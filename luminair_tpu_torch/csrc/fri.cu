// K3: the folds of one committed FRI layer in one launch.
//
// Replaces the JAX package's `_jit_fold_circle` and `_jit_fold_line`
// (parallel/accel.py :1299, :1314), and the folds that `_jit_fri_layer`
// (:1487) and `_jit_fri_chain` (:1566) run as one program per committed
// layer with the smaller inputs mixed in, which trace
// pcs/fri.fold_circle_to_line and fri.fold_line.
//
// One thread per row of the next committed layer (fri.cuh): it reads the
// 2^F rows of the layer that fold into its row (128-bit loads through the
// read-only path), applies the layer's F folds in registers with the
// challenges beta_t = alpha^(2^t) of the layer's slot of the FRI record
// (K8 drew alpha into device memory), folds each joining input's pair of
// circle rows with alpha0 and adds it scaled by beta_t^2, and writes its
// one row.  The intermediate folds of a layer and the joining inputs'
// line evaluations never reach device memory.  The largest input's circle
// fold is a launch of its own (one fold): its output is layer 0, which K2
// hashes and K8 mixes before layer 0's alpha exists.
//
// Bound on this card: device memory for a fold with nothing joining --
// per output row 16 * 2^F bytes of the layer read and 16 written against
// about 2^F QM31 products; a layer with an input joining (two circle rows
// and a QM31 product more per fold output) reaches the estimated integer
// rate first (chip_smoke.fri_layer_work).

#include <cuda_runtime.h>

#include "fri.cuh"

namespace {

constexpr int THREADS = 256;
static_assert(lum::FRI_MAX_FOLDS == 4, "lum_fri_layer has a case per fold count");

template <int F>
__global__ void __launch_bounds__(THREADS) fri_layer_kernel(const __grid_constant__ lum::FriLayer a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < a.n) lum::fri_layer_row<F>(a, i);
}

}  // namespace

extern "C" long long lum_fri_layer_size() { return (long long)sizeof(lum::FriLayer); }
extern "C" long long lum_fri_max_folds() { return lum::FRI_MAX_FOLDS; }

extern "C" int lum_fri_layer(const lum::FriLayer* a, void* stream) {
  if (a->n <= 0) return 0;
  const dim3 grid((unsigned)((a->n + THREADS - 1) / THREADS));
  cudaStream_t s = (cudaStream_t)stream;
  switch (a->folds) {
    case 1: fri_layer_kernel<1><<<grid, THREADS, 0, s>>>(*a); break;
    case 2: fri_layer_kernel<2><<<grid, THREADS, 0, s>>>(*a); break;
    case 3: fri_layer_kernel<3><<<grid, THREADS, 0, s>>>(*a); break;
    case 4: fri_layer_kernel<4><<<grid, THREADS, 0, s>>>(*a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
