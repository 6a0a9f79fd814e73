// logup_sum: one row shard's LogUp claimed sum,
//   sum_i mult_i / (z - sum_k alpha^k v_ki),   a (4,) QM31.
//
// Replaces the JAX package's `_logup_sum_body` (parallel/sharding.py:184),
// traced into `_compiled_prover_step` (:224): the combination, a batched
// QM31 inverse and a halving tree over the row-sharded rows, lowered by
// XLA to a psum over the mesh.  Here each shard's rows are one launch on
// its device, and the lead device adds the n shard sums.
//
// One thread a row (a grid-stride loop): the combination z - sum_k
// alpha^k v_k (the powers are launch parameters, computed once on the
// host), one QM31 inverse (m31.cuh's qinv: the CM31 norm and the M31
// Fermat chain K5 uses), the product by mult_i, summed in registers.  A
// warp adds its 32 sums with shuffles, the CTA its warps' in shared
// memory; each CTA writes its partial, and the last CTA to finish (a
// counter in the scratch) adds the partials, writes the sum and puts the
// counter back to 0 for the next launch (the wrapper keeps the scratch
// per device, zeroed once).  QM31 addition is exact, so the order of the
// sum changes no bit: the reference's halving tree need not be copied.
//
// Bound on this card: the integer units.  A row reads K + 1 words (4 (K +
// 1) bytes) and costs 4K products and 4K subtractions, the inverse (58
// products, 17 additions) and 4 products and 4 additions more: at K = 2
// some 500 integer instructions against 12 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "m31.cuh"

namespace lum {

// The launch parameters (kernels.LogupArgs mirrors them).  Outside the
// anonymous namespace: the C entry point takes a pointer to one, which
// would otherwise give it internal linkage.
struct LogupArgs {
  unsigned long long values;   // (K, n) uint32, rows `stride` words apart
  unsigned long long mult;     // (n,) uint32
  unsigned long long partial;  // the finish counter (0 at entry and exit), then 4 words a CTA
  unsigned long long out;      // 4 words
  long long n;
  long long stride;
  int k;
  int pad_;
  uint32_t z[4];
  uint32_t pows[4 * 32];  // alpha^0 .. alpha^(K-1), K <= MAX_K
};

}  // namespace lum

namespace {

constexpr int THREADS = 256;
constexpr int MAX_K = 32;  // relation columns of one call
constexpr int WARPS = THREADS / 32;
static_assert(sizeof(lum::LogupArgs::pows) == 16 * MAX_K, "one QM31 power a relation column");

__device__ __forceinline__ lum::qm31 warp_sum(lum::qm31 x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x.a = lum::add(x.a, __shfl_down_sync(0xffffffffu, x.a, o));
    x.b = lum::add(x.b, __shfl_down_sync(0xffffffffu, x.b, o));
    x.c = lum::add(x.c, __shfl_down_sync(0xffffffffu, x.c, o));
    x.d = lum::add(x.d, __shfl_down_sync(0xffffffffu, x.d, o));
  }
  return x;
}

// The CTA's sum of every thread's x, in thread 0.
__device__ __forceinline__ lum::qm31 cta_sum(lum::qm31 x, lum::qm31* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  lum::qm31 s = {0u, 0u, 0u, 0u};
  if (threadIdx.x == 0)
    for (int w = 0; w < WARPS; w++) s = lum::qadd(s, red[w]);
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(THREADS) logup_sum_kernel(const lum::LogupArgs a) {
  __shared__ lum::qm31 red[WARPS];
  __shared__ bool last;
  const uint32_t* vals = reinterpret_cast<const uint32_t*>(a.values);
  const uint32_t* mult = reinterpret_cast<const uint32_t*>(a.mult);
  unsigned* counter = reinterpret_cast<unsigned*>(a.partial);  // at a fixed word: grids differ between launches
  uint32_t* partial = reinterpret_cast<uint32_t*>(a.partial) + 1;
  const lum::qm31 z = {a.z[0], a.z[1], a.z[2], a.z[3]};
  lum::qm31 acc = {0u, 0u, 0u, 0u};
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x; r < a.n; r += (long long)gridDim.x * THREADS) {
    lum::qm31 d = z;
    for (int k = 0; k < a.k; k++) {
      const lum::qm31 p = {a.pows[4 * k], a.pows[4 * k + 1], a.pows[4 * k + 2], a.pows[4 * k + 3]};
      d = lum::qsub(d, lum::qmul_m31(p, vals[k * a.stride + r]));
    }
    acc = lum::qadd(acc, lum::qmul_m31(lum::qinv(d), mult[r]));
  }
  lum::qm31 s = cta_sum(acc, red);
  if (threadIdx.x == 0) {
    lum::qstore(partial + 4 * blockIdx.x, s);
    __threadfence();
    const unsigned done = atomicAdd(counter, 1u);
    last = done == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  lum::qm31 t = {0u, 0u, 0u, 0u};
  for (unsigned c = threadIdx.x; c < gridDim.x; c += THREADS) {
    const uint32_t* q = partial + 4 * c;
    t = lum::qadd(t, {__ldcg(q), __ldcg(q + 1), __ldcg(q + 2), __ldcg(q + 3)});
  }
  t = cta_sum(t, red);
  if (threadIdx.x == 0) {
    lum::qstore(reinterpret_cast<uint32_t*>(a.out), t);
    *counter = 0u;  // every CTA has counted: the next launch starts from 0
  }
}

}  // namespace

extern "C" long long lum_logup_args_size() { return (long long)sizeof(lum::LogupArgs); }
extern "C" long long lum_logup_max_k() { return MAX_K; }
extern "C" long long lum_logup_threads() { return THREADS; }

// args: a LogupArgs in host memory (passed by value to the launch); n_ctas
// CTAs, whose partials and counter (0 at entry) the wrapper's scratch holds.
extern "C" int lum_logup_sum(const lum::LogupArgs* args, int n_ctas, void* stream) {
  if (args->k < 1 || args->k > MAX_K || args->n <= 0 || n_ctas <= 0) return (int)cudaErrorInvalidValue;
  logup_sum_kernel<<<(unsigned)n_ctas, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
