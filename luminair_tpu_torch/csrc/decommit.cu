// K9: one decommitment pass -- the Merkle set arithmetic and every gather
// of it -- in one launch.
//
// Replaces the JAX package's `_jit_gather_cols` (parallel/accel.py:925)
// and `_jit_gather_many` (:968, called by `gather_many` :993) together with
// the host planning that fed them: crypto/merkle.py's `computed_positions`
// (:41), `decommit` (:169) and `queried_values` (:209).
//
// The host uploads, in one pinned copy, one record per tree (its
// descriptor's address, made once when the tree was built; its output
// offsets; the offset and count of its query positions per log) and the
// sorted, distinct query positions (kernels.DecommitPass).  The grid is
// (trees, slices): every CTA of a tree walks the tree's layers from the
// bottom in shared memory (decommit.cuh) -- a rank merge of the parents
// with the layer's queries, a block scan that drops repeats, a block scan
// that lists the children missing below -- and gathers its slice of the
// witness digests and opened values straight into the tree's part of the
// output, behind a header of counts per layer.  The output comes down in
// one transfer.
//
// The position lists of a CTA sit in shared memory while three lists of
// the plan's bound fit in SHARED_BYTES; a larger pass (many queries on a
// tree with columns at several logs) keeps them in a device-memory scratch
// area of the same size per CTA, which the wrapper allocates.
//
// Bound on this card: latency.  A pass moves well under a megabyte; each
// gathered word is a scattered 4-byte read.  The set work is a few hundred
// positions per layer, a handful of block scans each; slices spread the
// gathers of a large tree over more SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decommit.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_WORDS = THREADS / 32;
constexpr long long SHARED_BYTES = 200 * 1024;  // position lists in shared memory up to this size

struct DeviceBlock {
  int* scratch;  // SCAN_WORDS ints of shared memory
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int threads() const { return THREADS; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  // Exclusive prefix sum of v over the block; `total` is the block's sum.
  __device__ __forceinline__ int exclusive_scan(int v, int& total) const {
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = lane < SCAN_WORDS ? scratch[lane] : 0;
      for (int o = 1; o < SCAN_WORDS; o <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      if (lane < SCAN_WORDS) scratch[lane] = s;
    }
    __syncthreads();
    int before = warp ? scratch[warp - 1] : 0;
    total = scratch[SCAN_WORDS - 1];
    __syncthreads();
    return before + x - v;
  }
};

// The three position lists of a CTA are in shared memory, or, when
// `scratch` is given (a pass whose merge exceeds SHARED_BYTES), in its
// 3 * cap words of device memory; the block syncs order both alike.
__global__ void __launch_bounds__(THREADS) decommit_kernel(const long long* pass, int n_trees, int n_slices, int cap,
                                                           int32_t* scratch, int32_t* out) {
  extern __shared__ int32_t sm[];
  const long long* rec = pass + (long long)blockIdx.x * lum::DC_TREE_WORDS;
  const long long* positions = pass + (long long)n_trees * lum::DC_TREE_WORDS;
  int32_t* sets = scratch ? scratch + ((long long)blockIdx.x * n_slices + blockIdx.y) * 3 * cap : sm + SCAN_WORDS;
  lum::dc_tree(DeviceBlock{sm}, rec, positions, out, blockIdx.y, n_slices, cap, sets);
}

}  // namespace

extern "C" long long lum_dc_tree_words() { return lum::DC_TREE_WORDS; }
extern "C" long long lum_dc_desc_words() { return lum::DC_DESC_WORDS; }
extern "C" long long lum_dc_shared_bytes() { return SHARED_BYTES; }

extern "C" int lum_decommit(const long long* pass, int n_trees, int n_slices, int cap, int32_t* scratch, int32_t* out,
                            void* stream) {
  if (!scratch && 3LL * cap * (long long)sizeof(int32_t) > SHARED_BYTES) return (int)cudaErrorInvalidValue;
  size_t smem = ((scratch ? 0 : 3 * (size_t)cap) + SCAN_WORDS) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decommit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_trees > 0) {
    decommit_kernel<<<dim3(n_trees, n_slices), THREADS, smem, (cudaStream_t)stream>>>(pass, n_trees, n_slices, cap,
                                                                                       scratch, out);
  }
  return (int)cudaGetLastError();
}
