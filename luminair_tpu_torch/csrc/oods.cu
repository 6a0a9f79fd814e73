// K7: the OODS values of every (point, size) group of a prove in one call:
// M31 coefficient columns of length N = 2^L at a QM31 point, (C, N) ->
// (C, 4) per group, all groups into one (sum C, 4) output.
//
// Replaces the JAX package's `_jit_eval_at_point` (parallel/accel.py:1792).
//
// One packed descriptor (groups, their chains and column addresses; one
// upload, kernels.oods_eval_many) and two launches: oods_partial_kernel
// runs a grid of a few CTAs per SM, each over a contiguous run of units
// (one column x one chunk of 2^11 rows), building the group's factored
// basis in shared memory once per group it meets; its 16 lane groups of
// 16 threads take the units in turn, each writing one QM31 partial
// (oods.cuh); oods_combine_kernel adds each output row's partials.
//
// Bound on this card: the integer ALU -- 4 M31 products and sums per
// coefficient, against 4 bytes read per coefficient (3.35 TB/s moves a
// word in the time of about 5 integer operations of the 16.75 T/s rate).
// The basis costs 2^11 + 2^(L-11) QM31 products per CTA and group instead
// of one per row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "oods.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COMBINE_THREADS = 128;

constexpr int LANES = 16;  // lanes of a lane group: one unit of the partial pass each

template <int N>
struct DeviceBlock {
  unsigned long long* red;  // (N / 32) x 4 words of shared memory
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int threads() const { return N; }
  __device__ __forceinline__ int group() const { return LANES; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  // The sums of s[0..3] over the thread's lane group, in all its lanes
  // (the half-warp's lanes only: the two halves run apart).
  __device__ __forceinline__ void group_sum4(unsigned long long s[4]) const {
    const unsigned mask = 0xffffu << (threadIdx.x & 16);
#pragma unroll
    for (int k = 0; k < 4; k++) {
      for (int o = LANES / 2; o > 0; o >>= 1) s[k] += __shfl_xor_sync(mask, s[k], o, LANES);
    }
  }
  // The block's sums of s[0..3], in thread 0's s.
  __device__ __forceinline__ void sum4(unsigned long long s[4]) const {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      for (int o = 16; o > 0; o >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
      if (lane == 0) red[4 * w + k] = s[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < 4; k++) {
        unsigned long long t = 0;
        for (int j = 0; j < N / 32; j++) t += red[4 * j + k];
        s[k] = t;
      }
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(THREADS) oods_partial_kernel(const long long* desc, uint32_t* partial) {
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ unsigned long long red[THREADS / 32 * 4];
  lum::oods_cta(DeviceBlock<THREADS>{red}, desc, blockIdx.x, gridDim.x, partial, sm);
}

__global__ void __launch_bounds__(COMBINE_THREADS) oods_combine_kernel(const long long* desc,
                                                                       const uint32_t* partial, uint32_t* out) {
  __shared__ unsigned long long red[COMBINE_THREADS / 32 * 4];
  lum::oods_combine_row(DeviceBlock<COMBINE_THREADS>{red}, desc, blockIdx.x, partial, out);
}

}  // namespace

extern "C" long long lum_oods_lane_groups() { return THREADS / LANES; }
extern "C" long long lum_oods_group_words() { return lum::OODS_GROUP_WORDS; }

// desc: the descriptor on the card; `partial`: scratch of 4 words per
// (column, chunk); `out`: (rows, 4).  n_ctas CTAs share the items; smem:
// bytes of the largest group's tables.
extern "C" int lum_oods_eval(const long long* desc, int n_ctas, long long n_rows, long long smem, uint32_t* partial,
                             uint32_t* out, void* stream) {
  // The attribute is a device's: set it once on each device (the caller
  // makes the tensors' device current).
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(oods_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           200 * 1024);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  if (smem > 200 * 1024 || n_ctas <= 0 || n_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  oods_partial_kernel<<<n_ctas, THREADS, (size_t)smem, s>>>(desc, partial);
  oods_combine_kernel<<<(unsigned)n_rows, COMBINE_THREADS, 0, s>>>(desc, partial, out);
  return (int)cudaGetLastError();
}
