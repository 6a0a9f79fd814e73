// K1: circle FFT, iFFT and LDE over batched M31 columns, several butterfly
// stages per launch in shared memory.
//
// Replaces the JAX package's `_jit_lde` (parallel/accel.py:718),
// `_jit_ifft_t` (:1180) and `_jit_fft` (:1730), which trace fft.ifft,
// fft.fft and fft_dup2.
//
// A transform is a few passes (kernels.fft_passes), each one launch of
// fft_pass_kernel; the index math, butterflies and the work of one CTA are
// in fft.cuh:
//   - the tile pass: one CTA per (column, 2^12-row tile) loads the tile
//     with 16-byte loads, runs every stage whose block fits in the tile
//     in shared memory -- four levels at a time on 16 values per thread in
//     registers, between two buffers -- and writes the tile once.  It comes first in the
//     forward transform and the LDE (reading the coefficients through the
//     zero-strided embedding, or duplicated at blowup 1) and last in the
//     inverse, in place;
//   - the group passes: the stages with larger blocks, up to 8 per
//     launch.  r consecutive stages split the rows into independent groups
//     of 2^r; a CTA holds 32 groups of consecutive j, so every warp reads
//     32 consecutive words of each of the group's rows (in reverse order
//     for the mirrored halves).  These ping-pong between two buffers.
// A column of up to 2^20 rows takes two launches, up to 2^28 three.
//
// Bound on this card: the integer units.  A stage does one M31 product and
// two additions per pair; a pass reads and writes each word once, so the
// 8 bytes per word per pass are far below the 2^r butterflies' arithmetic
// at r >= 2.  Twiddles are read from the flat table of each size (one
// pointer per launch); their rows stay in L1/L2.

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int THREADS = 512;  // at most; one per mini-group of 16 values
constexpr int TILE_LOG = 12;   // rows of a tile pass
constexpr int GROUP_LOG = 8;   // stages of a group pass, at most
constexpr int GROUPS_LOG = 5;  // groups per CTA of a group pass
constexpr int MAX_WORDS = 1 << (GROUP_LOG + GROUPS_LOG);  // per buffer; two buffers

struct DeviceBlock {
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int threads() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// At least two CTAs of 512 threads per SM: 64 registers a thread, which
// hold a thread's 16 values without spilling.
__global__ void __launch_bounds__(THREADS, 2) fft_pass_kernel(lum::FftPass p) {
  extern __shared__ uint32_t sm[];
  lum::fft_cta(DeviceBlock{}, p, blockIdx.x, sm);
}

}  // namespace

extern "C" long long lum_fft_tile_log() { return TILE_LOG; }
extern "C" long long lum_fft_group_log() { return GROUP_LOG; }
extern "C" long long lum_fft_groups_log() { return GROUPS_LOG; }
extern "C" long long lum_fft_pass_size() { return sizeof(lum::FftPass); }

extern "C" int lum_fft_pass(lum::FftPass p, void* stream) {
  // The attribute is a device's: set it once on each device (the caller
  // makes the tensors' device current).
  constexpr int MAX_DEVICES = 64;
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    cudaError_t err = cudaFuncSetAttribute(fft_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           2 * MAX_WORDS * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  long long ctas = lum::fft_ctas(p);
  int words = 1 << (p.log_g + p.log_groups);
  if (words > MAX_WORDS || p.log_groups > p.log_w) return (int)cudaErrorInvalidValue;
  int threads = words >> lum::FFT_CHUNK;
  threads = threads < 32 ? 32 : threads > THREADS ? THREADS : threads;
  if (ctas > 0) {
    fft_pass_kernel<<<(unsigned)ctas, threads, 2 * words * sizeof(uint32_t), (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}
