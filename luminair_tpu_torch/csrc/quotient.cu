// K4: the DEEP quotients of every (commit log, sample point) group of a
// prove in one launch: per log the sum over its groups of
//   (sum_j gamma_j c_j - acc_a x - acc_c0) / L(x, y),
// L the line through the group's sample point and its conjugate.
//
// Replaces the JAX package's `_jit_quotient_group` (parallel/accel.py:1248),
// which pcs/quotients.accumulate_quotients calls once per group.
//
// One packed descriptor (kernels.QuotientPlan; one upload) and one launch:
// a CTA of THREADS threads takes THREADS * ROWS consecutive rows of one log,
// a thread ROWS of them, and runs every group of that log there
// (quotient.cuh): each log's output is written once, its xs and ys read
// once.  The groups' gammas and column addresses are staged in shared
// memory CHUNK columns at a time.
//
// Bound on this card: the integer ALU -- 4 folded products per column and
// row against 4 bytes read (3.35 TB/s moves a word in the time of about 5
// integer operations at 16.75 T/s); the denominator is CM31 (L = u d), so a
// row needs one M31 Fermat chain per ROWS rows, not a QM31 inverse per
// group.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quotient.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 4;
constexpr int CHUNK = 256;

struct DeviceBlock {
  __device__ __forceinline__ int tid() const { return threadIdx.x; }
  __device__ __forceinline__ int threads() const { return THREADS; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

__global__ void __launch_bounds__(THREADS) deep_quotient_kernel(const long long* desc, uint32_t* out) {
  __shared__ unsigned long long sptr[CHUNK];
  __shared__ lum::u32x4 sgam[CHUNK];
  lum::dq_cta<ROWS>(DeviceBlock{}, desc, blockIdx.x, out, sptr, sgam, CHUNK);
}

}  // namespace

// Checked against kernels.py when the library loads.
extern "C" long long lum_dq_log_words() { return lum::DQ_LOG_WORDS; }
extern "C" long long lum_dq_group_words() { return lum::DQ_GROUP_WORDS; }
extern "C" long long lum_dq_cta_rows() { return THREADS * ROWS; }

// desc: the descriptor on the card; n_ctas: the plan's CTAs (the last log's
// first CTA plus its CTAs); out: (rows, 4), every log's rows in turn.
extern "C" int lum_deep_quotient(const long long* desc, long long n_ctas, uint32_t* out, void* stream) {
  if (n_ctas <= 0 || n_ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  deep_quotient_kernel<<<(unsigned)n_ctas, THREADS, 0, (cudaStream_t)stream>>>(desc, out);
  return (int)cudaGetLastError();
}
