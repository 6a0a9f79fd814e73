// T1-T4: trace generation on the card -- one launch per graph node, each
// writing its rows of the node's trace table straight into the table's
// padded int32 columns, plus the node's int64 output buffer.
//
// Replaces the JAX package's device trace interpreter,
// luminair_tpu/graph/device_trace.py: `_Tracer._traced` (jitted at :158, one
// XLA program for the whole graph) and the settings pre-pass `_segment_fn`
// (:559, one program per segment between LUT nodes).  Where jax.jit fuses
// the graph into one program, here the host walks the graph once
// (graph/device_trace.py) and launches one of four kernels per node:
//   T1 trace_binary   add / mul / rem / less_than, one thread per row;
//   T2 trace_unary    inputs / recip / square / sqrt / sin, exp2, log2 /
//                     contiguous, one thread per row;
//   T3 trace_reduce   sum_reduce / max_reduce, one thread per trace row,
//                     a segmented scan along the reduced axis per CTA;
//   T4 lut_minmax     min and max of a LUT op's raw source buffer (the
//                     settings pre-pass), one block.
// Each thread resolves its own elements from the packed view (trace.cuh),
// so broadcasts, slices and pads need no materialised copy.  LUT and
// range-check multiplicities are atomicAdds of 1 into the histogram column:
// integer counts, the same in any order.  The settings pre-pass runs the
// same T1-T3 with every column pointer 0 (values only).
//
// Bound on this card: device memory.  Per row a node reads one or two int64
// elements and writes one int64 output and 11-22 int32 columns (60-100
// bytes) for a few tens of integer operations.  T3 scans each CTA's rows
// in shared memory (log2 of 256 steps) so that its column stores, 14 int32
// words a row, go out coalesced; a reduced axis longer than a CTA is walked
// in chunks by one CTA.

#include <cuda_runtime.h>

#include "trace.cuh"

namespace {

using lum::TraceArgs;

constexpr int THREADS = 256;

__global__ void trace_binary_kernel(const __grid_constant__ TraceArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) lum::binary_row(a, i);
}

__global__ void trace_unary_kernel(const __grid_constant__ TraceArgs a) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < a.n) lum::unary_row(a, r);
}

// T3's CTA: THREADS trace rows at a time (trace.cuh, reduce_cta).
struct ReduceBlock {
  __device__ __forceinline__ int threads() const { return THREADS; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  template <class F>
  __device__ __forceinline__ void each(F f) const { f((int)threadIdx.x); }
};

__global__ void __launch_bounds__(THREADS) trace_reduce_kernel(const __grid_constant__ TraceArgs a) {
  __shared__ long long raw[THREADS], scan[2 * THREADS];
  __shared__ int pos[THREADS];
  lum::reduce_cta(ReduceBlock{}, a, blockIdx.x, raw, scan, pos);
}

// One block of MINMAX_THREADS: out[0] = min, out[1] = max of buf[0 .. n).
constexpr int MINMAX_THREADS = 1024;

__global__ void lut_minmax_kernel(const long long* __restrict__ buf, long long n, long long* out) {
  __shared__ long long s_min[MINMAX_THREADS], s_max[MINMAX_THREADS];
  long long mn = buf[0], mx = buf[0];
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const long long v = buf[i];
    mn = v < mn ? v : mn;
    mx = v > mx ? v : mx;
  }
  s_min[threadIdx.x] = mn;
  s_max[threadIdx.x] = mx;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const long long a = s_min[threadIdx.x + s], b = s_max[threadIdx.x + s];
      if (a < s_min[threadIdx.x]) s_min[threadIdx.x] = a;
      if (b > s_max[threadIdx.x]) s_max[threadIdx.x] = b;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = s_min[0];
    out[1] = s_max[0];
  }
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// Checked against kernels.py when the library loads.
extern "C" long long lum_trace_args_size() { return (long long)sizeof(TraceArgs); }
extern "C" long long lum_trace_n_cols() { return lum::C_N_COLS; }
extern "C" long long lum_trace_n_ops() { return lum::T_N_OPS; }
extern "C" long long lum_view_max_dims() { return lum::VIEW_MAX_DIMS; }

extern "C" int lum_trace_binary(const TraceArgs* a, void* stream) {
  if (a->n > 0) trace_binary_kernel<<<blocks_for(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int lum_trace_unary(const TraceArgs* a, void* stream) {
  if (a->n > 0) trace_unary_kernel<<<blocks_for(a->n), THREADS, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int lum_trace_reduce(const TraceArgs* a, void* stream) {
  if (a->n > 0 && a->dsize > 0) {
    const long long per = lum::reduce_outputs_per_cta(a->dsize, THREADS);
    trace_reduce_kernel<<<(unsigned)((a->n + per - 1) / per), THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" int lum_lut_minmax(const long long* buf, long long n, long long* out, void* stream) {
  if (n > 0) lut_minmax_kernel<<<1, MINMAX_THREADS, 0, (cudaStream_t)stream>>>(buf, n, out);
  return (int)cudaGetLastError();
}
