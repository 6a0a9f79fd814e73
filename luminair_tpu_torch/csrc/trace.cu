// T1+T2, T3, T4: trace generation on the card, writing each node's rows of
// its trace table straight into the table's padded int32 columns, plus the
// node's int64 output in the pass's arena.
//
// Replaces the JAX package's device trace interpreter,
// luminair_tpu/graph/device_trace.py: `_Tracer._traced` (jitted at :158, one
// XLA program for the whole graph) and the settings pre-pass `_segment_fn`
// (:559, one program per segment between LUT nodes).  The host walks the
// graph once (graph/device_trace.py) and builds one table of node
// descriptors (TraceArgs) for the pass, uploaded in one copy with the
// inputs' float64 bits; then:
//   trace_segment  every add / mul / rem / less_than (T1) and inputs /
//                  recip / square / sqrt / sin, exp2, log2 / contiguous (T2)
//                  node of a segment -- the nodes between two reductions,
//                  and in the settings pass between LUT nodes too -- and,
//                  in a pass's first segment, each input's fixed encoding
//                  (T_ENCODE) and, in a trace, every table's padding rows:
//                  one cooperative launch of a persistent interpreter;
//   trace_reduce   sum_reduce / max_reduce (T3), one launch per node, one
//                  thread per trace row, a segmented scan per CTA;
//   lut_boundary   the boundary of a LUT node of the settings pre-pass (T4,
//                  lut.cuh): the min and max of its source buffer and its
//                  gathered input in one staging region, which the host
//                  copies to pinned memory in one download; a CTA of 256
//                  threads for every 2,048 source values (8 at the PINN).
// A segment's items are sorted by the host into phases, and inside a phase
// into chains: an item that reads an output of the current phase through a
// view mapping its row r to element r, with the writer's rows, joins the
// writer's chain (a thread runs its rows of each item of a chain in turn,
// so it reads what it wrote itself); any other read of the current phase
// starts a new phase.  The grid is the number of CTAs that fit on the card
// at once; each CTA takes tiles of the current phase's chains (256 rows,
// one a thread, or more for a chain of many), loads the chain's descriptors
// into shared memory (once
// for consecutive tiles of one chain) and runs each item of the chain on
// the tile; the grid meets at a barrier before each later phase.  Each
// thread resolves its own elements from the packed view (trace.cuh), with
// a fast divmod in 32 bits per view dimension, so broadcasts, slices and
// pads need no materialised copy.  LUT and range-check multiplicities are
// atomicAdds of 1 into the histogram column: integer counts, the same in
// any order.  The settings pre-pass runs the same kernels with every column
// pointer 0 (values only).
//
// Bound on this card: device memory.  Per row a node reads one or two int64
// elements and writes one int64 output and 11-22 int32 columns (60-100
// bytes) for a few tens of integer operations.  What one launch per node
// cost was the launch itself: most nodes write a few thousand rows, well
// under a microsecond of HBM time.  T3 scans each CTA's rows in shared
// memory (log2 of 256 steps) so that its column stores, 14 int32 words a
// row, go out coalesced; a reduced axis longer than a CTA is walked in
// chunks by one CTA.

#include <cuda_runtime.h>

#include "lut.cuh"
#include "trace.cuh"

namespace {

using lum::SegArgs;
using lum::TraceArgs;

constexpr int THREADS = 256;

// A CTA of the segment interpreter, as trace.cuh's tile_rows sees it.
struct SegBlock {
  __device__ __forceinline__ int threads() const { return lum::SEG_THREADS; }
  template <class F>
  __device__ __forceinline__ void each(F f) const { f((int)threadIdx.x); }
};

// Every CTA of the (co-resident) grid arrives; the last one resets the
// count and moves the generation on, which the others wait for.  The
// fences order each CTA's writes before its arrival and the next phase's
// reads after the release.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(256);
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(lum::SEG_THREADS) trace_segment_kernel(const __grid_constant__ SegArgs s) {
  __shared__ TraceArgs node[lum::SEG_CHAIN];
  __shared__ int s_first, s_count, s_shift, s_load;
  __shared__ long long s_tile;
  const TraceArgs* nodes = (const TraceArgs*)s.nodes;
  const lum::SegChain* chains = (const lum::SegChain*)s.chains;
  const lum::SegPhase* phases = (const lum::SegPhase*)s.phases;
  // Thread 0's: the chain whose descriptors `node` holds, and its tiles.
  int cur = -1;
  long long cur_lo = 0, cur_hi = 0;
  for (int p = s.p0; p < s.p1; p++) {
    if (lum::barrier_before(p, s.p0)) grid_sync((unsigned*)s.barrier);
    const lum::SegPhase ph = phases[p];
    for (long long t = blockIdx.x; t < ph.tiles; t += gridDim.x) {
      __syncthreads();  // the last tile's rows are done with `node`
      if (threadIdx.x == 0) {
        const bool same = cur >= ph.first && cur < ph.first + ph.count && t >= cur_lo && t < cur_hi;
        if (!same) {
          cur = lum::tile_chain(chains, ph, t);
          cur_lo = chains[cur].tile0;
          cur_hi = cur + 1 < ph.first + ph.count ? chains[cur + 1].tile0 : ph.tiles;
          s_first = chains[cur].first;
          s_count = chains[cur].count;
          s_shift = chains[cur].shift;
        }
        s_load = !same || s_count > lum::SEG_CHAIN;
        s_tile = t - cur_lo;
      }
      __syncthreads();
      for (int j0 = 0; j0 < s_count; j0 += lum::SEG_CHAIN) {
        const int m = s_count - j0 < lum::SEG_CHAIN ? s_count - j0 : lum::SEG_CHAIN;
        if (s_load) {
          if (j0 > 0) __syncthreads();  // the last chunk's rows are done with `node`
          const long long* from = (const long long*)(nodes + s_first + j0);
          long long* to = (long long*)node;
          for (int w = threadIdx.x; w < m * (int)(sizeof(TraceArgs) / 8); w += lum::SEG_THREADS) to[w] = from[w];
          __syncthreads();
        }
        for (int j = 0; j < m; j++) lum::tile_rows(SegBlock{}, node[j], s_tile, s_shift);
      }
    }
  }
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

// T4's CTA (lut.cuh): the warps' min / max by shuffles (a 64-bit shuffle
// moves the two 32-bit halves), then one exchange of the warps' partials
// in shared memory and the same shuffles in warp 0.
struct LutBlock {
  long long* warp_lo;
  long long* warp_hi;
  __device__ __forceinline__ int threads() const { return lum::LUT_THREADS; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  template <class F>
  __device__ __forceinline__ void each(F f) const { f((int)threadIdx.x); }
  __device__ __forceinline__ static void shuffle(long long& mn, long long& mx) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long o_mn = __shfl_xor_sync(0xffffffffu, mn, off), o_mx = __shfl_xor_sync(0xffffffffu, mx, off);
      mn = o_mn < mn ? o_mn : mn;
      mx = o_mx > mx ? o_mx : mx;
    }
  }
  __device__ __forceinline__ void minmax(long long* lo, long long* hi) const {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    long long mn = lo[t], mx = hi[t];
    shuffle(mn, mx);
    if (lane == 0) {
      warp_lo[warp] = mn;
      warp_hi[warp] = mx;
    }
    __syncthreads();
    if (warp == 0) {
      mn = lane < lum::LUT_THREADS / 32 ? warp_lo[lane] : lum::LUT_I64_MAX;
      mx = lane < lum::LUT_THREADS / 32 ? warp_hi[lane] : lum::LUT_I64_MIN;
      shuffle(mn, mx);
      if (lane == 0) {
        lo[0] = mn;
        hi[0] = mx;
      }
    }
    __syncthreads();
  }
};

__global__ void __launch_bounds__(lum::LUT_THREADS) lut_boundary_kernel(const lum::LutArgs a) {
  __shared__ long long lo[lum::LUT_THREADS], hi[lum::LUT_THREADS], warp_lo[32], warp_hi[32];
  __shared__ int last;
  lum::lut_boundary_cta(LutBlock{warp_lo, warp_hi}, a, blockIdx.x, gridDim.x, lo, hi, &last);
}

}  // namespace

// Checked against kernels.py when the library loads.
extern "C" long long lum_trace_args_size() { return (long long)sizeof(TraceArgs); }
extern "C" long long lum_seg_args_size() { return (long long)sizeof(SegArgs); }
extern "C" long long lum_seg_phase_size() { return (long long)sizeof(lum::SegPhase); }
extern "C" long long lum_seg_chain_size() { return (long long)sizeof(lum::SegChain); }
extern "C" long long lum_trace_layout() { return (long long)lum::trace_layout(); }
extern "C" long long lum_trace_n_cols() { return lum::C_N_COLS; }
extern "C" long long lum_trace_n_ops() { return lum::T_N_OPS; }
extern "C" long long lum_view_max_dims() { return lum::VIEW_MAX_DIMS; }
extern "C" long long lum_seg_tile() { return lum::SEG_TILE; }
extern "C" long long lum_seg_chain() { return lum::SEG_CHAIN; }

// The segment interpreter: a cooperative launch of as many CTAs as fit on
// the card at once (fewer when no phase has that many tiles), so the grid
// barrier cannot wait on a CTA that never started.  The count that fits is
// asked once per device.
extern "C" int lum_trace_segment(const SegArgs* s, void* stream) {
  if (s->p1 <= s->p0 || s->max_tiles <= 0) return 0;
  constexpr int MAX_DEVICES = 64;
  static long long fit[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (fit[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trace_segment_kernel, lum::SEG_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    fit[dev] = (long long)per_sm * sms;
  }
  const long long grid = s->max_tiles < fit[dev] ? s->max_tiles : fit[dev];
  if (grid <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)s};
  e = cudaLaunchCooperativeKernel((const void*)trace_segment_kernel, dim3((unsigned)grid), dim3(lum::SEG_THREADS), args,
                                  0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int lum_trace_reduce(const TraceArgs* a, void* stream) {
  if (a->n > 0 && a->dsize > 0) {
    const long long per = lum::reduce_outputs_per_cta(a->dsize, THREADS);
    trace_reduce_kernel<<<(unsigned)((a->n + per - 1) / per), THREADS, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

extern "C" long long lum_lut_threads() { return lum::LUT_THREADS; }
extern "C" long long lum_lut_pairs() { return lum::LUT_PAIRS; }
extern "C" long long lum_lut_max_ctas() { return lum::LUT_MAX_CTAS; }

extern "C" int lum_lut_boundary(const long long* src, long long n, const long long* gathered, long long gn,
                                long long* out, long long out_words, void* stream) {
  if (n <= 0 || out_words < lum::lut_boundary_words(n, gn, lum::LUT_THREADS)) return (int)cudaErrorInvalidValue;
  const lum::LutArgs a{src, n, gathered, gn, out, out_words};
  lut_boundary_kernel<<<(unsigned)lum::lut_ctas(n, lum::LUT_THREADS), lum::LUT_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
