// K5: the LogUp interaction columns and K6: the constraint quotients,
// every component of a phase in one launch, each component's tape compiled
// (air.cuh, air_tapes.cuh); K5's carry pass across row blocks; and the
// trace-domain constraint check, compiled per component (check.cuh,
// check_tapes.cuh).
//
// Replaces the JAX package's `_jit_witness` (parallel/accel.py, which traces
// WitnessEval.build_interaction and its cumsum) and `_jit_domain` (which
// traces DomainEval and the division by the vanishing polynomial).  Where
// jax.jit compiles each component into its own program, here each
// component's tape is one generated function, and one launch runs every
// component of the prove: K5 a tile of rows a CTA, the running sum down
// the rows finished in the same launch (a single-pass scan with decoupled
// look-back, air.cuh); K6 a row a thread, every component of the row's
// commit domain summed in registers and divided once by V_n.
// The carry pass (lum_m31_add_carry): row blocks' prefix sums plus the
//   sum of every earlier block, one QM31 word each on the card; one launch
//   takes every block of a row shard (CarryArgs), 16 bytes a thread.
// The check (air_check, lum_air_check): the trace-domain constraint check
//   of every component of a PIE in one launch.  Replaces the JAX package's
//   host `_CheckEval` (air/debug.py).
//
// Bound on this card: the integer ALU.  K5 does per row the tape, per
// entry a denominator, a CM31 norm and its conjugate products, and one M31
// inversion shared by the row's entries; K6 per row and component the
// tape, a QM31-by-M31 product per constraint and two QM31 products per
// entry, and per row one V_n and its inverse.  Bytes are 4 per column
// read and 16 per QM31 written.  Registers are locals (0 LDL / STL).  The
// carry pass is bound by its bytes.

#include <cuda_runtime.h>

#include "air.cuh"
#include "check.cuh"

namespace {

using lum::qm31;

// The CTA as air.cuh's K5 body sees it: thread threadIdx.x of blockDim.x.
struct CtaWarp {
  template <class F>
  __device__ __forceinline__ unsigned ballot(F f) const {
    return __ballot_sync(0xffffffffu, f((int)(threadIdx.x & 31)));
  }
  template <class F>
  __device__ __forceinline__ qm31 sum(F f) const {
    qm31 v = f((int)(threadIdx.x & 31));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v = lum::qadd(v, {__shfl_xor_sync(0xffffffffu, v.a, o), __shfl_xor_sync(0xffffffffu, v.b, o),
                        __shfl_xor_sync(0xffffffffu, v.c, o), __shfl_xor_sync(0xffffffffu, v.d, o)});
    }
    return v;
  }
  template <class F>
  __device__ __forceinline__ void lane0(F f) const {
    if ((threadIdx.x & 31) == 0) f();
  }
  __device__ __forceinline__ void pause() const { __nanosleep(64); }
};

struct CtaBlock {
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    f((int)threadIdx.x);
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  template <class F>
  __device__ __forceinline__ void warp(F f) const {
    if (threadIdx.x < 32) f(CtaWarp{});
  }
  // Inclusive QM31 prefix of x[0..blockDim.x) in place (blockDim.x a
  // multiple of 32): each thread reads its own word, scans its warp with
  // shuffles, and adds the warps before it.
  __device__ __forceinline__ void scan(qm31* x) const {
    __shared__ qm31 warp_tot[32];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, nw = blockDim.x >> 5;
    qm31 v = x[tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const qm31 y = {__shfl_up_sync(0xffffffffu, v.a, o), __shfl_up_sync(0xffffffffu, v.b, o),
                      __shfl_up_sync(0xffffffffu, v.c, o), __shfl_up_sync(0xffffffffu, v.d, o)};
      if (lane >= o) v = lum::qadd(v, y);
    }
    if (lane == 31) warp_tot[w] = v;
    __syncthreads();
    if (w == 0) {
      qm31 t = lane < nw ? warp_tot[lane] : qm31{0u, 0u, 0u, 0u};
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const qm31 y = {__shfl_up_sync(0xffffffffu, t.a, o), __shfl_up_sync(0xffffffffu, t.b, o),
                        __shfl_up_sync(0xffffffffu, t.c, o), __shfl_up_sync(0xffffffffu, t.d, o)};
        if (lane >= o) t = lum::qadd(t, y);
      }
      warp_tot[lane] = t;
    }
    __syncthreads();
    if (w > 0) v = lum::qadd(v, warp_tot[w - 1]);
    x[tid] = v;
    __syncthreads();
  }
};

// K5: one tile a CTA, its index drawn from the scratch's counter.  Four
// CTAs an SM: 64 registers, no spill (the SASS has no LDL / STL); at the
// 72 that ptxas takes unbounded, three CTAs an SM took 0.197 ms against
// 0.162 at mul's 2^21 rows (NVIDIA H100 80GB HBM3, tools/kernel_timing.py
// --kernels K6).
__global__ void __launch_bounds__(lum::WITNESS_THREADS, 4) air_witness_kernel(const __grid_constant__ lum::WitnessArgs a) {
  __shared__ qm31 tot[lum::WITNESS_MAX_ITEMS * lum::WITNESS_THREADS];
  __shared__ qm31 excl;
  __shared__ int tile;
  if (threadIdx.x == 0) tile = (int)(atomicAdd((unsigned long long*)a.counter, 1ull) - a.base);
  __syncthreads();
  const CtaBlock b;
  lum::witness_begin(b, a, tile, tot, &excl);
  lum::witness_end(b, a, tile, tot, &excl);
}

// K6: one row a thread (air.cuh).
__global__ void __launch_bounds__(lum::DOMAIN_THREADS) air_domain_kernel(const __grid_constant__ lum::DomainArgs a) {
  lum::domain_cta_row(a, blockIdx.x, threadIdx.x, lum::DOMAIN_THREADS);
}

// The check: one thread a row of one component (check.cuh).
__global__ void __launch_bounds__(lum::CHECK_THREADS) check_tapes_kernel(const __grid_constant__ lum::CheckArgs a) {
  lum::check_cta_row(a, blockIdx.x, threadIdx.x);
}

// The carry pass's blocks: (4, R) int32 rows each, block b's carry the
// QM31 at carry[4b..4b+3].  Mirrored by kernels.CarryBlock / CarryArgs.
constexpr int CARRY_MAX_BLOCKS = 32;
constexpr int CARRY_THREADS = 256;

struct CarryBlock {
  unsigned long long rows;  // (4, R) contiguous int32
  long long len;            // R
  int row_ctas;             // CTAs a coordinate row
  int vec;                  // 16 bytes a thread: R a multiple of 4, rows 16-byte aligned
  int cta0;                 // its first CTA
  int pad;
};

struct CarryArgs {
  CarryBlock blocks[CARRY_MAX_BLOCKS];
  unsigned long long carry;  // (n_blocks, 4) int32 on the card
  int n_blocks;
  int n_ctas;
};

// rows[k][j] += carry[k] of one block: a CTA takes 256 units of one
// coordinate row k, a unit 16 bytes (or one word where R is not a multiple
// of 4).
__global__ void __launch_bounds__(CARRY_THREADS) add_carry_kernel(const __grid_constant__ CarryArgs a) {
  int b = 0;
  for (int i = 1; i < a.n_blocks; i++) b = a.blocks[i].cta0 <= (int)blockIdx.x ? i : b;
  const CarryBlock& k = a.blocks[b];
  const int cta = (int)blockIdx.x - k.cta0, coord = cta / k.row_ctas;
  const long long j = (long long)(cta - coord * k.row_ctas) * CARRY_THREADS + threadIdx.x;
  const uint32_t c = ((const uint32_t*)a.carry)[4 * b + coord];
  uint32_t* row = (uint32_t*)k.rows + coord * k.len;
  if (k.vec) {
    if (4 * j >= k.len) return;
    lum::u32x4* p = (lum::u32x4*)row + j;
    lum::u32x4 v = *p;
    for (int i = 0; i < 4; i++) v.v[i] = lum::add(v.v[i], c);
    *p = v;
  } else if (j < k.len) {
    row[j] = lum::add(row[j], c);
  }
}

}  // namespace

// Checked against kernels.py when the library loads.
extern "C" long long lum_witness_args_size() { return (long long)sizeof(lum::WitnessArgs); }
extern "C" long long lum_witness_threads() { return lum::WITNESS_THREADS; }
extern "C" long long lum_witness_max_items() { return lum::WITNESS_MAX_ITEMS; }
extern "C" long long lum_domain_args_size() { return (long long)sizeof(lum::DomainArgs); }
extern "C" long long lum_domain_threads() { return lum::DOMAIN_THREADS; }
extern "C" long long lum_air_kinds() { return lum::AIR_KINDS; }
extern "C" long long lum_check_args_size() { return (long long)sizeof(lum::CheckArgs); }
extern "C" long long lum_check_threads() { return lum::CHECK_THREADS; }
extern "C" long long lum_check_kinds() { return lum::CHECK_KINDS; }
extern "C" long long lum_carry_args_size() { return (long long)sizeof(CarryArgs); }
extern "C" long long lum_carry_threads() { return CARRY_THREADS; }

// Every component of a witness (WitnessArgs) in one launch, a tile a CTA.
extern "C" int lum_air_witness(const lum::WitnessArgs* args, void* stream) {
  if (args->rows != args->items * lum::WITNESS_THREADS || args->items > lum::WITNESS_MAX_ITEMS) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->n_tiles > 0) {
    air_witness_kernel<<<args->n_tiles, lum::WITNESS_THREADS, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// Every domain of a quotient launch (DomainArgs) in one launch.
extern "C" int lum_air_domain(const lum::DomainArgs* args, void* stream) {
  if (args->n_ctas > 0) {
    air_domain_kernel<<<args->n_ctas, lum::DOMAIN_THREADS, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// Every component of a check (CheckArgs) in one launch.
extern "C" int lum_air_check(const lum::CheckArgs* args, void* stream) {
  if (args->n_ctas > 0) {
    check_tapes_kernel<<<args->n_ctas, lum::CHECK_THREADS, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// The carry pass over every block of `args`, in place.
extern "C" int lum_m31_add_carry(const void* args, void* stream) {
  const CarryArgs& a = *(const CarryArgs*)args;
  if (a.n_ctas > 0) {
    add_carry_kernel<<<a.n_ctas, CARRY_THREADS, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
