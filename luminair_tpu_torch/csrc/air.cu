// K5: the LogUp interaction columns and K6: the constraint quotients on a
// component's commit domain -- one interpreter of the component's tape
// (tape.cuh) with one thread per row; K5's carry pass across row blocks;
// and the trace-domain constraint check, compiled per component.
//
// Replaces the JAX package's `_jit_witness` (parallel/accel.py, which traces
// WitnessEval.build_interaction) and `_jit_domain` (which traces DomainEval
// and the division by the vanishing polynomial).  Where jax.jit fuses each
// component into its own program, here every component is one tape read by
// the same kernel; the kernels are built only from this source.
//
// K5, per trace row r:  for each relation entry b, d_b = v0 + alpha*v1 - z,
//   S_b = S_{b-1} + n_b * d_b^-1 (one QM31 inverse per entry), written as
//   coordinate rows 4b..4b+3 of out (4E, n).  Then the last entry's four
//   rows get their prefix sum down the rows (lum_m31_scan: tile sums, a scan
//   of the tile sums, a carry pass); the claimed sum is its last row.
// K6, per commit-domain row r (stride = 2^blowup rows per trace step):
//   acc = sum_i pows[i] * C_i(r) over the K recorded constraints, plus for
//   each entry b the LogUp constraint
//     (S_b(r) - S_{b-1}(r) [- S_last(r - stride) + is_first(r) * claimed])
//       * d_b - n_b
//   with pows[K + b]; then acc / V_n(x_r), V_n = pi^(n-1)(x).  MAIN_NEXT
//   reads row r + stride, the previous row of the last entry r - stride.
//   With `accumulate` the quotient is added into out (n, 4) in place.
//   A launch may cover one row block of the domain (a mesh's row shard;
//   lum_air_domain_halo): the reads past the block's ends go to its halo
//   (AirArgs.next, .prev: the neighbouring blocks' `stride` rows, wrapping
//   at the domain's ends), and xs starts at the block's first row.  A whole
//   domain (lum_air_domain) wraps with a mask and reads no halo.
// The carry pass (lum_m31_add_carry): row blocks' prefix sums plus the
//   sum of every earlier block, one QM31 word each on the card; one launch
//   takes every block of a row shard (CarryArgs), 16 bytes a thread.
// The check (air_check, lum_air_check): the trace-domain constraint check
//   of every component of a PIE in one launch, each component's tape
//   compiled (check.cuh, check_tapes.cuh).  Replaces the JAX package's
//   host `_CheckEval` (air/debug.py).
//
// Bound on this card: the integer ALU.  Per row K6 does ~20-100 M31 ops for
// the tape, a QM31 product per constraint, two per LogUp entry and one M31
// inverse; K5 a QM31 inverse per entry.  Bytes are 4 per column read and
// 16 per QM31 written.  K5 and K6 interpret the tape: it sits in shared
// memory (every thread reads the same instruction: a broadcast), and the
// register file is a local array, which the L1 cache holds.  The check
// runs compiled tapes, its registers in registers.  The carry pass is
// bound by its bytes.

#include <cuda_runtime.h>

#include "check.cuh"
#include "tape.cuh"

static_assert(lum::CHECK_ELEM_KINDS == lum::TAPE_KINDS, "check.cuh and tape.cuh disagree on the element kinds");

namespace {

using lum::AirArgs;
using lum::qm31;

__global__ void air_witness_kernel(const __grid_constant__ AirArgs a) {
  __shared__ int s_tape[lum::TAPE_INS_WORDS * lum::TAPE_MAX_INS];
  lum::load_tape(a, s_tape);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  uint32_t* out = (uint32_t*)a.out;
  qm31 s = {0, 0, 0, 0};
  int b = 0;
  lum::run_tape<false>(
      s_tape, a, r, [](uint32_t) {},
      [&](int kind, uint32_t m, uint32_t v0, uint32_t v1, bool two) {
        qm31 d = lum::denominator(a, kind, v0, v1, two);
        s = lum::qadd(s, lum::qmul_m31(lum::qinv(d), m));
        uint32_t* o = out + (long long)(4 * b) * a.n + r;
        o[0] = s.a;
        o[a.n] = s.b;
        o[2 * a.n] = s.c;
        o[3 * a.n] = s.d;
        b++;
      });
}

__device__ __forceinline__ qm31 load_inter(const AirArgs& a, int b, long long r) {
  return {((const uint32_t*)a.inter[4 * b])[r], ((const uint32_t*)a.inter[4 * b + 1])[r],
          ((const uint32_t*)a.inter[4 * b + 2])[r], ((const uint32_t*)a.inter[4 * b + 3])[r]};
}

// Entry b's LogUp constraint at row r:
//   (S_b - S_{b-1} [- S_last(r - stride) + is_first * claimed]) * d_b - n_b.
// `prev` holds S_{b-1}(r) (zero before the first entry) and becomes S_b(r).
// The row r - stride wraps at the column's start, or with Halo comes from
// a.prev before the block's start.
template <bool Halo>
__device__ __forceinline__ qm31 logup_constraint(const AirArgs& a, int b, long long r, qm31& prev,
                                                 uint32_t m, qm31 d) {
  qm31 s = load_inter(a, b, r);
  qm31 diff = lum::qsub(s, prev);
  if (b == a.n_rel - 1) {
    qm31 s_prev;
    if (!Halo) {
      s_prev = load_inter(a, b, (r - a.stride) & (a.n - 1));
    } else if (r >= a.stride) {
      s_prev = load_inter(a, b, r - a.stride);
    } else {  // the halo: the rows before the block
      s_prev = {((const uint32_t*)a.prev[0])[r], ((const uint32_t*)a.prev[1])[r], ((const uint32_t*)a.prev[2])[r],
                ((const uint32_t*)a.prev[3])[r]};
    }
    uint32_t first = ((const uint32_t*)a.is_first)[r];
    diff = lum::qadd(lum::qsub(diff, s_prev), lum::qmul_m31(lum::qword(a.claimed), first));
  }
  prev = s;
  return lum::qsub(lum::qmul(diff, d), {m, 0u, 0u, 0u});
}

template <bool Halo>
__global__ void air_domain_kernel(const __grid_constant__ AirArgs a) {
  __shared__ int s_tape[lum::TAPE_INS_WORDS * lum::TAPE_MAX_INS];
  lum::load_tape(a, s_tape);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  qm31 acc = {0, 0, 0, 0};
  qm31 prev = {0, 0, 0, 0};
  int k = 0, b = 0;
  lum::run_tape<Halo>(
      s_tape, a, r,
      [&](uint32_t v) {
        acc = lum::qadd(acc, lum::qmul_m31(lum::qword(a.pows[k]), v));
        k++;
      },
      [&](int kind, uint32_t m, uint32_t v0, uint32_t v1, bool two) {
        qm31 c = logup_constraint<Halo>(a, b, r, prev, m, lum::denominator(a, kind, v0, v1, two));
        acc = lum::qadd(acc, lum::qmul(c, lum::qword(a.pows[a.n_constraints + b])));
        b++;
      });
  // 1 / V_n(x): n - 1 squarings pi(x) = 2x^2 - 1, then one inverse.
  uint32_t v = ((const uint32_t*)a.xs)[r];
  for (int i = 0; i < a.log_trace - 1; i++) {
    uint32_t v2 = lum::mul(v, v);
    v = lum::sub(lum::add(v2, v2), 1u);
  }
  acc = lum::qmul_m31(acc, lum::inv(v));
  uint32_t* out = (uint32_t*)a.out + 4 * r;
  if (a.accumulate) acc = lum::qadd(lum::qload(out), acc);
  lum::qstore(out, acc);
}

// The check: one thread a row of one component (check.cuh).
__global__ void __launch_bounds__(lum::CHECK_THREADS) check_tapes_kernel(const __grid_constant__ lum::CheckArgs a) {
  lum::check_cta_row(a, blockIdx.x, threadIdx.x);
}

// ---------------------------------------------------------------------------
// M31 prefix sum of `cols` rows of length n, in place.

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

// Exclusive M31 scan across the block (blockDim a multiple of 32, at most
// 1024; every thread calls it).
__device__ uint32_t block_exclusive_scan(uint32_t x) {
  __shared__ uint32_t warp_tot[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  uint32_t inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc = lum::add(inc, y);
  }
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  if (w == 0) {
    uint32_t t = lane < nw ? warp_tot[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = lum::add(t, y);
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  uint32_t before = w > 0 ? warp_tot[w - 1] : 0u;
  return lum::add(before, lum::sub(inc, x));
}

// sums[c * nb + t] = the sum of tile t of row c.
__global__ void scan_tile_sums(const uint32_t* __restrict__ data, long long n, int nb,
                               uint32_t* __restrict__ sums) {
  __shared__ unsigned long long warp_sum[SCAN_THREADS / 32];
  const uint32_t* col = data + blockIdx.y * n;
  const long long base = (long long)blockIdx.x * SCAN_TILE;
  unsigned long long s = 0;  // at most SCAN_TILE values below 2^31
  for (int i = threadIdx.x; i < SCAN_TILE; i += blockDim.x) {
    long long r = base + i;
    if (r < n) s += col[r];
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < SCAN_THREADS / 32; w++) t += warp_sum[w];
    sums[blockIdx.y * nb + blockIdx.x] = (uint32_t)(t % lum::P);
  }
}

// The tile sums of row blockIdx.x, replaced by their exclusive prefix.
__global__ void scan_tile_offsets(uint32_t* sums, int nb) {
  uint32_t* s = sums + (long long)blockIdx.x * nb;
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int lo = min(nb, (int)threadIdx.x * per), hi = min(nb, lo + per);
  uint32_t t = 0;
  for (int i = lo; i < hi; i++) t = lum::add(t, s[i]);
  uint32_t ex = block_exclusive_scan(t);
  for (int i = lo; i < hi; i++) {
    uint32_t v = s[i];
    s[i] = ex;
    ex = lum::add(ex, v);
  }
}

// Each tile's inclusive scan plus the tile's offset, written in place.
__global__ void scan_tile_apply(uint32_t* data, long long n, int nb, const uint32_t* __restrict__ offs) {
  uint32_t* col = data + blockIdx.y * n;
  const long long base = (long long)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  uint32_t v[SCAN_ITEMS];
  uint32_t t = 0;
  for (int k = 0; k < SCAN_ITEMS; k++) {
    long long r = base + k;
    t = lum::add(t, r < n ? col[r] : 0u);
    v[k] = t;
  }
  uint32_t ex = lum::add(block_exclusive_scan(t), offs[blockIdx.y * nb + blockIdx.x]);
  for (int k = 0; k < SCAN_ITEMS; k++) {
    long long r = base + k;
    if (r < n) col[r] = lum::add(ex, v[k]);
  }
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

unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

// Checked against kernels.py when the library loads.
extern "C" long long lum_air_args_size() { return (long long)sizeof(AirArgs); }
extern "C" long long lum_tape_max_regs() { return lum::TAPE_MAX_REGS; }
extern "C" long long lum_tape_max_ins() { return lum::TAPE_MAX_INS; }
extern "C" long long lum_check_args_size() { return (long long)sizeof(lum::CheckArgs); }
extern "C" long long lum_check_threads() { return lum::CHECK_THREADS; }
extern "C" long long lum_check_kinds() { return lum::CHECK_KINDS; }
extern "C" long long lum_carry_args_size() { return (long long)sizeof(CarryArgs); }
extern "C" long long lum_carry_threads() { return CARRY_THREADS; }

extern "C" int lum_air_witness(const AirArgs* args, void* stream) {
  if (args->n > 0) {
    air_witness_kernel<<<blocks_for(args->n, 128), 128, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int lum_air_domain(const AirArgs* args, void* stream) {
  if (args->n > 0) {
    air_domain_kernel<false><<<blocks_for(args->n, 128), 128, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

// A row block of the domain with its halo (AirArgs.next, .prev).
extern "C" int lum_air_domain_halo(const AirArgs* args, void* stream) {
  if (args->n > 0) {
    air_domain_kernel<true><<<blocks_for(args->n, 128), 128, 0, (cudaStream_t)stream>>>(*args);
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

// Prefix sums of `cols` contiguous rows of length n, in place; `sums` is
// scratch of cols * ceil(n / 1024) words.
extern "C" int lum_m31_scan(uint32_t* data, long long n, int cols, uint32_t* sums, void* stream) {
  if (n > 0 && cols > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    int nb = (int)blocks_for(n, SCAN_TILE);
    dim3 grid(nb, cols);
    scan_tile_sums<<<grid, SCAN_THREADS, 0, s>>>(data, n, nb, sums);
    scan_tile_offsets<<<cols, 1024, 0, s>>>(sums, nb);
    scan_tile_apply<<<grid, SCAN_THREADS, 0, s>>>(data, n, nb, sums);
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
