// The trace interpreter's per-row work (csrc/trace.cu): fixed-point int64
// arithmetic with numpy's semantics, strided-view resolution, the column
// writes of one row of a trace table, and the tiles and phases of the
// segment interpreter.
//
// numpy is the spec (luminair_tpu_torch/fixed.py, graph/view.py):
//   * int64 sums and products wrap modulo 2^64: computed on uint64 and
//     reinterpreted (signed overflow is undefined in C++);
//   * to_m31 is a floor-mod (C++ `%` truncates: a negative remainder gets
//     P added);
//   * division truncates toward zero, a divisor of 0 gives 0, and
//     INT64_MIN / -1 gives the wrapped negation (as numpy's floor-division
//     path does; C++ leaves it undefined);
//   * sqrt takes the float64 estimate of the clamped product (IEEE sqrt is
//     correctly rounded here and on the host, so the estimate is the same)
//     and the host's single clamp in each direction, with wrapping squares;
//   * an input's encoding (fixed.from_float) rounds x * 2^12 half to even
//     (the product is exact, rint is numpy's round), NaN gives 0, and the
//     result saturates at +-2^62 (infinities too).
// The structs and the enums below are mirrored by luminair_tpu_torch/kernels.py
// (ViewDesc, TraceArgs, SegPhase, SegArgs, TRACE_OPS, TRACE_COLS), which
// checks their sizes, their field offsets and the counts when the library
// loads.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace lum {

constexpr int VIEW_MAX_DIMS = 8;
constexpr long long FP_SCALE = 1 << 12;
constexpr long long M31_P = 0x7fffffffLL;
constexpr uint32_t NEG1 = 0x7ffffffeu;  // -1 in M31

enum TraceOp : int {
  T_ADD,
  T_MUL,
  T_REM,
  T_LESS_THAN,
  T_INPUTS,
  T_RECIP,
  T_SQUARE,
  T_SQRT,
  T_LUT,
  T_CONTIGUOUS,
  T_SUM_REDUCE,
  T_MAX_REDUCE,
  T_PAD,     // a table's padding rows: every column given gets out_mult
  T_ENCODE,  // an input's float64 bits to its int64 fixed encoding (no columns)
  T_N_OPS
};

// Column slots: cols[slot] points at the column's row of the node's first
// row, or is 0 when the table has no such column (or nothing is recorded).
enum TraceCol : int {
  C_NODE_ID,
  C_IDX,
  C_IS_LAST_IDX,
  C_NEXT_NODE_ID,
  C_NEXT_IDX,
  C_LHS_ID,
  C_NEXT_LHS_ID,
  C_RHS_ID,
  C_NEXT_RHS_ID,
  C_INPUT_ID,
  C_NEXT_INPUT_ID,
  C_LHS,
  C_RHS,
  C_INPUT,
  C_OUT,
  C_REM,
  C_QUOTIENT,
  C_BORROW,
  C_DIFF,
  C_LIMB0,
  C_LIMB1,
  C_LIMB2,
  C_LIMB3,
  C_SCALE,
  C_LOOKUP_MULT,
  C_LHS_MULT,
  C_RHS_MULT,
  C_INPUT_MULT,
  C_OUT_MULT,
  C_RANGE_CHECK_MULT,
  C_VAL,
  C_MULTIPLICITY,
  C_ACC,
  C_NEXT_ACC,
  C_MAX_VAL,
  C_NEXT_MAX_VAL,
  C_IS_MAX,
  C_IS_LAST_STEP,
  C_GE_LIMB0,
  C_GE_LIMB1,
  C_GE_LIMB2,
  C_GE_LIMB3,
  C_N_COLS
};

// A strided view over a physical int64 buffer of `len` elements, packed
// by graph/view.py (View.packed): dimensions that resolve as one are merged,
// and logical coordinate c_d outside [lo_d, hi_d) reads 0.  Each size has a
// fast-divmod pair: floor(n / sizes[d]) = (n * magic[d]) >> shift[d] for
// every n < 2^31 (magic = ceil(2^shift / size), shift = 31 + ceil(log2
// size)), so a row resolves its coordinates with 32-bit products and no
// division.  A view has fewer than 2^31 elements.  `fresh` marks a buffer
// written earlier in the same launch (an earlier phase or item of the
// chain of a segment): it is read through L2 only; any other buffer is
// read-only while the kernel runs, and is read through the read-only cache.
struct ViewDesc {
  long long strides[VIEW_MAX_DIMS];
  long long base;
  long long len;
  uint32_t sizes[VIEW_MAX_DIMS];
  uint32_t magic[VIEW_MAX_DIMS];
  uint32_t shift[VIEW_MAX_DIMS];
  int32_t lo[VIEW_MAX_DIMS];  // clamped into [0, size]
  int32_t hi[VIEW_MAX_DIMS];
  int ndim;
  int fresh;
};

// One row range of a launch: a node's rows (T1, T2, T3), or a table's
// padding rows (T_PAD: n = the padding rows x the columns cols[0 .. m),
// row r the word r % pad of column r / pad, view[0].sizes[1] = pad with its
// fast-divmod pair).  A trace segment reads a table of them from device
// memory; T3 takes one by value.
struct TraceArgs {
  unsigned long long src[2];  // int64 source buffers
  ViewDesc view[2];
  unsigned long long out;     // int64 node output, or 0
  unsigned long long cols[C_N_COLS];
  unsigned long long lut_lo, lut_hi, lut_start, lut_out;  // int64: ranges and the outputs table
  unsigned long long mult;    // uint32 histogram (LUT or range-check multiplicities), or 0
  unsigned long long flag;    // int32 word set to 1 on an input out of range, or 0
  long long n;                // rows (T1, T2, T_PAD) or outputs (T3)
  long long n_in, n_out;      // contiguous: raw buffer length, gathered length
  long long dsize, back;      // reductions: the reduced axis and the elements after it
  long long lut_n;            // entries of the LUT outputs table
  int op;
  int n_ranges;
  uint32_t node_id, id0, id1;  // node, lhs / input, rhs ids
  uint32_t out_mult, in_mult;  // T_PAD: the padding value in out_mult
  uint32_t pad_;
};

// A chain of a segment: items [first, first + count) of the pass's table,
// all of the same rows, run tile by tile in order -- each thread runs its
// rows of the first item, then the same rows of the next, so an item may
// read what an earlier item of its chain wrote at its own row (a view that
// maps row r to element r) with no barrier.  Its rows are cut into tiles of
// SEG_TILE << shift rows (1 << shift a thread); tile0 is its first tile in
// its phase.
struct SegChain {
  int first;
  int count;
  long long tile0;
  int shift;
  int pad_;
};

// A phase of a segment: chains [first, first + count) of the pass, `tiles`
// tiles in all.  No chain of a phase reads what another chain of it writes.
struct SegPhase {
  int first;
  int count;
  long long tiles;
};

// One launch of the segment interpreter: phases [p0, p1) of a pass.
struct SegArgs {
  unsigned long long nodes;    // TraceArgs[] of the pass
  unsigned long long chains;   // SegChain[] of the pass
  unsigned long long phases;   // SegPhase[] of the pass
  unsigned long long barrier;  // uint32[2]: arrivals, generation (zero when the pass starts)
  long long max_tiles;         // the most tiles of a phase in [p0, p1)
  int p0, p1;
};

constexpr int SEG_THREADS = 256;
constexpr long long SEG_TILE = SEG_THREADS;  // rows of a tile: one a thread
constexpr int SEG_CHAIN = 8;                 // descriptors a CTA holds at once

// Checked against kernels.py: the offsets of the fields, folded in order.
constexpr unsigned long long fold_offset(unsigned long long h, size_t off) {
  return (h * 1000003ull + off) & 0x1fffffffffffffffull;
}

constexpr unsigned long long trace_layout() {
  unsigned long long h = 0;
  h = fold_offset(h, offsetof(ViewDesc, strides));
  h = fold_offset(h, offsetof(ViewDesc, base));
  h = fold_offset(h, offsetof(ViewDesc, len));
  h = fold_offset(h, offsetof(ViewDesc, sizes));
  h = fold_offset(h, offsetof(ViewDesc, magic));
  h = fold_offset(h, offsetof(ViewDesc, shift));
  h = fold_offset(h, offsetof(ViewDesc, lo));
  h = fold_offset(h, offsetof(ViewDesc, hi));
  h = fold_offset(h, offsetof(ViewDesc, ndim));
  h = fold_offset(h, offsetof(ViewDesc, fresh));
  h = fold_offset(h, offsetof(TraceArgs, src));
  h = fold_offset(h, offsetof(TraceArgs, view));
  h = fold_offset(h, offsetof(TraceArgs, out));
  h = fold_offset(h, offsetof(TraceArgs, cols));
  h = fold_offset(h, offsetof(TraceArgs, lut_lo));
  h = fold_offset(h, offsetof(TraceArgs, mult));
  h = fold_offset(h, offsetof(TraceArgs, flag));
  h = fold_offset(h, offsetof(TraceArgs, n));
  h = fold_offset(h, offsetof(TraceArgs, n_in));
  h = fold_offset(h, offsetof(TraceArgs, dsize));
  h = fold_offset(h, offsetof(TraceArgs, lut_n));
  h = fold_offset(h, offsetof(TraceArgs, op));
  h = fold_offset(h, offsetof(TraceArgs, n_ranges));
  h = fold_offset(h, offsetof(TraceArgs, node_id));
  h = fold_offset(h, offsetof(TraceArgs, out_mult));
  h = fold_offset(h, offsetof(TraceArgs, in_mult));
  h = fold_offset(h, offsetof(SegChain, tile0));
  h = fold_offset(h, offsetof(SegChain, shift));
  h = fold_offset(h, offsetof(SegPhase, tiles));
  h = fold_offset(h, offsetof(SegArgs, chains));
  h = fold_offset(h, offsetof(SegArgs, max_tiles));
  h = fold_offset(h, offsetof(SegArgs, p0));
  return h;
}

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

__device__ __forceinline__ long long trunc_div(long long a, long long b) {
  if (b == 0) return 0;
  if (b == -1) return wsub(0, a);
  return a / b;
}

// The floor-mod of v by P = 2^31 - 1 with no 64-bit division: u = v + 2^63
// (the bits of v with the top one flipped) is v + 2 modulo P, since 2^31 is
// 1 modulo P; two folds of 31 bits leave it below 2^31 + 5.
__device__ __forceinline__ uint32_t to_m31(long long v) {
  const unsigned long long u = (unsigned long long)v ^ (1ull << 63);
  unsigned long long f = (u & (unsigned long long)M31_P) + (u >> 31);
  f = (f & (unsigned long long)M31_P) + (f >> 31);
  long long r = (long long)f - 2;
  r = r >= M31_P ? r - M31_P : r;
  return (uint32_t)(r < 0 ? r + M31_P : r);
}

// A source element: through L2 only when the launch wrote it (so a row of
// a later phase never sees a stale L1 line of what an earlier phase wrote),
// else through the read-only cache (a small buffer read by a broadcast or a
// stride stays near the SM).
__host__ __device__ __forceinline__ long long load_src(const long long* p, int fresh) {
#ifdef __CUDA_ARCH__
  return fresh ? __ldcg(p) : __ldg(p);
#else
  return *p;
#endif
}

// A column word, stored streaming (evict first): the trace never reads its
// columns back (tools/kernel_timing.py --kernels trace_segment measures
// the choice).
__host__ __device__ __forceinline__ void store_col(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  __stcs((unsigned int*)p, v);
#else
  *p = v;
#endif
}

__host__ __device__ __forceinline__ uint32_t fast_div(uint32_t n, uint32_t magic, uint32_t shift) {
  return (uint32_t)(((unsigned long long)n * magic) >> shift);
}

// Logical element i of the view over `buf`, i below the view's element
// count (so the outermost coordinate is what is left of i once the inner
// ones are taken off): 0 outside the valid box; the physical index is
// clamped into the buffer as the host's gather does.
__device__ __forceinline__ long long gather(const ViewDesc& v, const long long* buf, uint32_t i) {
  long long phys = v.base;
  bool ok = true;
  for (int d = v.ndim - 1; d >= 0; d--) {
    uint32_t c = i;
    if (d > 0) {
      const uint32_t q = fast_div(i, v.magic[d], v.shift[d]);
      c = i - q * v.sizes[d];
      i = q;
    }
    phys = wadd(phys, wmul((long long)c, v.strides[d]));
    ok = ok && (int32_t)c >= v.lo[d] && (int32_t)c < v.hi[d];
  }
  if (!ok) return 0;
  phys = phys < 0 ? 0 : (phys >= v.len ? v.len - 1 : phys);
  return load_src(buf + phys, v.fresh);
}

struct Row {
  const TraceArgs& a;
  long long r;  // row within the node's block
  __device__ __forceinline__ void put(int slot, uint32_t v) const {
    if (a.cols[slot]) store_col((uint32_t*)a.cols[slot] + r, v);
  }
  // node_id, idx, is_last_idx, next_*, and the source ids: `idx` is the
  // row (the output index for reductions), `last` its largest value.
  __device__ __forceinline__ void common(long long idx, long long last) const {
    put(C_NODE_ID, a.node_id);
    put(C_NEXT_NODE_ID, a.node_id);
    put(C_IDX, (uint32_t)idx);
    put(C_NEXT_IDX, (uint32_t)(idx + 1));
    put(C_IS_LAST_IDX, idx == last ? 1u : 0u);
    put(C_LHS_ID, a.id0);
    put(C_NEXT_LHS_ID, a.id0);
    put(C_INPUT_ID, a.id0);
    put(C_NEXT_INPUT_ID, a.id0);
    put(C_RHS_ID, a.id1);
    put(C_NEXT_RHS_ID, a.id1);
  }
};

__device__ __forceinline__ void count(const TraceArgs& __restrict__ a, long long pos) {
  if (a.mult) atomicAdd((unsigned int*)a.mult + pos, 1u);
}

__device__ __forceinline__ void raise_flag(const TraceArgs& __restrict__ a) {
  if (a.flag) *(volatile int*)a.flag = 1;
}

// T1: add / mul / rem / less_than at row i.
__device__ __forceinline__ void binary_row(const TraceArgs& __restrict__ a, long long i) {
  const long long x = gather(a.view[0], (const long long*)a.src[0], (uint32_t)i);
  const long long y = gather(a.view[1], (const long long*)a.src[1], (uint32_t)i);
  const Row row{a, i};
  long long out;
  switch (a.op) {
    case T_ADD:
      out = wadd(x, y);
      row.put(C_OUT, to_m31(out));
      break;
    case T_MUL: {
      const long long prod = wmul(x, y);
      out = trunc_div(prod, FP_SCALE);
      row.put(C_OUT, to_m31(out));
      row.put(C_REM, to_m31(wsub(prod, wmul(out, FP_SCALE))));
      break;
    }
    case T_REM: {
      const long long q = trunc_div(x, y);
      out = wsub(x, wmul(q, y));
      row.put(C_REM, to_m31(out));
      row.put(C_QUOTIENT, to_m31(q));
      break;
    }
    default: {  // T_LESS_THAN
      const bool lt = x < y;
      out = lt ? FP_SCALE : 0;
      const long long diff = wadd(wsub(y, x), lt ? 0 : M31_P);
      const uint32_t d = (uint32_t)(unsigned long long)diff;
      const uint32_t limbs[4] = {d & 0xffu, (d >> 8) & 0xffu, (d >> 16) & 0xffu, (d >> 24) & 0xffu};
      row.put(C_OUT, to_m31(out));
      row.put(C_BORROW, lt ? 0u : 1u);
      row.put(C_DIFF, to_m31(diff));
      row.put(C_LIMB0, limbs[0]);
      row.put(C_LIMB1, limbs[1]);
      row.put(C_LIMB2, limbs[2]);
      row.put(C_LIMB3, limbs[3]);
      row.put(C_RANGE_CHECK_MULT, 1u);
      for (int k = 0; k < 4; k++) count(a, limbs[k]);
      break;
    }
  }
  row.common(i, a.n - 1);
  row.put(C_LHS, to_m31(x));
  row.put(C_RHS, to_m31(y));
  row.put(C_LHS_MULT, NEG1);
  row.put(C_RHS_MULT, NEG1);
  row.put(C_OUT_MULT, a.out_mult);
  if (a.out) ((long long*)a.out)[i] = out;
}

// Position of x in the LUT's enumeration, -1 outside every range: the last
// range whose lo is <= x, by binary search over the ascending lows.
__device__ __forceinline__ long long find_index(const TraceArgs& __restrict__ a, long long x) {
  const long long* lo = (const long long*)a.lut_lo;
  int left = 0, right = a.n_ranges;  // first range with lo > x
  while (left < right) {
    const int mid = (left + right) / 2;
    if (lo[mid] <= x) left = mid + 1;
    else right = mid;
  }
  const int k = left - 1;
  if (k < 0 || x > ((const long long*)a.lut_hi)[k]) return -1;
  return ((const long long*)a.lut_start)[k] + (x - lo[k]);
}

// T2: inputs (copy_to / constant) / recip / square / sqrt / sin, exp2,
// log2 (T_LUT) / contiguous at row r.
__device__ __forceinline__ void unary_row(const TraceArgs& __restrict__ a, long long r) {
  const Row row{a, r};
  const long long* src = (const long long*)a.src[0];
  row.common(r, a.n - 1);
  if (a.op == T_CONTIGUOUS) {
    // max(n_in, n_out) rows: the raw buffer is consumed element by element
    // beside the gathered output (graph/trace.py, contiguous).
    const bool in = r < a.n_in, has_out = r < a.n_out;
    const long long g = has_out ? gather(a.view[0], src, (uint32_t)r) : 0;
    row.put(C_INPUT, to_m31(in ? load_src(src + r, a.view[0].fresh) : 0));
    row.put(C_OUT, to_m31(g));
    row.put(C_INPUT_MULT, in ? a.in_mult : 0u);
    row.put(C_OUT_MULT, has_out ? a.out_mult : 0u);
    if (a.out && has_out) ((long long*)a.out)[r] = g;
    return;
  }
  const long long x = gather(a.view[0], src, (uint32_t)r);
  long long out = x;
  switch (a.op) {
    case T_INPUTS:
      row.put(C_VAL, to_m31(x));
      row.put(C_MULTIPLICITY, a.out_mult);
      if (a.out) ((long long*)a.out)[r] = x;
      return;
    case T_RECIP: {
      const long long s2 = FP_SCALE * FP_SCALE;
      out = trunc_div(s2, x);
      row.put(C_REM, to_m31(wsub(s2, wmul(x, out))));
      row.put(C_SCALE, (uint32_t)FP_SCALE);
      break;
    }
    case T_SQUARE: {
      const long long prod = wmul(x, x);
      out = trunc_div(prod, FP_SCALE);
      row.put(C_REM, to_m31(wsub(prod, wmul(out, FP_SCALE))));
      break;
    }
    case T_SQRT: {
      const long long prod = wmul(x, FP_SCALE);
      const long long clipped = prod > 0 ? prod : 0;
      long long s = (long long)sqrt((double)clipped);
      if (wmul(s + 1, s + 1) <= clipped) s += 1;
      if (wmul(s, s) > clipped) s -= 1;
      out = s;
      row.put(C_REM, to_m31(wsub(prod, wmul(s, s))));
      row.put(C_SCALE, (uint32_t)FP_SCALE);
      break;
    }
    default: {  // T_LUT: the settings' normative outputs table
      long long pos = find_index(a, x);
      if (pos < 0) raise_flag(a);
      pos = pos < 0 ? 0 : (pos >= a.lut_n ? a.lut_n - 1 : pos);
      out = ((const long long*)a.lut_out)[pos];
      row.put(C_LOOKUP_MULT, 1u);
      count(a, pos);
      break;
    }
  }
  row.put(C_INPUT, to_m31(x));
  row.put(C_OUT, to_m31(out));
  row.put(C_INPUT_MULT, a.in_mult);
  row.put(C_OUT_MULT, a.out_mult);
  if (a.out) ((long long*)a.out)[r] = out;
}

// T3: sum_reduce / max_reduce, one thread per trace row.  Output o = (i,
// j) reduces its axis of dsize elements into rows o * dsize + k, k = 0 ..
// dsize - 1 (graph/trace.py's row order); row (o, k) records the running
// value before and after element k: an inclusive scan of the segment,
// restarting at k == 0, with wrapping int64 + (sum, associative modulo
// 2^64) or max.  A CTA of T = b.threads() threads holds floor(T / dsize)
// whole segments, or, when dsize > T, one segment walked in chunks of T
// rows that carry the running value.  Consecutive threads own consecutive
// rows, so every column store is coalesced.
//
// The Block runs the CTA's phases: `each(f)` calls f(t) for every thread t
// (on the card, each thread its own t; on the host, every t in turn), and
// `sync()` orders the phases.  A phase reads only what earlier phases wrote
// to the CTA's arrays: raw[T] (the elements), scan[2][T] (the scan, in
// ping-pong) and pos[T] (a row's place in its segment, capped at T).

__host__ __device__ __forceinline__ long long reduce_outputs_per_cta(long long dsize, int T) {
  return dsize <= T ? T / dsize : 1;
}

template <class Block>
__device__ __forceinline__ void reduce_cta(const Block& b, const TraceArgs& a, long long cta, long long* raw,
                                           long long* scan, int* pos) {
  const int T = b.threads();
  const long long ds = a.dsize;
  const bool whole = ds <= T;  // whole segments in the CTA, in one chunk
  const long long per = reduce_outputs_per_cta(ds, T), o0 = cta * per;
  const long long n_out = o0 + per <= a.n ? per : a.n - o0;
  const bool is_sum = a.op == T_SUM_REDUCE;
  long long carry = 0;  // the running value at the row before the chunk
  for (long long c0 = 0; c0 < n_out * ds; c0 += T) {
    const int m = (int)(n_out * ds - c0 < T ? n_out * ds - c0 : T);
    b.sync();  // the last chunk's arrays are no longer read
    b.each([&](int t) {
      if (t >= m) return;
      const long long o = o0 + (whole ? t / ds : 0), k = whole ? t % ds : c0 + t;
      const long long i = o / a.back, j = o % a.back;
      raw[t] = scan[t] = gather(a.view[0], (const long long*)a.src[0], (uint32_t)((i * ds + k) * a.back + j));
      pos[t] = (int)(k < T ? k : T);
    });
    long long* src = scan;
    long long* dst = scan + T;
    for (int off = 1; off < m; off <<= 1) {
      b.sync();
      b.each([&](int t) {
        if (t >= m) return;
        const long long x = src[t];
        if (t >= off && pos[t] >= off) {  // row t - off is in the same segment
          const long long y = src[t - off];
          dst[t] = is_sum ? wadd(y, x) : (y > x ? y : x);
        } else {
          dst[t] = x;
        }
      });
      long long* swap = src;
      src = dst;
      dst = swap;
    }
    if (!whole && c0 > 0) {  // the segment began in an earlier chunk
      b.sync();
      b.each([&](int t) {
        if (t < m) src[t] = is_sum ? wadd(carry, src[t]) : (carry > src[t] ? carry : src[t]);
      });
    }
    b.sync();
    b.each([&](int t) {
      if (t >= m) return;
      const long long o = o0 + (whole ? t / ds : 0), k = whole ? t % ds : c0 + t;
      const long long v = raw[t], run = src[t];
      const bool last = k == ds - 1;
      const long long before = k == 0 ? (is_sum ? 0 : v) : (t > 0 ? src[t - 1] : carry);
      const Row row{a, o * ds + k};
      if (!is_sum) {  // T_MAX_REDUCE, with the >= witness limbs (8/8/8/6 bits)
        const bool is_max = v > before;
        const long long ge = wsub(run, is_max ? before : v);
        if (ge < 0 || ge >= (1LL << 30)) raise_flag(a);
        const uint32_t g = (uint32_t)(unsigned long long)ge;
        const uint32_t limbs[4] = {g & 0xffu, (g >> 8) & 0xffu, (g >> 16) & 0xffu, (g >> 24) & 0x3fu};
        row.put(C_IS_MAX, is_max ? 1u : 0u);
        row.put(C_GE_LIMB0, limbs[0]);
        row.put(C_GE_LIMB1, limbs[1]);
        row.put(C_GE_LIMB2, limbs[2]);
        row.put(C_GE_LIMB3, limbs[3]);
        row.put(C_RANGE_CHECK_MULT, 1u);
        count(a, limbs[0]);
        count(a, limbs[1]);
        count(a, limbs[2]);
        count(a, limbs[3] * 4);
      }
      row.common(o, a.n - 1);
      row.put(C_INPUT, to_m31(v));
      row.put(C_OUT, last ? to_m31(run) : 0u);
      // A table has either acc / next_acc (sum) or max_val / next_max_val.
      row.put(C_ACC, to_m31(before));
      row.put(C_NEXT_ACC, to_m31(run));
      row.put(C_MAX_VAL, to_m31(before));
      row.put(C_NEXT_MAX_VAL, to_m31(run));
      row.put(C_IS_LAST_STEP, last ? 1u : 0u);
      row.put(C_INPUT_MULT, a.in_mult);
      row.put(C_OUT_MULT, last ? a.out_mult : 0u);
      if (last && a.out) ((long long*)a.out)[o] = run;  // only a segment's last row writes the output
    });
    b.sync();
    carry = src[m - 1];
  }
}

// T_PAD: word r of a table's padding rows, column after column (`rows`
// padding rows a column, with their fast-divmod pair).
__device__ __forceinline__ void pad_word(const unsigned long long* cols, uint32_t magic, uint32_t shift, uint32_t rows,
                                         uint32_t value, long long r) {
  const uint32_t k = fast_div((uint32_t)r, magic, shift);
  store_col((uint32_t*)cols[k] + ((uint32_t)r - k * rows), value);
}

__device__ __forceinline__ void pad_row(const TraceArgs& __restrict__ a, long long r) {
  pad_word(a.cols, a.view[0].magic[1], a.view[0].shift[1], a.view[0].sizes[1], a.out_mult, r);
}

// T_ENCODE: the fixed encoding of the double whose bits are `bits`.  NaN
// is tested on the bits, before any comparison (fmin / fmax would return
// the other operand, and a fast-math build may drop `x != x`).
__host__ __device__ __forceinline__ long long fixed_from_bits(long long bits) {
  constexpr unsigned long long ABS = 0x7fffffffffffffffull, INF = 0x7ff0000000000000ull;
  if (((unsigned long long)bits & ABS) > INF) return 0;
#ifdef __CUDA_ARCH__
  const double x = __longlong_as_double(bits);
#else
  double x;
  memcpy(&x, &bits, sizeof x);
#endif
  const double s = rint(x * (double)FP_SCALE);
  constexpr double LIM = 4611686018427387904.0;  // 2^62
  return s >= LIM ? (1LL << 62) : (s <= -LIM ? -(1LL << 62) : (long long)s);
}

// Row r of an encode item: word r of its source, the bits of a double, to
// word r of its output (another region: the item can run again).
__device__ __forceinline__ void encode_row(const TraceArgs& __restrict__ a, long long r) {
  ((long long*)a.out)[r] = fixed_from_bits(load_src((const long long*)a.src[0] + r, a.view[0].fresh));
}

// Row r of a segment's item.
__device__ __forceinline__ void segment_row(const TraceArgs& __restrict__ a, long long r) {
  switch (a.op) {
    case T_ADD:
    case T_MUL:
    case T_REM:
    case T_LESS_THAN:
      binary_row(a, r);
      break;
    case T_PAD:
      pad_row(a, r);
      break;
    case T_ENCODE:
      encode_row(a, r);
      break;
    default:
      unary_row(a, r);
      break;
  }
}

// The segment interpreter (trace.cu): the phases [p0, p1) of a segment run
// in order; every CTA takes tiles of the current phase's chains, and the
// whole grid meets at a barrier before each phase but the first, since each
// later phase reads what the phase before it wrote.
__host__ __device__ __forceinline__ bool barrier_before(int p, int p0) { return p > p0; }

// The chain that tile t of a phase belongs to: the last of the phase's
// chains whose first tile is at most t (a chain of no rows has no tile).
__host__ __device__ __forceinline__ int tile_chain(const SegChain* chains, const SegPhase& ph, long long t) {
  int lo = ph.first, hi = ph.first + ph.count;  // the answer is in [lo, hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (chains[mid].tile0 <= t) lo = mid;
    else hi = mid;
  }
  return lo;
}

// The rows of tile t of item `a` (t counted from its chain's first tile,
// SEG_TILE << shift rows a tile): thread k of the block takes rows k, k +
// T, ..., so each column store of a warp is coalesced, and a thread takes
// the same rows of every item of the chain.
template <class Block>
__device__ __forceinline__ void tile_rows(const Block& b, const TraceArgs& __restrict__ a, long long t, int shift) {
  const long long r0 = (t * SEG_TILE) << shift;
  const long long end = r0 + (SEG_TILE << shift) < a.n ? r0 + (SEG_TILE << shift) : a.n;
  const int T = b.threads();
  if (a.op == T_PAD) {  // the split and the value once a tile, not once a word
    const uint32_t magic = a.view[0].magic[1], sh = a.view[0].shift[1], rows = a.view[0].sizes[1], v = a.out_mult;
    b.each([&](int k) {
      for (long long r = r0 + k; r < end; r += T) pad_word(a.cols, magic, sh, rows, v, r);
    });
    return;
  }
  b.each([&](int k) {
    for (long long r = r0 + k; r < end; r += T) segment_row(a, r);
  });
}

}  // namespace lum
