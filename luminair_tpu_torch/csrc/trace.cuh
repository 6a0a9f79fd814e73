// The trace interpreter's per-row work (csrc/trace.cu): fixed-point int64
// arithmetic with numpy's semantics, strided-view resolution, and the
// column writes of one row of a trace table.
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
//     and the host's single clamp in each direction, with wrapping squares.
// The struct and the enums below are mirrored by luminair_tpu_torch/kernels.py
// (TraceArgs, TRACE_OPS, TRACE_COLS), which checks sizeof and the counts
// when the library loads.
#pragma once

#include <math.h>
#include <stdint.h>

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

// A strided view over a physical int64 buffer of `len` elements: logical
// coordinate c_d outside [lo_d, hi_d) reads 0 (graph/view.py).
struct ViewDesc {
  long long sizes[VIEW_MAX_DIMS];
  long long strides[VIEW_MAX_DIMS];
  long long lo[VIEW_MAX_DIMS];
  long long hi[VIEW_MAX_DIMS];
  long long base;
  long long len;
  int ndim;
  int pad_;
};

// Everything one launch reads besides the buffers, passed by value.
struct TraceArgs {
  unsigned long long src[2];  // int64 source buffers
  ViewDesc view[2];
  unsigned long long out;     // int64 node output, or 0
  unsigned long long cols[C_N_COLS];
  unsigned long long lut_lo, lut_hi, lut_start, lut_out;  // int64: ranges and the outputs table
  unsigned long long mult;    // uint32 histogram (LUT or range-check multiplicities), or 0
  unsigned long long flag;    // int32 word set to 1 on an input out of range, or 0
  long long n;                // rows (T1, T2) or outputs (T3) of the launch
  long long n_in, n_out;      // contiguous: raw buffer length, gathered length
  long long dsize, back;      // reductions: the reduced axis and the elements after it
  long long lut_n;            // entries of the LUT outputs table
  int op;
  int n_ranges;
  uint32_t node_id, id0, id1;  // node, lhs / input, rhs ids
  uint32_t out_mult, in_mult;
  uint32_t pad_;
};

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

__device__ __forceinline__ uint32_t to_m31(long long v) {
  long long r = v % M31_P;
  return (uint32_t)(r < 0 ? r + M31_P : r);
}

// Logical element i of the view over `buf` (0 outside the valid box; the
// physical index is clamped into the buffer as the host's gather does).
__device__ __forceinline__ long long gather(const ViewDesc& v, const long long* buf, long long i) {
  long long phys = v.base;
  bool ok = true;
  for (int d = v.ndim - 1; d >= 0; d--) {
    const long long size = v.sizes[d] > 0 ? v.sizes[d] : 1;
    const long long c = i % size;
    i /= size;
    phys += c * v.strides[d];
    ok = ok && c >= v.lo[d] && c < v.hi[d];
  }
  if (!ok) return 0;
  phys = phys < 0 ? 0 : (phys >= v.len ? v.len - 1 : phys);
  return buf[phys];
}

struct Row {
  const TraceArgs& a;
  long long r;  // row within the node's block
  __device__ __forceinline__ void put(int slot, uint32_t v) const {
    if (a.cols[slot]) ((uint32_t*)a.cols[slot])[r] = v;
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

__device__ __forceinline__ void count(const TraceArgs& a, long long pos) {
  if (a.mult) atomicAdd((unsigned int*)a.mult + pos, 1u);
}

__device__ __forceinline__ void raise_flag(const TraceArgs& a) {
  if (a.flag) *(volatile int*)a.flag = 1;
}

// T1: add / mul / rem / less_than at row i.
__device__ __forceinline__ void binary_row(const TraceArgs& a, long long i) {
  const long long x = gather(a.view[0], (const long long*)a.src[0], i);
  const long long y = gather(a.view[1], (const long long*)a.src[1], i);
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
__device__ __forceinline__ long long find_index(const TraceArgs& a, long long x) {
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
__device__ __forceinline__ void unary_row(const TraceArgs& a, long long r) {
  const Row row{a, r};
  const long long* src = (const long long*)a.src[0];
  row.common(r, a.n - 1);
  if (a.op == T_CONTIGUOUS) {
    // max(n_in, n_out) rows: the raw buffer is consumed element by element
    // beside the gathered output (graph/trace.py, contiguous).
    const bool in = r < a.n_in, has_out = r < a.n_out;
    const long long g = has_out ? gather(a.view[0], src, r) : 0;
    row.put(C_INPUT, to_m31(in ? src[r] : 0));
    row.put(C_OUT, to_m31(g));
    row.put(C_INPUT_MULT, in ? a.in_mult : 0u);
    row.put(C_OUT_MULT, has_out ? a.out_mult : 0u);
    if (a.out && has_out) ((long long*)a.out)[r] = g;
    return;
  }
  const long long x = gather(a.view[0], src, r);
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
      raw[t] = scan[t] = gather(a.view[0], (const long long*)a.src[0], (i * ds + k) * a.back + j);
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

}  // namespace lum
