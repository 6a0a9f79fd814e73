// The trace-domain constraint check (air_check), one row per thread, each
// component's tape compiled (check_tapes.cuh): no interpreter, no register
// array, every column a compile-time index into its component's table.
//
// Per trace row r of a component: the K recorded constraints, bit k set
// when the k-th is nonzero; then per relation entry b the LogUp constraint
//     (S_b(r) - S_{b-1}(r) [- S_last(r - 1) + is_first(r) * claimed]) * d_b - n_b
// (the bracket on the last entry only), bit K + b set when any of its four
// coordinates is nonzero; d_b = v0 + alpha * v1 - z.  Next row r + 1 and
// previous row r - 1, cyclic.  One word per row.  This is K6's sum
// without the alpha powers and the 1 / V_n factor (V_n vanishes on the
// trace domain); the JAX package computes it on the host (air/debug.py,
// _CheckEval), and the plain twin is air/tape.py `check_plain`.
//
// One launch checks every component of a PIE: the CTAs of a component are
// consecutive (CheckComp.cta0), so a CTA runs one component's code; each
// writes its rows' words from CheckComp.out of one output.  The table is a
// kernel parameter (CheckArgs: 5,808 bytes, above the 4 KB that CUDA
// before 12.1 allows), so a check is one launch and no upload.
//
// The code builds with g++ too (define __host__ and __device__ empty and
// __forceinline__ inline): check_cta_row is one thread's work, and
// tests/test_torch_check_tapes.py runs every CTA's rows of a launch's table
// through it on the CPU.
#pragma once

#include "m31.cuh"

namespace lum {

constexpr int CHECK_MAX_COMPS = 32;
constexpr int CHECK_MAX_COLS = 512;
constexpr int CHECK_THREADS = 256;  // rows of a CTA
constexpr int CHECK_ELEM_KINDS = 5;  // tape.cuh TAPE_KINDS

// One component of a check launch.  Mirrored by kernels.CheckComp.
struct CheckComp {
  long long n;         // rows, a power of two
  long long out;       // the word of its first row in CheckArgs.out
  int kind;            // its compiled tape (LUM_CHECK_TAPES)
  int col0;            // its first column in CheckArgs.cols
  int cta0;            // its first CTA
  int pad;
  uint32_t claimed[4];  // its claimed sum
};

// Everything a check launch reads besides the columns.  Mirrored by
// kernels.CheckArgs.
struct CheckArgs {
  // Per component from its col0: main columns, preprocessed columns, the
  // 4E interaction coordinates (entry b's at 4b..4b+3), is_first.
  unsigned long long cols[CHECK_MAX_COLS];
  CheckComp comps[CHECK_MAX_COMPS];
  unsigned long long out;  // uint32 words, one per row of every component
  int n_comps;
  int n_ctas;
  uint32_t elems[CHECK_ELEM_KINDS][2][4];  // lookup elements z, alpha per kind
};

// 1 when x (below 2^31) is nonzero, else 0, by integer operations alone.
// A constraint's bit is set with this and not with a comparison: from
// (x != 0u ? 1u : 0u) ORed into the word, ptxas (CUDA 12.9, -O1 and above)
// built max_reduce's check with bits 5 and 13 lost on every row; with
// ptxas -O0, or with this form, every component's word equals the twin's.
__host__ __device__ __forceinline__ uint32_t nonzero(uint32_t x) { return (x | (0u - x)) >> 31; }

// One row of one component, as the compiled tapes read it.
struct CheckRow {
  const CheckArgs& a;
  const CheckComp& c;
  const unsigned long long* cols;  // the component's columns
  long long r, rn, rp;             // this row, the next and the previous (cyclic)

  __host__ __device__ __forceinline__ uint32_t at(int i) const { return ((const uint32_t*)cols[i])[r]; }
  __host__ __device__ __forceinline__ uint32_t next(int i) const { return ((const uint32_t*)cols[i])[rn]; }
  __host__ __device__ __forceinline__ qm31 quad(int i, long long row) const {
    return {((const uint32_t*)cols[i])[row], ((const uint32_t*)cols[i + 1])[row],
            ((const uint32_t*)cols[i + 2])[row], ((const uint32_t*)cols[i + 3])[row]};
  }

  // 1 when the LogUp constraint of the entry whose sums start at column
  // Col does not vanish, else 0.  `prev` holds S_{b-1} (zero before the
  // first entry) and becomes S_b.  First: is_first's column for the last
  // entry, -1 for the others.  Kind: the entry's lookup elements; Two: a
  // relation of two values.
  template <int Col, int Kind, bool Two, int First>
  __host__ __device__ __forceinline__ uint32_t logup(qm31& prev, uint32_t m, uint32_t v0, uint32_t v1) const {
    const qm31 s = quad(Col, r);
    qm31 diff = qsub(s, prev);
    if constexpr (First >= 0) {
      diff = qadd(qsub(diff, quad(Col, rp)), qmul_m31(qload(c.claimed), at(First)));
    }
    prev = s;
    qm31 d = qsub({v0, 0u, 0u, 0u}, qload(a.elems[Kind][0]));
    if constexpr (Two) d = qadd(d, qmul_m31(qload(a.elems[Kind][1]), v1));
    const qm31 e = qsub(qmul(diff, d), {m, 0u, 0u, 0u});
    return nonzero(e.a | e.b | e.c | e.d);
  }
};

}  // namespace lum

#include "check_tapes.cuh"

namespace lum {

// The component of CTA `cta`: the last whose first CTA is at or before it.
__host__ __device__ __forceinline__ int check_comp(const CheckArgs& a, int cta) {
  int k = 0;
  for (int i = 1; i < a.n_comps; i++) k = a.comps[i].cta0 <= cta ? i : k;
  return k;
}

// Thread `tid` of CTA `cta`: its row's check word.
__host__ __device__ __forceinline__ void check_cta_row(const CheckArgs& a, int cta, int tid) {
  const CheckComp& c = a.comps[check_comp(a, cta)];
  const long long r = (long long)(cta - c.cta0) * CHECK_THREADS + tid;
  if (r >= c.n) return;
  const CheckRow q{a, c, a.cols + c.col0, r, (r + 1) & (c.n - 1), (r - 1) & (c.n - 1)};
  uint32_t w;
  switch (c.kind) {
#define LUM_CHECK_CASE(kind, name) \
  case kind:                       \
    w = check_tape_##name(q);      \
    break;
    LUM_CHECK_TAPES(LUM_CHECK_CASE)
#undef LUM_CHECK_CASE
    default:  // no such tape: the wrapper refuses it
      w = ~0u;
  }
  ((uint32_t*)a.out)[c.out + r] = w;
}

}  // namespace lum
