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

#include "tape_row.cuh"

namespace lum {

constexpr int CHECK_MAX_COMPS = 32;
constexpr int CHECK_MAX_COLS = 512;
constexpr int CHECK_THREADS = 256;  // rows of a CTA

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
  uint32_t elems[TAPE_ELEM_KINDS][2][4];  // lookup elements z, alpha per kind
};

// One row of one component, as the compiled check tapes read it: the
// row accessor shared with K5 and K6 (tape_row.cuh), rows cyclic.
using CheckRow = TapeRow<false>;

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
  const CheckRow q{a.cols + c.col0, a.elems, c.claimed, r, (r + 1) & (c.n - 1), (r - 1) & (c.n - 1), c.n};
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
