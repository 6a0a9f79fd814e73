// The component tape (air/tape.py) and its interpreter, one row per thread.
//
// A tape is a straight-line program of 5-word instructions [op, dst, a, b,
// c] over M31 registers; air/tape.py records it from a component's
// `evaluate` and documents the format.  The limits below are mirrored in
// kernels.py (TAPE_MAX_*), and air/tape.py checks them when it records.
#pragma once

#include "m31.cuh"

namespace lum {

constexpr int TAPE_MAX_REGS = 16;
constexpr int TAPE_MAX_MAIN = 32;
constexpr int TAPE_MAX_PP = 4;
constexpr int TAPE_MAX_REL = 8;
constexpr int TAPE_MAX_POWS = 32;
constexpr int TAPE_MAX_INS = 128;
constexpr int TAPE_KINDS = 5;
constexpr int TAPE_INS_WORDS = 5;

enum : int {
  OP_MAIN,
  OP_MAIN_NEXT,
  OP_PP,
  OP_CONST,
  OP_ADD,
  OP_SUB,
  OP_MUL,
  OP_NEG,
  OP_CONSTRAINT,
  OP_RELATION,
};

// Everything one launch reads besides the columns, passed by value (the
// kernel parameter space holds it; nothing is uploaded per launch).  The
// field order is mirrored by kernels.AirArgs.
struct AirArgs {
  unsigned long long main[TAPE_MAX_MAIN];  // main columns (uint32 rows)
  unsigned long long pp[TAPE_MAX_PP];      // preprocessed columns
  unsigned long long inter[4 * TAPE_MAX_REL];  // interaction coordinates (domain)
  unsigned long long is_first;             // is_first column (domain)
  unsigned long long xs;                   // domain x coordinates (domain)
  unsigned long long out;                  // witness (4E, n) / quotient (n, 4)
  unsigned long long tape;                 // int32 program in device memory
  // The halo of a row block (read only by a launch with Halo = true):
  // next[x] holds the `stride` rows that follow the block in main column
  // x, prev[k] the `stride` rows that precede it in coordinate k of the
  // last relation entry.
  unsigned long long next[TAPE_MAX_MAIN];
  unsigned long long prev[4];
  long long n;                             // rows of the block (a power of two)
  int n_ins;
  int n_rel;                               // E
  int n_constraints;                       // K
  int stride;                              // next row = r + stride (mod n; a block: at most n)
  int log_trace;                           // trace log of the component
  int accumulate;                          // domain: out += quotient
  uint32_t elems[TAPE_KINDS][2][4];        // lookup elements z, alpha per kind
  uint32_t claimed[4];                     // claimed sum (domain)
  uint32_t pows[TAPE_MAX_POWS][4];         // alpha powers of the K + E constraints
};

__device__ __forceinline__ qm31 qword(const uint32_t* w) { return {w[0], w[1], w[2], w[3]}; }

// d = v0 + alpha * v1 - z: the entry's combined lookup value.
__device__ __forceinline__ qm31 denominator(const AirArgs& a, int kind, uint32_t v0, uint32_t v1,
                                            bool two) {
  qm31 d = qsub({v0, 0u, 0u, 0u}, qword(a.elems[kind][0]));
  if (two) d = qadd(d, qmul_m31(qword(a.elems[kind][1]), v1));
  return d;
}

// Copies the tape into shared memory; every thread of the block must call it.
__device__ __forceinline__ void load_tape(const AirArgs& a, int* s_tape) {
  const int* g = (const int*)a.tape;
  for (int i = threadIdx.x; i < TAPE_INS_WORDS * a.n_ins; i += blockDim.x) s_tape[i] = g[i];
  __syncthreads();
}

// Runs the tape at row r.  on_constraint(value) for each recorded
// constraint, on_relation(kind, mult, v0, v1, two_values) for each relation
// entry, in tape order.  The register file is a local array: the largest
// tape needs 13 registers.  MAIN_NEXT wraps at the column's end (a whole
// domain), or with Halo reads past the block's end from a.next.
template <bool Halo, class OnConstraint, class OnRelation>
__device__ __forceinline__ void run_tape(const int* tape, const AirArgs& a, long long r,
                                         OnConstraint on_constraint, OnRelation on_relation) {
  uint32_t reg[TAPE_MAX_REGS];
  const long long rn = Halo ? r + a.stride : (r + a.stride) & (a.n - 1);
  for (int i = 0; i < a.n_ins; i++) {
    const int* in = tape + TAPE_INS_WORDS * i;
    const int op = in[0], d = in[1], x = in[2], y = in[3], z = in[4];
    switch (op) {
      case OP_MAIN: reg[d] = ((const uint32_t*)a.main[x])[r]; break;
      case OP_MAIN_NEXT:
        if constexpr (Halo) {
          reg[d] = rn < a.n ? ((const uint32_t*)a.main[x])[rn] : ((const uint32_t*)a.next[x])[rn - a.n];
        } else {
          reg[d] = ((const uint32_t*)a.main[x])[rn];
        }
        break;
      case OP_PP: reg[d] = ((const uint32_t*)a.pp[x])[r]; break;
      case OP_CONST: reg[d] = (uint32_t)x; break;
      case OP_ADD: reg[d] = add(reg[x], reg[y]); break;
      case OP_SUB: reg[d] = sub(reg[x], reg[y]); break;
      case OP_MUL: reg[d] = mul(reg[x], reg[y]); break;
      case OP_NEG: reg[d] = neg(reg[x]); break;
      case OP_CONSTRAINT: on_constraint(reg[x]); break;
      case OP_RELATION: on_relation(d, reg[x], reg[y], z >= 0 ? reg[z] : 0u, z >= 0); break;
      default: break;
    }
  }
}

}  // namespace lum
