// M31 / QM31 field arithmetic shared by the port's kernels.
//
// Values are canonical residues in [0, P).  Every result is canonical too:
// P itself never appears where the reference package returns 0.
#pragma once

#include <stdint.h>

namespace lum {

constexpr uint32_t P = 0x7fffffffu;
constexpr uint32_t INV2 = 0x40000000u;  // (P + 1) / 2

__host__ __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // < 2^32: both operands are below 2^31
  return s >= P ? s - P : s;
}

__host__ __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (P - b);
}

__host__ __device__ __forceinline__ uint32_t neg(uint32_t a) { return a == 0 ? 0u : P - a; }

// One 64-bit product, one Mersenne fold, one conditional subtract: the
// product is below (P-1)^2, so (x & P) + (x >> 31) < 2P.
__host__ __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t x = (uint64_t)a * b;
  uint32_t r = (uint32_t)((x & P) + (x >> 31));
  return r >= P ? r - P : r;
}

__host__ __device__ __forceinline__ uint32_t sqn(uint32_t a, int k) {
  for (int i = 0; i < k; i++) a = mul(a, a);
  return a;
}

// a^(P-2) by the reference's 2^k-1 ladder; inv(0) = 0.
__host__ __device__ __forceinline__ uint32_t inv(uint32_t a) {
  uint32_t t0 = mul(mul(a, a), a);
  uint32_t t1 = mul(sqn(t0, 2), t0);
  uint32_t t2 = mul(sqn(t1, 4), t1);
  uint32_t t3 = mul(sqn(t2, 8), t2);
  uint32_t t4 = mul(sqn(t3, 8), t2);
  uint32_t t5 = mul(sqn(t4, 4), t1);
  uint32_t t6 = mul(sqn(t5, 1), a);
  return mul(sqn(t6, 2), a);
}

// Four words of a 16-byte aligned address, moved as one access.
struct alignas(16) u32x4 {
  uint32_t v[4];
};

// s += a * b with the product folded once: (p & P) + (p >> 31) < 2^32, so
// a 64-bit sum takes 2^32 such terms before it can wrap.
__host__ __device__ __forceinline__ void fold_mac(unsigned long long& s, uint32_t a, uint32_t b) {
  const uint64_t p = (uint64_t)a * b;
  s += (uint32_t)(p & P) + (uint32_t)(p >> 31);
}

// x mod P of any 64-bit sum: two Mersenne folds and a conditional subtract.
__host__ __device__ __forceinline__ uint32_t reduce64(unsigned long long x) {
  x = (x & P) + (x >> 31);  // < 2^34
  x = (x & P) + (x >> 31);  // < 2^31 + 8
  return (uint32_t)(x >= P ? x - P : x);
}

// QM31 = CM31[u]/(u^2 - (2+i)); (a + b i) + (c + d i) u is {a, b, c, d}.
struct qm31 {
  uint32_t a, b, c, d;
};

__host__ __device__ __forceinline__ qm31 qload(const uint32_t* p) { return {p[0], p[1], p[2], p[3]}; }

__host__ __device__ __forceinline__ void qstore(uint32_t* p, qm31 x) {
  p[0] = x.a;
  p[1] = x.b;
  p[2] = x.c;
  p[3] = x.d;
}

__host__ __device__ __forceinline__ qm31 qadd(qm31 x, qm31 y) {
  return {add(x.a, y.a), add(x.b, y.b), add(x.c, y.c), add(x.d, y.d)};
}

__host__ __device__ __forceinline__ qm31 qsub(qm31 x, qm31 y) {
  return {sub(x.a, y.a), sub(x.b, y.b), sub(x.c, y.c), sub(x.d, y.d)};
}

__host__ __device__ __forceinline__ qm31 qmul_m31(qm31 x, uint32_t s) {
  return {mul(x.a, s), mul(x.b, s), mul(x.c, s), mul(x.d, s)};
}

// CM31 product (ar + ai i)(br + bi i).
__host__ __device__ __forceinline__ void cmul(uint32_t ar, uint32_t ai, uint32_t br, uint32_t bi,
                                     uint32_t& rr, uint32_t& ri) {
  rr = sub(mul(ar, br), mul(ai, bi));
  ri = add(mul(ar, bi), mul(ai, br));
}

__host__ __device__ __forceinline__ qm31 qmul(qm31 x, qm31 y) {
  uint32_t ac_r, ac_i, bd_r, bd_i, ad_r, ad_i, bc_r, bc_i;
  cmul(x.a, x.b, y.a, y.b, ac_r, ac_i);
  cmul(x.c, x.d, y.c, y.d, bd_r, bd_i);
  cmul(x.a, x.b, y.c, y.d, ad_r, ad_i);
  cmul(x.c, x.d, y.a, y.b, bc_r, bc_i);
  // (2 + i) * BD
  uint32_t rbd_r = sub(add(bd_r, bd_r), bd_i);
  uint32_t rbd_i = add(bd_r, add(bd_i, bd_i));
  return {add(ac_r, rbd_r), add(ac_i, rbd_i), add(ad_r, bc_r), add(ad_i, bc_i)};
}

// (A + Bu)^-1 = (A - Bu) / (A^2 - (2+i) B^2), the CM31 denominator
// inverted through its norm and one M31 Fermat chain.
__host__ __device__ __forceinline__ qm31 qinv(qm31 x) {
  uint32_t a2_r, a2_i, b2_r, b2_i;
  cmul(x.a, x.b, x.a, x.b, a2_r, a2_i);
  cmul(x.c, x.d, x.c, x.d, b2_r, b2_i);
  uint32_t den_r = sub(a2_r, sub(add(b2_r, b2_r), b2_i));
  uint32_t den_i = sub(a2_i, add(b2_r, add(b2_i, b2_i)));
  uint32_t ninv = inv(add(mul(den_r, den_r), mul(den_i, den_i)));
  uint32_t di_r = mul(den_r, ninv);
  uint32_t di_i = mul(neg(den_i), ninv);
  qm31 r;
  cmul(x.a, x.b, di_r, di_i, r.a, r.b);
  cmul(neg(x.c), neg(x.d), di_r, di_i, r.c, r.d);
  return r;
}

}  // namespace lum
