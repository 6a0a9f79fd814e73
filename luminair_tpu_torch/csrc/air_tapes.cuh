// Generated by luminair_tpu_torch/air/tape_cuda.py from the components' witness
// and domain tapes (air/tape.py `record`); do not edit.  Regenerate with
//     python3 -m luminair_tpu_torch.air.tape_cuda
// tests/test_torch_air_tapes.py fails while this file and the tapes differ.
//
// witness_tape_<component>: one row of K5 (see air.cuh), its entries' sums
// written but the last, the row total returned.  domain_tape_<component>: one
// row of K6's terms, sum_i pw[i] * C_i over the K recorded and E LogUp
// constraints, before the division by V_n.
//
// The manifest, `<witness|domain> <kind> <component> <sha256 of the tape's shape
// and words>` (kernels.tape_digest; kernels.compiled_air_tapes reads it):
// witness 0 add 4f6934e24706d6765ad69b49027c6e63853285f9b9313a269d93e9c41cd80273
// witness 1 mul 1e0d817cb91ec2fb0a7cb0fe7a2ed515c3f905f90c6cfa1c026a5420cce04ff5
// witness 2 recip c7b804c7d15375b0a2c71c271c6d51a4e730b14938e27552c9ec886a2f272389
// witness 3 sqrt 63ab12e625f64f2ba55ce1bcc3fe1153ff445cb4511b5968980b333308587601
// witness 4 rem 8b310c789520a479db53176a91b60fc72d78c071a41bce671dcd01a9ffa383ba
// witness 5 sin 0f910c38f2e65b7838e751b055cab80f9601a0cdafb8431bdeab7bf5421423d9
// witness 6 exp2 e190ab59f6c286ef17455184134236669f15ce50ad70807f7380cebf7539222d
// witness 7 log2 9639da44b42d72108b9f08d090df5724d938253b1516a94d8071b358fb1fb976
// witness 8 less_than 15a0f0a60b4e53244509aec2949bf87119bd759a024b5bafcfa4db16742aa486
// witness 9 sum_reduce 1a6d2a7c1e6bd9e2655e2ba078c9cdd532a22fcf158a8ab9c2ca1be1ed4c0d4c
// witness 10 max_reduce 58a1c8b2f4cc080ee7a48fafb3ff6555f0bb520a469dacd6826cdd9f78d2fac7
// witness 11 inputs 6b8300f51a1fc0725b9e94aaeba829d5602e25fcd52fe7d98d3a2c12f9057806
// witness 12 contiguous aa98155682b65a4fd32ed8963d2afa5c6c86690455708aba077731f67227d090
// witness 13 sin_lookup e88617ee6fbd72f12210b978e22bd1b2d0aa8e0eeb0ffe6f36a22ba61637e7ac
// witness 14 exp2_lookup e78b55f2eddc3d140bde379ae0c95e734e5365d00461e9aef49f2d274a2d6b78
// witness 15 log2_lookup 3890febe6c1d5724115c9390cef1f3ff9fa4a92f43183b16413dbf3812f4a9ea
// witness 16 range_check_lookup 87816c5e382b3d22d13646108d44b7adda126d6b653435582e5c97e574c339b2
// witness 17 square d11585f6b1fe91dec78ea79eb62b36fdbd7b099ac4ac8729c3d52658a1d80354
// domain 0 add 8aa2067e75547648c887641a5856756b8d195d3115bd1b6b7cb377efe4353a25
// domain 1 mul ab0695cf8289bf5313d9fadf514106b3b7d0f739661b04bc36e3b75b202afd12
// domain 2 recip 5b87df6c83699a70d21d3074b1fbb28d1babc7dcc03311761e6061d125774f1d
// domain 3 sqrt 2c9158c8e375e01490f5f819c32f02b157c0af598a07ea76f942e5f4a109ab54
// domain 4 rem bea31d45e2401e08c8f4cb0facc47d82d590bb9b76dbe7fb771a38b5d704231d
// domain 5 sin 64ad4f2fda59e41b7dddbce3181f067576c83ed1768422a31ed858e554fc6f65
// domain 6 exp2 66783c34c48b36be17512dd422f949de027aba468f5512591dcceafb22c0584c
// domain 7 log2 acc811177668db2a2fb8efd1ea06c44f035fb3b55e9e0647f7e5eb320b35e065
// domain 8 less_than f491f034adc9b63cdeb5c8ef26d347bb31c57480b863009f668008134fb8bf95
// domain 9 sum_reduce 6a0ad60198e49df0a0dff904467acce09ef55ec77289ebca3573fe31cdd88959
// domain 10 max_reduce a3f9cd2c92550c05b414027d12267c1e2f7cb22d3051b84a52ded1099d22969b
// domain 11 inputs 5ae4374afd760e61548c576846bc643ea04a30597127f3ad19f908922bc73ef8
// domain 12 contiguous 4e9c27c91ae9a8854b2c1add05731be47c60bcd2ae9062f5b748196be459d134
// domain 13 sin_lookup e88617ee6fbd72f12210b978e22bd1b2d0aa8e0eeb0ffe6f36a22ba61637e7ac
// domain 14 exp2_lookup e78b55f2eddc3d140bde379ae0c95e734e5365d00461e9aef49f2d274a2d6b78
// domain 15 log2_lookup 3890febe6c1d5724115c9390cef1f3ff9fa4a92f43183b16413dbf3812f4a9ea
// domain 16 range_check_lookup 87816c5e382b3d22d13646108d44b7adda126d6b653435582e5c97e574c339b2
// domain 17 square 2e817f5b5d7000cffea2eb9891e8937889b2c86d25fd09f54911120fa0a5fd1e
#pragma once

namespace lum {

// add: 12 instructions, 3 registers, E = 3, 15 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_add(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[3];
  qm31 d[3];
  r0 = q.at(12);
  r1 = q.at(9);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(13);
  r1 = q.at(10);
  r2 = q.at(2);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  r0 = q.at(14);
  r1 = q.at(11);
  r2 = q.at(0);
  m[2] = r0;
  d[2] = q.denom<0, true>(r1, r2);
  return witness_sums<3>(m, d, out, n, q.r);
}

// mul: 12 instructions, 3 registers, E = 3, 16 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_mul(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[3];
  qm31 d[3];
  r0 = q.at(13);
  r1 = q.at(9);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(14);
  r1 = q.at(10);
  r2 = q.at(2);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  r0 = q.at(15);
  r1 = q.at(11);
  r2 = q.at(0);
  m[2] = r0;
  d[2] = q.denom<0, true>(r1, r2);
  return witness_sums<3>(m, d, out, n, q.r);
}

// recip: 8 instructions, 3 registers, E = 2, 13 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_recip(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[2];
  qm31 d[2];
  r0 = q.at(11);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(12);
  r1 = q.at(8);
  r2 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  return witness_sums<2>(m, d, out, n, q.r);
}

// sqrt: 8 instructions, 3 registers, E = 2, 13 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_sqrt(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[2];
  qm31 d[2];
  r0 = q.at(11);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(12);
  r1 = q.at(8);
  r2 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  return witness_sums<2>(m, d, out, n, q.r);
}

// rem: 12 instructions, 3 registers, E = 3, 16 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_rem(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[3];
  qm31 d[3];
  r0 = q.at(13);
  r1 = q.at(9);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(14);
  r1 = q.at(10);
  r2 = q.at(2);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  r0 = q.at(15);
  r1 = q.at(11);
  r2 = q.at(0);
  m[2] = r0;
  d[2] = q.denom<0, true>(r1, r2);
  return witness_sums<3>(m, d, out, n, q.r);
}

// sin: 10 instructions, 4 registers, E = 3, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_sin(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
  uint32_t m[3];
  qm31 d[3];
  r0 = q.at(9);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(10);
  r2 = q.at(8);
  r3 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r2, r3);
  r0 = q.at(11);
  m[2] = r0;
  d[2] = q.denom<1, true>(r1, r2);
  return witness_sums<3>(m, d, out, n, q.r);
}

// exp2: 10 instructions, 4 registers, E = 3, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_exp2(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
  uint32_t m[3];
  qm31 d[3];
  r0 = q.at(9);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(10);
  r2 = q.at(8);
  r3 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r2, r3);
  r0 = q.at(11);
  m[2] = r0;
  d[2] = q.denom<2, true>(r1, r2);
  return witness_sums<3>(m, d, out, n, q.r);
}

// log2: 10 instructions, 4 registers, E = 3, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_log2(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
  uint32_t m[3];
  qm31 d[3];
  r0 = q.at(9);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(10);
  r2 = q.at(8);
  r3 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r2, r3);
  r0 = q.at(11);
  m[2] = r0;
  d[2] = q.denom<3, true>(r1, r2);
  return witness_sums<3>(m, d, out, n, q.r);
}

// less_than: 21 instructions, 3 registers, E = 7, 22 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_less_than(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[7];
  qm31 d[7];
  r0 = q.at(18);
  r1 = q.at(9);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(19);
  r1 = q.at(10);
  r2 = q.at(2);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  r0 = q.at(20);
  r1 = q.at(11);
  r2 = q.at(0);
  m[2] = r0;
  d[2] = q.denom<0, true>(r1, r2);
  r0 = q.at(21);
  r1 = q.at(14);
  m[3] = r0;
  d[3] = q.denom<4, false>(r1, 0u);
  r1 = q.at(15);
  m[4] = r0;
  d[4] = q.denom<4, false>(r1, 0u);
  r1 = q.at(16);
  m[5] = r0;
  d[5] = q.denom<4, false>(r1, 0u);
  r1 = q.at(17);
  m[6] = r0;
  d[6] = q.denom<4, false>(r1, 0u);
  return witness_sums<7>(m, d, out, n, q.r);
}

// sum_reduce: 8 instructions, 3 registers, E = 2, 14 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_sum_reduce(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[2];
  qm31 d[2];
  r0 = q.at(12);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(13);
  r1 = q.at(8);
  r2 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  return witness_sums<2>(m, d, out, n, q.r);
}

// max_reduce: 19 instructions, 3 registers, E = 6, 20 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_max_reduce(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[6];
  qm31 d[6];
  r0 = q.at(17);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(18);
  r1 = q.at(8);
  r2 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  r0 = q.at(19);
  r1 = q.at(13);
  m[2] = r0;
  d[2] = q.denom<4, false>(r1, 0u);
  r1 = q.at(14);
  m[3] = r0;
  d[3] = q.denom<4, false>(r1, 0u);
  r1 = q.at(15);
  m[4] = r0;
  d[4] = q.denom<4, false>(r1, 0u);
  r1 = q.at(16);
  r2 = 4u;
  r1 = mul(r1, r2);
  m[5] = r0;
  d[5] = q.denom<4, false>(r1, 0u);
  return witness_sums<6>(m, d, out, n, q.r);
}

// inputs: 4 instructions, 3 registers, E = 1, 7 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_inputs(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[1];
  qm31 d[1];
  r0 = q.at(6);
  r1 = q.at(5);
  r2 = q.at(0);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  return witness_sums<1>(m, d, out, n, q.r);
}

// contiguous: 8 instructions, 3 registers, E = 2, 11 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_contiguous(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[2];
  qm31 d[2];
  r0 = q.at(9);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(10);
  r1 = q.at(8);
  r2 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  return witness_sums<2>(m, d, out, n, q.r);
}

// sin_lookup: 5 instructions, 3 registers, E = 1, 1 main, 2 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_sin_lookup(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[1];
  qm31 d[1];
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  m[0] = r0;
  d[0] = q.denom<1, true>(r1, r2);
  return witness_sums<1>(m, d, out, n, q.r);
}

// exp2_lookup: 5 instructions, 3 registers, E = 1, 1 main, 2 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_exp2_lookup(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[1];
  qm31 d[1];
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  m[0] = r0;
  d[0] = q.denom<2, true>(r1, r2);
  return witness_sums<1>(m, d, out, n, q.r);
}

// log2_lookup: 5 instructions, 3 registers, E = 1, 1 main, 2 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_log2_lookup(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[1];
  qm31 d[1];
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  m[0] = r0;
  d[0] = q.denom<3, true>(r1, r2);
  return witness_sums<1>(m, d, out, n, q.r);
}

// range_check_lookup: 4 instructions, 2 registers, E = 1, 1 main, 1 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_range_check_lookup(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u;
  uint32_t m[1];
  qm31 d[1];
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<4, false>(r1, 0u);
  return witness_sums<1>(m, d, out, n, q.r);
}

// square: 8 instructions, 3 registers, E = 2, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ qm31 witness_tape_square(const TapeRow<false>& q, uint32_t* out, long long n) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t m[2];
  qm31 d[2];
  r0 = q.at(10);
  r1 = q.at(7);
  r2 = q.at(1);
  m[0] = r0;
  d[0] = q.denom<0, true>(r1, r2);
  r0 = q.at(11);
  r1 = q.at(8);
  r2 = q.at(0);
  m[1] = r0;
  d[1] = q.denom<0, true>(r1, r2);
  return witness_sums<2>(m, d, out, n, q.r);
}

// add: 41 instructions, 9 registers, K = 6, E = 3, 15 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_add(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(9);
  r2 = q.at(10);
  r3 = add(r1, r2);
  r4 = q.at(11);
  r3 = sub(r3, r4);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r3));
  r3 = 1u;
  r0 = sub(r3, r0);
  r3 = q.at(5);
  r5 = q.at(0);
  r3 = sub(r3, r5);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r3));
  r3 = q.at(6);
  r6 = q.at(1);
  r3 = sub(r3, r6);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r3));
  r3 = q.at(7);
  r7 = q.at(2);
  r3 = sub(r3, r7);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r3));
  r3 = q.at(8);
  r8 = q.at(3);
  r3 = sub(r3, r8);
  r8 = 1u;
  r3 = sub(r3, r8);
  r0 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[5]), r0));
  r0 = q.at(12);
  acc = qadd(acc, qmul(q.logup_value<15, 0, true, -1, -1>(s, r0, r1, r6), qload(pw[6])));
  r0 = q.at(13);
  acc = qadd(acc, qmul(q.logup_value<19, 0, true, -1, -1>(s, r0, r2, r7), qload(pw[7])));
  r0 = q.at(14);
  acc = qadd(acc, qmul(q.logup_value<23, 0, true, 27, 28>(s, r0, r4, r5), qload(pw[8])));
  return acc;
}

// mul: 45 instructions, 9 registers, K = 6, E = 3, 16 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_mul(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(9);
  r2 = q.at(10);
  r3 = mul(r1, r2);
  r4 = q.at(11);
  r5 = 4096u;
  r5 = mul(r4, r5);
  r3 = sub(r3, r5);
  r5 = q.at(12);
  r3 = sub(r3, r5);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r3));
  r3 = 1u;
  r0 = sub(r3, r0);
  r3 = q.at(5);
  r5 = q.at(0);
  r3 = sub(r3, r5);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r3));
  r3 = q.at(6);
  r6 = q.at(1);
  r3 = sub(r3, r6);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r3));
  r3 = q.at(7);
  r7 = q.at(2);
  r3 = sub(r3, r7);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r3));
  r3 = q.at(8);
  r8 = q.at(3);
  r3 = sub(r3, r8);
  r8 = 1u;
  r3 = sub(r3, r8);
  r0 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[5]), r0));
  r0 = q.at(13);
  acc = qadd(acc, qmul(q.logup_value<16, 0, true, -1, -1>(s, r0, r1, r6), qload(pw[6])));
  r0 = q.at(14);
  acc = qadd(acc, qmul(q.logup_value<20, 0, true, -1, -1>(s, r0, r2, r7), qload(pw[7])));
  r0 = q.at(15);
  acc = qadd(acc, qmul(q.logup_value<24, 0, true, 28, 29>(s, r0, r4, r5), qload(pw[8])));
  return acc;
}

// recip: 37 instructions, 7 registers, K = 5, E = 2, 13 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_recip(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(7);
  r2 = q.at(8);
  r3 = mul(r1, r2);
  r4 = q.at(9);
  r3 = add(r3, r4);
  r4 = q.at(10);
  r4 = mul(r4, r4);
  r3 = sub(r3, r4);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r3));
  r3 = 1u;
  r0 = sub(r3, r0);
  r3 = q.at(4);
  r4 = q.at(0);
  r3 = sub(r3, r4);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r3));
  r3 = q.at(5);
  r5 = q.at(1);
  r3 = sub(r3, r5);
  r3 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r3));
  r3 = q.at(6);
  r6 = q.at(2);
  r3 = sub(r3, r6);
  r6 = 1u;
  r3 = sub(r3, r6);
  r0 = mul(r0, r3);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r0));
  r0 = q.at(11);
  acc = qadd(acc, qmul(q.logup_value<13, 0, true, -1, -1>(s, r0, r1, r5), qload(pw[5])));
  r0 = q.at(12);
  acc = qadd(acc, qmul(q.logup_value<17, 0, true, 21, 22>(s, r0, r2, r4), qload(pw[6])));
  return acc;
}

// sqrt: 37 instructions, 7 registers, K = 5, E = 2, 13 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_sqrt(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(8);
  r2 = mul(r1, r1);
  r3 = q.at(9);
  r2 = add(r2, r3);
  r3 = q.at(7);
  r4 = q.at(10);
  r4 = mul(r3, r4);
  r2 = sub(r2, r4);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r2));
  r2 = 1u;
  r0 = sub(r2, r0);
  r2 = q.at(4);
  r4 = q.at(0);
  r2 = sub(r2, r4);
  r2 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r2));
  r2 = q.at(5);
  r5 = q.at(1);
  r2 = sub(r2, r5);
  r2 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r2));
  r2 = q.at(6);
  r6 = q.at(2);
  r2 = sub(r2, r6);
  r6 = 1u;
  r2 = sub(r2, r6);
  r0 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r0));
  r0 = q.at(11);
  acc = qadd(acc, qmul(q.logup_value<13, 0, true, -1, -1>(s, r0, r3, r5), qload(pw[5])));
  r0 = q.at(12);
  acc = qadd(acc, qmul(q.logup_value<17, 0, true, 21, 22>(s, r0, r1, r4), qload(pw[6])));
  return acc;
}

// rem: 43 instructions, 9 registers, K = 6, E = 3, 16 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_rem(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(12);
  r2 = q.at(10);
  r1 = mul(r1, r2);
  r3 = q.at(11);
  r1 = add(r1, r3);
  r4 = q.at(9);
  r1 = sub(r1, r4);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r1));
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(5);
  r5 = q.at(0);
  r1 = sub(r1, r5);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r1));
  r1 = q.at(6);
  r6 = q.at(1);
  r1 = sub(r1, r6);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r1));
  r1 = q.at(7);
  r7 = q.at(2);
  r1 = sub(r1, r7);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r1));
  r1 = q.at(8);
  r8 = q.at(3);
  r1 = sub(r1, r8);
  r8 = 1u;
  r1 = sub(r1, r8);
  r0 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[5]), r0));
  r0 = q.at(13);
  acc = qadd(acc, qmul(q.logup_value<16, 0, true, -1, -1>(s, r0, r4, r6), qload(pw[6])));
  r0 = q.at(14);
  acc = qadd(acc, qmul(q.logup_value<20, 0, true, -1, -1>(s, r0, r2, r7), qload(pw[7])));
  r0 = q.at(15);
  acc = qadd(acc, qmul(q.logup_value<24, 0, true, 28, 29>(s, r0, r3, r5), qload(pw[8])));
  return acc;
}

// sin: 32 instructions, 5 registers, K = 4, E = 3, 12 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_sin(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r1));
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r1));
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r0));
  r0 = q.at(9);
  r1 = q.at(7);
  acc = qadd(acc, qmul(q.logup_value<12, 0, true, -1, -1>(s, r0, r1, r3), qload(pw[4])));
  r0 = q.at(10);
  r3 = q.at(8);
  acc = qadd(acc, qmul(q.logup_value<16, 0, true, -1, -1>(s, r0, r3, r2), qload(pw[5])));
  r0 = q.at(11);
  acc = qadd(acc, qmul(q.logup_value<20, 1, true, 24, 25>(s, r0, r1, r3), qload(pw[6])));
  return acc;
}

// exp2: 32 instructions, 5 registers, K = 4, E = 3, 12 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_exp2(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r1));
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r1));
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r0));
  r0 = q.at(9);
  r1 = q.at(7);
  acc = qadd(acc, qmul(q.logup_value<12, 0, true, -1, -1>(s, r0, r1, r3), qload(pw[4])));
  r0 = q.at(10);
  r3 = q.at(8);
  acc = qadd(acc, qmul(q.logup_value<16, 0, true, -1, -1>(s, r0, r3, r2), qload(pw[5])));
  r0 = q.at(11);
  acc = qadd(acc, qmul(q.logup_value<20, 2, true, 24, 25>(s, r0, r1, r3), qload(pw[6])));
  return acc;
}

// log2: 32 instructions, 5 registers, K = 4, E = 3, 12 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_log2(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r1));
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r1));
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r0));
  r0 = q.at(9);
  r1 = q.at(7);
  acc = qadd(acc, qmul(q.logup_value<12, 0, true, -1, -1>(s, r0, r1, r3), qload(pw[4])));
  r0 = q.at(10);
  r3 = q.at(8);
  acc = qadd(acc, qmul(q.logup_value<16, 0, true, -1, -1>(s, r0, r3, r2), qload(pw[5])));
  r0 = q.at(11);
  acc = qadd(acc, qmul(q.logup_value<20, 3, true, 24, 25>(s, r0, r1, r3), qload(pw[6])));
  return acc;
}

// less_than: 76 instructions, 13 registers, K = 9, E = 7, 22 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_less_than(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u, r9 = 0u, r10 = 0u, r11 = 0u, r12 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(12);
  r2 = 1u;
  r2 = sub(r1, r2);
  r2 = mul(r1, r2);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r2));
  r2 = 1u;
  r2 = sub(r2, r1);
  r3 = 4096u;
  r2 = mul(r2, r3);
  r3 = q.at(11);
  r2 = sub(r3, r2);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r2));
  r2 = q.at(9);
  r4 = q.at(13);
  r5 = add(r2, r4);
  r6 = q.at(10);
  r5 = sub(r5, r6);
  r7 = 0u;
  r1 = mul(r1, r7);
  r1 = sub(r5, r1);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r1));
  r1 = q.at(14);
  r4 = sub(r4, r1);
  r5 = q.at(15);
  r7 = 256u;
  r7 = mul(r5, r7);
  r4 = sub(r4, r7);
  r7 = q.at(16);
  r8 = 65536u;
  r8 = mul(r7, r8);
  r4 = sub(r4, r8);
  r8 = q.at(17);
  r9 = 16777216u;
  r9 = mul(r8, r9);
  r4 = sub(r4, r9);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r4));
  r4 = 1u;
  r0 = sub(r4, r0);
  r4 = q.at(5);
  r9 = q.at(0);
  r4 = sub(r4, r9);
  r4 = mul(r0, r4);
  acc = qadd(acc, qmul_m31(qload(pw[5]), r4));
  r4 = q.at(6);
  r10 = q.at(1);
  r4 = sub(r4, r10);
  r4 = mul(r0, r4);
  acc = qadd(acc, qmul_m31(qload(pw[6]), r4));
  r4 = q.at(7);
  r11 = q.at(2);
  r4 = sub(r4, r11);
  r4 = mul(r0, r4);
  acc = qadd(acc, qmul_m31(qload(pw[7]), r4));
  r4 = q.at(8);
  r12 = q.at(3);
  r4 = sub(r4, r12);
  r12 = 1u;
  r4 = sub(r4, r12);
  r0 = mul(r0, r4);
  acc = qadd(acc, qmul_m31(qload(pw[8]), r0));
  r0 = q.at(18);
  acc = qadd(acc, qmul(q.logup_value<22, 0, true, -1, -1>(s, r0, r2, r10), qload(pw[9])));
  r0 = q.at(19);
  acc = qadd(acc, qmul(q.logup_value<26, 0, true, -1, -1>(s, r0, r6, r11), qload(pw[10])));
  r0 = q.at(20);
  acc = qadd(acc, qmul(q.logup_value<30, 0, true, -1, -1>(s, r0, r3, r9), qload(pw[11])));
  r0 = q.at(21);
  acc = qadd(acc, qmul(q.logup_value<34, 4, false, -1, -1>(s, r0, r1, 0u), qload(pw[12])));
  acc = qadd(acc, qmul(q.logup_value<38, 4, false, -1, -1>(s, r0, r5, 0u), qload(pw[13])));
  acc = qadd(acc, qmul(q.logup_value<42, 4, false, -1, -1>(s, r0, r7, 0u), qload(pw[14])));
  acc = qadd(acc, qmul(q.logup_value<46, 4, false, 50, 51>(s, r0, r8, 0u), qload(pw[15])));
  return acc;
}

// sum_reduce: 51 instructions, 7 registers, K = 9, E = 2, 14 main, 0 preprocessed columns, 1 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_sum_reduce(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(11);
  r2 = 1u;
  r2 = sub(r1, r2);
  r2 = mul(r1, r2);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r2));
  r2 = q.at(10);
  r3 = q.at(9);
  r3 = sub(r2, r3);
  r4 = q.at(7);
  r3 = sub(r3, r4);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r3));
  r3 = q.at(8);
  r5 = sub(r3, r2);
  r5 = mul(r5, r1);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r5));
  r5 = 1u;
  r5 = sub(r5, r1);
  r6 = q.next(9, 23);
  r2 = sub(r6, r2);
  r2 = mul(r5, r2);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r2));
  r1 = mul(r1, r6);
  acc = qadd(acc, qmul_m31(qload(pw[5]), r1));
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[6]), r1));
  r1 = q.at(5);
  r5 = q.at(1);
  r1 = sub(r1, r5);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[7]), r1));
  r1 = q.at(6);
  r6 = q.at(2);
  r1 = sub(r1, r6);
  r6 = 1u;
  r1 = sub(r1, r6);
  r0 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[8]), r0));
  r0 = q.at(12);
  acc = qadd(acc, qmul(q.logup_value<14, 0, true, -1, -1>(s, r0, r4, r5), qload(pw[9])));
  r0 = q.at(13);
  acc = qadd(acc, qmul(q.logup_value<18, 0, true, 22, 24>(s, r0, r3, r2), qload(pw[10])));
  return acc;
}

// max_reduce: 91 instructions, 11 registers, K = 12, E = 6, 20 main, 0 preprocessed columns, 2 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_max_reduce(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u, r9 = 0u, r10 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(11);
  r2 = 1u;
  r2 = sub(r1, r2);
  r2 = mul(r1, r2);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r2));
  r2 = q.at(12);
  r3 = 1u;
  r3 = sub(r2, r3);
  r3 = mul(r2, r3);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r3));
  r3 = q.at(10);
  r4 = q.at(7);
  r5 = sub(r3, r4);
  r5 = mul(r1, r5);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r5));
  r5 = 1u;
  r5 = sub(r5, r1);
  r6 = q.at(9);
  r7 = sub(r3, r6);
  r5 = mul(r5, r7);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r5));
  r5 = mul(r1, r6);
  r6 = 1u;
  r1 = sub(r6, r1);
  r1 = mul(r1, r4);
  r1 = add(r5, r1);
  r5 = q.at(14);
  r6 = 256u;
  r6 = mul(r5, r6);
  r7 = q.at(13);
  r6 = add(r7, r6);
  r8 = q.at(15);
  r9 = 65536u;
  r9 = mul(r8, r9);
  r6 = add(r6, r9);
  r9 = q.at(16);
  r10 = 16777216u;
  r10 = mul(r9, r10);
  r6 = add(r6, r10);
  r6 = sub(r6, r3);
  r1 = add(r6, r1);
  acc = qadd(acc, qmul_m31(qload(pw[5]), r1));
  r1 = q.at(8);
  r6 = sub(r1, r3);
  r6 = mul(r6, r2);
  acc = qadd(acc, qmul_m31(qload(pw[6]), r6));
  r6 = 1u;
  r6 = sub(r6, r2);
  r10 = q.next(9, 46);
  r3 = sub(r10, r3);
  r3 = mul(r6, r3);
  acc = qadd(acc, qmul_m31(qload(pw[7]), r3));
  r3 = q.next(7, 45);
  r3 = sub(r10, r3);
  r2 = mul(r2, r3);
  acc = qadd(acc, qmul_m31(qload(pw[8]), r2));
  r2 = 1u;
  r0 = sub(r2, r0);
  r2 = q.at(4);
  r3 = q.at(0);
  r2 = sub(r2, r3);
  r2 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[9]), r2));
  r2 = q.at(5);
  r6 = q.at(1);
  r2 = sub(r2, r6);
  r2 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[10]), r2));
  r2 = q.at(6);
  r10 = q.at(2);
  r2 = sub(r2, r10);
  r10 = 1u;
  r2 = sub(r2, r10);
  r0 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[11]), r0));
  r0 = q.at(17);
  acc = qadd(acc, qmul(q.logup_value<20, 0, true, -1, -1>(s, r0, r4, r6), qload(pw[12])));
  r0 = q.at(18);
  acc = qadd(acc, qmul(q.logup_value<24, 0, true, -1, -1>(s, r0, r1, r3), qload(pw[13])));
  r0 = q.at(19);
  acc = qadd(acc, qmul(q.logup_value<28, 4, false, -1, -1>(s, r0, r7, 0u), qload(pw[14])));
  acc = qadd(acc, qmul(q.logup_value<32, 4, false, -1, -1>(s, r0, r5, 0u), qload(pw[15])));
  acc = qadd(acc, qmul(q.logup_value<36, 4, false, -1, -1>(s, r0, r8, 0u), qload(pw[16])));
  r1 = 4u;
  r1 = mul(r9, r1);
  acc = qadd(acc, qmul(q.logup_value<40, 4, false, 44, 47>(s, r0, r1, 0u), qload(pw[17])));
  return acc;
}

// inputs: 22 instructions, 4 registers, K = 3, E = 1, 7 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_inputs(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(2);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(3);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r1));
  r1 = q.at(4);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r3 = 1u;
  r1 = sub(r1, r3);
  r0 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r0));
  r0 = q.at(6);
  r1 = q.at(5);
  acc = qadd(acc, qmul(q.logup_value<7, 0, true, 11, 12>(s, r0, r1, r2), qload(pw[3])));
  return acc;
}

// contiguous: 30 instructions, 5 registers, K = 4, E = 2, 11 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_contiguous(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r1));
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r1));
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r0));
  r0 = q.at(9);
  r1 = q.at(7);
  acc = qadd(acc, qmul(q.logup_value<11, 0, true, -1, -1>(s, r0, r1, r3), qload(pw[4])));
  r0 = q.at(10);
  r1 = q.at(8);
  acc = qadd(acc, qmul(q.logup_value<15, 0, true, 19, 20>(s, r0, r1, r2), qload(pw[5])));
  return acc;
}

// sin_lookup: 5 instructions, 3 registers, K = 0, E = 1, 1 main, 2 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_sin_lookup(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  acc = qadd(acc, qmul(q.logup_value<3, 1, true, 7, 8>(s, r0, r1, r2), qload(pw[0])));
  return acc;
}

// exp2_lookup: 5 instructions, 3 registers, K = 0, E = 1, 1 main, 2 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_exp2_lookup(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  acc = qadd(acc, qmul(q.logup_value<3, 2, true, 7, 8>(s, r0, r1, r2), qload(pw[0])));
  return acc;
}

// log2_lookup: 5 instructions, 3 registers, K = 0, E = 1, 1 main, 2 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_log2_lookup(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  acc = qadd(acc, qmul(q.logup_value<3, 3, true, 7, 8>(s, r0, r1, r2), qload(pw[0])));
  return acc;
}

// range_check_lookup: 4 instructions, 2 registers, K = 0, E = 1, 1 main, 1 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_range_check_lookup(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  acc = qadd(acc, qmul(q.logup_value<2, 4, false, 6, 7>(s, r0, r1, 0u), qload(pw[0])));
  return acc;
}

// square: 37 instructions, 7 registers, K = 5, E = 2, 12 main, 0 preprocessed columns, 0 read at the next row
__host__ __device__ __forceinline__ qm31 domain_tape_square(const TapeRow<true>& q, const uint32_t (*pw)[4]) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  qm31 acc = {0u, 0u, 0u, 0u};
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  acc = qadd(acc, qmul_m31(qload(pw[0]), r1));
  r1 = q.at(7);
  r2 = mul(r1, r1);
  r3 = q.at(8);
  r4 = 4096u;
  r4 = mul(r3, r4);
  r2 = sub(r2, r4);
  r4 = q.at(9);
  r2 = sub(r2, r4);
  acc = qadd(acc, qmul_m31(qload(pw[1]), r2));
  r2 = 1u;
  r0 = sub(r2, r0);
  r2 = q.at(4);
  r4 = q.at(0);
  r2 = sub(r2, r4);
  r2 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[2]), r2));
  r2 = q.at(5);
  r5 = q.at(1);
  r2 = sub(r2, r5);
  r2 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[3]), r2));
  r2 = q.at(6);
  r6 = q.at(2);
  r2 = sub(r2, r6);
  r6 = 1u;
  r2 = sub(r2, r6);
  r0 = mul(r0, r2);
  acc = qadd(acc, qmul_m31(qload(pw[4]), r0));
  r0 = q.at(10);
  acc = qadd(acc, qmul(q.logup_value<12, 0, true, -1, -1>(s, r0, r1, r5), qload(pw[5])));
  r0 = q.at(11);
  acc = qadd(acc, qmul(q.logup_value<16, 0, true, 20, 21>(s, r0, r3, r4), qload(pw[6])));
  return acc;
}

constexpr int AIR_KINDS = 18;

}  // namespace lum

// X(kind, component) of every compiled component.
#define LUM_AIR_TAPES(X) \
  X(0, add) \
  X(1, mul) \
  X(2, recip) \
  X(3, sqrt) \
  X(4, rem) \
  X(5, sin) \
  X(6, exp2) \
  X(7, log2) \
  X(8, less_than) \
  X(9, sum_reduce) \
  X(10, max_reduce) \
  X(11, inputs) \
  X(12, contiguous) \
  X(13, sin_lookup) \
  X(14, exp2_lookup) \
  X(15, log2_lookup) \
  X(16, range_check_lookup) \
  X(17, square)
