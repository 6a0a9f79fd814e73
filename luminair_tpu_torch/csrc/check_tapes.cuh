// Generated by luminair_tpu_torch/air/tape_cuda.py from the components' check
// tapes (air/tape.py `record`); do not edit.  Regenerate with
//     python3 -m luminair_tpu_torch.air.tape_cuda
// tests/test_torch_check_tapes.py fails while this file and the tapes differ.
//
// Each function is one component's check tape as straight-line code (see
// check.cuh): it returns the row's word, bit k for the k-th recorded
// constraint, bit K + b for relation entry b's LogUp constraint.
//
// The manifest, `tape <kind> <component> <sha256 of the tape's shape and words>`
// (kernels.tape_digest; kernels.compiled_check_tapes reads it):
// tape 0 add 8aa2067e75547648c887641a5856756b8d195d3115bd1b6b7cb377efe4353a25
// tape 1 mul ab0695cf8289bf5313d9fadf514106b3b7d0f739661b04bc36e3b75b202afd12
// tape 2 recip 5b87df6c83699a70d21d3074b1fbb28d1babc7dcc03311761e6061d125774f1d
// tape 3 sqrt 2c9158c8e375e01490f5f819c32f02b157c0af598a07ea76f942e5f4a109ab54
// tape 4 rem bea31d45e2401e08c8f4cb0facc47d82d590bb9b76dbe7fb771a38b5d704231d
// tape 5 sin 64ad4f2fda59e41b7dddbce3181f067576c83ed1768422a31ed858e554fc6f65
// tape 6 exp2 66783c34c48b36be17512dd422f949de027aba468f5512591dcceafb22c0584c
// tape 7 log2 acc811177668db2a2fb8efd1ea06c44f035fb3b55e9e0647f7e5eb320b35e065
// tape 8 less_than f491f034adc9b63cdeb5c8ef26d347bb31c57480b863009f668008134fb8bf95
// tape 9 sum_reduce 6a0ad60198e49df0a0dff904467acce09ef55ec77289ebca3573fe31cdd88959
// tape 10 max_reduce a3f9cd2c92550c05b414027d12267c1e2f7cb22d3051b84a52ded1099d22969b
// tape 11 inputs 5ae4374afd760e61548c576846bc643ea04a30597127f3ad19f908922bc73ef8
// tape 12 contiguous 4e9c27c91ae9a8854b2c1add05731be47c60bcd2ae9062f5b748196be459d134
// tape 13 sin_lookup e88617ee6fbd72f12210b978e22bd1b2d0aa8e0eeb0ffe6f36a22ba61637e7ac
// tape 14 exp2_lookup e78b55f2eddc3d140bde379ae0c95e734e5365d00461e9aef49f2d274a2d6b78
// tape 15 log2_lookup 3890febe6c1d5724115c9390cef1f3ff9fa4a92f43183b16413dbf3812f4a9ea
// tape 16 range_check_lookup 87816c5e382b3d22d13646108d44b7adda126d6b653435582e5c97e574c339b2
// tape 17 square 2e817f5b5d7000cffea2eb9891e8937889b2c86d25fd09f54911120fa0a5fd1e
#pragma once

namespace lum {

// add: 41 instructions, 9 registers, K = 6, E = 3, 15 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_add(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(9);
  r2 = q.at(10);
  r3 = add(r1, r2);
  r4 = q.at(11);
  r3 = sub(r3, r4);
  w |= nonzero(r3) << 1;
  r3 = 1u;
  r0 = sub(r3, r0);
  r3 = q.at(5);
  r5 = q.at(0);
  r3 = sub(r3, r5);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 2;
  r3 = q.at(6);
  r6 = q.at(1);
  r3 = sub(r3, r6);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 3;
  r3 = q.at(7);
  r7 = q.at(2);
  r3 = sub(r3, r7);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 4;
  r3 = q.at(8);
  r8 = q.at(3);
  r3 = sub(r3, r8);
  r8 = 1u;
  r3 = sub(r3, r8);
  r0 = mul(r0, r3);
  w |= nonzero(r0) << 5;
  r0 = q.at(12);
  w |= q.logup<15, 0, true, -1>(s, r0, r1, r6) << 6;
  r0 = q.at(13);
  w |= q.logup<19, 0, true, -1>(s, r0, r2, r7) << 7;
  r0 = q.at(14);
  w |= q.logup<23, 0, true, 27>(s, r0, r4, r5) << 8;
  return w;
}

// mul: 45 instructions, 9 registers, K = 6, E = 3, 16 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_mul(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(9);
  r2 = q.at(10);
  r3 = mul(r1, r2);
  r4 = q.at(11);
  r5 = 4096u;
  r5 = mul(r4, r5);
  r3 = sub(r3, r5);
  r5 = q.at(12);
  r3 = sub(r3, r5);
  w |= nonzero(r3) << 1;
  r3 = 1u;
  r0 = sub(r3, r0);
  r3 = q.at(5);
  r5 = q.at(0);
  r3 = sub(r3, r5);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 2;
  r3 = q.at(6);
  r6 = q.at(1);
  r3 = sub(r3, r6);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 3;
  r3 = q.at(7);
  r7 = q.at(2);
  r3 = sub(r3, r7);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 4;
  r3 = q.at(8);
  r8 = q.at(3);
  r3 = sub(r3, r8);
  r8 = 1u;
  r3 = sub(r3, r8);
  r0 = mul(r0, r3);
  w |= nonzero(r0) << 5;
  r0 = q.at(13);
  w |= q.logup<16, 0, true, -1>(s, r0, r1, r6) << 6;
  r0 = q.at(14);
  w |= q.logup<20, 0, true, -1>(s, r0, r2, r7) << 7;
  r0 = q.at(15);
  w |= q.logup<24, 0, true, 28>(s, r0, r4, r5) << 8;
  return w;
}

// recip: 37 instructions, 7 registers, K = 5, E = 2, 13 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_recip(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(7);
  r2 = q.at(8);
  r3 = mul(r1, r2);
  r4 = q.at(9);
  r3 = add(r3, r4);
  r4 = q.at(10);
  r4 = mul(r4, r4);
  r3 = sub(r3, r4);
  w |= nonzero(r3) << 1;
  r3 = 1u;
  r0 = sub(r3, r0);
  r3 = q.at(4);
  r4 = q.at(0);
  r3 = sub(r3, r4);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 2;
  r3 = q.at(5);
  r5 = q.at(1);
  r3 = sub(r3, r5);
  r3 = mul(r0, r3);
  w |= nonzero(r3) << 3;
  r3 = q.at(6);
  r6 = q.at(2);
  r3 = sub(r3, r6);
  r6 = 1u;
  r3 = sub(r3, r6);
  r0 = mul(r0, r3);
  w |= nonzero(r0) << 4;
  r0 = q.at(11);
  w |= q.logup<13, 0, true, -1>(s, r0, r1, r5) << 5;
  r0 = q.at(12);
  w |= q.logup<17, 0, true, 21>(s, r0, r2, r4) << 6;
  return w;
}

// sqrt: 37 instructions, 7 registers, K = 5, E = 2, 13 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_sqrt(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(8);
  r2 = mul(r1, r1);
  r3 = q.at(9);
  r2 = add(r2, r3);
  r3 = q.at(7);
  r4 = q.at(10);
  r4 = mul(r3, r4);
  r2 = sub(r2, r4);
  w |= nonzero(r2) << 1;
  r2 = 1u;
  r0 = sub(r2, r0);
  r2 = q.at(4);
  r4 = q.at(0);
  r2 = sub(r2, r4);
  r2 = mul(r0, r2);
  w |= nonzero(r2) << 2;
  r2 = q.at(5);
  r5 = q.at(1);
  r2 = sub(r2, r5);
  r2 = mul(r0, r2);
  w |= nonzero(r2) << 3;
  r2 = q.at(6);
  r6 = q.at(2);
  r2 = sub(r2, r6);
  r6 = 1u;
  r2 = sub(r2, r6);
  r0 = mul(r0, r2);
  w |= nonzero(r0) << 4;
  r0 = q.at(11);
  w |= q.logup<13, 0, true, -1>(s, r0, r3, r5) << 5;
  r0 = q.at(12);
  w |= q.logup<17, 0, true, 21>(s, r0, r1, r4) << 6;
  return w;
}

// rem: 43 instructions, 9 registers, K = 6, E = 3, 16 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_rem(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(12);
  r2 = q.at(10);
  r1 = mul(r1, r2);
  r3 = q.at(11);
  r1 = add(r1, r3);
  r4 = q.at(9);
  r1 = sub(r1, r4);
  w |= nonzero(r1) << 1;
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(5);
  r5 = q.at(0);
  r1 = sub(r1, r5);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 2;
  r1 = q.at(6);
  r6 = q.at(1);
  r1 = sub(r1, r6);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 3;
  r1 = q.at(7);
  r7 = q.at(2);
  r1 = sub(r1, r7);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 4;
  r1 = q.at(8);
  r8 = q.at(3);
  r1 = sub(r1, r8);
  r8 = 1u;
  r1 = sub(r1, r8);
  r0 = mul(r0, r1);
  w |= nonzero(r0) << 5;
  r0 = q.at(13);
  w |= q.logup<16, 0, true, -1>(s, r0, r4, r6) << 6;
  r0 = q.at(14);
  w |= q.logup<20, 0, true, -1>(s, r0, r2, r7) << 7;
  r0 = q.at(15);
  w |= q.logup<24, 0, true, 28>(s, r0, r3, r5) << 8;
  return w;
}

// sin: 32 instructions, 5 registers, K = 4, E = 3, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_sin(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 1;
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 2;
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  w |= nonzero(r0) << 3;
  r0 = q.at(9);
  r1 = q.at(7);
  w |= q.logup<12, 0, true, -1>(s, r0, r1, r3) << 4;
  r0 = q.at(10);
  r3 = q.at(8);
  w |= q.logup<16, 0, true, -1>(s, r0, r3, r2) << 5;
  r0 = q.at(11);
  w |= q.logup<20, 1, true, 24>(s, r0, r1, r3) << 6;
  return w;
}

// exp2: 32 instructions, 5 registers, K = 4, E = 3, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_exp2(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 1;
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 2;
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  w |= nonzero(r0) << 3;
  r0 = q.at(9);
  r1 = q.at(7);
  w |= q.logup<12, 0, true, -1>(s, r0, r1, r3) << 4;
  r0 = q.at(10);
  r3 = q.at(8);
  w |= q.logup<16, 0, true, -1>(s, r0, r3, r2) << 5;
  r0 = q.at(11);
  w |= q.logup<20, 2, true, 24>(s, r0, r1, r3) << 6;
  return w;
}

// log2: 32 instructions, 5 registers, K = 4, E = 3, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_log2(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 1;
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 2;
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  w |= nonzero(r0) << 3;
  r0 = q.at(9);
  r1 = q.at(7);
  w |= q.logup<12, 0, true, -1>(s, r0, r1, r3) << 4;
  r0 = q.at(10);
  r3 = q.at(8);
  w |= q.logup<16, 0, true, -1>(s, r0, r3, r2) << 5;
  r0 = q.at(11);
  w |= q.logup<20, 3, true, 24>(s, r0, r1, r3) << 6;
  return w;
}

// less_than: 76 instructions, 13 registers, K = 9, E = 7, 22 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_less_than(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u, r9 = 0u, r10 = 0u, r11 = 0u, r12 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(4);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(12);
  r2 = 1u;
  r2 = sub(r1, r2);
  r2 = mul(r1, r2);
  w |= nonzero(r2) << 1;
  r2 = 1u;
  r2 = sub(r2, r1);
  r3 = 4096u;
  r2 = mul(r2, r3);
  r3 = q.at(11);
  r2 = sub(r3, r2);
  w |= nonzero(r2) << 2;
  r2 = q.at(9);
  r4 = q.at(13);
  r5 = add(r2, r4);
  r6 = q.at(10);
  r5 = sub(r5, r6);
  r7 = 0u;
  r1 = mul(r1, r7);
  r1 = sub(r5, r1);
  w |= nonzero(r1) << 3;
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
  w |= nonzero(r4) << 4;
  r4 = 1u;
  r0 = sub(r4, r0);
  r4 = q.at(5);
  r9 = q.at(0);
  r4 = sub(r4, r9);
  r4 = mul(r0, r4);
  w |= nonzero(r4) << 5;
  r4 = q.at(6);
  r10 = q.at(1);
  r4 = sub(r4, r10);
  r4 = mul(r0, r4);
  w |= nonzero(r4) << 6;
  r4 = q.at(7);
  r11 = q.at(2);
  r4 = sub(r4, r11);
  r4 = mul(r0, r4);
  w |= nonzero(r4) << 7;
  r4 = q.at(8);
  r12 = q.at(3);
  r4 = sub(r4, r12);
  r12 = 1u;
  r4 = sub(r4, r12);
  r0 = mul(r0, r4);
  w |= nonzero(r0) << 8;
  r0 = q.at(18);
  w |= q.logup<22, 0, true, -1>(s, r0, r2, r10) << 9;
  r0 = q.at(19);
  w |= q.logup<26, 0, true, -1>(s, r0, r6, r11) << 10;
  r0 = q.at(20);
  w |= q.logup<30, 0, true, -1>(s, r0, r3, r9) << 11;
  r0 = q.at(21);
  w |= q.logup<34, 4, false, -1>(s, r0, r1, 0u) << 12;
  w |= q.logup<38, 4, false, -1>(s, r0, r5, 0u) << 13;
  w |= q.logup<42, 4, false, -1>(s, r0, r7, 0u) << 14;
  w |= q.logup<46, 4, false, 50>(s, r0, r8, 0u) << 15;
  return w;
}

// sum_reduce: 51 instructions, 7 registers, K = 9, E = 2, 14 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_sum_reduce(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(11);
  r2 = 1u;
  r2 = sub(r1, r2);
  r2 = mul(r1, r2);
  w |= nonzero(r2) << 1;
  r2 = q.at(10);
  r3 = q.at(9);
  r3 = sub(r2, r3);
  r4 = q.at(7);
  r3 = sub(r3, r4);
  w |= nonzero(r3) << 2;
  r3 = q.at(8);
  r5 = sub(r3, r2);
  r5 = mul(r5, r1);
  w |= nonzero(r5) << 3;
  r5 = 1u;
  r5 = sub(r5, r1);
  r6 = q.next(9);
  r2 = sub(r6, r2);
  r2 = mul(r5, r2);
  w |= nonzero(r2) << 4;
  r1 = mul(r1, r6);
  w |= nonzero(r1) << 5;
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 6;
  r1 = q.at(5);
  r5 = q.at(1);
  r1 = sub(r1, r5);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 7;
  r1 = q.at(6);
  r6 = q.at(2);
  r1 = sub(r1, r6);
  r6 = 1u;
  r1 = sub(r1, r6);
  r0 = mul(r0, r1);
  w |= nonzero(r0) << 8;
  r0 = q.at(12);
  w |= q.logup<14, 0, true, -1>(s, r0, r4, r5) << 9;
  r0 = q.at(13);
  w |= q.logup<18, 0, true, 22>(s, r0, r3, r2) << 10;
  return w;
}

// max_reduce: 91 instructions, 11 registers, K = 12, E = 6, 20 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_max_reduce(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u, r7 = 0u, r8 = 0u, r9 = 0u, r10 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(11);
  r2 = 1u;
  r2 = sub(r1, r2);
  r2 = mul(r1, r2);
  w |= nonzero(r2) << 1;
  r2 = q.at(12);
  r3 = 1u;
  r3 = sub(r2, r3);
  r3 = mul(r2, r3);
  w |= nonzero(r3) << 2;
  r3 = q.at(10);
  r4 = q.at(7);
  r5 = sub(r3, r4);
  r5 = mul(r1, r5);
  w |= nonzero(r5) << 3;
  r5 = 1u;
  r5 = sub(r5, r1);
  r6 = q.at(9);
  r7 = sub(r3, r6);
  r5 = mul(r5, r7);
  w |= nonzero(r5) << 4;
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
  w |= nonzero(r1) << 5;
  r1 = q.at(8);
  r6 = sub(r1, r3);
  r6 = mul(r6, r2);
  w |= nonzero(r6) << 6;
  r6 = 1u;
  r6 = sub(r6, r2);
  r10 = q.next(9);
  r3 = sub(r10, r3);
  r3 = mul(r6, r3);
  w |= nonzero(r3) << 7;
  r3 = q.next(7);
  r3 = sub(r10, r3);
  r2 = mul(r2, r3);
  w |= nonzero(r2) << 8;
  r2 = 1u;
  r0 = sub(r2, r0);
  r2 = q.at(4);
  r3 = q.at(0);
  r2 = sub(r2, r3);
  r2 = mul(r0, r2);
  w |= nonzero(r2) << 9;
  r2 = q.at(5);
  r6 = q.at(1);
  r2 = sub(r2, r6);
  r2 = mul(r0, r2);
  w |= nonzero(r2) << 10;
  r2 = q.at(6);
  r10 = q.at(2);
  r2 = sub(r2, r10);
  r10 = 1u;
  r2 = sub(r2, r10);
  r0 = mul(r0, r2);
  w |= nonzero(r0) << 11;
  r0 = q.at(17);
  w |= q.logup<20, 0, true, -1>(s, r0, r4, r6) << 12;
  r0 = q.at(18);
  w |= q.logup<24, 0, true, -1>(s, r0, r1, r3) << 13;
  r0 = q.at(19);
  w |= q.logup<28, 4, false, -1>(s, r0, r7, 0u) << 14;
  w |= q.logup<32, 4, false, -1>(s, r0, r5, 0u) << 15;
  w |= q.logup<36, 4, false, -1>(s, r0, r8, 0u) << 16;
  r1 = 4u;
  r1 = mul(r9, r1);
  w |= q.logup<40, 4, false, 44>(s, r0, r1, 0u) << 17;
  return w;
}

// inputs: 22 instructions, 4 registers, K = 3, E = 1, 7 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_inputs(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(2);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(3);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 1;
  r1 = q.at(4);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r3 = 1u;
  r1 = sub(r1, r3);
  r0 = mul(r0, r1);
  w |= nonzero(r0) << 2;
  r0 = q.at(6);
  r1 = q.at(5);
  w |= q.logup<7, 0, true, 11>(s, r0, r1, r2) << 3;
  return w;
}

// contiguous: 30 instructions, 5 registers, K = 4, E = 2, 11 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_contiguous(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = 1u;
  r0 = sub(r1, r0);
  r1 = q.at(4);
  r2 = q.at(0);
  r1 = sub(r1, r2);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 1;
  r1 = q.at(5);
  r3 = q.at(1);
  r1 = sub(r1, r3);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 2;
  r1 = q.at(6);
  r4 = q.at(2);
  r1 = sub(r1, r4);
  r4 = 1u;
  r1 = sub(r1, r4);
  r0 = mul(r0, r1);
  w |= nonzero(r0) << 3;
  r0 = q.at(9);
  r1 = q.at(7);
  w |= q.logup<11, 0, true, -1>(s, r0, r1, r3) << 4;
  r0 = q.at(10);
  r1 = q.at(8);
  w |= q.logup<15, 0, true, 19>(s, r0, r1, r2) << 5;
  return w;
}

// sin_lookup: 5 instructions, 3 registers, K = 0, E = 1, 1 main, 2 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_sin_lookup(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  w |= q.logup<3, 1, true, 7>(s, r0, r1, r2) << 0;
  return w;
}

// exp2_lookup: 5 instructions, 3 registers, K = 0, E = 1, 1 main, 2 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_exp2_lookup(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  w |= q.logup<3, 2, true, 7>(s, r0, r1, r2) << 0;
  return w;
}

// log2_lookup: 5 instructions, 3 registers, K = 0, E = 1, 1 main, 2 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_log2_lookup(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  r2 = q.at(2);
  w |= q.logup<3, 3, true, 7>(s, r0, r1, r2) << 0;
  return w;
}

// range_check_lookup: 4 instructions, 2 registers, K = 0, E = 1, 1 main, 1 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_range_check_lookup(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(0);
  r0 = neg(r0);
  r1 = q.at(1);
  w |= q.logup<2, 4, false, 6>(s, r0, r1, 0u) << 0;
  return w;
}

// square: 37 instructions, 7 registers, K = 5, E = 2, 12 main, 0 preprocessed columns
__host__ __device__ __forceinline__ uint32_t check_tape_square(const CheckRow& q) {
  uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u, r4 = 0u, r5 = 0u, r6 = 0u;
  uint32_t w = 0u;
  qm31 s = {0u, 0u, 0u, 0u};  // S_{b-1}
  r0 = q.at(3);
  r1 = 1u;
  r1 = sub(r0, r1);
  r1 = mul(r0, r1);
  w |= nonzero(r1) << 0;
  r1 = q.at(7);
  r2 = mul(r1, r1);
  r3 = q.at(8);
  r4 = 4096u;
  r4 = mul(r3, r4);
  r2 = sub(r2, r4);
  r4 = q.at(9);
  r2 = sub(r2, r4);
  w |= nonzero(r2) << 1;
  r2 = 1u;
  r0 = sub(r2, r0);
  r2 = q.at(4);
  r4 = q.at(0);
  r2 = sub(r2, r4);
  r2 = mul(r0, r2);
  w |= nonzero(r2) << 2;
  r2 = q.at(5);
  r5 = q.at(1);
  r2 = sub(r2, r5);
  r2 = mul(r0, r2);
  w |= nonzero(r2) << 3;
  r2 = q.at(6);
  r6 = q.at(2);
  r2 = sub(r2, r6);
  r6 = 1u;
  r2 = sub(r2, r6);
  r0 = mul(r0, r2);
  w |= nonzero(r0) << 4;
  r0 = q.at(10);
  w |= q.logup<12, 0, true, -1>(s, r0, r1, r5) << 5;
  r0 = q.at(11);
  w |= q.logup<16, 0, true, 20>(s, r0, r3, r4) << 6;
  return w;
}

constexpr int CHECK_KINDS = 18;

}  // namespace lum

// X(kind, component) of every compiled tape.
#define LUM_CHECK_TAPES(X) \
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
