// Blake2s-256 compression shared by the Merkle layer (K2, merkle.cu), the
// Fiat-Shamir channel's steps (K8, channel.cuh; one of them inside K2's root
// pass) and the proof-of-work search (K10, channel.cuh).
//
// Digests are bit-identical to hashlib.blake2s: 32-byte output, no key, the
// 8 state words little-endian.  The message block lives in registers (the
// rounds are written out with literal SIGMA indices so nothing spills to
// local memory).
//
// Like trace.cuh, this header compiles with g++ when __device__ is defined
// empty and __forceinline__ as inline: the CPU tests run it that way.
#pragma once

#include <stdint.h>

namespace lum {

constexpr uint32_t B2S_IV0 = 0x6A09E667u, B2S_IV1 = 0xBB67AE85u, B2S_IV2 = 0x3C6EF372u,
                   B2S_IV3 = 0xA54FF53Au, B2S_IV4 = 0x510E527Fu, B2S_IV5 = 0x9B05688Cu,
                   B2S_IV6 = 0x1F83D9ABu, B2S_IV7 = 0x5BE0CD19u;
// Parameter block word 0: digest length 32, no key, fanout 1, depth 1.
constexpr uint32_t B2S_PARAM0 = 0x01010020u;

// nvcc compiles the rotate to one funnel shift.
__device__ __forceinline__ uint32_t b2s_rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

#define LUM_B2S_G(a, b, c, d, x, y) \
  a = a + b + (x);                  \
  d = b2s_rotr(d ^ a, 16);          \
  c = c + d;                        \
  b = b2s_rotr(b ^ c, 12);          \
  a = a + b + (y);                  \
  d = b2s_rotr(d ^ a, 8);           \
  c = c + d;                        \
  b = b2s_rotr(b ^ c, 7);

#define LUM_B2S_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  LUM_B2S_G(v0, v4, v8, v12, m[s0], m[s1])                                                 \
  LUM_B2S_G(v1, v5, v9, v13, m[s2], m[s3])                                                 \
  LUM_B2S_G(v2, v6, v10, v14, m[s4], m[s5])                                                \
  LUM_B2S_G(v3, v7, v11, v15, m[s6], m[s7])                                                \
  LUM_B2S_G(v0, v5, v10, v15, m[s8], m[s9])                                                \
  LUM_B2S_G(v1, v6, v11, v12, m[s10], m[s11])                                              \
  LUM_B2S_G(v2, v7, v8, v13, m[s12], m[s13])                                               \
  LUM_B2S_G(v3, v4, v9, v14, m[s14], m[s15])

// One compression of block m into state h; t is the byte counter after
// this block (messages here stay below 2^32 bytes), last the final flag.
__device__ __forceinline__ void blake2s_compress(uint32_t h[8], const uint32_t m[16], uint32_t t, bool last) {
  uint32_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3], v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint32_t v8 = B2S_IV0, v9 = B2S_IV1, v10 = B2S_IV2, v11 = B2S_IV3;
  uint32_t v12 = B2S_IV4 ^ t, v13 = B2S_IV5, v14 = last ? ~B2S_IV6 : B2S_IV6, v15 = B2S_IV7;
  LUM_B2S_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  LUM_B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  LUM_B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  LUM_B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  LUM_B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  LUM_B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  LUM_B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  LUM_B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  LUM_B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  LUM_B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

// LUM_B2S_G and LUM_B2S_ROUND stay defined: the proof-of-work search
// (channel.cuh) runs the same rounds on a state it starts part-way.

__device__ __forceinline__ void blake2s_init(uint32_t h[8]) {
  h[0] = B2S_IV0 ^ B2S_PARAM0;
  h[1] = B2S_IV1;
  h[2] = B2S_IV2;
  h[3] = B2S_IV3;
  h[4] = B2S_IV4;
  h[5] = B2S_IV5;
  h[6] = B2S_IV6;
  h[7] = B2S_IV7;
}

// Blake2s of a message of n_bytes <= 64 held zero-padded in one block.
__device__ __forceinline__ void blake2s_one_block(const uint32_t m[16], uint32_t n_bytes, uint32_t out[8]) {
  blake2s_init(out);
  blake2s_compress(out, m, n_bytes, true);
}

}  // namespace lum
