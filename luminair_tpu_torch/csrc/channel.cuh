// The Blake2s Fiat-Shamir channel's steps, one thread's work each
// (csrc/channel.cu: K8 draws and mixes, K10 the proof-of-work search).
//
// The spec is the host channel (luminair_tpu_torch/crypto/channel.py, the
// reference's crypto/channel.py):
//   mix root:    digest = H(digest || root)       64 bytes, one block;
//                counter = 0
//   draw block:  H(digest || LE64(counter))       40 bytes, zero-padded;
//                counter += 1
//   draw felt:   words w >= 2P (0xFFFFFFFE, 0xFFFFFFFF) are rejected, the
//                others reduced mod P, until 4 are taken; the rest of the
//                last block is discarded
//   PoW check:   the low `bits` of the hash's first 8 bytes (LE64) of
//                H(digest || LE64(nonce)) are zero
//
// Device state, int32 words: {digest[8], counter, alpha[4]} -- the counter
// is the low word of the LE64 draw counter (its high word is 0: a digest is
// never drawn from 2^32 times), alpha the last QM31 drawn.
//
// Compiles with g++ under the same shim as blake2s.cuh.
#pragma once

#include <stdint.h>

#include "blake2s.cuh"

namespace lum {

constexpr int CH_DIGEST = 0, CH_COUNTER = 8, CH_ALPHA = 9, CH_WORDS = 13;
constexpr uint32_t CH_P = 0x7fffffffu;
constexpr uint32_t CH_REJECT = 0xfffffffeu;  // 2P: words at or above it are rejected

// Take the accepted words of one draw block into out[n..4); returns the new
// count.  Words after the fourth accepted one are discarded.
__device__ __forceinline__ int take_words(const uint32_t block[8], uint32_t out[4], int n) {
  for (int i = 0; i < 8 && n < 4; i++) {
    uint32_t w = block[i];
    if (w < CH_REJECT) out[n++] = w >= CH_P ? w - CH_P : w;
  }
  return n;
}

// H(digest || LE64(counter)).
__device__ __forceinline__ void draw_block(const uint32_t digest[8], uint64_t counter, uint32_t out[8]) {
  uint32_t m[16];
  for (int w = 0; w < 8; w++) m[w] = digest[w];
  m[8] = (uint32_t)counter;
  m[9] = (uint32_t)(counter >> 32);
  for (int w = 10; w < 16; w++) m[w] = 0;
  blake2s_one_block(m, 40, out);
}

// One QM31 from the state: alpha and the counter are updated in place.
__device__ __forceinline__ void draw_felt(uint32_t* state) {
  uint32_t digest[8], out[4] = {0, 0, 0, 0};
  for (int w = 0; w < 8; w++) digest[w] = state[CH_DIGEST + w];
  uint32_t counter = state[CH_COUNTER];
  int n = 0;
  while (n < 4) {
    uint32_t block[8];
    draw_block(digest, counter, block);
    counter++;
    n = take_words(block, out, n);
  }
  state[CH_COUNTER] = counter;
  for (int k = 0; k < 4; k++) state[CH_ALPHA + k] = out[k];
}

// digest = H(digest || root); counter = 0.
__device__ __forceinline__ void mix_root(uint32_t* state, const uint32_t root[8]) {
  uint32_t m[16];
  for (int w = 0; w < 8; w++) {
    m[w] = state[CH_DIGEST + w];
    m[8 + w] = root[w];
  }
  uint32_t digest[8];
  blake2s_one_block(m, 64, digest);
  for (int w = 0; w < 8; w++) state[CH_DIGEST + w] = digest[w];
  state[CH_COUNTER] = 0;
}

// Whether `nonce` passes a `bits`-bit proof of work on `digest` (bits <= 64).
__device__ __forceinline__ bool pow_ok(const uint32_t digest[8], uint64_t nonce, int bits) {
  uint32_t h[8];
  draw_block(digest, nonce, h);
  uint64_t v = (uint64_t)h[0] | ((uint64_t)h[1] << 32);
  uint64_t mask = bits >= 64 ? ~0ull : (1ull << bits) - 1;
  return (v & mask) == 0;
}

}  // namespace lum
