// The Blake2s Fiat-Shamir channel's steps (K8: csrc/channel.cu draws
// alpha0; K2's root pass, merkle.cuh, mixes each FRI layer's root and draws
// its alpha) and the proof-of-work search (K10, csrc/channel.cu).
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
// Compiles with g++ under the same shim as blake2s.cuh (with __host__
// defined empty too); the search is one thread's loop, so the host can run
// a launch's threads one after another in any order
// (tests/test_torch_channel.py).
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

// ---------------------------------------------------------------------------
// K10: the proof-of-work search.
//
// A candidate's message is digest[8] || LE64(nonce) || six zero words, one
// block with t = 40 and the last-block flag.  Round 0 of the compression
// takes the message words in order: its column step reads m[0..7], the
// digest, and of its diagonal step only G(v0, v5, v10, v15, m[8], m[9])
// reads the nonce -- the other three G's read zero words and state words
// that the digest alone set.  pow_prefix computes those seven G's once per
// thread; pow_h01 runs the rest per candidate and keeps only h[0] and h[1],
// the words the check reads (the compiler drops round 9's work that neither
// depends on).  blake2s_compress stays as it is for K2 and K8.

// The state after the seven nonce-independent G's of round 0.
__device__ __forceinline__ void pow_prefix(const uint32_t digest[8], uint32_t pre[16]) {
  uint32_t v0 = B2S_IV0 ^ B2S_PARAM0, v1 = B2S_IV1, v2 = B2S_IV2, v3 = B2S_IV3, v4 = B2S_IV4, v5 = B2S_IV5,
           v6 = B2S_IV6, v7 = B2S_IV7;
  uint32_t v8 = B2S_IV0, v9 = B2S_IV1, v10 = B2S_IV2, v11 = B2S_IV3;
  uint32_t v12 = B2S_IV4 ^ 40u, v13 = B2S_IV5, v14 = ~B2S_IV6, v15 = B2S_IV7;
  LUM_B2S_G(v0, v4, v8, v12, digest[0], digest[1])
  LUM_B2S_G(v1, v5, v9, v13, digest[2], digest[3])
  LUM_B2S_G(v2, v6, v10, v14, digest[4], digest[5])
  LUM_B2S_G(v3, v7, v11, v15, digest[6], digest[7])
  LUM_B2S_G(v1, v6, v11, v12, 0u, 0u)
  LUM_B2S_G(v2, v7, v8, v13, 0u, 0u)
  LUM_B2S_G(v3, v4, v9, v14, 0u, 0u)
  const uint32_t v[16] = {v0, v1, v2, v3, v4, v5, v6, v7, v8, v9, v10, v11, v12, v13, v14, v15};
  for (int w = 0; w < 16; w++) pre[w] = v[w];
}

// h[0] and h[1] of H(digest || LE64(nonce)), from pow_prefix's state.
__device__ __forceinline__ void pow_h01(const uint32_t pre[16], const uint32_t digest[8], uint64_t nonce,
                                        uint32_t& h0, uint32_t& h1) {
  const uint32_t m[16] = {digest[0], digest[1], digest[2], digest[3], digest[4], digest[5], digest[6], digest[7],
                          (uint32_t)nonce, (uint32_t)(nonce >> 32), 0u, 0u, 0u, 0u, 0u, 0u};
  uint32_t v0 = pre[0], v1 = pre[1], v2 = pre[2], v3 = pre[3], v4 = pre[4], v5 = pre[5], v6 = pre[6], v7 = pre[7];
  uint32_t v8 = pre[8], v9 = pre[9], v10 = pre[10], v11 = pre[11], v12 = pre[12], v13 = pre[13], v14 = pre[14],
           v15 = pre[15];
  LUM_B2S_G(v0, v5, v10, v15, m[8], m[9])
  LUM_B2S_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  LUM_B2S_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  LUM_B2S_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  LUM_B2S_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  LUM_B2S_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  LUM_B2S_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  LUM_B2S_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  LUM_B2S_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  LUM_B2S_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  h0 = (B2S_IV0 ^ B2S_PARAM0) ^ v0 ^ v8;
  h1 = B2S_IV1 ^ v1 ^ v9;
}

// Whether `nonce` passes a `bits`-bit proof of work (bits <= 64).
__device__ __forceinline__ bool pow_pass(const uint32_t pre[16], const uint32_t digest[8], uint64_t nonce,
                                         uint64_t mask) {
  uint32_t h0, h1;
  pow_h01(pre, digest, nonce, h0, h1);
  return (((uint64_t)h0 | ((uint64_t)h1 << 32)) & mask) == 0;
}

__host__ __device__ __forceinline__ uint64_t pow_mask(int bits) {
  return bits >= 64 ? ~0ull : (1ull << bits) - 1;
}

// One search launch.  Its scratch, two words on the card kept between
// launches, holds the least passing nonce found by launches of even and of
// odd parity (all ones: none found).  A launch of parity p searches into
// word p and puts word 1 - p back to all ones for the next launch, which
// the stream starts only after this one ends; the host copies word p once
// the launch has ended.
struct PowArgs {
  uint32_t digest[8];
  unsigned long long limit;     // nonces [0, limit) are searched
  unsigned long long* scratch;  // two words: the least passing nonce of each parity
  int bits;                     // 0..64
  int parity;                   // 0 or 1
};

// The least passing nonce found so far, read through L2 (other threads'
// atomics update it there).
__host__ __device__ __forceinline__ unsigned long long pow_read(const unsigned long long* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

__host__ __device__ __forceinline__ void pow_min(unsigned long long* p, unsigned long long v) {
#ifdef __CUDA_ARCH__
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}

// The search of thread `mine` of a launch whose rounds are W nonces wide:
// round r covers the nonces [rW, (r + 1)W), one a thread, this thread
// taking rW + mine (on the card mine = blockIdx.x * blockDim.x +
// threadIdx.x, W = gridDim.x * blockDim.x).  A passing nonce goes through
// atomicMin to `best`; after each round the thread reads `best` and stops
// once it lies below the next round's first nonce.
//
// Invariant: let n* be the least passing nonce below the limit.  `best` is
// only ever lowered to passing nonces, so it never lies below n*; the
// thread that owns n* reaches n*'s round r* through rounds whose next first
// nonce (r + 1)W <= r* W <= n* <= best, so it never stops before it checks
// n*.  Whatever order the threads and CTAs run in, `best` ends at n*: the
// reference's nonce, the smallest.
//
// Thread 0 also puts the other parity's word back to all ones.
__device__ __forceinline__ void pow_search(const PowArgs& a, unsigned long long mine, unsigned long long W) {
  if (mine == 0) a.scratch[1 - a.parity] = ~0ull;
  unsigned long long* best = a.scratch + a.parity;
  const uint64_t mask = pow_mask(a.bits);
  uint32_t pre[16];
  pow_prefix(a.digest, pre);
  for (unsigned long long start = 0; start < a.limit; start += W) {
    const unsigned long long nonce = start + mine;
    if (nonce < a.limit && pow_pass(pre, a.digest, nonce, mask)) pow_min(best, nonce);
    if (pow_read(best) < start + W) break;
  }
}

}  // namespace lum
