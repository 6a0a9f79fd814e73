// K8: the Blake2s Fiat-Shamir channel on the card, and K10: the
// proof-of-work nonce search.
//
// K8 replaces the JAX package's device channel, `_dev_draw_block`,
// `_dev_draw_felt`, `_dev_mix_root` and `_jit_draw_felt`
// (parallel/accel.py), which the FRI commit chain (`_jit_fri_layer`,
// `_jit_fri_chain`) runs so that no layer root has to come to the host
// before its fold challenge is drawn.  One thread does one transcript step
// (csrc/channel.cuh) on the device state {digest[8], counter, alpha[4]}:
//   lum_channel_draw_felt       draw alpha;
//   lum_channel_mix_root_draw   mix a tree's root (read from its layer-0
//                               digest), then draw alpha.
// Each step also copies what it read and drew into a record slot, so the
// whole chain's roots and challenges come down in one transfer.
// Bound on this card: latency -- about three Blake2s compressions in a
// chain of dependent steps, one thread; the launch costs more than the work.
//
// K10 is the counterpart of the reference's batched host grind
// (crypto/channel.py `grind_pow`, numpy Blake2s over chunks of candidate
// nonces; not a device program there).  One thread per candidate nonce of
// a chunk [start, start + n): the smallest passing nonce wins an atomicMin
// on a 64-bit word the host reads after each chunk.  Bound on this card:
// the integer ALU, one compression (about 1,100 int32 operations) per
// candidate; nothing is read but the digest.

#include <cuda_runtime.h>
#include <stdint.h>

#include "channel.cuh"

namespace {

__global__ void channel_draw_kernel(uint32_t* state, uint32_t* alpha_out) {
  lum::draw_felt(state);
  if (alpha_out)
    for (int k = 0; k < 4; k++) alpha_out[k] = state[lum::CH_ALPHA + k];
}

__global__ void channel_mix_draw_kernel(uint32_t* state, const uint32_t* root, uint32_t* out) {
  uint32_t r[8];
  for (int w = 0; w < 8; w++) r[w] = root[w];
  lum::mix_root(state, r);
  lum::draw_felt(state);
  if (out) {
    for (int w = 0; w < 8; w++) out[w] = r[w];
    for (int k = 0; k < 4; k++) out[8 + k] = state[lum::CH_ALPHA + k];
  }
}

__global__ void grind_pow_kernel(const uint32_t* __restrict__ digest, unsigned long long start,
                                 long long n, int bits, unsigned long long* best) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t d[8];
#pragma unroll
  for (int w = 0; w < 8; w++) d[w] = digest[w];
  unsigned long long nonce = start + (unsigned long long)i;
  if (lum::pow_ok(d, nonce, bits)) atomicMin(best, nonce);
}

}  // namespace

extern "C" long long lum_channel_words() { return lum::CH_WORDS; }

extern "C" int lum_channel_draw_felt(uint32_t* state, uint32_t* alpha_out, void* stream) {
  channel_draw_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(state, alpha_out);
  return (int)cudaGetLastError();
}

extern "C" int lum_channel_mix_root_draw(uint32_t* state, const uint32_t* root, uint32_t* out,
                                         void* stream) {
  channel_mix_draw_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(state, root, out);
  return (int)cudaGetLastError();
}

extern "C" int lum_grind_pow(const uint32_t* digest, unsigned long long start, long long n, int bits,
                             unsigned long long* best, void* stream) {
  if (n > 0) {
    grind_pow_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(digest, start, n,
                                                                                     bits, best);
  }
  return (int)cudaGetLastError();
}
