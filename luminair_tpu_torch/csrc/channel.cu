// K8: the Blake2s Fiat-Shamir channel on the card, and K10: the
// proof-of-work nonce search.
//
// K8 replaces the JAX package's device channel, `_dev_draw_block`,
// `_dev_draw_felt`, `_dev_mix_root` and `_jit_draw_felt`
// (parallel/accel.py), which the FRI commit chain (`_jit_fri_layer`,
// `_jit_fri_chain`) runs so that no layer root has to come to the host
// before its fold challenge is drawn.  A transcript step is a chain of
// dependent Blake2s compressions on the device state {digest[8], counter,
// alpha[4]} (csrc/channel.cuh), one thread's work.  Here is the one step
// that stands alone, lum_channel_draw_felt (alpha0); each committed FRI
// layer's step (mix its root, draw its alpha) runs in the thread of K2's
// root pass that computes the root (csrc/merkle.cuh), so it costs no
// launch.  Each step copies what it drew into the FRI record, so the
// chain's roots and challenges come down in one transfer.
// Bound on this card: latency -- a step's compressions one after another
// on one thread (about 2); chip_smoke.py measures one dependent compression
// (tools/blake2s_latency.cu).
//
// K10 is the counterpart of the reference's batched host grind
// (crypto/channel.py `grind_pow`, numpy Blake2s over chunks of candidate
// nonces; not a device program there).  One launch a search: a persistent
// grid walks rounds of ascending nonces, one a thread, and stops at the
// smallest passing nonce (channel.cuh's
// pow_search: the invariant that makes the result the reference's whatever
// order the threads run in).  The digest is a launch parameter; launches
// alternate between two scratch words, each putting the other back to all
// ones, so the search needs no fill, no upload and no last-CTA pass; the
// entry point copies the result into the caller's pinned word and
// synchronises the stream, since the host waits for it.  Bound on
// this card: the integer ALU, per candidate the compression less its
// nonce-independent part and less what the check never reads (856
// instructions, chip_smoke.OPS_POW_CANDIDATE); nothing is read but the
// launch's parameters.  The grid is POW_CTAS_PER_SM CTAs an SM: a round
// is W = 2 x 132 x 128 = 33,792 nonces on an H100, about half the 2^16 a
// 16-bit search expects, so a search overshoots its nonce by half a round
// on average; a narrower round pays a hash's latency (about 0.83 us) and a
// read of `best` a round more often.  Below 12 bits the wrapper launches
// fewer CTAs (kernels.pow_ctas: a round of 8 times the expected work), so a
// 5-bit search hashes 256 nonces, not a card's width.

#include <cuda_runtime.h>
#include <stdint.h>

#include "channel.cuh"

namespace {

constexpr int POW_THREADS = 128;
constexpr int POW_CTAS_PER_SM = 2;

__global__ void channel_draw_kernel(uint32_t* state, uint32_t* alpha_out) {
  lum::draw_felt(state);
  if (alpha_out)
    for (int k = 0; k < 4; k++) alpha_out[k] = state[lum::CH_ALPHA + k];
}

__global__ void __launch_bounds__(POW_THREADS) grind_pow_kernel(const __grid_constant__ lum::PowArgs a) {
  lum::pow_search(a, (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x,
                  (unsigned long long)gridDim.x * blockDim.x);
}

}  // namespace

extern "C" long long lum_channel_words() { return lum::CH_WORDS; }
extern "C" long long lum_pow_args_size() { return (long long)sizeof(lum::PowArgs); }
extern "C" long long lum_pow_threads() { return POW_THREADS; }
extern "C" long long lum_pow_ctas_per_sm() { return POW_CTAS_PER_SM; }

extern "C" int lum_channel_draw_felt(uint32_t* state, uint32_t* alpha_out, void* stream) {
  channel_draw_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(state, alpha_out);
  return (int)cudaGetLastError();
}

// One search: the launch, then its parity's word copied into `result`
// (pinned host memory) and the stream synchronised.
extern "C" int lum_grind_pow(const lum::PowArgs* a, int ctas, unsigned long long* result, void* stream) {
  if (ctas <= 0 || a->bits < 0 || a->bits > 64 || (a->parity & ~1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  grind_pow_kernel<<<ctas, POW_THREADS, 0, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(result, a->scratch + a->parity, sizeof(unsigned long long), cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}
