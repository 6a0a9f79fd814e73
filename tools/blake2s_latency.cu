// Latency probes for one thread, timed with clock64(); a measurement that
// no path of the prover runs.  chip_smoke.py builds this file with nvcc
// (the flags of luminair_tpu_torch.kernels, -I luminair_tpu_torch/csrc)
// and loads it with ctypes.
//
//   lum_blake2s_chain        n dependent Blake2s compressions (csrc/
//                            blake2s.cuh's blake2s_compress, each on the
//                            state the last one left): the latency unit of
//                            K8's bound.
//   lum_blake2s_critical_path n times the dependent-operation chain of one
//                            compression, written out here and not taken
//                            from csrc/: 10 rounds x 2 half-rounds, and in a
//                            G each value feeds the next (a, d, c, b twice,
//                            each an add then an xor and a rotate), so 20
//                            G's one after another on one 4-word state are
//                            the 240 dependent operations that no schedule
//                            of a compression can shorten.  A floor that does
//                            not depend on the code under test.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2s.cuh"

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__global__ void blake2s_chain_kernel(uint32_t* h_io, long long n, long long* cycles) {
  uint32_t h[8], m[16];
  for (int w = 0; w < 8; w++) h[w] = h_io[w];
  for (int w = 0; w < 16; w++) m[w] = h_io[8 + w];
  const long long t0 = clock64();
  for (long long i = 0; i < n; i++) lum::blake2s_compress(h, m, (uint32_t)(64 * (i + 1)), false);
  *cycles = clock64() - t0;
  for (int w = 0; w < 8; w++) h_io[w] = h[w];
}

__global__ void critical_path_kernel(uint32_t* io, long long n, long long* cycles) {
  uint32_t a = io[0], b = io[1], c = io[2], d = io[3];
  const uint32_t x = io[4], y = io[5];
  const long long t0 = clock64();
  for (long long i = 0; i < n; i++) {
#pragma unroll
    for (int g = 0; g < 20; g++) {
      a = a + b + x;
      d = rotr(d ^ a, 16);
      c = c + d;
      b = rotr(b ^ c, 12);
      a = a + b + y;
      d = rotr(d ^ a, 8);
      c = c + d;
      b = rotr(b ^ c, 7);
    }
  }
  *cycles = clock64() - t0;
  io[0] = a, io[1] = b, io[2] = c, io[3] = d;
}

}  // namespace

// h_io: 8 state words (updated) then 16 message words; cycles: one word.
extern "C" int lum_blake2s_chain(uint32_t* h_io, long long n, long long* cycles, void* stream) {
  blake2s_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(h_io, n, cycles);
  return (int)cudaGetLastError();
}

// io: a, b, c, d (updated), then the two message words x, y; cycles: one word.
extern "C" int lum_blake2s_critical_path(uint32_t* io, long long n, long long* cycles, void* stream) {
  critical_path_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(io, n, cycles);
  return (int)cudaGetLastError();
}
