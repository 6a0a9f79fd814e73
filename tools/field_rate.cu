// Throughput probe of the prover's field arithmetic on the whole card, a
// measurement that no path of the prover runs: the rate at which csrc/
// m31.cuh's M31 and QM31 operations issue when nothing else limits them.
// chip_smoke.py builds this file with nvcc (the flags of
// luminair_tpu_torch.kernels, -I luminair_tpu_torch/csrc), loads it with
// ctypes, times each mode with CUDA events and divides the operations that
// its bounds count (OPS_MUL, OPS_ADD, OPS_QMUL) by the time.
//
//   mode 0  M31 products: x = mul(x, y), CHAINS chains a thread
//   mode 1  M31 sums: x = add(x, y), CHAINS chains a thread
//   mode 2  QM31 products and sums: x = qadd(qmul(x, y), z), QCHAINS chains
//
// The chains of a thread are independent and every CTA of the grid runs
// the same number of steps, so the card's issue rate, not a latency, sets
// the time.  y and z come from memory, and each thread writes its chains'
// xor back, so the compiler can fold nothing away.

#include <cuda_runtime.h>
#include <stdint.h>

#include "m31.cuh"

namespace {

constexpr int CHAINS = 8;
constexpr int QCHAINS = 4;

template <int MODE>
__global__ void field_rate_kernel(uint32_t* io, long long steps) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t y = io[0] | 1u, w = io[1];
  uint32_t out = 0;
  if (MODE == 2) {
    const lum::qm31 qy = {y, io[2], io[3], io[4]}, qz = {w, io[5], io[6], io[7]};
    lum::qm31 x[QCHAINS];
#pragma unroll
    for (int c = 0; c < QCHAINS; c++) x[c] = {(t + c) % lum::P, (t ^ c) % lum::P, c + 1u, t % 7u};
#pragma unroll 2
    for (long long i = 0; i < steps; i++) {
#pragma unroll
      for (int c = 0; c < QCHAINS; c++) x[c] = lum::qadd(lum::qmul(x[c], qy), qz);
    }
#pragma unroll
    for (int c = 0; c < QCHAINS; c++) out ^= x[c].a ^ x[c].b ^ x[c].c ^ x[c].d;
  } else {
    uint32_t x[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; c++) x[c] = (t * CHAINS + c) % lum::P;
#pragma unroll 4
    for (long long i = 0; i < steps; i++) {
#pragma unroll
      for (int c = 0; c < CHAINS; c++) x[c] = MODE == 0 ? lum::mul(x[c], y) : lum::add(x[c], y);
    }
#pragma unroll
    for (int c = 0; c < CHAINS; c++) out ^= x[c];
  }
  io[8 + t] = out;
}

}  // namespace

// io: 8 words of operands, then one output word a thread (blocks x threads).
extern "C" int lum_field_rate(int mode, uint32_t* io, long long steps, int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) field_rate_kernel<0><<<blocks, threads, 0, s>>>(io, steps);
  else if (mode == 1) field_rate_kernel<1><<<blocks, threads, 0, s>>>(io, steps);
  else if (mode == 2) field_rate_kernel<2><<<blocks, threads, 0, s>>>(io, steps);
  else return -1;
  return (int)cudaGetLastError();
}
