// K0 check entry: runs the device functions of rng.cuh elementwise, so the
// on-card build of the cipher and the float32 math can be held against the
// plain PyTorch versions (rng/threefry.py, rng/normal.py).  Not on the
// pricing path; it exists to test K0 on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

__global__ void rng_check_kernel(const uint32_t* __restrict__ c0,
                                 const uint32_t* __restrict__ c1,
                                 const float* __restrict__ x, int64_t n,
                                 uint32_t k0, uint32_t k1,
                                 uint32_t* __restrict__ bits,
                                 float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t b0, b1;
  mc::threefry2x32(k0, k1, c0[i], c1[i], &b0, &b1);
  float z0, z1;
  mc::boxmuller_pair(b0, b1, &z0, &z1);
  bits[i] = b0;
  bits[n + i] = b1;
  out[i] = mc::uniform_from_bits(b0);
  out[n + i] = mc::uniform_from_bits(b1);
  out[2 * n + i] = z0;
  out[3 * n + i] = z1;
  out[4 * n + i] = mc::exp32(x[i]);
  out[5 * n + i] = mc::log32(x[n + i]);
}

}  // namespace

// bits (2, n) uint32: Threefry words; out (6, n) float32: u0, u1, z0, z1,
// exp32(x[0, :]), log32(x[1, :]).
extern "C" int mc_rng_check(uint32_t* bits, float* out, const uint32_t* c0,
                            const uint32_t* c1, const float* x, int64_t n,
                            uint32_t k0, uint32_t k1, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  rng_check_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      c0, c1, x, n, k0, k1, bits, out);
  return (int)cudaGetLastError();
}
