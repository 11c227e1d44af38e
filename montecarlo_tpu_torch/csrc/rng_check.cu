// K0 check entries: run the device functions of rng.cuh elementwise, so the
// on-card build of the cipher, the float32 math, the Sobol normal and the
// table-inverted gamma variate can be held against the plain PyTorch
// versions (rng/threefry.py, rng/normal.py, rng/sobol.py, rng/gamma.py).
// Not on the pricing path; they exist to test K0 on the card.

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

__global__ void sobol_check_kernel(const uint32_t* __restrict__ sv,
                                   const uint32_t* __restrict__ ids,
                                   const uint32_t* __restrict__ dims,
                                   const float* __restrict__ u, int64_t n,
                                   uint32_t k0, uint32_t k1,
                                   uint32_t* __restrict__ bits,
                                   float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t dim = dims[i];
  const uint32_t x =
      mc::sobol_bits(sv + (size_t)dim * mc::kSobolBits, ids[i]);
  const uint32_t key = mc::sobol_key(k0, k1, dim);
  bits[i] = x;
  bits[n + i] = key;
  out[i] = mc::scrambled_uniform(x, key);
  out[n + i] = mc::sobol_normal(sv, k0, k1, ids[i], dim);
  out[2 * n + i] = mc::ndtri32(u[i]);
}

__global__ void gamma_check_kernel(const float* __restrict__ u_w,
                                   const float* __restrict__ u_b,
                                   const float* __restrict__ x, int64_t n,
                                   float a, float z0, float dz,
                                   const float* __restrict__ resid,
                                   const float* __restrict__ dresid,
                                   int n_table, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = mc::expneg_wide32(x[i]);
  out[n + i] = mc::gamma_from_uniforms_table32(a, u_w[i], u_b[i], z0, dz,
                                               resid, dresid, n_table);
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

// bits (2, n) uint32: the Sobol integer of (ids[i], dims[i]) in the table sv
// (n_dims, 30) and the dimension's Owen key; out (3, n) float32: the
// scrambled uniform, the Sobol normal, ndtri32(u[i]).
extern "C" int mc_sobol_check(uint32_t* bits, float* out, const uint32_t* sv,
                              const uint32_t* ids, const uint32_t* dims,
                              const float* u, int64_t n, uint32_t k0,
                              uint32_t k1, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  sobol_check_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      sv, ids, dims, u, n, k0, k1, bits, out);
  return (int)cudaGetLastError();
}

// out (2, n) float32: expneg_wide32(x[i]) and the Gamma(a) variate of
// (u_w[i], u_b[i]) from the residual table (z0, dz, resid, dresid) of
// n_table knots.
extern "C" int mc_gamma_check(float* out, const float* u_w, const float* u_b,
                              const float* x, int64_t n, float a, float z0,
                              float dz, const float* resid,
                              const float* dresid, int n_table,
                              void* stream) {
  if (n_table < 2) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  gamma_check_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      u_w, u_b, x, n, a, z0, dz, resid, dresid, n_table, out);
  return (int)cudaGetLastError();
}
