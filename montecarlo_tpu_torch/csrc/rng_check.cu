// K0 check entries: run the device functions of rng.cuh elementwise, so the
// on-card build of the cipher, the float32 math, the Sobol normal and the
// table-inverted gamma variate can be held against the plain PyTorch
// versions (rng/threefry.py, rng/normal.py, rng/sobol.py, rng/gamma.py),
// and ndtri32_unit against ndtri32 on every float32 of its range.
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

// ndtri32_unit's range: the float32 bit patterns of 2^-24 and 1 - 2^-24.
constexpr uint32_t kUnitLo = 0x33800000u;
constexpr uint32_t kUnitHi = 0x3F7FFFFFu;
constexpr uint32_t kUniforms = 1u << 23;  // uniform_from_bits' values

// counts[0] += the float32 u in [2^-24, 1 - 2^-24] where ndtri32_unit(u)
// and ndtri32(u) differ in a bit; counts[1] = min(counts[1], the lowest
// such u's bit pattern).  A grid-stride walk over every bit pattern.
__global__ void ndtri_unit_range_kernel(unsigned long long* counts) {
  unsigned long long bad = 0;
  unsigned long long first = ~0ull;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t b = kUnitLo + blockIdx.x * blockDim.x + threadIdx.x;
       b <= kUnitHi; b += stride) {
    const float u = __uint_as_float(b);
    if (__float_as_uint(mc::ndtri32_unit(u)) !=
        __float_as_uint(mc::ndtri32(u))) {
      ++bad;
      first = min(first, (unsigned long long)b);
    }
  }
  if (bad) {
    atomicAdd(counts, bad);
    atomicMin(counts + 1, first);
  }
}

// out[k] = ndtri32_unit((k + 1/2) 2^-23), k < 2^23.
__global__ void ndtri_unit_uniforms_kernel(float* __restrict__ out) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < kUniforms) out[k] = mc::ndtri32_unit(mc::uniform_from_bits(k << 9));
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

// counts (2,) int64, zeroed and set to INT64_MAX by the caller: the
// mismatches of ndtri32_unit against ndtri32 over every float32 in [2^-24,
// 1 - 2^-24] and the lowest mismatching bit pattern; uniforms (2^23,)
// float32: ndtri32_unit of every uniform_from_bits value, in word order.
extern "C" int mc_ndtri_unit_check(int64_t* counts, float* uniforms,
                                   void* stream) {
  const int threads = 256;
  const cudaStream_t st = (cudaStream_t)stream;
  ndtri_unit_range_kernel<<<132 * 16, threads, 0, st>>>(
      reinterpret_cast<unsigned long long*>(counts));
  ndtri_unit_uniforms_kernel<<<kUniforms / threads, threads, 0, st>>>(
      uniforms);
  return (int)cudaGetLastError();
}
