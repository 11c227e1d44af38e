// K0 — the device math traced into every kernel of the JAX package:
// Threefry-2x32-20, uniform_from_bits, Box-Muller, exp32 and log32.
//
// Replaces montecarlo_tpu/rng/threefry.py::threefry2x32 and
// montecarlo_tpu/rng/normal.py::{uniform_from_bits, boxmuller_pair, exp32,
// log32}, which Pallas inlines into each TPU kernel.  Written once, as
// __host__ __device__ inline functions, so the same text builds for sm_90a
// (nvcc) and for the host (g++), where the tests hold it against JAX.
//
// Bounds on the H100: the cipher is integer ALU work (20 rounds of add,
// rotate, xor per 64 random bits); Box-Muller's log, sqrt, sin and cos go
// to the SFU and their range reductions.  Nothing here touches memory.
// Design: one call per counter, all in registers; rotations are compile-time
// constants after unrolling (one funnel shift each).
//
// Numerics: build without --use_fast_math (its __logf/__expf are the biased
// approximations exp32/log32 exist to avoid) and with -fmad=false, so every
// a*b+c rounds twice as in the torch plain versions and the JAX package.
// Constants are the JAX package's, rounded to float32 by the compiler.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define MC_HD __host__ __device__ __forceinline__
#else
#define MC_HD inline
#endif

namespace mc {

MC_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (Salmon et al., SC'11).  key = (k0, k1),
// counter = (c0, c1) = (global path id, draw index).
MC_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                        uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[j % 2][i]);
      x1 ^= x0;
    }
    x0 += ks[(j + 1) % 3];
    x1 += ks[(j + 2) % 3] + (uint32_t)(j + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

// Open-interval uniform from the top 23 bits: ((b >> 9) + 0.5) * 2^-23, exact.
MC_HD float uniform_from_bits(uint32_t b) {
  return ((float)(int32_t)(b >> 9) + 0.5f) * 1.1920928955078125e-7f;
}

MC_HD void boxmuller_pair(uint32_t b0, uint32_t b1, float* z0, float* z1) {
  const float u1 = uniform_from_bits(b0);
  const float u2 = uniform_from_bits(b1);
  const float r = sqrtf(-2.0f * logf(u1));
  const float theta = 6.283185307179586f * u2;
  *z0 = r * cosf(theta);
  *z1 = r * sinf(theta);
}

// Accurate float32 exp: Cody-Waite reduction + the Cephes expf polynomial,
// IEEE-exact mul/add only; 2^n from two integer shifts.  |x| <= 20.
MC_HD float exp32(float x) {
  x = fminf(fmaxf(x, -20.0f), 20.0f);
  const float nf = floorf(x * 1.4426950408889634f + 0.5f);
  float r = x - nf * 0.693359375f;
  r = r - nf * -2.12194440054690583e-4f;
  float p = 1.9875691500e-4f;
  p = p * r + 1.3981999507e-3f;
  p = p * r + 8.3334519073e-3f;
  p = p * r + 4.1665795894e-2f;
  p = p * r + 1.6666665459e-1f;
  p = p * r + 5.0000001201e-1f;
  const float er = p * r * r + r + 1.0f;
  const int n = (int)nf;
  const int n1 = n >> 1;  // arithmetic shift: floor(n/2)
  const int n2 = n - n1;
  const float s1 = (float)(1 << (n1 + 15));
  const float s2 = (float)(1 << (n2 + 15));
  return er * s1 * (s2 * 9.313225746154785e-10f);  // 2^-30
}

// Accurate float32 log: one Newton step from the platform log's seed.
MC_HD float log32(float x) {
  x = fminf(fmaxf(x, 2.5e-9f), 5e8f);
  const float y = logf(x);
  return y + (x * exp32(-y) - 1.0f);
}

}  // namespace mc
