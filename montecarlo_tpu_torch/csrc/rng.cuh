// K0 — the device math traced into every kernel of the JAX package:
// Threefry-2x32-20, uniform_from_bits, Box-Muller, exp32, log32, the
// randomized Sobol normal (ndtri32, sobol_bits, the Owen hash), ndtri32's
// one-rational form on the functors' uniforms (ndtri32_unit) and the
// table-inverted gamma variate of variance gamma (expneg_wide32,
// gamma_from_uniforms_table32, and its form over an interleaved table).
//
// Replaces montecarlo_tpu/rng/threefry.py::threefry2x32,
// montecarlo_tpu/rng/normal.py::{uniform_from_bits, boxmuller_pair, exp32,
// log32, ndtri32}, montecarlo_tpu/rng/sobol.py::{sobol_bits, _reverse32,
// _scrambled_uniform, _shifted_normal} and montecarlo_tpu/rng/gamma.py::
// {expneg_wide32, gamma_from_uniforms_table32}, which Pallas inlines into
// each TPU kernel.  Written once, as
// __host__ __device__ inline functions, so the same text builds for sm_90a
// (nvcc) and for the host (g++), where the tests hold it against JAX.
//
// Bounds on the H100: the cipher is integer ALU work (20 rounds of add,
// rotate, xor per 64 random bits); Box-Muller's log, sqrt, sin and cos go
// to the SFU and their range reductions.  Nothing here touches memory.
// Design: one call per counter, all in registers, or U calls in lock step
// (threefry2x32_lanes) where a kernel needs independent work to hide the
// rounds' latency; rotations are compile-time constants after unrolling
// (one funnel shift each).
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

// Threefry-2x32, 20 rounds (Salmon et al., SC'11), on U counters in lock
// step: the U calls' instructions interleave, so a thread keeps U
// independent chains in flight; each gives the words one call gives.
// key = (k0, k1), counter u = (c0[u], c1[u]) = (global path id, draw index).
template <int U>
MC_HD void threefry2x32_lanes(uint32_t k0, uint32_t k1, const uint32_t* c0,
                              const uint32_t* c1, uint32_t* o0,
                              uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0[U], x1[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    x0[u] = c0[u] + k0;
    x1[u] = c1[u] + k1;
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x0[u] += x1[u];
        x1[u] = rotl32(x1[u], rot[j % 2][i]);
        x1[u] ^= x0[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x0[u] += ks[(j + 1) % 3];
      x1[u] += ks[(j + 2) % 3] + (uint32_t)(j + 1);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    o0[u] = x0[u];
    o1[u] = x1[u];
  }
}

// One Threefry-2x32-20 call at counter (c0, c1).
MC_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                        uint32_t* o0, uint32_t* o1) {
  threefry2x32_lanes<1>(k0, k1, &c0, &c1, o0, o1);
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

#ifdef __CUDACC__
// ---- Device only: Box-Muller from one sincosf ---------------------------------
//
// boxmuller_pair with the sine and cosine from one sincosf: one range
// reduction for both where sinf and cosf take one each (~16 SASS
// instructions a pair).  libdevice's sincosf gives sinf's and cosf's bits
// on every one of the 2^23 angles a word can give (mc_rbergomi_angle_check
// calls boxmuller_angle_sincos and is held against the plain version's
// torch.sin and torch.cos), so the pair is boxmuller_pair's, bit for bit.
// The host build keeps boxmuller_pair: glibc's sincosf is another libm.
// Called by K6 (rbergomi_kernel.cu), SabrProc and, through
// normal_pair_sincos, HestonQEProc, BatesQEProc and VgProc
// (processes.cuh).
__device__ __forceinline__ void boxmuller_angle_sincos(uint32_t b1, float* s,
                                                       float* c) {
  sincosf(6.283185307179586f * uniform_from_bits(b1), s, c);
}

__device__ __forceinline__ void boxmuller_sincos(uint32_t b0, uint32_t b1,
                                                 float* z0, float* z1) {
  const float r = sqrtf(-2.0f * logf(uniform_from_bits(b0)));
  float s, c;
  boxmuller_angle_sincos(b1, &s, &c);
  *z0 = r * c;
  *z1 = r * s;
}
#endif

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

// ---- Sobol points (rng/normal.py::ndtri32, rng/sobol.py) ---------------------

// Inverse standard-normal CDF, Wichura's AS241 PPND7, in the JAX package's
// operation order: the central rational and both tail rationals are all
// evaluated and the result selected, as jnp.where does.  u in (0, 1).
MC_HD float ndtri32(float u) {
  const float q = u - 0.5f;
  const float rc = 0.180625f - q * q;
  const float num_c = q * (((59.109374720f * rc + 159.29113202f) * rc +
                            50.434271938f) * rc + 3.3871327179f);
  const float den_c = ((67.187563600f * rc + 78.757757664f) * rc +
                       17.895169469f) * rc + 1.0f;
  const float central = num_c / den_c;
  const float p = fmaxf(fminf(fminf(u, 1.0f - u), 0.5f), 1e-30f);
  const float rt = sqrtf(-logf(p));
  const float r1 = rt - 1.6f;
  const float num_m = ((0.17023821103f * r1 + 1.3067284816f) * r1 +
                       2.7568153900f) * r1 + 1.4234372777f;
  const float den_m = (0.12021132975f * r1 + 0.73700164250f) * r1 + 1.0f;
  const float r2 = rt - 5.0f;
  const float num_f = ((0.017337203997f * r2 + 0.42868294337f) * r2 +
                       3.0812263860f) * r2 + 6.6579051150f;
  const float den_f = (0.012258202635f * r2 + 0.24197894225f) * r2 + 1.0f;
  const float mid = num_m / den_m;
  const float far = num_f / den_f;
  float tail = rt <= 5.0f ? mid : far;
  tail = q < 0.0f ? -tail : tail;
  return fabsf(q) <= 0.425f ? central : tail;
}

// ndtri32 for the functors' uniforms, bit for bit ndtri32's on every u in
// [2^-24, 1 - 2^-24], with one rational and one division where ndtri32
// evaluates three rationals and selects.  Called by QECore (qe_step.cuh),
// whose u is uniform_from_bits' (k + 1/2) 2^-23 >= 2^-24 or its exact
// mirror 1 - u <= 1 - 2^-24, and by VG's gamma-table inversion
// (gamma_knot), which clamps u to [6e-8, 1 - 2^-24].  There p = min(u, 1 - u) >= 2^-24 (1 - u
// is exact for u >= 1/2 and above 1/2 below it, so ndtri32's clamps of p
// to [1e-30, 1/2] change nothing), so rt = sqrt(-log p) <= sqrt(24 log 2)
// = 4.08 < 5: the far tail is never selected.  The central and middle
// rationals share one polynomial pair through selected coefficients:
// the middle denominator, of degree 2, is padded with a leading 0 (0 r +
// c = c exactly), the central numerator stays q P(rc), and the tail's
// sign goes on the numerator, since -(a / b) = (-a) / b in IEEE division.
// The Sobol sources and the bridge keep ndtri32.
MC_HD float ndtri32_unit(float u) {
  const float q = u - 0.5f;
  const bool central = fabsf(q) <= 0.425f;
  const float rc = 0.180625f - q * q;
  const float rt = sqrtf(-logf(fminf(u, 1.0f - u)));
  const float x = central ? rc : rt - 1.6f;
  const float num =
      (((central ? 59.109374720f : 0.17023821103f) * x +
        (central ? 159.29113202f : 1.3067284816f)) * x +
       (central ? 50.434271938f : 2.7568153900f)) * x +
      (central ? 3.3871327179f : 1.4234372777f);
  const float den =
      (((central ? 67.187563600f : 0.0f) * x +
        (central ? 78.757757664f : 0.12021132975f)) * x +
       (central ? 17.895169469f : 0.73700164250f)) * x + 1.0f;
  return ((central ? q : (q < 0.0f ? -1.0f : 1.0f)) * num) / den;
}

// Bits of a Sobol integer (rng/sobol.py::BITS).
constexpr int kSobolBits = 30;

// Bit reversal (rng/sobol.py::_reverse32); __brev on the card.
MC_HD uint32_t reverse32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __brev(x);
#else
  x = ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
  x = ((x >> 2) & 0x33333333u) | ((x & 0x33333333u) << 2);
  x = ((x >> 4) & 0x0F0F0F0Fu) | ((x & 0x0F0F0F0Fu) << 4);
  x = ((x >> 8) & 0x00FF00FFu) | ((x & 0x00FF00FFu) << 8);
  return (x >> 16) | (x << 16);
#endif
}

// The Sobol integer in [0, 2^30) of point `id` in the dimension whose 30
// direction numbers are row[0..29]: the XOR of row[k] over the set bits k
// of gray(id) below bit 30 (rng/sobol.py::sobol_bits).  XOR is order-free,
// so visiting only the set bits gives the same integer.
MC_HD uint32_t sobol_bits(const uint32_t* row, uint32_t id) {
  uint32_t g = (id ^ (id >> 1)) & ((1u << kSobolBits) - 1u);
  uint32_t x = 0;
  while (g) {
#ifdef __CUDA_ARCH__
    const int k = __ffs(g) - 1;
#else
    const int k = __builtin_ctz(g);
#endif
    x ^= row[k];
    g &= g - 1u;
  }
  return x;
}

// Owen-scrambled uniform of a Sobol integer (rng/sobol.py::
// _scrambled_uniform): the Laine-Karras hash keyed by `key` in the
// bit-reversed domain, then the top 23 bits with a half-ulp centre.
MC_HD float scrambled_uniform(uint32_t x, uint32_t key) {
  uint32_t y = reverse32(x << (32 - kSobolBits));
  y = y + key;
  y = y ^ (y * 0x6C50B47Cu);
  y = y ^ (y * 0xB82F1E52u);
  y = y ^ (y * 0xC7AFE638u);
  y = y ^ (y * 0x8D22F6E6u);
  return uniform_from_bits(reverse32(y));
}

// rng/sobol.py::_shifted_normal.
MC_HD float shifted_normal(uint32_t x, uint32_t key) {
  return ndtri32(scrambled_uniform(x, key));
}

// The Owen-hash key of Sobol dimension `dim`: word 0 of Threefry keyed by
// the run's (k0, k1) at counter (dim, 0x50B0), rng/sobol.py's convention.
MC_HD uint32_t sobol_key(uint32_t k0, uint32_t k1, uint32_t dim) {
  uint32_t s0, s1;
  threefry2x32(k0, k1, dim, 0x50B0u, &s0, &s1);
  return s0;
}

// The randomized Sobol normal of point `id` in dimension `dim` of the
// (n_dims, 30) table `sv`.
MC_HD float sobol_normal(const uint32_t* sv, uint32_t k0, uint32_t k1,
                         uint32_t id, uint32_t dim) {
  return shifted_normal(sobol_bits(sv + (size_t)dim * kSobolBits, id),
                        sobol_key(k0, k1, dim));
}

// ---- Gamma variates by table inversion (rng/gamma.py) -----------------------

// exp(x) for x in [-88, 0] as exp32(x / 8)^8; inputs clamp to that range.
MC_HD float expneg_wide32(float x) {
  x = fminf(fmaxf(x, -88.0f), 0.0f);
  const float e = exp32(x * 0.125f);
  const float e2 = e * e;
  const float e4 = e2 * e2;
  return e4 * e4;
}

// The first half of the table inversion below: u_w clamped to [6e-8, 1 -
// 2^-24] (*u), the knot interval i of z = ndtri32(u) (ndtri32_unit's bits
// on these u) in the table (z0, dz) of n knots, and the fraction into it.
MC_HD int gamma_knot(float u_w, float z0, float dz, int n, float* u,
                     float* frac) {
  *u = fminf(fmaxf(u_w, 6e-8f), (float)(1.0 - 6e-8));
  const float z = ndtri32_unit(*u);
  const float t = (z - z0) / dz;
  int i = (int)floorf(t);
  i = i < 0 ? 0 : (i > n - 2 ? n - 2 : i);
  *frac = fminf(fmaxf(t - (float)i, 0.0f), 1.0f);
  return i;
}

// The second half: the cubic Hermite residual at frac between the knots'
// values g0, g1 and slopes (times dz) m0, m1, plus log(u) / (1 + a), times
// u_boost^(1/a).
MC_HD float gamma_at_knots(float a, float u, float u_boost, float frac,
                           float g0, float g1, float m0, float m1) {
  const float f2 = frac * frac;
  const float f3 = f2 * frac;
  const float h = ((g0 * ((2.0f * f3 - 3.0f * f2) + 1.0f) +
                    m0 * ((f3 - 2.0f * f2) + frac)) +
                   g1 * (-2.0f * f3 + 3.0f * f2)) +
                  m1 * (f3 - f2);
  const float b = 1.0f + a;
  const float log_w = fminf(fmaxf(h + log32(u) / b, -20.0f), 20.0f);
  return exp32(log_w) * expneg_wide32(log32(u_boost) / a);
}

// One Gamma(a, 1) variate, a in (0, 1], from two uniforms (rng/gamma.py::
// gamma_from_uniforms_table32): the shape-(1 + a) quantile of u_w from the
// residual table (z0, dz, resid[n], dresid[n]) by cubic Hermite at z =
// ndtri32(u_w), plus log(u_w) / (1 + a), times u_boost^(1/a).  The table
// is read by plain indexing.
MC_HD float gamma_from_uniforms_table32(float a, float u_w, float u_boost,
                                        float z0, float dz,
                                        const float* resid,
                                        const float* dresid, int n) {
  float u, frac;
  const int i = gamma_knot(u_w, z0, dz, n, &u, &frac);
  return gamma_at_knots(a, u, u_boost, frac, resid[i], resid[i + 1],
                        dresid[i] * dz, dresid[i + 1] * dz);
}

// gamma_from_uniforms_table32 over the table interleaved by interval:
// quad[4 i .. 4 i + 3] = (resid[i], resid[i + 1], dresid[i], dresid[i +
// 1]) for i < n - 1, the same floats, so the same bits.  On the card quad
// lies on 16 bytes and an interval is one 16-byte load through the
// read-only cache, where the two tables take four (VgProc).
MC_HD float gamma_from_uniforms_quad32(float a, float u_w, float u_boost,
                                       float z0, float dz, const float* quad,
                                       int n) {
  float u, frac;
  const int i = gamma_knot(u_w, z0, dz, n, &u, &frac);
#ifdef __CUDA_ARCH__
  const float4 k = __ldg(reinterpret_cast<const float4*>(quad) + i);
#else
  const struct {
    float x, y, z, w;
  } k = {quad[4 * i], quad[4 * i + 1], quad[4 * i + 2], quad[4 * i + 3]};
#endif
  return gamma_at_knots(a, u, u_boost, frac, k.x, k.y, k.z * dz, k.w * dz);
}

}  // namespace mc
