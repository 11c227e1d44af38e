// The correlated basket's time loop in K2-K4 (BasketFixed<A> in
// csrc/fused_basket.cu): its constants in shared memory, the step pair with
// the draws streamed in the Cholesky factor's column order, and the basket
// value.
//
// Written as __host__ __device__ functions so that the same text runs in
// the kernels (nvcc, sm_90a) and in the host shim of
// tests/test_torch_basket_step.py (g++ -ffp-contract=off), which walks K2's
// and K4's per-path loop on normals handed in from torch and holds it
// bitwise against ops/fused_engine.py's plain versions.
//
// The asset count A is a compile-time constant (1..kMaxAssets): every
// array index below is static after unrolling, so a path's A log prices
// and the correlated sums stay in registers and the constants' offsets are
// immediates.  The arithmetic is processes/basket.py::BasketGBM.step's,
// term for term: zc_a = L[a,0] z_0 + L[a,1] z_1 + ... + L[a,a] z_a, left to
// right, the first term a product; then log_s_a + (drift_a + scale_a zc_a).
// Only the order in which the terms are formed differs: the draws of a step
// pair come from A Threefry calls at counters (id, j A + c), call c giving
// the normals flat[2c] and flat[2c+1], eps0 = flat[0:A] (step 2j) and eps1 =
// flat[A:2A] (step 2j+1).  Each normal z_b is used as it arrives: it adds
// L[a,b] z_b to zc_a for every a >= b (so each zc_a still takes its terms b
// = 0..a in order), and asset b, whose sum is then whole, takes its
// increment at once.  Step 2j is done, and observed in K4, before the calls
// that feed only step 2j+1 are made; an odd A's middle call holds its
// second normal over to step 2j+1.  Live per path: A log prices, at most A
// partial sums and the normals of the calls in flight, where the whole
// pair's 2A draws were live before.  Past 8 assets (staged_for) the pair's
// calls run first in a rolled loop into a scratch column, then the normals
// are fed in the same order (pair_staged).  Every multiply and add rounds
// on its own (nvcc -fmad=false, g++ -ffp-contract=off).
#pragma once

#include <stdint.h>

#include "rng.cuh"

namespace bstep {

constexpr int kMaxAssets = 16;  // the largest A with its own instantiation

MC_HD constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

// Threefry calls made in lock step (mc::threefry2x32_lanes) for A assets.
// Chosen by timing on an H100 (PERF.md); it changes no result.
MC_HD constexpr int lanes_for(int n_assets) { return n_assets >= 4 ? 2 : 1; }

// The constants in shared memory, in floats: column block b (b = 0..A-1)
// holds drift_b, scale_b, then L[b..A-1, b], padded to a multiple of 4 so
// that every block starts 16-byte aligned (one LDS.128 brings four); then
// the weights and log32(s0), A each, padded likewise.
template <int A>
MC_HD constexpr int col_offset(int b) {
  int o = 0;
  for (int c = 0; c < b; ++c) o += pad4(A - c + 2);
  return o;
}

template <int A>
struct Layout {
  static constexpr int kWeights = col_offset<A>(A);
  static constexpr int kLogS0 = kWeights + pad4(A);
  static constexpr int kFloats = kLogS0 + pad4(A);
};

// Stage the constants from the leaves [s0 (A), mu (A), sigma (A),
// chol_flat (A*A, row-major), weights (A), dt], by threads tid = 0..n-1;
// drift and scale as processes/basket.py::drift_scale computes them.
template <int A>
MC_HD void stage(float* s, const float* leaves, int tid, int n) {
  const float* mu = leaves + A;
  const float* sigma = leaves + 2 * A;
  const float* chol = leaves + 3 * A;
  const float* w = chol + A * A;
  const float dt = w[A];
  for (int b = tid; b < A; b += n) {
    float* c = s + col_offset<A>(b);
    c[0] = (mu[b] - 0.5f * (sigma[b] * sigma[b])) * dt;
    c[1] = sigma[b] * sqrtf(dt);
    for (int a = b; a < A; ++a) c[2 + a - b] = chol[a * A + b];
    for (int k = A - b + 2; k < pad4(A - b + 2); ++k) c[k] = 0.0f;
    s[Layout<A>::kWeights + b] = w[b];
    s[Layout<A>::kLogS0 + b] = mc::log32(leaves[b]);
  }
}

template <int A>
MC_HD void init(const float* s, float* log_s) {
#pragma unroll
  for (int a = 0; a < A; ++a) log_s[a] = s[Layout<A>::kLogS0 + a];
}

// Normal z_b of a step arrives: zc_a gets its term L[a,b] z_b for every a
// >= b (the first term, b = 0, a product and not an add to zero), and asset
// b, whose sum is now whole, takes the grouped increment.
template <int A>
MC_HD void column(const float* s, int b, float z, float* zc, float* log_s) {
  const float* c = s + col_offset<A>(b);
  if (b == 0) {
#pragma unroll
    for (int a = 0; a < A; ++a) zc[a] = c[2 + a] * z;
  } else {
#pragma unroll
    for (int a = b; a < A; ++a) zc[a] = zc[a] + c[2 + a - b] * z;
  }
  log_s[b] = log_s[b] + (c[0] + c[1] * zc[b]);
}

// One whole step on the normals eps[0..A-1] (the bridge's single draw).
template <int A>
MC_HD void step(const float* s, const float* eps, float* log_s) {
  float zc[A];
#pragma unroll
  for (int b = 0; b < A; ++b) column<A>(s, b, eps[b], zc, log_s);
}

// The basket value sum_a w_a exp32(log S_a), the assets in order.
template <int A>
MC_HD float value(const float* s, const float* log_s) {
  const float* w = s + Layout<A>::kWeights;
  float out = w[0] * mc::exp32(log_s[0]);
#pragma unroll
  for (int a = 1; a < A; ++a) out = out + w[a] * mc::exp32(log_s[a]);
  return out;
}

// Normal f = 0..2A-1 of a step pair (step t's column f for f < A, step
// t+1's column f - A after), negated on a mirrored path; after(t) once a
// step is whole.  Step t+1's normals are dropped when it is not taken.
template <int A, class After>
MC_HD void feed(const float* s, int f, float z, bool mirror, bool second,
                int t, float* zc, float* log_s, After& after) {
  z = mirror ? -z : z;
  if (f < A) {
    column<A>(s, f, z, zc, log_s);
    if (f == A - 1) after(t);
  } else if (second) {
    column<A>(s, f - A, z, zc, log_s);
    if (f == 2 * A - 1) after(t + 1);
  }
}

// Steps t = 2j and 2j+1 (the second only when `second`): the A calls of
// pair j in counter order, U at a time, each call's two normals fed as they
// come.  src.calls<U>(j, c, z) gives calls c..c+U-1's normals, z[2u] and
// z[2u+1] for call c+u.  Calls that feed only step 2j+1 are not made when
// it is not taken.
template <int A, int U, class Src, class After>
MC_HD void pair(const float* s, float* log_s, const Src& src, uint32_t j,
                bool mirror, bool second, int t, After& after) {
  constexpr int kFirst = (A + 1) / 2;  // the calls that feed step t
  constexpr int kBatched = A / U * U;
  float zc[A];
#pragma unroll
  for (int c = 0; c < kBatched; c += U) {
    if (second || c < kFirst) {
      float z[2 * U];
      src.template calls<U>(j, c, z);
#pragma unroll
      for (int f = 0; f < 2 * U; ++f) {
        feed<A>(s, 2 * c + f, z[f], mirror, second, t, zc, log_s, after);
      }
    }
  }
#pragma unroll
  for (int c = kBatched; c < A; ++c) {
    if (second || c < kFirst) {
      float z[2];
      src.template calls<1>(j, c, z);
      feed<A>(s, 2 * c, z[0], mirror, second, t, zc, log_s, after);
      feed<A>(s, 2 * c + 1, z[1], mirror, second, t, zc, log_s, after);
    }
  }
}

// Whether A assets' step pairs stage the pair's normals (pair_staged)
// rather than feed each call's normals as they come (pair).  Chosen by
// timing on an H100 (PERF.md); it changes no result.
MC_HD constexpr bool staged_for(int n_assets) { return n_assets > 8; }

// pair's arithmetic in the same order, with the pair's normals made first
// by a rolled loop of calls (U at a time) into z[f * stride], f = 0..2A-1,
// then fed in order: the unrolled code is the correlation's alone, and the
// cipher's registers are free while it runs.  z is the path's column of a
// shared-memory scratch on the card.
template <int A, int U, class Src, class After>
MC_HD void pair_staged(const float* s, float* log_s, const Src& src,
                       uint32_t j, bool mirror, bool second, int t,
                       After& after, float* z, int stride) {
  const int n_calls = second ? A : (A + 1) / 2;
  int c = 0;
#pragma unroll 1
  for (; c + U <= n_calls; c += U) {
    float w[2 * U];
    src.template calls<U>(j, c, w);
#pragma unroll
    for (int f = 0; f < 2 * U; ++f) z[(2 * c + f) * stride] = w[f];
  }
#pragma unroll 1
  for (; c < n_calls; ++c) {
    float w[2];
    src.template calls<1>(j, c, w);
    z[2 * c * stride] = w[0];
    z[(2 * c + 1) * stride] = w[1];
  }
  float zc[A];
#pragma unroll
  for (int f = 0; f < 2 * A; ++f) {
    if (f < A || second) {
      feed<A>(s, f, z[f * stride], mirror, second, t, zc, log_s, after);
    }
  }
}

// K2-K4's loop over the step pairs of one path; the odd final step is
// never taken.  With a scratch z (stride apart), the pairs are staged.
template <int A, int U, class Src, class After>
MC_HD void run_pairs(const float* s, float* log_s, const Src& src,
                     bool mirror, int n_steps, After& after,
                     float* z = nullptr, int stride = 0) {
  const int n_pairs = (n_steps + 1) / 2;
  for (int j = 0; j < n_pairs; ++j) {
    const bool second = 2 * j + 1 < n_steps;
    if (z != nullptr) {
      pair_staged<A, U>(s, log_s, src, (uint32_t)j, mirror, second, 2 * j,
                        after, z, stride);
    } else {
      pair<A, U>(s, log_s, src, (uint32_t)j, mirror, second, 2 * j, after);
    }
  }
}

// One step at a time on normal(t, d), d = 0..A-1 in order (the Sobol
// draws of dimension t A + d).
template <int A, class Normal, class After>
MC_HD void run_steps(const float* s, float* log_s, int n_steps,
                     const Normal& normal, After& after) {
  for (int t = 0; t < n_steps; ++t) {
    float zc[A];
#pragma unroll
    for (int d = 0; d < A; ++d) column<A>(s, d, normal(t, d), zc, log_s);
    after(t);
  }
}

// The Threefry normals of K2-K4: call c of pair j at counter (id, j A + c),
// U calls in lock step, each through Box-Muller.
template <int A>
struct ThreefryNormals {
  uint32_t k0, k1, id;
  template <int U>
  MC_HD void calls(uint32_t j, int c, float* z) const {
    uint32_t c0[U], c1[U], b0[U], b1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c0[u] = id;
      c1[u] = j * (uint32_t)A + (uint32_t)(c + u);
    }
    mc::threefry2x32_lanes<U>(k0, k1, c0, c1, b0, b1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mc::boxmuller_pair(b0[u], b1[u], &z[2 * u], &z[2 * u + 1]);
    }
  }
};

}  // namespace bstep
