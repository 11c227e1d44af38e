// The knot-grid reads of the local-vol surfaces (LocalVolProc, SlvProc,
// SlvKnotsProc in fused_engine.cu): a row of 128 log-moneyness knots read
// at a path's log-moneyness, and the hat-weight blend of time-knot rows.
//
// Replaces montecarlo_tpu/processes/local_vol.py::{interp_row_1d,
// LocalVolGBM._row, LocalVolGBM.local_vol} and processes/slv.py::{SLV.
// leverage, SLVKnots._row, SLVKnots.leverage}, which the JAX kernels trace
// into K2-K4; the torch plain versions are processes/local_vol.py::
// {knot_index, interp_row, blend_rows}.  __host__ __device__ like rng.cuh,
// so the tests build the same text with g++ and hold it against them.
//
// Bounds on the H100: an IEEE division per read, and two (an exact row) or
// four (a blend of two knots) loads from a table every thread of a step
// reads alike, so the read-only cache serves them.  Design: JAX's one-hot
// contractions and lane gathers work around XLA's and Mosaic's gathers;
// here a read is a pointer and an offset (__ldg on the card).  The time
// blend sums only the two bracketing knots: every other hat weight is 0,
// and adding 0 w T = +0 to the positive partial sum changes no bit, so the
// result is the plain version's full sum from 0 in knot order.
#pragma once

#include "rng.cuh"

#if defined(__CUDA_ARCH__)
#define MC_LDG(p) __ldg(p)
#else
#define MC_LDG(p) (*(p))
#endif

namespace mc {

constexpr int kKnots = 128;  // processes/local_vol.py::KNOTS

// Knot i = clip(floor(u), 0, 126), clamped in float before the cast (NaN
// goes to 0: fmaxf returns the number), and *frac = clip(u - i, 0, 1) from
// the unclamped u.
MC_HD int knot_index(float u, float* frac) {
  const float fi = fminf(fmaxf(floorf(u), 0.0f), (float)(kKnots - 2));
  *frac = fminf(fmaxf(u - fi, 0.0f), 1.0f);
  return (int)fi;
}

// A 128-knot row at log-moneyness x: row[i] (1 - frac) + row[i + 1] frac,
// flat outside the grid.
MC_HD float interp_row(const float* row, float x, float x0, float dx) {
  float frac;
  const int i = knot_index((x - x0) / dx, &frac);
  return MC_LDG(row + i) * (1.0f - frac) + MC_LDG(row + i + 1) * frac;
}

// The time-knot coordinate of step t: clip(t dt / dt_knot, 0, n_tk - 1).
MC_HD float knot_time(int t, float dt, float dt_knot, int n_tk) {
  const float u = ((float)t * dt) / dt_knot;
  return fminf(fmaxf(u, 0.0f), (float)(n_tk - 1));
}

// Lane k of the blended row at knot coordinate u of an (n_tk, 128) table
// (n_tk >= 2): sum_j max(1 - |u - j|, 0) table[j][k] from 0 over the two
// bracketing knots j0 = min(floor(u), n_tk - 2) and j0 + 1.
MC_HD float blend_lane(const float* table, int n_tk, float u, int k) {
  int j0 = (int)floorf(u);
  j0 = j0 < n_tk - 2 ? j0 : n_tk - 2;
  const float w0 = fmaxf(1.0f - fabsf(u - (float)j0), 0.0f);
  const float w1 = fmaxf(1.0f - fabsf(u - (float)(j0 + 1)), 0.0f);
  float row = 0.0f;
  row = row + w0 * MC_LDG(table + j0 * kKnots + k);
  row = row + w1 * MC_LDG(table + (j0 + 1) * kKnots + k);
  return row;
}

// The blended row at knot coordinate u, read at log-moneyness x.
MC_HD float interp_blend(const float* table, int n_tk, float u, float x,
                         float x0, float dx) {
  float frac;
  const int i = knot_index((x - x0) / dx, &frac);
  return blend_lane(table, n_tk, u, i) * (1.0f - frac) +
         blend_lane(table, n_tk, u, i + 1) * frac;
}

}  // namespace mc
