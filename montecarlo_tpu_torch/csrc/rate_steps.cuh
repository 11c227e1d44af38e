// The steps of Euler GBM, term-structure GBM and the short rates Vasicek,
// CIR, Hull-White and G2++, as K2-K4's functors run them
// (csrc/fused_rates.cu: RateProc<Step, D>, a draw source around a step of
// this header).
//
// Replaces montecarlo_tpu/processes/euler_gbm.py::EulerGBM.step,
// term_gbm.py::TermStructureGBM.step, shortrate.py::{Vasicek, CIR,
// HullWhite}.step and g2pp.py::G2PP.step, which the JAX kernels trace into
// K2-K4; the torch plain versions are the port's processes of the same
// names.  __host__ __device__ like rng.cuh, so the tests build the same
// text with g++ and walk it against them.
//
// Each step's constructor takes the process's float32 leaves in field
// order (ops/fused_engine.py::_leaves) and `dims`, the curve length of
// term-structure GBM and Hull-White, and computes the per-launch constants
// once, with the float32 operations of the JAX step in its order (Python's
// -k * dt is (-k) dt, -2.0 * k * dt is ((-2) k) dt).  step(state, eps, t)
// takes the draws of step t; the curves are read at t (__ldg on the card),
// which the launch has checked against the curve length
// (fused_rates.cu::steps_fit).
//
// Bounds on the H100: a Box-Muller pair per cipher call (one call a step
// pair, two for G2++), then 3 (Euler), 8 (term), 5 (Vasicek), 7 and a sqrtf
// (CIR), 5 and an IEEE division (Hull-White) and 9 (G2++) float32
// operations a step; the term-structure and Hull-White curves are two and
// one 4-byte reads a step through the read-only cache, the same address
// for every thread.  Numerics: -fmad=false, IEEE division and sqrtf, as
// every unit (ops/_build.py); the host build uses -ffp-contract=off.
#pragma once

#include "rng.cuh"

#ifndef MC_LDG
#if defined(__CUDA_ARCH__)
#define MC_LDG(p) __ldg(p)
#else
#define MC_LDG(p) (*(p))
#endif
#endif

namespace mc {

struct ScalarState {
  float r;  // the rate, the price (Euler GBM) or the log price (term GBM)
};

struct FactorState {
  float x, y;
};

// (decay, scale) of the exact OU step over dt at mean reversion k:
// exp32((-k) dt) and sigma sqrtf((1 - exp32(((-2) k) dt)) / (2 k)).
MC_HD void ou_decay_scale(float k, float sigma, float dt, float* decay,
                          float* scale) {
  *decay = exp32(-k * dt);
  *scale = sigma * sqrtf((1.0f - exp32((-2.0f * k) * dt)) / (2.0f * k));
}

// processes/euler_gbm.py: leaves = [s0, mu, sigma, dt];
// s' = s ((1 + mu dt) + (sigma sqrt(dt)) z).
struct EulerGbmStep {
  using State = ScalarState;
  static constexpr bool kLogPrices = false;
  float s0, one_drift, scale;
  MC_HD EulerGbmStep(const float* leaves, int) {
    const float mu = leaves[1], sigma = leaves[2], dt = leaves[3];
    s0 = leaves[0];
    one_drift = 1.0f + mu * dt;
    scale = sigma * sqrtf(dt);
  }
  MC_HD State init() const { return State{s0}; }
  MC_HD State step(State s, const float* eps, int) const {
    return State{s.r * (one_drift + scale * eps[0])};
  }
  MC_HD float prices(State s) const { return s.r; }
};

// processes/term_gbm.py: leaves = [s0, mu_t (n), sigma_t (n), dt], n =
// dims; log_s' = log_s + ((mu_t - 0.5 sigma_t^2) dt + (sigma_t sqrt(dt)) z).
struct TermGbmStep {
  using State = ScalarState;
  static constexpr bool kLogPrices = true;
  const float* mu;
  const float* sigma;
  float log_s0, dt, sq_dt;
  MC_HD TermGbmStep(const float* leaves, int n)
      : mu(leaves + 1), sigma(leaves + 1 + n) {
    log_s0 = log32(leaves[0]);
    dt = leaves[1 + 2 * n];
    sq_dt = sqrtf(dt);
  }
  MC_HD State init() const { return State{log_s0}; }
  MC_HD State step(State s, const float* eps, int t) const {
    const float m = MC_LDG(mu + t), sg = MC_LDG(sigma + t);
    const float drift = (m - 0.5f * (sg * sg)) * dt;
    return State{s.r + (drift + (sg * sq_dt) * eps[0])};
  }
  MC_HD float prices(State s) const { return exp32(s.r); }
  MC_HD float log_prices(State s) const { return s.r; }
};

// processes/shortrate.py::Vasicek: leaves = [r0, kappa, theta, sigma, dt];
// r' = (theta + (r - theta) decay) + scale z.
struct VasicekStep {
  using State = ScalarState;
  static constexpr bool kLogPrices = false;
  float r0, theta, decay, scale;
  MC_HD VasicekStep(const float* leaves, int) {
    r0 = leaves[0];
    theta = leaves[2];
    ou_decay_scale(leaves[1], leaves[3], leaves[4], &decay, &scale);
  }
  MC_HD State init() const { return State{r0}; }
  MC_HD State step(State s, const float* eps, int) const {
    return State{(theta + (s.r - theta) * decay) + scale * eps[0]};
  }
  MC_HD float prices(State s) const { return s.r; }
};

// processes/shortrate.py::CIR: leaves = [r0, kappa, theta, sigma, dt];
// r+ = max(r, 0), r' = (r + (kappa dt)(theta - r+)) + ((sigma sqrt(dt))
// sqrtf(r+)) z.
struct CirStep {
  using State = ScalarState;
  static constexpr bool kLogPrices = false;
  float r0, theta, kdt, vol;
  MC_HD CirStep(const float* leaves, int) {
    const float kappa = leaves[1], sigma = leaves[3], dt = leaves[4];
    r0 = leaves[0];
    theta = leaves[2];
    kdt = kappa * dt;
    vol = sigma * sqrtf(dt);
  }
  MC_HD State init() const { return State{r0}; }
  MC_HD State step(State s, const float* eps, int) const {
    const float r_plus = fmaxf(s.r, 0.0f);
    return State{(s.r + kdt * (theta - r_plus)) +
                 (vol * sqrtf(r_plus)) * eps[0]};
  }
  MC_HD float prices(State s) const { return s.r; }
};

// processes/shortrate.py::HullWhite: leaves = [r0, a, sigma, theta_t (n),
// dt], n = dims; r' = (r decay + (theta_t / a)(1 - decay)) + scale z, the
// mean term computed every step as the JAX step computes it.
struct HullWhiteStep {
  using State = ScalarState;
  static constexpr bool kLogPrices = false;
  const float* theta;
  float r0, a, decay, one_decay, scale;
  MC_HD HullWhiteStep(const float* leaves, int n) : theta(leaves + 3) {
    r0 = leaves[0];
    a = leaves[1];
    ou_decay_scale(a, leaves[2], leaves[3 + n], &decay, &scale);
    one_decay = 1.0f - decay;
  }
  MC_HD State init() const { return State{r0}; }
  MC_HD State step(State s, const float* eps, int t) const {
    const float mean = (MC_LDG(theta + t) / a) * one_decay;
    return State{(s.r * decay + mean) + scale * eps[0]};
  }
  MC_HD float prices(State s) const { return s.r; }
};

// processes/g2pp.py: leaves = [phi, a, sigma, b, eta, rho, dt]; two normals
// a step, the second correlated by the exact step correlation r12 =
// clip(cov / max(sx sy, 1e-38), -1, 1), cov = (((rho sigma) eta)(1 -
// exp32((-(a + b)) dt))) / (a + b); x' = x dec_x + sx z1, y' = y dec_y + sy
// (r12 z1 + sqrtf(max(1 - r12^2, 0)) z2); prices (x + y) + phi.
struct G2ppStep {
  using State = FactorState;
  static constexpr bool kLogPrices = false;
  float phi, dec_x, dec_y, sx, sy, r12, r12_perp;
  MC_HD G2ppStep(const float* leaves, int) {
    const float a = leaves[1], sg = leaves[2], b = leaves[3];
    const float et = leaves[4], rho = leaves[5], dt = leaves[6];
    phi = leaves[0];
    ou_decay_scale(a, sg, dt, &dec_x, &sx);
    ou_decay_scale(b, et, dt, &dec_y, &sy);
    const float cov =
        (((rho * sg) * et) * (1.0f - exp32((-(a + b)) * dt))) / (a + b);
    r12 = fminf(fmaxf(cov / fmaxf(sx * sy, 1e-38f), -1.0f), 1.0f);
    r12_perp = sqrtf(fmaxf(1.0f - r12 * r12, 0.0f));
  }
  MC_HD State init() const { return State{0.0f, 0.0f}; }
  MC_HD State step(State s, const float* eps, int) const {
    const float z2 = r12 * eps[0] + r12_perp * eps[1];
    return State{s.x * dec_x + sx * eps[0], s.y * dec_y + sy * z2};
  }
  MC_HD float prices(State s) const { return (s.x + s.y) + phi; }
};

}  // namespace mc
