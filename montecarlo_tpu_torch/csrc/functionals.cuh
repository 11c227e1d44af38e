// K4's path functionals: the codes, the host-folded parameters and the
// fold (init, update after every step, finalize) of engine/functionals.py's
// device forms, and the observation each functional takes.
//
// Written as __host__ __device__ functions so that the same text runs in
// K4 (csrc/fused_engine.cuh, nvcc) and in the host shim of
// tests/test_torch_basket_step.py (g++), which walks K4's per-path loop on
// the basket bitwise against ops/fused_engine.py::
// fused_functionals_reference.
#pragma once

#include <stdint.h>

#include "rng.cuh"

namespace mcf {

// engine/functionals.py::*_CODE.
enum FunctionalCode {
  kArithMean = 0,
  kGeoMean = 1,
  kRunningMax = 2,
  kRunningMin = 3,
  kBarrierUp = 4,    // params: log_b, inv
  kCliquet = 5,      // period; params: floor, cap
  kAutocall = 6,     // period; params: -r_dt, trigger, coupon, pdi, s0,
                     //         -r_dt * n_steps
  kRealizedVar = 7,
  kTrapezoid = 8,    // params: half_dt
};

constexpr int kMaxFunctionals = 4;
constexpr int kMaxParams = 6;

struct FunctionalSpec {
  int64_t out_stride;  // row stride of out (the whole run's path count)
  int n;
  int code[kMaxFunctionals];
  int period[kMaxFunctionals];
  float p[kMaxFunctionals][kMaxParams];
};

MC_HD bool log_space(int code) {
  return code == kGeoMean || code == kRunningMax || code == kRunningMin ||
         code == kBarrierUp || code == kRealizedVar;
}

// Which observations the spec's functionals take: the price, its log.
struct Needs {
  bool price, log;
};

MC_HD Needs needs(const FunctionalSpec& spec) {
  Needs n{false, false};
#pragma unroll
  for (int k = 0; k < kMaxFunctionals; ++k) {
    if (k < spec.n) {
      if (log_space(spec.code[k])) {
        n.log = true;
      } else {
        n.price = true;
      }
    }
  }
  return n;
}

// The observation of each functional slot: the price or the log price.
MC_HD void observations(const FunctionalSpec& spec, float price, float logp,
                        float* obs) {
#pragma unroll
  for (int k = 0; k < kMaxFunctionals; ++k) {
    obs[k] = log_space(spec.code[k]) ? logp : price;
  }
}

// init(obs0) of engine/functionals.py.
MC_HD void fn_init(int code, const float* p, float obs, float* acc) {
  switch (code) {
    case kBarrierUp:
      acc[0] = obs < p[0] ? 1.0f : 0.0f;
      acc[1] = obs;
      break;
    case kCliquet:
    case kRealizedVar:
    case kTrapezoid:
      acc[0] = 0.0f;
      acc[1] = obs;
      break;
    case kAutocall:
      acc[0] = 1.0f;
      acc[1] = 0.0f;
      acc[2] = obs;
      acc[3] = obs;
      break;
    default:  // means, running max / min
      acc[0] = obs;
  }
}

// update(acc, obs, t) with t the 1-based step index.
MC_HD void fn_update(int code, int period, const float* p, float obs, int t,
                     float* acc) {
  switch (code) {
    case kArithMean:
    case kGeoMean:
      acc[0] = acc[0] + obs;
      break;
    case kRunningMax:
      acc[0] = fmaxf(acc[0], obs);
      break;
    case kRunningMin:
      acc[0] = fminf(acc[0], obs);
      break;
    case kBarrierUp: {
      const float a = p[0] - acc[1];
      const float b = p[0] - obs;
      const float p_cross = mc::exp32(((-2.0f * a) * b) * p[1]);
      const bool alive = (a > 0.0f) && (b > 0.0f);
      acc[0] = acc[0] * (alive ? 1.0f - p_cross : 0.0f);
      acc[1] = obs;
      break;
    }
    case kCliquet:
      if (t % period == 0) {
        const float ret = fminf(fmaxf(obs / acc[1] - 1.0f, p[0]), p[1]);
        acc[0] = acc[0] + ret;
        acc[1] = obs;
      }
      break;
    case kAutocall: {
      acc[2] = fminf(acc[2], obs);
      if (t % period == 0 && acc[0] > 0.5f && obs >= p[1]) {
        const float tf = (float)t;
        const float j = tf / (float)period;
        acc[1] = (1.0f + p[2] * j) * mc::exp32(p[0] * tf);
        acc[0] = 0.0f;
      }
      acc[3] = obs;
      break;
    }
    case kRealizedVar: {
      const float d = obs - acc[1];
      acc[0] = acc[0] + d * d;
      acc[1] = obs;
      break;
    }
    case kTrapezoid:
      acc[0] = acc[0] + (acc[1] + obs) * p[0];
      acc[1] = obs;
      break;
  }
}

// finalize(acc, float(n_steps)).
MC_HD float fn_finalize(int code, const float* p, const float* acc,
                        int n_steps) {
  const float n_obs = (float)(n_steps + 1);  // n_steps + 1.0, exact
  switch (code) {
    case kArithMean:
      return acc[0] / n_obs;
    case kGeoMean:
      return mc::exp32(acc[0] / n_obs);
    case kRunningMax:
    case kRunningMin:
      return mc::exp32(acc[0]);
    case kAutocall: {
      if (acc[0] <= 0.5f) return acc[1];
      const float df_t = mc::exp32(p[5]);
      const bool breached = acc[2] <= p[3];
      return df_t * (breached ? fminf(acc[3] / p[4], 1.0f) : 1.0f);
    }
    default:  // barrier survival, cliquet leg, sums
      return acc[0];
  }
}

}  // namespace mcf
