// The QE-M variance step of HestonQEProc and BatesQEProc (processes.cuh):
// Andersen's quadratic-exponential transition of the variance and the
// martingale-corrected drift constant K0* of the log price.
//
// Replaces montecarlo_tpu/processes/heston_qe.py::QEVarianceMixin's step,
// which the JAX kernels trace into K2-K4; the torch plain version is
// processes/heston_qe.py's.  __host__ __device__ like rng.cuh, so the
// tests build the same text with g++ and hold it against the form it
// replaced.
//
// Bounds on the H100: the IEEE divisions (a reciprocal, its Newton fix-up
// and a range check each under -prec-div=true), ndtri32_unit's logf, sqrtf
// and division, and two log32 a step.  Design: the plain version computes
// both branches for every path and selects.  selected() does so too, but
// three pairs of divisions of which a path needs one of each, at the same
// depth of the chain, share one division through their selected operands:
// (2 m^2 / s^2, (s^2 - m^2) / (s^2 + m^2)), (m / (1 + b^2), (1 - p) / m)
// and the quotients of lm and of the exponential branch's moment
// generating function.  IEEE division is a function of its operands alone,
// so a path's selected results keep their bits; the untaken branch's
// values change only where a later select on the branch (v_new, lg's
// argument, lm, ok) throws them away.  Five divisions a step where the
// plain version's order has eight.  step_warp_uniform() runs quadratic()
// or exponential() alone, each the selected result of its branch's paths,
// where every lane of the warp takes that branch (the exponential branch
// runs only at small v, so most warp-steps are all quadratic), and
// selected() where they differ.
#pragma once

#include "rng.cuh"

namespace mc {

// From the nine QE leaves q = [e_kdt, c1, c2, k0, k1, k2, k3, k4, mgf_a]
// and theta.
struct QECore {
  float theta, e_kdt, c1, c2, k0, k1, k2, k3, k4, A, two_A, head_c;
  MC_HD QECore(float theta_, const float* q)
      : theta(theta_), e_kdt(q[0]), c1(q[1]), c2(q[2]), k0(q[3]), k1(q[4]),
        k2(q[5]), k3(q[6]), k4(q[7]), A(q[8]) {
    two_A = 2.0f * A;
    head_c = -(k1 + 0.5f * k3);
  }

  // A branch's v', the lm of K0* and whether K0* is the path's own.
  struct Branch {
    float v_new, lm;
    bool ok;
  };

  // The quadratic branch alone, from m, m^2 and s^2; u a uniform_from_bits
  // value or its mirror 1 - u (ndtri32_unit's range).
  MC_HD Branch quadratic(float m, float m2, float s2, float u) const {
    const float inv2 = (2.0f * m2) / s2;
    const float tw1 = fmaxf(inv2 - 1.0f, 0.0f);
    const float b2 = fmaxf((inv2 - 1.0f) + sqrtf(inv2 * tw1), 0.0f);
    const float a = m / (1.0f + b2);
    const float zq = sqrtf(b2) + ndtri32_unit(u);
    const float den = 1.0f - two_A * a;
    const bool ok = den > 0.0f;
    const float den_s = ok ? den : 1.0f;
    return Branch{a * (zq * zq), ((A * b2) * a) / den_s - 0.5f * log32(den_s),
                  ok};
  }

  // The exponential branch alone.
  MC_HD Branch exponential(float m, float m2, float s2, float u) const {
    const float p = (s2 - m2) / (s2 + m2);
    const float one_p = 1.0f - p;
    const float beta = one_p / m;
    const float tail = log32(one_p / (1.0f - u)) / beta;
    const float gap = beta - A;
    const bool ok = gap > 0.0f;
    return Branch{u <= p ? 0.0f : fmaxf(tail, 0.0f),
                  log32(fmaxf(p + (beta * one_p) / (ok ? gap : 1.0f), 1e-30f)),
                  ok};
  }

  // Both branches, the divisions paired, the branch's results selected.
  MC_HD Branch selected(float m, float m2, float s2, bool quad,
                        float u) const {
    // inv2 = 2 m^2 / s^2 on the quadratic branch, p on the exponential.
    const float inv2_p = (quad ? 2.0f * m2 : s2 - m2) / (quad ? s2 : s2 + m2);
    const float inv2 = inv2_p, p = inv2_p;
    const float tw1 = fmaxf(inv2 - 1.0f, 0.0f);
    const float b2 = fmaxf((inv2 - 1.0f) + sqrtf(inv2 * tw1), 0.0f);
    const float one_p = 1.0f - p;
    // a = m / (1 + b^2), or beta = (1 - p) / m.
    const float a_beta = (quad ? m : one_p) / (quad ? 1.0f + b2 : m);
    const float a = a_beta, beta = a_beta;
    const float zq = sqrtf(b2) + ndtri32_unit(u);
    const float v_quad = a * (zq * zq);
    const float tail = log32(one_p / (1.0f - u)) / beta;
    const float v_exp = u <= p ? 0.0f : fmaxf(tail, 0.0f);
    // K0* (one log32 on the branch's argument).
    const float den = 1.0f - two_A * a;
    const bool ok_q = den > 0.0f;
    const float den_s = ok_q ? den : 1.0f;
    const float gap = beta - A;
    const bool ok_e = gap > 0.0f;
    // ((A b^2) a) / den_s, or (beta (1 - p)) / gap.
    const float lm_mgf = (quad ? (A * b2) * a : beta * one_p) /
                         (quad ? den_s : (ok_e ? gap : 1.0f));
    const float mgf_e = fmaxf(p + lm_mgf, 1e-30f);
    const float lg = log32(quad ? den_s : mgf_e);
    return Branch{quad ? v_quad : v_exp, quad ? lm_mgf - 0.5f * lg : lg,
                  quad ? ok_q : ok_e};
  }

  // m, m^2 and s^2 of v, and whether the quadratic branch is taken.
  MC_HD bool moments(float v, float* m, float* m2, float* s2) const {
    *m = theta + (v - theta) * e_kdt;
    *s2 = v * c1 + c2;
    *m2 = *m * *m;
    return *s2 <= 1.5f * *m2;
  }

  // v' of the branch; *k0s the per-path K0*, *sq = sqrt(k3 v + k4 v') (0
  // where that is not positive).
  MC_HD float finish(float v, Branch b, float* k0s, float* sq) const {
    *k0s = b.ok ? head_c * v - b.lm : k0;
    const float var_s = k3 * v + k4 * b.v_new;
    *sq = var_s > 0.0f ? sqrtf(var_s) : 0.0f;
    return b.v_new;
  }

  // v' from (v, u): both branches, selected.
  MC_HD float step(float v, float u, float* k0s, float* sq) const {
    float m, m2, s2;
    const bool quad = moments(v, &m, &m2, &s2);
    return finish(v, selected(m, m2, s2, quad, u), k0s, sq);
  }

#ifdef __CUDACC__
  // step's bits, with only the taken branch where the warp's lanes agree.
  __device__ float step_warp_uniform(float v, float u, float* k0s,
                                     float* sq) const {
    float m, m2, s2;
    const bool quad = moments(v, &m, &m2, &s2);
    const unsigned lanes = __activemask();
    const bool all_q = __all_sync(lanes, quad);
    const bool all_e = __all_sync(lanes, !quad);
    Branch b;
    if (all_q) {
      b = quadratic(m, m2, s2, u);
    } else if (all_e) {
      b = exponential(m, m2, s2, u);
    } else {
      b = selected(m, m2, s2, quad, u);
    }
    return finish(v, b, k0s, sq);
  }
#endif
};

}  // namespace mc
