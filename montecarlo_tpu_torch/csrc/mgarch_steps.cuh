// The steps of the multi-asset state processes, TermBasketGBM, CCC-GARCH
// and DCC-GARCH, as K2-K4's functors run them (StateProc<Step, A> in
// csrc/fused_mgarch.cuh: a draw source around a step of this header), the
// asset count A a compile-time constant, 1..kMaxStateAssets.
//
// Replaces montecarlo_tpu/processes/term_basket.py::TermBasketGBM.step,
// ccc_garch.py::CCCGarch.step and dcc_garch.py::DCCGarch.step, which the
// JAX kernels trace into K2-K4; the torch plain versions are the port's
// processes of the same names.  __host__ __device__ like rng.cuh, so the
// tests build the same text with g++ and walk it against them.
//
// The term basket's constructor takes the process's float32 leaves in
// field order (ops/fused_engine.py::_leaves) and `dims` (A + 16 n, n its
// curve length), and reads its constants from the leaves where the step
// uses them (__ldg on the card: the same address for every thread).  CCC's
// and DCC's take their Leaves struct, the kernel's by-value parameter
// (CccLeaves, DccLeaves below).  Every state array is indexed statically
// after unrolling, so a path's state stays in registers.  The arithmetic
// is the plain versions', operation for operation:
//   - the correlated draws zc_a = L[a,0] z_0 + L[a,1] z_1 + ... + L[a,a]
//     z_a, left to right, the first term a product (correlate);
//   - the term basket: log_s_a + ((mu_a(t) - 0.5 sigma_a(t)^2) dt +
//     (sigma_a(t) sqrtf(dt)) zc_a), the curves read at t;
//   - CCC: r = sqrtf(var_a) zc_a, log_s_a + r, (omega_a + alpha_a (r r)) +
//     beta_a var_a;
//   - DCC: the unrolled Cholesky of the path's Q (sqrtf(max(s, 1e-12)) on
//     the diagonal, an IEEE division off it, each pivot's sum over k < j in
//     order), row i scaled by 1 / sqrtf(max(q_ii, 1e-12)) (the plain
//     version's form of JAX's rsqrt), CCC's update on eta = the scaled
//     factor times z, then q_ij' = ((c qbar_ij) + ((a eta_i) eta_j)) + b
//     q_ij with c = (1 - a) - b, over the A(A+1)/2 words of the lower
//     triangle (row-major pairs i >= j), a row at a time;
//   - the value sum_a w_a exp32(log_s_a), the assets in order.
// max is max_nan: NaN in its first argument comes out, as torch.maximum's
// and jnp.maximum's does (fmaxf would drop it).
//
// Bounds on the H100, per path and step: A normals (A/2 Threefry calls
// and Box-Muller pairs a step), A(A+1)/2 multiplies and A(A-1)/2 adds for
// zc; the term basket 7A more and two 4-byte curve reads an asset through
// the read-only cache; CCC 7A and A sqrtf; DCC CCC's plus A(A-1)(A+1)/3
// multiplies and subtractions of the Cholesky, A(A-1)/2 divisions, 2A
// sqrtf, A divisions of the row scales, A(A+1)/2 multiplies of the
// scaling and 4 A(A+1)/2 of the recursion (c qbar_ij is the wrapper's).
// The value's A exp32 once a path (and after every step in K4).
// Numerics: -fmad=false, IEEE division and sqrtf (ops/_build.py); the
// host build uses -ffp-contract=off.
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

constexpr int kMaxStateAssets = 8;  // ops/fused_engine.py MAX_STATE_ASSETS
constexpr int kCurveShift = 4;      // the term basket's dims = A + (n << 4)
constexpr float kDccEps = 1e-12f;   // processes/dcc_garch.py EPS

// max(x, lo) with NaN in x kept (torch.maximum, jnp.maximum).
MC_HD float max_nan(float x, float lo) { return x > lo || x != x ? x : lo; }

// zc_a = L[a,0] z_0 + ... + L[a,a] z_a for every a, L row-major (A x A).
template <int A>
MC_HD void correlate(const float* chol, const float* eps, float* zc) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
    float z = MC_LDG(chol + a * A) * eps[0];
#pragma unroll
    for (int b = 1; b <= a; ++b) z = z + MC_LDG(chol + a * A + b) * eps[b];
    zc[a] = z;
  }
}

// sum_a w_a exp32(log_s_a), the assets in order.
template <int A>
MC_HD float weighted_value(const float* w, const float* log_s) {
  float out = MC_LDG(w) * exp32(log_s[0]);
#pragma unroll
  for (int a = 1; a < A; ++a) out = out + MC_LDG(w + a) * exp32(log_s[a]);
  return out;
}

// (omega + alpha r^2) + beta var: one asset's GARCH(1,1) update.
MC_HD float garch_update(float omega, float alpha, float beta, float var,
                         float r) {
  return (omega + alpha * (r * r)) + beta * var;
}

// processes/term_basket.py: leaves = [s0 (A), mu_t (A n), sigma_t (A n),
// chol_flat (A A), weights (A), dt], dims = A + (n << kCurveShift).
template <int A>
struct TermBasketStep {
  struct State {
    float log_s[A];
  };
  const float* s0;
  const float* mu;
  const float* sigma;
  const float* chol;
  const float* w;
  int n;
  float dt, sq_dt;
  MC_HD TermBasketStep(const float* leaves, int dims)
      : s0(leaves), n(dims >> kCurveShift) {
    mu = leaves + A;
    sigma = mu + A * n;
    chol = sigma + A * n;
    w = chol + A * A;
    dt = w[A];
    sq_dt = sqrtf(dt);
  }
  MC_HD State init() const {
    State s;
#pragma unroll
    for (int a = 0; a < A; ++a) s.log_s[a] = log32(s0[a]);
    return s;
  }
  MC_HD State step(const State& s, const float* eps, int t) const {
    float zc[A];
    correlate<A>(chol, eps, zc);
    State out;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float m = MC_LDG(mu + a * n + t), sg = MC_LDG(sigma + a * n + t);
      const float drift = (m - 0.5f * (sg * sg)) * dt;
      out.log_s[a] = s.log_s[a] + (drift + (sg * sq_dt) * zc[a]);
    }
    return out;
  }
  MC_HD float prices(const State& s) const {
    return weighted_value<A>(w, s.log_s);
  }
};

// CCC's and DCC's constants, passed to the kernels by value: the launch
// copies the wrapper's launch leaves (ops/fused_engine.py::
// state_launch_leaves, floats in this field order) into the kernel's
// parameter space (csrc/fused_mgarch.cuh).  Every read is at an index fixed
// after unrolling, so on the card each comes from the constant bank (a
// uniform-register ULDC, shared by the warp) and none from device memory.
// The per-launch constants are the wrapper's, computed with torch by the
// plain versions' own operations: log32(s0), and DCC's ((1 - a) - b)
// qbar_ij.
template <int A>
struct GarchConsts {
  float log_s0[A];  // log32(s0): the plain init_state's
  float var0[A], omega[A], alpha[A], beta[A];
  // The start of a path.
  MC_HD void start(float* log_s, float* var) const {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      log_s[a] = log_s0[a];
      var[a] = var0[a];
    }
  }
  // Asset a on its correlated draw zc: the return into log_s, the
  // variance updated.
  MC_HD void update(int a, float zc, float* log_s, float* var) const {
    const float r = sqrtf(var[a]) * zc;
    log_s[a] = log_s[a] + r;
    var[a] = garch_update(omega[a], alpha[a], beta[a], var[a], r);
  }
};

// sum_a w_a exp32(log_s_a), the assets in order (weighted_value's, the
// weights by value).
template <int A>
MC_HD float book_value(const float (&w)[A], const float* log_s) {
  float out = w[0] * exp32(log_s[0]);
#pragma unroll
  for (int a = 1; a < A; ++a) out = out + w[a] * exp32(log_s[a]);
  return out;
}

// processes/ccc_garch.py: the launch leaves are [log32(s0), var0, omega,
// alpha, beta (A each), chol_flat (A A), weights (A)].
template <int A>
struct CccLeaves {
  GarchConsts<A> g;
  float chol[A * A];
  float w[A];
};

template <int A>
struct CccStep {
  using Leaves = CccLeaves<A>;
  struct State {
    float log_s[A];
    float var[A];
  };
  const Leaves& c;
  MC_HD explicit CccStep(const Leaves& leaves) : c(leaves) {}
  MC_HD State init() const {
    State s;
    c.g.start(s.log_s, s.var);
    return s;
  }
  // correlate's sums, each asset updated on its own.
  MC_HD State step(const State& s, const float* eps, int) const {
    State out = s;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float z = c.chol[a * A] * eps[0];
#pragma unroll
      for (int b = 1; b <= a; ++b) z = z + c.chol[a * A + b] * eps[b];
      c.g.update(a, z, out.log_s, out.var);
    }
    return out;
  }
  MC_HD float prices(const State& s) const {
    return book_value<A>(c.w, s.log_s);
  }
};

// processes/dcc_garch.py: the launch leaves are [log32(s0), var0, omega,
// alpha, beta (A each), qbar_flat (A A), a_dcc, b_dcc, weights (A),
// ((1 - a_dcc) - b_dcc) qbar_flat (A A)].
template <int A>
struct DccLeaves {
  GarchConsts<A> g;
  float qbar[A * A];
  float a, b;
  float w[A];
  float cqbar[A * A];
};

template <int A>
struct DccStep {
  using Leaves = DccLeaves<A>;
  static constexpr int kPairs = A * (A + 1) / 2;
  struct State {
    float log_s[A];
    float var[A];
    float q[kPairs];  // Q's lower triangle, row-major pairs i >= j
  };
  // Pair (i, j), i >= j, in the lower triangle.
  MC_HD static constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }
  const Leaves& c;
  MC_HD explicit DccStep(const Leaves& leaves) : c(leaves) {}
  MC_HD State init() const {
    State s;
    c.g.start(s.log_s, s.var);
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) s.q[tri(i, j)] = c.qbar[i * A + j];
    }
    return s;
  }
  // A row at a time: row i of the Cholesky factor of Q (it reads the
  // factor's earlier rows), its scale 1 / sqrt(q_ii) (the factor of R =
  // diag(Q)^-1/2 Q diag(Q)^-1/2 is the factor's row i times it), eta_i,
  // asset i's update, then Q's new row i, which needs eta_0..eta_i only.
  // Q's old row i dies as its new row is written, and the scaled factor
  // is never stored.
  MC_HD State step(const State& s, const float* eps, int) const {
    float l[kPairs];
    float eta[A];
    State out;
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float sum = s.q[tri(i, j)];
#pragma unroll
        for (int k = 0; k < j; ++k) sum = sum - l[tri(i, k)] * l[tri(j, k)];
        l[tri(i, j)] = j == i ? sqrtf(max_nan(sum, kDccEps))
                              : sum / l[tri(j, j)];
      }
      const float dinv = 1.0f / sqrtf(max_nan(s.q[tri(i, i)], kDccEps));
      float z = (l[tri(i, 0)] * dinv) * eps[0];
#pragma unroll
      for (int b = 1; b <= i; ++b) z = z + (l[tri(i, b)] * dinv) * eps[b];
      eta[i] = z;
      out.log_s[i] = s.log_s[i];
      out.var[i] = s.var[i];
      c.g.update(i, z, out.log_s, out.var);
      const float ae = c.a * eta[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        out.q[tri(i, j)] = (c.cqbar[i * A + j] + ae * eta[j]) +
                           c.b * s.q[tri(i, j)];
      }
    }
    return out;
  }
  MC_HD float prices(const State& s) const {
    return book_value<A>(c.w, s.log_s);
  }
};

}  // namespace mc
