// The process functors of K2-K4 on every process but the correlated
// basket, the draw sources each takes (SourceTraits) and the dispatch by
// process code, shared by the units that instantiate the kernels:
// csrc/fused_engine.cu (K2, K3) and csrc/fused_k4.cu (K4).  The basket's
// functors and launches are csrc/fused_basket.cuh's; the draw sources,
// epilogues and kernels csrc/fused_engine.cuh's.
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas (K2),
// ::fused_block_moments_pallas (K3) and ::fused_functionals_pallas (K4)
// for the process functors GbmProc, HestonProc, GarchProc, MertonProc,
// KouProc, BatesProc, NigProc, HestonQEProc, BatesQEProc, VgProc,
// SabrProc, LocalVolProc and SlvProc (Euler GBM, term-structure GBM and
// the short rates: csrc/fused_rates.cu; the term basket, CCC-GARCH and
// DCC-GARCH: csrc/fused_mgarch.cuh's units; each dispatched from here).
// SlvProc's per-step leverage row is the port of the JAX kernels' KernelRows
// (ops/fused_engine.py:44-66, the dynamic ref slice of a
// kernel_rows_field leaf): a pointer and a clamped row offset.  The
// surfaces on hat-blended time knots (local vol, and SLV on knots, which
// runs as SlvProc) read rows that the row builder (blend_rows_kernel in
// fused_engine.cu) blends once per launch, one per step, in the same way.
//
// Bounds on the H100: compute — integer ALU for Threefry, the SFU for
// log/sqrt/sin/cos; K2 writes 4 bytes per path, K3 8 bytes per 128 paths, K4 4
// bytes per path per output; GARCH one cipher call per pair of steps and, per
// step, one table read through the read-only cache (the 5-year table is 5 KB),
// a sqrt and 9 float32 operations.  The jump and Levy processes add uniform
// cipher calls on their second streams and per step the truncated Poisson's
// four selects, Kou four log32 (one per jump size), the QE step
// (qe_step.cuh) ndtri32_unit, two log32 and five divisions (HestonQE's
// warps whose lanes all take one branch only that branch's), VG
// ndtri32_unit, three log32, two exp32 and one 16-byte read of its
// interleaved table (8 KB through the read-only cache), SABR two exp32
// and a log32; SABR, the QE processes and VG take their Box-Muller pairs
// from one sincosf.  The local-vol surfaces add per step one IEEE
// division (the log-moneyness coordinate) and two reads of the step's
// row through the read-only cache, the same row for every thread;
// the time blend is the row builder's, once per step and lane.  A Sobol
// draw is integer work per
// dimension (the warp's shared Gray-code walk, a load and 11 shuffles; the
// Owen key's Threefry call once per block; the hash's four multiplies and two
// bit reversals) plus ndtri32's rationals, log and sqrt; the bridge adds 2L
// float32 operations per step and reads the plan's row (L dims and weights,
// the same for every thread), and takes each of its T normals once.
// Design: csrc/fused_engine.cuh's, one thread per path with its state in
// registers.
//
// Numerics: built with -fmad=false and the default -prec-div=true,
// -prec-sqrt=true (ops/_build.py, never fast math), so every a*b+c rounds
// twice and every division and sqrtf is the IEEE result, as in the torch
// plain versions and the JAX package.
#pragma once

#include "fused_engine.cuh"
#include "qe_step.cuh"
#include "surface.cuh"

namespace mcf {
namespace {

// Default innovations of NormalDrawsMixin: D normals per step, the 2D draws
// of steps (2j, 2j+1) from D cipher calls at counters j*D + c.
template <int D>
struct NormalDraws {
  static constexpr int kDraws = D;   // capacity of the eps arrays
  static constexpr int kUnroll = D;  // unroll factor of per-draw loops
  __device__ int draws() const { return D; }
  __device__ static float mirror(int, float e) { return -e; }
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    float flat[2 * D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      uint32_t b0, b1;
      mc::threefry2x32(k0, k1, id, j * (uint32_t)D + (uint32_t)c, &b0, &b1);
      mc::boxmuller_pair(b0, b1, &flat[2 * c], &flat[2 * c + 1]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      eps0[d] = flat[d];
      eps1[d] = flat[D + d];
    }
  }
};

// GBM (processes/gbm.py): leaves = [s0, mu, sigma, dt].
struct GbmProc : NormalDraws<1> {
  struct State {
    float log_s;
  };
  float drift, scale, log_s0;
  __device__ GbmProc(const float* leaves, int) {
    const float s0 = leaves[0], mu = leaves[1], sigma = leaves[2];
    const float dt = leaves[3];
    drift = (mu - 0.5f * (sigma * sigma)) * dt;
    scale = sigma * sqrtf(dt);
    log_s0 = mc::log32(s0);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps) const {
    return State{s.log_s + (drift + scale * eps[0])};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Heston, full-truncation Euler (processes/heston.py):
// leaves = [s0, v0, mu, kappa, theta, xi, rho, dt].
struct HestonProc : NormalDraws<2> {
  struct State {
    float log_s, v;
  };
  float log_s0, v0, mu, kappa, theta, xi, rho, dt, rho_perp;
  __device__ HestonProc(const float* leaves, int) {
    log_s0 = mc::log32(leaves[0]);
    v0 = leaves[1];
    mu = leaves[2];
    kappa = leaves[3];
    theta = leaves[4];
    xi = leaves[5];
    rho = leaves[6];
    dt = leaves[7];
    rho_perp = sqrtf(1.0f - rho * rho);
  }
  __device__ State init() const { return State{log_s0, v0}; }
  __device__ State step(State s, const float* eps) const {
    const float z1 = eps[0], z2 = eps[1];
    const float z_v = rho * z1 + rho_perp * z2;
    const float v_plus = fmaxf(s.v, 0.0f);
    const bool positive = v_plus > 0.0f;
    const float v_safe = positive ? v_plus : 1.0f;
    const float sq_vdt = positive ? sqrtf(v_safe * dt) : 0.0f;
    const float log_s = s.log_s + ((mu - 0.5f * v_plus) * dt + sq_vdt * z1);
    const float v = (s.v + (kappa * (theta - v_plus)) * dt) + (xi * sq_vdt) * z_v;
    return State{log_s, v};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// GARCH(1,1) bootstrap (processes/garch.py): leaves = [s0, var0, omega,
// alpha, beta, table (n)], n = dims the table length.  The draw of step t
// is a uniform, component t & 1 of cipher call t >> 1; the step maps it to
// min(floor(u * n), n - 1) (rng/normal.py::index_from_uniform), reads the
// shock there through the read-only cache and runs the recurrence in the
// JAX package's order: r = shock * sqrt(var), var' = (omega + alpha (r r))
// + beta var, log_s' = log_s + r.  The mirror is u -> 1 - u, exact in
// float32 for these uniforms.
struct GarchProc {
  static constexpr int kDraws = 1;
  static constexpr int kUnroll = 1;
  struct State {
    float log_s, var;
  };
  const float* table;
  int n;
  float n_f, log_s0, var0, omega, alpha, beta;
  __device__ GarchProc(const float* leaves, int n_table)
      : table(leaves + 5), n(n_table) {
    n_f = (float)n_table;
    log_s0 = mc::log32(leaves[0]);
    var0 = leaves[1];
    omega = leaves[2];
    alpha = leaves[3];
    beta = leaves[4];
  }
  __device__ int draws() const { return 1; }
  __device__ static float mirror(int, float u) { return 1.0f - u; }
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    uint32_t b0, b1;
    mc::threefry2x32(k0, k1, id, j, &b0, &b1);
    eps0[0] = mc::uniform_from_bits(b0);
    eps1[0] = mc::uniform_from_bits(b1);
  }
  __device__ State init() const { return State{log_s0, var0}; }
  __device__ State step(State s, const float* eps) const {
    const int idx = min((int)floorf(eps[0] * n_f), n - 1);
    const float shock = __ldg(table + idx);
    const float r = shock * sqrtf(s.var);
    const float var = (omega + alpha * (r * r)) + beta * s.var;
    return State{s.log_s + r, var};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// ---- Jump, Levy, QE and SABR processes -------------------------------------
//
// Each copies its JAX process's draws_pair exactly: normals are the
// Box-Muller halves of counters on the main key (k0, k1), uniforms both
// halves of counters on the process's second stream, whose key is (k0, k1
// ^ C) (rng/threefry.py: k1 = seed_hi ^ stream, so stream ^ C is k1 ^ C).
// Per-step constants are computed once per thread from the leaves, in the
// plain versions' float32 order.

constexpr int kKMax = 4;                     // processes/merton.py::K_MAX
constexpr uint32_t kJumpStream = 0x6A09E667u;  // merton.py::JUMP_STREAM
constexpr uint32_t kVStream = 0x5BE0CD19u;     // heston_qe.py::V_STREAM
constexpr uint32_t kIgStream = 0x510E527Fu;    // nig.py::IG_STREAM
constexpr uint32_t kVgStream = 0x1F83D9ABu;    // vg.py::VG_STREAM

__device__ __forceinline__ void normal_pair(uint32_t k0, uint32_t k1,
                                            uint32_t id, uint32_t c,
                                            float* z0, float* z1) {
  uint32_t b0, b1;
  mc::threefry2x32(k0, k1, id, c, &b0, &b1);
  mc::boxmuller_pair(b0, b1, z0, z1);
}

// normal_pair with the sine and cosine from one sincosf
// (mc::boxmuller_sincos): the same bits.  HestonQEProc, BatesQEProc and
// VgProc draw their normals through it.
__device__ __forceinline__ void normal_pair_sincos(uint32_t k0, uint32_t k1,
                                                   uint32_t id, uint32_t c,
                                                   float* z0, float* z1) {
  uint32_t b0, b1;
  mc::threefry2x32(k0, k1, id, c, &b0, &b1);
  mc::boxmuller_sincos(b0, b1, z0, z1);
}

// NormalDraws<D> with each Box-Muller pair's sine and cosine from one
// sincosf: D cipher calls a step pair at counters j D + c, the same bits
// (the rate and multi-asset state functors' draws).
template <int D>
struct SincosDraws : NormalDraws<D> {
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    float flat[2 * D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      normal_pair_sincos(k0, k1, id, j * (uint32_t)D + (uint32_t)c,
                         &flat[2 * c], &flat[2 * c + 1]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      eps0[d] = flat[d];
      eps1[d] = flat[D + d];
    }
  }
};

__device__ __forceinline__ void uniform_pair(uint32_t k0, uint32_t k1,
                                             uint32_t id, uint32_t c,
                                             float* u0, float* u1) {
  uint32_t b0, b1;
  mc::threefry2x32(k0, k1, id, c, &b0, &b1);
  *u0 = mc::uniform_from_bits(b0);
  *u1 = mc::uniform_from_bits(b1);
}

// D draws per step, those whose bit is set in UniformMask uniforms: the
// antithetic mirror reflects a uniform (1 - u, exact in float32 for these
// uniforms) and negates a normal.
template <int D, uint32_t UniformMask>
struct MixedDraws {
  static constexpr int kDraws = D;
  static constexpr int kUnroll = D;
  __device__ int draws() const { return D; }
  __device__ static float mirror(int d, float e) {
    return ((UniformMask >> d) & 1u) ? 1.0f - e : -e;
  }
};

// merton.py::poisson_count: the count is the number of cdf levels u
// exceeds, the levels built as pmf = pmf * rate / k, cdf = cdf + pmf from
// pmf = exp32(-rate) (the select chain of the plain version).
struct PoissonLevels {
  float cdf[kKMax];
  __device__ explicit PoissonLevels(float rate) {
    float pmf = mc::exp32(-rate);
    float c = pmf;
#pragma unroll
    for (int k = 1; k <= kKMax; ++k) {
      pmf = pmf * rate / (float)k;
      cdf[k - 1] = c;
      c = c + pmf;
    }
  }
  __device__ float count(float u) const {
    float n = 0.0f;
#pragma unroll
    for (int k = 1; k <= kKMax; ++k) n = u > cdf[k - 1] ? (float)k : n;
    return n;
  }
};

struct LogState {
  float log_s;
};

struct LogVarState {
  float log_s, v;
};

// Merton jump-diffusion (processes/merton.py): leaves = [s0, mu, sigma,
// lam, jump_mean, jump_std, dt]; draws (z1, u_count, z2).
struct MertonProc : MixedDraws<3, 0b010u> {
  using State = LogState;
  float log_s0, drift, scale, jm, js;
  PoissonLevels pois;
  __device__ MertonProc(const float* leaves, int)
      : pois(leaves[3] * leaves[6]) {
    const float mu = leaves[1], sigma = leaves[2], lam = leaves[3];
    const float dt = leaves[6];
    jm = leaves[4];
    js = leaves[5];
    log_s0 = mc::log32(leaves[0]);
    const float m = mc::exp32(jm + 0.5f * (js * js)) - 1.0f;
    drift = ((mu - lam * m) - 0.5f * (sigma * sigma)) * dt;
    scale = sigma * sqrtf(dt);
  }
  // Normals at pair counters 2j, 2j+1; the counts both halves of counter j
  // on the jump stream.
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    normal_pair(k0, k1, id, 2u * j, &eps0[0], &eps0[2]);
    normal_pair(k0, k1, id, 2u * j + 1u, &eps1[0], &eps1[2]);
    uniform_pair(k0, k1 ^ kJumpStream, id, j, &eps0[1], &eps1[1]);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps) const {
    const float n = pois.count(eps[1]);
    const float jump = jm * n + (js * sqrtf(n)) * eps[2];
    return State{s.log_s + ((drift + scale * eps[0]) + jump)};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Kou double-exponential jumps (processes/kou.py): leaves = [s0, mu,
// sigma, lam, p_up, eta1, eta2, dt]; draws (z, u_count, u_jump x 4).  A
// step pair: the Box-Muller halves of counter j, then the ten halves of
// jump-stream counters 5j..5j+4 in order, the first five to step 2j.
struct KouProc : MixedDraws<2 + kKMax, 0b111110u> {
  using State = LogState;
  float log_s0, drift, scale, p, q, eta1, eta2;
  PoissonLevels pois;
  __device__ KouProc(const float* leaves, int)
      : pois(leaves[3] * leaves[7]) {
    const float mu = leaves[1], sigma = leaves[2], lam = leaves[3];
    const float dt = leaves[7];
    p = leaves[4];
    eta1 = leaves[5];
    eta2 = leaves[6];
    q = 1.0f - p;
    log_s0 = mc::log32(leaves[0]);
    const float m =
        ((p * eta1) / (eta1 - 1.0f) + (q * eta2) / (eta2 + 1.0f)) - 1.0f;
    drift = ((mu - lam * m) - 0.5f * (sigma * sigma)) * dt;
    scale = sigma * sqrtf(dt);
  }
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    normal_pair(k0, k1, id, j, &eps0[0], &eps1[0]);
    float h[2 * (1 + kKMax)];
#pragma unroll
    for (int k = 0; k <= kKMax; ++k) {
      uniform_pair(k0, k1 ^ kJumpStream, id,
                   j * (uint32_t)(1 + kKMax) + (uint32_t)k, &h[2 * k],
                   &h[2 * k + 1]);
    }
#pragma unroll
    for (int k = 0; k <= kKMax; ++k) {
      eps0[1 + k] = h[k];
      eps1[1 + k] = h[1 + kKMax + k];
    }
  }
  // One log32 of the ratio the uniform selects.
  __device__ float jump_size(float u) const {
    const bool down = u <= q;
    const float ratio = down ? u / q : (1.0f - u) / p;
    const float lg = mc::log32(fmaxf(ratio, 1e-38f));
    return down ? lg / eta2 : -lg / eta1;
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps) const {
    const float n = pois.count(eps[1]);
    float jump = 0.0f;
#pragma unroll
    for (int k = 0; k < kKMax; ++k) {
      jump = jump + (n > (float)k ? jump_size(eps[2 + k]) : 0.0f);
    }
    return State{s.log_s + ((drift + scale * eps[0]) + jump)};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Bates, full-truncation Euler with Merton's jump leg (processes/
// bates.py): leaves = [s0, v0, mu, kappa, theta, xi, rho, lam, jump_mean,
// jump_std, dt]; draws (z_s, z_perp, u_count, z_jump).
struct BatesProc : MixedDraws<4, 0b0100u> {
  using State = LogVarState;
  float log_s0, v0, mu_lm, kappa, theta, xi, rho, rho_perp, dt, jm, js;
  PoissonLevels pois;
  __device__ BatesProc(const float* leaves, int)
      : pois(leaves[7] * leaves[10]) {
    log_s0 = mc::log32(leaves[0]);
    v0 = leaves[1];
    kappa = leaves[3];
    theta = leaves[4];
    xi = leaves[5];
    rho = leaves[6];
    jm = leaves[8];
    js = leaves[9];
    dt = leaves[10];
    rho_perp = sqrtf(1.0f - rho * rho);
    const float mbar = mc::exp32(jm + 0.5f * (js * js)) - 1.0f;
    mu_lm = leaves[2] - leaves[7] * mbar;
  }
  // The six halves of pair counters 3j..3j+2 in order; the counts both
  // halves of counter j on the jump stream.
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    const uint32_t c = 3u * j;
    normal_pair(k0, k1, id, c, &eps0[0], &eps0[1]);
    normal_pair(k0, k1, id, c + 1u, &eps0[3], &eps1[0]);
    normal_pair(k0, k1, id, c + 2u, &eps1[1], &eps1[3]);
    uniform_pair(k0, k1 ^ kJumpStream, id, j, &eps0[2], &eps1[2]);
  }
  __device__ State init() const { return State{log_s0, v0}; }
  __device__ State step(State s, const float* eps) const {
    const float z_s = eps[0], z_v = rho * z_s + rho_perp * eps[1];
    const float v_plus = fmaxf(s.v, 0.0f);
    const bool positive = v_plus > 0.0f;
    const float v_safe = positive ? v_plus : 1.0f;
    const float sq_vdt = positive ? sqrtf(v_safe * dt) : 0.0f;
    const float n = pois.count(eps[2]);
    const float jumps = n * jm + (sqrtf(n) * js) * eps[3];
    const float log_s =
        s.log_s + (((mu_lm - 0.5f * v_plus) * dt + sq_vdt * z_s) + jumps);
    const float v =
        (s.v + (kappa * (theta - v_plus)) * dt) + (xi * sq_vdt) * z_v;
    return State{log_s, v};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Normal-inverse-Gaussian (processes/nig.py): leaves = [s0, mu, alpha,
// beta, delta, dt]; draws (z_ig, u_accept, z), Merton's layout on the IG
// stream.  The IG increment keeps the root y where u (m + y) <= m, else
// m^2 / y.
struct NigProc : MixedDraws<3, 0b010u> {
  using State = LogState;
  float log_s0, drift, beta, m, m_sq, four_lam, four_lam_m;
  __device__ NigProc(const float* leaves, int) {
    const float mu = leaves[1], alpha = leaves[2], delta = leaves[4];
    const float dt = leaves[5];
    beta = leaves[3];
    log_s0 = mc::log32(leaves[0]);
    const float gamma = sqrtf(alpha * alpha - beta * beta);
    const float a = delta * dt;
    m = a / gamma;
    m_sq = m * m;
    four_lam = 4.0f * (a * a);
    four_lam_m = four_lam * m;
    const float b1 = beta + 1.0f;
    const float omega = delta * (sqrtf(alpha * alpha - b1 * b1) - gamma);
    drift = (mu + omega) * dt;
  }
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    normal_pair(k0, k1, id, 2u * j, &eps0[0], &eps0[2]);
    normal_pair(k0, k1, id, 2u * j + 1u, &eps1[0], &eps1[2]);
    uniform_pair(k0, k1 ^ kIgStream, id, j, &eps0[1], &eps1[1]);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps) const {
    const float nu = fmaxf(eps[0] * eps[0], 1e-12f);
    const float x = m * nu;
    const float r = sqrtf(x * (x + four_lam));
    const float xs = x + r;
    const float y = (four_lam_m * x) / (xs * xs);
    const float inc = eps[1] * (m + y) <= m ? y : m_sq / y;
    return State{s.log_s + ((drift + beta * inc) + sqrtf(inc) * eps[2])};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Heston under QE-M (processes/heston_qe.py): leaves = [s0, v0, mu, kappa,
// theta, xi, rho, dt, e_kdt, c1, c2, k0, k1, k2, k3, k4, mgf_a]; draws (z,
// u_variance): the halves of counter j on the main and variance streams.
// The QE step in its warp-uniform form: only the taken branch where the
// warp's lanes agree.  (BatesQEProc keeps the selected form: the
// warp-uniform one ran slower for it at the CLI's parameters.)
struct HestonQEProc : MixedDraws<2, 0b10u> {
  using State = LogVarState;
  float log_s0, v0, mu_dt;
  mc::QECore qe;
  __device__ HestonQEProc(const float* leaves, int)
      : qe(leaves[4], leaves + 8) {
    log_s0 = mc::log32(leaves[0]);
    v0 = leaves[1];
    mu_dt = leaves[2] * leaves[7];
  }
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    normal_pair_sincos(k0, k1, id, j, &eps0[0], &eps1[0]);
    uniform_pair(k0, k1 ^ kVStream, id, j, &eps0[1], &eps1[1]);
  }
  __device__ State init() const { return State{log_s0, v0}; }
  __device__ State step(State s, const float* eps) const {
    float k0s, sq;
    const float v_new = qe.step_warp_uniform(s.v, eps[1], &k0s, &sq);
    const float log_s = s.log_s + ((((mu_dt + k0s) + qe.k1 * s.v) +
                                    qe.k2 * v_new) + sq * eps[0]);
    return State{log_s, v_new};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Bates under QE-M (processes/bates_qe.py): leaves = [s0, v0, mu, kappa,
// theta, xi, rho, lam, jump_mean, jump_std, dt, the nine QE leaves];
// draws (z_s, u_variance, u_count, z_jump).
struct BatesQEProc : MixedDraws<4, 0b0110u> {
  using State = LogVarState;
  float log_s0, v0, mu_lm_dt, jm, js;
  mc::QECore qe;
  PoissonLevels pois;
  __device__ BatesQEProc(const float* leaves, int)
      : qe(leaves[4], leaves + 11), pois(leaves[7] * leaves[10]) {
    log_s0 = mc::log32(leaves[0]);
    v0 = leaves[1];
    jm = leaves[8];
    js = leaves[9];
    const float mbar = mc::exp32(jm + 0.5f * (js * js)) - 1.0f;
    mu_lm_dt = (leaves[2] - leaves[7] * mbar) * leaves[10];
  }
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    normal_pair_sincos(k0, k1, id, 2u * j, &eps0[0], &eps0[3]);
    normal_pair_sincos(k0, k1, id, 2u * j + 1u, &eps1[0], &eps1[3]);
    uniform_pair(k0, k1 ^ kVStream, id, j, &eps0[1], &eps1[1]);
    uniform_pair(k0, k1 ^ kJumpStream, id, j, &eps0[2], &eps1[2]);
  }
  __device__ State init() const { return State{log_s0, v0}; }
  __device__ State step(State s, const float* eps) const {
    float k0s, sq;
    const float v_new = qe.step(s.v, eps[1], &k0s, &sq);
    const float n = pois.count(eps[2]);
    const float jumps = n * jm + (sqrtf(n) * js) * eps[3];
    const float log_s =
        s.log_s + (((((mu_lm_dt + k0s) + qe.k1 * s.v) + qe.k2 * v_new) +
                    sq * eps[0]) + jumps);
    return State{log_s, v_new};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Variance gamma (processes/vg.py): leaves = [s0, mu, sigma, theta, nu,
// dt, gq_z0, gq_dz, gq_resid (n), gq_dresid (n)], n = dims, then on the
// card (ops/fused_engine.py::_launch_leaves) zeros to 16 bytes and the
// tables interleaved by interval, (resid[i], resid[i + 1], dresid[i],
// dresid[i + 1]) for i < n - 1; draws (u_w, u_boost, z).  The
// subordinator increment is nu times mc::gamma_from_uniforms_quad32 over
// the interleaved table: one 16-byte load through the read-only cache a
// step, the two tables' floats.
struct VgProc : MixedDraws<3, 0b011u> {
  using State = LogState;
  const float* quad;
  int n;
  float log_s0, drift, sigma, theta, nu, a, z0, dz;
  __device__ VgProc(const float* leaves, int n_table)
      : quad(leaves + ((8 + 2 * n_table + 3) & ~3)), n(n_table) {
    const float mu = leaves[1], dt = leaves[5];
    sigma = leaves[2];
    theta = leaves[3];
    nu = leaves[4];
    z0 = leaves[6];
    dz = leaves[7];
    log_s0 = mc::log32(leaves[0]);
    a = dt / nu;
    const float omega =
        mc::log32((1.0f - theta * nu) - (0.5f * (sigma * sigma)) * nu) / nu;
    drift = (mu + omega) * dt;
  }
  // The normals are the Box-Muller halves of counter j; each step's two
  // uniforms both halves of counter 2j or 2j+1 on the VG stream.
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    normal_pair_sincos(k0, k1, id, j, &eps0[2], &eps1[2]);
    uniform_pair(k0, k1 ^ kVgStream, id, 2u * j, &eps0[0], &eps0[1]);
    uniform_pair(k0, k1 ^ kVgStream, id, 2u * j + 1u, &eps1[0], &eps1[1]);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps) const {
    const float g =
        nu * mc::gamma_from_uniforms_quad32(a, eps[0], eps[1], z0, dz, quad, n);
    return State{s.log_s + ((drift + theta * g) + (sigma * sqrtf(g)) * eps[2])};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// SABR (processes/sabr.py): leaves = [f0, alpha, beta, nu, rho, dt]; two
// normals per step (NormalDrawsMixin).  F+^beta = exp32(beta log32(F+))
// for F+ > 0, 0 at F+ = 0 (1 when beta = 0); the forward is absorbed at 0.
// The prices are the forward; log-space functionals observe log32(F).
struct SabrProc : NormalDraws<2> {
  // NormalDraws<2>'s counters 2j and 2j + 1, each pair's sine and cosine
  // from one sincosf (mc::boxmuller_sincos): the same bits.
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    uint32_t b0, b1, c0, c1;
    mc::threefry2x32(k0, k1, id, 2u * j, &b0, &b1);
    mc::threefry2x32(k0, k1, id, 2u * j + 1u, &c0, &c1);
    mc::boxmuller_sincos(b0, b1, &eps0[0], &eps0[1]);
    mc::boxmuller_sincos(c0, c1, &eps1[0], &eps1[1]);
  }
  struct State {
    float f, sigma;
  };
  float f0, alpha, beta, rho, rho_perp, sqdt, nu_sqdt, half_nu2_dt, at_zero;
  __device__ SabrProc(const float* leaves, int) {
    f0 = leaves[0];
    alpha = leaves[1];
    beta = leaves[2];
    const float nu = leaves[3], dt = leaves[5];
    rho = leaves[4];
    rho_perp = sqrtf(1.0f - rho * rho);
    sqdt = sqrtf(dt);
    nu_sqdt = nu * sqdt;
    half_nu2_dt = (0.5f * (nu * nu)) * dt;
    at_zero = beta == 0.0f ? 1.0f : 0.0f;
  }
  __device__ State init() const { return State{f0, alpha}; }
  __device__ State step(State s, const float* eps) const {
    const float w2 = rho * eps[0] + rho_perp * eps[1];
    const float f_plus = fmaxf(s.f, 0.0f);
    const float pw =
        f_plus > 0.0f ? mc::exp32(beta * mc::log32(f_plus)) : at_zero;
    const float df = ((s.sigma * pw) * sqdt) * eps[0];
    const float f_new = fmaxf(f_plus + df, 0.0f);
    const float sig_new = s.sigma * mc::exp32(nu_sqdt * w2 - half_nu2_dt);
    return State{f_new, sig_new};
  }
  __device__ float prices(State s) const { return s.f; }
  __device__ float log_prices(State s) const { return mc::log32(s.f); }
};

// ---- Local and stochastic-local volatility ----------------------------------
//
// TimedStep functors (fused_engine.cuh); their knot-grid reads are
// surface.cuh's.

// Local volatility (processes/local_vol.py): leaves = [s0, rate, dt, x0, dx,
// rows (n_rows * 128)], n_rows = dims >= 1, row t the surface's hat blend
// at step t from the row builder (blend_rows_kernel).  Per step sigma = row
// clamp(t, 0, n_rows - 1) at x = log_s - log32(s0), read as SlvProc reads
// its rows (interp_row over blend_lane's floats is interp_blend's
// arithmetic, so the bits are the per-path blend's), then the GBM
// increment ((rate - 0.5 sigma^2) dt + (sigma sqrt(dt)) z), grouped before
// the add.
struct LocalVolProc : NormalDraws<1>, TimedStep {
  using State = LogState;
  const float* vol;
  int n_rows;
  float log_s0, rate, dt, sq_dt, x0, dx;
  __device__ LocalVolProc(const float* leaves, int n)
      : vol(leaves + 5), n_rows(n) {
    log_s0 = mc::log32(leaves[0]);
    rate = leaves[1];
    dt = leaves[2];
    x0 = leaves[3];
    dx = leaves[4];
    sq_dt = sqrtf(dt);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps, int t) const {
    const int k = t < 0 ? 0 : (t < n_rows ? t : n_rows - 1);
    const float sig = mc::interp_row(vol + (int64_t)k * mc::kKnots,
                                     s.log_s - log_s0, x0, dx);
    const float drift = (rate - 0.5f * (sig * sig)) * dt;
    return State{s.log_s + (drift + (sig * sq_dt) * eps[0])};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// Heston mixing with a leverage L (processes/slv.py::_SLVStep.step):
// full-truncation Euler, the double select around the square root, then
// log_s += ((rate - (0.5 L^2) v+) dt + (L sqrt(v+ dt)) z1) and the Heston
// variance update.  Leverage::at(log_s, t) gives L; leaves = [s0, rate, v0,
// kappa, theta, xi, rho, dt, x0, dx, ...].
template <class Leverage>
struct SlvStep : NormalDraws<2>, TimedStep {
  using State = LogVarState;
  float log_s0, rate, v0, kappa, theta, xi, rho, rho_perp, dt, x0, dx;
  __device__ explicit SlvStep(const float* leaves) {
    log_s0 = mc::log32(leaves[0]);
    rate = leaves[1];
    v0 = leaves[2];
    kappa = leaves[3];
    theta = leaves[4];
    xi = leaves[5];
    rho = leaves[6];
    dt = leaves[7];
    x0 = leaves[8];
    dx = leaves[9];
    rho_perp = sqrtf(1.0f - rho * rho);
  }
  __device__ State init() const { return State{log_s0, v0}; }
  __device__ State step(State s, const float* eps, int t) const {
    const float z1 = eps[0], z2 = eps[1];
    const float z_v = rho * z1 + rho_perp * z2;
    const float v_plus = fmaxf(s.v, 0.0f);
    const bool positive = v_plus > 0.0f;
    const float v_safe = positive ? v_plus : 1.0f;
    const float sq_vdt = positive ? sqrtf(v_safe * dt) : 0.0f;
    const float lev =
        static_cast<const Leverage*>(this)->at(s.log_s - log_s0, t);
    const float log_s = s.log_s + ((rate - (0.5f * (lev * lev)) * v_plus) * dt +
                                   (lev * sq_vdt) * z1);
    const float v =
        (s.v + (kappa * (theta - v_plus)) * dt) + (xi * sq_vdt) * z_v;
    return State{log_s, v};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
  __device__ float log_prices(State s) const { return s.log_s; }
};

// SLV with exact per-step rows (processes/slv.py::SLV): leaves = [..., x0,
// dx, lev_rows (n_rows * 128)], n_rows = dims >= 1.  The port of the JAX
// kernels' KernelRows (ops/fused_engine.py:44-66): row t is lev + clamp(t,
// 0, n_rows - 1) * 128, a pointer and an offset, read through the
// read-only cache (every thread of a step reads the same 512-byte row).
// SLV on time knots (processes/slv.py::SLVKnots) runs here too, on the
// rows the row builder blends from its knots, one per step.
struct SlvProc : SlvStep<SlvProc> {
  const float* lev;
  int n_rows;
  __device__ SlvProc(const float* leaves, int n)
      : SlvStep<SlvProc>(leaves), lev(leaves + 10), n_rows(n) {}
  __device__ float at(float x, int t) const {
    const int k = t < 0 ? 0 : (t < n_rows ? t : n_rows - 1);
    return mc::interp_row(lev + (int64_t)k * mc::kKnots, x, x0, dx);
  }
};

}  // namespace

template <>
struct SourceTraits<MertonProc> : ThreefryOnly {};
template <>
struct SourceTraits<KouProc> : ThreefryOnly {};
template <>
struct SourceTraits<BatesProc> : ThreefryOnly {};
template <>
struct SourceTraits<NigProc> : ThreefryOnly {};
template <>
struct SourceTraits<HestonQEProc> : ThreefryOnly {};
template <>
struct SourceTraits<BatesQEProc> : ThreefryOnly {};
template <>
struct SourceTraits<VgProc> : ThreefryOnly {};
template <>
struct SourceTraits<GbmProc> {
  static constexpr bool kSobol = true;
  static constexpr bool kBridge = true;
};
template <>
struct SourceTraits<LocalVolProc> {
  static constexpr bool kSobol = true;
  static constexpr bool kBridge = true;
};
template <>
struct SourceTraits<GarchProc> {
  static constexpr bool kSobol = false;
  static constexpr bool kBridge = false;
};

// K2, K3 and K4 on Euler GBM, term-structure GBM, Vasicek, CIR, Hull-White
// and G2++ (csrc/fused_rates.cu, over csrc/rate_steps.cuh), launched with
// one thread per path; the arguments of a Launcher's run after the draw
// source.
cudaError_t launch_rates(int process, const DrawArgs& a, int dims,
                         unsigned blocks, cudaStream_t s, int64_t n_paths,
                         const float* leaves, int n_steps,
                         uint32_t path_offset, uint32_t k0, uint32_t k1,
                         StoreTerminal epilogue);
cudaError_t launch_rates(int process, const DrawArgs& a, int dims,
                         unsigned blocks, cudaStream_t s, int64_t n_paths,
                         const float* leaves, int n_steps,
                         uint32_t path_offset, uint32_t k0, uint32_t k1,
                         RowMoments epilogue);
cudaError_t launch_rates(int process, const DrawArgs& a, int dims,
                         unsigned blocks, cudaStream_t s, int64_t n_paths,
                         const float* leaves, int n_steps,
                         uint32_t path_offset, uint32_t k0, uint32_t k1,
                         FunctionalSpec spec, float* out, int* fixed);

// K2, K3 and K4 on the multi-asset state processes of 1..8 assets
// (csrc/fused_mgarch.cuh's StateProc over csrc/mgarch_steps.cuh): the term
// basket in csrc/fused_term_basket.cu (K4 in fused_term_basket_k4.cu),
// CCC-GARCH in csrc/fused_ccc.cu, DCC-GARCH in csrc/fused_dcc.cu (K4 in
// fused_dcc_k4.cu); one thread per path, the arguments of a Launcher's run
// after the draw source.
#define MC_STATE_LAUNCHES(name)                                              \
  cudaError_t name(const DrawArgs& a, int dims, unsigned blocks,             \
                   cudaStream_t s, int64_t n_paths, const float* leaves,     \
                   int n_steps, uint32_t path_offset, uint32_t k0,           \
                   uint32_t k1, StoreTerminal epilogue);                     \
  cudaError_t name(const DrawArgs& a, int dims, unsigned blocks,             \
                   cudaStream_t s, int64_t n_paths, const float* leaves,     \
                   int n_steps, uint32_t path_offset, uint32_t k0,           \
                   uint32_t k1, RowMoments epilogue);                        \
  cudaError_t name(const DrawArgs& a, int dims, unsigned blocks,             \
                   cudaStream_t s, int64_t n_paths, const float* leaves,     \
                   int n_steps, uint32_t path_offset, uint32_t k0,           \
                   uint32_t k1, FunctionalSpec spec, float* out, int* fixed);
MC_STATE_LAUNCHES(launch_term_basket)
MC_STATE_LAUNCHES(launch_ccc_garch)
MC_STATE_LAUNCHES(launch_dcc_garch)
#undef MC_STATE_LAUNCHES

namespace {

// Launches `Launcher` on this header's functor for the process code with
// one thread per path; an invalid value for a code that is none of them.
// The snapshot kernel's unit (csrc/fused_k4_snapshot.cu) dispatches here
// alone.
template <template <class, class> class Launcher, class... Args>
cudaError_t launch_functor(int process, int dims, const DrawArgs& a,
                           unsigned blocks, cudaStream_t s, Args... args) {
  switch (process) {
    case kGbm:
      return launch_source<Launcher, GbmProc>(a, dims, blocks, s, args...);
    case kHeston:
      return launch_source<Launcher, HestonProc>(a, dims, blocks, s,
                                                 args...);
    case kGarch:
      if (dims < 1) return cudaErrorInvalidValue;
      return launch_source<Launcher, GarchProc>(a, dims, blocks, s, args...);
    case kMerton:
      return launch_source<Launcher, MertonProc>(a, dims, blocks, s,
                                                 args...);
    case kKou:
      return launch_source<Launcher, KouProc>(a, dims, blocks, s, args...);
    case kBates:
      return launch_source<Launcher, BatesProc>(a, dims, blocks, s, args...);
    case kNig:
      return launch_source<Launcher, NigProc>(a, dims, blocks, s, args...);
    case kHestonQE:
      return launch_source<Launcher, HestonQEProc>(a, dims, blocks, s,
                                                   args...);
    case kBatesQE:
      return launch_source<Launcher, BatesQEProc>(a, dims, blocks, s,
                                                  args...);
    case kVg:
      if (dims < 2) return cudaErrorInvalidValue;
      return launch_source<Launcher, VgProc>(a, dims, blocks, s, args...);
    case kSabr:
      return launch_source<Launcher, SabrProc>(a, dims, blocks, s, args...);
    case kLocalVol:
      if (dims < 1) return cudaErrorInvalidValue;
      return launch_source<Launcher, LocalVolProc>(a, dims, blocks, s,
                                                   args...);
    case kSlv:
      if (dims < 1) return cudaErrorInvalidValue;
      return launch_source<Launcher, SlvProc>(a, dims, blocks, s, args...);
    default:
      return cudaErrorInvalidValue;
  }
}

// Picks the functor for the process code (this header's by
// launch_functor; the basket's by its asset count, in fused_basket.cuh;
// the rate and term-structure processes' in fused_rates.cu; the
// multi-asset state processes' in their units) and launches it with one
// thread per path.
template <template <class, class> class Launcher, class... Args>
int dispatch(int process, int dims, const DrawArgs& a, int64_t n_paths,
             void* stream, Args... args) {
  const unsigned blocks = (unsigned)((n_paths + kRow - 1) / kRow);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (process) {
    case kBasket:
      err = launch_basket(a, dims, blocks, s, n_paths, args...);
      break;
    case kEulerGbm:
    case kTermGbm:
    case kVasicek:
    case kCir:
    case kHullWhite:
    case kG2pp:
      err = launch_rates(process, a, dims, blocks, s, n_paths, args...);
      break;
    case kTermBasket:
      err = launch_term_basket(a, dims, blocks, s, n_paths, args...);
      break;
    case kCccGarch:
      err = launch_ccc_garch(a, dims, blocks, s, n_paths, args...);
      break;
    case kDccGarch:
      err = launch_dcc_garch(a, dims, blocks, s, n_paths, args...);
      break;
    default:
      err = launch_functor<Launcher>(process, dims, a, blocks, s, n_paths,
                                     args...);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace mcf

// Every entry takes the process code and its dimension `dims` (the basket's
// asset count, GARCH's table length, VG's quantile-table length, the
// surfaces' row count, the curve length of term-structure GBM and
// Hull-White, CCC's and DCC's asset count A, the term basket's A + 16 n;
// ignored by the other processes) after the leaves, and after
// the key words the draw source (DrawSource): `source`, `antithetic`
// (Threefry only), the Sobol table `sv` (n_dims, 30) for kSobol and
// kBridge, and for kBridge the plan's weights `plan_coeffs` (>= n_steps
// rows of `width` <= mc::kMaxLevels slots) and its load schedule
// `plan_sched` (rng/sobol.py::bridge_schedule over the bridge's `bridge_T`
// dims).
// Unused pointers are null.  The leaves are device memory, but CCC's and
// DCC's launch leaves are host memory: their launch copies them into the
// kernel's parameters (csrc/fused_mgarch.cuh).
#define MC_DRAW_PARAMS                                                      \
  int source, int antithetic, const uint32_t *sv, const float *plan_coeffs, \
      const uint32_t *plan_sched, int bridge_T, int width
#define MC_DRAW_ARGS                                                       \
  mcf::DrawArgs {                                                          \
    source, antithetic, sv, plan_coeffs, plan_sched, bridge_T, width       \
  }
