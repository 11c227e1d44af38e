// K2, K3 and K4 — the process-generic fused time loop.
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas (K2,
// _make_kernel with payoff_fn=None), ::fused_block_moments_pallas (K3,
// _make_kernel with a payoff epilogue) and ::fused_functionals_pallas (K4,
// _make_functional_kernel).  Every kernel is a template over a process
// functor (GbmProc, HestonProc, BasketProc<16>, BasketProc<128>,
// GarchProc, MertonProc, KouProc, BatesProc, NigProc, HestonQEProc,
// BatesQEProc, VgProc, SabrProc, LocalVolProc, SlvProc, SlvKnotsProc) and a
// draw source: init from the process leaves, then the draw source's time
// loop calls step(t, eps) for every step in order, and prices come at the
// end.  SlvProc's per-step leverage row is the port of the JAX kernels'
// KernelRows (ops/fused_engine.py:44-66, the dynamic ref slice of a
// kernel_rows_field leaf): a pointer and a clamped row offset.  Draw
// sources:
//   ThreefryDraws<Antithetic>: per pair of steps one draws_pair (the two
//     steps share their cipher calls; each process keeps the JAX
//     package's layout of normals and uniforms, uniforms on their own key
//     streams k1 ^ C), the process's own per-draw antithetic mirror on odd
//     path ids (a normal negated, a uniform reflected 1 - u), the odd
//     final step never taken;
//   SobolDraws (rng/sobol.py::SobolDeviceSampler.draws_kernel): the
//     randomized Sobol normal of dimension t * D + d from the direction
//     table;
//   BridgeDraws (SobolBridgeKernelSampler with _bridge_fill_scratch and
//     _bridge_step_draws): the T bridge normals once per path into a
//     scratch, then per step the plan's weighted sum of O(log T) of them.
//   fused_kernel<Proc, Draws, Epilogue>: the epilogue stores the
//     terminal price (K2) or applies a vanilla payoff and writes (mean, M2)
//     per 128-path row (K3).
//   fused_functional_kernel<Proc, Draws>: K4 folds up to four path
//     functionals (FunctionalCode, with float32 parameters folded on the
//     host) after every step, the scan engine's order, and writes the
//     terminal prices and each finalized functional.
//
// Bounds on the H100: compute — integer ALU for Threefry, the SFU for
// log/sqrt/sin/cos; K2 writes 4 bytes per path, K3 8 bytes per 128 paths,
// K4 4 bytes per path per output; a basket takes A cipher calls per pair
// of steps and A(A+1)/2 multiplies and A(A-1)/2 adds per step (the
// unrolled Cholesky),
// its parameters read from the leaves through L1 by every thread; GARCH
// one cipher call per pair of steps and, per step, one table read through
// the read-only cache (the 5-year table is 5 KB), a sqrt and 9 float32
// operations.  The jump and Levy processes add uniform cipher calls on
// their second streams and per step the truncated Poisson's four selects,
// Kou four log32 (one per jump size), the QE step ndtri32 and two log32,
// VG ndtri32, three log32, two exp32 and four table reads (two 2 KB
// tables through the read-only cache), SABR two exp32 and a log32.  The
// local-vol surfaces add per step one or two IEEE divisions (the
// log-moneyness coordinate; the time-knot coordinate of a blended surface)
// and two (an exact SLV row) or four (a blend of two knots) table reads
// through the read-only cache, the same addresses for every thread.  A
// Sobol draw is integer work per dimension (a Threefry call for the Owen
// key, the Gray-code XOR over the set bits, the hash's four multiplies and
// two bit reversals) plus ndtri32's rationals, log and sqrt; the bridge
// adds 2L float32 operations per step, T scratch writes and L scratch
// reads per step.  Design:
// one thread per path with the state and the functional accumulators (at
// most 4 x 4 floats, statically indexed so they stay in registers) in
// registers for the whole time loop (a basket of more than 16 assets keeps
// its 128-slot state in local memory);
// the functional code is a kernel argument, so its switch branches the
// same way across a warp.  K3 uses one 128-thread block per row and sums
// it in the fixed adjacent-pair tree of stats/welford.py::tree_sum (warp
// butterfly at offsets 1..16, then (w0+w1)+(w2+w3)), which the plain
// version reproduces bitwise.  The row -> 4096-path merge stays in torch.
//
// Numerics: built with -fmad=false and the default -prec-div=true,
// -prec-sqrt=true (ops/_build.py, never fast math), so every a*b+c rounds
// twice and every division and sqrtf is the IEEE result, as in the torch
// plain versions and the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rng.cuh"
#include "surface.cuh"

namespace {

constexpr int kRow = 128;  // paths per stats row = K3's block size

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

// Process codes: the index in ops/fused_engine.py::PROCESS_CODES.
enum ProcessCode {
  kGbm = 0,
  kHeston = 1,
  kBasket = 2,
  kGarch = 3,
  kMerton = 4,
  kKou = 5,
  kBates = 6,
  kNig = 7,
  kHestonQE = 8,
  kBatesQE = 9,
  kVg = 10,
  kSabr = 11,
  kLocalVol = 12,
  kSlv = 13,
  kSlvKnots = 14,
};

constexpr int kBasketSmall = 16;   // register-resident basket capacity
constexpr int kBasketMax = 128;    // local-memory capacity: MAX_ASSETS

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

// Correlated GBM basket (processes/basket.py), A <= kCap assets:
// leaves = [s0 (A), mu (A), sigma (A), chol_flat (A*A, row-major), weights
// (A), dt].  The state is kCap log prices statically indexed under full
// unrolling at kCap = 16, so it stays in registers; kCap = 128 keeps rolled
// loops and local memory (slow but right).  Every loop is guarded by the
// runtime A: the draws, the counters and the sums never depend on kCap.
template <int kCap>
struct BasketProc {
  static constexpr int kDraws = kCap;
  static constexpr int kUnroll = kCap <= kBasketSmall ? kCap : 1;
  struct State {
    float log_s[kCap];
  };
  const float* s0;
  const float* chol;
  const float* w;
  int A;
  float drift[kCap], scale[kCap];
  __device__ BasketProc(const float* leaves, int n_assets) : A(n_assets) {
    s0 = leaves;
    const float* mu = leaves + A;
    const float* sigma = leaves + 2 * A;
    chol = leaves + 3 * A;
    w = chol + A * A;
    const float dt = w[A];
    const float sq_dt = sqrtf(dt);
#pragma unroll(kUnroll)
    for (int a = 0; a < kCap; ++a) {
      if (a < A) {
        drift[a] = (mu[a] - 0.5f * (sigma[a] * sigma[a])) * dt;
        scale[a] = sigma[a] * sq_dt;
      }
    }
  }
  __device__ int draws() const { return A; }
  __device__ static float mirror(int, float e) { return -e; }
  // NormalDrawsMixin.draws_pair with the runtime A: calls j*A + c, c < A,
  // flattened to flat[0:2A]; eps0 = flat[0:A], eps1 = flat[A:2A].  Split
  // by the parity of A so every slot index is static after unrolling: an
  // odd A's middle call gives eps0[A-1] and eps1[0].
  __device__ void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                             uint32_t j, float* eps0, float* eps1) const {
    const uint32_t base = j * (uint32_t)A;
    float z0, z1;
#pragma unroll(kUnroll)
    for (int p = 0; p < kCap / 2; ++p) {
      if (2 * p < A) {
        normal(k0, k1, id, base + (uint32_t)p, &z0, &z1);
        eps0[2 * p] = z0;
        if (2 * p + 1 < A) {
          eps0[2 * p + 1] = z1;
        } else {
          eps1[0] = z1;
        }
      }
    }
    const uint32_t half = base + (uint32_t)((A + 1) / 2);
    if ((A & 1) == 0) {
#pragma unroll(kUnroll)
      for (int p = 0; p < kCap / 2; ++p) {
        if (2 * p < A) {
          normal(k0, k1, id, half + (uint32_t)p, &z0, &z1);
          eps1[2 * p] = z0;
          eps1[2 * p + 1] = z1;
        }
      }
    } else {
#pragma unroll(kUnroll)
      for (int p = 0; p < kCap / 2; ++p) {
        if (2 * p + 1 < A) {
          normal(k0, k1, id, half + (uint32_t)p, &z0, &z1);
          eps1[2 * p + 1] = z0;
          if (2 * p + 2 < A && 2 * p + 2 < kCap) eps1[2 * p + 2] = z1;
        }
      }
    }
  }
  __device__ static void normal(uint32_t k0, uint32_t k1, uint32_t id,
                                uint32_t c, float* z0, float* z1) {
    uint32_t b0, b1;
    mc::threefry2x32(k0, k1, id, c, &b0, &b1);
    mc::boxmuller_pair(b0, b1, z0, z1);
  }
  __device__ State init() const {
    State s;
#pragma unroll(kUnroll)
    for (int a = 0; a < kCap; ++a) {
      if (a < A) s.log_s[a] = mc::log32(s0[a]);
    }
    return s;
  }
  // zc_a = L[a,0] z_0 + ... + L[a,a] z_a, left to right; grouped increment.
  __device__ State step(const State& s, const float* eps) const {
    State out;
#pragma unroll(kUnroll)
    for (int a = 0; a < kCap; ++a) {
      if (a < A) {
        const float* row = chol + a * A;
        float zc = row[0] * eps[0];
#pragma unroll(kUnroll)
        for (int b = 1; b <= a; ++b) zc = zc + row[b] * eps[b];
        out.log_s[a] = s.log_s[a] + (drift[a] + scale[a] * zc);
      }
    }
    return out;
  }
  // The basket value, summed over the assets in order.
  __device__ float prices(const State& s) const {
    float out = w[0] * mc::exp32(s.log_s[0]);
#pragma unroll(kUnroll)
    for (int a = 1; a < kCap; ++a) {
      if (a < A) out = out + w[a] * mc::exp32(s.log_s[a]);
    }
    return out;
  }
  __device__ float log_prices(const State& s) const {
    return mc::log32(prices(s));
  }
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

// The QE-M variance transition and martingale-corrected drift constant
// (processes/heston_qe.py::QEVarianceMixin) from the nine QE leaves q =
// [e_kdt, c1, c2, k0, k1, k2, k3, k4, mgf_a] and theta.  Both branches are
// computed and selected, as the plain version's selects do.
struct QECore {
  float theta, e_kdt, c1, c2, k0, k1, k2, k3, k4, A, two_A, head_c;
  __device__ QECore(float theta_, const float* q)
      : theta(theta_), e_kdt(q[0]), c1(q[1]), c2(q[2]), k0(q[3]), k1(q[4]),
        k2(q[5]), k3(q[6]), k4(q[7]), A(q[8]) {
    two_A = 2.0f * A;
    head_c = -(k1 + 0.5f * k3);
  }
  // v' from (v, u); *k0s the per-path K0*, *sq = sqrt(k3 v + k4 v') (0
  // where that is not positive).
  __device__ float step(float v, float u, float* k0s, float* sq) const {
    const float m = theta + (v - theta) * e_kdt;
    const float s2 = v * c1 + c2;
    const float m2 = m * m;
    const bool quad = s2 <= 1.5f * m2;
    const float inv2 = (2.0f * m2) / s2;
    const float tw1 = fmaxf(inv2 - 1.0f, 0.0f);
    const float b2 = fmaxf((inv2 - 1.0f) + sqrtf(inv2 * tw1), 0.0f);
    const float a = m / (1.0f + b2);
    const float zq = sqrtf(b2) + mc::ndtri32(u);
    const float v_quad = a * (zq * zq);
    const float p = (s2 - m2) / (s2 + m2);
    const float beta = (1.0f - p) / m;
    const float tail = mc::log32((1.0f - p) / (1.0f - u)) / beta;
    const float v_exp = u <= p ? 0.0f : fmaxf(tail, 0.0f);
    const float v_new = quad ? v_quad : v_exp;
    // K0* (one log32 on the branch's argument).
    const float den = 1.0f - two_A * a;
    const bool ok_q = den > 0.0f;
    const float den_s = ok_q ? den : 1.0f;
    const float gap = beta - A;
    const bool ok_e = gap > 0.0f;
    const float mgf_e =
        fmaxf(p + (beta * (1.0f - p)) / (ok_e ? gap : 1.0f), 1e-30f);
    const float lg = mc::log32(quad ? den_s : mgf_e);
    const float lm = quad ? ((A * b2) * a) / den_s - 0.5f * lg : lg;
    const bool ok = quad ? ok_q : ok_e;
    *k0s = ok ? head_c * v - lm : k0;
    const float var_s = k3 * v + k4 * v_new;
    *sq = var_s > 0.0f ? sqrtf(var_s) : 0.0f;
    return v_new;
  }
};

// Heston under QE-M (processes/heston_qe.py): leaves = [s0, v0, mu, kappa,
// theta, xi, rho, dt, e_kdt, c1, c2, k0, k1, k2, k3, k4, mgf_a]; draws (z,
// u_variance): the halves of counter j on the main and variance streams.
struct HestonQEProc : MixedDraws<2, 0b10u> {
  using State = LogVarState;
  float log_s0, v0, mu_dt;
  QECore qe;
  __device__ HestonQEProc(const float* leaves, int)
      : qe(leaves[4], leaves + 8) {
    log_s0 = mc::log32(leaves[0]);
    v0 = leaves[1];
    mu_dt = leaves[2] * leaves[7];
  }
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    normal_pair(k0, k1, id, j, &eps0[0], &eps1[0]);
    uniform_pair(k0, k1 ^ kVStream, id, j, &eps0[1], &eps1[1]);
  }
  __device__ State init() const { return State{log_s0, v0}; }
  __device__ State step(State s, const float* eps) const {
    float k0s, sq;
    const float v_new = qe.step(s.v, eps[1], &k0s, &sq);
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
  QECore qe;
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
    normal_pair(k0, k1, id, 2u * j, &eps0[0], &eps0[3]);
    normal_pair(k0, k1, id, 2u * j + 1u, &eps1[0], &eps1[3]);
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
// dt, gq_z0, gq_dz, gq_resid (n), gq_dresid (n)], n = dims; draws (u_w,
// u_boost, z).  The subordinator increment is nu times
// mc::gamma_from_uniforms_table32 over the tables, read through the
// read-only cache.
struct VgProc : MixedDraws<3, 0b011u> {
  using State = LogState;
  const float* resid;
  const float* dresid;
  int n;
  float log_s0, drift, sigma, theta, nu, a, z0, dz;
  __device__ VgProc(const float* leaves, int n_table)
      : resid(leaves + 8), dresid(leaves + 8 + n_table), n(n_table) {
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
    normal_pair(k0, k1, id, j, &eps0[2], &eps1[2]);
    uniform_pair(k0, k1 ^ kVgStream, id, 2u * j, &eps0[0], &eps0[1]);
    uniform_pair(k0, k1 ^ kVgStream, id, 2u * j + 1u, &eps1[0], &eps1[1]);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps) const {
    const float g = nu * mc::gamma_from_uniforms_table32(
                             a, eps[0], eps[1], z0, dz, resid, dresid, n);
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
// The functors whose step reads the step index t (a time-dependent surface)
// derive from TimedStep; step_at hands t to them and not to the others.
// Their knot-grid reads are surface.cuh's.
struct TimedStep {};

// Local volatility (processes/local_vol.py): leaves = [s0, rate, dt, x0, dx,
// dt_knot, vol_flat (n_tk * 128)], n_tk = dims >= 2 time knots.  Per step
// sigma = the t-blended surface at x = log_s - log32(s0), then the GBM
// increment ((rate - 0.5 sigma^2) dt + (sigma sqrt(dt)) z), grouped before
// the add.
struct LocalVolProc : NormalDraws<1>, TimedStep {
  using State = LogState;
  const float* vol;
  int n_tk;
  float log_s0, rate, dt, sq_dt, x0, dx, dt_knot;
  __device__ LocalVolProc(const float* leaves, int n)
      : vol(leaves + 6), n_tk(n) {
    log_s0 = mc::log32(leaves[0]);
    rate = leaves[1];
    dt = leaves[2];
    x0 = leaves[3];
    dx = leaves[4];
    dt_knot = leaves[5];
    sq_dt = sqrtf(dt);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps, int t) const {
    const float u = mc::knot_time(t, dt, dt_knot, n_tk);
    const float sig =
        mc::interp_blend(vol, n_tk, u, s.log_s - log_s0, x0, dx);
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

// SLV on hat-blended time knots (processes/slv.py::SLVKnots): leaves =
// [..., x0, dx, dt_knot, lev_flat (n_tk * 128)], n_tk = dims >= 2.
struct SlvKnotsProc : SlvStep<SlvKnotsProc> {
  const float* lev;
  int n_tk;
  float dt_knot;
  __device__ SlvKnotsProc(const float* leaves, int n)
      : SlvStep<SlvKnotsProc>(leaves), lev(leaves + 11), n_tk(n),
        dt_knot(leaves[10]) {}
  __device__ float at(float x, int t) const {
    return mc::interp_blend(lev, n_tk, mc::knot_time(t, dt, dt_knot, n_tk), x,
                            x0, dx);
  }
};

// Step t of a path: a TimedStep functor gets t, the others the draws only.
template <class Proc>
__device__ __forceinline__ typename Proc::State step_at(
    const Proc& proc, const typename Proc::State& s, const float* eps, int t) {
  if constexpr (std::is_base_of<TimedStep, Proc>::value) {
    return proc.step(s, eps, t);
  } else {
    return proc.step(s, eps);
  }
}

// ---- Draw sources ------------------------------------------------------------
//
// A draw source is the time loop of one path: run(proc, k0, k1, id, i,
// n_steps, step) calls step(t, eps) once for each t = 0 .. n_steps - 1, in
// order, with the innovations of step t.  The codes are
// ops/fused_engine.py's THREEFRY, SOBOL and BRIDGE.
enum DrawSource { kThreefry = 0, kSobol = 1, kBridge = 2 };

// The process's own Threefry draws: per pair of steps one draws_pair (the
// two steps share their cipher calls), mirrored by the process on odd ids
// for antithetic runs; the odd final step is never taken.
template <bool Antithetic>
struct ThreefryDraws {
  template <class Proc, class Step>
  __device__ void run(const Proc& proc, uint32_t k0, uint32_t k1,
                      uint32_t id, int64_t, int n_steps, Step step) const {
    constexpr int D = Proc::kDraws;
    // Antithetic: path 2k+1 mirrors path 2k (draws keyed by the pair id).
    const uint32_t draw_id = Antithetic ? id >> 1 : id;
    const bool mirror = Antithetic && (id & 1u);
    const int n_pairs = (n_steps + 1) / 2;
    for (int j = 0; j < n_pairs; ++j) {
      float eps0[D], eps1[D];
      proc.draws_pair(k0, k1, draw_id, (uint32_t)j, eps0, eps1);
      if (mirror) {
#pragma unroll(Proc::kUnroll)
        for (int d = 0; d < D; ++d) {
          if (d < proc.draws()) {
            eps0[d] = Proc::mirror(d, eps0[d]);
            eps1[d] = Proc::mirror(d, eps1[d]);
          }
        }
      }
      step(2 * j, eps0);
      if (2 * j + 1 < n_steps) step(2 * j + 1, eps1);
    }
  }
};

// rng/sobol.py::SobolDeviceSampler.draws_kernel: draw d of step t is the
// randomized Sobol normal of dimension t * D + d, read from the (n_dims, 30)
// table.  JAX's kernel keeps its pair loop and evaluates the draws of the
// dropped odd final step t = n_steps (its one-hot table read gives 0 past
// the table); the draws are pure functions of (id, dim), so running the
// steps one by one and never evaluating that step gives the same bits and
// never reads past a table built for exactly n_steps.
struct SobolDraws {
  const uint32_t* __restrict__ sv;
  template <class Proc, class Step>
  __device__ void run(const Proc& proc, uint32_t k0, uint32_t k1,
                      uint32_t id, int64_t, int n_steps, Step step) const {
    constexpr int D = Proc::kDraws;
    const int nd = proc.draws();
    for (int t = 0; t < n_steps; ++t) {
      float eps[D];
#pragma unroll(Proc::kUnroll)
      for (int d = 0; d < D; ++d) {
        if (d < nd) {
          eps[d] = mc::sobol_normal(sv, k0, k1, id, (uint32_t)(t * nd + d));
        }
      }
      step(t, eps);
    }
  }
};

// rng/sobol.py::SobolBridgeKernelSampler with ops/fused_engine.py::
// _bridge_fill_scratch and _bridge_step_draws.  Phase 1 writes the T bridge
// normals of the path to its scratch column; phase 2 takes, per step, eps =
// 0 + c_0 z[d_0] + ... + c_{L-1} z[d_{L-1}] over every padded plan slot in
// order (the padding is (dim 0, coeff 0), kept so the sum rounds as JAX's).
// The scratch is a global workspace laid out [dim][path] (stride gridDim.x *
// blockDim.x: a warp's accesses are coalesced).  Each thread reads only its
// own column, so no barrier is needed.
struct BridgeDraws {
  const uint32_t* __restrict__ sv;     // (T, 30)
  const int* __restrict__ dims;        // (n_plan, L) plan dims
  const float* __restrict__ coeffs;    // (n_plan, L) plan weights
  int T, L;
  float* scratch;                      // (T, blocks * 128) workspace
  template <class Proc, class Step>
  __device__ void run(const Proc&, uint32_t k0, uint32_t k1, uint32_t id,
                      int64_t i, int n_steps, Step step) const {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    float* z = scratch + i;
    for (int d = 0; d < T; ++d) {
      z[d * stride] = mc::sobol_normal(sv, k0, k1, id, (uint32_t)d);
    }
    for (int t = 0; t < n_steps; ++t) {
      const int* row_d = dims + (int64_t)t * L;
      const float* row_c = coeffs + (int64_t)t * L;
      float e = 0.0f;
      for (int j = 0; j < L; ++j) e = e + row_c[j] * z[row_d[j] * stride];
      float eps[Proc::kDraws];
      eps[0] = e;
      step(t, eps);
    }
  }
};

// The draw-source arguments of every entry (ops/fused_engine.py::
// _draw_args): the source code, the antithetic flag (Threefry only), the
// Sobol table, and the bridge plan with its scratch.
struct DrawArgs {
  int source;
  int antithetic;
  const uint32_t* sv;
  const int* dims;
  const float* coeffs;
  int T, L;
  float* scratch;
};

struct StoreTerminal {  // K2
  float* out;
  __device__ void operator()(int64_t i, bool active, float price) const {
    if (active) out[i] = price;
  }
};

// Sum over the 128 threads of a block in tree_sum's adjacent-pair order.
// Every thread gets the total.
__device__ float row_tree_sum(float v, float* partial) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[warp] = v;
  __syncthreads();
  const float total = (partial[0] + partial[1]) + (partial[2] + partial[3]);
  __syncthreads();  // partial[] is reused by the next call
  return total;
}

struct RowMoments {  // K3
  float* rows;       // (n_paths / 128, 2): mean, M2
  int payoff;        // 0 call, 1 put, 2 digital (engine/payoffs.py)
  float strike;
  __device__ void operator()(int64_t, bool, float price) const {
    __shared__ float partial[kRow / 32];
    float pay;
    if (payoff == 0) {
      pay = fmaxf(price - strike, 0.0f);
    } else if (payoff == 1) {
      pay = fmaxf(strike - price, 0.0f);
    } else {
      pay = price > strike ? 1.0f : 0.0f;
    }
    const float mean = row_tree_sum(pay, partial) / (float)kRow;
    const float d = pay - mean;
    const float m2 = row_tree_sum(d * d, partial);
    if (threadIdx.x == 0) {
      rows[2 * blockIdx.x] = mean;
      rows[2 * blockIdx.x + 1] = m2;
    }
  }
};

template <class Proc, class Draws, class Epilogue>
__global__ void fused_kernel(const float* __restrict__ leaves, int dims,
                             int64_t n_paths, int n_steps,
                             uint32_t path_offset, uint32_t k0, uint32_t k1,
                             Draws draws, Epilogue epilogue) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_paths;
  const Proc proc(leaves, dims);
  typename Proc::State state = proc.init();
  if (active) {
    const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
    draws.run(proc, k0, k1, id, i, n_steps, [&](int t, const float* eps) {
      state = step_at(proc, state, eps, t);
    });
  }
  epilogue(i, active, proc.prices(state));
}

// ---- K4: path functionals --------------------------------------------------

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

__device__ __forceinline__ bool log_space(int code) {
  return code == kGeoMean || code == kRunningMax || code == kRunningMin ||
         code == kBarrierUp || code == kRealizedVar;
}

// init(obs0) of engine/functionals.py.
__device__ __forceinline__ void fn_init(int code, const float* p, float obs,
                                        float* acc) {
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
__device__ __forceinline__ void fn_update(int code, int period,
                                          const float* p, float obs, int t,
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
__device__ __forceinline__ float fn_finalize(int code, const float* p,
                                             const float* acc, int n_steps) {
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

template <class Proc, class Draws>
__global__ void fused_functional_kernel(const float* __restrict__ leaves,
                                        int dims, int64_t n_paths,
                                        int n_steps, uint32_t path_offset,
                                        uint32_t k0, uint32_t k1,
                                        Draws draws, FunctionalSpec spec,
                                        float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  const Proc proc(leaves, dims);
  bool need_price = false;
#pragma unroll
  for (int k = 0; k < kMaxFunctionals; ++k) {
    if (k < spec.n && !log_space(spec.code[k])) need_price = true;
  }
  // The observation of functional k: the price or the log price.
  auto observe = [&](const typename Proc::State& s, float* obs) {
    const float price = need_price ? proc.prices(s) : 0.0f;
    const float logp = proc.log_prices(s);
#pragma unroll
    for (int k = 0; k < kMaxFunctionals; ++k) {
      obs[k] = log_space(spec.code[k]) ? logp : price;
    }
  };
  float acc[kMaxFunctionals][4];
  float obs[kMaxFunctionals];
  typename Proc::State state = proc.init();
  observe(state, obs);
#pragma unroll
  for (int k = 0; k < kMaxFunctionals; ++k) {
    if (k < spec.n) fn_init(spec.code[k], spec.p[k], obs[k], acc[k]);
  }
  auto update_all = [&](int t) {
    observe(state, obs);
#pragma unroll
    for (int k = 0; k < kMaxFunctionals; ++k) {
      if (k < spec.n) {
        fn_update(spec.code[k], spec.period[k], spec.p[k], obs[k], t, acc[k]);
      }
    }
  };
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  // One update after every step, with the 1-based step index (the scan
  // engine's order, which JAX's pair and bridge loops both keep).
  draws.run(proc, k0, k1, id, i, n_steps, [&](int t, const float* eps) {
    state = step_at(proc, state, eps, t);
    update_all(t + 1);
  });
  out[i] = proc.prices(state);
#pragma unroll
  for (int k = 0; k < kMaxFunctionals; ++k) {
    if (k < spec.n) {
      out[(k + 1) * spec.out_stride + i] =
          fn_finalize(spec.code[k], spec.p[k], acc[k], n_steps);
    }
  }
}

// Which draw sources a functor takes: Sobol normals need an all-normal
// process (GARCH's draw is a uniform, and so are some of every MixedDraws
// process's: rng/sobol.py refuses them too); the bridge a single draw
// (GBM, or a basket of one asset, checked at run time).
template <class Proc>
struct SourceTraits {
  static constexpr bool kSobol = true;
  static constexpr bool kBridge = false;
};
struct ThreefryOnly {
  static constexpr bool kSobol = false;
  static constexpr bool kBridge = false;
};
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
struct SourceTraits<BasketProc<kBasketSmall>> {
  static constexpr bool kSobol = true;
  static constexpr bool kBridge = true;
};
template <>
struct SourceTraits<GarchProc> {
  static constexpr bool kSobol = false;
  static constexpr bool kBridge = false;
};

// Instantiates `Launcher<Proc, Draws>` for the draw source of `a` and
// launches it; a source the functor does not take is an invalid value.
template <template <class, class> class Launcher, class Proc, class... Args>
cudaError_t launch_source(const DrawArgs& a, int dims, unsigned blocks,
                          cudaStream_t s, Args... args) {
  switch (a.source) {
    case kThreefry:
      if (a.antithetic) {
        return Launcher<Proc, ThreefryDraws<true>>::run(
            blocks, s, dims, ThreefryDraws<true>{}, args...);
      }
      return Launcher<Proc, ThreefryDraws<false>>::run(
          blocks, s, dims, ThreefryDraws<false>{}, args...);
    case kSobol:
      if constexpr (SourceTraits<Proc>::kSobol) {
        if (a.sv == nullptr) return cudaErrorInvalidValue;
        return Launcher<Proc, SobolDraws>::run(blocks, s, dims,
                                               SobolDraws{a.sv}, args...);
      }
      return cudaErrorInvalidValue;
    case kBridge:
      if constexpr (SourceTraits<Proc>::kBridge) {
        if (a.sv == nullptr || a.dims == nullptr || a.coeffs == nullptr ||
            a.scratch == nullptr || a.T < 1 || a.L < 1 ||
            (dims != 1 && Proc::kDraws != 1)) {
          return cudaErrorInvalidValue;
        }
        return Launcher<Proc, BridgeDraws>::run(
            blocks, s, dims,
            BridgeDraws{a.sv, a.dims, a.coeffs, a.T, a.L, a.scratch},
            args...);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// Picks the functor for the process code (and the basket capacity that
// holds `dims` assets) and launches it with one thread per path.
template <template <class, class> class Launcher, class... Args>
int dispatch(int process, int dims, const DrawArgs& a, int64_t n_paths,
             void* stream, Args... args) {
  const unsigned blocks = (unsigned)((n_paths + kRow - 1) / kRow);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (process) {
    case kGbm:
      err = launch_source<Launcher, GbmProc>(a, dims, blocks, s, n_paths,
                                             args...);
      break;
    case kHeston:
      err = launch_source<Launcher, HestonProc>(a, dims, blocks, s,
                                                n_paths, args...);
      break;
    case kGarch:
      if (dims < 1) return (int)cudaErrorInvalidValue;
      err = launch_source<Launcher, GarchProc>(a, dims, blocks, s, n_paths,
                                               args...);
      break;
    case kMerton:
      err = launch_source<Launcher, MertonProc>(a, dims, blocks, s, n_paths,
                                                args...);
      break;
    case kKou:
      err = launch_source<Launcher, KouProc>(a, dims, blocks, s, n_paths,
                                             args...);
      break;
    case kBates:
      err = launch_source<Launcher, BatesProc>(a, dims, blocks, s, n_paths,
                                               args...);
      break;
    case kNig:
      err = launch_source<Launcher, NigProc>(a, dims, blocks, s, n_paths,
                                             args...);
      break;
    case kHestonQE:
      err = launch_source<Launcher, HestonQEProc>(a, dims, blocks, s,
                                                  n_paths, args...);
      break;
    case kBatesQE:
      err = launch_source<Launcher, BatesQEProc>(a, dims, blocks, s,
                                                 n_paths, args...);
      break;
    case kVg:
      if (dims < 2) return (int)cudaErrorInvalidValue;
      err = launch_source<Launcher, VgProc>(a, dims, blocks, s, n_paths,
                                            args...);
      break;
    case kSabr:
      err = launch_source<Launcher, SabrProc>(a, dims, blocks, s, n_paths,
                                              args...);
      break;
    case kLocalVol:
      if (dims < 2) return (int)cudaErrorInvalidValue;
      err = launch_source<Launcher, LocalVolProc>(a, dims, blocks, s,
                                                  n_paths, args...);
      break;
    case kSlv:
      if (dims < 1) return (int)cudaErrorInvalidValue;
      err = launch_source<Launcher, SlvProc>(a, dims, blocks, s, n_paths,
                                             args...);
      break;
    case kSlvKnots:
      if (dims < 2) return (int)cudaErrorInvalidValue;
      err = launch_source<Launcher, SlvKnotsProc>(a, dims, blocks, s,
                                                  n_paths, args...);
      break;
    case kBasket:
      if (dims < 1 || dims > kBasketMax) return (int)cudaErrorInvalidValue;
      if (dims <= kBasketSmall) {
        err = launch_source<Launcher, BasketProc<kBasketSmall>>(
            a, dims, blocks, s, n_paths, args...);
      } else {
        err = launch_source<Launcher, BasketProc<kBasketMax>>(
            a, dims, blocks, s, n_paths, args...);
      }
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class Epilogue>
struct FusedLauncher {
  template <class Proc, class Draws>
  struct With {
    static cudaError_t run(unsigned blocks, cudaStream_t s, int dims,
                           Draws draws, int64_t n_paths, const float* leaves,
                           int n_steps, uint32_t path_offset, uint32_t k0,
                           uint32_t k1, Epilogue epilogue) {
      fused_kernel<Proc, Draws, Epilogue><<<blocks, kRow, 0, s>>>(
          leaves, dims, n_paths, n_steps, path_offset, k0, k1, draws,
          epilogue);
      return cudaSuccess;
    }
  };
};

template <class Proc, class Draws>
struct FunctionalLauncher {
  static cudaError_t run(unsigned blocks, cudaStream_t s, int dims,
                         Draws draws, int64_t n_paths, const float* leaves,
                         int n_steps, uint32_t path_offset, uint32_t k0,
                         uint32_t k1, FunctionalSpec spec, float* out) {
    fused_functional_kernel<Proc, Draws><<<blocks, kRow, 0, s>>>(
        leaves, dims, n_paths, n_steps, path_offset, k0, k1, draws, spec,
        out);
    return cudaSuccess;
  }
};

}  // namespace

// Every entry takes the process code and its dimension `dims` (the basket's
// asset count, GARCH's table length, VG's quantile-table length; ignored by
// the other processes) after the leaves, and after the key words the draw
// source (DrawSource): `source`, `antithetic` (Threefry only), the Sobol
// table `sv` (n_dims, 30) for kSobol and kBridge, and for kBridge the plan
// `plan_dims`/`plan_coeffs` (>= n_steps rows of `width`), the bridge's
// `bridge_T` dims and its scratch, a float workspace of bridge_T *
// ceil(n_paths / 128) * 128 entries (the wrapper launches at most 2^20
// paths at a time on it).
// Unused pointers are null.
#define MC_DRAW_PARAMS                                                   \
  int source, int antithetic, const uint32_t *sv, const int *plan_dims, \
      const float *plan_coeffs, int bridge_T, int width, float *scratch
#define MC_DRAW_ARGS                                                 \
  DrawArgs {                                                         \
    source, antithetic, sv, plan_dims, plan_coeffs, bridge_T, width, \
        scratch                                                      \
  }

// K2: terminal prices, out (n_paths,).
extern "C" int mc_fused_terminal(float* out, const float* leaves,
                                 int process, int dims, int64_t n_paths,
                                 int64_t n_steps, uint32_t path_offset,
                                 uint32_t k0, uint32_t k1, MC_DRAW_PARAMS,
                                 void* stream) {
  return dispatch<FusedLauncher<StoreTerminal>::With>(
      process, dims, MC_DRAW_ARGS, n_paths, stream, leaves, (int)n_steps,
      path_offset, k0, k1, StoreTerminal{out});
}

// K3: per-128-path-row payoff (mean, M2), rows (n_paths / 128, 2).
// n_paths must be a multiple of 128 (the wrapper checks).
extern "C" int mc_fused_block_moments(float* rows, const float* leaves,
                                      int process, int dims,
                                      int64_t n_paths, int64_t n_steps,
                                      uint32_t path_offset, uint32_t k0,
                                      uint32_t k1, MC_DRAW_PARAMS,
                                      int payoff, float strike,
                                      void* stream) {
  return dispatch<FusedLauncher<RowMoments>::With>(
      process, dims, MC_DRAW_ARGS, n_paths, stream, leaves, (int)n_steps,
      path_offset, k0, k1, RowMoments{rows, payoff, strike});
}

// K4: out (1 + n_functionals, out_stride), out_stride >= n_paths: terminal
// prices, then each finalized functional, in columns 0 .. n_paths - 1 of
// each row.  codes/periods (n_functionals,) and params (n_functionals,
// kMaxParams) are host arrays.
extern "C" int mc_fused_functionals(float* out, const float* leaves,
                                    int process, int dims, int64_t n_paths,
                                    int64_t n_steps, uint32_t path_offset,
                                    uint32_t k0, uint32_t k1, MC_DRAW_PARAMS,
                                    int n_functionals, const int* codes,
                                    const int* periods, const float* params,
                                    int64_t out_stride, void* stream) {
  if (n_functionals < 0 || n_functionals > kMaxFunctionals ||
      out_stride < n_paths) {
    return (int)cudaErrorInvalidValue;
  }
  FunctionalSpec spec = {};
  spec.out_stride = out_stride;
  spec.n = n_functionals;
  for (int k = 0; k < n_functionals; ++k) {
    spec.code[k] = codes[k];
    spec.period[k] = periods[k] < 1 ? 1 : periods[k];
    for (int q = 0; q < kMaxParams; ++q) {
      spec.p[k][q] = params[k * kMaxParams + q];
    }
  }
  return dispatch<FunctionalLauncher>(process, dims, MC_DRAW_ARGS, n_paths,
                                      stream, leaves, (int)n_steps,
                                      path_offset, k0, k1, spec, out);
}
