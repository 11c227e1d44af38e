// K2, K3 and K4 on the correlated GBM basket (processes/basket.py::
// BasketGBM): the functors, BasketFixed<A> for A = 1..16 assets, one
// instantiation per asset count, and BasketProc<128> for 17..128, and their
// launch by asset count.  The kernels, draw sources and epilogues are
// csrc/fused_engine.cuh's, the step csrc/basket_step.cuh's; each kernel's
// instantiations build in their own translation unit, in parallel
// (fused_basket.cu K2, fused_basket_k3.cu K3, fused_basket_k4.cu and
// fused_basket_k4_even.cu K4).
//
// Replaces the basket's part of montecarlo_tpu/ops/fused_engine.py::
// fused_terminal_pallas (K2), ::fused_block_moments_pallas (K3) and
// ::fused_functionals_pallas (K4), whose process is BasketGBM.step: zc_a =
// L[a,0] z_0 + ... + L[a,a] z_a, left to right, then log_s_a + (drift_a +
// scale_a zc_a), and the basket value sum_a w_a exp32(log_s_a) in order.
//
// Bounds on the H100: compute.  Per step pair of a path, A Threefry calls
// (integer ALU) and their Box-Muller (log, sqrt, sin, cos); per step A(A+1)/2
// float32 multiplies and A(A-1)/2 adds (unfused, -fmad=false) and the 3A of
// the increments; the basket value's A exp32 once per path, and in K4 once
// per observation.  K2 writes 4 bytes a path, K3 8 bytes per 128 paths.
//
// Design (BasketFixed<A>): A is a compile-time constant, so the state (A
// log prices) and the partial sums are registers indexed statically, and
// nothing is sized for more assets than the run has.  The block stages
// the constants once in shared memory (drift, scale and the factor's
// column b contiguous, 16-byte aligned; weights; log32(s0)), read at
// immediate offsets.  The draws are used in the factor's column order
// (basket_step.cuh), bitwise the plain version's sums: up to 8 assets each
// normal as its Threefry call makes it (step 2j whole, and observed by K4,
// before the calls that feed only step 2j+1 are made); past 8, where the
// fully unrolled stream of A calls measured slower, a rolled loop of calls
// first stages the pair's 2A normals in a shared-memory column per thread
// (bstep::staged_for).  Calls go bstep::lanes_for(A) at a time in lock
// step.  K4 takes the basket value
// once per observation and its log as log32 of it (ProcTraits::
// kLogOfPrice), what the plain version's observation is.  The Sobol source
// streams the same way, dimension t A + d in d order; the bridge-Sobol
// source (one draw) takes A = 1 only.
//
// Numerics: -fmad=false, IEEE division and sqrt (ops/_build.py).

#pragma once

#include <utility>

#include "basket_step.cuh"
#include "fused_engine.cuh"

namespace mcf {
namespace {

constexpr int kBasketMax = 128;  // processes/basket.py MAX_ASSETS

template <int A>
struct BasketFixed {
  static constexpr int kDraws = A;
  static constexpr int kUnroll = A;
  static constexpr int kLanes = bstep::lanes_for(A);
  struct State {
    float log_s[A];
  };
  const float* s;  // the staged constants (bstep::Layout<A>)
  __device__ BasketFixed(const float* staged, int) : s(staged) {}
  __device__ static void stage(float* smem, const float* leaves, int) {
    bstep::stage<A>(smem, leaves, threadIdx.x, blockDim.x);
  }
  __device__ int draws() const { return A; }
  __device__ static float mirror(int, float e) { return -e; }
  __device__ State init() const {
    State st;
    bstep::init<A>(s, st.log_s);
    return st;
  }
  __device__ State step(const State& st, const float* eps) const {
    State out = st;
    bstep::step<A>(s, eps, out.log_s);
    return out;
  }
  __device__ float prices(const State& st) const {
    return bstep::value<A>(s, st.log_s);
  }
  // Threefry: the step pairs, the draws used in column order, streamed or
  // (past 8 assets) staged in a shared-memory column per thread.
  template <bool Anti, class After>
  __device__ void run(const ThreefryDraws<Anti>&, uint32_t k0, uint32_t k1,
                      uint32_t id, int n_steps, State& st,
                      After& after) const {
    const bstep::ThreefryNormals<A> src{k0, k1,
                                        ThreefryDraws<Anti>::draw_id(id)};
    const bool mirror = ThreefryDraws<Anti>::mirrored(id);
    if constexpr (bstep::staged_for(A)) {
      __shared__ float z[2 * A * kRow];  // [normal][thread]
      bstep::run_pairs<A, kLanes>(s, st.log_s, src, mirror, n_steps, after,
                                  z + threadIdx.x, kRow);
    } else {
      bstep::run_pairs<A, kLanes>(s, st.log_s, src, mirror, n_steps, after);
    }
  }
  // Sobol: draw d of step t is the normal of dimension t A + d.
  template <class After>
  __device__ void run(const SobolDraws& d, uint32_t k0, uint32_t k1,
                      uint32_t id, int n_steps, State& st,
                      After& after) const {
    mc::SobolWarpNormals src(d.sv, k0, k1, id);
    auto normal = [&](int t, int c) {
      return src.normal((uint32_t)(t * A + c));
    };
    bstep::run_steps<A>(s, st.log_s, n_steps, normal, after);
  }
};

// The correlated GBM basket of 17..128 assets (processes/basket.py), A <=
// kCap assets: leaves = [s0 (A), mu (A), sigma (A), chol_flat (A*A,
// row-major), weights (A), dt].  Rolled loops over a kCap-slot state in
// local memory (slow but right), every loop guarded by the runtime A: the
// draws, the counters and the sums never depend on kCap.  Its log price is
// log32 of its value (ProcTraits::kLogOfPrice).
template <int kCap>
struct BasketProc {
  static constexpr int kDraws = kCap;
  static constexpr int kUnroll = kCap <= bstep::kMaxAssets ? kCap : 1;
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
};


}  // namespace

template <int A>
struct ProcTraits<BasketFixed<A>> {
  static constexpr int kShared = bstep::Layout<A>::kFloats;
  static constexpr bool kLogOfPrice = true;
};
template <int kCap>
struct ProcTraits<BasketProc<kCap>> {
  static constexpr int kShared = 0;
  static constexpr bool kLogOfPrice = true;
};
template <int A, bool Anti>
struct Streams<BasketFixed<A>, ThreefryDraws<Anti>> : std::true_type {};
template <int A>
struct Streams<BasketFixed<A>, SobolDraws> : std::true_type {};
// K4's fixed fold of the 5-asset basket Asian, under Threefry and Sobol
// draws (csrc/fused_basket_k4.cu).
template <bool Anti>
struct FixedFor<BasketFixed<5>, ThreefryDraws<Anti>, FixedFold<kArithMean>>
    : std::true_type {};
template <>
struct FixedFor<BasketFixed<5>, SobolDraws, FixedFold<kArithMean>>
    : std::true_type {};
// The bridge's single draw: a basket of one asset.
template <int A>
struct SourceTraits<BasketFixed<A>> {
  static constexpr bool kSobol = true;
  static constexpr bool kBridge = A == 1;
};

namespace {

// The asset counts of BasketFixed's instantiations in a translation unit.
template <int... As>
using Assets = std::integer_sequence<int, As...>;
using AllAssets = Assets<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16>;
// K4's, split in two units that build in parallel (fused_basket_k4.cu and
// fused_basket_k4_even.cu).
using OddAssets = Assets<1, 3, 5, 7, 9, 11, 13, 15>;
using EvenAssets = Assets<2, 4, 6, 8, 10, 12, 14, 16>;

// BasketFixed<dims>, if dims is one of As.
template <template <class, class> class Launcher, int... As, class... Args>
cudaError_t launch_fixed(Assets<As...>, const DrawArgs& a, int dims,
                         unsigned blocks, cudaStream_t s, Args... args) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((dims == As &&
          (err = launch_source<Launcher, BasketFixed<As>>(a, dims, blocks, s,
                                                         args...),
           true)) ||
         ...);
  return err;
}

// The functor for `dims` assets: BasketFixed<dims> up to
// bstep::kMaxAssets (those of `fixed`), BasketProc<kBasketMax> above.
template <template <class, class> class Launcher, int... As, class... Args>
cudaError_t launch_assets(Assets<As...> fixed, const DrawArgs& a, int dims,
                          unsigned blocks, cudaStream_t s, Args... args) {
  if (dims < 1 || dims > kBasketMax) return cudaErrorInvalidValue;
  if (dims <= bstep::kMaxAssets) {
    return launch_fixed<Launcher>(fixed, a, dims, blocks, s, args...);
  }
  return launch_source<Launcher, BasketProc<kBasketMax>>(a, dims, blocks, s,
                                                         args...);
}

}  // namespace

// K4 on an even number of assets up to bstep::kMaxAssets
// (fused_basket_k4_even.cu); the arguments of launch_basket.
cudaError_t launch_basket_even(const DrawArgs& a, int dims, unsigned blocks,
                               cudaStream_t s, int64_t n_paths,
                               const float* leaves, int n_steps,
                               uint32_t path_offset, uint32_t k0, uint32_t k1,
                               FunctionalSpec spec, float* out, int* fixed);

}  // namespace mcf
