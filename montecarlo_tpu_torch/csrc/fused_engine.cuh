// K2, K3 and K4's shared text: the draw sources, the epilogues, the kernels
// and the launch by draw source, templates over a process functor that
// csrc/fused_engine.cu (every process but the basket) and
// csrc/fused_basket.cu (the correlated basket) instantiate, each in its own
// nvcc process (ops/_build.py).
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas (K2,
// _make_kernel with payoff_fn=None), ::fused_block_moments_pallas (K3,
// _make_kernel with a payoff epilogue) and ::fused_functionals_pallas (K4,
// _make_functional_kernel).  Every kernel is a template over a process
// functor and a draw source: init from the process leaves (or from the
// constants a functor stages in shared memory), then the path's time loop
// runs every step in order, and prices come at the end.  The time loop is
// the draw source's (run_path): it calls step(t, eps) for every step with
// the innovations of step t, or, for a functor that streams its draws (the
// basket, Streams), the functor runs it itself.  Draw sources:
//   ThreefryDraws<Antithetic>: per pair of steps one draws_pair (the two
//     steps share their cipher calls; each process keeps the JAX
//     package's layout of normals and uniforms, uniforms on their own key
//     streams k1 ^ C), the process's own per-draw antithetic mirror on odd
//     path ids (a normal negated, a uniform reflected 1 - u), the odd
//     final step never taken;
//   SobolDraws (rng/sobol.py::SobolDeviceSampler.draws_kernel): the
//     randomized Sobol normal of dimension t * D + d from the direction
//     table, the warp's Gray-code walk and the block's staged Owen keys
//     (sobol_warp.cuh);
//   BridgeDraws (SobolBridgeKernelSampler with _bridge_step_draws): per
//     step the plan's weighted sum of O(log T) bridge normals, one held per
//     tree level in registers and each computed once per path, when its
//     level first needs it (bridge_levels.cuh); no scratch.
//   fused_kernel<Proc, Draws, Epilogue>: the epilogue stores the
//     terminal price (K2) or applies a vanilla payoff and writes (mean, M2)
//     per 128-path row (K3).
//   fused_functional_kernel<Proc, Draws, Fold>: K4 folds up to four path
//     functionals (csrc/functionals.cuh, with float32 parameters folded on
//     the host) after every step, the scan engine's order, and writes the
//     terminal prices and each finalized functional.  The fold is a
//     FixedFold, the set fixed at compile time (straight-line updates, only
//     the accumulators the codes use), for the sets and functors K4 is
//     built for (FixedFor), else SpecFold, the codes read from the spec.  It
//     observes the price only when a functional reads it and the log price
//     only when one reads that; a functor whose log price is log32 of its
//     price (the basket) computes its price once per observation.
//   K4 on a set of price snapshots only is a kernel of its own,
//     csrc/fused_k4_snapshot.cu's fused_snapshot_kernel over the same
//     draw sources and run_path.
//
// Design: one thread per path with the state and the functional
// accumulators in registers for the whole time loop (SpecFold's at most 4
// x 4 floats, statically indexed).  Under the Sobol sources every thread
// of a block runs its path, past n_paths too, and only the active ones
// write: their lanes shuffle with the whole warp and their blocks stage
// keys between barriers.  SpecFold's codes are kernel arguments, so its
// switch branches the same way across a warp.  K3
// uses one 128-thread block per row and sums it in the fixed adjacent-pair
// tree of stats/welford.py::tree_sum (warp butterfly at offsets 1..16, then
// (w0+w1)+(w2+w3)), which the plain version reproduces bitwise.  The row ->
// 4096-path merge stays in torch.
//
// Numerics: built with -fmad=false and the default -prec-div=true,
// -prec-sqrt=true (ops/_build.py, never fast math), so every a*b+c rounds
// twice and every division and sqrtf is the IEEE result, as in the torch
// plain versions and the JAX package.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bridge_levels.cuh"
#include "functionals.cuh"
#include "rng.cuh"
#include "sobol_warp.cuh"

namespace mcf {

constexpr int kRow = 128;  // paths per stats row = K3's block size

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
  kSlv = 13,  // also SLV on time knots, on its blended rows
  // csrc/fused_rates.cu's (launch_rates):
  kEulerGbm = 14,
  kTermGbm = 15,
  kVasicek = 16,
  kCir = 17,
  kHullWhite = 18,
  kG2pp = 19,
  // csrc/fused_term_basket{,_k4}.cu's, fused_ccc.cu's, fused_dcc{,_k4}.cu's
  // (launch_term_basket, launch_ccc_garch, launch_dcc_garch):
  kTermBasket = 20,
  kCccGarch = 21,
  kDccGarch = 22,
};

// The functors whose step reads the step index t (a time-dependent surface)
// derive from TimedStep; step_at hands t to them and not to the others.
// Their knot-grid reads are surface.cuh's.
struct TimedStep {};

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

// What a functor may declare beyond the protocol (init, step, prices,
// log_prices, draws_pair, mirror, kDraws, kUnroll), by specializing these:
//   ProcTraits<Proc>::kShared > 0: its constants, Proc::stage(smem,
//     leaves, dims) by every thread of the block, live in kShared floats of
//     shared memory, and the functor is built on them in place of the
//     leaves;
//   ProcTraits<Proc>::kLogOfPrice: its log price is log32 of its price
//     (it has no log_prices), so K4 takes the price once per observation;
//   Streams<Proc, Draws>: it runs the time loop of draw source Draws
//     itself, proc.run(draws, k0, k1, id, n_steps, state, after), calling
//     after(t) once step t is whole.
template <class Proc>
struct ProcTraits {
  static constexpr int kShared = 0;
  static constexpr bool kLogOfPrice = false;
};
template <class Proc, class Draws>
struct Streams : std::false_type {};

// ---- Draw sources ------------------------------------------------------------
//
// A draw source is the time loop of one path: run(proc, k0, k1, id, i,
// n_steps, step) calls step(t, eps) once for each t = 0 .. n_steps - 1, in
// order, with the innovations of step t.  kWholeBlock: every thread of the
// block must run it, past n_paths too (its warps shuffle and its block
// stages between barriers); the kernels then write for the active threads
// only.  The codes are ops/fused_engine.py's THREEFRY, SOBOL and BRIDGE.
enum DrawSource { kThreefry = 0, kSobol = 1, kBridge = 2 };

// The process's own Threefry draws: per pair of steps one draws_pair (the
// two steps share their cipher calls), mirrored by the process on odd ids
// for antithetic runs; the odd final step is never taken.
template <bool Antithetic>
struct ThreefryDraws {
  static constexpr bool kWholeBlock = false;  // each path on its own
  // Antithetic: path 2k+1 mirrors path 2k (draws keyed by the pair id).
  __device__ static uint32_t draw_id(uint32_t id) {
    return Antithetic ? id >> 1 : id;
  }
  __device__ static bool mirrored(uint32_t id) {
    return Antithetic && (id & 1u);
  }
  template <class Proc, class Step>
  __device__ void run(const Proc& proc, uint32_t k0, uint32_t k1,
                      uint32_t id, int64_t, int n_steps, Step step) const {
    constexpr int D = Proc::kDraws;
    const bool mirror = mirrored(id);
    const int n_pairs = (n_steps + 1) / 2;
    for (int j = 0; j < n_pairs; ++j) {
      float eps0[D], eps1[D];
      proc.draws_pair(k0, k1, draw_id(id), (uint32_t)j, eps0, eps1);
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
// never reads past a table built for exactly n_steps.  The normals are
// sobol_warp.cuh's: the warp walks the Gray code together and the block
// stages the Owen keys, so every thread of the block runs this source.
struct SobolDraws {
  static constexpr bool kWholeBlock = true;  // warp walk, staged keys
  const uint32_t* __restrict__ sv;
  template <class Proc, class Step>
  __device__ void run(const Proc& proc, uint32_t k0, uint32_t k1,
                      uint32_t id, int64_t, int n_steps, Step step) const {
    constexpr int D = Proc::kDraws;
    const int nd = proc.draws();
    mc::SobolWarpNormals src(sv, k0, k1, id);
    for (int t = 0; t < n_steps; ++t) {
      float eps[D];
#pragma unroll(Proc::kUnroll)
      for (int d = 0; d < D; ++d) {
        if (d < nd) eps[d] = src.normal((uint32_t)(t * nd + d));
      }
      step(t, eps);
    }
  }
};

// rng/sobol.py::SobolBridgeKernelSampler with ops/fused_engine.py::
// _bridge_step_draws: per step, eps = 0 + c_0 z[d_0] + ... + c_{L-1}
// z[d_{L-1}] over every plan slot in order (a padded slot's weight is 0,
// kept so the sum rounds as JAX's), the normals held one per tree level in
// registers (bridge_levels.cuh) and each computed once per path when its
// level first needs it: sobol_warp.cuh's warp walk, as
// SobolDraws', with the Owen keys of the T dims staged once per block
// (SobolStagedNormals: tree order jumps between SobolDraws' key chunks
// once T > 256).  Nothing is written to or read from global memory but
// the plan, the same rows for every thread (read-only cache).
struct BridgeDraws {
  const uint32_t* __restrict__ sv;      // (T, 30)
  const float* __restrict__ coeffs;     // (n_plan, L) plan weights
  const uint32_t* __restrict__ sched;   // (2T + 1,) load schedule
  int T, L;
  static constexpr bool kWholeBlock = true;  // warp walk, staged keys
  template <class Proc, class Step>
  __device__ void run(const Proc&, uint32_t k0, uint32_t k1, uint32_t id,
                      int64_t, int n_steps, Step step) const {
    const mc::SobolStagedNormals src(sv, k0, k1, id, T);
    auto normal = [&](uint32_t dim) { return src.normal(dim); };
    mc::BridgeLevels levels;
    const uint32_t* loads = sched + T + 1;  // after the T + 1 offsets
    const float* row = coeffs;
    uint32_t first = 0;
    for (int t = 0; t < n_steps; ++t, row += L) {
      const uint32_t next = __ldg(sched + t + 1);
      float eps[Proc::kDraws];
      eps[0] = levels.step(row, loads + first, (int)(next - first), L,
                           normal);
      first = next;
      step(t, eps);
    }
  }
};

// The draw-source arguments of every entry (ops/fused_engine.py::
// _draw_args): the source code, the antithetic flag (Threefry only), the
// Sobol table, and the bridge plan: its weights (L slots a row) and load
// schedule, over T bridge dims.
struct DrawArgs {
  int source;
  int antithetic;
  const uint32_t* sv;
  const float* coeffs;
  const uint32_t* sched;
  int T, L;
};

struct StoreTerminal {  // K2
  float* out;
  __device__ void operator()(int64_t i, bool active, float price) const {
    if (active) out[i] = price;
  }
};

// Sum over the 128 threads of a block in tree_sum's adjacent-pair order.
// Every thread gets the total.
__device__ __forceinline__ float row_tree_sum(float v, float* partial) {
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

// The functor of a block: on its constants in shared memory, staged by
// every thread (ProcTraits::kShared), or on the leaves.
template <class Proc>
__device__ __forceinline__ const float* constants(const float* leaves,
                                                  int dims) {
  if constexpr (ProcTraits<Proc>::kShared > 0) {
    __shared__ __align__(16) float smem[ProcTraits<Proc>::kShared];
    Proc::stage(smem, leaves, dims);
    __syncthreads();
    return smem;
  } else {
    return leaves;
  }
}

// The time loop of one path: the draw source's, or the functor's own for a
// source it streams; after(t) once step t is done.
template <class Proc, class Draws, class After>
__device__ __forceinline__ void run_path(const Proc& proc, const Draws& draws,
                                         uint32_t k0, uint32_t k1,
                                         uint32_t id, int64_t i, int n_steps,
                                         typename Proc::State& state,
                                         After& after) {
  if constexpr (Streams<Proc, Draws>::value) {
    proc.run(draws, k0, k1, id, n_steps, state, after);
  } else {
    draws.run(proc, k0, k1, id, i, n_steps, [&](int t, const float* eps) {
      state = step_at(proc, state, eps, t);
      after(t);
    });
  }
}

template <class Proc, class Draws, class Epilogue>
__global__ void fused_kernel(const float* __restrict__ leaves, int dims,
                             int64_t n_paths, int n_steps,
                             uint32_t path_offset, uint32_t k0, uint32_t k1,
                             Draws draws, Epilogue epilogue) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_paths;
  const Proc proc(constants<Proc>(leaves, dims), dims);
  typename Proc::State state = proc.init();
  if (active || Draws::kWholeBlock) {
    const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
    auto none = [](int) {};
    run_path(proc, draws, k0, k1, id, i, n_steps, state, none);
  }
  epilogue(i, active, proc.prices(state));
}

// ---- K4: path functionals --------------------------------------------------

template <class Proc, class Draws, class Fold>
__global__ void fused_functional_kernel(const float* __restrict__ leaves,
                                        int dims, int64_t n_paths,
                                        int n_steps, uint32_t path_offset,
                                        uint32_t k0, uint32_t k1,
                                        Draws draws, FunctionalSpec spec,
                                        float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_paths;
  const float* consts = constants<Proc>(leaves, dims);  // the whole block
  if (!active && !Draws::kWholeBlock) return;
  const Proc proc(consts, dims);
  const Needs need = Fold::needs(spec);  // a constant for a FixedFold
  // The observations: the price and the log price.  A functor whose log
  // price is log32 of its price computes the price once, and only when
  // some functional reads either.
  float price, logp;
  auto observe = [&](const typename Proc::State& s) {
    if constexpr (ProcTraits<Proc>::kLogOfPrice) {
      price = need.price || need.log ? proc.prices(s) : 0.0f;
      logp = need.log ? mc::log32(price) : 0.0f;
    } else {
      price = need.price ? proc.prices(s) : 0.0f;
      logp = proc.log_prices(s);
    }
  };
  Fold fold;
  typename Proc::State state = proc.init();
  observe(state);
  fold.init(spec, price, logp);
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  // One update after every step, with the 1-based step index (the scan
  // engine's order, which JAX's pair and bridge loops both keep).
  auto after = [&](int t) {
    observe(state);
    fold.update(spec, price, logp, t + 1);
  };
  run_path(proc, draws, k0, k1, id, i, n_steps, state, after);
  if (!active) return;
  out[i] = proc.prices(state);
  fold.finalize(spec, out, i, n_steps);
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
        if (a.sv == nullptr || a.coeffs == nullptr || a.sched == nullptr ||
            a.T < 1 || a.L < 1 || a.L > mc::kMaxLevels ||
            (dims != 1 && Proc::kDraws != 1)) {
          return cudaErrorInvalidValue;
        }
        return Launcher<Proc, BridgeDraws>::run(
            blocks, s, dims, BridgeDraws{a.sv, a.coeffs, a.sched, a.T, a.L},
            args...);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
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

// Whether K4 on functor Proc under draw source Draws is built with the
// fixed fold Fold, one of FixedFolds (specialized, for FixedFold types
// only, where the kernels are instantiated: csrc/fused_k4.cu,
// csrc/fused_basket.cuh).  Elsewhere the set runs SpecFold.
template <class Proc, class Draws, class Fold>
struct FixedFor : std::false_type {};

// K4 with the fold the entry chose from the spec (with_fold): Fold where
// FixedFor says so, else SpecFold; *fixed says which (1 or 0).
template <class Fold>
struct FoldLauncher {
  template <class Proc, class Draws>
  struct With {
    static cudaError_t run(unsigned blocks, cudaStream_t s, int dims,
                           Draws draws, int64_t n_paths, const float* leaves,
                           int n_steps, uint32_t path_offset, uint32_t k0,
                           uint32_t k1, FunctionalSpec spec, float* out,
                           int* fixed) {
      if constexpr (FixedFor<Proc, Draws, Fold>::value) {
        *fixed = 1;
        fused_functional_kernel<Proc, Draws, Fold><<<blocks, kRow, 0, s>>>(
            leaves, dims, n_paths, n_steps, path_offset, k0, k1, draws, spec,
            out);
      } else {
        *fixed = 0;
        fused_functional_kernel<Proc, Draws, SpecFold>
            <<<blocks, kRow, 0, s>>>(leaves, dims, n_paths, n_steps,
                                     path_offset, k0, k1, draws, spec, out);
      }
      return cudaSuccess;
    }
  };
};

// K2, K3 and K4 on the correlated basket of `dims` assets, launched with
// one thread per path (csrc/fused_basket.cu); the arguments of a Launcher's
// run after the draw source.
cudaError_t launch_basket(const DrawArgs& a, int dims, unsigned blocks,
                          cudaStream_t s, int64_t n_paths, const float* leaves,
                          int n_steps, uint32_t path_offset, uint32_t k0,
                          uint32_t k1, StoreTerminal epilogue);
cudaError_t launch_basket(const DrawArgs& a, int dims, unsigned blocks,
                          cudaStream_t s, int64_t n_paths, const float* leaves,
                          int n_steps, uint32_t path_offset, uint32_t k0,
                          uint32_t k1, RowMoments epilogue);
cudaError_t launch_basket(const DrawArgs& a, int dims, unsigned blocks,
                          cudaStream_t s, int64_t n_paths, const float* leaves,
                          int n_steps, uint32_t path_offset, uint32_t k0,
                          uint32_t k1, FunctionalSpec spec, float* out,
                          int* fixed);

}  // namespace mcf
