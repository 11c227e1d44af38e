// K2, K3 and K4 on the multi-asset state processes, TermBasketGBM,
// CCC-GARCH and DCC-GARCH: the functor StateProc<Step, A> over a step of
// csrc/mgarch_steps.cuh, the draw sources it takes, and its launch by asset
// count, A = 1..mc::kMaxStateAssets, one instantiation each.  The units
// that instantiate it, each in its own nvcc process so that none of them
// grows past about a minute of build: csrc/fused_term_basket.cu with
// fused_term_basket_k4.cu (the term basket's K4 apart: its fixed fold's
// kernels), csrc/fused_ccc.cu, and csrc/fused_dcc.cu with fused_dcc_k4.cu
// (DCC's K4 apart: its unrolled Cholesky makes the largest kernels).
//
// Replaces the parts of montecarlo_tpu/ops/fused_engine.py::
// fused_terminal_pallas (K2), ::fused_block_moments_pallas (K3) and
// ::fused_functionals_pallas (K4) that trace these processes' steps.
// Bounds and numerics: csrc/mgarch_steps.cuh.  Design: csrc/
// fused_engine.cuh's, one thread per path with its state in registers (at
// A = 8, DCC's 52 words and its step's factor); A normals a step, drawn
// under Threefry, plain and antithetic (NormalDrawsMixin's counters j A +
// c, each Box-Muller pair from one sincosf, the plain version's bits), or
// by the Sobol source (dimension t A + d); the bridge takes one draw, and
// the wrappers refuse it here at every A (ops/fused_engine.py::
// kernel_refusal).  K4 observes the portfolio value, its log as log32 of
// it (ProcTraits::kLogOfPrice: no log price of its own), on the fold the
// spec names (with_fold): a fixed fold where the unit declares FixedFor
// (the term basket's {avg} under Threefry draws), else the generic fold
// (SpecFold); CCC's and DCC's by-value K4 always runs the generic fold.
// A launch whose dims or steps the
// process does not take (an asset count outside 1..8, a run longer than
// the term basket's curves) is an invalid value; the wrappers refuse it
// first.
//
// CCC and DCC (ByValue: their steps take their constants as a struct,
// Step::Leaves) launch kernels of their own, state_kernel and
// state_functional_kernel: the launch copies the wrapper's launch leaves,
// a host array, into the kernel's parameter space (__grid_constant__), so
// the step reads every constant from the constant bank with no load from
// device memory.  At an even A they draw a step at a time (step_normals:
// step 2j's A normals are the first A/2 of the pair's calls, step 2j+1's
// the last A/2), so no step holds the next one's normals, in a loop of
// one step a pass; at an odd A the middle call feeds both steps and they
// keep ThreefryDraws' pair.  The term basket keeps its
// leaves pointer (its curves are 2 A n floats) and fused_engine.cuh's
// kernels.
#pragma once

#include <string.h>

#include <type_traits>
#include <utility>

#include "mgarch_steps.cuh"
#include "processes.cuh"

namespace mcf {
namespace {

// Whether a step takes its constants by value (Step::Leaves).
template <class Step, class = void>
struct ByValue : std::false_type {};
template <class Step>
struct ByValue<Step, std::void_t<typename Step::Leaves>> : std::true_type {};

// The A normals of step t of path `id` (its draw id) at an even A: cipher
// calls (t >> 1) A + (t & 1) A / 2 + c, c < A / 2, each a Box-Muller pair
// from one sincosf; the pair's flat normals split as SincosDraws<A>::
// draws_pair's eps0 and eps1, negated when mirrored.
template <int A>
__device__ __forceinline__ void step_normals(uint32_t k0, uint32_t k1,
                                             uint32_t id, bool mirror,
                                             int t, float* eps) {
  static_assert(A % 2 == 0, "an odd A shares a call between two steps");
  const uint32_t base =
      (uint32_t)(t >> 1) * A + (uint32_t)(t & 1) * (uint32_t)(A / 2);
#pragma unroll
  for (int c = 0; c < A / 2; ++c) {
    normal_pair_sincos(k0, k1, id, base + (uint32_t)c, &eps[2 * c],
                       &eps[2 * c + 1]);
  }
  if (mirror) {
#pragma unroll
    for (int d = 0; d < A; ++d) eps[d] = -eps[d];
  }
}

// A step of mgarch_steps.cuh with its A normals a step: a TimedStep
// functor (the term basket's curves are read at t; the GARCH steps ignore
// it), built on the leaves pointer and dims or on the step's Leaves.
template <class Step, int A>
struct StateProc : SincosDraws<A>, TimedStep, Step {
  using State = typename Step::State;
  template <class... Args>
  __device__ explicit StateProc(const Args&... args) : Step(args...) {}
  // Threefry at an even A (Streams): each step's normals drawn just
  // before it, a pass of the loop a step (half the code of a pass a step
  // pair: DCC's step at A = 8 is ~1750 instructions).
  template <bool Anti, class After>
  __device__ void run(const ThreefryDraws<Anti>&, uint32_t k0, uint32_t k1,
                      uint32_t id, int n_steps, State& st,
                      After& after) const {
    const uint32_t did = ThreefryDraws<Anti>::draw_id(id);
    const bool mirror = ThreefryDraws<Anti>::mirrored(id);
    for (int t = 0; t < n_steps; ++t) {
      float eps[A];
      step_normals<A>(k0, k1, did, mirror, t, eps);
      st = this->step(st, eps, t);
      after(t);
    }
  }
};

// K2 and K3 on a by-value functor: fused_kernel with the constants as a
// kernel parameter.
template <class Proc, class Draws, class Epilogue>
__global__ void state_kernel(
    const __grid_constant__ typename Proc::Leaves leaves, int64_t n_paths,
    int n_steps, uint32_t path_offset, uint32_t k0, uint32_t k1,
    Draws draws, Epilogue epilogue) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_paths;
  const Proc proc(leaves);
  typename Proc::State state = proc.init();
  if (active || Draws::kWholeBlock) {
    const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
    auto none = [](int) {};
    run_path(proc, draws, k0, k1, id, i, n_steps, state, none);
  }
  epilogue(i, active, proc.prices(state));
}

// K4 on a by-value functor: fused_functional_kernel's generic fold with
// the constants as a kernel parameter; the log price is log32 of the
// price (ProcTraits::kLogOfPrice).
template <class Proc, class Draws>
__global__ void state_functional_kernel(
    const __grid_constant__ typename Proc::Leaves leaves, int64_t n_paths,
    int n_steps, uint32_t path_offset, uint32_t k0, uint32_t k1,
    Draws draws, FunctionalSpec spec, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_paths;
  if (!active && !Draws::kWholeBlock) return;
  const Proc proc(leaves);
  const Needs need = SpecFold::needs(spec);
  float price, logp;
  auto observe = [&](const typename Proc::State& s) {
    price = need.price || need.log ? proc.prices(s) : 0.0f;
    logp = need.log ? mc::log32(price) : 0.0f;
  };
  SpecFold fold;
  typename Proc::State state = proc.init();
  observe(state);
  fold.init(spec, price, logp);
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  auto after = [&](int t) {
    observe(state);
    fold.update(spec, price, logp, t + 1);
  };
  run_path(proc, draws, k0, k1, id, i, n_steps, state, after);
  if (!active) return;
  out[i] = proc.prices(state);
  fold.finalize(spec, out, i, n_steps);
}

}  // namespace

template <class Step, int A>
struct ProcTraits<StateProc<Step, A>> {
  static constexpr int kShared = 0;
  static constexpr bool kLogOfPrice = true;
};
template <class Step, int A>
struct SourceTraits<StateProc<Step, A>> {
  static constexpr bool kSobol = true;
  static constexpr bool kBridge = false;
};
template <class Step, int A, bool Anti>
struct Streams<StateProc<Step, A>, ThreefryDraws<Anti>>
    : std::bool_constant<ByValue<Step>::value && A % 2 == 0> {};

namespace {

template <int... As>
using StateAssets = std::integer_sequence<int, As...>;
using AllStateAssets = StateAssets<1, 2, 3, 4, 5, 6, 7, 8>;
static_assert(mc::kMaxStateAssets == 8, "AllStateAssets lists 1..8");

// Whether a launch of `process` takes `dims` and `n_steps`: an asset count
// A in 1..8 (CCC and DCC: dims = A; the term basket: dims = A + (n <<
// kCurveShift) with a curve of n >= max(n_steps, 1) entries).
inline bool state_fits(int process, int dims, int n_steps) {
  int n_assets = dims;
  if (process == kTermBasket) {
    n_assets = dims & ((1 << mc::kCurveShift) - 1);
    const int n = dims >> mc::kCurveShift;
    if (n < 1 || n_steps > n) return false;
  }
  return n_assets >= 1 && n_assets <= mc::kMaxStateAssets;
}

// StateProc<Step<A>, A> for the run's asset count A, launched through
// Launcher.
template <template <class, class> class Launcher, template <int> class Step,
          int... As, class... Args>
cudaError_t launch_state(StateAssets<As...>, int process, const DrawArgs& a,
                         int dims, unsigned blocks, cudaStream_t s,
                         int64_t n_paths, const float* leaves, int n_steps,
                         Args... args) {
  if (!state_fits(process, dims, n_steps)) return cudaErrorInvalidValue;
  const int n_assets = dims & ((1 << mc::kCurveShift) - 1);
  cudaError_t err = cudaErrorInvalidValue;
  (void)((n_assets == As &&
          (err = launch_source<Launcher, StateProc<Step<As>, As>>(
               a, dims, blocks, s, n_paths, leaves, n_steps, args...),
           true)) ||
         ...);
  return err;
}

// K2 and K3 (Epilogue) and K4 (the fold Fold that with_fold chose) on
// functor Proc under draw source Draws: a by-value functor's kernels on a
// copy of the launch leaves (`leaves` points to host memory), its K4 on
// SpecFold whatever the spec; the others fused_engine.cuh's, K4 through
// FoldLauncher<Fold> (Fold where FixedFor says so, else SpecFold).
template <class Epilogue>
struct StateLauncher {
  template <class Proc, class Draws>
  struct With {
    static cudaError_t run(unsigned blocks, cudaStream_t s, int dims,
                           Draws draws, int64_t n_paths, const float* leaves,
                           int n_steps, uint32_t path_offset, uint32_t k0,
                           uint32_t k1, Epilogue epilogue) {
      if constexpr (ByValue<Proc>::value) {
        typename Proc::Leaves lv;
        memcpy(&lv, leaves, sizeof lv);
        state_kernel<Proc, Draws, Epilogue><<<blocks, kRow, 0, s>>>(
            lv, n_paths, n_steps, path_offset, k0, k1, draws, epilogue);
        return cudaSuccess;
      } else {
        return FusedLauncher<Epilogue>::template With<Proc, Draws>::run(
            blocks, s, dims, draws, n_paths, leaves, n_steps, path_offset,
            k0, k1, epilogue);
      }
    }
  };
};
template <class Fold>
struct StateFoldLauncher {
  template <class Proc, class Draws>
  struct With {
    static cudaError_t run(unsigned blocks, cudaStream_t s, int dims,
                           Draws draws, int64_t n_paths, const float* leaves,
                           int n_steps, uint32_t path_offset, uint32_t k0,
                           uint32_t k1, FunctionalSpec spec, float* out,
                           int* fixed) {
      if constexpr (ByValue<Proc>::value) {
        *fixed = 0;
        typename Proc::Leaves lv;
        memcpy(&lv, leaves, sizeof lv);
        state_functional_kernel<Proc, Draws><<<blocks, kRow, 0, s>>>(
            lv, n_paths, n_steps, path_offset, k0, k1, draws, spec, out);
        return cudaSuccess;
      } else {
        return FoldLauncher<Fold>::template With<Proc, Draws>::run(
            blocks, s, dims, draws, n_paths, leaves, n_steps, path_offset,
            k0, k1, spec, out, fixed);
      }
    }
  };
};

}  // namespace

// The definitions of csrc/processes.cuh's MC_STATE_LAUNCHES(name) for the
// step template Step of process code `code`: K2 and K3 by MC_STATE_K2_K3,
// K4 by MC_STATE_K4 on the fold with_fold picks from the spec (the term
// basket's and DCC's in units of their own), all three by
// MC_STATE_DEFINE_LAUNCHES.
#define MC_STATE_EPILOGUE(name, code, Step, Epilogue)                        \
  cudaError_t name(const DrawArgs& a, int dims, unsigned blocks,             \
                   cudaStream_t s, int64_t n_paths, const float* leaves,     \
                   int n_steps, uint32_t path_offset, uint32_t k0,           \
                   uint32_t k1, Epilogue epilogue) {                         \
    return launch_state<StateLauncher<Epilogue>::With, Step>(                \
        AllStateAssets{}, code, a, dims, blocks, s, n_paths, leaves,         \
        n_steps, path_offset, k0, k1, epilogue);                             \
  }
#define MC_STATE_K2_K3(name, code, Step)                                     \
  MC_STATE_EPILOGUE(name, code, Step, StoreTerminal)                         \
  MC_STATE_EPILOGUE(name, code, Step, RowMoments)
#define MC_STATE_K4(name, code, Step)                                        \
  cudaError_t name(const DrawArgs& a, int dims, unsigned blocks,             \
                   cudaStream_t s, int64_t n_paths, const float* leaves,     \
                   int n_steps, uint32_t path_offset, uint32_t k0,           \
                   uint32_t k1, FunctionalSpec spec, float* out, int* fixed) { \
    return with_fold(spec, [&](auto fold) {                                  \
      return launch_state<StateFoldLauncher<decltype(fold)>::template With,  \
                          Step>(AllStateAssets{}, code, a, dims, blocks, s,  \
                                n_paths, leaves, n_steps, path_offset, k0,   \
                                k1, spec, out, fixed);                       \
    });                                                                      \
  }
#define MC_STATE_DEFINE_LAUNCHES(name, code, Step)                           \
  MC_STATE_K2_K3(name, code, Step)                                           \
  MC_STATE_K4(name, code, Step)

}  // namespace mcf
