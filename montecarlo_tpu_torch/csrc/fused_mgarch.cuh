// K2, K3 and K4 on the multi-asset state processes, TermBasketGBM,
// CCC-GARCH and DCC-GARCH: the functor StateProc<Step, A> over a step of
// csrc/mgarch_steps.cuh, the draw sources it takes, and its launch by asset
// count, A = 1..mc::kMaxStateAssets, one instantiation each.  The units
// that instantiate it, each in its own nvcc process so that none of them
// grows past about a minute of build: csrc/fused_term_basket.cu,
// csrc/fused_ccc.cu, and csrc/fused_dcc.cu with fused_dcc_k4.cu (DCC's K4
// apart: its unrolled Cholesky makes the largest kernels).
//
// Replaces the parts of montecarlo_tpu/ops/fused_engine.py::
// fused_terminal_pallas (K2), ::fused_block_moments_pallas (K3) and
// ::fused_functionals_pallas (K4) that trace these processes' steps.
// Bounds and numerics: csrc/mgarch_steps.cuh.  Design: csrc/
// fused_engine.cuh's, one thread per path with its state in registers (at
// A = 8, DCC's 52 words and its step's 36-word factor); A normals a step,
// drawn by SincosDraws<A> (NormalDrawsMixin's counters j A + c, each
// Box-Muller pair from one sincosf, the plain version's bits) under
// Threefry, plain and antithetic, or by the Sobol source (dimension t A +
// d); the bridge takes one draw, and the wrappers refuse it here at every
// A (ops/fused_engine.py::kernel_refusal).  K4 observes the portfolio
// value, its log as log32 of it (ProcTraits::kLogOfPrice: no log price of
// its own), and runs the generic fold (SpecFold) for every set.  A launch
// whose dims or steps the process does not take (an asset count outside
// 1..8, a run longer than the term basket's curves) is an invalid value;
// the wrappers refuse it first.
#pragma once

#include <utility>

#include "mgarch_steps.cuh"
#include "processes.cuh"

namespace mcf {
namespace {

// A step of mgarch_steps.cuh with its A normals a step: a TimedStep
// functor (the term basket's curves are read at t; the GARCH steps ignore
// it).
template <class Step, int A>
struct StateProc : SincosDraws<A>, TimedStep, Step {
  using State = typename Step::State;
  __device__ StateProc(const float* leaves, int dims) : Step(leaves, dims) {}
};

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

}  // namespace

// The definitions of csrc/processes.cuh's MC_STATE_LAUNCHES(name) for the
// step template Step of process code `code`: K2 and K3 by MC_STATE_K2_K3,
// K4 by MC_STATE_K4 (DCC's in a unit of its own), all three by
// MC_STATE_DEFINE_LAUNCHES.
#define MC_STATE_EPILOGUE(name, code, Step, Epilogue)                        \
  cudaError_t name(const DrawArgs& a, int dims, unsigned blocks,             \
                   cudaStream_t s, int64_t n_paths, const float* leaves,     \
                   int n_steps, uint32_t path_offset, uint32_t k0,           \
                   uint32_t k1, Epilogue epilogue) {                         \
    return launch_state<FusedLauncher<Epilogue>::With, Step>(                \
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
    return launch_state<FoldLauncher<SpecFold>::With, Step>(                 \
        AllStateAssets{}, code, a, dims, blocks, s, n_paths, leaves,         \
        n_steps, path_offset, k0, k1, spec, out, fixed);                     \
  }
#define MC_STATE_DEFINE_LAUNCHES(name, code, Step)                           \
  MC_STATE_K2_K3(name, code, Step)                                           \
  MC_STATE_K4(name, code, Step)

}  // namespace mcf
