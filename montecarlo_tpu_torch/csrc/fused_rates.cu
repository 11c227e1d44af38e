// K2, K3 and K4 on Euler GBM, term-structure GBM, Vasicek, CIR,
// Hull-White and G2++: the functors RateProc<Step, D> over
// csrc/rate_steps.cuh's steps and their instantiations, in a unit of their
// own so the units of the other functors (fused_engine.cu, fused_k4.cu)
// keep their build time.  Their entries dispatch here (processes.cuh::
// dispatch, launch_rates).
//
// Replaces the parts of montecarlo_tpu/ops/fused_engine.py::
// fused_terminal_pallas (K2), ::fused_block_moments_pallas (K3) and
// ::fused_functionals_pallas (K4) that trace these processes' steps.
// Bounds: csrc/rate_steps.cuh.  Design: csrc/fused_engine.cuh's, one
// thread per path with its state in registers; the Box-Muller pairs from
// one sincosf (mc::boxmuller_sincos, the same bits as the plain version's
// sin and cos); the single-draw steps take Threefry, Sobol and bridge
// draws, G2++ Threefry and Sobol.  K4 picks its fold from the spec
// (with_fold): the bond command's {trap} on Vasicek, CIR, Hull-White and
// G2++ under Threefry draws, plain and antithetic, runs the fixed fold
// FixedFold<kTrapezoid> (two floats of state, a multiply and two adds an
// observation, no switch over codes, the price observed and no log); every
// other set, functor and draw source the generic fold (SpecFold).  A
// launch of more steps than a curve holds is an invalid value (the
// wrappers refuse it first).  Numerics: as csrc/processes.cuh.

#include "processes.cuh"
#include "rate_steps.cuh"

namespace mcf {
namespace {

// A step of rate_steps.cuh with D normals a step: a TimedStep functor (the
// curves are read at t; the other steps ignore it).
template <class Step, int D>
struct RateProc : SincosDraws<D>, TimedStep, Step {
  using State = typename Step::State;
  __device__ RateProc(const float* leaves, int dims) : Step(leaves, dims) {}
};

using EulerGbmProc = RateProc<mc::EulerGbmStep, 1>;
using TermGbmProc = RateProc<mc::TermGbmStep, 1>;
using VasicekProc = RateProc<mc::VasicekStep, 1>;
using CirProc = RateProc<mc::CirStep, 1>;
using HullWhiteProc = RateProc<mc::HullWhiteStep, 1>;
using G2ppProc = RateProc<mc::G2ppStep, 2>;

}  // namespace

// The steps without log_prices (all but term GBM) give K4 the log price as
// log32 of the price, as engine/functionals.py::functional_observables
// does.
template <class Step, int D>
struct ProcTraits<RateProc<Step, D>> {
  static constexpr int kShared = 0;
  static constexpr bool kLogOfPrice = !Step::kLogPrices;
};
// All draws are normals: Sobol for every step, the bridge for one draw.
template <class Step, int D>
struct SourceTraits<RateProc<Step, D>> {
  static constexpr bool kSobol = true;
  static constexpr bool kBridge = D == 1;
};
// K4 {trap} on the bond models under Threefry draws (engine/rates.py's
// zero-coupon bond and bond option), on its fixed fold.
using Trap = FixedFold<kTrapezoid>;
template <bool Anti>
struct FixedFor<VasicekProc, ThreefryDraws<Anti>, Trap> : std::true_type {};
template <bool Anti>
struct FixedFor<CirProc, ThreefryDraws<Anti>, Trap> : std::true_type {};
template <bool Anti>
struct FixedFor<HullWhiteProc, ThreefryDraws<Anti>, Trap>
    : std::true_type {};
template <bool Anti>
struct FixedFor<G2ppProc, ThreefryDraws<Anti>, Trap> : std::true_type {};

namespace {

// n_steps within the curves of term GBM and Hull-White (dims entries).
bool steps_fit(int process, int dims, int n_steps) {
  if (process == kTermGbm || process == kHullWhite) {
    return dims >= 1 && n_steps <= dims;
  }
  return true;
}

template <template <class, class> class Launcher, class... Args>
cudaError_t launch_rate(int process, const DrawArgs& a, int dims,
                        unsigned blocks, cudaStream_t s, int64_t n_paths,
                        const float* leaves, int n_steps, Args... args) {
  if (!steps_fit(process, dims, n_steps)) return cudaErrorInvalidValue;
  switch (process) {
    case kEulerGbm:
      return launch_source<Launcher, EulerGbmProc>(a, dims, blocks, s, n_paths,
                                                   leaves, n_steps, args...);
    case kTermGbm:
      return launch_source<Launcher, TermGbmProc>(a, dims, blocks, s, n_paths,
                                                  leaves, n_steps, args...);
    case kVasicek:
      return launch_source<Launcher, VasicekProc>(a, dims, blocks, s, n_paths,
                                                  leaves, n_steps, args...);
    case kCir:
      return launch_source<Launcher, CirProc>(a, dims, blocks, s, n_paths,
                                              leaves, n_steps, args...);
    case kHullWhite:
      return launch_source<Launcher, HullWhiteProc>(
          a, dims, blocks, s, n_paths, leaves, n_steps, args...);
    case kG2pp:
      return launch_source<Launcher, G2ppProc>(a, dims, blocks, s, n_paths,
                                               leaves, n_steps, args...);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t launch_rates(int process, const DrawArgs& a, int dims,
                         unsigned blocks, cudaStream_t s, int64_t n_paths,
                         const float* leaves, int n_steps,
                         uint32_t path_offset, uint32_t k0, uint32_t k1,
                         StoreTerminal epilogue) {
  return launch_rate<FusedLauncher<StoreTerminal>::With>(
      process, a, dims, blocks, s, n_paths, leaves, n_steps, path_offset, k0,
      k1, epilogue);
}

cudaError_t launch_rates(int process, const DrawArgs& a, int dims,
                         unsigned blocks, cudaStream_t s, int64_t n_paths,
                         const float* leaves, int n_steps,
                         uint32_t path_offset, uint32_t k0, uint32_t k1,
                         RowMoments epilogue) {
  return launch_rate<FusedLauncher<RowMoments>::With>(
      process, a, dims, blocks, s, n_paths, leaves, n_steps, path_offset, k0,
      k1, epilogue);
}

cudaError_t launch_rates(int process, const DrawArgs& a, int dims,
                         unsigned blocks, cudaStream_t s, int64_t n_paths,
                         const float* leaves, int n_steps,
                         uint32_t path_offset, uint32_t k0, uint32_t k1,
                         FunctionalSpec spec, float* out, int* fixed) {
  return with_fold(spec, [&](auto fold) {
    return launch_rate<FoldLauncher<decltype(fold)>::template With>(
        process, a, dims, blocks, s, n_paths, leaves, n_steps, path_offset,
        k0, k1, spec, out, fixed);
  });
}

}  // namespace mcf
