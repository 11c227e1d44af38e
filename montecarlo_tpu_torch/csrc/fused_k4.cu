// K4 on every process but the correlated basket: the library's entry, its
// fixed folds' instantiations (FixedFor) and the generic fold's,
// instantiated over csrc/processes.cuh's functors and dispatch (the
// basket's in csrc/fused_basket_k4.cu and fused_basket_k4_even.cu).
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_functionals_pallas,
// which compiles every functional set into its own kernel
// (_make_functional_kernel).  Bound on the H100: compute, K2's loop plus
// the observation (an exp32 for a price) and the fold after every step; 4
// bytes a path per output.  Design: the fold is a template parameter
// (csrc/functionals.cuh).  The sets of FixedFolds are built as fixed folds
// for the functors and draw sources below, the ones the main paths
// launch; every other set, functor or source runs SpecFold, the codes
// read from the spec, in the same kernel template.  Numerics: as
// csrc/processes.cuh.

#include "processes.cuh"

namespace mcf {

using Avg = FixedFold<kArithMean>;
using AvgMaxMin = FixedFold<kArithMean, kRunningMax, kRunningMin>;

// GBM under every draw source and every set of FixedFolds but {trap} (the
// rate functors' set, csrc/fused_rates.cu): the Asian, barrier, note and
// app paths, iid, antithetic, Sobol and bridge-Sobol.
template <class Draws, int... Codes>
struct FixedFor<GbmProc, Draws, FixedFold<Codes...>> : std::true_type {};
template <class Draws>
struct FixedFor<GbmProc, Draws, FixedFold<kTrapezoid>> : std::false_type {};
// Heston and GARCH: {avg} and {avg, mx, mn} under Threefry draws, Heston's
// {avg} also under Sobol draws.
template <bool Anti>
struct FixedFor<HestonProc, ThreefryDraws<Anti>, Avg> : std::true_type {};
template <bool Anti>
struct FixedFor<HestonProc, ThreefryDraws<Anti>, AvgMaxMin>
    : std::true_type {};
template <>
struct FixedFor<HestonProc, SobolDraws, Avg> : std::true_type {};
template <bool Anti>
struct FixedFor<GarchProc, ThreefryDraws<Anti>, Avg> : std::true_type {};
template <bool Anti>
struct FixedFor<GarchProc, ThreefryDraws<Anti>, AvgMaxMin>
    : std::true_type {};
// The Kou, VG and SLV Asians.
template <bool Anti>
struct FixedFor<KouProc, ThreefryDraws<Anti>, Avg> : std::true_type {};
template <bool Anti>
struct FixedFor<VgProc, ThreefryDraws<Anti>, Avg> : std::true_type {};
template <bool Anti>
struct FixedFor<SlvProc, ThreefryDraws<Anti>, Avg> : std::true_type {};

}  // namespace mcf

using namespace mcf;

// K4: out (1 + n_functionals, out_stride), out_stride >= n_paths: terminal
// prices, then each finalized functional, in columns 0 .. n_paths - 1 of
// each row.  codes/periods (n_functionals,) and params (n_functionals,
// kMaxParams) are host arrays.  *fixed (a host int, or null) gets the index
// in FixedFolds of the fixed fold the launch ran, or -1 for SpecFold.
extern "C" int mc_fused_functionals(float* out, const float* leaves,
                                    int process, int dims, int64_t n_paths,
                                    int64_t n_steps, uint32_t path_offset,
                                    uint32_t k0, uint32_t k1, MC_DRAW_PARAMS,
                                    int n_functionals, const int* codes,
                                    const int* periods, const float* params,
                                    int64_t out_stride, int* fixed,
                                    void* stream) {
  if (n_functionals < 0 || n_functionals > kMaxFunctionals ||
      out_stride < n_paths) {
    return (int)cudaErrorInvalidValue;
  }
  FunctionalSpec spec = {};
  spec.out_stride = out_stride;
  spec.n = n_functionals;
  for (int k = 0; k < n_functionals; ++k) {
    spec.code[k] = codes[k];
    // A period divides t (the cliquet, the autocall): at least 1; a
    // snapshot's is its step, 0 for the spot.
    spec.period[k] =
        periods[k] < 1 && codes[k] != kSnapshot ? 1 : periods[k];
    for (int q = 0; q < kMaxParams; ++q) {
      spec.p[k][q] = params[k * kMaxParams + q];
    }
  }
  int used = 0;
  const int err = with_fold(spec, [&](auto fold) {
    return dispatch<FoldLauncher<decltype(fold)>::template With>(
        process, dims, MC_DRAW_ARGS, n_paths, stream, leaves, (int)n_steps,
        path_offset, k0, k1, spec, out, &used);
  });
  if (fixed != nullptr) *fixed = used ? fixed_fold_index(spec) : -1;
  return err;
}
