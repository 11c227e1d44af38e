// K4 on the correlated basket of an even number of assets up to 16:
// BasketFixed<A>'s instantiations at even A under every draw source, with
// the generic fold, split from fused_basket_k4.cu so that the two build in
// parallel.  Replaces the basket's part of montecarlo_tpu/ops/
// fused_engine.py::fused_functionals_pallas.

#include "fused_basket.cuh"

namespace mcf {

cudaError_t launch_basket_even(const DrawArgs& a, int dims, unsigned blocks,
                               cudaStream_t s, int64_t n_paths,
                               const float* leaves, int n_steps,
                               uint32_t path_offset, uint32_t k0, uint32_t k1,
                               FunctionalSpec spec, float* out, int* fixed) {
  return launch_fixed<FoldLauncher<SpecFold>::With>(
      EvenAssets{}, a, dims, blocks, s, n_paths, leaves, n_steps, path_offset,
      k0, k1, spec, out, fixed);
}

}  // namespace mcf
