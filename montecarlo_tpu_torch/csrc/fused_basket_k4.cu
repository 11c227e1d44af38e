// K4 on the correlated basket: its instantiations, every functor and draw
// source of csrc/fused_basket.cuh but BasketFixed<A> at even A, which
// fused_basket_k4_even.cu builds in parallel; the fixed fold where
// FixedFor says so (the 5-asset Asian's), the generic fold elsewhere.
// Replaces the basket's part of montecarlo_tpu/ops/fused_engine.py::
// fused_functionals_pallas.

#include "fused_basket.cuh"

namespace mcf {

cudaError_t launch_basket(const DrawArgs& a, int dims, unsigned blocks,
                          cudaStream_t s, int64_t n_paths, const float* leaves,
                          int n_steps, uint32_t path_offset, uint32_t k0,
                          uint32_t k1, FunctionalSpec spec, float* out,
                          int* fixed) {
  if (dims % 2 == 0 && dims <= bstep::kMaxAssets) {
    return launch_basket_even(a, dims, blocks, s, n_paths, leaves, n_steps,
                              path_offset, k0, k1, spec, out, fixed);
  }
  return with_fold(spec, [&](auto fold) {
    return launch_assets<FoldLauncher<decltype(fold)>::template With>(
        OddAssets{}, a, dims, blocks, s, n_paths, leaves, n_steps,
        path_offset, k0, k1, spec, out, fixed);
  });
}

}  // namespace mcf
