// K3 on the correlated basket: its instantiations, every functor and draw
// source of csrc/fused_basket.cuh.  Replaces the basket's part of
// montecarlo_tpu/ops/fused_engine.py::fused_block_moments_pallas.

#include "fused_basket.cuh"

namespace mcf {

cudaError_t launch_basket(const DrawArgs& a, int dims, unsigned blocks,
                          cudaStream_t s, int64_t n_paths, const float* leaves,
                          int n_steps, uint32_t path_offset, uint32_t k0,
                          uint32_t k1, RowMoments epilogue) {
  return launch_assets<FusedLauncher<RowMoments>::With>(
      AllAssets{}, a, dims, blocks, s, n_paths, leaves, n_steps, path_offset,
      k0, k1, epilogue);
}

}  // namespace mcf
