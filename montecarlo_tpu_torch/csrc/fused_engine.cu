// K2 and K3 on every process but the correlated basket: the library's
// entries, instantiated over csrc/processes.cuh's functors and dispatch
// (the basket's in csrc/fused_basket.cu and fused_basket_k3.cu; K4's in
// csrc/fused_k4.cu).
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas (K2)
// and ::fused_block_moments_pallas (K3).  Bounds, design and numerics:
// csrc/processes.cuh and csrc/fused_engine.cuh.

#include "processes.cuh"

using namespace mcf;

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
