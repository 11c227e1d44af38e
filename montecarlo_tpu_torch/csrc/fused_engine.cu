// K2 and K3 on every process but the correlated basket: the library's
// entries, instantiated over csrc/processes.cuh's functors and dispatch
// (the basket's in csrc/fused_basket.cu and fused_basket_k3.cu; K4's in
// csrc/fused_k4.cu); and the row builder of the surfaces on time knots,
// whose rows K2-K4 read.
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas (K2)
// and ::fused_block_moments_pallas (K3).  Bounds, design and numerics:
// csrc/processes.cuh and csrc/fused_engine.cuh.

#include "processes.cuh"

using namespace mcf;

namespace mcf {
namespace {

// The row builder: rows[t][k] = mc::row_lane(table, n_tk, t, dt, dt_knot, k)
// = mc::blend_lane(table, n_tk, mc::knot_time(t, dt, dt_knot, n_tk), k),
// block t, thread k.  The time blend of a surface on knots (local vol, SLV
// on knots; processes/local_vol.py::blend_rows) once per step and lane,
// where the functors would take it once per path and step; they then read
// row t as SlvProc reads its exact rows.  dt and dt_knot are the process's
// float32 leaves, read in place.
__global__ void __launch_bounds__(mc::kKnots)
    blend_rows_kernel(float* __restrict__ rows, const float* __restrict__ table,
                      const float* __restrict__ dt,
                      const float* __restrict__ dt_knot, int n_tk) {
  const int t = blockIdx.x, k = threadIdx.x;
  rows[(int64_t)t * mc::kKnots + k] =
      mc::row_lane(table, n_tk, t, *dt, *dt_knot, k);
}

}  // namespace
}  // namespace mcf

// The (n_rows, 128) rows of steps 0 .. n_rows - 1 of an (n_tk, 128) table
// on time knots (n_tk >= 2, n_rows >= 1).
extern "C" int mc_surface_rows(float* rows, const float* table,
                               const float* dt, const float* dt_knot,
                               int n_tk, int64_t n_rows, void* stream) {
  if (n_tk < 2 || n_rows < 1 || n_rows > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  blend_rows_kernel<<<(unsigned)n_rows, mc::kKnots, 0,
                      (cudaStream_t)stream>>>(rows, table, dt, dt_knot, n_tk);
  return (int)cudaGetLastError();
}

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
