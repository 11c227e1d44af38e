// K2 and K3 on DCC-GARCH (processes/dcc_garch.py), A = 1..8 assets:
// StateProc<mc::DccStep<A>, A> (csrc/fused_mgarch.cuh) under Threefry,
// plain and antithetic, and Sobol draws, in a unit of its own (K4 in
// fused_dcc_k4.cu, which builds beside it: DCC's unrolled Cholesky makes
// the largest kernels of the multi-asset units).  Replaces the part of
// montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas and
// ::fused_block_moments_pallas that traces its step.

#include "fused_mgarch.cuh"

namespace mcf {

MC_STATE_K2_K3(launch_dcc_garch, kDccGarch, mc::DccStep)

}  // namespace mcf
