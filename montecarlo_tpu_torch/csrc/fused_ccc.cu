// K2, K3 and K4 on CCC-GARCH (processes/ccc_garch.py), A = 1..8 assets:
// StateProc<mc::CccStep<A>, A> (csrc/fused_mgarch.cuh) under Threefry,
// plain and antithetic, and Sobol draws, K4 on the generic fold, in a unit
// of its own.  Replaces the part of montecarlo_tpu/ops/fused_engine.py::
// fused_terminal_pallas, ::fused_block_moments_pallas and
// ::fused_functionals_pallas that traces its step.

#include "fused_mgarch.cuh"

namespace mcf {

MC_STATE_DEFINE_LAUNCHES(launch_ccc_garch, kCccGarch, mc::CccStep)

}  // namespace mcf
