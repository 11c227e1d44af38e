// K4 on DCC-GARCH (processes/dcc_garch.py), A = 1..8 assets:
// StateProc<mc::DccStep<A>, A> (csrc/fused_mgarch.cuh) under Threefry,
// plain and antithetic, and Sobol draws, on the generic fold; K2 and K3 in
// fused_dcc.cu.  Replaces the part of montecarlo_tpu/ops/fused_engine.py::
// fused_functionals_pallas that traces its step.

#include "fused_mgarch.cuh"

namespace mcf {

MC_STATE_K4(launch_dcc_garch, kDccGarch, mc::DccStep)

}  // namespace mcf
