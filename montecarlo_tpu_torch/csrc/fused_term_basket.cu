// K2 and K3 on the term basket (processes/term_basket.py), A = 1..8 assets:
// StateProc<mc::TermBasketStep<A>, A> (csrc/fused_mgarch.cuh) under
// Threefry, plain and antithetic, and Sobol draws, in a unit of its own (K4
// in fused_term_basket_k4.cu, which builds beside it).  Replaces the part
// of montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas and
// ::fused_block_moments_pallas that traces its step.

#include "fused_mgarch.cuh"

namespace mcf {

MC_STATE_K2_K3(launch_term_basket, kTermBasket, mc::TermBasketStep)

}  // namespace mcf
