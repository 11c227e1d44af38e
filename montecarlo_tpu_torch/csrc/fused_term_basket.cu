// K2, K3 and K4 on the term basket (processes/term_basket.py), A = 1..8 assets:
// StateProc<mc::TermBasketStep<A>, A> (csrc/fused_mgarch.cuh) under Threefry,
// plain and antithetic, and Sobol draws, K4 on the generic fold, in a unit
// of its own.  Replaces the part of montecarlo_tpu/ops/fused_engine.py::
// fused_terminal_pallas, ::fused_block_moments_pallas and
// ::fused_functionals_pallas that traces its step.

#include "fused_mgarch.cuh"

namespace mcf {

MC_STATE_DEFINE_LAUNCHES(launch_term_basket, kTermBasket,
                         mc::TermBasketStep)

}  // namespace mcf
