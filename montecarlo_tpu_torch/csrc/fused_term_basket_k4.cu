// K4 on the term basket (processes/term_basket.py), A = 1..8 assets:
// StateProc<mc::TermBasketStep<A>, A> (csrc/fused_mgarch.cuh) under
// Threefry, plain and antithetic, and Sobol draws; K2 and K3 in
// fused_term_basket.cu.  Replaces the part of montecarlo_tpu/ops/
// fused_engine.py::fused_functionals_pallas that traces its step.
//
// Bound on the H100: compute.  K4 observes the portfolio value after every
// step, A exp32 and A multiply-adds (mgarch_steps.cuh::weighted_value, the
// assets in order), on top of K2's step.  Design: the term basket's Asian,
// {avg} under Threefry draws, plain and antithetic, runs the fixed fold
// FixedFold<kArithMean> (one float of state and one add an observation,
// the value observed and no log32 of it), for every A the functor takes;
// every other set and the Sobol source run the generic fold (SpecFold),
// the codes read from the spec.  Numerics: as csrc/processes.cuh.

#include "fused_mgarch.cuh"

namespace mcf {

template <int A, bool Anti>
struct FixedFor<StateProc<mc::TermBasketStep<A>, A>, ThreefryDraws<Anti>,
                FixedFold<kArithMean>> : std::true_type {};

MC_STATE_K4(launch_term_basket, kTermBasket, mc::TermBasketStep)

}  // namespace mcf
