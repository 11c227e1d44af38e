"""Path-simulation engine, path functionals, payoffs and Monte Carlo
estimators."""

from montecarlo_tpu_torch.engine.simulate import (  # noqa: F401
    check_sampler,
    check_steps,
    path_ids_for,
    replay_paths,
    simulate,
)
from montecarlo_tpu_torch.engine.payoffs import (  # noqa: F401
    VanillaPayoff,
    basket_call,
    black_scholes_call,
    black_scholes_call_tensor,
    black_scholes_digital,
    black_scholes_put,
    black_scholes_quanto_call,
    digital_call,
    discount_factor,
    european_call,
    european_put,
    max_call,
    quanto_drift,
)
from montecarlo_tpu_torch.engine.dispatch import (  # noqa: F401
    kernel_route,
    payoff_block_moments,
    terminal_prices,
)
from montecarlo_tpu_torch.engine.functionals import (  # noqa: F401
    ARITH_MEAN,
    GEO_MEAN,
    RUNNING_MAX,
    RUNNING_MIN,
    PathFunctional,
    asian_call,
    autocallable,
    barrier_survival_up,
    cliquet_sum,
    down_and_out_call,
    geometric_asian_call_closed_form,
    lookback_call_floating,
    realized_variance,
    simulate_functionals,
    trapezoid_integral,
    up_and_out_call,
    variance_swap_strike_mc,
    worst_of_autocallable,
)
from montecarlo_tpu_torch.engine.pricing import (  # noqa: F401
    mc_estimate,
    price_to_tolerance,
    price_to_tolerance_rqmc,
    rqmc_estimate,
)
from montecarlo_tpu_torch.engine.greeks import (  # noqa: F401
    black_scholes_delta,
    black_scholes_vega,
    lr_greeks_gbm,
    price_and_greeks,
    second_order_greeks,
    smoothed_call,
    smoothed_digital,
)
from montecarlo_tpu_torch.engine.control_variate import (  # noqa: F401
    cv_estimate,
)
from montecarlo_tpu_torch.engine.importance import (  # noqa: F401
    importance_sampled_estimate,
    shift_to_strike,
    stratified_terminal_estimate,
)
from montecarlo_tpu_torch.engine.implied_vol import (  # noqa: F401
    implied_vol_call,
)
from montecarlo_tpu_torch.engine.surface import (  # noqa: F401
    mc_implied_vol_surface,
    price_snapshot,
)
from montecarlo_tpu_torch.engine.bermudan import (  # noqa: F401
    bermudan_swaption_lsm,
    lmm_bermudan_swaption_lsm,
    vasicek_swaption_jamshidian,
)
from montecarlo_tpu_torch.engine.american import (  # noqa: F401
    american_price_and_greeks,
    andersen_broadie_bound,
    andersen_broadie_bound_multi,
    andersen_broadie_bound_sv,
    binomial_american_put,
    lsm_exercise_policy,
    lsm_policy,
    lsm_policy_multi,
    lsm_policy_sv,
    lsm_price,
    lsm_price_multi,
    lsm_price_path_dependent,
    lsm_price_sv,
)
