"""Path-simulation engine, payoffs and Monte Carlo estimators."""

from montecarlo_tpu_torch.engine.simulate import (  # noqa: F401
    check_sampler,
    path_ids_for,
    replay_paths,
    simulate,
)
from montecarlo_tpu_torch.engine.payoffs import (  # noqa: F401
    VanillaPayoff,
    black_scholes_call,
    black_scholes_digital,
    black_scholes_put,
    digital_call,
    discount_factor,
    european_call,
    european_put,
)
from montecarlo_tpu_torch.engine.dispatch import (  # noqa: F401
    payoff_block_moments,
    terminal_prices,
)
from montecarlo_tpu_torch.engine.pricing import (  # noqa: F401
    mc_estimate,
    price_to_tolerance,
)
