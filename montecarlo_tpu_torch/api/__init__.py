"""Public API: the reference's GARCH Monte Carlo and portfolio VaR/CVaR."""

from montecarlo_tpu_torch.api.montecarlo import garch_monte_carlo  # noqa: F401
from montecarlo_tpu_torch.api.var import (  # noqa: F401
    portfolio_var,
    portfolio_var_on_device,
)
