"""Public API: the reference's GARCH Monte Carlo and single-card VaR/CVaR."""

from montecarlo_tpu_torch.api.montecarlo import garch_monte_carlo  # noqa: F401
from montecarlo_tpu_torch.api.var import portfolio_var_on_device  # noqa: F401
