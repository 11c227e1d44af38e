"""Public API: the reference's GARCH Monte Carlo, portfolio VaR/CVaR, and
stress and scenario grids."""

from montecarlo_tpu_torch.api.montecarlo import garch_monte_carlo  # noqa: F401
from montecarlo_tpu_torch.api.stress import (  # noqa: F401
    ladder,
    standard_scenarios,
    stress_grid,
    stress_report,
)
from montecarlo_tpu_torch.api.var import (  # noqa: F401
    portfolio_var,
    portfolio_var_on_device,
)
