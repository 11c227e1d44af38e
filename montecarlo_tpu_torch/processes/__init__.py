"""Stochastic processes (GBM, Heston, the correlated GBM basket, MultiGBM
and the bootstrap GARCH) and the rough-Bergomi sampler."""

from montecarlo_tpu_torch.processes.base import NormalDrawsMixin  # noqa: F401
from montecarlo_tpu_torch.processes.basket import BasketGBM  # noqa: F401
from montecarlo_tpu_torch.processes.garch import (  # noqa: F401
    MIN_HISTORY,
    GARCHBootstrap,
    GARCHState,
)
from montecarlo_tpu_torch.processes.gbm import GBM, GBMState  # noqa: F401
from montecarlo_tpu_torch.processes.heston import (  # noqa: F401
    Heston,
    HestonState,
)
from montecarlo_tpu_torch.processes.multi_gbm import (  # noqa: F401
    MultiGBM,
    MultiGBMState,
)
from montecarlo_tpu_torch.processes.rough_bergomi import (  # noqa: F401
    RoughBergomi,
    rbergomi_simulate,
    volterra_joint_chol,
)
