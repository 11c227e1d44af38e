"""Stochastic processes (GBM, Heston, the correlated GBM basket, MultiGBM,
the bootstrap GARCH, the jump processes Merton, Kou and Bates, the Levy
processes NIG and variance gamma, HestonQE, BatesQE, SABR, local
volatility and stochastic-local volatility with its particle calibration
and the Dupire surface) and the rough-Bergomi sampler."""

from montecarlo_tpu_torch.processes.base import NormalDrawsMixin  # noqa: F401
from montecarlo_tpu_torch.processes.basket import BasketGBM  # noqa: F401
from montecarlo_tpu_torch.processes.bates import (  # noqa: F401
    Bates,
    bates_log_cf,
)
from montecarlo_tpu_torch.processes.bates_qe import BatesQE  # noqa: F401
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
from montecarlo_tpu_torch.processes.heston_qe import HestonQE  # noqa: F401
from montecarlo_tpu_torch.processes.kou import Kou  # noqa: F401
from montecarlo_tpu_torch.processes.local_vol import (  # noqa: F401
    LocalVolGBM,
    LocalVolState,
)
from montecarlo_tpu_torch.processes.merton import (  # noqa: F401
    Merton,
    merton_call_series,
)
from montecarlo_tpu_torch.processes.multi_gbm import (  # noqa: F401
    MultiGBM,
    MultiGBMState,
)
from montecarlo_tpu_torch.processes.nig import NIG  # noqa: F401
from montecarlo_tpu_torch.processes.rough_bergomi import (  # noqa: F401
    RoughBergomi,
    rbergomi_simulate,
    volterra_joint_chol,
)
from montecarlo_tpu_torch.processes.sabr import SABR  # noqa: F401
from montecarlo_tpu_torch.processes.slv import (  # noqa: F401
    SLV,
    SLVKnots,
    SLVState,
    calibrate_slv,
    slv_to_kernel,
)
from montecarlo_tpu_torch.processes.vg import VarianceGamma  # noqa: F401
