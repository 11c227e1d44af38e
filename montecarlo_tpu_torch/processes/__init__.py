"""Stochastic processes (GBM in this slice of the port)."""

from montecarlo_tpu_torch.processes.base import NormalDrawsMixin  # noqa: F401
from montecarlo_tpu_torch.processes.gbm import GBM, GBMState  # noqa: F401
