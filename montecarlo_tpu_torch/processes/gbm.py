"""Geometric Brownian motion, log-Euler (exact for GBM):

    log S_{t+1} = log S_t + ((mu - sigma^2/2) dt + sigma sqrt(dt) z_t)

The port of ``montecarlo_tpu/processes/gbm.py``: ``log32`` for the initial
log-price, ``exp32`` for prices, and the step increment grouped before the
accumulator add.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.rng.normal import exp32, log32


class GBMState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class GBM(NormalDrawsMixin):
    """Single-asset GBM; ``mu``/``sigma`` per unit time, step ``dt``.  Every
    field is a 0-d float32 tensor on the process's device."""

    s0: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    dt: torch.Tensor

    n_draws: ClassVar[int] = 1

    @classmethod
    def create(cls, s0, mu, sigma, dt, device="cuda") -> "GBM":
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma), dt=as_(dt))

    def drift_scale(self):
        """(drift, scale) of one step, float32, in the JAX package's order."""
        drift = (self.mu - 0.5 * torch.square(self.sigma)) * self.dt
        scale = self.sigma * torch.sqrt(self.dt)
        return drift, scale

    def init_state(self, path_ids) -> GBMState:
        log_s0 = log32(self.s0)
        return GBMState(log_s=log_s0.expand(path_ids.shape).clone())

    def step(self, state: GBMState, eps, t) -> GBMState:
        drift, scale = self.drift_scale()
        # The increment is grouped BEFORE the accumulator add: adding the
        # small constant drift to the large log-price each step has a
        # systematic f32 rounding bias; one add of the grouped increment
        # does not.
        return GBMState(log_s=state.log_s + (drift + scale * eps[0]))

    def prices(self, state: GBMState):
        return exp32(state.log_s)

    def log_prices(self, state: GBMState):
        """Native log prices: log-space path functionals fold these directly
        instead of ``log32(exp32(log_s))``, which is a few ULP off."""
        return state.log_s
