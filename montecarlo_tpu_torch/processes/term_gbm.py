"""GBM with term structure: per-step drift and volatility curves,

    log S_{t+1} = log S_t + ((mu_t - sigma_t^2 / 2) dt + sigma_t sqrt(dt) z_t)

The port of ``montecarlo_tpu/processes/term_gbm.py``.  The curves are
stored as given, one entry a step: the JAX package pads them to a power of
two for Mosaic's layout, which is not ported (a JAX process's padded curves
come across as they are, padding included).  A step past a curve's end
raises ``ValueError`` (``max_steps``).  The log price is the state, so
log-space functionals fold it directly.  K2, K3 and K4 run it as
``RateProc<mc::TermGbmStep, 1>`` (``csrc/rate_steps.cuh``), the curves
read at the step index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import (LogPriceMixin,
                                                 NormalDrawsMixin, curve_at)


class TermGBMState(NamedTuple):
    log_s: torch.Tensor


@dataclass(frozen=True)
class TermStructureGBM(LogPriceMixin, NormalDrawsMixin):
    """GBM under deterministic drift and vol curves (per unit time), one
    entry a step.  ``s0`` and ``dt`` are 0-d float32 tensors, ``mu_t`` and
    ``sigma_t`` 1-d float32 tensors of one length."""

    s0: torch.Tensor
    mu_t: torch.Tensor
    sigma_t: torch.Tensor
    dt: torch.Tensor

    n_draws: ClassVar[int] = 1
    State: ClassVar[type] = TermGBMState

    @classmethod
    def from_curves(cls, s0, mu_curve, sigma_curve, dt,
                    device="cuda") -> "TermStructureGBM":
        mu_curve = np.asarray(mu_curve, np.float64).reshape(-1)
        sigma_curve = np.asarray(sigma_curve, np.float64).reshape(-1)
        if mu_curve.shape != sigma_curve.shape:
            raise ValueError("mu and sigma curves must share a length")
        if mu_curve.size < 1:
            raise ValueError("the curves need at least one step")
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return cls(s0=as_(s0), mu_t=as_(mu_curve), sigma_t=as_(sigma_curve),
                   dt=as_(dt))

    @classmethod
    def with_dividend(cls, s0, r, q, sigma, dt, n_steps: int,
                      device="cuda") -> "TermStructureGBM":
        """Constant rate r, continuous dividend yield q: mu = r - q."""
        return cls.from_curves(s0, np.full(n_steps, r - q),
                               np.full(n_steps, sigma), dt, device)

    @property
    def max_steps(self) -> int:
        return self.mu_t.numel()

    def step(self, state: TermGBMState, eps, t) -> TermGBMState:
        mu = curve_at(self.mu_t, t)
        sigma = curve_at(self.sigma_t, t)
        drift = (mu - 0.5 * torch.square(sigma)) * self.dt
        scale = sigma * torch.sqrt(self.dt)
        # Increment grouped before the accumulator add (see GBM.step).
        return TermGBMState(log_s=state.log_s + (drift + scale * eps[0]))
