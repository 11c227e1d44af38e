"""Correlated multi-asset GBM, matrix state (BASELINE.json config 3):

    log S_{t+1,a} = log S_{t,a} + ((mu_a - sigma_a^2/2) dt
                                   + sigma_a sqrt(dt) (L z_t)_a)

The port of ``montecarlo_tpu/processes/multi_gbm.py``: an (n_paths, A)
log-price state, ``n_assets`` i.i.d. normals per step in the
``t * A + d`` draw convention, and the correlation as one true-float32
product ``z @ L^T`` per step (``factor_product``'s precision guard), the
increment grouped before the accumulator add.  No kernel runs it: it is
the torch time loop's process, as MultiGBM is the scan engine's in the JAX
package (the max-call and the worst-of note).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.precision import factor_product
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.rng.normal import exp32, log32


class MultiGBMState(NamedTuple):
    log_s: torch.Tensor  # (n_paths, n_assets)


@dataclass(frozen=True)
class MultiGBM(NormalDrawsMixin):
    """Basket of correlated GBM assets; fields in the JAX NamedTuple's
    order, float32 on the process's device."""

    s0: torch.Tensor     # (A,)
    mu: torch.Tensor     # (A,)
    sigma: torch.Tensor  # (A,)
    chol: torch.Tensor   # (A, A) lower-triangular
    dt: torch.Tensor

    @classmethod
    def create(cls, s0, mu, sigma, corr, dt, device="cuda") -> "MultiGBM":
        dev = resolve_device(device)
        chol = np.linalg.cholesky(np.asarray(corr, np.float64))
        as_ = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
        return cls(s0=as_(s0), mu=as_(mu), sigma=as_(sigma), chol=as_(chol),
                   dt=as_(dt))

    @property
    def n_draws(self) -> int:
        return self.s0.shape[0]

    def init_state(self, path_ids) -> MultiGBMState:
        log_s0 = log32(self.s0)
        return MultiGBMState(log_s=log_s0.expand(path_ids.shape[0],
                                                 self.n_draws).clone())

    def step(self, state: MultiGBMState, eps, t) -> MultiGBMState:
        # A float32 product, as JAX's ``preferred_element_type=float32``
        # gives it for a float64 state too.
        zc = factor_product(torch.stack(eps, dim=-1), self.chol.T).to(
            torch.float32).to(state.log_s.dtype)
        drift = (self.mu - 0.5 * torch.square(self.sigma)) * self.dt
        scale = self.sigma * torch.sqrt(self.dt)
        return MultiGBMState(log_s=state.log_s + (drift + scale * zc))

    def prices(self, state: MultiGBMState):
        return exp32(state.log_s)

    def log_prices(self, state: MultiGBMState):
        """Native log prices: log-space functionals fold these directly."""
        return state.log_s
