"""Heston stochastic volatility, full-truncation Euler:

    log S_{t+1} = log S_t + ((mu - v+/2) dt + sqrt(v+ dt) z_1)
    v_{t+1}     = v_t + kappa (theta - v+) dt + xi sqrt(v+ dt) z_v
    z_v = rho z_1 + sqrt(1 - rho^2) z_2,   v+ = max(v, 0)

The port of ``montecarlo_tpu/processes/heston.py``, with its float32
operations in the same order: the grouped log-price increment, the
variance update summed left to right, and the double ``where`` around the
square root at v+ = 0.  Two draws per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.rng.normal import exp32, log32


class HestonState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)
    v: torch.Tensor      # (n_paths,); may go negative, truncated at use


@dataclass(frozen=True)
class Heston(NormalDrawsMixin):
    """Heston under full-truncation Euler.  Every field is a 0-d float32
    tensor on the process's device."""

    s0: torch.Tensor
    v0: torch.Tensor
    mu: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor
    dt: torch.Tensor

    n_draws: ClassVar[int] = 2

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, dt,
               device="cuda") -> "Heston":
        dev = resolve_device(device)
        as_ = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return cls(s0=as_(s0), v0=as_(v0), mu=as_(mu), kappa=as_(kappa),
                   theta=as_(theta), xi=as_(xi), rho=as_(rho), dt=as_(dt))

    def init_state(self, path_ids) -> HestonState:
        shape = path_ids.shape
        return HestonState(log_s=log32(self.s0).expand(shape).clone(),
                           v=self.v0.expand(shape).clone())

    def step(self, state: HestonState, eps, t) -> HestonState:
        z1, z2 = eps[0], eps[1]
        z_v = self.rho * z1 + torch.sqrt(1.0 - torch.square(self.rho)) * z2
        v_plus = torch.clamp(state.v, min=0.0)
        positive = v_plus > 0
        v_safe = torch.where(positive, v_plus, 1.0)
        sq_vdt = torch.where(positive, torch.sqrt(v_safe * self.dt), 0.0)
        log_s = state.log_s + ((self.mu - 0.5 * v_plus) * self.dt
                               + sq_vdt * z1)
        v = (state.v + self.kappa * (self.theta - v_plus) * self.dt
             + self.xi * sq_vdt * z_v)
        return HestonState(log_s=log_s, v=v)

    def prices(self, state: HestonState):
        return exp32(state.log_s)

    def log_prices(self, state: HestonState):
        return state.log_s
