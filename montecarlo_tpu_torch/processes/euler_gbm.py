"""Euler–Maruyama GBM, the biased discretization in price space:

    S_{t+1} = S_t ((1 + mu dt) + sigma sqrt(dt) z_t)

The port of ``montecarlo_tpu/processes/euler_gbm.py``, grouped as the JAX
package groups it; the prices are the state itself.  It has no
``log_prices``, so log-space functionals observe ``log32(prices)``.  K2, K3
and K4 run it as ``RateProc<mc::EulerGbmStep, 1>``
(``csrc/rate_steps.cuh``, ``csrc/fused_rates.cu``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import NormalDrawsMixin, f32_leaves


class EulerGBMState(NamedTuple):
    s: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class EulerGBM(NormalDrawsMixin):
    """Single-asset GBM under the arithmetic Euler scheme.  Every field is
    a 0-d float32 tensor."""

    s0: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    dt: torch.Tensor

    n_draws: ClassVar[int] = 1

    @classmethod
    def create(cls, s0, mu, sigma, dt, device="cuda") -> "EulerGBM":
        return cls(**f32_leaves(device, s0=s0, mu=mu, sigma=sigma, dt=dt))

    def init_state(self, path_ids) -> EulerGBMState:
        return EulerGBMState(s=self.s0.expand(path_ids.shape).clone())

    def step(self, state: EulerGBMState, eps, t) -> EulerGBMState:
        drift = self.mu * self.dt
        scale = self.sigma * torch.sqrt(self.dt)
        return EulerGBMState(s=state.s * ((1.0 + drift) + scale * eps[0]))

    def prices(self, state: EulerGBMState):
        return state.s
