"""SABR stochastic-volatility model (Hagan et al. 2002), forward measure.

    F'     = max(F+ + sigma F+^beta sqrt(dt) z1, 0),   F+ = max(F, 0)
    sigma' = sigma exp32(nu sqrt(dt) w2 - nu^2 dt / 2)
    w2     = rho z1 + sqrt(1 - rho^2) z2

The port of the process in ``montecarlo_tpu/processes/sabr.py``: Euler on
the forward, absorbed at zero, and the exact lognormal step of the vol.
Two normal draws per step (``NormalDrawsMixin``), so the Sobol samplers
take it.  The prices are the forward itself; it has no ``log_prices``, so
log-space functionals observe ``log32(prices)``.

The power ``F+^beta`` is ``exp32(beta log32(F+))`` for F+ > 0, 0 at F+ = 0
(1 when beta = 0, as ``jnp.power`` gives), so the torch versions and the
kernel run the same IEEE operations; it agrees with ``jnp.power`` to a few
float32 ULP for F+ in log32's range [2.5e-9, 5e8].

K2, K3 and K4 run it as ``SabrProc`` (``csrc/fused_engine.cu``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import NormalDrawsMixin, f32_leaves
from montecarlo_tpu_torch.rng.normal import exp32, log32


class SABRState(NamedTuple):
    f: torch.Tensor      # forward
    sigma: torch.Tensor  # instantaneous vol


def cev_power(f_plus: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``f_plus ** beta`` for f_plus >= 0 as ``exp32(beta log32(f))``,
    with ``jnp.power``'s value at 0: 0, or 1 when beta = 0."""
    at_zero = torch.where(beta == 0.0, 1.0, 0.0)
    return torch.where(f_plus > 0.0, exp32(beta * log32(f_plus)), at_zero)


@dataclass(frozen=True)
class SABR(NormalDrawsMixin):
    """SABR under the forward measure (driftless forward).  Every field is
    a 0-d float32 tensor."""

    f0: torch.Tensor
    alpha: torch.Tensor  # initial vol sigma_0
    beta: torch.Tensor   # CEV exponent in [0, 1]
    nu: torch.Tensor     # vol-of-vol
    rho: torch.Tensor    # corr(forward, vol)
    dt: torch.Tensor

    n_draws: ClassVar[int] = 2

    @classmethod
    def create(cls, f0, alpha, beta, nu, rho, dt, device="cuda") -> "SABR":
        return cls(**f32_leaves(device, f0=f0, alpha=alpha, beta=beta, nu=nu,
                                rho=rho, dt=dt))

    def init_state(self, path_ids) -> SABRState:
        shape = path_ids.shape
        return SABRState(f=self.f0.expand(shape).clone(),
                         sigma=self.alpha.expand(shape).clone())

    def step(self, state: SABRState, eps, t) -> SABRState:
        z1, z2 = eps
        w2 = self.rho * z1 + torch.sqrt(1.0 - torch.square(self.rho)) * z2
        sqdt = torch.sqrt(self.dt)
        f_plus = torch.clamp(state.f, min=0.0)
        df = state.sigma * cev_power(f_plus, self.beta) * sqdt * z1
        f_new = torch.clamp(f_plus + df, min=0.0)
        sig_new = state.sigma * exp32(
            self.nu * sqdt * w2 - 0.5 * torch.square(self.nu) * self.dt)
        return SABRState(f=f_new, sigma=sig_new)

    def prices(self, state: SABRState):
        return state.f
