"""Normal-inverse-Gaussian Levy process (Barndorff-Nielsen 1997).

    log S += (mu + omega) dt + beta I + sqrt(I) z,
    I ~ InverseGaussian(delta dt, gamma),   gamma = sqrt(alpha^2 - beta^2),
    omega = delta (sqrt(alpha^2 - (beta + 1)^2) - gamma)

The port of ``montecarlo_tpu/processes/nig.py``.  The increment is exactly
NIG at any step size.  The IG increment is the Michael-Schucany-Haas
transform in its cancellation-free form (``x = m z_ig^2``, ``s = sqrt(x (x
+ 4 lam))``, ``y = 4 lam m x / (x + s)^2``), keeping ``y`` where ``u (m +
y) <= m`` and taking ``m^2 / y`` otherwise.  Draws per step: z_ig and z at
normal draw indices 2t, 2t+1 of the main stream, the accept uniform at
index t of ``stream ^ IG_STREAM``: Merton's layout.

K2, K3 and K4 run it as ``NigProc`` (``csrc/fused_engine.cu``); its oracle
is ``engine.cf_pricing.nig_log_cf``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import (DeviceMixin, LogPriceMixin,
                                                 f32_leaves)
from montecarlo_tpu_torch.rng.normal import (normal_draw, normal_pair,
                                             uniform_draw, uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32

IG_STREAM = 0x510E527F  # key-stream offset of the IG accept uniforms


class NIGState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class NIG(LogPriceMixin, DeviceMixin):
    """NIG log-returns with martingale correction.  Every field is a 0-d
    float32 tensor."""

    s0: torch.Tensor
    mu: torch.Tensor     # drift of E[S_t] per unit time
    alpha: torch.Tensor  # tail heaviness (> |beta + 1|)
    beta: torch.Tensor   # skewness
    delta: torch.Tensor  # scale per unit time (> 0)
    dt: torch.Tensor

    n_draws: ClassVar[int] = 3  # z_ig, u (accept), z
    draw_kinds: ClassVar[tuple] = ("normal", "uniform", "normal")
    State: ClassVar[type] = NIGState

    @classmethod
    def create(cls, s0, mu, alpha, beta, delta, dt, device="cuda") -> "NIG":
        if float(delta) <= 0.0:
            raise ValueError("delta must be positive")
        if float(alpha) <= abs(float(beta)):
            raise ValueError("need alpha > |beta| (gamma real)")
        if float(alpha) <= abs(float(beta) + 1.0):
            raise ValueError(
                "need alpha > |beta + 1| (finite E[S_t] for the "
                "martingale correction)")
        return cls(**f32_leaves(device, s0=s0, mu=mu, alpha=alpha, beta=beta,
                                delta=delta, dt=dt))

    def draws(self, seed, stream, path_ids, t):
        m0 = 2 * int(t)
        z_ig = normal_draw(seed, stream, path_ids, m0 & MASK32)
        z = normal_draw(seed, stream, path_ids, (m0 + 1) & MASK32)
        u = uniform_draw(seed, stream ^ IG_STREAM, path_ids, int(t) & MASK32)
        return (z_ig, u, z)

    def draws_pair(self, seed, stream, path_ids, j):
        """Steps (2j, 2j+1): pair counters 2j and 2j+1 and both halves of
        counter j on the IG stream; bitwise equal to :meth:`draws`."""
        j = int(j)
        za, zb = normal_pair(seed, stream, path_ids, (2 * j) & MASK32)
        zc, zd = normal_pair(seed, stream, path_ids, (2 * j + 1) & MASK32)
        u0, u1 = uniform_pair(seed, stream ^ IG_STREAM, path_ids,
                              j & MASK32)
        return (za, u0, zb), (zc, u1, zd)

    def antithetic(self, eps):
        z_ig, u, z = eps
        return (-z_ig, 1.0 - u, -z)

    def _gamma(self):
        return torch.sqrt(torch.square(self.alpha) - torch.square(self.beta))

    def _ig_increment(self, z_ig, u):
        """Exact IG(delta dt, gamma) increment, branch-free."""
        a = self.delta * self.dt
        m = a / self._gamma()
        lam = torch.square(a)
        nu = torch.clamp(torch.square(z_ig), min=1e-12)
        x = m * nu
        s = torch.sqrt(x * (x + 4.0 * lam))
        y = 4.0 * lam * m * x / torch.square(x + s)
        return torch.where(u * (m + y) <= m, y, torch.square(m) / y)

    def omega(self):
        """Martingale correction per unit time: E[S_t] = s0 e^{mu t}."""
        return self.delta * (torch.sqrt(torch.square(self.alpha)
                                        - torch.square(self.beta + 1.0))
                             - self._gamma())

    def step(self, state: NIGState, eps, t) -> NIGState:
        z_ig, u, z = eps
        inc = self._ig_increment(z_ig, u)
        drift = (self.mu + self.omega()) * self.dt
        return NIGState(log_s=state.log_s
                        + (drift + self.beta * inc + torch.sqrt(inc) * z))
