"""Kou double-exponential jump-diffusion (Kou 2002).

    log S += (mu - lambda m - sigma^2/2) dt + sigma sqrt(dt) z
             + sum_{k < N} J_k,
    J ~ +Exp(eta1) with probability p_up, -Exp(eta2) otherwise,
    m = p eta1/(eta1 - 1) + (1 - p) eta2/(eta2 + 1) - 1

The port of ``montecarlo_tpu/processes/kou.py``.  The count N comes from
Merton's truncated Poisson; each of the K_MAX jump sizes is the inverse
CDF of one uniform with ONE ``log32`` on the ratio the uniform selects
(``u/q`` below ``q = 1 - p``, ``(1 - u)/p`` above), and all K_MAX sizes
are computed and added where ``N > k``.  Draws per step: one normal (index
t of the main stream) and 1 + K_MAX uniforms at indices ``t (1 + K_MAX) +
k`` of the jump stream; a step pair takes one Box-Muller pair and five
uniform cipher calls, whose ten halves split five and five in order.

K2, K3 and K4 run it as ``KouProc`` (``csrc/fused_engine.cu``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import (DeviceMixin, LogPriceMixin,
                                                 f32_leaves)
from montecarlo_tpu_torch.processes.merton import (JUMP_STREAM, K_MAX,
                                                   check_jump_grid,
                                                   jump_drift, poisson_count)
from montecarlo_tpu_torch.rng.normal import (log32, normal_draw, normal_pair,
                                             uniform_draw, uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32


class KouState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class Kou(LogPriceMixin, DeviceMixin):
    """Kou double-exponential jump-diffusion with risk-drift
    compensation.  Every field is a 0-d float32 tensor."""

    s0: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    lam: torch.Tensor    # jump intensity per unit time
    p_up: torch.Tensor   # probability a jump is upward
    eta1: torch.Tensor   # up-jump decay (> 1)
    eta2: torch.Tensor   # down-jump decay (> 0)
    dt: torch.Tensor

    n_draws: ClassVar[int] = 2 + K_MAX  # z, u_count, u_jump[0..K_MAX-1]
    draw_kinds: ClassVar[tuple] = ("normal",) + ("uniform",) * (1 + K_MAX)
    State: ClassVar[type] = KouState

    @classmethod
    def create(cls, s0, mu, sigma, lam, p_up, eta1, eta2, dt,
               device="cuda") -> "Kou":
        if float(eta1) <= 1.0:
            raise ValueError("eta1 must exceed 1 (finite E[e^J])")
        check_jump_grid(lam, dt)
        return cls(**f32_leaves(device, s0=s0, mu=mu, sigma=sigma, lam=lam,
                                p_up=p_up, eta1=eta1, eta2=eta2, dt=dt))

    def draws(self, seed, stream, path_ids, t):
        t = int(t)
        z = normal_draw(seed, stream, path_ids, t & MASK32)
        base = t * (1 + K_MAX)
        return (z,) + tuple(
            uniform_draw(seed, stream ^ JUMP_STREAM, path_ids,
                         (base + k) & MASK32) for k in range(1 + K_MAX))

    def draws_pair(self, seed, stream, path_ids, j):
        """Steps (2j, 2j+1): the Box-Muller halves of counter j and the
        ten halves of jump-stream counters 5j..5j+4, the first five to step
        2j; bitwise equal to :meth:`draws` at t = 2j and 2j+1."""
        j = int(j)
        z0, z1 = normal_pair(seed, stream, path_ids, j & MASK32)
        halves = []
        for k in range(1 + K_MAX):
            halves.extend(uniform_pair(seed, stream ^ JUMP_STREAM, path_ids,
                                       (j * (1 + K_MAX) + k) & MASK32))
        return ((z0,) + tuple(halves[:1 + K_MAX]),
                (z1,) + tuple(halves[1 + K_MAX:]))

    def antithetic(self, eps):
        return (-eps[0],) + tuple(1.0 - u for u in eps[1:])

    def _jump_size(self, u):
        """Inverse CDF of the asymmetric double exponential: one log32 of
        the ratio the uniform selects."""
        q = 1.0 - self.p_up
        down = u <= q
        ratio = torch.where(down, u / q, (1.0 - u) / self.p_up)
        lg = log32(torch.clamp(ratio, min=1e-38))
        return torch.where(down, lg / self.eta2, -lg / self.eta1)

    def mean_jump_factor(self):
        """m + 1 = E[e^J]."""
        return (self.p_up * self.eta1 / (self.eta1 - 1.0)
                + (1.0 - self.p_up) * self.eta2 / (self.eta2 + 1.0))

    def step(self, state: KouState, eps, t) -> KouState:
        z, u_count = eps[0], eps[1]
        n = poisson_count(u_count, self.lam * self.dt)
        jump = torch.zeros_like(state.log_s)
        for k in range(K_MAX):
            size = self._jump_size(eps[2 + k])
            jump = jump + torch.where(n > float(k), size, 0.0)
        m = self.mean_jump_factor() - 1.0
        drift = jump_drift(self.mu, self.lam, m, self.sigma, self.dt)
        scale = self.sigma * torch.sqrt(self.dt)
        return KouState(log_s=state.log_s + (drift + scale * z + jump))
