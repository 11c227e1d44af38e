"""Merton jump-diffusion: GBM plus compound-Poisson lognormal jumps.

    log S += (mu - lambda m - sigma^2/2) dt + sigma sqrt(dt) z1
             + jump_mean N + jump_std sqrt(N) z2,
    m = exp(jump_mean + jump_std^2/2) - 1

The port of ``montecarlo_tpu/processes/merton.py``.  The per-step count N
is the inverse CDF of a Poisson(lambda dt) truncated to {0..K_MAX}
(``poisson_count``: a chain of selects over ``u > cdf``, the pmf and cdf
accumulated in float32 in the JAX package's order), shared with Kou, Bates
and BatesQE.  Draws per step: z1 and z2 at normal draw indices 2t, 2t+1 of
the main stream, the count uniform at index t of the jump stream ``stream
^ JUMP_STREAM`` (a uniform never shares a cipher call with a Box-Muller
pair).  The antithetic mirror negates the normals and reflects the
uniform, ``1 - u``.

K2, K3 and K4 run it as ``MertonProc`` (``csrc/fused_engine.cu``).
``merton_call_series`` (Merton 1976) is its European-call oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.processes.base import (DeviceMixin, LogPriceMixin,
                                                 f32_leaves)
from montecarlo_tpu_torch.rng.normal import (exp32, normal_draw, normal_pair,
                                             uniform_draw, uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32

K_MAX = 4                  # truncated Poisson support
JUMP_STREAM = 0x6A09E667   # key-stream offset of the count uniforms


def check_jump_grid(lam, dt) -> None:
    """Reject per-step jump rates the K_MAX-truncated Poisson cannot carry
    (lam * dt > 0.4), with the JAX package's message."""
    rate = float(lam) * float(dt)
    if rate > 0.4:
        raise ValueError(
            f"lam*dt = {rate:.3f} too coarse for the K_MAX={K_MAX} "
            f"truncated Poisson (P(N>{K_MAX}) ~ {rate**5/120:.2e}); "
            "use more steps so lam*dt <= 0.4")


def poisson_count(u: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF Poisson(rate) on {0..K_MAX}, float32 counts: the count
    is the number of cdf levels ``u`` exceeds, the pmf and cdf built up as
    ``pmf * rate / k`` and ``cdf + pmf``."""
    pmf = exp32(-rate)
    cdf = pmf
    count = torch.zeros_like(u)
    for k in range(1, K_MAX + 1):
        pmf = pmf * rate / k
        count = torch.where(u > cdf, float(k), count)
        cdf = cdf + pmf
    return count


def jump_drift(mu, lam, m, sigma, dt):
    """The compensated per-step drift ``((mu - lam m) - sigma^2/2) dt``."""
    return (mu - lam * m - 0.5 * torch.square(sigma)) * dt


class MertonState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class Merton(LogPriceMixin, DeviceMixin):
    """Merton jump-diffusion with risk-drift compensation.  Every field is
    a 0-d float32 tensor on the process's device."""

    s0: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    lam: torch.Tensor        # jump intensity per unit time
    jump_mean: torch.Tensor  # mean of the log jump
    jump_std: torch.Tensor   # std of the log jump
    dt: torch.Tensor

    n_draws: ClassVar[int] = 3
    draw_kinds: ClassVar[tuple] = ("normal", "uniform", "normal")
    State: ClassVar[type] = MertonState

    @classmethod
    def create(cls, s0, mu, sigma, lam, jump_mean, jump_std, dt,
               device="cuda") -> "Merton":
        check_jump_grid(lam, dt)
        return cls(**f32_leaves(device, s0=s0, mu=mu, sigma=sigma, lam=lam,
                                jump_mean=jump_mean, jump_std=jump_std,
                                dt=dt))

    def draws(self, seed, stream, path_ids, t):
        m0 = 2 * int(t)
        z1 = normal_draw(seed, stream, path_ids, m0 & MASK32)
        z2 = normal_draw(seed, stream, path_ids, (m0 + 1) & MASK32)
        u = uniform_draw(seed, stream ^ JUMP_STREAM, path_ids,
                         int(t) & MASK32)
        return (z1, u, z2)

    def draws_pair(self, seed, stream, path_ids, j):
        """Steps (2j, 2j+1): the normals of pair counters 2j and 2j+1 and
        both halves of counter j on the jump stream; bitwise equal to
        :meth:`draws` at t = 2j and 2j+1."""
        j = int(j)
        z1a, z2a = normal_pair(seed, stream, path_ids, (2 * j) & MASK32)
        z1b, z2b = normal_pair(seed, stream, path_ids, (2 * j + 1) & MASK32)
        u0, u1 = uniform_pair(seed, stream ^ JUMP_STREAM, path_ids,
                              j & MASK32)
        return (z1a, u0, z2a), (z1b, u1, z2b)

    def antithetic(self, eps):
        z1, u, z2 = eps
        return (-z1, 1.0 - u, -z2)

    def step(self, state: MertonState, eps, t) -> MertonState:
        z1, u, z2 = eps
        n = poisson_count(u, self.lam * self.dt)
        m = exp32(self.jump_mean + 0.5 * torch.square(self.jump_std)) - 1.0
        drift = jump_drift(self.mu, self.lam, m, self.sigma, self.dt)
        jump = self.jump_mean * n + self.jump_std * torch.sqrt(n) * z2
        return MertonState(log_s=state.log_s
                           + (drift + self.sigma * torch.sqrt(self.dt) * z1
                              + jump))


def merton_call_series(s0, strike, r, sigma, lam, jump_mean, jump_std, T,
                       n_terms: int = 30) -> float:
    """Merton (1976) semi-analytic European call: the Poisson-weighted sum
    of Black-Scholes prices, in float64."""
    from scipy.stats import norm

    def bs(s0_, k_, r_, sig_, T_):
        d1 = (np.log(s0_ / k_) + (r_ + sig_**2 / 2) * T_) / (sig_
                                                             * np.sqrt(T_))
        d2 = d1 - sig_ * np.sqrt(T_)
        return s0_ * norm.cdf(d1) - k_ * np.exp(-r_ * T_) * norm.cdf(d2)

    m = np.exp(jump_mean + 0.5 * jump_std**2) - 1.0
    lam_p = lam * (1.0 + m)
    total = 0.0
    log_fact = 0.0
    for k in range(n_terms):
        if k > 0:
            log_fact += np.log(k)
        weight = np.exp(-lam_p * T + k * np.log(lam_p * T) - log_fact)
        sig_k = np.sqrt(sigma**2 + k * jump_std**2 / T)
        r_k = r - lam * m + k * (jump_mean + 0.5 * jump_std**2) / T
        total += weight * bs(s0, strike, r_k, sig_k, T)
    return float(total)
