"""Bates (1996): Heston stochastic volatility plus Merton lognormal jumps.

    log S += ((mu - lam mbar - v+/2) dt + sqrt(v+ dt) z_s) + jumps,
    v     += kappa (theta - v+) dt + xi sqrt(v+ dt) z_v,
    jumps  = N jump_mean + sqrt(N) jump_std z_j,   N ~ Poisson(lam dt)

The port of ``montecarlo_tpu/processes/bates.py``: Heston's
full-truncation Euler with Merton's aggregated jump leg, in the JAX
package's float32 order.  Draws per step: z_s, z_perp, z_j at normal draw
indices 3t..3t+2 of the main stream and the count uniform at index t of the
jump stream; a step pair takes three Box-Muller pairs and one uniform
cipher call.

K2, K3 and K4 run it as ``BatesProc`` (``csrc/fused_engine.cu``).
``bates_log_cf`` (the Heston CF times the Merton jump CF) is its oracle,
priced by ``engine.cf_pricing.cf_call_price``; with ``lam = 0`` it is
Heston's, the oracle of HestonQE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.processes.base import (DeviceMixin,
                                                 LogVarianceMixin,
                                                 f32_leaves)
from montecarlo_tpu_torch.processes.merton import (JUMP_STREAM,
                                                   check_jump_grid,
                                                   poisson_count)
from montecarlo_tpu_torch.rng.normal import (exp32, normal_draw,
                                             normal_pair, uniform_draw,
                                             uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32


class BatesState(NamedTuple):
    log_s: torch.Tensor
    v: torch.Tensor


def jump_leg(n, jump_mean, jump_std, z_j):
    """Merton's aggregated jump sum and its compensator's mbar:
    ``(n jm + sqrt(n) js z_j, exp32(jm + js^2/2) - 1)``."""
    jumps = n * jump_mean + torch.sqrt(n) * jump_std * z_j
    mbar = exp32(jump_mean + 0.5 * torch.square(jump_std)) - 1.0
    return jumps, mbar


@dataclass(frozen=True)
class Bates(LogVarianceMixin, DeviceMixin):
    """Bates stochastic-volatility jump-diffusion, full-truncation Euler.
    Every field is a 0-d float32 tensor."""

    s0: torch.Tensor
    v0: torch.Tensor
    mu: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor
    lam: torch.Tensor
    jump_mean: torch.Tensor
    jump_std: torch.Tensor
    dt: torch.Tensor

    n_draws: ClassVar[int] = 4  # z_s, z_perp, u_count, z_jump
    draw_kinds: ClassVar[tuple] = ("normal", "normal", "uniform", "normal")
    State: ClassVar[type] = BatesState

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, lam, jump_mean,
               jump_std, dt, device="cuda") -> "Bates":
        check_jump_grid(lam, dt)
        return cls(**f32_leaves(device, s0=s0, v0=v0, mu=mu, kappa=kappa,
                                theta=theta, xi=xi, rho=rho, lam=lam,
                                jump_mean=jump_mean, jump_std=jump_std,
                                dt=dt))

    def draws(self, seed, stream, path_ids, t):
        m0 = 3 * int(t)
        z_s, z_p, z_j = (normal_draw(seed, stream, path_ids,
                                     (m0 + d) & MASK32) for d in range(3))
        u = uniform_draw(seed, stream ^ JUMP_STREAM, path_ids,
                         int(t) & MASK32)
        return (z_s, z_p, u, z_j)

    def draws_pair(self, seed, stream, path_ids, j):
        """Steps (2j, 2j+1): the six halves of pair counters 3j..3j+2 in
        order and both halves of jump-stream counter j; bitwise equal to
        :meth:`draws` at t = 2j and 2j+1."""
        c = 3 * int(j)
        z_s0, z_p0 = normal_pair(seed, stream, path_ids, c & MASK32)
        z_j0, z_s1 = normal_pair(seed, stream, path_ids, (c + 1) & MASK32)
        z_p1, z_j1 = normal_pair(seed, stream, path_ids, (c + 2) & MASK32)
        u0, u1 = uniform_pair(seed, stream ^ JUMP_STREAM, path_ids,
                              int(j) & MASK32)
        return (z_s0, z_p0, u0, z_j0), (z_s1, z_p1, u1, z_j1)

    def antithetic(self, eps):
        z_s, z_p, u, z_j = eps
        return (-z_s, -z_p, 1.0 - u, -z_j)

    def step(self, state: BatesState, eps, t) -> BatesState:
        z_s, z_p, u, z_j = eps
        z_v = self.rho * z_s + torch.sqrt(1.0 - torch.square(self.rho)) * z_p
        v_plus = torch.clamp(state.v, min=0.0)
        positive = v_plus > 0
        v_safe = torch.where(positive, v_plus, 1.0)
        sq_vdt = torch.where(positive, torch.sqrt(v_safe * self.dt), 0.0)
        n = poisson_count(u, self.lam * self.dt)
        jumps, mbar = jump_leg(n, self.jump_mean, self.jump_std, z_j)
        log_s = state.log_s + (((self.mu - self.lam * mbar) - 0.5 * v_plus)
                               * self.dt + sq_vdt * z_s + jumps)
        v = (state.v + self.kappa * (self.theta - v_plus) * self.dt
             + self.xi * sq_vdt * z_v)
        return BatesState(log_s=log_s, v=v)


def heston_log_cf(s0, r, v0, kappa, theta, xi, rho, T):
    """Risk-neutral CF of ln S_T under Heston, the trap form (the JAX
    package's ``engine/heston_analytic.py::_phi`` with j = 2), complex128
    numpy over a complex argument array."""

    def phi(u):
        u = np.asarray(u, np.complex128)
        iu = 1j * u
        a = kappa * theta
        b = kappa
        uu = -0.5
        d = np.sqrt((rho * xi * iu - b) ** 2
                    - xi**2 * (2 * uu * iu - u**2))
        # 1/g of the trap form, as one quotient: at u = -i its numerator
        # is 0 where g's denominator is (JAX's complex 1/inf is 0 there).
        big_g = (b - rho * xi * iu - d) / (b - rho * xi * iu + d)
        c = (r * iu * T + a / xi**2 * (
            (b - rho * xi * iu - d) * T
            - 2.0 * np.log((1 - big_g * np.exp(-d * T)) / (1 - big_g))))
        dd = ((b - rho * xi * iu - d) / xi**2
              * ((1 - np.exp(-d * T)) / (1 - big_g * np.exp(-d * T))))
        return np.exp(c + dd * v0 + iu * np.log(s0))

    return phi


def bates_log_cf(s0, r, v0, kappa, theta, xi, rho, lam, jump_mean,
                 jump_std, T):
    """Risk-neutral CF of ln S_T under Bates: the Heston CF times
    ``exp(lam T (e^{iu jm - u^2 js^2/2} - 1) - iu lam mbar T)``."""
    heston = heston_log_cf(s0, r, v0, kappa, theta, xi, rho, T)
    mbar = float(np.exp(jump_mean + 0.5 * jump_std**2) - 1.0)

    def phi(us):
        us = np.asarray(us, np.complex128)
        iu = 1j * us
        jump = np.exp(lam * T * (np.exp(iu * jump_mean
                                        - 0.5 * jump_std**2 * us * us)
                                 - 1.0)
                      - iu * lam * mbar * T)
        return heston(us) * jump

    return phi
