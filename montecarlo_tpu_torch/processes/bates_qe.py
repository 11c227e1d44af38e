"""Bates under the Andersen QE-M variance scheme with Merton's exact jump
leg.

The port of ``montecarlo_tpu/processes/bates_qe.py``: HestonQE's variance
transition and martingale-corrected drift (``QEVarianceMixin``) plus the
aggregated lognormal jumps of Bates, compensated by ``-lam mbar dt``.
Draws per step: z_s and z_j at normal draw indices 2t, 2t+1 of the main
stream, the variance uniform at index t of ``stream ^ V_STREAM`` and the
count uniform at index t of ``stream ^ JUMP_STREAM``; a step pair takes two
Box-Muller pairs and one cipher call on each uniform stream.

K2, K3 and K4 run it as ``BatesQEProc`` (``csrc/fused_engine.cu``); its
oracle is ``processes.bates.bates_log_cf``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import DeviceMixin, f32_leaves
from montecarlo_tpu_torch.processes.bates import jump_leg
from montecarlo_tpu_torch.processes.heston_qe import (V_STREAM,
                                                      QEVarianceMixin,
                                                      check_qe, qe_constants)
from montecarlo_tpu_torch.processes.merton import (JUMP_STREAM,
                                                   check_jump_grid,
                                                   poisson_count)
from montecarlo_tpu_torch.rng.normal import (normal_draw, normal_pair,
                                             uniform_draw, uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32


class BatesQEState(NamedTuple):
    log_s: torch.Tensor
    v: torch.Tensor


@dataclass(frozen=True)
class BatesQE(QEVarianceMixin, DeviceMixin):
    """Bates stochastic-volatility jump-diffusion under QE-M.  Every field
    is a 0-d float32 tensor; the last nine are ``qe_constants``'."""

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
    e_kdt: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    k0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    mgf_a: torch.Tensor

    n_draws: ClassVar[int] = 4  # z_s, u_variance, u_count, z_jump
    draw_kinds: ClassVar[tuple] = ("normal", "uniform", "uniform", "normal")
    State: ClassVar[type] = BatesQEState

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, lam, jump_mean,
               jump_std, dt, device="cuda") -> "BatesQE":
        check_qe(xi, kappa, "Merton")
        check_jump_grid(lam, dt)
        p = f32_leaves(device, s0=s0, v0=v0, mu=mu, kappa=kappa,
                       theta=theta, xi=xi, rho=rho, lam=lam,
                       jump_mean=jump_mean, jump_std=jump_std, dt=dt)
        return cls(**p, **qe_constants(p["kappa"], p["theta"], p["xi"],
                                       p["rho"], p["dt"]))

    def draws(self, seed, stream, path_ids, t):
        m0 = 2 * int(t)
        tt = int(t) & MASK32
        return (normal_draw(seed, stream, path_ids, m0 & MASK32),
                uniform_draw(seed, stream ^ V_STREAM, path_ids, tt),
                uniform_draw(seed, stream ^ JUMP_STREAM, path_ids, tt),
                normal_draw(seed, stream, path_ids, (m0 + 1) & MASK32))

    def draws_pair(self, seed, stream, path_ids, j):
        """Steps (2j, 2j+1): pair counters 2j and 2j+1, and both halves of
        counter j on the variance and the jump streams."""
        j = int(j)
        z_s0, z_j0 = normal_pair(seed, stream, path_ids, (2 * j) & MASK32)
        z_s1, z_j1 = normal_pair(seed, stream, path_ids,
                                 (2 * j + 1) & MASK32)
        uv0, uv1 = uniform_pair(seed, stream ^ V_STREAM, path_ids,
                                j & MASK32)
        uc0, uc1 = uniform_pair(seed, stream ^ JUMP_STREAM, path_ids,
                                j & MASK32)
        return (z_s0, uv0, uc0, z_j0), (z_s1, uv1, uc1, z_j1)

    def antithetic(self, eps):
        z_s, u_v, u_c, z_j = eps
        return (-z_s, 1.0 - u_v, 1.0 - u_c, -z_j)

    def step(self, state: BatesQEState, eps, t) -> BatesQEState:
        z_s, u_v, u_c, z_j = eps
        v_new, k0s, sq = self._qe_step(state, u_v)
        n = poisson_count(u_c, self.lam * self.dt)
        jumps, mbar = jump_leg(n, self.jump_mean, self.jump_std, z_j)
        log_s = state.log_s + ((self.mu - self.lam * mbar) * self.dt + k0s
                               + self.k1 * state.v + self.k2 * v_new
                               + sq * z_s + jumps)
        return BatesQEState(log_s=log_s, v=v_new)
