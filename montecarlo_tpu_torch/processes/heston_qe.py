"""Heston under Andersen's Quadratic-Exponential (QE-M) scheme.

The port of ``montecarlo_tpu/processes/heston_qe.py``.  The variance step
matches the exact conditional mean ``m`` and variance ``s2`` of the CIR
transition: below ``psi = s2/m^2 <= 1.5`` it is ``a (sqrt(b2) + z_v)^2``
with ``z_v = ndtri32(u)``, above it zero with probability ``p`` and an
exponential tail otherwise.  The log price takes Andersen's central
discretization with the per-path martingale-corrected drift constant K0*
(the plain K0 where the conditional MGF diverges).  Both branches are
computed and selected, in the JAX package's float32 order; the create-time
constants (``qe_constants``) ride as leaves.  Draws per step: one normal
(index t of the main stream) and one uniform (index t of ``stream ^
V_STREAM``); a step pair takes one Box-Muller pair and one uniform cipher.

K2, K3 and K4 run it as ``HestonQEProc`` (``csrc/fused_engine.cu``),
``ndtri32`` from ``csrc/rng.cuh``.  Its oracle is Heston's CF
(``processes.bates.bates_log_cf`` with ``lam = 0``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import (DeviceMixin,
                                                 LogVarianceMixin,
                                                 f32_leaves)
from montecarlo_tpu_torch.rng.normal import (log32, ndtri32, normal_draw,
                                             normal_pair, uniform_draw,
                                             uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32

V_STREAM = 0x5BE0CD19  # key-stream offset of the variance uniforms
PSI_C = 1.5            # Andersen's switching point


class HestonQEState(NamedTuple):
    log_s: torch.Tensor
    v: torch.Tensor  # >= 0 by construction


def qe_constants(kappa, theta, xi, rho, dt) -> dict:
    """The QE leaves from 0-d float32 parameters, in the JAX package's
    order: e^{-kappa dt}, s2 = v c1 + c2, K0 (the fallback), K1, K2,
    K3 = K4, A = K2 + K4/2."""
    e = torch.exp(-kappa * dt)
    c1 = xi * xi * e * (1.0 - e) / kappa
    c2 = theta * xi * xi * torch.square(1.0 - e) / (2.0 * kappa)
    g = 0.5
    rx = rho / xi
    k1 = g * dt * (kappa * rx - 0.5) - rx
    k2 = g * dt * (kappa * rx - 0.5) + rx
    k34 = g * dt * (1.0 - torch.square(rho))
    return dict(e_kdt=e, c1=c1, c2=c2, k0=-rx * kappa * theta * dt, k1=k1,
                k2=k2, k3=k34, k4=k34, mgf_a=k2 + 0.5 * k34)


def check_qe(xi, kappa, zero_xi: str) -> None:
    if float(xi) <= 0.0:
        raise ValueError(f"xi must be positive (xi=0 is {zero_xi})")
    if float(kappa) <= 0.0:
        raise ValueError("kappa must be positive (QE's conditional "
                         "moments use the mean-reverting transition)")


class QEVarianceMixin(LogVarianceMixin):
    """The QE variance transition and the martingale-corrected drift
    constant, shared by HestonQE and BatesQE."""

    def _next_v(self, v, u):
        """(v_next, quad, a, b2, p, beta) of one QE transition."""
        m = self.theta + (v - self.theta) * self.e_kdt
        s2 = v * self.c1 + self.c2
        m2 = torch.square(m)
        quad = s2 <= PSI_C * m2
        inv2 = 2.0 * m2 / s2
        tw1 = torch.clamp(inv2 - 1.0, min=0.0)
        b2 = torch.clamp(inv2 - 1.0 + torch.sqrt(inv2 * tw1), min=0.0)
        a = m / (1.0 + b2)
        z_v = ndtri32(u)
        v_quad = a * torch.square(torch.sqrt(b2) + z_v)
        p = (s2 - m2) / (s2 + m2)
        beta = (1.0 - p) / m
        tail = log32((1.0 - p) / (1.0 - u)) / beta
        v_exp = torch.where(u <= p, 0.0, torch.clamp(tail, min=0.0))
        return torch.where(quad, v_quad, v_exp), quad, a, b2, p, beta

    def _k0_star(self, v, quad, a, b2, p, beta):
        """Per-path K0* = -log E[e^{A v'} | v] - (K1 + K3/2) v, one log32
        on the branch's argument; the plain K0 where the MGF diverges."""
        A = self.mgf_a
        den = 1.0 - 2.0 * A * a
        ok_q = den > 0.0
        den_s = torch.where(ok_q, den, 1.0)
        gap = beta - A
        ok_e = gap > 0.0
        mgf_e = torch.clamp(p + beta * (1.0 - p)
                            / torch.where(ok_e, gap, 1.0), min=1e-30)
        lg = log32(torch.where(quad, den_s, mgf_e))
        lm = torch.where(quad, A * b2 * a / den_s - 0.5 * lg, lg)
        ok = (quad & ok_q) | (~quad & ok_e)
        head = -(self.k1 + 0.5 * self.k3) * v
        return torch.where(ok, head - lm, self.k0)

    def _qe_step(self, state, u):
        """(v', K0*, sqrt(K3 v + K4 v')) of one step: the new variance,
        the per-path drift constant and the log price's diffusion scale (0
        where K3 v + K4 v' is not positive)."""
        v = state.v
        v_new, quad, a, b2, p, beta = self._next_v(v, u)
        k0s = self._k0_star(v, quad, a, b2, p, beta)
        var_s = self.k3 * v + self.k4 * v_new
        positive = var_s > 0
        sq = torch.where(positive,
                         torch.sqrt(torch.where(positive, var_s, 1.0)), 0.0)
        return v_new, k0s, sq


@dataclass(frozen=True)
class HestonQE(QEVarianceMixin, DeviceMixin):
    """Heston under the Andersen QE-M scheme.  Every field is a 0-d
    float32 tensor; the last nine are ``qe_constants``'."""

    s0: torch.Tensor
    v0: torch.Tensor
    mu: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor
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

    n_draws: ClassVar[int] = 2  # z_asset, u_variance
    draw_kinds: ClassVar[tuple] = ("normal", "uniform")
    State: ClassVar[type] = HestonQEState

    @classmethod
    def create(cls, s0, v0, mu, kappa, theta, xi, rho, dt,
               device="cuda") -> "HestonQE":
        check_qe(xi, kappa, "BS — use GBM")
        p = f32_leaves(device, s0=s0, v0=v0, mu=mu, kappa=kappa,
                       theta=theta, xi=xi, rho=rho, dt=dt)
        return cls(**p, **qe_constants(p["kappa"], p["theta"], p["xi"],
                                       p["rho"], p["dt"]))

    def draws(self, seed, stream, path_ids, t):
        t = int(t) & MASK32
        return (normal_draw(seed, stream, path_ids, t),
                uniform_draw(seed, stream ^ V_STREAM, path_ids, t))

    def draws_pair(self, seed, stream, path_ids, j):
        """Steps (2j, 2j+1): the Box-Muller halves of counter j and both
        halves of counter j on the variance stream."""
        j = int(j) & MASK32
        z0, z1 = normal_pair(seed, stream, path_ids, j)
        u0, u1 = uniform_pair(seed, stream ^ V_STREAM, path_ids, j)
        return (z0, u0), (z1, u1)

    def antithetic(self, eps):
        z, u = eps
        return (-z, 1.0 - u)

    def step(self, state: HestonQEState, eps, t) -> HestonQEState:
        z_s, u = eps
        v_new, k0s, sq = self._qe_step(state, u)
        log_s = state.log_s + (self.mu * self.dt + k0s + self.k1 * state.v
                               + self.k2 * v_new + sq * z_s)
        return HestonQEState(log_s=log_s, v=v_new)
