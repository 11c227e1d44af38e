"""Variance-Gamma Levy process (Madan-Carr-Chang 1998).

    log S += (mu + omega) dt + theta G + sigma sqrt(G) z,
    G ~ Gamma(shape dt/nu, scale nu),
    omega = log(1 - theta nu - sigma^2 nu / 2) / nu

The port of ``montecarlo_tpu/processes/vg.py``.  The increment is exactly
VG at any step size.  G is ``nu`` times a Gamma(dt/nu) variate from
``rng.gamma.gamma_from_uniforms_table32``, whose shape-(1 + dt/nu) residual
quantile table (512 knots and their derivatives, ``gq_resid`` and
``gq_dresid``, with the first knot ``gq_z0`` and spacing ``gq_dz``) is
built once at create time.  Draws per step: the two inversion uniforms
``(u_w, u_boost)`` are both halves of cipher t on ``stream ^ VG_STREAM``,
the normal is index t of the main stream (two steps share a Box-Muller
pair).  The mirror reflects both uniforms and negates the normal.

K2, K3 and K4 run it as ``VgProc`` (``csrc/fused_engine.cu``), the table
passed after the six scalars with ``dims`` = 512; its oracle is
``engine.cf_pricing.vg_log_cf``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import torch

from montecarlo_tpu_torch.processes.base import (DeviceMixin, LogPriceMixin,
                                                 f32_leaves)
from montecarlo_tpu_torch.rng.gamma import (gamma_from_uniforms_table32,
                                            gamma_icdf_resid_table64)
from montecarlo_tpu_torch.rng.normal import (log32, normal_draw, normal_pair,
                                             uniform_draw, uniform_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32

VG_STREAM = 0x1F83D9AB  # key-stream offset of the inversion uniforms


class VGState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class VarianceGamma(LogPriceMixin, DeviceMixin):
    """Variance-Gamma log-returns with martingale correction.  Fields: six
    0-d float32 parameters, the table's first knot and spacing (0-d) and
    the (512,) residual table with its derivative, float32."""

    s0: torch.Tensor
    mu: torch.Tensor     # drift of E[S_t] per unit time
    sigma: torch.Tensor  # diffusion scale of the subordinated BM
    theta: torch.Tensor  # subordinated drift
    nu: torch.Tensor     # subordinator variance rate
    dt: torch.Tensor
    gq_z0: torch.Tensor
    gq_dz: torch.Tensor
    gq_resid: torch.Tensor
    gq_dresid: torch.Tensor

    n_draws: ClassVar[int] = 3  # u_w, u_boost, z
    draw_kinds: ClassVar[tuple] = ("uniform", "uniform", "normal")
    State: ClassVar[type] = VGState

    @classmethod
    def create(cls, s0, mu, sigma, theta, nu, dt,
               device="cuda") -> "VarianceGamma":
        if float(sigma) <= 0.0:
            raise ValueError("sigma must be positive")
        if float(nu) <= 0.0:
            raise ValueError("nu must be positive")
        if float(dt) > float(nu):
            raise ValueError(
                "need dt <= nu (gamma shape dt/nu <= 1 for the boost-"
                "identity sampler in rng/gamma.py) — use more steps")
        if 1.0 - float(theta) * float(nu) \
                - 0.5 * float(sigma) ** 2 * float(nu) <= 0.0:
            raise ValueError(
                "need theta*nu + sigma^2*nu/2 < 1 (finite E[S_t] for the "
                "martingale correction)")
        z0, dz, resid, dresid = gamma_icdf_resid_table64(
            1.0 + float(dt) / float(nu))
        leaves = f32_leaves(device, s0=s0, mu=mu, sigma=sigma, theta=theta,
                            nu=nu, dt=dt, gq_z0=z0, gq_dz=dz)
        dev = leaves["s0"].device
        return cls(**leaves, gq_resid=torch.from_numpy(resid).to(dev),
                   gq_dresid=torch.from_numpy(dresid).to(dev))

    def draws(self, seed, stream, path_ids, t):
        t = int(t)
        u_w = uniform_draw(seed, stream ^ VG_STREAM, path_ids,
                           (2 * t) & MASK32)
        u_b = uniform_draw(seed, stream ^ VG_STREAM, path_ids,
                           (2 * t + 1) & MASK32)
        return (u_w, u_b, normal_draw(seed, stream, path_ids, t & MASK32))

    def draws_pair(self, seed, stream, path_ids, j):
        """Steps (2j, 2j+1): the Box-Muller halves of counter j, and each
        step's uniforms both halves of counter 2j or 2j+1 on the VG
        stream."""
        j = int(j)
        za, zb = normal_pair(seed, stream, path_ids, j & MASK32)
        ua_w, ua_b = uniform_pair(seed, stream ^ VG_STREAM, path_ids,
                                  (2 * j) & MASK32)
        ub_w, ub_b = uniform_pair(seed, stream ^ VG_STREAM, path_ids,
                                  (2 * j + 1) & MASK32)
        return (ua_w, ua_b, za), (ub_w, ub_b, zb)

    def antithetic(self, eps):
        u_w, u_b, z = eps
        return (1.0 - u_w, 1.0 - u_b, -z)

    def omega(self):
        """Martingale correction per unit time: E[S_t] = s0 e^{mu t}."""
        return log32(1.0 - self.theta * self.nu
                     - 0.5 * torch.square(self.sigma) * self.nu) / self.nu

    def step(self, state: VGState, eps, t) -> VGState:
        u_w, u_b, z = eps
        g = self.nu * gamma_from_uniforms_table32(
            self.dt / self.nu, u_w, u_b, self.gq_z0, self.gq_dz,
            self.gq_resid, self.gq_dresid)
        drift = (self.mu + self.omega()) * self.dt
        return VGState(log_s=state.log_s
                       + (drift + self.theta * g
                          + self.sigma * torch.sqrt(g) * z))
