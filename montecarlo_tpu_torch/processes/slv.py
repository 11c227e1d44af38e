"""Heston stochastic-local volatility (SLV), particle-calibrated leverage.

    d log S = (r - L(t,S)^2 v+ / 2) dt + L(t,S) sqrt(v+ dt) z_s
    dv      = kappa (theta - v+) dt + xi sqrt(v+ dt) z_v
    z_v     = rho z_s + sqrt(1 - rho^2) z_2,   v+ = max(v, 0)

The port of ``montecarlo_tpu/processes/slv.py`` (full-truncation Euler, the
double ``where`` around the square root, the increments grouped as there):

- :class:`SLV` keeps one exact leverage row per step, ``lev_rows`` of
  shape (n_steps, 128); step t reads row clip(t, 0, n_steps - 1).  K2-K4
  run it as ``SlvProc``, which reads that row through a pointer and an
  offset (the JAX kernels' ``KernelRows``);
- :class:`SLVKnots` keeps the leverage on hat-blended time knots, as
  :class:`LocalVolGBM` keeps its surface, built from an SLV by
  :func:`slv_to_kernel`.  K2-K4 blend its rows once, one per step (the
  row builder, ``ops.fused_engine.surface_rows``), and run them as an
  SLV's exact rows (``SlvProc``);
- :func:`calibrate_slv` fits the leverage to a local-vol target by the
  particle method (Guyon and Henry-Labordere): at each step the particles'
  E[v | S] on the 128 knots from cloud-in-cell deposits, smoothed and
  shrunk to the mean, sets L = clip(sigma_LV / sqrt(E[v | S]), lev_min,
  lev_max) (Gyongy), and the particles advance with that row by
  ``SLV.step`` itself, on the draws ``engine.simulate`` gives an SLV at the
  calibration seed.  JAX runs it as one ``lax.scan``; here it is a torch
  loop over the steps on the target's device.

The deposits are sums over the particles.  ``segment_sum`` has no
order-stable counterpart among torch's scatters on CUDA (``index_add_``,
``scatter_add_`` and ``bincount`` add floats with atomics, in an order that
changes from run to run), so each step writes every particle's two hat
weights into its row of a dense (n, 128) matrix, which rows never share,
and sums the columns with ``torch.sum``, a fixed-order reduction: the
leverage rows are the same bits from run to run at a fixed seed, on the
card and on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.processes.base import (LogVarianceMixin,
                                                 NormalDrawsMixin, f32_leaves)
from montecarlo_tpu_torch.processes.local_vol import (DEFAULT_TIME_KNOTS,
                                                      KNOTS, LocalVolGBM,
                                                      blend_rows, f32_table,
                                                      interp_row, knot_index)
from montecarlo_tpu_torch.rng.normal import log32, normal_pair
from montecarlo_tpu_torch.rng.threefry import key_from_seed


class SLVState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)
    v: torch.Tensor      # (n_paths,); may go negative, truncated at use


class _SLVStep(LogVarianceMixin, NormalDrawsMixin):
    """Heston mixing dynamics around a leverage L(t, S) = ``leverage``."""

    n_draws: ClassVar[int] = 2
    State: ClassVar[type] = SLVState

    def leverage(self, log_s: torch.Tensor, t: int) -> torch.Tensor:
        return interp_row(self._row(t), log_s - log32(self.s0), self.x0,
                          self.dx)

    def step(self, state: SLVState, eps, t) -> SLVState:
        z1, z2 = eps[0], eps[1]
        z_v = self.rho * z1 + torch.sqrt(1.0 - torch.square(self.rho)) * z2
        v_plus = torch.clamp(state.v, min=0.0)
        positive = v_plus > 0
        v_safe = torch.where(positive, v_plus, 1.0)
        sq_vdt = torch.where(positive, torch.sqrt(v_safe * self.dt), 0.0)
        lev = self.leverage(state.log_s, t)
        log_s = state.log_s + (
            (self.rate - 0.5 * torch.square(lev) * v_plus) * self.dt
            + lev * sq_vdt * z1)
        v = (state.v + self.kappa * (self.theta - v_plus) * self.dt
             + self.xi * sq_vdt * z_v)
        return SLVState(log_s=log_s, v=v)


@dataclass(frozen=True)
class SLV(_SLVStep):
    """Heston dynamics with one leverage row per step.  The scalar fields
    are 0-d float32 tensors; ``lev_rows`` is (n_steps, 128) float32."""

    s0: torch.Tensor
    rate: torch.Tensor
    v0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor
    dt: torch.Tensor
    x0: torch.Tensor        # first log-moneyness knot
    dx: torch.Tensor        # knot spacing
    lev_rows: torch.Tensor  # (n_steps, 128) per-step leverage

    def _row(self, t: int) -> torch.Tensor:
        """Row clip(t, 0, n_steps - 1): a step past the last row reads the
        last."""
        return self.lev_rows[min(max(int(t), 0), self.lev_rows.shape[0] - 1)]


@dataclass(frozen=True)
class SLVKnots(_SLVStep):
    """SLV with the leverage on hat-blended time knots (piecewise linear in
    time), as :class:`LocalVolGBM` keeps its surface; build one with
    :func:`slv_to_kernel`."""

    s0: torch.Tensor
    rate: torch.Tensor
    v0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor
    dt: torch.Tensor
    x0: torch.Tensor
    dx: torch.Tensor
    dt_knot: torch.Tensor   # time-knot spacing (years)
    lev_flat: torch.Tensor  # (n_knots * 128,) row-major leverage

    @property
    def n_time_knots(self) -> int:
        return self.lev_flat.numel() // KNOTS

    def _row(self, t: int) -> torch.Tensor:
        return blend_rows(self.lev_flat.reshape(-1, KNOTS), t, self.dt,
                          self.dt_knot)


def slv_to_kernel(slv: SLV, n_time_knots: int = DEFAULT_TIME_KNOTS
                  ) -> SLVKnots:
    """Resample an SLV's per-step rows onto ``n_time_knots`` time knots, in
    float64 on the host (knot j at j * horizon / (n_time_knots - 1) is the
    linear blend of its two bracketing step rows, flat at the ends), then
    rounded to float32, as the JAX package does."""
    rows = slv.lev_rows.double().cpu().numpy()
    n_steps = rows.shape[0]
    if n_time_knots < 2:
        raise ValueError("need at least 2 time knots")
    dt = float(slv.dt)
    dt_knot = n_steps * dt / (n_time_knots - 1)
    knot_rows = np.empty((n_time_knots, KNOTS))
    for j in range(n_time_knots):
        s = min(j * dt_knot / dt, n_steps - 1.0)
        k = int(min(int(s), n_steps - 2))
        f = s - k
        knot_rows[j] = (1.0 - f) * rows[k] + f * rows[k + 1]
    dev = slv.device
    return SLVKnots(s0=slv.s0, rate=slv.rate, v0=slv.v0, kappa=slv.kappa,
                    theta=slv.theta, xi=slv.xi, rho=slv.rho, dt=slv.dt,
                    x0=slv.x0, dx=slv.dx,
                    dt_knot=torch.tensor(np.float32(dt_knot), device=dev),
                    lev_flat=f32_table(knot_rows, dev))


def _smoothing_kernel(smooth_bins: int):
    """The triangular kernel of ``smooth_bins`` (odd) taps, unit mass, as
    float32 python floats."""
    half = (smooth_bins - 1) // 2
    kern = (np.convolve(np.ones(half + 1), np.ones(half + 1))
            / float((half + 1) ** 2))
    return [float(np.float32(k)) for k in kern]


def _smooth(x: torch.Tensor, kern) -> torch.Tensor:
    """``convolve(x, kern, mode="same")`` for a symmetric odd kernel: the
    taps summed in order over the zero-padded row."""
    half = (len(kern) - 1) // 2
    xp = torch.nn.functional.pad(x, (half, half))
    out = kern[0] * xp[:x.numel()]
    for k in range(1, len(kern)):
        out = out + kern[k] * xp[k:k + x.numel()]
    return out


def _deposit(i: torch.Tensor, frac: torch.Tensor, v_plus: torch.Tensor):
    """Cloud-in-cell deposits on the knots: (sum of weights, sum of weights
    times v+) per knot, each particle weighing 1 - frac at knot i and frac
    at knot i + 1; a dense (n, 128) matrix summed by column (see the
    module docstring)."""
    w = torch.zeros((i.numel(), KNOTS), dtype=torch.float32, device=i.device)
    w.scatter_(1, torch.stack([i, i + 1], dim=1),
               torch.stack([1.0 - frac, frac], dim=1))
    return w.sum(dim=0), (w * v_plus[:, None]).sum(dim=0)


def calibrate_slv(lv: LocalVolGBM, *, v0, kappa, theta, xi, rho,
                  n_steps: int, n_particles: int = 1 << 17, seed: int = 0,
                  reg: float = 1.0, lev_min: float = 0.05,
                  lev_max: float = 20.0, smooth_bins: int = 5) -> SLV:
    """An :class:`SLV` calibrated to the local-vol target ``lv`` (s0, rate,
    dt, the knot grid and sigma_LV(t, S); create it with the same
    ``n_steps`` and dt), on ``lv``'s device.

    ``v0``..``rho`` are the Heston mixing dynamics; ``n_particles`` the
    particles of the E[v | S] estimate, simulated with ``seed`` (ids 0 ..
    n - 1, stream 0); ``reg`` the shrink-to-mean weight in particles;
    ``smooth_bins`` the triangular smoothing width over the knots (odd).
    """
    from montecarlo_tpu_torch.engine.simulate import path_ids_for

    if smooth_bins < 1 or smooth_bins % 2 == 0:
        raise ValueError("smooth_bins must be odd and >= 1")
    dev = lv.device
    scalars = f32_leaves(dev, v0=v0, kappa=kappa, theta=theta, xi=xi,
                         rho=rho)
    lev_rows = torch.empty((n_steps, KNOTS), dtype=torch.float32, device=dev)
    slv = SLV(s0=lv.s0, rate=lv.rate, dt=lv.dt, x0=lv.x0, dx=lv.dx,
              lev_rows=lev_rows, **scalars)
    reg_, lo, hi = (float(np.float32(v)) for v in (reg, lev_min, lev_max))
    kern = _smoothing_kernel(smooth_bins)
    k0, k1 = key_from_seed(seed, 0)
    ids = path_ids_for(n_particles, 0, dev)
    state = slv.init_state(ids)
    log_s0 = log32(lv.s0)
    sig_rows = blend_rows(lv.vol_flat.reshape(-1, KNOTS),
                          list(range(n_steps)), lv.dt, lv.dt_knot)
    for t in range(n_steps):
        v_plus = torch.clamp(state.v, min=0.0)
        i, frac = knot_index((state.log_s - log_s0 - lv.x0) / lv.dx)
        denom, numer = _deposit(i, frac, v_plus)
        ev = ((_smooth(numer, kern) + reg_ * torch.mean(v_plus))
              / (_smooth(denom, kern) + reg_))
        lev = sig_rows[t] / torch.sqrt(torch.clamp(ev, min=1e-8))
        lev_rows[t] = torch.clamp(lev, lo, hi)
        state = slv.step(state, normal_pair(k0, k1, ids, t), t)
    return slv
