"""Local volatility: sigma(t, S) from a sampled surface.

    d log S = (r - sigma(t, S)^2 / 2) dt + sigma(t, S) dW

The port of ``montecarlo_tpu/processes/local_vol.py``.  The surface is
``n_time_knots`` rows (16 by default) of 128 log-moneyness knots, row-major
in ``vol_flat``.  The row at step t is the hat-weight blend of the time
knots, summed from 0 over every knot in order as the JAX package does (only
the two bracketing knots weigh anything); the value at a path's
log-moneyness is linear between its two bracketing knots and flat outside
the grid.  JAX's one-hot contractions and lane gathers are workarounds for
XLA's and Mosaic's gathers; here plain indexing reads the same entries.

K2, K3 and K4 run it as ``LocalVolProc`` (``csrc/fused_engine.cu``) with
the same float32 operations (``csrc/surface.cuh``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, NamedTuple

import numpy as np
import torch

from montecarlo_tpu_torch.processes.base import (LogPriceMixin,
                                                 NormalDrawsMixin, f32_leaves)
from montecarlo_tpu_torch.rng.normal import log32

KNOTS = 128
DEFAULT_TIME_KNOTS = 16


def knot_index(u: torch.Tensor):
    """(i, frac) of grid coordinates u: i = clip(floor(u), 0, 126), taken
    in float before the integer cast (a NaN counts as 0, so every input
    has a defined index, as the card's saturating cast gives), and frac =
    clip(u - i, 0, 1) from the unclamped u."""
    i = torch.clamp(torch.nan_to_num(torch.floor(u), nan=0.0), 0.0,
                    KNOTS - 2.0)
    return i.to(torch.int64), torch.clamp(u - i, 0.0, 1.0)


def interp_row(row: torch.Tensor, x: torch.Tensor, x0, dx) -> torch.Tensor:
    """Linear interpolation of a (128,) knot row at log-moneyness x, flat
    outside the grid: v[i] (1 - frac) + v[i + 1] frac."""
    i, frac = knot_index((x - x0) / dx)
    return row[i] * (1.0 - frac) + row[i + 1] * frac


def blend_rows(table: torch.Tensor, steps, dt, dt_knot) -> torch.Tensor:
    """The rows of an (n_knots, 128) table at ``steps`` (an int: one (128,)
    row; a list: (len(steps), 128)): u = clip(t dt / dt_knot, 0, n_knots -
    1), row = sum_j max(1 - |u - j|, 0) table[j], summed from 0 in j
    order."""
    n = table.shape[0]
    t = torch.tensor(steps, dtype=torch.float32, device=table.device)
    u = torch.clamp(t * dt / dt_knot, 0.0, n - 1.0).reshape(t.shape + (1,))
    row = torch.zeros(t.shape + (KNOTS,), dtype=torch.float32,
                      device=table.device)
    for j in range(n):
        w = torch.clamp(1.0 - torch.abs(u - j), min=0.0)
        row = row + w * table[j]
    return row


def f32_table(rows: np.ndarray, device) -> torch.Tensor:
    """A float64 host table, rounded to float32 once and flattened."""
    return torch.from_numpy(rows.reshape(-1).astype(np.float32)).to(device)


class LocalVolState(NamedTuple):
    log_s: torch.Tensor  # (n_paths,)


@dataclass(frozen=True)
class LocalVolGBM(LogPriceMixin, NormalDrawsMixin):
    """GBM with state- and time-dependent volatility from a sampled
    surface.  The scalar fields are 0-d float32 tensors; ``vol_flat`` is
    the (n_time_knots * 128,) float32 surface."""

    s0: torch.Tensor
    rate: torch.Tensor
    dt: torch.Tensor
    x0: torch.Tensor        # first log-moneyness knot
    dx: torch.Tensor        # log-moneyness knot spacing
    dt_knot: torch.Tensor   # time-knot spacing (years)
    vol_flat: torch.Tensor  # (n_time_knots * 128,) row-major surface

    n_draws: ClassVar[int] = 1
    State: ClassVar[type] = LocalVolState

    @classmethod
    def create(cls, s0, rate, dt, n_steps: int,
               vol_fn: Callable[[float, np.ndarray], np.ndarray],
               x_min: float = -1.5, x_max: float = 1.5,
               n_time_knots: int | None = None,
               device="cuda") -> "LocalVolGBM":
        """Sample ``vol_fn(t, spots) -> vols`` on the host in float64 at
        ``n_time_knots`` knots j * dt_knot spanning [0, n_steps dt]
        (min(max(n_steps, 2), 16) unless given) over spots ``s0 *
        exp(x)``, x the 128 uniform knots of [x_min, x_max]; every leaf is
        then rounded to float32 once, as the JAX package does."""
        n_tk = (min(max(n_steps, 2), DEFAULT_TIME_KNOTS)
                if n_time_knots is None else n_time_knots)
        if n_tk < 2:
            raise ValueError("need at least 2 time knots")
        dt_knot = n_steps * float(dt) / (n_tk - 1)
        x = np.linspace(x_min, x_max, KNOTS)
        spots = float(s0) * np.exp(x)
        rows = np.stack([np.asarray(vol_fn(j * dt_knot, spots), np.float64)
                         for j in range(n_tk)])
        if rows.shape != (n_tk, KNOTS):
            raise ValueError(f"vol_fn must return {KNOTS} vols per knot")
        if np.any(rows <= 0) or not np.all(np.isfinite(rows)):
            raise ValueError("vol surface must be positive and finite")
        leaves = f32_leaves(device, s0=s0, rate=rate, dt=dt, x0=x[0],
                            dx=x[1] - x[0], dt_knot=dt_knot)
        return cls(**leaves, vol_flat=f32_table(rows, leaves["s0"].device))

    @property
    def n_time_knots(self) -> int:
        return self.vol_flat.numel() // KNOTS

    def _row(self, t: int) -> torch.Tensor:
        """The surface's (128,) row at step t."""
        return blend_rows(self.vol_flat.reshape(-1, KNOTS), t, self.dt,
                          self.dt_knot)

    def local_vol(self, log_s: torch.Tensor, t: int) -> torch.Tensor:
        """sigma(t, S): the step-t row at the paths' log-moneyness."""
        return interp_row(self._row(t), log_s - log32(self.s0), self.x0,
                          self.dx)

    def step(self, state: LocalVolState, eps, t) -> LocalVolState:
        sig = self.local_vol(state.log_s, t)
        drift = (self.rate - 0.5 * torch.square(sig)) * self.dt
        # Increment grouped before the add (see GBM.step).
        return LocalVolState(log_s=state.log_s + (
            drift + sig * torch.sqrt(self.dt) * eps[0]))
