"""Dupire local volatility from an implied-vol surface (host NumPy).

The port's own copy of ``montecarlo_tpu/processes/dupire.py``: Gatheral's
form of Dupire's formula in total implied variance w(y, T) = iv^2 T over
forward log-moneyness y = log(K / F_T),

                         dw/dT
    sigma_loc^2 = ---------------------------------------------------------
    1 - (y/w) w_y + 1/4 (-1/4 - 1/w + y^2/w^2) w_y^2 + 1/2 w_yy

evaluated in float64 NumPy on the host: resample each maturity's smile onto
a uniform y grid, finite-difference, evaluate the formula with
no-arbitrage guards.  The result feeds
:meth:`montecarlo_tpu_torch.processes.local_vol.LocalVolGBM.create`, the
same numbers as the JAX package's (the same NumPy operations).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def dupire_local_vol_grid(strikes, maturities, ivs, *, s0: float,
                          rate: float, n_y: int = 101,
                          vol_floor: float = 0.01, vol_cap: float = 2.0):
    """(t_grid, y_grid, sigma_loc) arrays from an implied-vol surface.

    Args:
      strikes: (K,) absolute strikes.
      maturities: (T,) year fractions (>= 2 pillars, increasing).
      ivs: (T, K) Black implied vols.

    Returns ``(maturities, y_grid, local_vols)`` with ``local_vols`` of
    shape (T, n_y) over *forward log-moneyness* y; values clamped to
    [vol_floor, vol_cap] where the surface is arbitrage-violating or the
    finite differences are unreliable (deep wings).
    """
    strikes = np.asarray(strikes, np.float64)
    mats = np.asarray(maturities, np.float64)
    ivs = np.asarray(ivs, np.float64)
    if ivs.shape != (mats.size, strikes.size):
        raise ValueError("ivs must be (n_maturities, n_strikes)")
    if mats.size < 2:
        raise ValueError("need >= 2 maturity pillars for dw/dT")

    # Total variance on a per-maturity forward log-moneyness axis, then
    # resampled to one uniform y grid (flat smile extrapolation).
    fwd = s0 * np.exp(rate * mats)                       # (T,)
    y_pm = np.log(strikes[None, :] / fwd[:, None])       # (T, K)
    y_lo, y_hi = y_pm.min(), y_pm.max()
    y = np.linspace(y_lo, y_hi, n_y)
    w = np.empty((mats.size, n_y))
    for j in range(mats.size):
        w_j = ivs[j] ** 2 * mats[j]
        order = np.argsort(y_pm[j])
        w[j] = np.interp(y, y_pm[j][order], w_j[order])

    # Finite differences (non-uniform T pillars handled by np.gradient).
    w_t = np.gradient(w, mats, axis=0)
    w_y = np.gradient(w, y, axis=1)
    w_yy = np.gradient(w_y, y, axis=1)

    w_safe = np.maximum(w, 1e-10)
    denom = (1.0 - y[None, :] / w_safe * w_y
             + 0.25 * (-0.25 - 1.0 / w_safe + y[None, :] ** 2 / w_safe**2)
             * w_y**2
             + 0.5 * w_yy)
    var_loc = np.where(denom > 1e-4, w_t / np.maximum(denom, 1e-4), np.nan)
    sig = np.sqrt(np.clip(var_loc, vol_floor**2, vol_cap**2))
    # NaNs (butterfly/calendar violations from data noise): fall back to
    # the implied vol at that point — conservative and always positive.
    sig = np.where(np.isfinite(sig), sig, np.sqrt(w_safe / mats[:, None]))
    return mats, y, sig


def local_vol_fn_from_ivs(strikes, maturities, ivs, *, s0: float,
                          rate: float, **kw) -> Callable:
    """``vol_fn(t, spots) -> vols`` for :meth:`LocalVolGBM.create`.

    Bilinear interpolation on the Dupire grid in (t, forward
    log-moneyness), edge-clamped (market practice: flat wings and flat
    short/long-end extrapolation).
    """
    mats, y, sig = dupire_local_vol_grid(strikes, maturities, ivs, s0=s0,
                                         rate=rate, **kw)

    def vol_fn(t, spots):
        t_c = np.clip(t, mats[0], mats[-1])
        j = np.searchsorted(mats, t_c, side="right") - 1
        j = int(np.clip(j, 0, mats.size - 2))
        u = (t_c - mats[j]) / (mats[j + 1] - mats[j])
        y_q = np.log(np.asarray(spots, np.float64) / s0) - rate * t_c
        row = (1.0 - u) * sig[j] + u * sig[j + 1]
        return np.interp(y_q, y, row)  # edge-clamped by np.interp

    return vol_fn


__all__ = ["dupire_local_vol_grid", "local_vol_fn_from_ivs"]
