"""Synthetic OHLCV generation — the offline stand-in for market data.

A copy of ``montecarlo_tpu/data/synthetic.py`` (pure numpy, the same
series for the same seed), so the port builds its GARCH histories without
importing the JAX package.  The reference fetches from yfinance (reference
app.py:887-896); this module provides deterministic synthetic series with
realistic structure (volatility clustering, volume correlated with absolute
returns).
"""

from __future__ import annotations

import numpy as np


def generate_ohlcv(n_days: int = 1260, seed: int = 0, s0: float = 100.0,
                   mu: float = 0.08, base_vol: float = 0.2,
                   vol_persistence: float = 0.95) -> dict:
    """Deterministic OHLCV dict of float64 numpy arrays of length n_days.

    Uses a stochastic-volatility random walk so features like vol regimes
    and GARCH fits have actual signal to find.
    """
    rng = np.random.default_rng(seed)
    dt = 1.0 / 252.0

    log_vol = np.log(base_vol)
    vols = np.empty(n_days)
    lv = log_vol
    for t in range(n_days):
        lv = (vol_persistence * lv + (1 - vol_persistence) * log_vol
              + 0.1 * rng.normal())
        vols[t] = np.exp(lv)

    z = rng.normal(size=n_days)
    rets = (mu - 0.5 * vols**2) * dt + vols * np.sqrt(dt) * z
    close = s0 * np.exp(np.cumsum(rets))

    open_ = np.empty(n_days)
    open_[0] = s0
    open_[1:] = close[:-1] * np.exp(0.1 * vols[1:] * np.sqrt(dt)
                                    * rng.normal(size=n_days - 1))
    intraday = np.abs(rng.normal(size=n_days)) * vols * np.sqrt(dt)
    high = np.maximum(open_, close) * np.exp(intraday * 0.5)
    low = np.minimum(open_, close) * np.exp(-intraday * 0.5)

    base_volume = 1e6
    volume = base_volume * np.exp(
        0.5 * rng.normal(size=n_days) + 5.0 * np.abs(rets))
    volume = np.round(volume)

    return {
        "Open": open_, "High": high, "Low": low,
        "Close": close, "Volume": volume,
    }
