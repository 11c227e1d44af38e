"""Black-Scholes implied volatility by a safeguarded Newton iteration.

The port of ``montecarlo_tpu/engine/implied_vol.py``, in float64 on the
host (``engine.payoffs.black_scholes_call_tensor`` and
``engine.greeks.black_scholes_vega``): a surface of a few hundred cells is
host work, and float64 keeps the Newton slope finite in the wings.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.engine.greeks import black_scholes_vega
from montecarlo_tpu_torch.engine.payoffs import (black_scholes_call_tensor,
                                                 host64)


def implied_vol_call(price, s0, strike, r, T, *, init=0.2,
                     n_iter: int = 32) -> torch.Tensor:
    """Implied vol of a European call: ``n_iter`` Newton steps, each
    clipped to +-0.5, sigma kept in [1e-4, 5].  Broadcasts over all five
    inputs, starting from their common shape; NaN where the price lies
    outside the no-arbitrage band ``(max(S - K e^{-rT}, 0), S)``.  A
    float64 host tensor."""
    price, s0, strike, r, T = map(host64, (price, s0, strike, r, T))
    lower = torch.clamp(s0 - strike * torch.exp(-r * T), min=0.0)
    valid = (price > lower + 1e-12) & (price < s0)
    shape = torch.broadcast_shapes(price.shape, s0.shape, strike.shape,
                                   r.shape, T.shape)
    sigma = torch.full(shape, float(init), dtype=torch.float64)
    for _ in range(n_iter):
        bs = black_scholes_call_tensor(s0, strike, r, sigma, T)
        vega = torch.clamp(black_scholes_vega(s0, strike, r, sigma, T),
                           min=1e-8)
        step = torch.clamp((bs - price) / vega, -0.5, 0.5)
        sigma = torch.clamp(sigma - step, 1e-4, 5.0)
    return torch.where(valid, sigma, torch.full_like(sigma, float("nan")))
