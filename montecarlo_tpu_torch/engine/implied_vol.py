"""Black-Scholes implied volatility by a safeguarded Newton iteration.

The port of ``montecarlo_tpu/engine/implied_vol.py``.  It runs in the dtype
and on the device of its tensor inputs (the float types among them
promoted; numpy arrays count as tensors, python numbers take the tensors'
type; with no tensor at all, float64 on the host) and keeps their autograd
graph, so a calibration loss back-propagates through every clipped Newton
step, as JAX differentiates through its ``fori_loop``.  The
implied-vol surface (``engine.surface``) hands it float64 host prices.
"""

from __future__ import annotations

import math

import torch

from montecarlo_tpu_torch.engine.payoffs import common_operands

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _bs_call_and_vega(sigma, s0, log_sk, r, T, sqrt_t, kdisc):
    """The Black-Scholes call and its vega at ``sigma``, in JAX's grouping
    (``black_scholes_call``, ``black_scholes_vega``: one d1 serves both,
    the same operations), with the loop-invariant ``log(s0 / K)``,
    ``sqrt(T)`` and ``K e^{-rT}`` taken once."""
    sig_rt = sigma * sqrt_t
    d1 = (log_sk + (r + 0.5 * sigma ** 2) * T) / sig_rt
    d2 = d1 - sig_rt
    bs = s0 * torch.special.ndtr(d1) - kdisc * torch.special.ndtr(d2)
    vega = s0 * (torch.exp(-0.5 * d1 * d1) * _INV_SQRT_2PI) * sqrt_t
    return bs, vega


def implied_vol_call(price, s0, strike, r, T, *, init=0.2,
                     n_iter: int = 32) -> torch.Tensor:
    """Implied vol of a European call: ``n_iter`` Newton steps, each
    clipped to +-0.5, sigma kept in [1e-4, 5], the slope (vega) floored at
    1e-8.  Broadcasts over all five inputs, starting from their common
    shape; NaN where the price lies outside the no-arbitrage band
    ``(max(S - K e^{-rT}, 0), S)``.  In the inputs' dtype, on their
    device, differentiable."""
    price, s0, strike, r, T = common_operands(price, s0, strike, r, T)
    kdisc = strike * torch.exp(-r * T)
    lower = torch.clamp(s0 - kdisc, min=0.0)
    valid = (price > lower + 1e-12) & (price < s0)
    shape = torch.broadcast_shapes(price.shape, s0.shape, strike.shape,
                                   r.shape, T.shape)
    sigma = torch.full(shape, float(init), dtype=price.dtype,
                       device=price.device)
    fixed = (s0, torch.log(s0 / strike), r, T, torch.sqrt(T), kdisc)
    for _ in range(n_iter):
        bs, vega = _bs_call_and_vega(sigma, *fixed)
        vega = torch.clamp(vega, min=1e-8)
        step = torch.clamp((bs - price) / vega, -0.5, 0.5)
        sigma = torch.clamp(sigma - step, 1e-4, 5.0)
    return torch.where(valid, sigma, torch.full_like(sigma, float("nan")))
