"""Semi-analytic Heston pricing and its calibration to an implied-vol
surface.

The port of ``montecarlo_tpu/engine/heston_analytic.py``.  The Heston call
from the characteristic function of ln S_T in the "little Heston trap"
form (Albrecher et al. 2007), integrated by Gauss-Legendre on [0, u_max]
(the JAX package's nodes), in the dtype and on the device of the
parameters, differentiable: calibration is Adam on the exact gradient of

    mean_i (C_heston(K_i, T_i; params) - C_market_i)^2

(or of the implied-vol error, through ``engine.implied_vol``'s Newton
steps), each step eager on the parameters' device
(``engine.adam.adam_minimize``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.engine.adam import adam_minimize
from montecarlo_tpu_torch.engine.cf_pricing import quad_nodes_tensor
from montecarlo_tpu_torch.engine.implied_vol import implied_vol_call

#: Raw optimizer start of both calibrators: v0 0.04 * softplus(1), kappa
#: softplus(0.5), theta 0.04 * softplus(1), xi 0.5 * softplus(1), rho 0.
RAW0 = (1.0, 0.5, 1.0, 1.0, 0.0)


class HestonParams(NamedTuple):
    """Heston's parameters, each a 0-d tensor (or a float in a result)."""

    v0: torch.Tensor
    kappa: torch.Tensor
    theta: torch.Tensor
    xi: torch.Tensor
    rho: torch.Tensor


def _phi(u, j: int, T, r, s0, p: HestonParams):
    """The CF of ln S_T at real nodes ``u`` (trap form), j in {1, 2}:
    ``g`` and then its reciprocal, as the JAX package computes them."""
    iu = 1j * u
    a = p.kappa * p.theta
    b = p.kappa - p.rho * p.xi if j == 1 else p.kappa
    uu = 0.5 if j == 1 else -0.5
    rxi = p.rho * p.xi * iu
    xi2 = p.xi ** 2
    d = torch.sqrt((rxi - b) ** 2 - xi2 * (2 * uu * iu - u ** 2))
    b_minus = b - rxi - d
    big_g = 1.0 / ((b - rxi + d) / b_minus)
    e = torch.exp(-d * T)
    c = (r * iu * T + a / xi2 * (
        b_minus * T - 2.0 * torch.log((1 - big_g * e) / (1 - big_g))))
    dd = b_minus / xi2 * ((1 - e) / (1 - big_g * e))
    return torch.exp(c + dd * p.v0 + iu * torch.log(s0))


def heston_call_cf(s0, strike, T, r, params: HestonParams, *,
                   n_quad: int = 128, u_max: float = 200.0) -> torch.Tensor:
    """The semi-analytic Heston call over a broadcast batch of strike and
    T, in the parameters' dtype on their device (numbers and arrays are
    converted there), differentiable in every input."""
    dtype, device = params.v0.dtype, params.v0.device
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    s0, strike, T, r = map(as_t, (s0, strike, T, r))
    batch = torch.broadcast_shapes(strike.shape, T.shape)
    u, w = quad_nodes_tensor(n_quad, u_max, dtype, device)
    u = u.reshape((n_quad,) + (1,) * len(batch))
    lnk = torch.log(strike)

    def p_j(j):
        vals = torch.real(torch.exp(-1j * u * lnk)
                          * _phi(u, j, T, r, s0, params) / (1j * u))
        return 0.5 + torch.tensordot(w, vals, dims=1) / math.pi

    return s0 * p_j(1) - strike * torch.exp(-r * T) * p_j(2)


def _constrain(raw: torch.Tensor) -> HestonParams:
    return HestonParams(v0=F.softplus(raw[0]) * 0.04,
                        kappa=F.softplus(raw[1]),
                        theta=F.softplus(raw[2]) * 0.04,
                        xi=F.softplus(raw[3]) * 0.5,
                        rho=torch.tanh(raw[4]))


def _as_floats(p: HestonParams) -> HestonParams:
    return HestonParams(*(float(v) for v in p))


def _price_loss(strikes, maturities, prices, s0, r, n_quad: int):
    """raw -> the mean squared price error of ``_constrain(raw)``."""
    def loss_fn(raw):
        model = heston_call_cf(s0, strikes, maturities, r, _constrain(raw),
                               n_quad=n_quad)
        return torch.mean(torch.square(model - prices))

    return loss_fn


def _iv_loss(strikes, maturities, ivs, s0, r, n_quad: int):
    """raw -> the mean squared implied-vol error: each model price clipped
    into the no-arbitrage band (so the inversion never gives NaN far from
    the data), then inverted by ``implied_vol_call``'s 32 Newton steps,
    all differentiated."""
    lower = torch.clamp(s0 - strikes * torch.exp(-r * maturities), min=0.0)

    def loss_fn(raw):
        model = heston_call_cf(s0, strikes, maturities, r, _constrain(raw),
                               n_quad=n_quad)
        model = torch.minimum(torch.maximum(model, lower + 1e-6),
                              s0 * (1.0 - 1e-6))
        model_iv = implied_vol_call(model, s0, strikes, r, maturities)
        return torch.mean(torch.square(model_iv - ivs))

    return loss_fn


def _operands(raw0, *xs):
    return tuple(torch.as_tensor(x, dtype=raw0.dtype, device=raw0.device)
                 for x in xs)


def _calibrate(strikes, maturities, prices, s0, r, raw0, n_iters: int,
               n_quad: int, lr: float):
    """Adam on the price loss from ``raw0``, every array in its dtype on
    its device.  Returns ``(raw, losses)``."""
    ops = _operands(raw0, strikes, maturities, prices, s0, r)
    return adam_minimize(_price_loss(*ops, n_quad), raw0, n_iters, lr)


def _calibrate_iv(strikes, maturities, ivs, s0, r, raw0, n_iters: int,
                  n_quad: int, lr: float):
    """Adam on the implied-vol loss from ``raw0``.  Returns ``(raw,
    losses)``."""
    ops = _operands(raw0, strikes, maturities, ivs, s0, r)
    return adam_minimize(_iv_loss(*ops, n_quad), raw0, n_iters, lr)


def _start(dtype, device) -> torch.Tensor:
    return torch.tensor(RAW0, dtype=dtype, device=resolve_device(device))


def calibrate_heston(strikes, maturities, prices, *, s0, r,
                     n_iters: int = 800, n_quad: int = 96, lr: float = 0.05,
                     dtype=torch.float32, device="cuda") -> HestonParams:
    """Fit Heston's parameters to market call prices by Adam on the exact
    gradient of the semi-analytic pricer, in ``dtype`` on ``device``.
    Returns the constrained parameters as floats."""
    raw, _ = _calibrate(strikes, maturities, prices, s0, r,
                        _start(dtype, device), n_iters, n_quad, lr)
    return _as_floats(_constrain(raw))


def calibrate_heston_to_ivs(strikes, maturities, ivs, *, s0, r,
                            n_iters: int = 800, n_quad: int = 96,
                            lr: float = 0.05, dtype=torch.float32,
                            device="cuda") -> HestonParams:
    """Fit Heston's parameters to a market implied-vol surface (the loss
    in vol space, through the differentiated Newton inversion of the
    model prices), in ``dtype`` on ``device``.  Returns the constrained
    parameters as floats."""
    raw, _ = _calibrate_iv(strikes, maturities, ivs, s0, r,
                           _start(dtype, device), n_iters, n_quad, lr)
    return _as_floats(_constrain(raw))


__all__ = ["HestonParams", "heston_call_cf", "calibrate_heston",
           "calibrate_heston_to_ivs"]
