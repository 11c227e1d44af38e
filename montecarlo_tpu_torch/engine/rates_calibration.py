"""Vasicek calibration to European payer-swaption quotes.

The port of the Vasicek part of
``montecarlo_tpu/engine/rates_calibration.py``: (kappa, theta, sigma)
fitted to a grid of swaption premia by Adam on exact gradients
(``engine.adam``) through a Jamshidian pricer whose critical rate r* is 40
clipped Newton steps on the par gap, differentiated through.  The bond
forms are ``engine.rates``'s (``vasicek_affine``, the (A, B) of
``vasicek_bond_from_rate``, and ``vasicek_bond_option_from_rate``), in the
parameters' dtype.

The LMM calibration (``bootstrap_lmm_vols``,
``calibrate_lmm_corr_to_swaptions``) waits for the LMM itself (ROADMAP
Queue 1 item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.engine.adam import adam_minimize, rmse_of_last
from montecarlo_tpu_torch.engine.rates import (vasicek_affine,
                                               vasicek_bond_option_from_rate)

#: Newton steps for the critical rate.
N_NEWTON = 40


def vasicek_swaption_prices(r0, kappa, theta, sigma, expiries, pay_dts,
                            strikes, n_periods, *, max_periods=None,
                            dtype=torch.float32, device="cuda"):
    """European payer-swaption premia for a batch of quotes: quote i
    exercises at ``expiries[i]`` into a payer swap of ``n_periods[i]``
    payments every ``pay_dts[i]`` at fixed rate ``strikes[i]`` (ragged
    payment counts padded to ``max_periods`` and masked).  A (Q,) tensor
    in ``dtype`` on ``device`` (a tensor parameter's dtype and device win);
    differentiable in the parameters through the Newton critical rate."""
    ref = next((x for x in (kappa, theta, sigma, r0)
                if torch.is_tensor(x)), None)
    if ref is not None:
        dtype, dev = ref.dtype, ref.device
    else:
        dev = resolve_device(device)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    expiries, pay_dts, strikes = map(as_t, (expiries, pay_dts, strikes))
    r0, kappa, theta, sigma = map(as_t, (r0, kappa, theta, sigma))
    n_per = torch.as_tensor(n_periods, dtype=torch.int64, device=dev)
    q = expiries.shape[0]
    pmax = int(max_periods if max_periods is not None
               else int(torch.max(n_per)))
    j = torch.arange(pmax, device=dev)
    mask = (j[None, :] < n_per[:, None]).to(dtype)          # (Q, P)
    taus = (j.to(dtype) + 1.0)[None, :] * pay_dts[:, None]   # from T0
    coup = strikes[:, None] * pay_dts[:, None] * mask
    last = torch.clamp(n_per - 1, min=0)
    coup = coup.index_put((torch.arange(q, device=dev), last),
                          torch.ones(q, dtype=dtype, device=dev),
                          accumulate=True)
    # The bond's (A, B) do not depend on the rate: taken once, as the
    # JAX package's bond form computes them (B is its b_tau).
    a_tau, b_tau = vasicek_affine(kappa, theta, sigma, taus)
    coup_b = coup * b_tau

    def newton(r):
        p = a_tau * torch.exp(-b_tau * r[:, None]) * mask
        f = torch.sum(coup * p, dim=1) - 1.0
        fp = -torch.sum(coup_b * p, dim=1)
        return torch.clamp(r - f / torch.clamp(fp, max=-1e-12), -2.0, 3.0)

    r_star = theta.expand(q)
    for _ in range(N_NEWTON):
        r_star = newton(r_star)
    ks = a_tau * torch.exp(-b_tau * r_star[:, None])
    puts = vasicek_bond_option_from_rate(
        r0, kappa, theta, sigma, expiries[:, None],
        expiries[:, None] + taus, ks, call=False)
    return torch.sum(coup * puts * mask, dim=1)


def _constrain(raw):
    return {"kappa": F.softplus(raw[0]),
            "theta": raw[1] * 0.05,
            "sigma": F.softplus(raw[2]) * 0.02}


#: Raw optimizer start: kappa softplus(0.3), theta 0.05, sigma 0.02
#: softplus(0.5).
RAW0 = (0.3, 1.0, 0.5)


def _swaption_loss(r0, expiries, pay_dts, strikes, n_periods, prices,
                   max_periods: int):
    """raw -> the mean squared relative premium error (the premia span
    orders of magnitude) of ``_constrain(raw)``."""
    def loss_fn(raw):
        p = _constrain(raw)
        model = vasicek_swaption_prices(
            r0, p["kappa"], p["theta"], p["sigma"], expiries, pay_dts,
            strikes, n_periods, max_periods=max_periods)
        return torch.mean(torch.square(model / prices - 1.0))

    return loss_fn


def _calibrate(r0, expiries, pay_dts, strikes, n_periods, prices, raw0,
               n_iters: int, lr: float, max_periods: int):
    """Adam on the relative premium loss from ``raw0`` (its dtype and
    device are the run's).  Returns ``(raw, losses)``."""
    as_t = lambda x: torch.as_tensor(x, dtype=raw0.dtype, device=raw0.device)
    n_periods = torch.as_tensor(n_periods, dtype=torch.int64,
                                device=raw0.device)
    loss = _swaption_loss(as_t(r0), as_t(expiries), as_t(pay_dts),
                          as_t(strikes), n_periods, as_t(prices),
                          max_periods)
    return adam_minimize(loss, raw0, n_iters, lr)


def calibrate_vasicek_to_swaptions(expiries, pay_dts, strikes, n_periods,
                                   prices, *, r0, n_iters: int = 1500,
                                   lr: float = 0.05, dtype=torch.float32,
                                   device="cuda") -> dict:
    """Fit Vasicek (kappa, theta, sigma) to payer-swaption premia (per
    unit notional; ``r0`` the observed short rate, not fitted) in
    ``dtype`` on ``device``.  Returns the constrained parameters as floats
    plus ``rmse_rel``, the square root of the last relative-error loss
    evaluated."""
    raw0 = torch.tensor(RAW0, dtype=dtype, device=resolve_device(device))
    pmax = int(max(int(n) for n in n_periods))
    raw, losses = _calibrate(r0, expiries, pay_dts, strikes, n_periods,
                             prices, raw0, n_iters, lr, pmax)
    out = {k: float(v) for k, v in _constrain(raw).items()}
    out["rmse_rel"] = rmse_of_last(losses)
    return out


__all__ = ["vasicek_swaption_prices", "calibrate_vasicek_to_swaptions"]
