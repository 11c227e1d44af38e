"""Vasicek calibration to European payer-swaption quotes.

The port of the Vasicek part of
``montecarlo_tpu/engine/rates_calibration.py``: (kappa, theta, sigma)
fitted to a grid of swaption premia by Adam on exact gradients
(``engine.adam``) through a Jamshidian pricer whose critical rate r* is 40
clipped Newton steps on the par gap, differentiated through.  The bond
forms are ``engine.rates``'s (``vasicek_affine``, the (A, B) of
``vasicek_bond_from_rate``, and ``vasicek_bond_option_from_rate``), in the
parameters' dtype.

The LMM's two-stage market-model calibration, host float64 NumPy and
SciPy as in the JAX package: ``bootstrap_lmm_vols`` (per-forward vols) and
``bootstrap_lmm_ttm_vols`` (the time-homogeneous table) invert a
co-terminal cap strip caplet by caplet through Black's formula (bisection
on the monotone total-stddev map, ``_caplet_total_sds``), then
``calibrate_lmm_corr_to_swaptions`` fits the forward-correlation decay
beta to European swaption premia by a golden section over Rebonato's
frozen-weight map (``processes.lmm.lmm_swaption_rebonato``, on CPU
models whose leaves are float32, as the JAX package's default).
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


def _black76_np(f, k, sd):
    """Undiscounted Black-76 call (host float64; vector in any argument)."""
    import numpy as np
    from scipy.stats import norm

    f = np.asarray(f, np.float64)
    sd = np.asarray(sd, np.float64)
    with np.errstate(divide="ignore"):
        d1 = np.where(sd > 0, (np.log(f / k) + 0.5 * sd * sd)
                      / np.where(sd > 0, sd, 1.0), np.inf)
    return np.where(sd > 0, f * norm.cdf(d1) - k * norm.cdf(d1 - sd),
                    np.maximum(f - k, 0.0))


def _caplet_total_sds(f0, delta, strike, cap_prices):
    """Invert a co-terminal cap strip into per-caplet total stddevs
    (bisection on the monotone Black map; shared by both bootstraps)."""
    import numpy as np

    f0 = np.asarray(f0, np.float64)
    k_fwd = f0.shape[0]
    cap_prices = np.asarray(cap_prices, np.float64)
    if cap_prices.shape != (k_fwd - 1,):
        raise ValueError(f"need {k_fwd - 1} co-terminal cap quotes "
                         f"(resets 1..{k_fwd - 1}); got "
                         f"{cap_prices.shape}")
    caplets = np.diff(np.concatenate([[0.0], cap_prices]))
    if np.any(caplets <= 0.0):
        raise ValueError("cap strip is not strictly increasing — caplet "
                         "premia must be positive")
    dlt = float(delta)
    p = np.cumprod(1.0 / (1.0 + dlt * f0))
    sds = np.zeros(k_fwd)
    for k in range(1, k_fwd):
        undisc = caplets[k - 1] / (dlt * p[k])
        if undisc >= f0[k]:
            raise ValueError(f"caplet {k} price {caplets[k - 1]:.6g} "
                             "exceeds its undiscounted forward bound")
        lo_sd, hi_sd = 0.0, 1e2
        for _ in range(200):  # bisection: exact to float64
            mid = 0.5 * (lo_sd + hi_sd)
            if _black76_np(f0[k], strike, mid) < undisc:
                lo_sd = mid
            else:
                hi_sd = mid
        sds[k] = 0.5 * (lo_sd + hi_sd)
    return sds


def bootstrap_lmm_ttm_vols(f0, delta, strike, cap_prices):
    """The time-homogeneous vol table ``vol_ttm`` (``LMM.create(...,
    vol_ttm=)``) from a co-terminal cap strip: caplet k's total variance is
    ``delta * sum_{m < k} ttm[m]^2``, so consecutive differences pin each
    ``ttm[m]``.  Raises when the caplet variances are not increasing."""
    import numpy as np

    sds = _caplet_total_sds(f0, delta, strike, cap_prices)
    dv = np.diff(np.square(sds))
    if np.any(dv <= 0.0):
        raise ValueError(
            "caplet total variances are not increasing — no "
            "time-homogeneous vol table reproduces this strip "
            "(use the per-forward bootstrap_lmm_vols instead)")
    k_fwd = len(sds)
    ttm = np.zeros(k_fwd)
    ttm[0] = sds[1] / np.sqrt(float(delta))
    ttm[1:k_fwd - 1] = np.sqrt(dv[1:] / float(delta))
    ttm[k_fwd - 1] = ttm[k_fwd - 2]  # never observed by any quoted caplet
    return ttm


def bootstrap_lmm_vols(f0, delta, strike, cap_prices):
    """Per-forward LMM vols from a co-terminal cap strip on resets
    1..K-1: caplet k is ``cap_k - cap_{k-1}`` and sigma_k inverts its
    Black price.  Returns (K,) vols, ``sigma_0`` a copy of ``sigma_1`` (it
    enters no price).  Raises on a strip that is not strictly increasing
    or a caplet above its undiscounted forward bound."""
    import numpy as np

    sds = _caplet_total_sds(f0, delta, strike, cap_prices)
    k_fwd = len(sds)
    sigmas = np.zeros(k_fwd)
    sigmas[1:] = sds[1:] / np.sqrt(float(delta) * np.arange(1, k_fwd))
    sigmas[0] = sigmas[1]
    return sigmas


def calibrate_lmm_corr_to_swaptions(f0, sigma, delta, quotes, *,
                                    beta_hi: float = 3.0) -> dict:
    """Fit the correlation decay ``beta`` (``rho_jk = exp(-beta |T_j -
    T_k|)``) to European swaption premia through Rebonato's map: 80 golden
    sections on [0, ``beta_hi``] of the mean squared relative error.
    ``quotes``: ``(start_idx, end_idx, strike, price)`` tuples.  Returns
    ``{"corr_beta", "rmse_rel"}``."""
    import numpy as np

    from montecarlo_tpu_torch.processes.lmm import (LMM,
                                                    lmm_swaption_rebonato)

    def loss(beta):
        m = LMM.create(f0, sigma, delta, corr_beta=float(beta),
                       device="cpu")
        errs = [lmm_swaption_rebonato(m, int(s), int(e), float(k_)) / px
                - 1.0 for s, e, k_, px in quotes]
        return float(np.mean(np.square(errs)))

    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = 0.0, float(beta_hi)
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = loss(c), loss(d)
    for _ in range(80):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = loss(d)
    beta = 0.5 * (a + b)
    return {"corr_beta": float(beta),
            "rmse_rel": float(np.sqrt(loss(beta)))}


__all__ = ["bootstrap_lmm_ttm_vols", "bootstrap_lmm_vols",
           "calibrate_lmm_corr_to_swaptions",
           "calibrate_vasicek_to_swaptions", "vasicek_swaption_prices"]
