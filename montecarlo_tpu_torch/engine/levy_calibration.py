"""Calibrate the CF-priced families — variance gamma, NIG, Merton and Kou
— to an implied-vol surface.

The port of ``montecarlo_tpu/engine/levy_calibration.py``: the loss lives
in implied-vol space, through the CF pricer
(``engine.cf_pricing.cf_call_price_impl``, 96 nodes, the Heston
calibrator's count) and the Newton inversion (``engine.implied_vol``),
both differentiated; the optimizer is Adam as optax computes it
(``engine.adam``), eager on the parameters' device.  One parameter set
prices every maturity of these exponential-Lévy models, so the residual
``rmse_vol`` on a multi-expiry surface is the model's error.

Raw optimizer coordinates map to each family's open domain, so every
iterate is valid: VG's martingale-correction argument ``1 - theta nu -
sigma^2 nu / 2`` is floored at 1e-4 inside the CF; NIG's ``alpha =
max(|beta|, |beta + 1|) + gap`` with a softplus gap.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.engine.adam import adam_minimize, rmse_of_last
from montecarlo_tpu_torch.engine.cf_pricing import (cf_call_price_impl,
                                                    kou_log_cf_tensor,
                                                    merton_log_cf_tensor,
                                                    nig_log_cf_tensor,
                                                    vg_log_cf_tensor)
from montecarlo_tpu_torch.engine.implied_vol import implied_vol_call

N_QUAD = 96  # the Heston calibrator's node count


def _vg_constrain(raw):
    return {"sigma": F.softplus(raw[0]) * 0.2,
            "theta": raw[1] * 0.2,
            "nu": F.softplus(raw[2]) * 0.2 + 1e-3}


def _vg_phi(p, s0, r, T):
    return vg_log_cf_tensor(s0, r, p["sigma"], p["theta"], p["nu"], T,
                            floor=1e-4)


def _nig_constrain(raw):
    beta = raw[1] * 5.0
    gap = F.softplus(raw[0]) * 5.0 + 0.1
    return {"alpha": torch.maximum(torch.abs(beta),
                                   torch.abs(beta + 1.0)) + gap,
            "beta": beta,
            "delta": F.softplus(raw[2]) * 0.5 + 1e-3}


def _nig_phi(p, s0, r, T):
    return nig_log_cf_tensor(s0, r, p["alpha"], p["beta"], p["delta"], T)


def _merton_constrain(raw):
    return {"sigma": F.softplus(raw[0]) * 0.2,
            "lam": F.softplus(raw[1]),
            "jump_mean": raw[2] * 0.2,
            "jump_std": F.softplus(raw[3]) * 0.2 + 1e-3}


def _merton_phi(p, s0, r, T):
    return merton_log_cf_tensor(s0, r, p["sigma"], p["lam"], p["jump_mean"],
                                p["jump_std"], T)


def _kou_constrain(raw):
    return {"sigma": F.softplus(raw[0]) * 0.2,
            "lam": F.softplus(raw[1]),
            "p_up": torch.sigmoid(raw[2]),
            "eta1": 1.0 + F.softplus(raw[3]) * 10.0,  # > 1: finite mean
            "eta2": F.softplus(raw[4]) * 10.0 + 1e-2}


def _kou_phi(p, s0, r, T):
    return kou_log_cf_tensor(s0, r, p["sigma"], p["lam"], p["p_up"],
                             p["eta1"], p["eta2"], T)


#: family -> (constrain, CF builder, raw start).
FAMILIES = {"vg": (_vg_constrain, _vg_phi, (0.5, -0.5, 0.5)),
            "nig": (_nig_constrain, _nig_phi, (1.0, -0.5, 0.5)),
            "merton": (_merton_constrain, _merton_phi,
                       (0.5, 0.0, -0.3, 0.5)),
            "kou": (_kou_constrain, _kou_phi, (0.5, 0.0, -0.4, 0.0, 0.0))}


def _iv_loss(family: str, strikes, maturities, ivs, s0, r):
    """raw -> the mean squared implied-vol error of ``family`` at its
    constrained parameters: CF prices clipped into the no-arbitrage band,
    then inverted, all differentiated."""
    constrain, make_phi, _ = FAMILIES[family]
    lower = torch.clamp(s0 - strikes * torch.exp(-r * maturities), min=0.0)

    def loss_fn(raw):
        p = constrain(raw)
        model = cf_call_price_impl(make_phi(p, s0, r, maturities), s0,
                                   strikes, maturities, r, n_quad=N_QUAD)
        model = torch.minimum(torch.maximum(model, lower + 1e-6),
                              s0 * (1.0 - 1e-6))
        model_iv = implied_vol_call(model, s0, strikes, r, maturities)
        return torch.mean(torch.square(model_iv - ivs))

    return loss_fn


def _calibrate_iv(family: str, strikes, maturities, ivs, s0, r, raw0,
                  n_iters: int, lr: float):
    """Adam on ``family``'s implied-vol loss from ``raw0``, every array in
    its dtype on its device.  Returns ``(raw, losses)``."""
    as_t = lambda x: torch.as_tensor(x, dtype=raw0.dtype, device=raw0.device)
    ops = map(as_t, (strikes, maturities, ivs, s0, r))
    return adam_minimize(_iv_loss(family, *ops), raw0, n_iters, lr)


def calibrate_levy_to_ivs(family: str, strikes, maturities, ivs, *, s0, r,
                          n_iters: int = 1500, lr: float = 0.03,
                          dtype=torch.float32, device="cuda") -> dict:
    """Fit ``family`` ("vg", "nig", "merton", "kou") to a market
    implied-vol surface in ``dtype`` on ``device``.  Returns the
    constrained parameters as floats plus ``rmse_vol``, the square root
    of the last loss evaluated."""
    if family not in FAMILIES:
        raise ValueError(f"unknown Levy family {family!r} "
                         f"(have {sorted(FAMILIES)})")
    constrain, _, raw0 = FAMILIES[family]
    raw0 = torch.tensor(raw0, dtype=dtype, device=resolve_device(device))
    raw, losses = _calibrate_iv(family, strikes, maturities, ivs, s0, r,
                                raw0, n_iters, lr)
    out = {k: float(v) for k, v in constrain(raw).items()}
    out["rmse_vol"] = rmse_of_last(losses)
    return out


__all__ = ["calibrate_levy_to_ivs"]
