"""Fixed-income pricing over the short-rate processes.

The port of ``montecarlo_tpu/engine/rates.py``.  Monte Carlo bond and
bond-option prices under the bank-account numeraire,

    P(0, T)    = E[ exp(-int_0^T r_t dt) ]
    ZBC(T1,T2) = E[ exp(-int_0^T1 r_t dt) max(P(T1, T2) - K, 0) ]

with the discount integral folded into the time loop by
``trapezoid_integral`` (K4 on the card, its plain version on the CPU; O(paths)
memory), and the affine closed forms they are held against: the Vasicek and
CIR zero-coupon bonds, Jamshidian's Vasicek bond option and the Vasicek
cap.  The closed forms at t = 0 are python float64 arithmetic; the
functions of a rate (``vasicek_bond_from_rate``,
``vasicek_bond_option_from_rate``) compute in the rate's dtype (float64 for
python numbers), with ``torch.special.ndtr`` for the normal CDF.
"""

from __future__ import annotations

import math

import torch

from montecarlo_tpu_torch.engine.functionals import (simulate_functionals,
                                                     trapezoid_integral)
from montecarlo_tpu_torch.engine.pricing import mc_estimate
from montecarlo_tpu_torch.processes.shortrate import Vasicek


# --- affine closed forms (oracles and quoting) -------------------------------

def vasicek_zcb(r0, kappa, theta, sigma, T):
    """Vasicek zero-coupon bond price P(0, T) = A e^{-B r0}."""
    k, th, s = float(kappa), float(theta), float(sigma)
    B = (1.0 - math.exp(-k * T)) / k
    A = math.exp((th - s * s / (2.0 * k * k)) * (B - T)
                 - s * s * B * B / (4.0 * k))
    return A * math.exp(-B * float(r0))


def cir_zcb(r0, kappa, theta, sigma, T):
    """CIR zero-coupon bond price (Cox–Ingersoll–Ross 1985)."""
    k, th, s = float(kappa), float(theta), float(sigma)
    h = math.sqrt(k * k + 2.0 * s * s)
    ehT = math.exp(h * T)
    denom = 2.0 * h + (k + h) * (ehT - 1.0)
    A = (2.0 * h * math.exp((k + h) * T / 2.0) / denom) ** (
        2.0 * k * th / (s * s))
    B = 2.0 * (ehT - 1.0) / denom
    return A * math.exp(-B * float(r0))


def vasicek_bond_option(r0, kappa, theta, sigma, T1, T2, strike,
                        call: bool = True):
    """European option maturing T1 on a T2-bond, Jamshidian (1989)."""
    def ncdf(x):
        return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))

    p1 = vasicek_zcb(r0, kappa, theta, sigma, T1)
    p2 = vasicek_zcb(r0, kappa, theta, sigma, T2)
    k = float(kappa)
    s = float(sigma)
    b = (1.0 - math.exp(-k * (T2 - T1))) / k
    sig_p = b * s * math.sqrt((1.0 - math.exp(-2.0 * k * T1)) / (2.0 * k))
    h = math.log(p2 / (float(strike) * p1)) / sig_p + 0.5 * sig_p
    if call:
        return p2 * ncdf(h) - float(strike) * p1 * ncdf(h - sig_p)
    return float(strike) * p1 * ncdf(sig_p - h) - p2 * ncdf(-h)


def _like(r, *values):
    """``r`` as a tensor (float64 for python numbers) and ``values`` as
    tensors of its dtype on its device."""
    if not torch.is_tensor(r):
        r = torch.as_tensor(r, dtype=torch.float64)
    return (r, *(torch.as_tensor(v, dtype=r.dtype, device=r.device)
                 for v in values))


def vasicek_affine(kappa, theta, sigma, tau):
    """(A, B) of Vasicek's ``P(t, t + tau) = A exp(-B r_t)``, tensors in
    the dtype and on the device of ``kappa`` (a tensor), broadcasting."""
    k, th, s, tau = _like(kappa, theta, sigma, tau)
    B = (1.0 - torch.exp(-k * tau)) / k
    A = torch.exp((th - s * s / (2.0 * k * k)) * (B - tau)
                  - s * s * B * B / (4.0 * k))
    return A, B


def vasicek_bond_from_rate(r, kappa, theta, sigma, tau):
    """P(t, t + tau) as the affine function of the rate r_t, in r's dtype,
    broadcasting."""
    r, k, th, s, tau = _like(r, kappa, theta, sigma, tau)
    A, B = vasicek_affine(k, th, s, tau)
    return A * torch.exp(-B * r)


def vasicek_bond_option_from_rate(r, kappa, theta, sigma, tau1, tau2,
                                  strike, call: bool = True):
    """Jamshidian's bond option valued at time t from the short rate r_t
    (``tau1``, ``tau2``: the year fractions to the option's expiry and the
    bond's maturity), in r's dtype, broadcasting.  ``tau1 -> 0``
    degenerates to the intrinsic value (sig_p floored at 1e-12)."""
    r, kappa, theta, sigma, tau1, tau2, strike = _like(
        r, kappa, theta, sigma, tau1, tau2, strike)
    ncdf = torch.special.ndtr
    p1 = vasicek_bond_from_rate(r, kappa, theta, sigma, tau1)
    p2 = vasicek_bond_from_rate(r, kappa, theta, sigma, tau2)
    b = (1.0 - torch.exp(-kappa * (tau2 - tau1))) / kappa
    var = (1.0 - torch.exp(-2.0 * kappa * torch.clamp(tau1, min=0.0))) \
        / (2.0 * kappa)
    sig_p = torch.clamp(b * sigma * torch.sqrt(var), min=1e-12)
    h = torch.log(p2 / (strike * p1)) / sig_p + 0.5 * sig_p
    if call:
        return p2 * ncdf(h) - strike * p1 * ncdf(h - sig_p)
    return strike * p1 * ncdf(sig_p - h) - p2 * ncdf(-h)


def vasicek_cap_price(r0, kappa, theta, sigma, strike, reset_times,
                      pay_dt, *, floor: bool = False):
    """Cap (or floor) on the simple rate, closed form under Vasicek, in
    float64: caplet i pays ``delta (L(T_i, T_i + delta) - K)^+`` at ``T_i +
    delta``, which is ``(1 + K delta)`` zero-coupon-bond puts expiring at
    the reset, struck at ``1 / (1 + K delta)`` (floorlets the calls).
    ``reset_times`` are the caplets' fixing dates."""
    resets = torch.as_tensor(reset_times, dtype=torch.float64)
    delta = torch.as_tensor(pay_dt, dtype=torch.float64)
    kd = 1.0 + torch.as_tensor(strike, dtype=torch.float64) * delta
    per = vasicek_bond_option_from_rate(
        torch.as_tensor(r0, dtype=torch.float64), kappa, theta, sigma,
        resets, resets + delta, 1.0 / kd, call=bool(floor))
    return torch.sum(kd * per)


# --- Monte Carlo pricers ------------------------------------------------------

def zcb_price_mc(model, T: float, n_steps: int, n_paths: int, *, seed: int,
                 stream: int = 0, path_offset=0) -> dict:
    """P(0, T) by simulation: the mean of exp(-trapezoid int r dt) over the
    model's rate (any short-rate process), the integral folded into the
    time loop; ``mc_estimate``'s dict."""
    dt = T / n_steps
    out = simulate_functionals(
        model, n_paths, n_steps, seed=seed, stream=stream,
        path_offset=path_offset,
        functionals={"discount_integral": trapezoid_integral(dt)})
    return mc_estimate(torch.exp(-out["discount_integral"]))


def bond_option_mc(model: Vasicek, T1: float, T2: float, strike: float,
                   n_steps: int, n_paths: int, *, seed: int,
                   call: bool = True) -> dict:
    """The Vasicek bond option by simulation to T1: the T2-bond at expiry
    is the affine function of r_{T1} (in the model's float32), the
    discounting pathwise."""
    if not isinstance(model, Vasicek):
        raise TypeError("bond_option_mc prices under Vasicek (affine "
                        "P(T1,T2) as a function of r); got "
                        f"{type(model).__name__}")
    dt = T1 / n_steps
    out = simulate_functionals(
        model, n_paths, n_steps, seed=seed,
        functionals={"discount_integral": trapezoid_integral(dt)})
    p_t1_t2 = vasicek_bond_from_rate(out["terminal"], model.kappa,
                                     model.theta, model.sigma, T2 - T1)
    intrinsic = (torch.clamp(p_t1_t2 - strike, min=0.0) if call
                 else torch.clamp(strike - p_t1_t2, min=0.0))
    return mc_estimate(torch.exp(-out["discount_integral"]) * intrinsic)


__all__ = [
    "vasicek_zcb", "cir_zcb", "vasicek_bond_option", "vasicek_affine",
    "vasicek_bond_from_rate", "vasicek_bond_option_from_rate",
    "vasicek_cap_price", "zcb_price_mc", "bond_option_mc",
]
