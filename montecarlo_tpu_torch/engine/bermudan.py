"""Bermudan swaptions by pathwise-discounted LSM, under Vasicek and under
the LIBOR market model.

The port of ``montecarlo_tpu/engine/bermudan.py``.  The equity LSM
(:mod:`montecarlo_tpu_torch.engine.american`) carried to rates: the
numeraire is the bank account, the discount along each path the trapezoid
``exp(-sum (r_t + r_{t+1})/2 dt)``, and the exercise value at a reset date
is the remaining swap's value, affine in the short rate through the
Vasicek zero-coupon closed form:

    payer swap value at t_j = 1 - P(t_j, T_N) - K Delta sum_{i>j} P(t_j, T_i)

The backward induction regresses the pathwise-discounted continuation on
a polynomial basis of r_t over the ITM paths, in float64 by default (the
paths from the torch time loop in that dtype).  With one exercise date the
Bermudan is the European payer swaption, priced in closed form by
Jamshidian's (1989) decomposition (:func:`vasicek_swaption_jamshidian`);
more dates can only add value.

Under the LMM (:func:`lmm_bermudan_swaption_lsm`) the paths are the
model's ``exposure_obs`` rows on the reset grid, the exercise value the
remaining swap's forward-curve closed form (``lmm_swap_value_fn``), the
discount the exact bank account, and the regression state the remaining
swap's par rate; one exercise date is ``lmm_swaption_mc`` at the same
seed.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlo_tpu_torch.engine.american import (_basis, _check_solves,
                                                  _itm, _itm_stats,
                                                  _normal_solve, _result)
from montecarlo_tpu_torch.engine.rates import (vasicek_bond_from_rate,
                                               vasicek_bond_option,
                                               vasicek_zcb)
from montecarlo_tpu_torch.engine.simulate import simulate


def _swap_value(r, model, taus, strike, delta):
    """Payer swap value at a reset date, remaining payments ``taus`` (year
    fractions from the valuation date), broadcast over the rates ``r``."""
    p = vasicek_bond_from_rate(r[..., None], model.kappa, model.theta,
                               model.sigma, taus)
    float_leg = 1.0 - p[..., -1]
    fixed_leg = strike * delta * torch.sum(p, dim=-1)
    return float_leg - fixed_leg


def bermudan_swaption_lsm(model, strike: float, *, n_paths: int,
                          steps_per_period: int, n_periods: int,
                          n_exercise: int, seed: int, degree: int = 3,
                          dtype=torch.float64) -> dict:
    """Bermudan payer swaption by LSM with pathwise discounting.

    The swap pays at the ``n_periods`` period ends (period ``delta =
    steps_per_period * model.dt``); exercise is allowed at the first
    ``n_exercise`` reset dates (period starts, the first one period from
    today), ``n_exercise=1`` the European case.  Returns ``{"price",
    "std_err", "n_paths"}``."""
    if not 1 <= n_exercise < n_periods:
        # Exercise at reset n_periods would enter a swap with no payments.
        raise ValueError(
            f"n_exercise={n_exercise} must be in [1, n_periods-1]="
            f"[1, {n_periods - 1}]")
    dev = model.device
    dt = torch.as_tensor(model.dt, dtype=dtype, device=dev)
    delta = steps_per_period * dt
    n_steps = steps_per_period * n_exercise  # to the last reset
    paths = simulate(model, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)  # (n_steps+1, n_paths) short rates
    # Pathwise discount factors to each step (trapezoid integral).
    mid = 0.5 * (paths[:-1] + paths[1:]) * dt
    cum = torch.cat([torch.zeros((1, n_paths), dtype=dtype, device=dev),
                     torch.cumsum(mid, dim=0)])
    disc_to = torch.exp(-cum)  # row k = D(0, t_k)

    def exercise_value(j):
        """(rates, swap values, discount) at reset j (1-based)."""
        step = j * steps_per_period
        r = paths[step]
        taus = torch.arange(1, n_periods - j + 1, dtype=dtype,
                            device=dev) * delta
        return r, _swap_value(r, model, taus, strike, delta), disc_to[step]

    return _result(_lsm_backward(exercise_value, 1, n_exercise, degree,
                                 dtype), n_paths)


def _lsm_backward(at, first, last, degree, dtype):
    """The backward induction over exercise dates ``last .. first``:
    ``at(j)`` gives (regression state, exercise value, discount to 0) at
    date j; returns the pathwise cash flows discounted to 0."""
    r, ex, d = at(last)
    cash = torch.clamp(ex, min=0.0) * d  # discounted to 0
    infos = []
    for j in range(last - 1, first - 1, -1):
        r, ex, d = at(j)
        itm, w, wsum = _itm(ex, dtype)
        m, sd = _itm_stats(r, w, wsum)
        x = _basis((r - m) / sd, degree)
        beta = _normal_solve(x, w, cash / torch.clamp(d, min=1e-30), wsum,
                             infos, ridge=1e-8)
        take = itm & (ex >= x @ beta)  # continuation in t_j dollars
        cash = torch.where(take, ex * d, cash)
    _check_solves(infos)
    return cash


def lmm_bermudan_swaption_lsm(model, strike: float, start_idx: int,
                              end_idx: int, *, n_exercise: int,
                              n_paths: int, seed: int, degree: int = 3,
                              dtype=torch.float64) -> dict:
    """Bermudan payer swaption under the LIBOR market model by LSM:
    exercise at resets ``start_idx .. start_idx + n_exercise - 1``, each
    into the remaining swap to ``end_idx`` (co-terminal).  ``n_exercise=1``
    is the European ``lmm_swaption_mc`` at the same seed.  Returns
    ``{"price", "std_err", "n_paths"}`` (tensors and the count)."""
    from montecarlo_tpu_torch.processes.lmm import lmm_swap_value_fn

    k_fwd = int(model.sigma.shape[0])
    if not 1 <= start_idx < end_idx <= k_fwd:
        raise ValueError(f"need 1 <= start ({start_idx}) < end "
                         f"({end_idx}) <= K ({k_fwd})")
    if not 1 <= n_exercise <= end_idx - start_idx:
        raise ValueError(f"n_exercise={n_exercise} must be in "
                         f"[1, {end_idx - start_idx}]")
    dlt = model.delta.to(dtype)
    last_ex = start_idx + n_exercise - 1
    obs = simulate(model, n_paths, last_ex, seed=seed, mode="paths",
                   dtype=dtype, observe=lambda p, s: p.exposure_obs(s))
    obs = torch.movedim(obs, -1, 1)  # (T+1, C, N): the closure's layout
    v_fn = lmm_swap_value_fn(model, strike, start_idx, end_idx, dtype=dtype)
    jj = torch.arange(k_fwd, device=obs.device)[:, None]
    dlt_host = float(dlt)

    def at(j):
        cols = obs[j]                                   # (C, N)
        ex = v_fn(cols, j * dlt_host)
        d = torch.exp(-cols[-1])                        # 1/B(T_j)
        # The remaining swap's par rate: the regression state.
        f = cols[:k_fwd]
        dfac = torch.where(jj >= j, 1.0 / (1.0 + dlt * f), 1.0)
        p = torch.cumprod(dfac, dim=0)
        pay = (jj >= j) & (jj < end_idx)
        annuity = dlt * torch.sum(torch.where(pay, p, 0.0), dim=0)
        rate = (1.0 - p[end_idx - 1]) / torch.clamp(annuity, min=1e-30)
        return rate, ex, d

    return _result(_lsm_backward(at, start_idx, last_ex, degree, dtype),
                   n_paths)


def vasicek_swaption_jamshidian(model_params, strike: float, t0: float,
                                delta: float, n_periods: int,
                                r0: float) -> float:
    """European payer swaption in closed form (Jamshidian 1989): exercise
    at ``t0`` into a payer swap paying at ``t0 + delta, ..., t0 +
    n_periods * delta``.  The rate r* at which the coupon bond is at par
    splits the swaption into zero-coupon bond puts struck at each bond's
    value under r*.  Python float64."""
    from scipy.optimize import brentq

    kappa, theta, sigma = model_params
    times = t0 + delta * np.arange(1, n_periods + 1)
    coupons = np.full(n_periods, strike * delta)
    coupons[-1] += 1.0

    def p_t0(tau, r):
        return vasicek_zcb(r, kappa, theta, sigma, tau)

    def par_gap(r):
        return sum(c * p_t0(t - t0, r) for c, t in zip(coupons, times)) - 1.0

    r_star = brentq(par_gap, -2.0, 3.0, xtol=1e-14)
    total = 0.0
    for c, t in zip(coupons, times):
        k_i = p_t0(t - t0, r_star)
        total += c * vasicek_bond_option(r0, kappa, theta, sigma, t0, t,
                                         k_i, call=False)
    return total


__all__ = ["bermudan_swaption_lsm", "lmm_bermudan_swaption_lsm",
           "vasicek_swaption_jamshidian"]
