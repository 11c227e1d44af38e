"""Path functionals: running statistics folded into the time loop.

The port of ``montecarlo_tpu/engine/functionals.py``.  Path-dependent
payoffs (Asian averages, barriers, lookbacks, notes) need per-path running
statistics over the whole trajectory; they fold step by step and memory
stays O(paths):

    out = simulate_functionals(proc, N, T, seed=...,
                               functionals={"avg": ARITH_MEAN,
                                            "max": RUNNING_MAX})
    out["terminal"], out["avg"], out["max"]

Each functional is ``(init, update, finalize)`` over per-step observations
plus its *device form*: the integer code and float32 parameters with which
the K4 kernel (``csrc/fused_engine.cu``) runs the same fold.  A factory
computes its constants in double on the host, rounds them to float32 once,
and both the torch closures and the device form use those float32 values,
so the kernel and the torch time loop share every rounding.

The time index ``t`` handed to ``update`` is the 1-based step index as a
python int (the spot is folded by ``init``); scalars that depend only on
``t`` are computed in float32 on the host, as the kernel computes them per
thread.  Divisions go through a tensor divisor on the operand's device:
torch divides a CUDA tensor by a python scalar as a multiplication by the
reciprocal, which is not the IEEE quotient the kernel and JAX compute.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from montecarlo_tpu_torch.engine.simulate import (check_sampler, check_steps,
                                                 path_ids_for)
from montecarlo_tpu_torch.rng.normal import exp32, log32
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from montecarlo_tpu_torch.samplers import PlainSampler

F32 = torch.float32

# Device codes of the K4 kernel (csrc/fused_engine.cu, enum FunctionalCode).
ARITH_MEAN_CODE, GEO_MEAN_CODE, RUNNING_MAX_CODE, RUNNING_MIN_CODE = 0, 1, 2, 3
BARRIER_UP_CODE, CLIQUET_CODE, AUTOCALL_CODE = 4, 5, 6
REALIZED_VAR_CODE, TRAPEZOID_CODE, SNAPSHOT_CODE = 7, 8, 9
#: Float parameters a device form may carry (the kernel's kMaxParams).
MAX_PARAMS = 6


def _f32(x) -> float:
    """The float32 rounding of ``x``, as a python float."""
    return float(np.float32(x))


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """IEEE float32 ``a / b`` on ``a``'s device for a host scalar ``b``."""
    return a / torch.tensor(b, dtype=F32, device=a.device)


def _exp32_host(x) -> float:
    """``exp32`` of a float32 host scalar, as a python float."""
    return float(exp32(torch.tensor(x, dtype=F32)))


def _call_value(t: int, period: int, coupon: float, neg_r_dt: float):
    """An autocall at step ``t``, ``(1 + coupon * t/period) * exp32(-r_dt *
    t)``, in float32 as every path computes it."""
    tf = np.float32(t)
    j = tf / np.float32(period)
    disc = np.float32(_exp32_host(np.float32(neg_r_dt) * tf))
    return _f32((np.float32(1.0) + np.float32(coupon) * j) * disc)


class DeviceForm(NamedTuple):
    """A functional as K4 runs it: ``code``, an integer ``period`` and up to
    ``MAX_PARAMS`` float32-exact parameters."""

    code: int
    period: int = 1
    params: tuple = ()


@dataclass(frozen=True)
class PathFunctional:
    """``(init, update, finalize)`` fold over per-step observations.

    ``init(obs0) -> acc``; ``update(acc, obs, t) -> acc`` with ``t`` the
    1-based step index; ``finalize(acc, n_steps) -> value`` with
    ``n_steps`` a float.  ``space`` is ``"price"`` (observe
    ``process.prices``) or ``"log"`` (observe ``process.log_prices``, or
    ``log32`` of the prices for a process without them).  ``device``
    maps the step count to the K4 :class:`DeviceForm`, or is None for a
    functional only the torch time loop runs.
    """

    init: Callable
    update: Callable
    finalize: Callable
    space: str = "price"
    device: Optional[Callable[[int], DeviceForm]] = None


def functional_observables(process, state, functionals):
    """Per-functional observation tuple for one step: the shared dispatch
    of ``space`` for the time loop and K4's plain version."""
    spaces = [f.space for f in functionals]
    has_log = hasattr(process, "log_prices")
    need_price = "price" in spaces or ("log" in spaces and not has_log)
    prices = process.prices(state) if need_price else None
    logp = None
    if "log" in spaces:
        logp = process.log_prices(state) if has_log else log32(prices)
    return tuple(logp if sp == "log" else prices for sp in spaces)


def _constant_form(code: int):
    return lambda n_steps: DeviceForm(code)


#: Arithmetic mean of the T+1 observations (spot included) — Asian options.
ARITH_MEAN = PathFunctional(
    init=lambda s: s,
    update=lambda acc, s, t: acc + s,
    finalize=lambda acc, n_steps: _div(acc, n_steps + 1.0),
    device=_constant_form(ARITH_MEAN_CODE),
)

#: Geometric mean of the T+1 observations — has a closed form under GBM.
GEO_MEAN = PathFunctional(
    init=lambda lp: lp,
    update=lambda acc, lp, t: acc + lp,
    finalize=lambda acc, n_steps: exp32(_div(acc, n_steps + 1.0)),
    space="log",
    device=_constant_form(GEO_MEAN_CODE),
)

#: Running maximum / minimum — barriers and lookbacks, folded in log space
#: and finalized to prices.
RUNNING_MAX = PathFunctional(
    init=lambda lp: lp,
    update=lambda acc, lp, t: torch.maximum(acc, lp),
    finalize=lambda acc, n_steps: exp32(acc),
    space="log",
    device=_constant_form(RUNNING_MAX_CODE),
)
RUNNING_MIN = PathFunctional(
    init=lambda lp: lp,
    update=lambda acc, lp, t: torch.minimum(acc, lp),
    finalize=lambda acc, n_steps: exp32(acc),
    space="log",
    device=_constant_form(RUNNING_MIN_CODE),
)


def barrier_survival_up(barrier: float, sigma: float, dt: float
                        ) -> PathFunctional:
    """Probability that the *continuous* path stayed below an up barrier:
    per step the Brownian-bridge survival ``1 - exp(-2 a b / (sigma^2
    dt))`` with ``a = log(B/S_t)``, ``b = log(B/S_{t+1})`` (exact under
    GBM).  Knock-out pays ``payoff * survival``, knock-in ``payoff * (1 -
    survival)`` from the same run.  Accumulator: (survival, previous log
    price); log-space fold."""
    log_b = _f32(math.log(barrier))
    inv = _f32(1.0 / (float(sigma) ** 2 * float(dt)))

    def update(acc, log_s, t):
        surv, prev = acc
        a = log_b - prev
        b = log_b - log_s
        p_cross = exp32(-2.0 * a * b * inv)
        alive = (a > 0) & (b > 0)
        return (surv * torch.where(alive, 1.0 - p_cross, 0.0), log_s)

    return PathFunctional(
        init=lambda log_s: (torch.where(log_s < log_b, 1.0, 0.0), log_s),
        update=update,
        finalize=lambda acc, n_steps: acc[0],
        space="log",
        device=lambda n_steps: DeviceForm(BARRIER_UP_CODE, 1, (log_b, inv)),
    )


def cliquet_sum(period: int, local_floor: float, local_cap: float
                ) -> PathFunctional:
    """Cliquet leg: the sum of period returns collared to [local_floor,
    local_cap], reset every ``period`` steps.  Accumulator: (running sum,
    price at the last reset); a trailing partial period is ignored."""
    if period < 1:
        raise ValueError("period must be >= 1")
    lo, hi = _f32(local_floor), _f32(local_cap)

    def update(acc, s, t):
        total, prev = acc
        if t % period:
            return (total, prev)
        ret = torch.clamp(s / prev - 1.0, lo, hi)
        return (total + ret, s)

    return PathFunctional(
        init=lambda s: (torch.zeros_like(s), s),
        update=update,
        finalize=lambda acc, n_steps: acc[0],
        device=lambda n_steps: DeviceForm(CLIQUET_CODE, period, (lo, hi)),
    )


def autocallable(period: int, trigger: float, coupon: float, r_dt: float,
                 pdi_barrier: float, s0: float) -> PathFunctional:
    """Discounted payoff of an autocallable (Phoenix-style) note.

    At each observation t_j = j*period a live note with ``S >= trigger``
    autocalls and pays ``(1 + j*coupon) * exp(-r_dt * t_j)``.  A note never
    called settles at maturity: the notional, or ``min(S_T/s0, 1)`` if the
    running minimum breached ``pdi_barrier``, discounted to 0.
    Accumulator: (alive, pay, running min, last price).  ``finalize``
    returns the discounted payoff per path.
    """
    if period < 1:
        raise ValueError("period must be >= 1")
    neg_r_dt, trig, cpn = _f32(-r_dt), _f32(trigger), _f32(coupon)
    pdi, s0_ = _f32(pdi_barrier), _f32(s0)

    def check(n_steps: int) -> int:
        n_steps = int(n_steps)
        if n_steps % period != 0:
            # Without a maturity observation, surviving S_T >= trigger
            # paths would silently forfeit every accrued coupon.
            raise ValueError(f"n_steps={n_steps} must be a multiple of the "
                             f"observation period {period}")
        return n_steps

    def neg_r_t(n_steps: int) -> float:
        return _f32(-r_dt * n_steps)

    def update(acc, s, t):
        alive, pay, run_min, _ = acc
        run_min = torch.minimum(run_min, s)
        if t % period == 0:
            called = (alive > 0.5) & (s >= trig)
            pay = torch.where(called, _call_value(t, period, cpn, neg_r_dt),
                              pay)
            alive = torch.where(called, 0.0, alive)
        return (alive, pay, run_min, s)

    def finalize(acc, n_steps):
        n_steps = check(n_steps)
        alive, pay, run_min, last = acc
        df_t = _exp32_host(neg_r_t(n_steps))
        breached = run_min <= pdi
        settle = df_t * torch.where(
            breached, torch.clamp(_div(last, s0_), max=1.0), 1.0)
        return torch.where(alive > 0.5, settle, pay)

    def device(n_steps: int) -> DeviceForm:
        n_steps = check(n_steps)
        return DeviceForm(AUTOCALL_CODE, period,
                          (neg_r_dt, trig, cpn, pdi, s0_, neg_r_t(n_steps)))

    return PathFunctional(
        init=lambda s: (torch.ones_like(s), torch.zeros_like(s), s, s),
        update=update,
        finalize=finalize,
        device=device,
    )


def worst_of_autocallable(period: int, trigger: float, coupon: float,
                          r_dt: float, pdi_barrier: float, s0
                          ) -> PathFunctional:
    """:func:`autocallable` on the WORST performance ``min_a S_a / s0_a``
    of a multi-asset state shaped (n_paths, A); ``trigger`` and
    ``pdi_barrier`` are in performance units.  It has no device form: a
    multi-asset state runs the torch time loop (``prefer_fused=False``)."""
    if period < 1:
        raise ValueError("period must be >= 1")
    s0v = torch.as_tensor(np.asarray(s0, np.float32))
    neg_r_dt, trig, cpn = _f32(-r_dt), _f32(trigger), _f32(coupon)
    pdi = _f32(pdi_barrier)

    def perf(s):
        return torch.amin(s / s0v.to(s.device), dim=-1)

    def init(s):
        w = perf(s)
        return (torch.ones_like(w), torch.zeros_like(w), w, w)

    def update(acc, s, t):
        alive, pay, run_min, _ = acc
        w = perf(s)
        run_min = torch.minimum(run_min, w)
        if t % period == 0:
            called = (alive > 0.5) & (w >= trig)
            pay = torch.where(called, _call_value(t, period, cpn, neg_r_dt),
                              pay)
            alive = torch.where(called, 0.0, alive)
        return (alive, pay, run_min, w)

    def finalize(acc, n_steps):
        n_steps = int(n_steps)
        if n_steps % period != 0:
            raise ValueError(f"n_steps={n_steps} must be a multiple of the "
                             f"observation period {period}")
        alive, pay, run_min, last = acc
        df_t = _exp32_host(_f32(-r_dt * n_steps))
        settle = df_t * torch.where(run_min <= pdi,
                                    torch.clamp(last, max=1.0), 1.0)
        return torch.where(alive > 0.5, settle, pay)

    return PathFunctional(init=init, update=update, finalize=finalize)


def realized_variance() -> PathFunctional:
    """Sum of squared log returns over the step grid — the variance-swap
    leg (fair strike = E[sum] / T).  Accumulator: (sum, previous log
    price); log-space fold."""
    return PathFunctional(
        init=lambda lp: (torch.zeros_like(lp), lp),
        update=lambda acc, lp, t: (acc[0] + torch.square(lp - acc[1]), lp),
        finalize=lambda acc, n_steps: acc[0],
        space="log",
        device=_constant_form(REALIZED_VAR_CODE),
    )


def trapezoid_integral(dt: float) -> PathFunctional:
    """Pathwise trapezoid rule for int_0^T x_t dt over the step grid.
    Accumulator: (sum, previous value)."""
    half_dt = _f32(0.5 * float(dt))
    return PathFunctional(
        init=lambda s: (torch.zeros_like(s), s),
        update=lambda acc, s, t: (acc[0] + (acc[1] + s) * half_dt, s),
        finalize=lambda acc, n_steps: acc[0],
        device=lambda n_steps: DeviceForm(TRAPEZOID_CODE, 1, (half_dt,)),
    )


def _simulate_functionals(process, n_paths: int, n_steps: int, k0: int,
                          k1: int, sampler, path_offset, functional_items):
    """The torch time loop, one step at a time: step, observe, update with
    the 1-based index.  It defines the semantics K4 reproduces."""
    names = [k for k, _ in functional_items]
    fns = [f for _, f in functional_items]
    sampler = PlainSampler() if sampler is None else sampler
    check_sampler(sampler, process, n_steps)
    check_steps(process, n_steps)
    ids = path_ids_for(n_paths, path_offset, process.device)
    state = process.init_state(ids)
    accs = [f.init(o) for f, o in
            zip(fns, functional_observables(process, state, fns))]
    for t in range(n_steps):
        eps = sampler.draws(process, k0, k1, ids, t)
        state = process.step(state, eps, t)
        obs = functional_observables(process, state, fns)
        accs = [f.update(a, o, t + 1) for f, a, o in zip(fns, accs, obs)]
    out = {"terminal": process.prices(state)}
    for name, f, a in zip(names, fns, accs):
        out[name] = f.finalize(a, float(n_steps))
    return out


def simulate_functionals(process, n_paths: int, n_steps: int, *, seed: int,
                         functionals: Dict[str, PathFunctional],
                         stream: int = 0, sampler=None, path_offset=0,
                         prefer_fused: bool = True) -> dict:
    """Terminal prices plus named path functionals, O(paths) memory.

    ``prefer_fused=True`` goes through ``engine.dispatch``'s gate: K4
    (``ops.fused_engine.fused_functionals``; the kernel on a CUDA process,
    its plain version on a CPU one) for the processes and samplers the
    kernels run, the torch time loop for the others.  On the kernel route
    a functional without a device form raises ``TypeError``;
    ``prefer_fused=False`` takes the torch time loop, which runs any of
    them.
    """
    items = tuple(functionals.items())
    if prefer_fused:
        from montecarlo_tpu_torch.engine.dispatch import functional_run

        return functional_run(process, n_paths, n_steps, seed=seed,
                              functionals=dict(items), stream=stream,
                              sampler=sampler, path_offset=path_offset)
    k0, k1 = key_from_seed(seed, stream)
    return _simulate_functionals(process, n_paths, n_steps, k0, k1, sampler,
                                 path_offset, items)


# --- payoffs over functionals ----------------------------------------------

def asian_call(avg, strike):
    return torch.clamp(avg - strike, min=0.0)


def up_and_out_call(terminal, running_max, strike, barrier):
    """Knocked out if the (discretely monitored) max breached the barrier."""
    alive = running_max < barrier
    return torch.where(alive, torch.clamp(terminal - strike, min=0.0), 0.0)


def down_and_out_call(terminal, running_min, strike, barrier):
    alive = running_min > barrier
    return torch.where(alive, torch.clamp(terminal - strike, min=0.0), 0.0)


def lookback_call_floating(terminal, running_min):
    """Floating-strike lookback call: S_T - min S_t."""
    return terminal - running_min


def variance_swap_strike_mc(process, n_paths: int, n_steps: int, *,
                            T: float, seed: int, **sim_kw) -> dict:
    """Fair variance-swap strike (annualized) by simulation:
    K_var = E[sum (log S_{t+1}/S_t)^2] / T, discretely monitored."""
    from montecarlo_tpu_torch.engine.pricing import mc_estimate

    out = simulate_functionals(process, n_paths, n_steps, seed=seed,
                               functionals={"rv": realized_variance()},
                               **sim_kw)
    est = mc_estimate(_div(out["rv"], T))
    return {"strike": est["price"], "std_err": est["std_err"],
            "n_paths": est["n_paths"]}


def geometric_asian_call_closed_form(s0, strike, r, sigma, T, n_steps):
    """Closed form of the discretely monitored geometric Asian call under
    GBM, monitored at the N+1 times 0, T/N, ..., T (spot included) as
    GEO_MEAN observes them."""
    from scipy.stats import norm

    times = np.arange(0, n_steps + 1) * (T / n_steps)
    m = len(times)
    mu_g = (r - 0.5 * sigma**2) * times.mean()
    # Var of the mean of correlated BMs: cov(W_ti, W_tj) = min(ti, tj).
    cov_sum = float(np.minimum.outer(times, times).sum())
    var_g = sigma**2 * cov_sum / m**2
    sd_g = np.sqrt(var_g)
    d1 = (np.log(s0 / strike) + mu_g + var_g) / sd_g
    d2 = d1 - sd_g
    fwd = s0 * np.exp(mu_g + 0.5 * var_g)
    return float(np.exp(-r * T) * (fwd * norm.cdf(d1)
                                   - strike * norm.cdf(d2)))
