"""American and Bermudan exercise by Longstaff-Schwartz least-squares Monte
Carlo, and the Andersen-Broadie dual upper bound.

The port of ``montecarlo_tpu/engine/american.py``.  The paths come from
the torch time loop (``engine.simulate``, ``mode="paths"``; the JAX package
takes them from its scan, no kernel), and the backward induction walks the
exercise dates in reverse: at each date a tiny weighted normal-equation
system on a standardized polynomial basis of the in-the-money paths (ITM
selection is a weight mask, not a gather), solved by
``torch.linalg.solve_ex`` whose error flags are read once, after the loop
(``torch.linalg.solve`` reads one on the host at every date).  JAX's ridge
``1e-6 I`` keeps every system regular.

Four forms, with JAX's names, signatures, return keys and streams:

- spot only (``lsm_price``, ``lsm_policy``, ``lsm_exercise_policy``);
- path-dependent (``lsm_price_path_dependent``): the joint (spot, running
  functional) state, the functional finalized at every step;
- stochastic volatility (``lsm_policy_sv``, ``lsm_price_sv``): the joint
  (spot, variance) state, its own forward loop on stream 0;
- multi-asset (``lsm_policy_multi``, ``lsm_price_multi``): a total-degree
  polynomial in the descending-sorted prices.

Each ``*_policy`` also fits an all-paths value surrogate that
``andersen_broadie_bound`` (and its ``_sv`` and ``_multi`` forms) builds
its martingale from, on streams of its own: outer ``0xAB50`` / inner
``0xAB51`` (SV ``0xAB54`` / ``0xAB55``, multi ``0xAB52`` / ``0xAB53``),
inner ids ``ids * n_inner + j`` wrapped mod 2^32.  The dual sums each
outer path's inner samples by ``tree_sum``'s fixed tree and evaluates its
polynomials column by column, so a path's maximum is the same bits in any
batch: the sharded dual (``parallel.sharded``) relies on it.
``american_price_and_greeks`` differentiates the stopped value under a
frozen policy by reverse mode through the torch loop, each step
checkpointed.  ``binomial_american_put`` is the NumPy oracle.
"""

from __future__ import annotations

import dataclasses
from itertools import product

import numpy as np
import torch

from montecarlo_tpu_torch.engine.greeks import float_leaves, grads_like
from montecarlo_tpu_torch.engine.simulate import (cast_state, path_ids_for,
                                                  simulate)
from montecarlo_tpu_torch.precision import factor_product
from montecarlo_tpu_torch.rng.normal import log32
from montecarlo_tpu_torch.rng.threefry import MASK32
from montecarlo_tpu_torch.stats.welford import tree_sum

F32 = torch.float32


# --- bases, products and solves ------------------------------------------------

def _basis(s, degree: int):
    """Polynomial basis on normalized prices: [1, x, x^2, ...]."""
    cols = [torch.ones_like(s)]
    for _ in range(degree):
        cols.append(cols[-1] * s)
    return torch.stack(cols, dim=-1)  # (..., degree+1)


def _basis2(x, y, degree: int):
    """2-D polynomial basis of total degree <= ``degree``: [1, y, y^2, ...,
    x, xy, ..., x^degree], (degree+1)(degree+2)/2 terms, JAX's order and
    powers (``x ** i``)."""
    cols = []
    for i in range(degree + 1):
        xi = torch.ones_like(x) if i == 0 else x ** i
        for j in range(degree + 1 - i):
            cols.append(xi if j == 0 else xi * y ** j)
    return torch.stack(cols, dim=-1)


def _multi_indices(n_vars: int, degree: int):
    """All exponent tuples with total degree <= ``degree``, ordered by total
    degree then lexicographically (the betas' order)."""
    idxs = [m for m in product(range(degree + 1), repeat=n_vars)
            if sum(m) <= degree]
    return sorted(idxs, key=lambda m: (sum(m), m))


def _basis_multi(x, degree: int):
    """Multivariate polynomial basis of total degree <= ``degree`` of ``x``
    (..., A): (..., C(A + degree, A)) monomials from per-coordinate powers
    by repeated multiplies, in ``_multi_indices``' order."""
    a = x.shape[-1]
    pows = []
    for c in range(a):
        col = [torch.ones_like(x[..., c])]
        for _ in range(degree):
            col.append(col[-1] * x[..., c])
        pows.append(col)
    cols = []
    for m in _multi_indices(a, degree):
        term = None
        for c, p in enumerate(m):
            if p:
                term = pows[c][p] if term is None else term * pows[c][p]
        cols.append(torch.ones_like(x[..., 0]) if term is None else term)
    return torch.stack(cols, dim=-1)


def _dot(x, beta):
    """``x @ beta`` over the last axis, column by column in order: the same
    bits for a path in any batch (a library product picks its order from
    the batch's shape)."""
    acc = x[..., 0] * beta[0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i] * beta[i]
    return acc


def _gram(xw, y):
    """``xw.T @ y`` in the full precision of the dtype (float32 products
    keep every mantissa bit whatever the process-wide TF32 setting)."""
    return factor_product(xw.T, y)


def _tensor(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _normal_solve(x, w, target, wsum, infos, ridge=1e-6):
    """The weighted normal equations ``(xw.T x / wsum + ridge I) beta =
    xw.T target / wsum`` (``w`` None: every path, weight 1), solved with
    its error flag kept in ``infos``."""
    xw = x if w is None else x * w[:, None]
    k = x.shape[-1]
    a = (_gram(xw, x) / wsum
         + ridge * torch.eye(k, dtype=x.dtype, device=x.device))
    beta, info = torch.linalg.solve_ex(a, _gram(xw, target) / wsum)
    infos.append(info)
    return beta


def _check_solves(infos) -> None:
    """One host read for every solve of a run."""
    if infos and bool(torch.stack(infos).any()):
        raise ValueError("a singular LSM normal-equation system (non-finite "
                         "paths or payoffs?)")


def _wstats(x, w, wsum):
    """Weighted per-coordinate mean/std of x (N, A) under weights w (N,)."""
    m = torch.sum(w[:, None] * x, dim=0) / wsum
    sd = torch.sqrt(torch.sum(w[:, None] * torch.square(x - m[None, :]),
                              dim=0) / wsum + 1e-12)
    return m, sd


def _itm_stats(v, w, wsum):
    """Weighted mean and std of v (N,) over the ITM weights."""
    m = torch.sum(w * v) / wsum
    return m, torch.sqrt(torch.sum(w * torch.square(v - m)) / wsum + 1e-12)


def _itm(exercise, dtype):
    itm = exercise > 0
    w = itm.to(dtype)
    return itm, w, torch.clamp(torch.sum(w), min=1.0)


def _result(value, n_paths: int) -> dict:
    n = _tensor(n_paths, value.dtype, value.device)
    return {"price": torch.mean(value),
            "std_err": torch.std(value, correction=1) / torch.sqrt(n),
            "n_paths": n_paths}


def _draws(process, seed, stream, ids, t, dtype):
    """The process's own draws (JAX's PlainSampler) in ``dtype``."""
    extra = () if dtype == F32 else (dtype,)
    return process.draws(seed, stream, ids, t, *extra)


# --- spot-only LSM ------------------------------------------------------------

def _regression_step(s_t, disc, payoff_fn, degree: int, dtype, infos):
    """One backward LSM regression on a basis standardized over the ITM
    paths (weighted mean/std) with averaged normal equations: raw bases
    on clustered prices are near-collinear in float32.  Returns
    (new_cashflow, beta, mean, std)."""
    exercise = payoff_fn(s_t)
    itm, w, wsum = _itm(exercise, dtype)
    m, sd = _itm_stats(s_t, w, wsum)
    x = _basis((s_t - m) / sd, degree)
    beta = _normal_solve(x, w, disc, wsum, infos)
    take = itm & (exercise >= x @ beta)
    return torch.where(take, exercise, disc), beta, m, sd


def _discount(rate, dt, dtype, device):
    return torch.exp(_tensor(-rate * dt, dtype, device))


def lsm_price(process, payoff_fn, n_paths: int, n_steps: int, *, seed: int,
              rate, dt, degree: int = 2, dtype=F32):
    """Price an American-exercise payoff by LSM; ``payoff_fn`` is the
    immediate-exercise payoff of the price array, the discount per step
    ``exp(-rate dt)``.  Returns ``{"price", "std_err", "n_paths"}`` with
    plain LSM's small low bias."""
    result, _ = lsm_policy(process, payoff_fn, n_paths, n_steps, seed=seed,
                           rate=rate, dt=dt, degree=degree, dtype=dtype,
                           fit_value=False)
    return result


def lsm_policy(process, payoff_fn, n_paths: int, n_steps: int, *, seed: int,
               rate, dt, degree: int = 2, value_degree: int | None = None,
               dtype=F32, fit_value: bool = True):
    """LSM price **and** the value surrogate of its policy: each backward
    step also fits an all-paths polynomial of degree ``value_degree``
    (default ``2 * degree + 1``) to the realized value, from which the
    dual builds its martingale.  Returns ``(result, (vbetas, vmeans,
    vstds))`` for exercise dates 1..T-1 in forward order, the basis
    standardized by ``(s - vmeans[t-1]) / vstds[t-1]``; ``fit_value``
    False skips the surrogate (zeros, means 0, stds 1)."""
    vdeg = 2 * degree + 1 if value_degree is None else value_degree
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)
    dev = paths.device
    df = _discount(rate, dt, dtype, dev)
    n = _tensor(n_paths, dtype, dev)
    cashflow = payoff_fn(paths[-1])
    infos, policy = [], []
    for t in range(n_steps - 1, 0, -1):
        s_t = paths[t]
        cashflow, *_ = _regression_step(s_t, df * cashflow, payoff_fn,
                                        degree, dtype, infos)
        if not fit_value:
            policy.append((torch.zeros(vdeg + 1, dtype=dtype, device=dev),
                           torch.zeros((), dtype=dtype, device=dev),
                           torch.ones((), dtype=dtype, device=dev)))
            continue
        ma = torch.mean(s_t)
        sda = torch.std(s_t, correction=0) + 1e-12
        xa = _basis((s_t - ma) / sda, vdeg)
        policy.append((_normal_solve(xa, None, cashflow, n, infos), ma,
                       sda))
    _check_solves(infos)
    return _result(df * cashflow, n_paths), _forward(policy)


def _forward(rev):
    """Per-date tuples collected backward -> stacked arrays in forward
    date order."""
    return tuple(torch.stack(col[::-1]) for col in zip(*rev))


def lsm_exercise_policy(process, payoff_fn, n_paths: int, n_steps: int, *,
                        seed: int, rate, dt, degree: int = 2, dtype=F32):
    """The continuation regression (beta, mean, std) for steps 1..T-1: the
    exercise rule itself, which ``american_price_and_greeks`` freezes."""
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)
    df = _discount(rate, dt, dtype, paths.device)
    cashflow = payoff_fn(paths[-1])
    infos, rev = [], []
    for t in range(n_steps - 1, 0, -1):
        cashflow, beta, m, sd = _regression_step(
            paths[t], df * cashflow, payoff_fn, degree, dtype, infos)
        rev.append((beta, m, sd))
    _check_solves(infos)
    return _forward(rev)


# --- path-dependent LSM --------------------------------------------------------

def _joint_step(s_t, a_t, disc, exercise, degree, dtype, infos):
    """The continuation on the ITM-standardized pair (s_t, a_t) with the
    2-D basis; returns (itm, continuation)."""
    itm, w, wsum = _itm(exercise, dtype)
    ms, ss = _itm_stats(s_t, w, wsum)
    ma, sa = _itm_stats(a_t, w, wsum)
    x = _basis2((s_t - ms) / ss, (a_t - ma) / sa, degree)
    return itm, x @ _normal_solve(x, w, disc, wsum, infos)


def lsm_price_path_dependent(process, payoff_fn, functional, n_paths: int,
                             n_steps: int, *, seed: int, rate, dt,
                             degree: int = 2, exercise_from: int = 1,
                             dtype=F32):
    """American exercise on a path-dependent payoff by LSM on the joint
    (spot, running functional) state: ``payoff_fn(s_t, a_t)`` with ``a_t``
    the running value of ``functional`` finalized at step t (ARITH_MEAN:
    the to-date average), the continuation on a 2-D basis of total degree
    ``degree`` (Longstaff-Schwartz 2001's Asian).  ``exercise_from`` is the
    first exercisable step (``n_steps``: European).  A log-space
    functional observes ``log32`` of the prices.  Returns ``{"price",
    "std_err", "n_paths"}``."""
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)
    obs = log32(paths) if functional.space == "log" else paths
    acc = functional.init(obs[0])
    a_full = [functional.finalize(acc, 0.0)]
    for t in range(1, n_steps + 1):
        acc = functional.update(acc, obs[t], t)
        a_full.append(functional.finalize(acc, float(t)))
    df = _discount(rate, dt, dtype, paths.device)
    cashflow = payoff_fn(paths[-1], a_full[-1])
    infos = []
    for t in range(n_steps - 1, 0, -1):
        disc = df * cashflow
        exercise = payoff_fn(paths[t], a_full[t])
        itm, cont = _joint_step(paths[t], a_full[t], disc, exercise, degree,
                                dtype, infos)
        take = itm & (exercise >= cont) & (t >= exercise_from)
        cashflow = torch.where(take, exercise, disc)
    _check_solves(infos)
    return _result(df * cashflow, n_paths)


# --- stochastic-vol LSM --------------------------------------------------------

def _default_aux(state):
    """The variance leaf of a stochastic-vol state (Heston/Bates/QE/SLV
    ``v``, GARCH ``var``), the second regressor."""
    for name in ("v", "var"):
        if hasattr(state, name):
            return getattr(state, name)
    raise ValueError(
        f"{type(state).__name__} has no variance leaf — pass aux_fn")


def lsm_policy_sv(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, rate, dt, aux_fn=_default_aux,
                  degree: int = 2, value_degree: int | None = None,
                  dtype=F32, fit_value: bool = True):
    """LSM for stochastic-vol processes: the continuation on the joint
    (spot, ``aux_fn(state)``) pair, total degree ``degree``, so that the
    exercise rule sees the vol state.  The forward pass is its own loop on
    stream 0 keeping (prices, aux) after every step.  Returns ``(result,
    (vbetas, vmeans (2,), vstds (2,)))``, the value surrogate of total
    degree ``value_degree`` (default ``degree + 1``) that
    ``andersen_broadie_bound_sv`` takes."""
    vdeg = degree + 1 if value_degree is None else value_degree
    dev = process.device
    ids = path_ids_for(n_paths, 0, dev)
    state = cast_state(process.init_state(ids), dtype)
    s_traj, a_traj = [], []
    for t in range(n_steps):
        state = process.step(state, _draws(process, seed, 0, ids, t, dtype),
                             t)
        s_traj.append(process.prices(state))
        a_traj.append(aux_fn(state))
    df = _discount(rate, dt, dtype, dev)
    n = _tensor(n_paths, dtype, dev)
    n_vterms = (vdeg + 1) * (vdeg + 2) // 2
    cashflow = payoff_fn(s_traj[-1])
    infos, rev = [], []
    for t in range(n_steps - 2, -1, -1):
        s_t, a_t = s_traj[t], a_traj[t]
        disc = df * cashflow
        exercise = payoff_fn(s_t)
        itm, cont = _joint_step(s_t, a_t, disc, exercise, degree, dtype,
                                infos)
        cashflow = torch.where(itm & (exercise >= cont), exercise, disc)
        if not fit_value:
            rev.append((torch.zeros(n_vterms, dtype=dtype, device=dev),
                        torch.zeros(2, dtype=dtype, device=dev),
                        torch.ones(2, dtype=dtype, device=dev)))
            continue
        msa, ssa = torch.mean(s_t), torch.std(s_t, correction=0) + 1e-12
        maa, saa = torch.mean(a_t), torch.std(a_t, correction=0) + 1e-12
        xa = _basis2((s_t - msa) / ssa, (a_t - maa) / saa, vdeg)
        rev.append((_normal_solve(xa, None, cashflow, n, infos),
                    torch.stack([msa, maa]), torch.stack([ssa, saa])))
    _check_solves(infos)
    return _result(df * cashflow, n_paths), _forward(rev)


def lsm_price_sv(process, payoff_fn, n_paths: int, n_steps: int, *,
                 seed: int, rate, dt, aux_fn=_default_aux, degree: int = 2,
                 dtype=F32):
    """Stochastic-vol American LSM price (see :func:`lsm_policy_sv`)."""
    result, _ = lsm_policy_sv(process, payoff_fn, n_paths, n_steps,
                              seed=seed, rate=rate, dt=dt, aux_fn=aux_fn,
                              degree=degree, dtype=dtype, fit_value=False)
    return result


# --- multi-asset LSM ------------------------------------------------------------

def _features(s, sort_assets: bool):
    """Prices sorted in descending order (exchangeable payoffs), or as
    they are."""
    return torch.sort(s, dim=-1, descending=True).values if sort_assets \
        else s


def lsm_policy_multi(process, payoff_fn, n_paths: int, n_steps: int, *,
                     seed: int, rate, dt, degree: int = 3,
                     value_degree: int | None = None, dtype=F32,
                     fit_value: bool = True, sort_assets: bool = True):
    """Multi-asset LSM price and value surrogate (the Bermudan max-call,
    Longstaff-Schwartz 2001 8.1 / Andersen-Broadie 2004): ``payoff_fn``
    maps (N, A) prices to (N,) exercise values; the continuation is a
    total-degree-``degree`` polynomial of the ITM-standardized features
    (the prices sorted descending, or as they are with ``sort_assets``
    False).  Returns ``(result, (vbetas, vmeans (A,), vstds (A,)))``, the
    all-paths value fit of total degree ``value_degree`` (default
    ``degree + 1``) that ``andersen_broadie_bound_multi`` takes."""
    vdeg = degree + 1 if value_degree is None else value_degree
    paths = simulate(process, n_paths, n_steps, seed=seed, mode="paths",
                     dtype=dtype)  # (T+1, N, A)
    dev = paths.device
    n_assets = paths.shape[-1]
    n_vterms = len(_multi_indices(n_assets, vdeg))
    df = _discount(rate, dt, dtype, dev)
    n = _tensor(n_paths, dtype, dev)
    cashflow = payoff_fn(paths[-1])
    infos, rev = [], []
    for t in range(n_steps - 1, 0, -1):
        s_t = paths[t]
        disc = df * cashflow
        feats = _features(s_t, sort_assets)
        exercise = payoff_fn(s_t)
        itm, w, wsum = _itm(exercise, dtype)
        m, sd = _wstats(feats, w, wsum)
        x = _basis_multi((feats - m[None, :]) / sd[None, :], degree)
        beta = _normal_solve(x, w, disc, wsum, infos)
        cashflow = torch.where(itm & (exercise >= x @ beta), exercise, disc)
        if not fit_value:
            rev.append((torch.zeros(n_vterms, dtype=dtype, device=dev),
                        torch.zeros(n_assets, dtype=dtype, device=dev),
                        torch.ones(n_assets, dtype=dtype, device=dev)))
            continue
        ma, sda = _wstats(feats, torch.ones_like(w), n)
        xa = _basis_multi((feats - ma[None, :]) / sda[None, :], vdeg)
        rev.append((_normal_solve(xa, None, cashflow, n, infos), ma, sda))
    _check_solves(infos)
    return _result(df * cashflow, n_paths), _forward(rev)


def lsm_price_multi(process, payoff_fn, n_paths: int, n_steps: int, *,
                    seed: int, rate, dt, degree: int = 3, dtype=F32,
                    sort_assets: bool = True):
    """Multi-asset American/Bermudan LSM price (see
    :func:`lsm_policy_multi`)."""
    result, _ = lsm_policy_multi(
        process, payoff_fn, n_paths, n_steps, seed=seed, rate=rate, dt=dt,
        degree=degree, dtype=dtype, fit_value=False,
        sort_assets=sort_assets)
    return result


# --- the Andersen-Broadie dual ---------------------------------------------------

def _dual_best(process, payoff_fn, fit, ids, n_inner: int, n_steps: int, *,
               seed, streams, rate, dt, dtype):
    """Per-path dual maxima ``max_t (disc_t h_t - M_t)`` for the global
    path ids ``ids``, the martingale from the surrogate ``v_t =
    max(h_t, fit(state, prices, k))`` (``h_t`` at the last step):
    ``dM_t = disc_t v_t(S_t) - E[disc_t v_t | state_{t-1}]``, the one-step
    expectation from ``n_inner`` samples of each outer state on the inner
    stream.  ``k = min(t, T - 2)`` is the policy's date index.  Every draw
    is a function of (seed, stream, global id, t) and every reduction is
    per path, so a shard holding a subset of ids gets the full run's
    bits."""
    outer_stream, inner_stream = streams
    n_ids = ids.shape[0]
    dev = ids.device
    state = cast_state(process.init_state(ids), dtype)
    df_t = _discount(rate, dt, dtype, dev)
    inner_ids = (ids[:, None] * n_inner
                 + torch.arange(n_inner, dtype=torch.int64,
                                device=dev)[None, :]) & MASK32
    n_in = _tensor(n_inner, dtype, dev)

    def surrogate(st, disc, t):
        prices = process.prices(st)
        h = payoff_fn(prices)
        v = h if t == n_steps - 1 else torch.maximum(
            h, fit(st, prices, min(t, n_steps - 2)))
        return disc * v, disc * h

    best = payoff_fn(process.prices(state))
    mart = torch.zeros(n_ids, dtype=dtype, device=dev)
    disc = _tensor(1.0, dtype, dev)
    for t in range(n_steps):
        disc = disc * df_t
        rep = type(state)(*(x[:, None].expand(n_ids, n_inner, *x.shape[1:])
                            for x in state))
        stepped = process.step(
            rep, _draws(process, seed, inner_stream, inner_ids, t, dtype), t)
        v_in, _ = surrogate(stepped, disc, t)
        vbar = tree_sum(v_in, axis=1) / n_in
        state = process.step(
            state, _draws(process, seed, outer_stream, ids, t, dtype), t)
        v_out, h_out = surrogate(state, disc, t)
        mart = mart + (v_out - vbar)
        best = torch.maximum(best, h_out - mart)
    return best


def _upper(best, n_outer: int) -> dict:
    out = _result(best, n_outer)
    return {"upper": out["price"], "std_err": out["std_err"],
            "n_paths": n_outer}


def _ab_best(process, payoff_fn, policy, ids, n_inner: int, n_steps: int, *,
             seed, rate, dt, degree: int, value_degree, dtype):
    """Per-path dual maxima of :func:`andersen_broadie_bound` for the
    global path ids ``ids``: the shared core of it and of the sharded
    dual (``parallel.sharded.sharded_andersen_broadie_bound``)."""
    vdeg = 2 * degree + 1 if value_degree is None else value_degree
    betas, means, stds = policy

    def fit(st, prices, k):
        return _dot(_basis((prices - means[k]) / stds[k], vdeg), betas[k])

    return _dual_best(process, payoff_fn, fit, ids, n_inner, n_steps,
                      seed=seed, streams=(0xAB50, 0xAB51), rate=rate, dt=dt,
                      dtype=dtype)


def andersen_broadie_bound(process, payoff_fn, policy, n_outer: int,
                           n_inner: int, n_steps: int, *, seed: int,
                           rate, dt, degree: int = 2,
                           value_degree: int | None = None, dtype=F32):
    """Duality (Andersen-Broadie 2004 / Haugh-Kogan) upper bound on the
    American price from :func:`lsm_policy`'s value surrogate, on streams of
    its own (outer paths never reuse the training paths of stream 0).
    Returns ``{"upper", "std_err", "n_paths"}``."""
    ids = path_ids_for(n_outer, 0, process.device)
    best = _ab_best(process, payoff_fn, policy, ids, n_inner, n_steps,
                    seed=seed, rate=rate, dt=dt, degree=degree,
                    value_degree=value_degree, dtype=dtype)
    return _upper(best, n_outer)


def andersen_broadie_bound_sv(process, payoff_fn, policy, n_outer: int,
                              n_inner: int, n_steps: int, *, seed: int,
                              rate, dt, aux_fn=_default_aux,
                              degree: int = 2,
                              value_degree: int | None = None, dtype=F32):
    """The dual with :func:`lsm_policy_sv`'s (spot, aux) surrogate, on
    streams ``0xAB54`` / ``0xAB55``."""
    vdeg = degree + 1 if value_degree is None else value_degree
    betas, means, stds = policy

    def fit(st, prices, k):
        m, sd = means[k], stds[k]
        return _dot(_basis2((prices - m[0]) / sd[0],
                            (aux_fn(st) - m[1]) / sd[1], vdeg), betas[k])

    ids = path_ids_for(n_outer, 0, process.device)
    best = _dual_best(process, payoff_fn, fit, ids, n_inner, n_steps,
                      seed=seed, streams=(0xAB54, 0xAB55), rate=rate, dt=dt,
                      dtype=dtype)
    return _upper(best, n_outer)


def andersen_broadie_bound_multi(process, payoff_fn, policy, n_outer: int,
                                 n_inner: int, n_steps: int, *, seed: int,
                                 rate, dt, degree: int = 3,
                                 value_degree: int | None = None,
                                 dtype=F32, sort_assets: bool = True):
    """The dual with :func:`lsm_policy_multi`'s surrogate, on streams
    ``0xAB52`` / ``0xAB53``: with the LSM lower bound it brackets the
    published Andersen-Broadie (2004) max-call values."""
    vdeg = degree + 1 if value_degree is None else value_degree
    betas, means, stds = policy

    def fit(st, prices, k):
        z = (_features(prices, sort_assets) - means[k]) / stds[k]
        return _dot(_basis_multi(z, vdeg), betas[k])

    ids = path_ids_for(n_outer, 0, process.device)
    best = _dual_best(process, payoff_fn, fit, ids, n_inner, n_steps,
                      seed=seed, streams=(0xAB52, 0xAB53), rate=rate, dt=dt,
                      dtype=dtype)
    return _upper(best, n_outer)


# --- policy-frozen greeks ----------------------------------------------------------

def american_price_and_greeks(process, payoff_fn, policy, n_paths: int,
                              n_steps: int, *, seed: int, rate, dt,
                              stream: int = 0x4A3E, degree: int = 2,
                              dtype=F32):
    """American price and pathwise greeks by policy freezing: with the
    exercise rule (``policy`` from :func:`lsm_exercise_policy`) held
    constant, the stopped value E[D^tau h(S_tau)] is pathwise
    differentiable in the process's parameters (the stopping indicators
    are piecewise constant; the policy's own dependence vanishes at the
    optimum).  The forward pass runs on a fresh stream (``0x4A3E``), the
    torch loop with each step checkpointed, and reverse mode
    differentiates it over the process's float leaves.  Returns ``(price,
    grads)``, ``grads`` a dataclass shaped like ``process`` (``grads.s0``
    delta, ``grads.sigma`` vega, ...)."""
    from torch.utils.checkpoint import checkpoint

    betas, ms, sds = (p.detach() for p in policy)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in float_leaves(process).items()}
    proc = dataclasses.replace(process, **leaves)
    dev = process.device
    ids = path_ids_for(n_paths, 0, dev)
    df = _discount(rate, dt, dtype, dev)

    def body(state, alive, acc, disc, t):
        state = proc.step(state, _draws(proc, seed, stream, ids, t, dtype),
                          t)
        disc = disc * df
        s = proc.prices(state)
        h = payoff_fn(s)
        k = min(t, n_steps - 2)
        cont = _dot(_basis((s - ms[k]) / sds[k], degree), betas[k])
        take = alive & (h > 0)
        if t != n_steps - 1:
            take = take & (h >= cont)
        acc = acc + torch.where(take, disc * h, 0.0)
        return state, alive & ~take, acc, disc

    with torch.enable_grad():
        state = cast_state(proc.init_state(ids), dtype)
        alive = torch.ones(n_paths, dtype=torch.bool, device=dev)
        acc = torch.zeros(n_paths, dtype=dtype, device=dev)
        disc = _tensor(1.0, dtype, dev)
        for t in range(n_steps):
            state, alive, acc, disc = checkpoint(
                body, state, alive, acc, disc, t, use_reentrant=False)
        price = torch.mean(acc)
        grads = {}
        if price.requires_grad:
            got = torch.autograd.grad(price, list(leaves.values()),
                                      allow_unused=True)
            grads = dict(zip(leaves, got))
    return price.detach(), grads_like(process, grads)


# --- the oracle --------------------------------------------------------------------

def binomial_american_put(s0, strike, r, sigma, T, n_steps: int = 1000):
    """CRR binomial-tree American put — the validation oracle (NumPy,
    float64)."""
    dt = T / n_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    p = (np.exp(r * dt) - d) / (u - d)
    disc = np.exp(-r * dt)
    j = np.arange(n_steps + 1)
    prices = s0 * u ** (n_steps - j) * d ** j
    values = np.maximum(strike - prices, 0.0)
    for step in range(n_steps - 1, -1, -1):
        prices = prices[:-1] / u  # prices at this layer
        values = disc * (p * values[:-1] + (1 - p) * values[1:])
        values = np.maximum(values, strike - prices)
    return float(values[0])


__all__ = [
    "lsm_price", "lsm_policy", "lsm_exercise_policy",
    "lsm_price_path_dependent", "lsm_policy_sv", "lsm_price_sv",
    "lsm_policy_multi", "lsm_price_multi", "andersen_broadie_bound",
    "andersen_broadie_bound_sv", "andersen_broadie_bound_multi",
    "american_price_and_greeks", "binomial_american_put",
]
