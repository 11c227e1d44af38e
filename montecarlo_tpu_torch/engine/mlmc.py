"""Multilevel Monte Carlo (Giles 2008): coupled-level estimation.

The port of ``montecarlo_tpu/engine/mlmc.py``.  The fine-grid expectation
telescopes over a geometric ladder of step sizes,

    E[P_L] = E[P_0] + sum_{l=1..L} E[P_l - P_{l-1}],

each difference estimated on coupled paths: the fine path takes M
sub-steps per coarse step on its own draws, and the coarse step takes
their sum scaled by 1/sqrt(M) (summed in sub-step order, then scaled).
The coupling needs Gaussian innovations that aggregate across sub-steps,
so the process must draw normals only (``NormalDrawsMixin``: Euler GBM,
GBM, Heston, ...); the bootstrap GARCH's resampled shocks are refused.

Routes: level 0 in float32 is the engine's ordinary run through the port's
one gate (``engine.dispatch``): K2 for terminal payoffs
(``terminal_prices``), K4's {avg} for ``payoff_on="mean"``
(``functional_run``), on the card; the coupled levels >= 1 are a torch
loop over coarse steps with the M fine sub-steps inside, as JAX scans
them.  ``dtype=torch.float64`` runs every level on that loop with the JAX
package's float64 draws (the kernels are float32).

Statistics: a level's moments over a multiple of 4096 paths are 4096-path
block states (``parallel.sharded.block_moments``) merged by the fixed tree
(``stats.welford.moments_reduce``), so a level is bitwise the same bits
over any mesh and without one; other counts take ``moments_from_array``.
Level l draws on stream ``stream_base + l`` with path ids continuing across
chunks, so a fixed seed reproduces the whole adaptive run bitwise; the
ladder and the Giles allocation run on the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from montecarlo_tpu_torch.engine.simulate import cast_state, path_ids_for
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from montecarlo_tpu_torch.stats.welford import (MomentState,
                                                moments_from_array,
                                                moments_merge,
                                                moments_reduce, variance)

#: Paths per statistics block of a level.
BLOCK = 4096
#: Most paths ``mlmc_estimate`` simulates in one run of a level.
RUN_PATHS = 1 << 22


def _coupled_values(fine, coarse, payoff_fn, n_paths: int,
                    n_coarse_steps: int, m_refine: int, seed: int,
                    stream: int, dtype, path_offset,
                    payoff_on: str = "terminal"):
    """Per-path ``(Y, P_fine)`` under the level coupling, on the fine
    process's device.  ``coarse`` None is level 0 on the same loop (Y =
    P_fine, ``n_coarse_steps`` then counting fine steps with
    ``m_refine`` 1).  ``payoff_on="mean"`` feeds each grid's own
    arithmetic average of its prices (spot included) to the payoff: the
    Asian telescope, where each level refines the monitoring grid."""
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, fine.device)
    fs = cast_state(fine.init_state(ids), dtype)
    cs = (None if coarse is None
          else cast_state(coarse.init_state(ids), dtype))
    inv_sqrt_m = torch.full((), 1.0 / math.sqrt(m_refine), dtype=dtype,
                            device=ids.device)
    track_mean = payoff_on == "mean"
    fa = fine.prices(fs) if track_mean else None
    ca = coarse.prices(cs) if track_mean and coarse is not None else None
    for j in range(n_coarse_steps):
        t0 = j * m_refine
        sums = None
        for m in range(m_refine):
            eps = fine.draws(k0, k1, ids, t0 + m, dtype)
            fs = fine.step(fs, eps, t0 + m)
            if track_mean:
                fa = fa + fine.prices(fs)
            sums = eps if sums is None else tuple(
                a + b for a, b in zip(sums, eps))
        if coarse is not None:
            cs = coarse.step(cs, tuple(s * inv_sqrt_m for s in sums), j)
            if track_mean:
                ca = ca + coarse.prices(cs)
    n_fine = n_coarse_steps * m_refine
    if track_mean:
        p_fine = payoff_fn(fa / torch.full((), n_fine + 1.0, dtype=fa.dtype,
                                           device=fa.device))
    else:
        p_fine = payoff_fn(fine.prices(fs))
    if coarse is None:
        return p_fine, p_fine
    if track_mean:
        p_coarse = payoff_fn(ca / torch.full(
            (), n_coarse_steps + 1.0, dtype=ca.dtype, device=ca.device))
    else:
        p_coarse = payoff_fn(coarse.prices(cs))
    return p_fine - p_coarse, p_fine


def _level0_values(proc, payoff_fn, n_paths: int, n_steps: int, seed: int,
                   stream: int, path_offset, payoff_on: str):
    """Level 0 in float32 through the engine's gate: K2's terminals, or
    K4's {avg} for the mean (their plain versions on the CPU)."""
    from montecarlo_tpu_torch.engine.dispatch import (functional_run,
                                                      terminal_prices)
    from montecarlo_tpu_torch.engine.functionals import ARITH_MEAN

    if payoff_on == "mean":
        out = functional_run(proc, n_paths, n_steps, seed=seed,
                             stream=stream, path_offset=path_offset,
                             functionals={"avg": ARITH_MEAN})
        return payoff_fn(out["avg"])
    return payoff_fn(terminal_prices(proc, n_paths, n_steps, seed=seed,
                                     stream=stream, path_offset=path_offset))


def _level_values(make_process, payoff_fn, level: int, n_paths: int,
                  seed: int, n0_steps: int, m_refine: int, stream: int,
                  dtype, path_offset, payoff_on: str):
    """Per-path ``(Y_l, P_l)`` of ``n_paths`` paths from ``path_offset``."""
    n_fine = n0_steps * m_refine ** level
    fine = make_process(n_fine)
    if level == 0 and dtype == torch.float32:
        y = _level0_values(fine, payoff_fn, n_paths, n_fine, seed, stream,
                           path_offset, payoff_on)
        return y, y
    if level == 0:
        return _coupled_values(fine, None, payoff_fn, n_paths, n_fine, 1,
                               seed, stream, dtype, path_offset, payoff_on)
    coarse = make_process(n_fine // m_refine)
    return _coupled_values(fine, coarse, payoff_fn, n_paths,
                           n_fine // m_refine, m_refine, seed, stream, dtype,
                           path_offset, payoff_on)


def _check_level(make_process, n0_steps, m_refine, level, payoff_on):
    if payoff_on not in ("terminal", "mean"):
        raise ValueError(f"unknown payoff_on={payoff_on!r}")
    fine = make_process(n0_steps * m_refine ** level)
    if not isinstance(fine, NormalDrawsMixin):
        raise TypeError(
            "MLMC coupling needs Gaussian innovations (NormalDrawsMixin); "
            f"{type(fine).__name__} draws do not telescope across grids")


def mlmc_level_moments(make_process: Callable[[int], object], payoff_fn,
                       level: int, n_paths: int, *, seed: int = 0,
                       n0_steps: int = 1, m_refine: int = 2,
                       stream_base: int = 0, dtype=torch.float32,
                       path_offset: int = 0, payoff_on: str = "terminal",
                       mesh=None):
    """(moments of Y_l, moments of P_l) for one MLMC level.

    ``make_process(n_steps)`` returns the process discretized with ``dt =
    T / n_steps``; the ladder builds the fine/coarse pairs from it.
    ``payoff_on``: "terminal" or "mean" (the Asian telescope).  With
    ``mesh`` the level's paths are sharded over its paths axis, bitwise
    the level without it."""
    return _chunk_moments(make_process, payoff_fn, level, n_paths, 1, seed,
                          n0_steps, m_refine, stream_base, dtype,
                          path_offset, payoff_on, mesh)[0]


def _chunk_moments(make_process, payoff_fn, level: int, chunk: int,
                   n_chunks: int, seed: int, n0_steps: int, m_refine: int,
                   stream_base: int, dtype, path_offset, payoff_on: str,
                   mesh):
    """The (Y, P) moment states of ``n_chunks`` consecutive chunks of
    ``chunk`` paths from ``path_offset``, simulated as one run of
    ``n_chunks * chunk`` paths.  Each chunk's states are bitwise those of
    its own ``mlmc_level_moments`` call: a path's values depend on its id
    alone, a block's state on its own paths, and each chunk's blocks merge
    by the same tree."""
    _check_level(make_process, n0_steps, m_refine, level, payoff_on)
    n_paths = n_chunks * chunk
    stream = stream_base + level
    if mesh is None:
        y, p = _level_values(make_process, payoff_fn, level, n_paths, seed,
                             n0_steps, m_refine, stream, dtype, path_offset,
                             payoff_on)
        if chunk % BLOCK:
            return [(moments_from_array(y[i * chunk:(i + 1) * chunk]),
                     moments_from_array(p[i * chunk:(i + 1) * chunk]))
                    for i in range(n_chunks)]
        from montecarlo_tpu_torch.parallel.sharded import block_moments

        blocks = [block_moments(v, BLOCK) for v in (y, p)]
    else:
        blocks = _sharded_block_states(make_process, payoff_fn, level,
                                       n_paths, seed, n0_steps, m_refine,
                                       stream, dtype, path_offset, payoff_on,
                                       mesh)
        if blocks[0].count.shape[0] != n_paths // BLOCK:
            # A sliced mesh gathers one state per slice: one chunk a run.
            assert n_chunks == 1
            return [tuple(moments_reduce(b) for b in blocks)]
    # The chunks' block trees side by side: (blocks a chunk, n_chunks).
    per = [moments_reduce(MomentState(*(v.reshape(n_chunks, -1).T
                                        for v in b))) for b in blocks]
    return [tuple(MomentState(*(v[i] for v in st)) for st in per)
            for i in range(n_chunks)]


def _sharded_block_states(make_process, payoff_fn, level: int,
                          n_paths: int, seed: int, n0_steps: int,
                          m_refine: int, stream: int, dtype, path_offset,
                          payoff_on: str, mesh):
    """One level over a mesh: each rank takes a contiguous run of global
    path ids and reduces its values to 4096-path block states; the block
    states of Y and P are gathered in global order on every rank
    (``parallel.sharded``'s contract; one state a slice on a sliced
    mesh)."""
    from montecarlo_tpu_torch.parallel.mesh import PATHS_AXIS
    from montecarlo_tpu_torch.parallel.sharded import (_check_device,
                                                       _gather_two_level,
                                                       _layout,
                                                       _shard_offset,
                                                       block_moments)

    _check_device(make_process(n0_steps).device, mesh)
    local_n, has_slices = _layout(mesh, n_paths, BLOCK, PATHS_AXIS)
    y, p = _level_values(make_process, payoff_fn, level, local_n, seed,
                         n0_steps, m_refine, stream, dtype,
                         _shard_offset(mesh, PATHS_AXIS, local_n,
                                       path_offset), payoff_on)
    return [_gather_two_level(block_moments(v, BLOCK), mesh, PATHS_AXIS,
                              has_slices) for v in (y, p)]


class MLMCLevel(NamedTuple):
    n_paths: int
    mean: float
    var: float
    cost: float  # fine-equivalent path-steps per path


def _fit_alpha(means, m_refine):
    """Weak-error rate: regress log_M |mean_l| on l (levels >= 1)."""
    ls, ys = [], []
    for l, m in enumerate(means):
        if l >= 1 and abs(m) > 0:
            ls.append(float(l))
            ys.append(math.log(abs(m), m_refine))
    if len(ls) < 2:
        return 1.0
    n = len(ls)
    sx, sy = sum(ls), sum(ys)
    sxx = sum(x * x for x in ls)
    sxy = sum(x * y for x, y in zip(ls, ys))
    denom = n * sxx - sx * sx
    if denom <= 0:
        return 1.0
    return max(0.5, -(n * sxy - sx * sy) / denom)


def _var(state: MomentState) -> float:
    return max(float(variance(state, ddof=1)), 0.0)


def mlmc_estimate(make_process: Callable[[int], object], payoff_fn, *,
                  target_rmse: float, seed: int = 0, n0_steps: int = 1,
                  m_refine: int = 2, min_levels: int = 3,
                  max_levels: int = 12, n_warmup: int = 4096,
                  chunk_paths: int = 1 << 16, discount=1.0,
                  dtype=torch.float32, payoff_on: str = "terminal",
                  mesh=None) -> dict:
    """Adaptive MLMC (the Giles 2008 algorithm): E[payoff] to RMSE
    ``target_rmse``, half of eps^2 to the variance and half to the bias.

    Each level samples in chunks of ``max(chunk_paths >> l, 2048)`` paths
    (rounded up to ranks x 4096 over a mesh), each chunk extending the
    level's path ids and merged in turn into the level's moments, as the
    JAX package does; the chunks a target needs are simulated together,
    up to ``RUN_PATHS`` paths a run (one chunk a run on a sliced mesh),
    which changes no bit of the result.  Returns ``{"price", "std_err", "bias_est",
    "rmse_est", "n_levels", "levels": [MLMCLevel...], "alpha",
    "cost_path_steps", "single_level_cost_est"}`` as the JAX package
    does."""
    eps = float(target_rmse)
    if eps <= 0:
        raise ValueError("target_rmse must be positive")
    var_budget = 0.5 * eps * eps
    bias_budget = eps / math.sqrt(2.0)

    states: list = []
    sampled: list = []

    def level_cost(l):
        nf = n0_steps * m_refine ** l
        return float(nf if l == 0 else nf + nf // m_refine)

    def ensure(l, n_target):
        chunk = max(chunk_paths >> l, 2048)
        per_run = max(RUN_PATHS // chunk, 1)
        if mesh is not None:
            from montecarlo_tpu_torch.parallel.mesh import PATHS_AXIS
            from montecarlo_tpu_torch.parallel.sharded import _slice_layout

            q = _slice_layout(mesh, PATHS_AXIS)[2] * BLOCK
            chunk = ((chunk + q - 1) // q) * q
            if _slice_layout(mesh, PATHS_AXIS)[0] > 1:
                per_run = 1
        while sampled[l] < n_target:
            n_chunks = min(-(-(n_target - sampled[l]) // chunk), per_run)
            for st_y, _ in _chunk_moments(
                    make_process, payoff_fn, l, chunk, n_chunks, seed,
                    n0_steps, m_refine, 0, dtype, sampled[l], payoff_on,
                    mesh):
                states[l] = (st_y if sampled[l] == 0
                             else moments_merge(states[l], st_y))
                sampled[l] += chunk

    def add_level():
        states.append(None)
        sampled.append(0)
        ensure(len(states) - 1, n_warmup)

    for _ in range(min_levels):
        add_level()

    while True:
        vars_ = [_var(s) for s in states]
        costs = [level_cost(l) for l in range(len(states))]
        # Giles' optimal allocation for the variance half of the budget.
        lam = sum(math.sqrt(v * c) for v, c in zip(vars_, costs))
        for l, (v, c) in enumerate(zip(vars_, costs)):
            n_opt = (int(math.ceil(math.sqrt(v / c) * lam / var_budget))
                     if v > 0 else n_warmup)
            ensure(l, n_opt)

        means = [float(s.mean) for s in states]
        alpha = _fit_alpha(means, m_refine)
        gain = m_refine ** alpha - 1.0
        tail = [abs(means[-1]),
                abs(means[-2]) / m_refine ** alpha if len(means) > 1
                else 0.0]
        bias = max(tail) / gain
        if bias <= bias_budget or len(states) >= max_levels:
            break
        add_level()

    st_sum = 0.0
    var_sum = 0.0
    for s in states:
        st_sum += float(s.mean)
        var_sum += _var(s) / float(s.count)
    d = float(discount)
    cost = sum(level_cost(l) * sampled[l] for l in range(len(states)))
    # Single-level MC at the finest grid for the same RMSE: Var[P] /
    # var_budget paths of n_fine steps each (no coarse companion).
    v0 = max(float(variance(states[0], ddof=1)), 1e-30)
    single_cost = (v0 / var_budget) * float(
        n0_steps * m_refine ** (len(states) - 1))
    return {
        "price": d * st_sum,
        "std_err": d * math.sqrt(var_sum),
        "bias_est": d * bias,
        "rmse_est": d * math.sqrt(var_sum + bias * bias),
        "n_levels": len(states),
        "levels": [MLMCLevel(n_paths=sampled[l], mean=float(s.mean),
                             var=_var(s), cost=level_cost(l))
                   for l, s in enumerate(states)],
        "alpha": alpha,
        "cost_path_steps": cost,
        "single_level_cost_est": single_cost,
    }


__all__ = ["mlmc_estimate", "mlmc_level_moments", "MLMCLevel"]
