"""Portfolio VaR/CVaR at any path count (BASELINE.json config 5).

The port of ``montecarlo_tpu/api/var.py``: ``portfolio_var`` (one sharded
sketch pass over a mesh, or the checkpointed stream of
``engine.streaming``) and ``portfolio_var_on_device`` (a host loop of K2
chunks whose histogram sketch and Chan-merged moments never leave the
card), with the range helpers.  Memory is O(bins) at any path count; the
sketch range is calibrated by a small pilot run.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from montecarlo_tpu_torch.engine.dispatch import terminal_prices
from montecarlo_tpu_torch.engine.streaming import (risk_dict,
                                                   risk_from_state,
                                                   streaming_estimate)
from montecarlo_tpu_torch.parallel.sharded import sharded_terminal_sketch
from montecarlo_tpu_torch.stats.quantiles import (HistogramSketch, bin_index,
                                                  histogram_counts)
from montecarlo_tpu_torch.stats.welford import std_error

#: Out-of-range fraction above which the auto-ranged sketch re-runs on a
#: widened grid: a 4096-path pilot cannot see deep tails, and CVaR would
#: approximate that mass at the grid edge.
_OOB_RERANGE_THRESHOLD = 1e-6


def _pilot_range(process, n_steps: int, seed: int, margin: float = 0.5):
    # The JAX package's pilot (its scan engine's 4096 paths on stream 999)
    # through the dispatch gate: K2 where it takes the process, the same
    # bits as the torch loop, one launch where the loop takes hundreds a
    # step.
    pilot = terminal_prices(process, 4096, n_steps, seed=seed, stream=999)
    lo, hi = float(pilot.min()), float(pilot.max())
    span = hi - lo
    return lo - margin * span, hi + margin * span


def _oob_fraction(sketch) -> float:
    total = max(float(sketch.total), 1.0)
    return (float(sketch.underflow) + float(sketch.overflow)) / total


def _widened_range(lo, hi, vmin, vmax):
    """A grid covering every observed value: the exact global min/max, so
    one re-run is in range (counter-based draws repeat bit for bit)."""
    new_lo = min(float(lo), float(vmin))
    new_hi = max(float(hi), float(vmax))
    eps = 1e-3 * max(new_hi - new_lo, 1e-12)
    return new_lo - eps, new_hi + eps


def _warn_oob(sketch, context: str) -> None:
    frac = _oob_fraction(sketch)
    if frac > _OOB_RERANGE_THRESHOLD:
        warnings.warn(
            f"{context}: {frac:.2e} of terminal values fell outside the "
            f"explicit sketch range [{float(sketch.lo)}, "
            f"{float(sketch.hi)}] (observed range "
            f"[{float(sketch.vmin)}, {float(sketch.vmax)}]); tail "
            "quantiles/CVaR are approximated at the grid edge — widen "
            "lo/hi or let the range auto-calibrate",
            stacklevel=3)


def portfolio_var(process, n_paths: int, n_days: int, current_value: float,
                  *, seed: int = 0, sampler=None, mesh=None,
                  bins: int = 8192, lo: Optional[float] = None,
                  hi: Optional[float] = None,
                  chunk_paths: Optional[int] = None, block_size: int = 4096,
                  checkpoint_path: Optional[str] = None,
                  progress_callback=None) -> dict:
    """VaR/CVaR and percentile bands of ``n_paths`` terminal values.

    - With ``mesh`` and no ``chunk_paths``: one sharded pass,
      ``parallel.sharded.sharded_terminal_sketch`` (integer bin counts
      summed by the collective, block moments gathered and merged by the
      fixed tree), on every rank.
    - Otherwise ``engine.streaming.streaming_estimate`` in chunks of
      ``chunk_paths`` (at most 2^20 by default), over ``mesh`` when given,
      with ``checkpoint_path`` resumable and ``progress_callback``.

    An auto-ranged grid (no ``lo``/``hi``) that lost more than 1e-6 of the
    values off its edges runs once more on the exact observed range,
    except in a checkpointed run: its checkpoint holds the grid, and a
    second grid would not resume.  Returns the reference's risk keys
    (app.py:647-657) with their error bars, ``std_err`` and ``n_paths``.
    """
    auto_ranged = lo is None and hi is None
    if lo is None or hi is None:
        auto_lo, auto_hi = _pilot_range(process, n_days, seed)
        lo = auto_lo if lo is None else lo
        hi = auto_hi if hi is None else hi

    if mesh is not None and chunk_paths is None:
        for _ in range(2):
            sketch, moments = sharded_terminal_sketch(
                process, n_paths, n_days, seed=seed, mesh=mesh, lo=lo,
                hi=hi, bins=bins, block_size=block_size, sampler=sampler)
            if (auto_ranged
                    and _oob_fraction(sketch) > _OOB_RERANGE_THRESHOLD):
                lo, hi = _widened_range(lo, hi, sketch.vmin, sketch.vmax)
                continue
            break
        if not auto_ranged:
            _warn_oob(sketch, "portfolio_var")
        std = float(torch.sqrt(moments.m2
                               / torch.clamp(moments.count, min=1.0)))
        return risk_dict(sketch, mean=float(moments.mean), std=std,
                         std_err=float(std_error(moments)),
                         count=int(float(moments.count)),
                         current_price=current_value)

    chunk = chunk_paths or min(n_paths, 1 << 20)
    for _ in range(2):
        state = streaming_estimate(
            process, n_paths, n_days, seed=seed, chunk_paths=chunk,
            block_size=block_size, lo=lo, hi=hi, bins=bins, mesh=mesh,
            sampler=sampler, checkpoint_path=checkpoint_path,
            progress_callback=progress_callback)
        if (auto_ranged and checkpoint_path is None
                and _oob_fraction(state.sketch) > _OOB_RERANGE_THRESHOLD):
            lo, hi = _widened_range(lo, hi, state.sketch.vmin,
                                    state.sketch.vmax)
            continue
        break
    if not (auto_ranged and checkpoint_path is None):
        _warn_oob(state.sketch, "portfolio_var")
    return risk_from_state(state, current_value)


def _sketch_chunks(process, n_chunks: int, chunk_paths: int, n_days: int,
                   seed: int, sampler, bins: int, lo: float, hi: float):
    """One K2 launch per chunk, then floor, mask and ``bincount`` on the
    card; int32 counts and float32 moments (Chan merge, the JAX package's
    order) stay there until the caller reads them."""
    dev = process.device
    f32 = dict(dtype=torch.float32, device=dev)
    lo_t, hi_t = torch.tensor(lo, **f32), torch.tensor(hi, **f32)
    width = (hi_t - lo_t) / bins
    counts = torch.zeros(bins, dtype=torch.int32, device=dev)
    uf = torch.zeros((), dtype=torch.int32, device=dev)
    of = torch.zeros((), dtype=torch.int32, device=dev)
    vmin, vmax = torch.tensor(np.inf, **f32), torch.tensor(-np.inf, **f32)
    total, mean, m2 = (torch.zeros((), **f32) for _ in range(3))
    c_n = torch.tensor(float(chunk_paths), **f32)
    for i in range(n_chunks):
        term = terminal_prices(process, chunk_paths, n_days, seed=seed,
                               sampler=sampler, path_offset=i * chunk_paths)
        # Out-of-range terminals are COUNTED, never clipped into the edge
        # bins (that would place tail mass at the edge-bin midpoint).
        idx, under, over = bin_index(term, lo_t, width, bins)
        batch = histogram_counts(idx, bins)
        batch[0] -= (under | over).sum(dtype=torch.int32)
        counts += batch
        uf += under.sum(dtype=torch.int32)
        of += over.sum(dtype=torch.int32)
        vmin = torch.minimum(vmin, term.min())
        vmax = torch.maximum(vmax, term.max())
        c_mean = term.mean()
        c_m2 = torch.square(term - c_mean).sum()
        n_new = total + c_n
        delta = c_mean - mean
        mean = mean + delta * c_n / n_new
        m2 = m2 + c_m2 + torch.square(delta) * total * c_n / n_new
        total = n_new
    return counts, uf, of, vmin, vmax, total, mean, m2


def portfolio_var_on_device(process, n_paths: int, n_days: int,
                            current_value: float, *, seed: int = 0,
                            sampler=None, bins: int = 8192,
                            lo: Optional[float] = None,
                            hi: Optional[float] = None,
                            chunk_paths: int = 1 << 24) -> dict:
    """VaR/CVaR and percentile bands of ``n_paths`` terminal values on the
    process's device: a host loop of K2 chunks whose sketch and moments
    stay on the card, one host read after the last chunk, and at most one
    re-run on a widened grid when an auto-ranged sketch lost more than
    1e-6 of the values off its edges.  No checkpointing.

    Returns the reference's risk keys (app.py:647-657) with their error
    bars, ``std_err`` and ``n_paths`` (``engine.streaming.risk_dict``).
    """
    if n_paths % chunk_paths:
        raise ValueError("n_paths must be a multiple of chunk_paths")
    auto_ranged = lo is None and hi is None
    if lo is None or hi is None:
        auto_lo, auto_hi = _pilot_range(process, n_days, seed)
        lo = auto_lo if lo is None else lo
        hi = auto_hi if hi is None else hi
    n_chunks = n_paths // chunk_paths

    for _ in range(2):
        counts, uf, of, vmin, vmax, total, mean, m2 = _sketch_chunks(
            process, n_chunks, chunk_paths, n_days, seed, sampler, bins,
            float(lo), float(hi))
        # The one host read of a pass.
        uf_f, of_f, vmin_f, vmax_f, total_f, mean_f, m2_f = torch.stack(
            [uf.to(torch.float64), of.to(torch.float64)]
            + [v.to(torch.float64) for v in (vmin, vmax, total, mean, m2)]
        ).tolist()
        oob = (uf_f + of_f) / max(total_f, 1.0)
        if auto_ranged and oob > _OOB_RERANGE_THRESHOLD:
            lo, hi = _widened_range(lo, hi, vmin_f, vmax_f)
            continue
        break

    as_ = lambda v: torch.tensor(v, dtype=torch.float32)
    sketch = HistogramSketch(
        lo=as_(float(lo)), hi=as_(float(hi)),
        counts=counts.cpu().to(torch.float32), total=as_(total_f),
        underflow=as_(uf_f), overflow=as_(of_f), vmin=as_(vmin_f),
        vmax=as_(vmax_f))
    if not auto_ranged:
        _warn_oob(sketch, "portfolio_var_on_device")
    std = float(np.sqrt(m2_f / max(total_f, 1.0)))
    return risk_dict(sketch, mean=mean_f, std=std,
                     std_err=std / np.sqrt(max(total_f, 1.0)),
                     count=int(total_f), current_price=current_value)
