"""Streaming estimation with checkpoint and resume.

The port of ``montecarlo_tpu/engine/streaming.py``'s estimator
(``StreamingState``, ``streaming_estimate``, ``risk_from_state``,
``risk_dict``).  A run of any path count goes in fixed-size chunks and
keeps O(blocks + bins) state on the host:

- per-block moment states (``block_size`` consecutive global paths, the
  sharded estimators' ``block_moments``), kept and not merged, so the final
  fixed-tree reduce is the same bits whether the run went in one shot, in
  chunks, across resumes or over a mesh;
- a histogram sketch of the terminal values, binned and merged on the host
  in float64 numpy as in the JAX package (exact count adds to 2^53);
- no RNG state: draws are keyed by global path id, so a resumed run
  regenerates exactly the paths it would have had, and a lost chunk is
  replayed from its path-id range alone.

Checkpoints: a ``.npz`` path takes JAX's keys (a checkpoint written by the
JAX package loads here); any other path takes ``torch.save`` of the same
fields (the counterpart of the JAX package's orbax directory).  Both are
written to a temporary file and renamed over the target.

:meth:`StreamingState.moments` reduces the float64 block arrays in
float64; the JAX package reduces them in its default float width (float64
with x64 on, float32 in its CLI).
"""

from __future__ import annotations

import os
import tempfile
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from montecarlo_tpu_torch.engine.dispatch import terminal_prices
from montecarlo_tpu_torch.parallel.sharded import (DEFAULT_BLOCK,
                                                   block_moments,
                                                   sharded_terminal)
from montecarlo_tpu_torch.stats.quantiles import (HistogramSketch,
                                                  sketch_cdf, sketch_quantile,
                                                  sketch_quantile_std_err,
                                                  sketch_tail_mean_below)
from montecarlo_tpu_torch.stats.welford import (MomentState, moments_reduce,
                                                std_error)

_SCALARS = ("seed", "n_steps", "block_size", "paths_done")
_BLOCKS = ("block_count", "block_mean", "block_m2")


def _atomic_write(path: str, write) -> None:
    """``write(file)`` into a temporary file beside ``path``, then rename it
    over ``path`` (mkstemp: the name exists from creation, so concurrent
    writers cannot collide on it)."""
    fd, tmp = tempfile.mkstemp(suffix=os.path.splitext(path)[1] or ".tmp",
                               dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as fh:
            write(fh)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclass
class StreamingState:
    """Host-side accumulated state: numpy float64 block arrays and a
    sketch whose leaves are numpy float64."""

    seed: int
    n_steps: int
    block_size: int
    paths_done: int
    block_count: np.ndarray   # (n_blocks,)
    block_mean: np.ndarray
    block_m2: np.ndarray
    sketch: HistogramSketch   # numpy-leaved

    def save(self, path: str) -> None:
        """Checkpoint to ``path``: ``.npz`` with the JAX package's keys, or
        ``torch.save`` of the same fields for any other path."""
        fields = {k: getattr(self, k) for k in _SCALARS + _BLOCKS}
        sk = {f"sk_{k}": np.asarray(v)
              for k, v in self.sketch._asdict().items()}
        if path.endswith(".npz"):
            _atomic_write(path, lambda fh: np.savez(fh, **fields, **sk))
            return
        tree = {k: (v if k in _SCALARS else torch.from_numpy(np.asarray(v)))
                for k, v in {**fields, **sk}.items()}
        _atomic_write(path, lambda fh: torch.save(tree, fh))

    @classmethod
    def load(cls, path: str) -> "StreamingState":
        if path.endswith(".npz"):
            with np.load(path) as z:
                t = {k: z[k] for k in z.files}
        else:
            t = {k: (v if isinstance(v, int) else v.numpy())
                 for k, v in torch.load(path, weights_only=True).items()}
        return cls(**{k: int(t[k]) for k in _SCALARS},
                   **{k: np.asarray(t[k]) for k in _BLOCKS},
                   sketch=HistogramSketch(**{
                       k: np.asarray(t[f"sk_{k}"])
                       for k in HistogramSketch._fields}))

    def moments(self) -> MomentState:
        """The fixed-tree reduce of the block states, in float64."""
        return moments_reduce(MomentState(*(
            torch.from_numpy(np.asarray(getattr(self, k), np.float64))
            for k in _BLOCKS)))


def _empty_state(seed, n_steps, block_size, lo, hi, bins) -> StreamingState:
    z64 = np.float64(0.0)
    return StreamingState(
        seed=seed, n_steps=n_steps, block_size=block_size, paths_done=0,
        block_count=np.zeros((0,)), block_mean=np.zeros((0,)),
        block_m2=np.zeros((0,)),
        sketch=HistogramSketch(
            lo=np.float64(lo), hi=np.float64(hi),
            counts=np.zeros((bins,), np.float64), total=z64,
            underflow=z64, overflow=z64,
            vmin=np.float64(np.inf), vmax=np.float64(-np.inf)))


def _resumed(checkpoint_path, seed, n_steps, block_size, lo, hi, bins,
             chunk_paths) -> StreamingState:
    state = StreamingState.load(checkpoint_path)
    if (state.seed, state.n_steps, state.block_size) != (
            seed, n_steps, block_size):
        raise ValueError("checkpoint does not match this run's config")
    if (state.sketch.counts.shape[0] != bins
            or float(state.sketch.lo) != float(lo)
            or float(state.sketch.hi) != float(hi)):
        raise ValueError(
            "checkpoint sketch grid (lo/hi/bins) does not match this run — "
            "merged quantiles would be silently wrong")
    if state.paths_done % chunk_paths:
        raise ValueError(
            f"resumed paths_done={state.paths_done} is not a multiple of "
            f"chunk_paths={chunk_paths}; resume with the original chunk "
            "size (or a divisor of paths_done)")
    return state


def _absorb(state: StreamingState, terminal: torch.Tensor, payoffs,
            lo: float, hi: float, bins: int) -> None:
    """Append the chunk's block states and bin its terminals into the
    sketch on the host in float64, as the JAX package does."""
    blocks = block_moments(payoffs, state.block_size)
    for k, v in zip(_BLOCKS, blocks):
        setattr(state, k, np.concatenate(
            [getattr(state, k), v.cpu().numpy().astype(np.float64)]))
    term64 = terminal.cpu().numpy().astype(np.float64).reshape(-1)
    width = (np.float64(hi) - np.float64(lo)) / bins
    idx = np.floor((term64 - np.float64(lo)) / width).astype(np.int64)
    under = int(np.sum(idx < 0))
    over = int(np.sum(idx >= bins))
    cnts = np.bincount(idx[(idx >= 0) & (idx < bins)],
                       minlength=bins).astype(np.float64)
    s = state.sketch
    state.sketch = HistogramSketch(
        lo=s.lo, hi=s.hi, counts=s.counts + cnts,
        total=s.total + np.float64(term64.size),
        underflow=s.underflow + np.float64(under),
        overflow=s.overflow + np.float64(over),
        vmin=np.minimum(s.vmin, term64.min()),
        vmax=np.maximum(s.vmax, term64.max()))


def streaming_estimate(
    process, total_paths: int, n_steps: int, *, seed: int,
    payoff_fn: Optional[Callable] = None, chunk_paths: int = 1 << 20,
    block_size: int = DEFAULT_BLOCK, lo: float = 0.0, hi: float = 1000.0,
    bins: int = 4096, sampler=None, checkpoint_path: Optional[str] = None,
    resume: bool = True, checkpoint_every: int = 1,
    target_std_err: Optional[float] = None, mesh=None,
    progress_callback=None,
) -> StreamingState:
    """Estimate over ``total_paths`` in chunks of ``chunk_paths``,
    checkpointing every ``checkpoint_every`` chunks and at the end.

    Chunk ``i`` simulates global paths ``[i, i + 1) * chunk_paths`` (K2, or
    the torch loop, through ``engine.dispatch``; with ``mesh``, every rank
    simulates its shard and gathers the chunk's terminals before the block
    moments, so every rank holds the same state).  ``payoff_fn`` feeds the
    moments (the terminal value itself by default); the sketch always takes
    terminal values.  ``resume`` picks up ``checkpoint_path`` when it
    exists, after checking its config, grid and chunk alignment.  Stops at
    a chunk boundary once the std-err reaches ``target_std_err``.
    ``progress_callback(paths_done, total_paths, std_err)`` runs after each
    chunk (and its checkpoint)."""
    if total_paths % chunk_paths or chunk_paths % block_size:
        raise ValueError("total_paths % chunk_paths % block_size != 0")
    payoff_fn = payoff_fn or (lambda s: s)
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        state = _resumed(checkpoint_path, seed, n_steps, block_size, lo, hi,
                         bins, chunk_paths)
    else:
        state = _empty_state(seed, n_steps, block_size, lo, hi, bins)

    chunk_idx = state.paths_done // chunk_paths
    while state.paths_done < total_paths:
        offset = state.paths_done
        if mesh is not None:
            terminal = sharded_terminal(process, chunk_paths, n_steps,
                                        seed=seed, mesh=mesh,
                                        sampler=sampler, path_offset=offset)
        else:
            terminal = terminal_prices(process, chunk_paths, n_steps,
                                       seed=seed, sampler=sampler,
                                       path_offset=offset)
        _absorb(state, terminal, payoff_fn(terminal), lo, hi, bins)
        state.paths_done += chunk_paths
        chunk_idx += 1

        if checkpoint_path and chunk_idx % checkpoint_every == 0:
            state.save(checkpoint_path)
        se = float(std_error(state.moments()))
        if progress_callback:
            progress_callback(state.paths_done, total_paths, se)
        if target_std_err is not None and se <= target_std_err:
            break

    if checkpoint_path:
        state.save(checkpoint_path)
    return state


def risk_from_state(state: StreamingState, current_price: float, *,
                    moments_are_prices: bool = True) -> dict:
    """The reference's risk statistics (app.py:647-657) from streamed
    state: sketch quantiles (error at most one bin width) instead of an
    exact sort, in float64.

    The sketch holds terminal prices; the moments hold whatever
    ``payoff_fn`` the stream ran.  With ``moments_are_prices=False`` the
    price mean and std come from the sketch's bin midpoints, and the payoff
    moments are reported as ``payoff_mean``/``payoff_std_err``."""
    m = state.moments()
    sk = HistogramSketch(*(torch.as_tensor(np.asarray(v, np.float64))
                           for v in state.sketch))
    if moments_are_prices:
        mean = float(m.mean)
        std = float(torch.sqrt(m.m2 / torch.clamp(m.count, min=1.0)))
    else:
        bins = sk.counts.shape[0]
        width = (sk.hi - sk.lo) / bins
        mids = sk.lo + (torch.arange(bins, dtype=torch.float64) + 0.5) \
            * width
        w = sk.counts
        tot = torch.clamp(w.sum(), min=1.0)
        mean = float((w * mids).sum() / tot)
        std = float(torch.sqrt(torch.clamp(
            (w * torch.square(mids - mean)).sum() / tot, min=0.0)))
    out = risk_dict(sk, mean=mean, std=std, std_err=float(std_error(m)),
                    count=int(float(m.count)), current_price=current_price)
    if not moments_are_prices:
        out["payoff_mean"] = float(m.mean)
        out["payoff_std_err"] = float(std_error(m))
    return out


def risk_dict(sk: HistogramSketch, *, mean: float, std: float,
              std_err: float, count: int, current_price: float) -> dict:
    """The reference risk keys (app.py:647-657) from a sketch plus price
    moments, with each estimate's two error sources: ``var_95_std_err``
    (sampling) and ``var_95_grid_err`` / ``cvar_95_grid_err`` (the grid,
    one bin width; CVaR adds the bin-midpoint half width), in percent of
    spot.  Warns when the grid error dominates: more paths stop helping,
    more bins do."""
    s0 = float(current_price)
    p = {f"p{q}": float(sketch_quantile(sk, float(q)))
         for q in (1, 5, 10, 25, 50, 75, 90, 95, 99)}
    tail_mean = float(sketch_tail_mean_below(sk, p["p5"]))
    bins = sk.counts.shape[0]
    width = float(sk.hi - sk.lo) / bins
    var_grid_err = width / s0 * 100.0
    cvar_grid_err = 1.5 * width / s0 * 100.0
    var_std_err = float(sketch_quantile_std_err(sk, 5.0)) / s0 * 100.0
    if var_std_err < var_grid_err:
        warnings.warn(
            f"VaR sampling std-err ({var_std_err:.3g}% of spot) is below "
            f"the sketch's deterministic grid resolution "
            f"({var_grid_err:.3g}% = one bin width): the estimate is "
            "grid-limited — increase bins (or narrow the lo/hi range) "
            "rather than adding paths", stacklevel=3)
    return {
        "percentiles": p,
        "expected_return": (mean / s0 - 1.0) * 100.0,
        "expected_vol": std / s0 * 100.0,
        "prob_profit": 100.0 * (1.0 - float(sketch_cdf(sk, s0))),
        "var_95": (s0 - p["p5"]) / s0 * 100.0,
        "var_95_std_err": var_std_err,
        "var_95_grid_err": var_grid_err,
        "cvar_95": (s0 - tail_mean) / s0 * 100.0,
        "cvar_95_grid_err": cvar_grid_err,
        "std_err": std_err,
        "n_paths": count,
        # Fraction of samples outside the grid: > 0 means the tail
        # quantiles and CVaR approximate that mass at the grid edge.
        "sketch_oob_fraction":
            (float(sk.underflow) + float(sk.overflow))
            / max(float(sk.total), 1.0),
    }
