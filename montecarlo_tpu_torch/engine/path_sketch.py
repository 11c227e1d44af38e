"""Per-step percentile curves from histograms — O(T x bins) memory at any
path count.

The port of ``montecarlo_tpu/engine/path_sketch.py``: ``path_histograms``
and ``percentiles_from_histograms``; ``sharded_path_percentiles`` lives
with the other sharded estimators in ``parallel.sharded`` and is
re-exported here, JAX's import path.  The reference's chart needs per-step
percentile bands (reference app.py:643-645), which it gets from the whole
``(n_days + 1, n_sims)`` path array; here every step's prices go into a
histogram and are dropped.  The JAX package runs this loop as a scan
outside any Pallas kernel, so the port runs it as a torch time loop: per
step one draw, one step, one ``prices`` and one ``bincount``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from montecarlo_tpu_torch.engine.simulate import check_sampler, path_ids_for
from montecarlo_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_path_percentiles)
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from montecarlo_tpu_torch.samplers import PlainSampler
from montecarlo_tpu_torch.stats.quantiles import histogram_counts
from montecarlo_tpu_torch.stats.risk import PATH_PERCENTILES


def path_histograms(process, n_paths: int, n_steps: int, *, seed: int,
                    lo: float, hi: float, bins: int = 1024, stream: int = 0,
                    sampler=None, path_offset=0) -> torch.Tensor:
    """(n_steps + 1, bins) int32 counts of the prices at every step, on
    the process's device; row 0 is the spot.  Values outside [lo, hi)
    clamp into the edge bins (percentiles inside the range are
    unaffected), as in the JAX package."""
    sampler = PlainSampler() if sampler is None else sampler
    check_sampler(sampler, process, n_steps)
    dev = process.device
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, dev)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=dev)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=dev)
    width = (hi_t - lo_t) / bins

    def hist(prices):
        raw = torch.clamp(torch.floor((prices - lo_t) / width), 0.0,
                          float(bins - 1))
        return histogram_counts(raw.to(torch.int32), bins)

    state = process.init_state(ids)
    rows = [hist(process.prices(state))]
    for t in range(n_steps):
        state = process.step(state, sampler.draws(process, k0, k1, ids, t),
                             t)
        rows.append(hist(process.prices(state)))
    return torch.stack(rows)


def percentiles_from_histograms(hists, lo: float, hi: float,
                                levels=PATH_PERCENTILES
                                ) -> Dict[str, np.ndarray]:
    """Per-step percentile curves from (T+1, bins) counts — the
    reference's ``path_percentiles`` dict shape (app.py:643-645), within
    one bin width.  Host numpy, as in the JAX package."""
    hists = np.asarray(hists)
    t_plus_1, bins = hists.shape
    width = (hi - lo) / bins
    cdf = np.cumsum(hists, axis=1)
    total = cdf[:, -1:]
    out = {}
    for q in levels:
        target = (q / 100.0) * total[:, 0]
        k = np.minimum(np.argmax(cdf >= target[:, None], axis=1), bins - 1)
        cdf_left = np.where(k > 0, cdf[np.arange(t_plus_1),
                                       np.maximum(k - 1, 0)], 0.0)
        in_bin = np.maximum(hists[np.arange(t_plus_1), k], 1e-12)
        frac = np.clip((target - cdf_left) / in_bin, 0.0, 1.0)
        out[f"p{q}"] = lo + (k + frac) * width
    return out

