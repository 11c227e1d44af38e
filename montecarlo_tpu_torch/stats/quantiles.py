"""Quantiles: exact (NumPy-`linear` compatible) and a mergeable histogram
sketch.

The port of ``montecarlo_tpu/stats/quantiles.py``:

- **Exact** — :func:`percentile_linear` sorts the sample and takes numpy's
  default ``linear`` interpolation (``torch.quantile`` refuses inputs above
  2^24 elements, which ``terminal_statistics`` reaches at 2^24 paths).
- **Sketch** — a fixed-grid histogram over a data-driven range whose counts
  are int32 adds, so merges are exact.  Quantile error is bounded by one
  bin width.  Out-of-range values are counted in under/overflow, never
  clipped into the edge bins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def percentile_linear(x: torch.Tensor, q, dim=None) -> torch.Tensor:
    """``np.percentile(x, q, axis=dim)`` with the default linear
    interpolation: a sort along ``dim`` (all of ``x`` when None), the
    positions ``q/100 * (n - 1)`` taken in float64 on the host, and numpy's
    lerp of the two neighbours in ``x``'s dtype.  Percentiles lead the
    output's shape, as in numpy."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    pos = np.asarray(q, np.float64).reshape(-1) / 100.0 * (n - 1)
    below = np.floor(pos).astype(np.int64)
    above = np.minimum(below + 1, n - 1)
    srt = torch.sort(x, dim=-1).values
    lo = srt[..., torch.from_numpy(below).to(x.device)]
    hi = srt[..., torch.from_numpy(above).to(x.device)]
    t = torch.as_tensor(pos - below, dtype=x.dtype, device=x.device)
    diff = hi - lo
    # numpy's _lerp: from the nearer neighbour, so t = 1 gives b exactly.
    out = torch.where(t >= 0.5, hi - diff * (1 - t), lo + diff * t)
    out = torch.movedim(out, -1, 0)
    return out.reshape(np.shape(q) + out.shape[1:])


def histogram_counts(idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Exact int32 counts of integer bin indices in [0, bins).  The JAX
    package contracts one-hot matrices on the TPU's matrix unit; on the
    card (and the CPU) ``torch.bincount`` counts in int64, cast here."""
    return torch.bincount(idx.reshape(-1), minlength=bins).to(torch.int32)


def bin_index(x: torch.Tensor, lo, width, bins: int):
    """(idx, under, over) of ``floor((x - lo) / width)`` in float32:
    ``idx`` clipped to [0, bins) and 0 where out of range.  The floor is
    clamped to [-1, bins] before its integer cast, which keeps the counts
    of any finite value defined."""
    raw = torch.clamp(torch.floor((x - lo) / width), -1.0, float(bins))
    raw = raw.to(torch.int32)
    under, over = raw < 0, raw >= bins
    idx = torch.where(under | over, 0, raw)
    return idx, under, over


class HistogramSketch(NamedTuple):
    """Histogram over [lo, hi) with ``bins`` equal cells plus
    under/overflow, every field a tensor on one device."""

    lo: torch.Tensor         # 0-d float32
    hi: torch.Tensor
    counts: torch.Tensor     # (bins,) int32 (or float after a host merge)
    total: torch.Tensor      # 0-d float, includes under/overflow
    underflow: torch.Tensor  # 0-d float
    overflow: torch.Tensor   # 0-d float
    vmin: torch.Tensor       # exact running min/max
    vmax: torch.Tensor


def sketch_empty(lo: float, hi: float, bins: int = 4096, *,
                 device) -> HistogramSketch:
    """An empty sketch on ``device``: int32 counts (exact to 2^31 per bin)
    and float32 scalars, the totals wrap-free past 2^31 as in the JAX
    package."""
    as_ = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return HistogramSketch(
        lo=as_(lo), hi=as_(hi),
        counts=torch.zeros(bins, dtype=torch.int32, device=device),
        total=as_(0.0), underflow=as_(0.0), overflow=as_(0.0),
        vmin=as_(float("inf")), vmax=as_(float("-inf")))


def sketch_add(s: HistogramSketch, x: torch.Tensor) -> HistogramSketch:
    """Absorb a batch of values (any shape): in-range values into their
    bins, out-of-range ones into the under/overflow counts."""
    x = x.reshape(-1).to(s.lo.dtype)
    bins = s.counts.shape[0]
    width = (s.hi - s.lo) / bins
    idx, under, over = bin_index(x, s.lo, width, bins)
    batch = histogram_counts(idx, bins)
    # Out-of-range values were routed to bin 0: take them out again.
    batch[0] -= (under | over).sum(dtype=torch.int32)
    tdt = s.total.dtype
    return HistogramSketch(
        lo=s.lo, hi=s.hi, counts=s.counts + batch.to(s.counts.dtype),
        total=s.total + x.numel(),
        underflow=s.underflow + under.sum(dtype=torch.int32).to(tdt),
        overflow=s.overflow + over.sum(dtype=torch.int32).to(tdt),
        vmin=torch.minimum(s.vmin, x.min()),
        vmax=torch.maximum(s.vmax, x.max()))


def sketch_from_array(x: torch.Tensor, lo: float, hi: float,
                      bins: int = 4096) -> HistogramSketch:
    return sketch_add(sketch_empty(lo, hi, bins, device=x.device), x)


def sketch_merge(a: HistogramSketch, b: HistogramSketch) -> HistogramSketch:
    """Exact merge; the grids must match."""
    return HistogramSketch(
        lo=a.lo, hi=a.hi, counts=a.counts + b.counts, total=a.total + b.total,
        underflow=a.underflow + b.underflow, overflow=a.overflow + b.overflow,
        vmin=torch.minimum(a.vmin, b.vmin), vmax=torch.maximum(a.vmax, b.vmax))


def _width(s: HistogramSketch):
    return (s.hi - s.lo) / s.counts.shape[0]


def sketch_quantile(s: HistogramSketch, q) -> torch.Tensor:
    """Quantile (``q`` in [0, 100]) with within-bin linear interpolation,
    clamped to the observed range; error <= one bin width in range."""
    vdt = s.lo.dtype
    q = torch.as_tensor(q, dtype=vdt, device=s.lo.device) / 100.0
    bins = s.counts.shape[0]
    # CDF at each bin's right edge, underflow first, summed in float.
    cdf = s.underflow.to(vdt) + torch.cumsum(s.counts.to(vdt), dim=0)
    target = q * s.total.to(vdt)
    k = torch.clamp(torch.searchsorted(cdf, target.reshape(1)), 0,
                    bins - 1)[0]
    cdf_left = torch.where(k > 0, cdf[torch.clamp(k - 1, min=0)],
                           s.underflow.to(vdt))
    in_bin = torch.clamp(cdf[k] - cdf_left, min=1e-12)
    frac = torch.clamp((target - cdf_left) / in_bin, 0.0, 1.0)
    est = s.lo + (k.to(vdt) + frac) * _width(s)
    return torch.minimum(torch.maximum(est, s.vmin), s.vmax)


def sketch_quantile_std_err(s: HistogramSketch, q,
                            smooth_bins: int = 9) -> torch.Tensor:
    """Asymptotic standard error sqrt(q(1-q)/n) / f(x_q) of the q-th
    percentile, the density from the counts in a ``smooth_bins`` window
    around the quantile's bin (positions off the grid masked out)."""
    vdt = s.lo.dtype
    qf = float(q) / 100.0
    bins = s.counts.shape[0]
    width = _width(s)
    x_q = sketch_quantile(s, q)
    k = torch.clamp(torch.floor((x_q - s.lo) / width).to(torch.int32), 0,
                    bins - 1)
    h = smooth_bins // 2
    idx = k + torch.arange(-h, h + 1, device=k.device)
    valid = (idx >= 0) & (idx < bins)
    win = torch.where(valid, s.counts[torch.clamp(idx, 0, bins - 1)],
                      0).to(vdt).sum()
    n_win = valid.to(vdt).sum()
    n = torch.clamp(s.total.to(vdt), min=1.0)
    dens = torch.clamp(win / (n * n_win * width), min=1e-30)
    return torch.sqrt(qf * (1.0 - qf) / n) / dens


def sketch_cdf(s: HistogramSketch, x) -> torch.Tensor:
    """P(value <= x) with within-bin linear interpolation."""
    vdt = s.lo.dtype
    counts = s.counts.to(vdt)
    bins = s.counts.shape[0]
    width = _width(s)
    x = torch.as_tensor(x, dtype=vdt, device=s.lo.device)
    k = torch.clamp(torch.floor((x - s.lo) / width).to(torch.int32), 0,
                    bins - 1)
    below = torch.where(torch.arange(bins, device=k.device) < k, counts,
                        0.0).sum() + s.underflow.to(vdt)
    frac = torch.clamp((x - (s.lo + k.to(vdt) * width)) / width, 0.0, 1.0)
    below = below + counts[k] * frac
    return below / torch.clamp(s.total.to(vdt), min=1.0)


def sketch_tail_mean_below(s: HistogramSketch, threshold) -> torch.Tensor:
    """Mean of all values <= threshold (bin midpoints; the bin holding the
    threshold in proportion; the underflow mass at ``vmin``)."""
    vdt = s.lo.dtype
    counts = s.counts.to(vdt)
    bins = s.counts.shape[0]
    width = _width(s)
    threshold = torch.as_tensor(threshold, dtype=vdt, device=s.lo.device)
    grid = torch.arange(bins, dtype=vdt, device=counts.device)
    mids = s.lo + (grid + 0.5) * width
    right_edges = s.lo + (grid + 1.0) * width
    w = torch.where(right_edges <= threshold, counts, 0.0)
    k = torch.clamp(torch.floor((threshold - s.lo) / width).to(torch.int32),
                    0, bins - 1)
    frac = torch.clamp((threshold - (s.lo + k.to(vdt) * width)) / width,
                       0.0, 1.0)
    w[k] = counts[k] * frac
    under = s.underflow.to(vdt)
    tot = w.sum() + under
    acc = (w * mids).sum() + under * s.vmin
    return acc / torch.clamp(tot, min=1e-12)
