"""Mergeable first/second-moment accumulators (Chan/Welford parallel form).

The port of ``montecarlo_tpu/stats/welford.py``.  Per-block states merge in
a fixed pairwise-tree order that depends only on the number of states, so
an estimate is bitwise the same however its blocks were computed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MomentState(NamedTuple):
    """count / mean / M2 (sum of squared deviations), any leading shape."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def moments_zero(shape=(), device=None) -> MomentState:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return MomentState(count=z, mean=z, m2=z)


def moments_from_array(x: torch.Tensor, axis: int = -1) -> MomentState:
    """Exact per-block moments of ``x`` along ``axis``."""
    mean = torch.mean(x, dim=axis)
    m2 = torch.sum(torch.square(x - mean.unsqueeze(axis)), dim=axis)
    count = torch.full_like(mean, float(x.shape[axis]))
    return MomentState(count=count, mean=mean, m2=m2)


def moments_merge(a: MomentState, b: MomentState) -> MomentState:
    """Chan et al. pairwise combine — associative, usable in trees."""
    n = a.count + b.count
    safe_n = torch.where(n > 0, n, torch.ones_like(n))
    delta = b.mean - a.mean
    w_b = b.count / safe_n
    mean = a.mean + delta * w_b
    m2 = a.m2 + b.m2 + torch.square(delta) * a.count * w_b
    return MomentState(count=n, mean=mean, m2=m2)


def moments_reduce(states: MomentState) -> MomentState:
    """Merge the leading axis of ``states`` in a fixed pairwise-tree order
    (adjacent pairs, odd leftover carried); the zero state for an empty
    axis."""
    st = states
    if st.count.shape[0] == 0:
        return MomentState(*(v.new_zeros(v.shape[1:]) for v in st))
    while st.count.shape[0] > 1:
        half = st.count.shape[0] // 2
        merged = moments_merge(MomentState(*(v[0:2 * half:2] for v in st)),
                               MomentState(*(v[1:2 * half:2] for v in st)))
        st = MomentState(*(torch.cat([m, v[2 * half:]])
                           for m, v in zip(merged, st)))
    return MomentState(*(v[0] for v in st))


def tree_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum along ``axis`` in a fixed adjacent-pair tree order (odd leftover
    carried).  The K3 kernel sums its 128-path rows in exactly this order
    (a warp butterfly, then the four warp partials as (w0+w1)+(w2+w3)), so
    the two agree bitwise.  Zero for an empty axis."""
    x = torch.movedim(x, axis, 0)
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = torch.cat([x[0:2 * half:2] + x[1:2 * half:2], x[2 * half:]])
    return x[0]


def variance(state: MomentState, ddof: int = 0):
    return state.m2 / torch.clamp(state.count - ddof, min=1.0)


def std(state: MomentState, ddof: int = 0):
    return torch.sqrt(variance(state, ddof))


def std_error(state: MomentState):
    """Standard error of the mean — the Monte Carlo convergence metric."""
    return torch.sqrt(variance(state, ddof=1)
                      / torch.clamp(state.count, min=1.0))
