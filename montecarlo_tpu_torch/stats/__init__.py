"""Mergeable moment statistics."""

from montecarlo_tpu_torch.stats.welford import (  # noqa: F401
    MomentState,
    moments_from_array,
    moments_merge,
    moments_reduce,
    moments_zero,
    std,
    std_error,
    tree_sum,
    variance,
)
