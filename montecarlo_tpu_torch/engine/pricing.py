"""Monte Carlo estimators over simulated terminal prices.

The port of ``montecarlo_tpu/engine/pricing.py::mc_estimate`` and
``::price_to_tolerance`` (randomized QMC comes with the QMC slice).
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.engine.dispatch import payoff_block_moments
from montecarlo_tpu_torch.stats.welford import (moments_from_array,
                                                moments_merge, moments_reduce,
                                                moments_zero, std_error)


def mc_estimate(payoffs: torch.Tensor, discount=1.0) -> dict:
    """Mean estimator with standard error: ``{"price", "std_err",
    "n_paths"}``, ``std_err`` discounted like the price."""
    if not torch.is_floating_point(payoffs):
        # Bool/int payoffs (digitals): promote the payoffs, never truncate
        # the discount to their dtype.
        payoffs = payoffs.to(torch.float32)
    st = moments_from_array(payoffs, axis=0)
    d = torch.as_tensor(discount, dtype=payoffs.dtype, device=payoffs.device)
    return {"price": d * st.mean, "std_err": d * std_error(st),
            "n_paths": st.count}


def price_to_tolerance(process, payoff_fn, *, target_std_err, seed,
                       chunk_paths: int = 1 << 22, n_steps: int = 252,
                       discount=1.0, max_chunks: int = 1024) -> dict:
    """Price chunk by chunk until the discounted standard error reaches
    ``target_std_err`` (at least one chunk, at most ``max_chunks``).

    Chunk ``i`` simulates global paths [i*chunk_paths, (i+1)*chunk_paths),
    so the estimate equals the JAX package's for the same arguments up to
    float32 summation order.  Returns ``{"price", "std_err", "n_paths",
    "n_chunks"}``.
    """
    if chunk_paths * max_chunks > 1 << 32:
        # Path ids are uint32: offsets past 2^32 wrap and REPLAY earlier
        # chunks' draws, which would be merged as independent samples.
        raise ValueError(
            f"chunk_paths*max_chunks = {chunk_paths}*{max_chunks} exceeds "
            "the 2^32 global path-id space; lower one of them")
    dev = process.device
    d = torch.tensor(discount, dtype=torch.float32, device=dev)
    target = torch.tensor(target_std_err, dtype=torch.float32, device=dev)
    st = moments_zero(device=dev)
    n_chunks = 0
    # The JAX version is one on-device while_loop.  Here the loop is on the
    # host and reading the stopping test syncs with the device once per
    # chunk; at 2^22 paths x 252 steps per chunk that wait is negligible
    # beside the chunk's own kernel time.
    while n_chunks < max_chunks and (
            n_chunks < 1 or bool(d * std_error(st) > target)):
        blocks = payoff_block_moments(
            process, payoff_fn, chunk_paths, n_steps, seed=seed,
            path_offset=n_chunks * chunk_paths)
        st = moments_merge(st, moments_reduce(blocks))
        n_chunks += 1
    return {"price": d * st.mean, "std_err": d * std_error(st),
            "n_paths": st.count, "n_chunks": n_chunks}
