"""Monte Carlo estimators over simulated terminal prices.

The port of ``montecarlo_tpu/engine/pricing.py``: ``mc_estimate``,
``price_to_tolerance`` and the randomized-QMC estimators
``rqmc_estimate`` and ``price_to_tolerance_rqmc``.  The JAX package runs
the replicates as one ``lax.scan`` inside one jitted program; here they
are a host loop of R launches (one per replicate) and, for the tolerance
loop, one host read per chunk for the stopping test.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.engine.dispatch import (payoff_block_moments,
                                                  terminal_prices)
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


def _replicate_shift_seeds(seed: int, n_replicates: int) -> list:
    """Per-replicate seeds (the Owen-hash keys of each replicate's draws),
    masked to 31 bits as the JAX package masks them for its int32 kernel
    operand."""
    return [(seed + 0x9E3779B9 * (r + 1)) & 0x7FFFFFFF
            for r in range(n_replicates)]


def _default_factory(process, n_steps: int, seed: int):
    """Device Sobol samplers with a fresh linear matrix scramble per
    replicate, on the process's device."""
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    return lambda r: SobolDeviceSampler.create(
        n_steps, process.n_draws, scramble_seed=seed + r,
        device=process.device)


def _check_replicates(n_replicates: int) -> None:
    if n_replicates < 2:
        raise ValueError("n_replicates must be >= 2 (the error bar is the "
                         "spread across replications)")


def _spread_se(means: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """d * std(replicate means, ddof=1) / sqrt(R), float32."""
    rf = torch.tensor(float(means.numel()), dtype=torch.float32,
                      device=means.device)
    return d * torch.std(means, correction=1) / torch.sqrt(rf)


def rqmc_estimate(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, sampler_factory=None, n_replicates: int = 8,
                  discount=1.0, functionals=None) -> dict:
    """Randomized-QMC estimate with an honest error bar: ``n_replicates``
    independent randomizations of the same point set, each over
    ``n_paths // n_replicates`` paths, reporting

        price   = d * mean of replicate means,
        std_err = d * std(replicate means, ddof=1) / sqrt(R).

    ``sampler_factory(r) -> sampler`` defaults to device Sobol samplers
    with a fresh linear matrix scramble per replicate; replicate ``r``
    draws with seed ``_replicate_shift_seeds(seed, R)[r]``.  Each replicate
    goes through ``engine.dispatch`` (a kernel launch, or the torch loop
    for a host table).  ``functionals``: an optional ``{name:
    PathFunctional}``; ``payoff_fn`` then receives the
    ``simulate_functionals`` output dict instead of the terminal array.
    Returns ``{"price", "std_err", "n_paths", "n_replicates"}``.
    """
    from montecarlo_tpu_torch.engine.functionals import simulate_functionals

    _check_replicates(n_replicates)
    if n_paths < n_replicates or n_paths % n_replicates:
        raise ValueError(
            f"n_paths={n_paths} must split into n_replicates="
            f"{n_replicates} equal non-empty QMC replications")
    n_per = n_paths // n_replicates
    if sampler_factory is None:
        sampler_factory = _default_factory(process, n_steps, seed)
    means = []
    for r, rseed in enumerate(_replicate_shift_seeds(seed, n_replicates)):
        smp = sampler_factory(r)
        if functionals is None:
            out = terminal_prices(process, n_per, n_steps, seed=rseed,
                                  sampler=smp)
        else:
            out = simulate_functionals(process, n_per, n_steps, seed=rseed,
                                       functionals=functionals, sampler=smp)
        means.append(torch.mean(payoff_fn(out).to(torch.float32)))
    m = torch.stack(means)
    d = torch.as_tensor(discount, dtype=torch.float32, device=m.device)
    return {"price": d * torch.mean(m), "std_err": _spread_se(m, d),
            "n_paths": n_paths, "n_replicates": n_replicates}


def price_to_tolerance_rqmc(process, payoff_fn, *, target_std_err, seed,
                            n_replicates: int = 8,
                            chunk_paths: int = 1 << 18, n_steps: int = 252,
                            discount=1.0, max_chunks: int = 256,
                            min_chunks: int = 1,
                            sampler_factory=None) -> dict:
    """Price to a target std-err with randomized QMC: every replicate
    prices ``chunk_paths`` more Sobol points per chunk (the same growing
    prefix of point indices), the running replicate means update as
    ``means + (cm - means) / (i + 1)`` in float32, and the loop stops
    after at least ``min_chunks`` chunks once the replicate-spread error
    ``d * std(means, ddof=1) / sqrt(R)`` reaches ``target_std_err`` (or
    after ``max_chunks``).  Per chunk: R launches and one host read.

    Returns ``{"price", "std_err", "n_paths", "n_chunks",
    "n_replicates"}``.
    """
    _check_replicates(n_replicates)
    if chunk_paths * max_chunks > 1 << 30:
        # Sobol integers carry 30 bits: point indices past 2^30 wrap and
        # REPLAY earlier points, understating the reported spread.
        raise ValueError(
            f"chunk_paths*max_chunks = {chunk_paths}*{max_chunks} exceeds "
            "the 2^30 Sobol point space per replicate; lower one of them")
    if sampler_factory is None:
        sampler_factory = _default_factory(process, n_steps, seed)
    samplers = [sampler_factory(r) for r in range(n_replicates)]
    seeds = _replicate_shift_seeds(seed, n_replicates)
    dev = process.device
    d = torch.as_tensor(discount, dtype=torch.float32, device=dev)
    target = torch.as_tensor(target_std_err, dtype=torch.float32, device=dev)
    means = torch.zeros(n_replicates, dtype=torch.float32, device=dev)
    i = 0
    while i < max_chunks and (i < min_chunks
                              or bool(_spread_se(means, d) > target)):
        cm = torch.stack([
            moments_reduce(payoff_block_moments(
                process, payoff_fn, chunk_paths, n_steps, seed=rseed,
                path_offset=i * chunk_paths, sampler=smp)).mean
            for smp, rseed in zip(samplers, seeds)])
        # Equal-size chunks: exact running replicate means.
        means = means + (cm - means) / float(i + 1)
        i += 1
    return {"price": d * torch.mean(means), "std_err": _spread_se(means, d),
            "n_paths": float(i * chunk_paths * n_replicates),
            "n_chunks": i, "n_replicates": n_replicates}
