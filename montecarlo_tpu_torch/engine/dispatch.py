"""Engine dispatch for terminal and path-functional runs.

GBM, Heston, BasketGBM and the bootstrap GARCH with the plain or
antithetic sampler always go through the kernel wrappers, at any path
count (the kernels mask the ragged edge); each wrapper launches its CUDA
kernel for a CUDA process and runs its plain version for a CPU one.  Block moments use K3 when the payoff is a
:class:`VanillaPayoff` and the path count is a multiple of the 4096-path
stats block; otherwise K2, then the payoff and ``moments_from_array`` in
torch.  Path functionals go to K4 (``simulate_functionals(...,
prefer_fused=True)``).
"""

from __future__ import annotations

from montecarlo_tpu_torch.engine.payoffs import VanillaPayoff
from montecarlo_tpu_torch.ops.fused_engine import (STATS_BLOCK,
                                                   fused_block_moments,
                                                   fused_functionals,
                                                   fused_terminal)
from montecarlo_tpu_torch.samplers import AntitheticSampler, PlainSampler
from montecarlo_tpu_torch.stats.welford import MomentState, moments_from_array


def _antithetic(sampler) -> bool:
    if sampler is None or isinstance(sampler, PlainSampler):
        return False
    if isinstance(sampler, AntitheticSampler):
        return True
    raise TypeError("the kernels run the plain and antithetic samplers, got "
                    f"{type(sampler).__name__}; use engine.simulate")


def terminal_prices(process, n_paths: int, n_steps: int, *, seed, stream=0,
                    sampler=None, path_offset=0):
    """Terminal prices through K2 (its plain version on the CPU); the same
    draw streams as ``simulate``."""
    return fused_terminal(process, n_paths, n_steps, seed=seed,
                          stream=stream, path_offset=path_offset,
                          antithetic=_antithetic(sampler))


def functional_run(process, n_paths: int, n_steps: int, *, seed,
                   functionals, stream=0, sampler=None, path_offset=0):
    """Terminal prices and path functionals through K4 (its plain version
    on the CPU); the same draw streams as the torch time loop."""
    return fused_functionals(process, n_paths, n_steps, seed=seed,
                             functionals=functionals, stream=stream,
                             path_offset=path_offset,
                             antithetic=_antithetic(sampler))


def payoff_block_moments(process, payoff_fn, n_paths: int, n_steps: int, *,
                         seed, stream=0, sampler=None,
                         path_offset=0) -> MomentState:
    """Per-4096-path-block payoff moments (one state over the whole run
    when ``n_paths`` is not a multiple of 4096)."""
    antithetic = _antithetic(sampler)
    if isinstance(payoff_fn, VanillaPayoff) and n_paths % STATS_BLOCK == 0:
        return fused_block_moments(process, payoff_fn, n_paths, n_steps,
                                   seed=seed, stream=stream,
                                   path_offset=path_offset,
                                   antithetic=antithetic)
    terminal = fused_terminal(process, n_paths, n_steps, seed=seed,
                              stream=stream, path_offset=path_offset,
                              antithetic=antithetic)
    payoffs = payoff_fn(terminal)
    if n_paths % STATS_BLOCK:
        return moments_from_array(payoffs[None, :], axis=-1)
    return moments_from_array(payoffs.reshape(-1, STATS_BLOCK), axis=-1)
