"""Engine dispatch for terminal, block-moment and path-functional runs.

One gate, :func:`kernel_route`, decides every route from types and sizes
before anything launches (the counterpart of the JAX package's
``_fusable_sampler``/``_kernel_sampler``/``_fused_eligible``):

- **the kernels** (K2, K3, K4; their plain versions for a CPU process)
  for a process the kernels take (``ops.fused_engine.kernel_refusal`` is
  None: a type in ``PROCESS_CODES``, a :class:`BasketGBM` of at most
  ``MAX_ASSETS`` assets, a TermBasketGBM, CCCGarch or DCCGarch of at most
  ``MAX_STATE_ASSETS`` assets and not under the bridge) with no sampler,
  the plain or antithetic sampler, a :class:`SobolDeviceSampler` whose
  table covers ``n_steps * n_draws`` dims, or a
  :class:`SobolBridgeKernelSampler` on a single-draw process built for at
  least ``n_steps`` steps, its plan at most ``MAX_BRIDGE_LEVELS`` wide;
- **the torch time loop** otherwise (``engine.simulate``, the
  functionals' loop): any process with the protocol, any sampler, the same
  streams.

Nothing catches a kernel's error to retry elsewhere: a run the gate sends
to a kernel launches it, or raises.  Block moments use K3 when the payoff
is a :class:`VanillaPayoff` and the path count is a multiple of the
4096-path stats block; otherwise terminal prices, then the payoff and
``moments_from_array`` in torch.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.engine.payoffs import VanillaPayoff
from montecarlo_tpu_torch.engine.simulate import simulate
from montecarlo_tpu_torch.ops.fused_engine import (STATS_BLOCK,
                                                   fused_block_moments,
                                                   fused_functionals,
                                                   fused_terminal,
                                                   kernel_refusal)
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            SobolDeviceSampler)
from montecarlo_tpu_torch.samplers import AntitheticSampler, PlainSampler
from montecarlo_tpu_torch.stats.welford import MomentState, moments_from_array


def _kernel_sampler_ok(sampler, process, n_steps: int) -> bool:
    if sampler is None or isinstance(sampler, (PlainSampler,
                                               AntitheticSampler)):
        return True
    if isinstance(sampler, SobolBridgeKernelSampler):
        return process.n_draws == 1 and n_steps <= sampler.n_steps
    return (isinstance(sampler, SobolDeviceSampler)
            and sampler.n_dims >= n_steps * process.n_draws)


def kernel_route(process, sampler, n_steps: int) -> bool:
    """True when K2-K4 (or their plain versions) run this process and
    sampler; False for the torch time loop (also for a process the
    kernels' wrappers refuse, such as a basket larger than they take or a
    CCC book of more than MAX_STATE_ASSETS assets)."""
    return (kernel_refusal(process, sampler) is None
            and _kernel_sampler_ok(sampler, process, n_steps))


def _kernel_args(sampler) -> dict:
    """The kernel wrappers' draw arguments for a sampler the gate took."""
    if isinstance(sampler, (SobolDeviceSampler, SobolBridgeKernelSampler)):
        return {"sampler": sampler}
    return {"antithetic": isinstance(sampler, AntitheticSampler)}


def terminal_prices(process, n_paths: int, n_steps: int, *, seed, stream=0,
                    sampler=None, path_offset=0, prefer_fused: bool = True,
                    dtype=torch.float32):
    """Terminal prices through K2 when the gate takes the run (its plain
    version on the CPU), else the torch loop; the same draw streams.  The
    kernels are float32: a run in another ``dtype`` takes the torch loop
    in it (``simulate(dtype=)``)."""
    if (prefer_fused and dtype == torch.float32
            and kernel_route(process, sampler, n_steps)):
        return fused_terminal(process, n_paths, n_steps, seed=seed,
                              stream=stream, path_offset=path_offset,
                              **_kernel_args(sampler))
    return simulate(process, n_paths, n_steps, seed=seed, stream=stream,
                    sampler=sampler, path_offset=path_offset, dtype=dtype)


def functional_run(process, n_paths: int, n_steps: int, *, seed,
                   functionals, stream=0, sampler=None, path_offset=0):
    """Terminal prices and path functionals through K4 when the gate takes
    the run (its plain version on the CPU), else the functionals' torch
    loop; the same draw streams."""
    if kernel_route(process, sampler, n_steps):
        return fused_functionals(process, n_paths, n_steps, seed=seed,
                                 functionals=functionals, stream=stream,
                                 path_offset=path_offset,
                                 **_kernel_args(sampler))
    from montecarlo_tpu_torch.engine.functionals import _simulate_functionals
    from montecarlo_tpu_torch.rng.threefry import key_from_seed

    k0, k1 = key_from_seed(seed, stream)
    return _simulate_functionals(process, n_paths, n_steps, k0, k1, sampler,
                                 path_offset, tuple(functionals.items()))


def payoff_block_moments(process, payoff_fn, n_paths: int, n_steps: int, *,
                         seed, stream=0, sampler=None, path_offset=0,
                         prefer_fused: bool = True) -> MomentState:
    """Per-4096-path-block payoff moments (one state over the whole run
    when ``n_paths`` is not a multiple of 4096)."""
    fused = prefer_fused and kernel_route(process, sampler, n_steps)
    if (fused and isinstance(payoff_fn, VanillaPayoff)
            and n_paths % STATS_BLOCK == 0):
        return fused_block_moments(process, payoff_fn, n_paths, n_steps,
                                   seed=seed, stream=stream,
                                   path_offset=path_offset,
                                   **_kernel_args(sampler))
    terminal = terminal_prices(process, n_paths, n_steps, seed=seed,
                               stream=stream, sampler=sampler,
                               path_offset=path_offset,
                               prefer_fused=prefer_fused)
    payoffs = payoff_fn(terminal)
    if n_paths % STATS_BLOCK:
        return moments_from_array(payoffs[None, :], axis=-1)
    return moments_from_array(payoffs.reshape(-1, STATS_BLOCK), axis=-1)
