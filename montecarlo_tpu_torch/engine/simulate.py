"""The reference path-simulation engine: a Python loop over time.

The port of ``montecarlo_tpu/engine/simulate.py``.  This engine defines the
semantics: the kernels in :mod:`montecarlo_tpu_torch.ops` and their plain
versions draw the same streams and run the same step arithmetic.

Modes:
- ``"terminal"`` — terminal prices only, shape (n_paths,);
- ``"paths"``    — the (n_steps+1, n_paths) price array, row 0 = spot.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.rng.threefry import MASK32, key_from_seed
from montecarlo_tpu_torch.samplers import PlainSampler


def check_sampler(sampler, process, n_steps: int) -> None:
    """Sampler/process compatibility guards: a sampler that substitutes
    standard normals for every draw (``normals_only``) needs an all-normal
    process, and a sampler with a finite table validates its coverage."""
    if sampler is None:
        return
    if not callable(getattr(sampler, "draws", None)):
        raise TypeError(f"{type(sampler).__name__} is not a sampler: it has "
                        "no draws(process, seed, stream, path_ids, t)")
    if getattr(sampler, "normals_only", False):
        from montecarlo_tpu_torch.processes.base import NormalDrawsMixin

        if not isinstance(process, NormalDrawsMixin):
            raise ValueError(
                f"{type(sampler).__name__} substitutes standard normals for "
                f"every draw, but {type(process).__name__} consumes "
                "non-normal draws")
    validate = getattr(sampler, "validate", None)
    if validate is not None:
        validate(process, n_steps)


def check_steps(process, n_steps: int) -> None:
    """Raise ``ValueError`` when ``process`` reads per-step curves
    (``max_steps``: TermStructureGBM, HullWhite, TermBasketGBM) shorter
    than ``n_steps``.
    Every route (the torch loop, K2-K4 and their plain versions) asks
    before its first step."""
    limit = getattr(process, "max_steps", None)
    if limit is not None and n_steps > limit:
        raise ValueError(f"{type(process).__name__} has curves for {limit} "
                         f"steps, {n_steps} asked for")


def path_ids_for(n_paths: int, path_offset=0, device=None) -> torch.Tensor:
    """Global path ids ``path_offset + i`` of a contiguous block, wrapped
    mod 2^32 as the JAX package's uint32 ids are (int64 words)."""
    offset = int(path_offset) & MASK32
    return (torch.arange(n_paths, dtype=torch.int64, device=device)
            + offset) & MASK32


def cast_state(state, dtype):
    """``state`` with every field in ``dtype`` (the JAX package's
    ``init_state(path_ids, dtype)``: the float32 start, cast)."""
    if dtype == torch.float32:
        return state
    return type(state)(*(v.to(dtype) for v in state))


def start_state(process, ids, dtype):
    """The start of a run in ``dtype``: computed in it by a process whose
    JAX ``init_state`` computes in the run's dtype (``start_in_run_dtype``:
    the LMM's ``log32(f0 + shift)``), else the float32 start, cast."""
    if getattr(process, "start_in_run_dtype", False):
        return process.init_state(ids, dtype)
    return cast_state(process.init_state(ids), dtype)


def _run(process, ids, n_steps, k0, k1, sampler, mode, remat=False,
         observe=None, dtype=torch.float32):
    if mode not in ("terminal", "paths"):
        raise ValueError(f"mode must be 'terminal' or 'paths', got {mode!r}")
    sampler = PlainSampler() if sampler is None else sampler
    check_sampler(sampler, process, n_steps)
    check_steps(process, n_steps)
    obs = observe or (lambda p, s: p.prices(s))

    # Another dtype than float32 asks the sampler for draws in it, as the
    # JAX package's samplers take a dtype (PlainSampler passes it on to
    # the process's own draws).
    extra = () if dtype == torch.float32 else (dtype,)

    def body(state, t):
        return process.step(state, sampler.draws(process, k0, k1, ids, t,
                                                 *extra), t)

    step = body
    if remat:
        from torch.utils.checkpoint import checkpoint

        def step(state, t):
            return checkpoint(body, state, t, use_reentrant=False)

    state = start_state(process, ids, dtype)
    rows = [obs(process, state)] if mode == "paths" else None
    for t in range(n_steps):
        state = step(state, t)
        if rows is not None:
            rows.append(obs(process, state))
    if rows is not None:
        return torch.stack(rows)
    return obs(process, state)


def simulate(process, n_paths: int, n_steps: int, *, seed, stream=0,
             sampler=None, mode: str = "terminal", path_offset=0,
             remat: bool = False, observe=None, dtype=torch.float32):
    """Simulate ``n_paths`` paths for ``n_steps`` steps on the process's
    device.

    ``seed`` is a python int (full 64-bit seed space); it is folded into the
    Threefry key words once, here.  ``path_offset`` is the global id of the
    first path: a shard simulating paths [o, o+n) gets exactly the paths it
    would own inside a bigger run.

    ``remat``: run each step under ``torch.utils.checkpoint`` (non-reentrant),
    so that reverse mode (pathwise greeks) keeps one state per step instead
    of every intermediate of the step, and recomputes the step's draws from
    their counters in the backward pass; the values and gradients are the
    same bits.  ``observe(process, state)`` replaces ``process.prices`` in
    every output row (and the terminal): how a multi-state process exposes
    its full state; an (n_paths, C) observation gives (n_steps + 1,
    n_paths, C) paths.  ``dtype`` (float32 by default) is the state's and
    the draws' dtype, as the JAX package's ``dtype``: float64 casts the
    float32 start and draws float64 normals (the process's leaves keep
    their own dtype).
    """
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, process.device)
    return _run(process, ids, n_steps, k0, k1, sampler, mode, remat,
                observe, dtype)


def replay_paths(process, path_ids, n_steps: int, *, seed, stream=0,
                 sampler=None, mode: str = "terminal"):
    """Re-simulate an arbitrary set of global path ids, bit-exactly equal
    to the same paths inside :func:`simulate` — counter-based draws need no
    saved RNG state."""
    k0, k1 = key_from_seed(seed, stream)
    ids = torch.as_tensor(path_ids, device=process.device).to(torch.int64)
    return _run(process, ids & MASK32, n_steps, k0, k1, sampler, mode)
