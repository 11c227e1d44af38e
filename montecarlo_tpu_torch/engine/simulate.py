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


def path_ids_for(n_paths: int, path_offset=0, device=None) -> torch.Tensor:
    """Global path ids ``path_offset + i`` of a contiguous block, wrapped
    mod 2^32 as the JAX package's uint32 ids are (int64 words)."""
    offset = int(path_offset) & MASK32
    return (torch.arange(n_paths, dtype=torch.int64, device=device)
            + offset) & MASK32


def _run(process, ids, n_steps, k0, k1, sampler, mode):
    if mode not in ("terminal", "paths"):
        raise ValueError(f"mode must be 'terminal' or 'paths', got {mode!r}")
    sampler = PlainSampler() if sampler is None else sampler
    check_sampler(sampler, process, n_steps)
    state = process.init_state(ids)
    rows = [process.prices(state)] if mode == "paths" else None
    for t in range(n_steps):
        eps = sampler.draws(process, k0, k1, ids, t)
        state = process.step(state, eps, t)
        if rows is not None:
            rows.append(process.prices(state))
    if rows is not None:
        return torch.stack(rows)
    return process.prices(state)


def simulate(process, n_paths: int, n_steps: int, *, seed, stream=0,
             sampler=None, mode: str = "terminal", path_offset=0):
    """Simulate ``n_paths`` paths for ``n_steps`` steps on the process's
    device.

    ``seed`` is a python int (full 64-bit seed space); it is folded into the
    Threefry key words once, here.  ``path_offset`` is the global id of the
    first path: a shard simulating paths [o, o+n) gets exactly the paths it
    would own inside a bigger run.
    """
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, process.device)
    return _run(process, ids, n_steps, k0, k1, sampler, mode)


def replay_paths(process, path_ids, n_steps: int, *, seed, stream=0,
                 sampler=None, mode: str = "terminal"):
    """Re-simulate an arbitrary set of global path ids, bit-exactly equal
    to the same paths inside :func:`simulate` — counter-based draws need no
    saved RNG state."""
    k0, k1 = key_from_seed(seed, stream)
    ids = torch.as_tensor(path_ids, device=process.device).to(torch.int64)
    return _run(process, ids & MASK32, n_steps, k0, k1, sampler, mode)
