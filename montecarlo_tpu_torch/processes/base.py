"""The stochastic-process protocol, as in ``montecarlo_tpu/processes/base.py``.

A *process* is a frozen dataclass whose fields are 0-d float32 tensors on
one device, with pure methods:

- ``n_draws``                       — innovations per path per step
- ``init_state(path_ids)``          — state for a block of paths
- ``draws(seed, stream, path_ids, t)`` — the innovations of step ``t``
- ``step(state, eps, t)``           — one time step
- ``prices(state)``                 — observable prices
- ``antithetic(eps)``               — mirrored innovations (negation)

Time stays sequential (a Python loop here, a loop inside the kernel on the
card); parallelism is over paths.
"""

from __future__ import annotations

import dataclasses

import torch

from montecarlo_tpu_torch.rng.normal import normal_draw, normal_pair
from montecarlo_tpu_torch.rng.threefry import MASK32


class NormalDrawsMixin:
    """Default innovations: i.i.d. standard normals keyed by (global path
    id, draw index ``m = t * n_draws + d``), so streams are shard-invariant.
    Innovations are a tuple of per-dimension tensors shaped like
    ``path_ids``."""

    @property
    def device(self) -> torch.device:
        return getattr(self, dataclasses.fields(self)[0].name).device

    def draws(self, seed, stream, path_ids, t):
        d0 = int(t) * self.n_draws
        return tuple(normal_draw(seed, stream, path_ids, (d0 + d) & MASK32)
                     for d in range(self.n_draws))

    def draws_pair(self, seed, stream, path_ids, j):
        """Innovations for steps (2j, 2j+1) from exactly ``n_draws`` cipher
        calls (draw m lives in call m >> 1) — bitwise equal to :meth:`draws`
        at t=2j and t=2j+1."""
        D = self.n_draws
        flat = []
        for c in range(D):
            z0, z1 = normal_pair(seed, stream, path_ids,
                                 (int(j) * D + c) & MASK32)
            flat += [z0, z1]
        return tuple(flat[:D]), tuple(flat[D:])

    def antithetic(self, eps):
        return tuple(-e for e in eps)
