"""Draw providers: plain Monte Carlo and antithetic variates.

A sampler decides what innovations the engine feeds the process at each
step; the engine calls ``sampler.draws(process, seed, stream, path_ids, t)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PlainSampler:
    """Process-native pseudo-random draws (counter-based Threefry)."""

    def draws(self, process, seed, stream, path_ids, t):
        return process.draws(seed, stream, path_ids, t)


@dataclass(frozen=True)
class AntitheticSampler:
    """Antithetic variates: paths (2k, 2k+1) share the draws of logical pair
    ``k``, the odd path with mirrored sign.  Keyed by the global pair id, so
    still shard-invariant.  Use an even number of paths."""

    def draws(self, process, seed, stream, path_ids, t):
        eps = process.draws(seed, stream, path_ids >> 1, t)
        mirrored = process.antithetic(eps)
        odd = (path_ids & 1).to(torch.bool)
        return tuple(torch.where(odd, m, e) for m, e in zip(mirrored, eps))
