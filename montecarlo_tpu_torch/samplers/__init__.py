"""Draw providers: plain Monte Carlo, antithetic variates, Sobol QMC.

A sampler decides what innovations the engine feeds the process at each
step; the engine calls ``sampler.draws(process, seed, stream, path_ids, t)``.
The device-generated Sobol samplers live in :mod:`montecarlo_tpu_torch.rng.
sobol`; the host tables here (``SobolSampler``, ``MixedSobolSampler``) are
the port of ``montecarlo_tpu/samplers/__init__.py``'s: scipy's seeded
scrambled Sobol points and ``scipy.special.ndtri`` in float64, cast once to
float32, so they equal the JAX package's tables bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class PlainSampler:
    """Process-native pseudo-random draws (counter-based Threefry); a
    ``dtype`` after ``t`` goes on to the process's draws (the JAX package's
    float64 draws)."""

    def draws(self, process, seed, stream, path_ids, t, *dtype):
        return process.draws(seed, stream, path_ids, t, *dtype)


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


def _brownian_bridge_increments(z: np.ndarray) -> np.ndarray:
    """Map (n, T) i.i.d. normals to Brownian increments in the bridge
    order: dimension 0 sets W_T, then each next dimension fills the
    midpoint of the widest remaining interval with the exact conditional
    mean and variance.  The increments stay i.i.d. N(0, 1)."""
    n, T = z.shape
    w = np.zeros((n, T + 1))
    w[:, T] = np.sqrt(float(T)) * z[:, 0]
    k = 1
    segments = [(0, T)]
    while segments:
        nxt = []
        for (l, r) in segments:
            if r - l <= 1:
                continue
            mid = (l + r) // 2
            mean = ((r - mid) * w[:, l] + (mid - l) * w[:, r]) / (r - l)
            std = np.sqrt((mid - l) * (r - mid) / (r - l))
            w[:, mid] = mean + std * z[:, k]
            k += 1
            nxt += [(l, mid), (mid, r)]
        segments = nxt
    assert k == T, (k, T)
    return np.diff(w, axis=1)  # unit-time steps -> N(0,1) increments


def _sobol_points(n_paths: int, dim: int, seed: int) -> np.ndarray:
    """The first ``n_paths`` of scipy's seeded scrambled Sobol points in
    ``dim`` dimensions (the next power of two, truncated), float64."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=dim, scramble=True, seed=seed)
    m = max(1, int(np.ceil(np.log2(max(n_paths, 2)))))
    return eng.random_base2(m=m)[:n_paths]


def _draw_kinds(process) -> Tuple[str, ...]:
    return tuple(getattr(process, "draw_kinds",
                         ("normal",) * process.n_draws))


@dataclass(frozen=True)
class SobolSampler:
    """Scrambled Sobol quasi-Monte Carlo draws from a host table
    ``z`` (n_paths, n_steps, n_draws) on the process's device, float32
    unless built with another ``dtype`` (the JAX package's float64 table);
    the engine gathers step slices by global path id, so a run must use
    ids below ``n_paths``.  A run in another dtype than the table's gets
    the table's values cast, as JAX's ``astype``.  Normals only: build it
    with :meth:`for_process`, which gives processes with uniform slots a
    :class:`MixedSobolSampler`."""

    z: torch.Tensor

    normals_only = True

    def draws(self, process, seed, stream, path_ids, t, *dtype):
        step = self.z[path_ids, int(t)]
        if dtype:
            step = step.to(dtype[0])
        return tuple(step[..., d] for d in range(self.z.shape[-1]))

    @classmethod
    def for_process(cls, process, n_paths: int, n_steps: int, seed: int = 0,
                    bridge: bool = False, dtype=torch.float32):
        """All-normal processes get a :class:`SobolSampler`, processes with
        uniform slots (``draw_kinds``) a :class:`MixedSobolSampler`; the
        table lives on the process's device."""
        kinds = _draw_kinds(process)
        if all(k == "normal" for k in kinds):
            return cls.create(n_paths, n_steps, len(kinds), seed=seed,
                              bridge=bridge, device=process.device,
                              dtype=dtype)
        if bridge:
            raise ValueError("the Brownian-bridge construction reorders "
                             "NORMAL increments; this process has uniform "
                             "draw slots")
        return MixedSobolSampler.create(process, n_paths, n_steps,
                                        seed=seed)

    @classmethod
    def create(cls, n_paths: int, n_steps: int, n_draws: int, seed: int = 0,
               bridge: bool = False, device="cuda",
               dtype=torch.float32) -> "SobolSampler":
        """``bridge=True`` applies the Brownian-bridge construction (single
        draw dimension only): the best Sobol dimensions drive the path's
        coarse structure."""
        from scipy.special import ndtri

        z = ndtri(_sobol_points(n_paths, n_steps * n_draws, seed))
        if bridge:
            if n_draws != 1:
                raise ValueError("bridge construction supports n_draws=1")
            z = _brownian_bridge_increments(z)
        z = z.reshape(n_paths, n_steps, n_draws)
        return cls(z=torch.as_tensor(z, dtype=dtype,
                                     device=resolve_device(device)))


@dataclass(frozen=True)
class MixedSobolSampler:
    """Scrambled Sobol QMC for processes with mixed normal and uniform
    draw slots (the bootstrap GARCH's resampling uniform): each (step,
    slot) has its own Sobol dimension; normal slots go through the inverse
    CDF, uniform slots keep the point, clipped to [2^-24, 1 - 2^-24].
    ``kinds`` must equal the process's ``draw_kinds`` (``validate``)."""

    z: torch.Tensor
    kinds: Tuple[str, ...]

    def validate(self, process, n_steps: int) -> None:
        want = _draw_kinds(process)
        if want != self.kinds:
            raise ValueError(
                f"MixedSobolSampler slot layout {self.kinds} does not "
                f"match {type(process).__name__}.draw_kinds {want} — "
                "build the sampler with SobolSampler.for_process(process)")
        if n_steps > self.z.shape[1]:
            raise ValueError(
                f"sampler table covers {self.z.shape[1]} steps, run asks "
                f"for {n_steps}")

    def draws(self, process, seed, stream, path_ids, t):
        step = self.z[path_ids, int(t)]
        return tuple(step[..., d] for d in range(len(self.kinds)))

    @classmethod
    def create(cls, process, n_paths: int, n_steps: int,
               seed: int = 0) -> "MixedSobolSampler":
        from scipy.special import ndtri

        kinds = tuple(process.draw_kinds)
        d = len(kinds)
        u = _sobol_points(n_paths, n_steps * d, seed).reshape(
            n_paths, n_steps, d)
        # Open interval: inverse CDFs and table indices stay finite.
        u = np.clip(u, 2.0**-24, 1.0 - 2.0**-24)
        z = np.where(np.asarray([k == "normal" for k in kinds]), ndtri(u), u)
        return cls(z=torch.as_tensor(z, dtype=torch.float32,
                                     device=process.device), kinds=kinds)
