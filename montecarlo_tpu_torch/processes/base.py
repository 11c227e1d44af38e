"""The stochastic-process protocol, as in ``montecarlo_tpu/processes/base.py``.

A *process* is a frozen dataclass whose fields are 0-d float32 tensors on
one device, with pure methods:

- ``n_draws``                       — innovations per path per step
- ``init_state(path_ids)``          — state for a block of paths
- ``draws(seed, stream, path_ids, t)`` — the innovations of step ``t``
- ``step(state, eps, t)``           — one time step
- ``prices(state)``                 — observable prices
- ``antithetic(eps)``               — mirrored innovations (a normal
  negated, a uniform reflected as ``1 - u``)
- ``draw_kinds``                    — ``"normal"`` or ``"uniform"`` per
  draw, for processes whose draws are not all normals

Time stays sequential (a Python loop here, a loop inside the kernel on the
card); parallelism is over paths.
"""

from __future__ import annotations

import dataclasses

import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.rng.normal import (exp32, log32, normal_draw,
                                             normal_pair)
from montecarlo_tpu_torch.rng.threefry import MASK32


def f32_leaves(device, **values) -> dict:
    """0-d float32 tensors on ``device`` (resolved: CUDA without a card
    raises) from python numbers or 0-d tensors, by field name."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in values.items()}


def curve_at(curve: torch.Tensor, t) -> torch.Tensor:
    """Entry ``t`` of a per-step parameter curve (TermStructureGBM's drift
    and vol, HullWhite's theta), or column ``t`` of per-asset curves, one
    row an asset (TermBasketGBM's): plain indexing, where the JAX package
    reads a one-hot row inside its kernels.  A step past the curve's end
    raises ``ValueError``: outside a kernel JAX clamps the index, inside one
    its one-hot read gives 0, and the port copies neither."""
    t, n = int(t), curve.shape[-1]
    if not 0 <= t < n:
        raise ValueError(f"step {t} is past the end of a {n}-step curve")
    return curve[..., t]


def grad_safe_sqrt(q: torch.Tensor) -> torch.Tensor:
    """``sqrt(max(q, 0))`` with a finite gradient at ``q <= 0``: the
    double ``where`` of the JAX package (its value is the clamped root,
    its gradient at q <= 0 is 0)."""
    pos = q > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, q, 1.0)),
                       torch.zeros_like(q))


class DeviceMixin:
    """The device of a process: the device of its first field."""

    @property
    def device(self) -> torch.device:
        return getattr(self, dataclasses.fields(self)[0].name).device


class LogPriceMixin:
    """State, prices and native log prices of a process whose only state
    is the log price ``log_s``, started at ``log32(s0)``."""

    def init_state(self, path_ids):
        return self.State(log_s=log32(self.s0).expand(path_ids.shape).clone())

    def prices(self, state):
        return exp32(state.log_s)

    def log_prices(self, state):
        return state.log_s


class LogVarianceMixin(LogPriceMixin):
    """State (log price, variance) started at (log32(s0), v0): Bates,
    HestonQE and BatesQE."""

    def init_state(self, path_ids):
        shape = path_ids.shape
        return self.State(log_s=log32(self.s0).expand(shape).clone(),
                          v=self.v0.expand(shape).clone())


class NormalDrawsMixin(DeviceMixin):
    """Default innovations: i.i.d. standard normals keyed by (global path
    id, draw index ``m = t * n_draws + d``), so streams are shard-invariant.
    Innovations are a tuple of per-dimension tensors shaped like
    ``path_ids``, float32 unless ``dtype`` asks for float64 (the JAX
    package's float64 draws, which multilevel Monte Carlo takes)."""

    def draws(self, seed, stream, path_ids, t, dtype=torch.float32):
        """One ``normal_draw`` call a dimension.  ``rng.normal.
        normal_matrix`` gives the same bits from one call, but its cipher
        temporaries are ``n_draws`` times the size (several int64 blocks
        of paths x n_draws live at once: ~GiBs for a 128-asset basket at
        2^20 paths), so only the LMM, whose K is small beside its
        operation count a step, takes it."""
        d0 = int(t) * self.n_draws
        return tuple(normal_draw(seed, stream, path_ids, (d0 + d) & MASK32,
                                 dtype)
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
