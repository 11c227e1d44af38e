"""Stress and scenario grids: reprice a payoff over bumps of two process
fields, under common random numbers.

The port of ``montecarlo_tpu/api/stress.py``.  The JAX package vmaps its
scan over the bumped processes; the port loops over the scenarios, and
each scenario's terminal prices go through ``engine.dispatch.
terminal_prices``: K2 on the card for a float32 run on a process the
kernels take (GBM, Heston, ...), the torch loop in the run's dtype
otherwise (a float64 run always: the kernels are float32).  Every
scenario is one seed and stream, so the P&L between scenarios carries no
noise of independent sampling.

A bump is relative: ``leaf * (1 + bump)``, the bump in the run's dtype and
the factor in the leaf's, as the JAX package computes it, on a new
process (``dataclasses.replace``; no leaf is changed in place, so the
kernels' launch leaves, cached per process, stay right).  The base
scenario is subtracted on the host, so its P&L is exactly 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from montecarlo_tpu_torch.engine.dispatch import terminal_prices


def _bumped(process, fields, ba, bb, dtype):
    """``process`` with ``fields[0] *= 1 + ba`` and ``fields[1] *= 1 +
    bb``."""
    def bump(name, b):
        leaf = getattr(process, name)
        one = 1.0 + torch.as_tensor(b, dtype=dtype, device=leaf.device)
        return leaf * one.to(leaf.dtype)

    return dataclasses.replace(process, **{fields[0]: bump(fields[0], ba),
                                           fields[1]: bump(fields[1], bb)})


def _prices(process, payoff_fn, n_paths, n_steps, pairs, seed, fields,
            discount, stream, dtype, prefer_fused):
    """The discounted mean payoff of each (ba, bb) scenario, a tensor."""
    disc = torch.as_tensor(discount, dtype=dtype, device=process.device)
    out = []
    for ba, bb in pairs:
        proc = _bumped(process, fields, ba, bb, dtype)
        terminal = terminal_prices(proc, n_paths, n_steps, seed=seed,
                                   stream=stream, dtype=dtype,
                                   prefer_fused=prefer_fused)
        out.append(disc * torch.mean(payoff_fn(terminal)))
    return torch.stack(out)


def stress_grid(process, payoff_fn, n_paths: int, n_steps: int, *,
                bumps_a, bumps_b, seed: int,
                fields: tuple = ("s0", "sigma"), discount=1.0,
                stream: int = 0, dtype=torch.float32,
                prefer_fused: bool = True) -> dict:
    """The price surface over the outer product of relative bumps
    ``bumps_a`` (to ``fields[0]``) and ``bumps_b`` (to ``fields[1]``).
    Returns ``prices`` (len(a), len(b)), ``pnl`` against the scenario
    nearest (0, 0), ``base_price`` and the bump axes, as numpy.
    ``prefer_fused=False`` takes the torch loop where K2 would run."""
    pairs = [(a, b) for a in np.asarray(bumps_a, np.float64)
             for b in np.asarray(bumps_b, np.float64)]
    prices = _prices(process, payoff_fn, n_paths, n_steps, pairs, seed,
                     tuple(fields), discount, stream, dtype, prefer_fused)
    prices = prices.cpu().numpy().reshape(len(bumps_a), len(bumps_b))
    ia = int(np.argmin(np.abs(np.asarray(bumps_a))))
    ib = int(np.argmin(np.abs(np.asarray(bumps_b))))
    base = prices[ia, ib]
    return {"prices": prices, "pnl": prices - base, "base_price": base,
            "bumps_a": np.asarray(bumps_a), "bumps_b": np.asarray(bumps_b)}


def ladder(lo: float, hi: float, n: int) -> np.ndarray:
    """A bump ladder from ``lo`` to ``hi`` holding the base scenario 0.0
    exactly (linspace leaves ~1e-17 at the center; an exact zero bump
    makes the base P&L exactly 0)."""
    g = np.linspace(lo, hi, n)
    g[np.isclose(g, 0.0, atol=1e-12)] = 0.0
    if not (g == 0.0).any():
        g = np.sort(np.append(g, 0.0))
    return g


def standard_scenarios() -> dict:
    """Named stress scenarios (relative spot, relative vol)."""
    return {
        "base": (0.0, 0.0),
        "spot_down_20": (-0.20, 0.0),
        "spot_down_10": (-0.10, 0.0),
        "spot_up_10": (0.10, 0.0),
        "spot_up_20": (0.20, 0.0),
        "vol_up_50": (0.0, 0.50),
        "vol_down_30": (0.0, -0.30),
        "crash": (-0.30, 1.00),
        "melt_up": (0.20, 0.40),
    }


def stress_report(process, payoff_fn, n_paths: int, n_steps: int, *,
                  seed: int, fields: tuple = ("s0", "sigma"),
                  discount=1.0, scenarios: dict | None = None,
                  stream: int = 0, dtype=torch.float32,
                  prefer_fused: bool = True) -> dict:
    """P&L of each named scenario (``standard_scenarios`` by default)
    against ``base`` (or the first)."""
    scen = scenarios if scenarios is not None else standard_scenarios()
    if not scen:
        return {"scenarios": {}, "base_price": float("nan")}
    names = list(scen)
    prices = _prices(process, payoff_fn, n_paths, n_steps,
                     [scen[k] for k in names], seed, tuple(fields),
                     discount, stream, dtype, prefer_fused).cpu().numpy()
    base = prices[names.index("base")] if "base" in names else prices[0]
    return {"scenarios": {k: {"price": float(p), "pnl": float(p - base)}
                          for k, p in zip(names, prices)},
            "base_price": float(base)}


__all__ = ["ladder", "standard_scenarios", "stress_grid", "stress_report"]
