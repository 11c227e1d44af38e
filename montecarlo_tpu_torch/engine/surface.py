"""Model-implied volatility surfaces from one Monte Carlo run.

The port of ``montecarlo_tpu/engine/surface.py``.  :func:`price_snapshot`
latches the price at a fixed step inside the time loop's fold, so one run
gives the terminal prices of every maturity of a grid; European calls over
the (maturity, strike) grid are priced on the run's device and inverted by
``engine.implied_vol.implied_vol_call``:

    surface = mc_implied_vol_surface(proc, strikes, step_grid, dt, rate=...)

One run to the last maturity gives the grid: the last maturity is the
run's terminal and every one before it a snapshot.  On the kernel route
that run is the snapshot kernel (``ops.fused_engine.fused_snapshots``,
``csrc/fused_k4_snapshot.cu``), one launch for a grid of up to
``MAX_SNAPSHOTS`` + 1 maturities; a functor or draw source it is not
built for runs ``SNAPSHOT_CODE`` on K4's generic fold, four snapshots a
launch (``ops.fused_engine.k4_launches``).  The draws are keyed by (path,
step), so any split gives the bits of one long run.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlo_tpu_torch.engine.functionals import (SNAPSHOT_CODE,
                                                     DeviceForm,
                                                     PathFunctional,
                                                     simulate_functionals)
from montecarlo_tpu_torch.engine.implied_vol import implied_vol_call


def price_snapshot(step: int) -> PathFunctional:
    """Latch the price observed at step ``step`` (1-based; step 0 is the
    spot, the init value).  Its device form is ``DeviceForm(SNAPSHOT_CODE,
    step)`` at every step, 0 included."""
    step = int(step)
    if step < 0:
        raise ValueError(f"step={step} must be >= 0")
    form = DeviceForm(SNAPSHOT_CODE, step)
    if step == 0:
        return PathFunctional(init=lambda s: s,
                              update=lambda acc, s, t: acc,
                              finalize=lambda acc, n_steps: acc,
                              device=lambda n_steps: form)
    return PathFunctional(init=torch.zeros_like,
                          update=lambda acc, s, t: s if t == step else acc,
                          finalize=lambda acc, n_steps: acc,
                          device=lambda n_steps: form)


def snapshot_terminals(process, n_paths: int, steps, *, seed: int,
                       **sim_kw) -> torch.Tensor:
    """The (T, n_paths) prices at each step of the increasing grid
    ``steps``: one ``simulate_functionals`` run to the last step (the
    snapshot kernel on the kernel route) with a snapshot at each step
    before it, the last row its terminal."""
    funcs = {f"m{j}": price_snapshot(s) for j, s in enumerate(steps[:-1])}
    out = simulate_functionals(process, n_paths, steps[-1], seed=seed,
                               functionals=funcs, **sim_kw)
    return torch.stack([out[k] for k in funcs] + [out["terminal"]])


def mc_implied_vol_surface(process, strikes, step_grid, dt: float, *,
                           rate: float, n_paths: int = 1 << 17,
                           seed: int = 0, s0=None, **sim_kw) -> dict:
    """Black-Scholes implied-vol surface of a process's European calls.

    ``strikes`` (K,); ``step_grid`` strictly increasing steps >= 1, the
    maturity of entry j being ``step_grid[j] * dt`` years; ``rate`` the
    continuous discount rate (and the inversion's carry); ``s0`` the
    inversion's spot (default ``float(process.s0)``).  ``sim_kw`` goes to
    ``simulate_functionals`` (``stream``, ``sampler``, ``prefer_fused``).

    The (T, K) call prices are discounted means in float32 on the run's
    device, inverted in float64 on the host.  Returns ``{"ivs" (T, K),
    "prices" (T, K), "maturities" (T,), "strikes" (K,)}`` as float64
    numpy arrays, NaN where a price falls outside the no-arbitrage band.
    """
    steps = [int(s) for s in step_grid]
    if (not steps or steps[0] < 1
            or any(b <= a for a, b in zip(steps, steps[1:]))):
        raise ValueError("step_grid must be strictly increasing and >= 1")
    terms = snapshot_terminals(process, n_paths, steps, seed=seed, **sim_kw)
    spot = float(process.s0) if s0 is None else float(s0)
    strikes = np.asarray(strikes, np.float64)
    mats = np.asarray(steps, np.float64) * float(dt)
    f32 = dict(dtype=torch.float32, device=terms.device)
    discs = torch.exp(-rate * torch.tensor(mats, **f32))
    ks = torch.tensor(strikes, **f32)
    pay = torch.clamp(terms[:, :, None] - ks[None, None, :], min=0.0)
    prices = (discs[:, None] * torch.mean(pay, dim=1)).cpu().double()
    ivs = implied_vol_call(prices, spot, torch.from_numpy(strikes)[None, :],
                           rate, torch.from_numpy(mats)[:, None])
    return {"ivs": ivs.numpy(), "prices": prices.numpy(), "maturities": mats,
            "strikes": strikes}
