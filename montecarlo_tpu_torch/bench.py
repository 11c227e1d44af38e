"""Path-steps per second of the kernels, on the card.

``run_bench``: GBM through K1, the port's counterpart of the repo-root
``bench.py`` (which stays the JAX package's): ``reps`` K1 launches with
different seeds, chained by a data dependency (each adds its first price to
an accumulator), timed with CUDA events after a warm-up launch; then a
Black-Scholes sanity gate on a 1-year call at the same shape, so a fast
kernel that prices garbage fails.

``run_basket_bench``: correlated GBM baskets, the counterpart of
``experiments/basket_bench.py`` at its shapes and baskets, timed the same
way: K7 at A in {8, 16, 32, 64, 128} assets and K2 on BasketGBM at A in
{5, 8, 16}, one row each in path-steps/s and asset-steps/s.

Only a card gives these numbers: without one both raise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.engine.payoffs import black_scholes_call
from montecarlo_tpu_torch.ops.basket_kernel import packed_basket_terminal
from montecarlo_tpu_torch.ops.fused_engine import fused_terminal
from montecarlo_tpu_torch.ops.gbm_kernel import gbm_terminal
from montecarlo_tpu_torch.processes import GBM, BasketGBM


# The repo-root bench.py's shape: 2^20 paths x 1024 steps x 8 chained reps.
N_PATHS, N_STEPS, REPS = 1 << 20, 1024, 8
# experiments/basket_bench.py's: 2^18 paths x 512 steps x 4 chained reps.
BASKET_PATHS, BASKET_STEPS, BASKET_REPS = 1 << 18, 512, 4
K7_ASSETS, K2_ASSETS = (8, 16, 32, 64, 128), (5, 8, 16)


def chained_ms(fn, reps: int, device) -> float:
    """Milliseconds per call of ``fn(seed)`` over ``reps`` calls with
    different seeds, chained by a data dependency, by CUDA events after one
    warm-up call; raises on a non-finite result."""
    acc = torch.zeros((), dtype=torch.float32, device=device)
    acc += fn(1)[0]  # warm-up
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        acc += fn(1000 + i)[0]
    stop.record()
    torch.cuda.synchronize(device)
    if not math.isfinite(float(acc)):
        raise RuntimeError("benchmark produced a non-finite value")
    return start.elapsed_time(stop) / reps


def run_bench() -> dict:
    dev = resolve_device("cuda")
    n_paths, n_steps, reps = N_PATHS, N_STEPS, REPS
    # Maturity T = 1y folded into dt: the timed workload is also the
    # sanity-checked one.
    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / n_steps,
                      device=dev)
    ms_per_rep = chained_ms(
        lambda seed: gbm_terminal(proc, n_paths, n_steps, seed=seed), reps,
        dev)

    terminal = gbm_terminal(proc, n_paths, n_steps, seed=7)
    payoff = torch.clamp(terminal - 105.0, min=0.0)
    disc = math.exp(-0.03)
    price = disc * float(payoff.mean())
    se = disc * float(payoff.std(correction=0)) / math.sqrt(n_paths)
    bs = black_scholes_call(100.0, 105.0, 0.03, 0.2, 1.0)
    if not abs(price - bs) < 5 * se + 1e-3:
        raise RuntimeError(f"Black-Scholes gate failed: price {price}, "
                           f"bs {bs}, se {se}")
    return {
        "metric": "gbm_path_steps_per_sec",
        "value": n_paths * n_steps / (ms_per_rep * 1e-3),
        "unit": "path_steps/s",
        "ms_per_rep": ms_per_rep,
        "n_paths": n_paths, "n_steps": n_steps, "reps": reps,
        "price": price, "black_scholes": bs, "std_err": se,
        "device": torch.cuda.get_device_name(dev),
    }


def bench_basket(n_assets: int, seed: int = 0, device="cuda") -> BasketGBM:
    """``experiments/basket_bench.py``'s basket: spots, drifts and vols
    drawn from ``np.random.default_rng(seed)``, a random correlation
    matrix, equal weights, dt = 1/252."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n_assets, n_assets))
    corr = q @ q.T
    d = np.sqrt(np.diag(corr))
    return BasketGBM.create(
        s0=rng.uniform(50, 150, n_assets), mu=rng.uniform(0.0, 0.06, n_assets),
        sigma=rng.uniform(0.1, 0.4, n_assets), corr=corr / np.outer(d, d),
        weights=np.full(n_assets, 1.0 / n_assets), dt=1.0 / 252.0,
        device=device)


def run_basket_bench() -> list:
    """One row per (kernel, asset count): K7 (``packed_basket_terminal``)
    at K7_ASSETS, then K2 (``fused_terminal`` on BasketGBM) at K2_ASSETS,
    each at 2^18 paths x 512 steps x 4 chained reps."""
    dev = resolve_device("cuda")
    n, t = BASKET_PATHS, BASKET_STEPS
    runs = [("packed_basket_terminal", a, packed_basket_terminal)
            for a in K7_ASSETS]
    runs += [("fused_terminal", a, fused_terminal) for a in K2_ASSETS]
    rows = []
    for kernel, a_n, fn in runs:
        basket = bench_basket(a_n, device=dev)
        ms = chained_ms(lambda seed: fn(basket, n, t, seed=seed),
                        BASKET_REPS, dev)
        rate = n * t / (ms * 1e-3)
        rows.append({"kernel": kernel, "n_assets": a_n,
                     "path_steps_per_sec": rate,
                     "asset_steps_per_sec": a_n * rate, "ms_per_rep": ms,
                     "n_paths": n, "n_steps": t, "reps": BASKET_REPS,
                     "device": torch.cuda.get_device_name(dev)})
    return rows
