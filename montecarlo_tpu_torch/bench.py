"""GBM path-steps per second through K1, on the card.

The port's counterpart of the repo-root ``bench.py`` (which stays the JAX
package's): ``reps`` K1 launches with different seeds, chained by a data
dependency (each adds its first price to an accumulator), timed with CUDA
events after a warm-up launch; then a Black-Scholes sanity gate on a 1-year
call at the same shape, so a fast kernel that prices garbage fails.
Only a card gives these numbers: without one this raises.
"""

from __future__ import annotations

import math

import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.engine.payoffs import black_scholes_call
from montecarlo_tpu_torch.ops.gbm_kernel import gbm_terminal
from montecarlo_tpu_torch.processes import GBM


# The repo-root bench.py's shape: 2^20 paths x 1024 steps x 8 chained reps.
N_PATHS, N_STEPS, REPS = 1 << 20, 1024, 8


def run_bench() -> dict:
    dev = resolve_device("cuda")
    n_paths, n_steps, reps = N_PATHS, N_STEPS, REPS
    # Maturity T = 1y folded into dt: the timed workload is also the
    # sanity-checked one.
    proc = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1.0 / n_steps,
                      device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    acc += gbm_terminal(proc, n_paths, n_steps, seed=1)[0]  # warm-up
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        acc += gbm_terminal(proc, n_paths, n_steps, seed=1000 + i)[0]
    stop.record()
    torch.cuda.synchronize(dev)
    ms_per_rep = start.elapsed_time(stop) / reps
    if not math.isfinite(float(acc)):
        raise RuntimeError("benchmark produced a non-finite price")

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
