"""The reference's Monte Carlo entry point (reference app.py:586-657).

The port of ``montecarlo_tpu/api/montecarlo.py``.
``garch_monte_carlo(data, n_sims, n_days, current_price)`` takes the feature
dict (it reads ``log_ret`` and ``rvol_20``), runs the bootstrap GARCH(1,1)
and returns the reference's keys: ``paths``, ``final_prices``,
``percentiles`` (p1..p99), ``path_percentiles`` (p5..p95 curves),
``expected_return``, ``expected_vol``, ``prob_profit``, ``var_95``,
``cvar_95``.  The draws are seeded and counter-based, so a run repeats
bit for bit (the reference uses the unseeded global NumPy RNG, app.py:620).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.engine.dispatch import terminal_prices
from montecarlo_tpu_torch.engine.simulate import simulate
from montecarlo_tpu_torch.processes.garch import MIN_HISTORY, GARCHBootstrap
from montecarlo_tpu_torch.stats.risk import (path_percentiles,
                                             terminal_statistics)

#: Bins of the per-step histograms behind ``keep_paths=False``'s bands.
PATH_BINS = 2048


def garch_monte_carlo(data: Dict[str, np.ndarray], n_sims: int, n_days: int,
                      current_price: float, progress_callback=None,
                      seed: int = 0, keep_paths: bool = True,
                      fit_params: bool = False, antithetic: bool = False,
                      device="cuda") -> Optional[Dict]:
    """Bootstrap-GARCH Monte Carlo with the reference's result contract,
    on ``device`` (the card unless the caller asks for the CPU).

    Returns None with fewer than 100 return observations (app.py:594-595)
    or a non-finite initial variance.  ``keep_paths=True`` keeps the
    (n_days + 1, n_sims) path array from the torch time loop;
    ``keep_paths=False`` takes the terminal prices from K2 and the
    percentile curves from per-step histograms of a plain-draw run (as the
    JAX package does, also under ``antithetic``).  ``fit_params=True``
    fits omega/alpha/beta by Gaussian QMLE instead of the reference's
    fixed ones (app.py:601-603).  ``antithetic=True`` mirrors the bootstrap
    uniforms, u -> 1 - u (needs an even ``n_sims``).
    """
    dev = resolve_device(device)
    returns = np.asarray(data["log_ret"], np.float64)
    returns = returns[~np.isnan(returns)]
    if len(returns) < MIN_HISTORY:
        return None
    if progress_callback:
        progress_callback("Running Monte Carlo simulation...")

    var0 = float(np.asarray(data["rvol_20"])[-1]) ** 2 / 252.0
    if not np.isfinite(var0):
        return None  # never emit NaN risk
    garch_kw = {}
    if fit_params:
        from montecarlo_tpu_torch.processes.garch_fit import fit_garch

        est = fit_garch(returns, device=dev)
        garch_kw = dict(omega=est.omega, alpha=est.alpha, beta=est.beta)
    proc = GARCHBootstrap.create(returns, s0=current_price, var0=var0,
                                 device=dev, **garch_kw)

    sampler = None
    if antithetic:
        from montecarlo_tpu_torch.samplers import AntitheticSampler

        if n_sims % 2:
            raise ValueError("antithetic pairing needs an even n_sims")
        sampler = AntitheticSampler()
    if keep_paths:
        paths = simulate(proc, n_sims, n_days, seed=seed, mode="paths",
                         sampler=sampler)
        final_prices = paths[-1]
    else:
        paths = None
        final_prices = terminal_prices(proc, n_sims, n_days, seed=seed,
                                       sampler=sampler)

    stats = terminal_statistics(final_prices, current_price)
    out = {k: float(v) for k, v in stats.items() if k != "percentiles"}
    out["percentiles"] = {k: float(v)
                          for k, v in stats["percentiles"].items()}
    out["final_prices"] = final_prices.cpu().numpy()
    if keep_paths:
        out["path_percentiles"] = {k: v.cpu().numpy() for k, v in
                                   path_percentiles(paths).items()}
        out["paths"] = paths.cpu().numpy()
    else:
        from montecarlo_tpu_torch.engine.path_sketch import (
            path_histograms, percentiles_from_histograms)

        fp = out["final_prices"]
        span = float(fp.max() - fp.min()) + 1e-6
        lo = min(float(fp.min()), current_price) - 0.25 * span
        hi = max(float(fp.max()), current_price) + 0.25 * span
        hists = path_histograms(proc, n_sims, n_days, seed=seed, lo=lo,
                                hi=hi, bins=PATH_BINS)
        out["path_percentiles"] = percentiles_from_histograms(
            hists.cpu().numpy(), lo, hi)
    return out
