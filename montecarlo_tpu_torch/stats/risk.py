"""Risk metrics over terminal Monte Carlo prices, with the reference's
formulas, keys and percent units (reference app.py:636-657).

The port of ``montecarlo_tpu/stats/risk.py``: percentiles by
:func:`~montecarlo_tpu_torch.stats.quantiles.percentile_linear` (numpy's
``linear`` method), everything else float32 reductions on the prices'
device.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.stats.quantiles import percentile_linear

#: Terminal-price percentile levels the reference reports (app.py:639).
TERMINAL_PERCENTILES = (1, 5, 10, 25, 50, 75, 90, 95, 99)
#: Per-time-step path percentile levels (app.py:644).
PATH_PERCENTILES = (5, 25, 50, 75, 95)


def terminal_statistics(final_prices: torch.Tensor, current_price) -> dict:
    """The reference's Monte Carlo statistics of (n_paths,) terminal
    prices: ``percentiles`` (p1..p99), ``expected_return``,
    ``expected_vol``, ``prob_profit``, ``var_95`` and ``cvar_95``, all in
    percent, as 0-d tensors."""
    s0 = torch.as_tensor(current_price, dtype=final_prices.dtype,
                         device=final_prices.device)
    qs = percentile_linear(final_prices, TERMINAL_PERCENTILES)
    percentiles = {f"p{p}": qs[i] for i, p in enumerate(TERMINAL_PERCENTILES)}
    p5 = percentiles["p5"]
    tail = final_prices <= p5
    tail_count = torch.clamp(tail.sum(), min=1)
    tail_mean = torch.where(tail, final_prices, 0.0).sum() / tail_count
    return {
        "percentiles": percentiles,
        "expected_return": (final_prices.mean() / s0 - 1.0) * 100.0,
        "expected_vol": final_prices.std(correction=0) / s0 * 100.0,
        "prob_profit": (final_prices > s0).to(final_prices.dtype).mean()
        * 100.0,
        "var_95": (s0 - p5) / s0 * 100.0,
        "cvar_95": (s0 - tail_mean) / s0 * 100.0,
    }


def path_percentiles(paths: torch.Tensor) -> dict:
    """Per-time-step percentile curves p5/25/50/75/95 of (n_steps + 1,
    n_paths) price paths (app.py:643-645): ``{"p5": (n_steps + 1,), ...}``."""
    qs = percentile_linear(paths, PATH_PERCENTILES, dim=1)
    return {f"p{p}": qs[i] for i, p in enumerate(PATH_PERCENTILES)}
