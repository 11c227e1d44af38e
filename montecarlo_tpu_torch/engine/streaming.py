"""The reference's risk keys from a histogram sketch and price moments.

Only ``risk_dict`` of ``montecarlo_tpu/engine/streaming.py`` so far: the
one place the VaR/CVaR formulas live, which
``api/var.py::portfolio_var_on_device`` calls.  The streaming estimator,
its checkpoints and the sharded paths come with the multi-device slice.
"""

from __future__ import annotations

import warnings

from montecarlo_tpu_torch.stats.quantiles import (HistogramSketch,
                                                  sketch_cdf, sketch_quantile,
                                                  sketch_quantile_std_err,
                                                  sketch_tail_mean_below)


def risk_dict(sk: HistogramSketch, *, mean: float, std: float,
              std_err: float, count: int, current_price: float) -> dict:
    """The reference risk keys (app.py:647-657) from a sketch plus price
    moments, with each estimate's two error sources: ``var_95_std_err``
    (sampling) and ``var_95_grid_err`` / ``cvar_95_grid_err`` (the grid,
    one bin width; CVaR adds the bin-midpoint half width), in percent of
    spot.  Warns when the grid error dominates: more paths stop helping,
    more bins do."""
    s0 = float(current_price)
    p = {f"p{q}": float(sketch_quantile(sk, float(q)))
         for q in (1, 5, 10, 25, 50, 75, 90, 95, 99)}
    tail_mean = float(sketch_tail_mean_below(sk, p["p5"]))
    bins = sk.counts.shape[0]
    width = float(sk.hi - sk.lo) / bins
    var_grid_err = width / s0 * 100.0
    cvar_grid_err = 1.5 * width / s0 * 100.0
    var_std_err = float(sketch_quantile_std_err(sk, 5.0)) / s0 * 100.0
    if var_std_err < var_grid_err:
        warnings.warn(
            f"VaR sampling std-err ({var_std_err:.3g}% of spot) is below "
            f"the sketch's deterministic grid resolution "
            f"({var_grid_err:.3g}% = one bin width): the estimate is "
            "grid-limited — increase bins (or narrow the lo/hi range) "
            "rather than adding paths", stacklevel=3)
    return {
        "percentiles": p,
        "expected_return": (mean / s0 - 1.0) * 100.0,
        "expected_vol": std / s0 * 100.0,
        "prob_profit": 100.0 * (1.0 - float(sketch_cdf(sk, s0))),
        "var_95": (s0 - p["p5"]) / s0 * 100.0,
        "var_95_std_err": var_std_err,
        "var_95_grid_err": var_grid_err,
        "cvar_95": (s0 - tail_mean) / s0 * 100.0,
        "cvar_95_grid_err": cvar_grid_err,
        "std_err": std_err,
        "n_paths": count,
        # Fraction of samples outside the grid: > 0 means the tail
        # quantiles and CVaR approximate that mass at the grid edge.
        "sketch_oob_fraction":
            (float(sk.underflow) + float(sk.overflow))
            / max(float(sk.total), 1.0),
    }
