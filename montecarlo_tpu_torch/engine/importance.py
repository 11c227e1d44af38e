"""Importance and stratified sampling for GBM.

The port of ``montecarlo_tpu/engine/importance.py``.  Deep out-of-the-money
payoffs starve plain Monte Carlo.  Sampling under a drift-shifted measure
pushes paths into the payoff region, and each path is reweighted by the
Radon-Nikodym derivative, an exact function of the terminal price for GBM:

    sample under  mu' = mu + c sigma / sqrt(dt)   (z -> z + c per step)
    weight(S_T) = exp(-c Z - T_steps c^2 / 2),
    Z = (ln(S_T / S0) - T_steps (mu' - sigma^2 / 2) dt) / (sigma sqrt(dt))

so K2 runs the shifted process unmodified (``engine.dispatch.
terminal_prices``) and the weighting happens on the terminal prices.
:func:`shift_to_strike` aims the terminal median at the strike.
:func:`stratified_terminal_estimate` stratifies GBM's terminal normal.
"""

from __future__ import annotations

import torch

from montecarlo_tpu_torch.engine.dispatch import terminal_prices
from montecarlo_tpu_torch.processes.gbm import GBM
from montecarlo_tpu_torch.rng.normal import uniform_draw
from montecarlo_tpu_torch.stats.welford import moments_from_array, std_error

F32 = torch.float32
#: The stratification's uniform stream (JAX's).
STRATA_STREAM = 0x5742


def shift_to_strike(process: GBM, strike, n_steps: int) -> torch.Tensor:
    """Per-step shift c that moves the terminal median onto the strike."""
    t_total = process.dt * n_steps
    drift_med = (process.mu - 0.5 * torch.square(process.sigma)) * t_total
    k = torch.as_tensor(strike, dtype=F32, device=process.device)
    gap = torch.log(k / process.s0) - drift_med
    # gap = c * sigma * sqrt(dt) * n_steps
    return gap / (process.sigma * torch.sqrt(process.dt) * n_steps)


def stratified_terminal_estimate(process: GBM, payoff_fn, n_paths: int, *,
                                 seed: int, t_years, discount=1.0,
                                 n_replicates: int = 16) -> dict:
    """Stratified sampling of GBM's terminal law, for European payoffs:
    stratum i draws ``u_i = (i + v_i) / N`` (``v_i`` a counter-based
    uniform on stream 0x5742), ``z = ndtri(u)`` and ``S_T = S0 exp((mu -
    sigma^2/2) T + sigma sqrt(T) z)``, so every stratum is hit once.  The
    inverse normal is ``torch.special.ndtri`` (JAX's is
    ``jax.scipy.special.ndtri``, not the kernels' ``ndtri32``).

    The standard error comes from ``n_replicates`` interleaved
    replications (strata i mod K form replicate k).  float32, as the port
    runs: more than 2^24 paths are refused, since float32 cannot index the
    strata exactly (JAX takes them in float64).  Returns ``{"price",
    "std_err", "n_paths"}``."""
    if n_paths % n_replicates:
        raise ValueError(
            f"n_paths={n_paths} must be divisible by "
            f"n_replicates={n_replicates} (interleaved replication)")
    if n_paths > 1 << 24:
        raise ValueError(
            "stratification beyond 2^24 paths needs float64, which the port "
            "does not run (float32 cannot index the strata exactly)")
    dev = process.device
    ids = torch.arange(n_paths, dtype=torch.int64, device=dev)
    v = uniform_draw(seed, STRATA_STREAM, ids, 0)
    n = torch.tensor(float(n_paths), dtype=F32, device=dev)
    u = (ids.to(F32) + v) / n
    z = torch.special.ndtri(torch.clamp(u, 1e-7, 1.0 - 1e-7))
    t = torch.as_tensor(t_years, dtype=F32, device=dev)
    s_t = process.s0 * torch.exp(
        (process.mu - 0.5 * torch.square(process.sigma)) * t
        + process.sigma * torch.sqrt(t) * z)
    vals = payoff_fn(s_t) * torch.as_tensor(discount, dtype=F32, device=dev)
    price = torch.mean(vals)
    rep_means = torch.mean(vals.reshape(n_paths // n_replicates,
                                        n_replicates), dim=0)
    se = torch.std(rep_means, correction=1) / torch.sqrt(
        torch.tensor(float(n_replicates), dtype=F32, device=dev))
    return {"price": price, "std_err": se, "n_paths": n_paths}


def importance_sampled_estimate(process: GBM, payoff_fn, n_paths: int,
                                n_steps: int, *, seed: int, shift,
                                discount=1.0, stream: int = 0) -> dict:
    """IS estimator: the drift-shifted GBM through K2 (its plain version on
    the CPU), reweighted.  Returns ``{"price", "std_err", "n_paths",
    "ess"}``, ``ess`` the effective sample size (sum w)^2 / sum w^2, a
    health check of the shift."""
    dev = process.device
    c = torch.as_tensor(shift, dtype=F32, device=dev)
    sigma = process.sigma
    sq_dt = torch.sqrt(process.dt)
    # Shifting every z by c adds c sigma sqrt(dt) per log-step.
    shifted = GBM(s0=process.s0, mu=process.mu + c * sigma / sq_dt,
                  sigma=process.sigma, dt=process.dt)
    terminal = terminal_prices(shifted, n_paths, n_steps, seed=seed,
                               stream=stream)
    t_steps = torch.tensor(float(n_steps), dtype=F32, device=dev)
    drift_s = (shifted.mu - 0.5 * torch.square(shifted.sigma)) * shifted.dt
    z_total = ((torch.log(terminal / process.s0) - t_steps * drift_s)
               / (sigma * sq_dt))
    # The product over steps of exp(-c z' + c^2/2), z' the raw shifted
    # draw, with z_total = sum z' - T c centred under the shifted drift:
    # exp(-c (z_total + T c) + T c^2 / 2) = exp(-c z_total - T c^2 / 2).
    log_w = -c * z_total - 0.5 * t_steps * torch.square(c)
    w = torch.exp(log_w)
    st = moments_from_array(payoff_fn(terminal) * w, axis=0)
    d = torch.as_tensor(discount, dtype=F32, device=dev)
    ess = torch.square(torch.sum(w)) / torch.clamp(
        torch.sum(torch.square(w)), min=1e-30)
    return {"price": d * st.mean, "std_err": d * std_error(st),
            "n_paths": n_paths, "ess": ess}
