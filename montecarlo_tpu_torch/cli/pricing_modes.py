"""Dedicated run modes of the `price` subcommand, as in
``montecarlo_tpu/cli/pricing_modes.py``: the own-simulator processes (rough
Bergomi in this port), multilevel Monte Carlo and the multi-asset max-call
print their own JSON."""

from __future__ import annotations

import json


def run_rbergomi(args) -> int:
    """``price --process rbergomi``: European call/put under rough Bergomi
    (``--v0`` is xi0, ``--rho`` the spot-vol correlation), driftless with
    discounting by ``--rate``, through K5, the factor product and K6."""
    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.engine import (discount_factor, european_call,
                                             european_put, mc_estimate)
    from montecarlo_tpu_torch.processes import RoughBergomi, rbergomi_simulate

    if args.payoff not in ("call", "put"):
        raise SystemExit("--process rbergomi prices European call/put")
    if args.sampler != "plain":
        raise SystemExit("--process rbergomi uses its own "
                         "exact-covariance sampler; --sampler has no "
                         "effect there (remove it)")
    device = resolve_cli_device(args.device)
    model = RoughBergomi.create(
        s0=args.s0, xi0=args.v0, eta=args.eta, rho=args.rho, h=args.hurst,
        n_steps=args.steps, T=args.maturity, device=device)
    s_t = rbergomi_simulate(model, args.paths, seed=args.seed)
    payoff = european_call if args.payoff == "call" else european_put
    est = mc_estimate(payoff(s_t, args.strike),
                      discount_factor(args.rate, args.maturity))
    print(json.dumps({"price": float(est["price"]),
                      "std_err": float(est["std_err"]),
                      "n_paths": int(est["n_paths"]),
                      "hurst": args.hurst}))
    return 0


def run_mlmc(args) -> int:
    """``price --mlmc``: the European call or put to total RMSE
    ``--mlmc-rmse`` by adaptive multilevel Monte Carlo
    (``engine.mlmc.mlmc_estimate``, 4 steps at level 0, refinement 2) on
    the Euler GBM (``--process gbm``) or Heston; level 0 runs K2, the
    coupled levels the torch loop, in the JAX command's chunks of
    2^16 >> l paths on every device.  JSON: price, std_err, bias_est,
    rmse_est, n_levels, level_paths, cost_path_steps,
    vs_single_level_cost and, for the GBM call, black_scholes."""
    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.engine import (black_scholes_call,
                                             discount_factor, european_call,
                                             european_put)
    from montecarlo_tpu_torch.engine.mlmc import mlmc_estimate
    from montecarlo_tpu_torch.processes import EulerGBM, Heston

    if args.payoff not in ("call", "put"):
        raise SystemExit("--mlmc supports European call/put payoffs")
    if args.sampler != "plain":
        raise SystemExit("--mlmc uses its own coupled plain draws; "
                         "--sampler has no effect there (remove it)")
    device = resolve_cli_device(args.device)
    if args.process == "gbm":
        def make(n):
            return EulerGBM.create(args.s0, args.rate, args.sigma,
                                   args.maturity / n, device=device)
    elif args.process == "heston":
        def make(n):
            return Heston.create(s0=args.s0, v0=args.v0, mu=args.rate,
                                 kappa=args.kappa, theta=args.theta,
                                 xi=args.xi, rho=args.rho,
                                 dt=args.maturity / n, device=device)
    else:
        raise SystemExit("--mlmc supports gbm (Euler scheme) and heston")
    pay = european_call if args.payoff == "call" else european_put
    res = mlmc_estimate(make, lambda s: pay(s, args.strike),
                        target_rmse=args.mlmc_rmse, seed=args.seed,
                        n0_steps=4,
                        discount=float(discount_factor(args.rate,
                                                       args.maturity)))
    out = {"price": float(res["price"]),
           "std_err": float(res["std_err"]),
           "bias_est": float(res["bias_est"]),
           "rmse_est": float(res["rmse_est"]),
           "n_levels": res["n_levels"],
           "level_paths": [l.n_paths for l in res["levels"]],
           "cost_path_steps": res["cost_path_steps"],
           "vs_single_level_cost": res["single_level_cost_est"]
           / max(res["cost_path_steps"], 1.0)}
    if args.process == "gbm" and args.payoff == "call":
        out["black_scholes"] = black_scholes_call(
            args.s0, args.strike, args.rate, args.sigma, args.maturity)
    print(json.dumps(out))
    return 0


def run_max_call(args, dt, disc, device) -> int:
    """``price --payoff max-call``: the European best-of-A call (the
    Bermudan max-call benchmark family, Andersen-Broadie 2004) on
    ``--n-assets`` symmetric GBM assets with drift ``rate - div`` and one
    pairwise correlation, through the torch time loop on MultiGBM, as the
    JAX CLI runs its scan engine.  (The American half, LSM, comes with the
    pricing toolkit.)"""
    from montecarlo_tpu_torch.engine import max_call, mc_estimate, simulate

    if args.process != "gbm":
        raise SystemExit("--payoff max-call prices symmetric "
                         "multi-asset GBM (--process gbm)")
    if args.sampler != "plain":
        raise SystemExit("--payoff max-call uses plain Threefry "
                         "draws; --sampler has no effect there")
    proc = symmetric_multi_gbm(args, dt, device)
    terminal = simulate(proc, args.paths, args.steps, seed=args.seed)
    est = mc_estimate(max_call(terminal, args.strike), disc)
    print(json.dumps({"price": float(est["price"]),
                      "std_err": float(est["std_err"]),
                      "n_paths": int(est["n_paths"]),
                      "n_assets": args.n_assets}))
    return 0


def symmetric_multi_gbm(args, dt: float, device):
    """``--n-assets`` MultiGBM assets alike in spot (``--s0``), drift
    (``--rate`` less ``--div``) and vol (``--sigma``), with one pairwise
    correlation (``--asset-corr``): the max-call's and the worst-of note's
    underlyings."""
    import numpy as np

    from montecarlo_tpu_torch.processes import MultiGBM

    a = args.n_assets
    if a < 1:
        raise SystemExit("--n-assets must be >= 1")
    corr = np.full((a, a), args.asset_corr)
    np.fill_diagonal(corr, 1.0)
    return MultiGBM.create(s0=[args.s0] * a, mu=[args.rate - args.div] * a,
                           sigma=[args.sigma] * a, corr=corr, dt=dt,
                           device=device)
