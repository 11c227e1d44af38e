"""Dedicated run modes of the `price` subcommand, as in
``montecarlo_tpu/cli/pricing_modes.py``: the own-simulator processes (rough
Bergomi in this port) and the multi-asset max-call print their own JSON."""

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
