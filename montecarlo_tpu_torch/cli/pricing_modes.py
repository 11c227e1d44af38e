"""Dedicated run modes of the `price` subcommand, as in
``montecarlo_tpu/cli/pricing_modes.py``: the own-simulator processes (the
equity-Vasicek hybrid, rough Bergomi), multilevel Monte Carlo and the multi-asset max-call
print their own JSON; American exercise (``run_american``) returns its
estimate to the shared output, or prints the American Asian's."""

from __future__ import annotations

import json


def run_hybrid(args, dt) -> int:
    """``price --process hybrid``: the European call or put under GBM with a
    Vasicek short rate (exact joint transition, the discount in the state)
    on the torch loop; the call's closed form beside it."""
    import torch

    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.processes import (EquityVasicekHybrid,
                                                hybrid_call_closed_form,
                                                hybrid_price_mc)

    if args.american or args.payoff not in ("call", "put"):
        raise SystemExit("--process hybrid prices European call/put")
    if args.sampler != "plain":
        raise SystemExit("--process hybrid uses plain draws; remove "
                         "--sampler")
    device = resolve_cli_device(args.device)
    hyb = EquityVasicekHybrid.create(
        args.s0, args.rate, args.kappa, args.theta, args.sigma_r,
        args.sigma, args.rho, dt, device=device)
    pay = ((lambda s: torch.clamp(s - args.strike, min=0.0))
           if args.payoff == "call"
           else (lambda s: torch.clamp(args.strike - s, min=0.0)))
    est = hybrid_price_mc(hyb, pay, args.paths, args.steps, seed=args.seed)
    out = {"price": float(est["price"]),
           "std_err": float(est["std_err"]),
           "n_paths": int(est["n_paths"])}
    if args.payoff == "call":
        out["closed_form"] = hybrid_call_closed_form(
            args.s0, args.strike, args.maturity, args.rate, args.kappa,
            args.theta, args.sigma_r, args.sigma, args.rho)
    print(json.dumps(out))
    return 0


def run_rbergomi(args) -> int:
    """``price --process rbergomi``: European call/put under rough Bergomi
    (``--v0`` is xi0, ``--rho`` the spot-vol correlation), driftless with
    discounting by ``--rate``, through K5, the factor product and K6."""
    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.engine import (discount_factor, european_call,
                                             european_put, mc_estimate)
    from montecarlo_tpu_torch.processes import RoughBergomi, rbergomi_simulate

    if args.american or args.payoff not in ("call", "put"):
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

    if args.american or args.payoff not in ("call", "put"):
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
    JAX CLI runs its scan engine.  ``--american``: the Bermudan max-call
    over the ``--steps`` dates by multi-asset LSM (degree 3, value degree
    3); ``--american-bound`` adds the dual on min(paths, 4096) x 256 outer
    and inner paths at ``--seed`` + 1 (``upper_bound``,
    ``upper_bound_std_err``)."""
    from montecarlo_tpu_torch.engine import max_call, mc_estimate, simulate

    if args.process != "gbm":
        raise SystemExit("--payoff max-call prices symmetric "
                         "multi-asset GBM (--process gbm)")
    if args.sampler != "plain":
        raise SystemExit("--payoff max-call uses plain Threefry "
                         "draws; --sampler has no effect there")
    proc = symmetric_multi_gbm(args, dt, device)
    payoff = lambda p: max_call(p, args.strike)
    if args.american:
        from montecarlo_tpu_torch.engine.american import (
            andersen_broadie_bound_multi, lsm_policy_multi)

        kw = dict(rate=args.rate, dt=dt, degree=3, value_degree=3)
        est, policy = lsm_policy_multi(proc, payoff, args.paths, args.steps,
                                       seed=args.seed,
                                       fit_value=args.american_bound, **kw)
    else:
        terminal = simulate(proc, args.paths, args.steps, seed=args.seed)
        est = mc_estimate(payoff(terminal), disc)
    out = {"price": float(est["price"]), "std_err": float(est["std_err"]),
           "n_paths": int(est["n_paths"]), "n_assets": args.n_assets}
    if args.american and args.american_bound:
        ab = andersen_broadie_bound_multi(
            proc, payoff, policy, min(args.paths, 4096), 256, args.steps,
            seed=args.seed + 1, **kw)
        out["upper_bound"] = float(ab["upper"])
        out["upper_bound_std_err"] = float(ab["std_err"])
    print(json.dumps(out))
    return 0


#: The stochastic-vol processes, priced on the joint (spot, variance) LSM.
SV_PROCESSES = ("heston", "heston-qe", "bates", "bates-qe", "slv")


def run_american(args, proc, dt):
    """``price --american``: LSM on the spot (degree 3), on the joint
    (spot, variance) state for the stochastic-vol processes (degree 2,
    value degree 5) or on (spot, running average) for ``--payoff asian``
    (degree 2), with JAX's sizes for ``--american-bound``'s dual at
    ``--seed`` + 1: min(paths, 4096) x 512 (SV min(paths, 2048) x 256).
    Returns the exit code when it printed the Asian's JSON itself, else
    the estimate (with ``upper_bound`` and ``upper_bound_std_err`` under
    ``--american-bound``)."""
    import torch

    from montecarlo_tpu_torch.engine.american import (
        andersen_broadie_bound, andersen_broadie_bound_sv, lsm_policy,
        lsm_policy_sv, lsm_price_path_dependent)
    from montecarlo_tpu_torch.engine.functionals import ARITH_MEAN

    if args.sampler != "plain":
        raise SystemExit("--american uses plain Threefry draws; "
                         "--sampler has no effect there (remove it)")
    k = args.strike
    if args.payoff == "asian":
        # The American average-price call: LSM on the joint (spot, running
        # average) state (Longstaff-Schwartz 2001 sec. 5).
        if args.american_bound:
            raise SystemExit("--american-bound covers call/put only")
        est = lsm_price_path_dependent(
            proc, lambda s, a: torch.clamp(a - k, min=0.0), ARITH_MEAN,
            args.paths, args.steps, seed=args.seed, rate=args.rate, dt=dt,
            degree=2)
        print(json.dumps({"price": float(est["price"]),
                          "std_err": float(est["std_err"]),
                          "n_paths": int(est["n_paths"])}))
        return 0
    if args.payoff not in ("call", "put"):
        raise SystemExit(
            f"--american supports call/put exercise (or asian via the "
            f"path-dependent LSM), not {args.payoff!r}")
    payoff = ((lambda s: torch.clamp(s - k, min=0.0)) if args.payoff == "call"
              else (lambda s: torch.clamp(k - s, min=0.0)))
    kw = dict(rate=args.rate, dt=dt)
    if args.process in SV_PROCESSES:
        kw.update(degree=2, value_degree=5)
        est, policy = lsm_policy_sv(proc, payoff, args.paths, args.steps,
                                    seed=args.seed, **kw)
        bound, outer, inner = andersen_broadie_bound_sv, 2048, 256
    else:
        kw.update(degree=3)
        est, policy = lsm_policy(proc, payoff, args.paths, args.steps,
                                 seed=args.seed, **kw)
        bound, outer, inner = andersen_broadie_bound, 4096, 512
    if args.american_bound:
        ab = bound(proc, payoff, policy, min(args.paths, outer), inner,
                   args.steps, seed=args.seed + 1, **kw)
        est = {**est, "upper_bound": ab["upper"],
               "upper_bound_std_err": ab["std_err"]}
    return est


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
