"""Dedicated run modes of the `price` subcommand, as in
``montecarlo_tpu/cli/pricing_modes.py``: the own-simulator processes (rough
Bergomi in this port) print their own JSON."""

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
