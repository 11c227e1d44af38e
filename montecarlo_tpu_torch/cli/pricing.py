"""`price` — European GBM option pricing through the port's engine.

The port of the vanilla branch of ``montecarlo_tpu/cli/pricing.py``: GBM,
the plain and antithetic samplers, call/put/digital payoffs, a fixed
``--paths`` estimate or ``--target-se`` tolerance pricing.  The output JSON
has the JAX CLI's keys: ``price``, ``std_err``, ``n_paths`` and, for the
call and the digital, ``black_scholes``.
"""

from __future__ import annotations

import json


def add_parsers(sub):
    p = sub.add_parser("price", help="Monte Carlo option pricing (GBM)")
    p.add_argument("--process", default="gbm", choices=["gbm"])
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=105.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--maturity", type=float, default=1.0, help="years")
    p.add_argument("--paths", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=252)
    p.add_argument("--sampler", default="plain",
                   choices=["plain", "antithetic"])
    p.add_argument("--payoff", default="call",
                   choices=["call", "put", "digital"])
    p.add_argument("--target-se", type=float, default=None,
                   help="price until the discounted std-err reaches this "
                        "target instead of a fixed --paths (--sampler plain)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")


def cmd_price(args) -> int:
    from montecarlo_tpu_torch.device import resolve_device
    from montecarlo_tpu_torch.engine import (
        VanillaPayoff, black_scholes_call, black_scholes_digital,
        discount_factor, mc_estimate, price_to_tolerance, terminal_prices)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.samplers import AntitheticSampler, PlainSampler

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e
    proc = GBM.create(s0=args.s0, mu=args.rate, sigma=args.sigma,
                      dt=args.maturity / args.steps, device=device)
    payoff = VanillaPayoff(args.payoff, args.strike)
    disc = float(discount_factor(args.rate, args.maturity))
    if args.target_se is not None:
        if args.sampler != "plain":
            raise SystemExit("--target-se supports --sampler plain (iid "
                             "chunked loop)")
        est = price_to_tolerance(
            proc, payoff, target_std_err=args.target_se, seed=args.seed,
            n_steps=args.steps, discount=disc,
            chunk_paths=(1 << 22) if device.type == "cuda" else (1 << 16))
    else:
        sampler = (AntitheticSampler() if args.sampler == "antithetic"
                   else PlainSampler())
        terminal = terminal_prices(proc, args.paths, args.steps,
                                   seed=args.seed, sampler=sampler)
        est = mc_estimate(payoff(terminal), disc)

    out = {"price": float(est["price"]), "std_err": float(est["std_err"]),
           "n_paths": int(est["n_paths"])}
    oracle = {"call": black_scholes_call,
              "digital": black_scholes_digital}.get(args.payoff)
    if oracle is not None:
        out["black_scholes"] = oracle(args.s0, args.strike, args.rate,
                                      args.sigma, args.maturity)
    print(json.dumps(out))
    return 0
