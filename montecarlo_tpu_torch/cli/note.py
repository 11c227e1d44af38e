"""`note` — structured notes: the autocallable (Phoenix; worst-of with
``--n-assets > 1``) and the cliquet.

The port of ``montecarlo_tpu/cli/note.py``: GBM with drift ``rate - div``
and the note folded into the time loop as one functional (K4); the worst-of
autocallable on ``--n-assets`` symmetric MultiGBM assets with one pairwise
correlation, through the torch time loop (``prefer_fused=False``: no kernel
runs a multi-asset state, as in the JAX package); the JAX CLI's output
keys.
"""

from __future__ import annotations

import json


def add_parsers(sub):
    p = sub.add_parser("note", help="structured notes: autocallable "
                                    "(Phoenix) and cliquet, single- or "
                                    "multi-asset (worst-of)")
    p.add_argument("--type", default="autocall",
                   choices=["autocall", "cliquet"])
    p.add_argument("--n-assets", type=int, default=1,
                   help="autocall: >1 prices the WORST-OF note")
    p.add_argument("--asset-corr", type=float, default=0.6,
                   help="common pairwise correlation (n-assets > 1)")
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--div", type=float, default=0.0,
                   help="continuous dividend yield")
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--observations", type=int, default=4,
                   help="autocall observations / cliquet resets per life")
    p.add_argument("--steps", type=int, default=252,
                   help="simulation steps (rounded to a multiple of "
                        "observations)")
    p.add_argument("--trigger", type=float, default=1.0,
                   help="autocall trigger as a fraction of s0")
    p.add_argument("--coupon", type=float, default=0.02,
                   help="autocall coupon per observation period")
    p.add_argument("--pdi-barrier", type=float, default=0.7,
                   help="down-and-in capital barrier as a fraction of s0")
    p.add_argument("--local-floor", type=float, default=-0.02,
                   help="cliquet per-period floor")
    p.add_argument("--local-cap", type=float, default=0.03,
                   help="cliquet per-period cap")
    p.add_argument("--global-floor", type=float, default=0.0,
                   help="cliquet floor on the summed leg")
    p.add_argument("--paths", type=int, default=1 << 17)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")


def cmd_note(args) -> int:
    import math

    import torch

    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.cli.pricing_modes import symmetric_multi_gbm
    from montecarlo_tpu_torch.engine import (autocallable, cliquet_sum,
                                             mc_estimate,
                                             simulate_functionals,
                                             worst_of_autocallable)
    from montecarlo_tpu_torch.processes import GBM

    device = resolve_cli_device(args.device)
    period = max(args.steps // args.observations, 1)
    n_steps = period * args.observations
    dt = args.maturity / n_steps
    r_dt = args.rate * dt
    one_asset = args.type == "cliquet" or args.n_assets == 1
    if one_asset:
        proc = GBM.create(s0=args.s0, mu=args.rate - args.div,
                          sigma=args.sigma, dt=dt, device=device)
    else:
        proc = symmetric_multi_gbm(args, dt, device)

    if args.type == "cliquet":
        out = simulate_functionals(
            proc, args.paths, n_steps, seed=args.seed,
            functionals={"leg": cliquet_sum(period, args.local_floor,
                                            args.local_cap)})
        pay = torch.clamp(out["leg"], min=args.global_floor)
        est = mc_estimate(pay, math.exp(-args.rate * args.maturity))
        print(json.dumps({"cliquet_leg": float(est["price"]),
                          "std_err": float(est["std_err"]),
                          "n_paths": int(est["n_paths"]),
                          "periods": args.observations}))
        return 0

    if one_asset:
        fn = autocallable(period, args.trigger * args.s0, args.coupon, r_dt,
                          args.pdi_barrier * args.s0, args.s0)
    else:
        fn = worst_of_autocallable(period, args.trigger, args.coupon, r_dt,
                                   args.pdi_barrier,
                                   [args.s0] * args.n_assets)
    out = simulate_functionals(proc, args.paths, n_steps, seed=args.seed,
                               functionals={"note": fn},
                               prefer_fused=one_asset)
    # The functional returns the pathwise-DISCOUNTED payoff already.
    est = mc_estimate(out["note"], 1.0)
    print(json.dumps({"autocall_note": float(est["price"]),
                      "std_err": float(est["std_err"]),
                      "n_paths": int(est["n_paths"]),
                      "n_assets": args.n_assets,
                      "observations": args.observations}))
    return 0
