"""`greeks` — option sensitivities on GBM and Heston.

The port of ``montecarlo_tpu/cli/greeks.py`` with its flags, defaults and
JSON keys: ``--method pathwise`` (reverse mode through the torch time
loop, ``engine.greeks.price_and_greeks``), ``lr`` (likelihood ratio on
GBM, its terminal prices through K2), ``second-order`` (gamma, vanna and
volga of the smoothed call), ``--mesh N`` (pathwise greeks over a mesh
of N ranks, ``sharded_price_and_greeks``) and ``--american`` (policy-frozen
American greeks, pathwise on a call or put: ``lsm_exercise_policy`` fits
the exercise rule, ``american_price_and_greeks`` differentiates the
stopped value on a fresh stream).  ``--device cuda`` (the default; an error without a card) or ``cpu`` (the
kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import json
import sys


def add_parsers(sub):
    p = sub.add_parser("greeks", help="option sensitivities")
    p.add_argument("--process", default="gbm", choices=["gbm", "heston"])
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=105.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--paths", type=int, default=200_000)
    p.add_argument("--steps", type=int, default=252)
    p.add_argument("--payoff", default="call", choices=["call", "put",
                                                        "digital"])
    p.add_argument("--method", default="pathwise",
                   choices=["pathwise", "lr", "second-order"],
                   help="pathwise autodiff (Lipschitz payoffs), "
                        "likelihood-ratio (any payoff, GBM only), or "
                        "second-order (gamma/vanna/volga via double "
                        "autodiff of a kernel-smoothed payoff)")
    p.add_argument("--smooth-width", type=float, default=2.0,
                   help="payoff smoothing width for --method second-order "
                        "(price units; bias O(w^2), gamma noise O(1/w))")
    p.add_argument("--american", action="store_true",
                   help="American-exercise Greeks by policy freezing: LSM "
                        "fits the exercise rule, then pathwise-"
                        "differentiates the frozen stopped value "
                        "(envelope theorem; call/put, pathwise method)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="pathwise greeks over a mesh of N ranks "
                        "(sharded_price_and_greeks: price, grads and error "
                        "bars bitwise the same on any mesh); pathwise "
                        "method only")
    # Heston extras
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=-0.7)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")


def _payoff(args):
    import torch

    k = args.strike
    if args.payoff == "call":
        return lambda s: torch.clamp(s - k, min=0.0)
    if args.payoff == "put":
        return lambda s: torch.clamp(k - s, min=0.0)
    return lambda s: (s > k).to(torch.float32)


def _fields(grads) -> dict:
    return {f.name: float(getattr(grads, f.name))
            for f in dataclasses.fields(grads)}


def _mesh_greeks(args, proc, payoff, disc, device) -> dict:
    import torch.distributed as dist

    from montecarlo_tpu_torch.parallel import (DEFAULT_BLOCK, make_mesh,
                                               sharded_price_and_greeks)

    n_ranks = (dist.get_world_size()
               if dist.is_available() and dist.is_initialized() else 1)
    if args.mesh > n_ranks:
        raise SystemExit(
            f"--mesh {args.mesh}: only {n_ranks} rank(s) in the process "
            "group (start the ranks with torch.distributed; the test suite "
            "holds meshes of 1, 2 and 4 gloo ranks)")
    unit = args.mesh * DEFAULT_BLOCK
    n_paths = -(-args.paths // unit) * unit
    if n_paths != args.paths:
        print(f"note: paths rounded up to {n_paths} "
              f"(mesh x {DEFAULT_BLOCK}-path stat blocks)", file=sys.stderr)
    res = sharded_price_and_greeks(
        proc, payoff, n_paths, args.steps, seed=args.seed,
        mesh=make_mesh(args.mesh, device=device), discount=disc)
    out = {"price": float(res["price"]), "std_err": float(res["std_err"]),
           "n_paths": int(res["n_paths"]), "mesh": args.mesh}
    out.update({f"d_{k}": v for k, v in _fields(res["grads"]).items()})
    out.update({f"d_{k}_std_err": v
                for k, v in _fields(res["grad_std_err"]).items()})
    return out


def _american_greeks(args, proc, payoff, dt) -> dict:
    """Policy-frozen American price and greeks (degree 3, the exercise
    rule fitted on the pricing paths' seed): price and delta, with vega
    and the drift sensitivity on GBM, d/dv0 and d/dxi on Heston."""
    from montecarlo_tpu_torch.engine.american import (
        american_price_and_greeks, lsm_exercise_policy)

    if args.method != "pathwise" or args.payoff == "digital":
        raise SystemExit("--american greeks use the pathwise method on "
                         "call/put payoffs")
    kw = dict(seed=args.seed, rate=args.rate, dt=dt, degree=3)
    policy = lsm_exercise_policy(proc, payoff, args.paths, args.steps, **kw)
    price, g = american_price_and_greeks(proc, payoff, policy, args.paths,
                                         args.steps, **kw)
    out = {"price": float(price), "delta": float(g.s0)}
    if args.process == "gbm":
        out.update(vega=float(g.sigma), drift_sens=float(g.mu))
    else:
        out.update(vega_v0=float(g.v0), xi_sens=float(g.xi))
    return out


def cmd_greeks(args) -> int:
    import math

    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.engine.greeks import (lr_greeks_gbm,
                                                    price_and_greeks,
                                                    second_order_greeks,
                                                    smoothed_call)
    from montecarlo_tpu_torch.processes import GBM, Heston

    if args.mesh and (args.method != "pathwise" or args.american):
        # Reject rather than silently ignore.
        raise SystemExit("--mesh applies to the pathwise method only "
                         "(not --method lr/second-order, not --american)")
    device = resolve_cli_device(args.device)
    dt = args.maturity / args.steps
    disc = math.exp(-args.rate * args.maturity)
    payoff = _payoff(args)
    if args.process == "gbm":
        proc = GBM.create(s0=args.s0, mu=args.rate, sigma=args.sigma, dt=dt,
                          device=device)
    else:
        proc = Heston.create(s0=args.s0, v0=args.v0, mu=args.rate,
                             kappa=args.kappa, theta=args.theta, xi=args.xi,
                             rho=args.rho, dt=dt, device=device)

    if args.american:
        print(json.dumps(_american_greeks(args, proc, payoff, dt)))
        return 0

    if args.method == "lr":
        if args.process != "gbm":
            print("likelihood-ratio greeks support GBM only",
                  file=sys.stderr)
            return 2
        out = lr_greeks_gbm(proc, payoff, args.paths, args.steps,
                            seed=args.seed, discount=disc)
        print(json.dumps({k: float(v) for k, v in out.items()}))
        return 0

    if args.method == "second-order":
        if args.payoff != "call":
            print("second-order greeks use the smoothed call payoff",
                  file=sys.stderr)
            return 2
        sfields = ("s0", "sigma") if args.process == "gbm" else ("s0", "v0")
        price, grad, hess = second_order_greeks(
            proc, smoothed_call(args.strike, args.smooth_width), args.paths,
            args.steps, seed=args.seed, fields=sfields, discount=disc)
        print(json.dumps({"price": float(price), "delta": float(grad[0]),
                          f"vega_{sfields[1]}": float(grad[1]),
                          "gamma": float(hess[0, 0]),
                          "vanna": float(hess[0, 1]),
                          "volga": float(hess[1, 1])}))
        return 0

    if args.payoff == "digital":
        print("note: pathwise gradients of a hard digital are ~0; use "
              "--method lr or a smoothed payoff", file=sys.stderr)
    if args.mesh:
        print(json.dumps(_mesh_greeks(args, proc, payoff, disc, device)))
        return 0
    price, grads = price_and_greeks(proc, payoff, args.paths, args.steps,
                                    seed=args.seed, discount=disc)
    out = {"price": float(price)}
    out.update({f"d_{k}": v for k, v in _fields(grads).items()})
    print(json.dumps(out))
    return 0
