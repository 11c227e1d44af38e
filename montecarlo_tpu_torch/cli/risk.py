"""`var` and `stress` — portfolio VaR/CVaR at scale, and scenario-grid and
named-stress P&L under common random numbers.

The port of ``montecarlo_tpu/cli/risk.py``, with the same flags and
defaults and the same JSON.  ``var`` on GBM: by default
``api.var.portfolio_var``'s stream (K2 chunks of at most 2^20 paths, the
sketch and block moments on the host, ``--checkpoint`` resumable,
progress on stderr); ``--on-device`` runs
``api.var.portfolio_var_on_device`` (K2 chunks, the sketch on the card).
``--ticker`` waits for the data and feature layer and exits non-zero with
a message naming the ROADMAP item.  ``stress`` on GBM (spot and sigma
bumped) or Heston (spot and v0 bumped), float32: the nine named scenarios
(``api.stress.stress_report``) and, unless ``--grid 0``, the ``--grid`` x
``--grid`` ladder (``stress_grid``), each scenario's terminal prices
through K2 (34 launches at the default ``--grid 5``).
"""

from __future__ import annotations

import json
import sys


def add_parsers(sub):
    _add_var(sub)
    _add_stress(sub)


def _device_flag(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")


def _add_var(sub):
    p = sub.add_parser("var", help="portfolio VaR/CVaR at scale")
    p.add_argument("--paths", type=int, default=1 << 22)
    p.add_argument("--days", type=int, default=20)
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--mu", type=float, default=0.05)
    p.add_argument("--sigma", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bins", type=int, default=8192)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="npz path for resume-able runs")
    p.add_argument("--on-device", action="store_true",
                   help="single device program (fastest; no checkpointing)")
    p.add_argument("--ticker", default=None,
                   help="use a ticker's GARCH-bootstrap process instead of "
                        "parametric GBM (not ported yet)")
    p.add_argument("--period", default="5y")
    p.add_argument("--provider", default=None)
    _device_flag(p)


def cmd_var(args) -> int:
    from montecarlo_tpu_torch.api import (portfolio_var,
                                          portfolio_var_on_device)
    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.processes import GBM

    if args.ticker:
        raise SystemExit("var --ticker needs the data and feature layer, "
                         "which the port has not yet (ROADMAP Queue 1 item "
                         "12); run var on GBM")
    device = resolve_cli_device(args.device)
    s0 = args.s0
    proc = GBM.create(s0=s0, mu=args.mu, sigma=args.sigma, dt=1 / 252,
                      device=device)
    chunk = args.chunk or min(args.paths, 1 << 20)
    if args.on_device:
        out = portfolio_var_on_device(
            proc, args.paths, args.days, s0, seed=args.seed, bins=args.bins,
            chunk_paths=chunk)
    else:
        out = portfolio_var(
            proc, args.paths, args.days, s0, seed=args.seed, bins=args.bins,
            chunk_paths=chunk, checkpoint_path=args.checkpoint,
            progress_callback=lambda done, total, se: print(
                f"  {done:,}/{total:,} paths, std-err {se:.2e}",
                file=sys.stderr))
    print(json.dumps(out, default=float))
    return 0


def _add_stress(sub):
    p = sub.add_parser("stress", help="scenario grid / named stress P&L")
    p.add_argument("--process", default="gbm", choices=["gbm", "heston"])
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=105.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--paths", type=int, default=65536)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--payoff", default="call", choices=["call", "put"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spot-range", type=float, default=0.2,
                   help="grid spans +-this relative spot bump")
    p.add_argument("--vol-range", type=float, default=0.5,
                   help="grid spans +-this relative vol bump")
    p.add_argument("--grid", type=int, default=5,
                   help="points per axis (0 = named scenarios only)")
    # Heston extras
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=-0.7)
    _device_flag(p)


def cmd_stress(args) -> int:
    import numpy as np
    import torch

    from montecarlo_tpu_torch.api.stress import (ladder, stress_grid,
                                                 stress_report)
    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.processes import GBM, Heston

    device = resolve_cli_device(args.device)
    dt = args.maturity / args.steps
    disc = float(np.exp(-args.rate * args.maturity))
    payoff = ((lambda s: torch.clamp(s - args.strike, min=0.0))
              if args.payoff == "call"
              else (lambda s: torch.clamp(args.strike - s, min=0.0)))
    if args.process == "gbm":
        proc = GBM.create(s0=args.s0, mu=args.rate, sigma=args.sigma, dt=dt,
                          device=device)
        fields = ("s0", "sigma")
    else:
        proc = Heston.create(s0=args.s0, v0=args.v0, mu=args.rate,
                             kappa=args.kappa, theta=args.theta, xi=args.xi,
                             rho=args.rho, dt=dt, device=device)
        fields = ("s0", "v0")

    out = stress_report(proc, payoff, args.paths, args.steps,
                        seed=args.seed, fields=fields, discount=disc)
    if args.grid > 0:
        g = stress_grid(proc, payoff, args.paths, args.steps,
                        bumps_a=ladder(-args.spot_range, args.spot_range,
                                       args.grid),
                        bumps_b=ladder(-args.vol_range, args.vol_range,
                                       args.grid),
                        seed=args.seed, fields=fields, discount=disc)
        out["grid"] = {
            "spot_bumps": [float(v) for v in g["bumps_a"]],
            "vol_bumps": [float(v) for v in g["bumps_b"]],
            "prices": g["prices"].round(6).tolist(),
            "pnl": g["pnl"].round(6).tolist(),
        }
    print(json.dumps(out))
    return 0
