"""`var` — portfolio VaR/CVaR at scale.

The port of ``montecarlo_tpu/cli/risk.py::var``, with the same flags and
defaults and the same JSON, on GBM.  By default it runs
``api.var.portfolio_var``'s stream (K2 chunks of at most 2^20 paths, the
sketch and block moments on the host, ``--checkpoint`` resumable,
progress on stderr); ``--on-device`` runs
``api.var.portfolio_var_on_device`` (K2 chunks, the sketch on the card).
``--ticker`` waits for the data and feature layer and exits non-zero with
a message naming the ROADMAP item.  ``stress`` is not ported.
"""

from __future__ import annotations

import json
import sys


def add_parsers(sub):
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
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")


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
