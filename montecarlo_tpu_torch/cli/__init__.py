"""Command-line interface of the port.

Subcommands:
  price — European GBM option pricing (fixed --paths or --target-se),
          --device cuda (default) or cpu
  bench — GBM path-steps/s through the K1 kernel at 2^20 paths x 1024
          steps x 8 chained reps, on the card

Usage: python -m montecarlo_tpu_torch <subcommand> [flags]
"""

from __future__ import annotations

import argparse
import json


def _run_bench(args) -> int:
    from montecarlo_tpu_torch.bench import run_bench

    print(json.dumps(run_bench()))
    return 0


def main(argv=None) -> int:
    from montecarlo_tpu_torch.cli import pricing

    parser = argparse.ArgumentParser(
        prog="montecarlo_tpu_torch",
        description="PyTorch/CUDA port of the Monte Carlo framework")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pricing.add_parsers(sub)
    sub.add_parser("bench", help="GBM path-steps/s through K1 at 2^20 "
                   "paths x 1024 steps x 8 reps (CUDA)")
    args = parser.parse_args(argv)
    handlers = {"price": pricing.cmd_price, "bench": _run_bench}
    return handlers[args.cmd](args)
