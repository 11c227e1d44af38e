"""Command-line interface of the port.

Subcommands:
  price — European option pricing on GBM or Heston: vanilla payoffs (fixed
          --paths or --target-se) and Asian, lookback, up-and-out/in
          (--bridge); rough-Bergomi call/put (--process rbergomi --hurst
          --eta); --device cuda (default) or cpu
  price --payoff max-call — the best-of-A call on correlated GBM
          (--n-assets --asset-corr --div)
  price --mlmc — multilevel Monte Carlo to --mlmc-rmse on Euler GBM or
          Heston (level 0 through K2)
  price --american — American exercise by Longstaff-Schwartz (call/put,
          the Asian on (spot, average), the SV processes on (spot,
          variance), the max-call); --american-bound adds the
          Andersen-Broadie dual upper bound
  note  — structured notes: autocallable (worst-of with --n-assets > 1)
          and cliquet
  bench — GBM path-steps/s through the K1 kernel at 2^20 paths x 1024
          steps x 8 chained reps, on the card; --basket: correlated-basket
          path-steps/s through K7 (A = 8..128) and K2 (A = 5, 8, 16) at
          2^18 paths x 512 steps, one JSON line per row
  price --process hybrid — the European call/put under GBM with a
          Vasicek short rate (exact joint transition; --sigma-r)
  var   — portfolio VaR/CVaR: --on-device runs K2 chunks into a histogram
          sketch on the card (GBM; --paths --days --bins --chunk)
  stress — named-scenario and spot x vol grid P&L on GBM or Heston under
          common random numbers, each scenario through K2
  bond  — short-rate bonds: the zero-coupon bond by simulation (K4) under
          --model vasicek|cir|hullwhite|g2pp against its closed form;
          --option (Vasicek bond call), --cap/--floor (Vasicek), --swaption
          (the Vasicek Bermudan payer swaption by LSM; --model g2pp the
          European swaption's quadrature); --model lmm: the LIBOR market
          model's zero-coupon bond, --caplet, --swaption [--n-exercise N]
  greeks — option sensitivities on GBM and Heston: --method pathwise
          (reverse mode through the torch time loop), lr (likelihood
          ratio, GBM; terminal prices through K2), second-order (gamma,
          vanna, volga of the smoothed call); --mesh N (pathwise over a
          mesh of N ranks); --american (policy-frozen American greeks)
  calibrate — fit Heston, SABR, VG, NIG, Merton or Kou to an
          implied-vol surface, Vasicek to payer-swaption premia (Adam on
          exact gradients; without --surface a demo surface is generated
          and recovered); --model lmm: the cap-strip vol bootstrap and the
          correlation decay fitted to swaptions

Usage: python -m montecarlo_tpu_torch <subcommand> [flags]
"""

from __future__ import annotations

import argparse
import json


def _run_bench(args) -> int:
    from montecarlo_tpu_torch.bench import run_basket_bench, run_bench

    rows = run_basket_bench() if args.basket else [run_bench()]
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


def main(argv=None) -> int:
    from montecarlo_tpu_torch.cli import (bond, calibrate, greeks, note,
                                          pricing, risk)

    parser = argparse.ArgumentParser(
        prog="montecarlo_tpu_torch",
        description="PyTorch/CUDA port of the Monte Carlo framework")
    sub = parser.add_subparsers(dest="cmd", required=True)
    pricing.add_parsers(sub)
    note.add_parsers(sub)
    risk.add_parsers(sub)
    bond.add_parsers(sub)
    greeks.add_parsers(sub)
    calibrate.add_parsers(sub)
    bench = sub.add_parser("bench", help="GBM path-steps/s through K1 at "
                           "2^20 paths x 1024 steps x 8 reps (CUDA)")
    bench.add_argument("--basket", action="store_true",
                       help="correlated-basket path-steps/s through K7 and "
                            "K2 at 2^18 paths x 512 steps x 4 reps instead")
    args = parser.parse_args(argv)
    handlers = {"price": pricing.cmd_price, "note": note.cmd_note,
                "bench": _run_bench, "var": risk.cmd_var,
                "stress": risk.cmd_stress,
                "bond": bond.cmd_bond, "greeks": greeks.cmd_greeks,
                "calibrate": calibrate.cmd_calibrate}
    return handlers[args.cmd](args)
