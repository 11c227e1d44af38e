"""`price` — option pricing through the port's engine.

The port of the European branches of ``montecarlo_tpu/cli/pricing.py``:
GBM and Heston; the plain, antithetic and Sobol samplers (``sobol``: the
host table on the torch loop; ``sobol-device`` and ``sobol-bridge``:
Sobol draws inside K2-K4), every Sobol variant priced by randomized QMC
over 8 replicates; vanilla call/put/digital payoffs (fixed ``--paths``
through K2, or ``--target-se`` tolerance pricing through K3, by the iid
chunk loop under ``plain`` and by RQMC under ``sobol-device``); the
path-dependent Asian, lookback, up-and-out and up-and-in calls (K4, with
the Brownian-bridge barrier under ``--bridge``); the jump, Levy, QE and
SABR processes of the JAX CLI's menu (``--process heston-qe``, ``bates``,
``bates-qe``, ``merton``, ``kou``, ``nig``, ``vg``, ``sabr``) on the same
kernels, with the JAX CLI's refusal of the in-kernel Sobol samplers for the
seven whose draws include uniforms (``--sampler sobol`` runs them on the
host's mixed-draw table on the torch loop); local volatility (``--process
cev``: the CEV surface sigma (S/s0)^(beta - 1)) and stochastic-local
volatility (``--process slv``: leverage particle-calibrated on the card to
the Dupire local vol of a demo skewed implied-vol surface) on the same
kernels; the rough-Bergomi call and put
(``--process rbergomi``, K5 and K6, in ``pricing_modes``) and the European
best-of-A call on correlated GBM (``--payoff max-call``, the torch time
loop on MultiGBM, in ``pricing_modes``).  The output JSON has the JAX CLI's
keys: ``price``, ``std_err``, ``n_paths`` and, for the GBM call and
digital, ``black_scholes``; for the call on Kou, NIG, VG, Bates and BatesQE
``cf_price``, the characteristic-function oracle; rough Bergomi adds
``hurst``, the max-call ``n_assets``.
"""

from __future__ import annotations

import json

#: The ``--process`` menu: the JAX CLI's, less hybrid.
PROCESSES = ["gbm", "cev", "heston", "heston-qe", "bates", "bates-qe",
             "merton", "kou", "nig", "vg", "sabr", "rbergomi", "slv"]
VANILLA = ("call", "put", "digital")
PATH_DEPENDENT = ("asian", "lookback", "up-and-out", "up-and-in")
MULTI_ASSET = ("max-call",)


def add_parsers(sub):
    p = sub.add_parser("price", help="Monte Carlo option pricing (GBM, "
                                     "CEV, Heston, jump, Levy and SABR "
                                     "processes, rough Bergomi, SLV)")
    p.add_argument("--process", default="gbm", choices=PROCESSES)
    p.add_argument("--s0", type=float, default=100.0)
    p.add_argument("--strike", type=float, default=105.0)
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--sigma", type=float, default=0.2)
    p.add_argument("--beta", type=float, default=0.7,
                   help="CEV elasticity (--process cev); SABR: CEV exponent")
    p.add_argument("--skew", type=float, default=-0.1,
                   help="slv: demo-surface IV skew per unit log-moneyness "
                        "(iv = sigma + skew*log(K/S0))")
    p.add_argument("--maturity", type=float, default=1.0, help="years")
    p.add_argument("--paths", type=int, default=100_000)
    p.add_argument("--steps", type=int, default=252)
    p.add_argument("--sampler", default="plain",
                   choices=["plain", "antithetic", "sobol", "sobol-device",
                            "sobol-bridge"])
    p.add_argument("--payoff", default="call",
                   choices=list(VANILLA + PATH_DEPENDENT + MULTI_ASSET))
    # Multi-asset extras (--payoff max-call)
    p.add_argument("--n-assets", type=int, default=2,
                   help="max-call: number of (symmetric) assets")
    p.add_argument("--div", type=float, default=0.0,
                   help="max-call: continuous dividend yield (risk-neutral "
                        "drift = rate - div)")
    p.add_argument("--asset-corr", type=float, default=0.0,
                   help="max-call: common pairwise correlation")
    p.add_argument("--barrier", type=float, default=None,
                   help="barrier level for up-and-out/in (default "
                        "1.2*strike)")
    p.add_argument("--bridge", action="store_true",
                   help="up-and-out/in: Brownian-bridge continuous-barrier "
                        "correction (gbm)")
    p.add_argument("--target-se", type=float, default=None,
                   help="price until the discounted std-err reaches this "
                        "target instead of a fixed --paths (vanilla "
                        "payoffs): --sampler plain runs the iid chunk loop, "
                        "sobol-device replicated-randomization RQMC")
    p.add_argument("--seed", type=int, default=0)
    # Heston extras
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--kappa", type=float, default=2.0)
    p.add_argument("--theta", type=float, default=0.04)
    p.add_argument("--xi", type=float, default=0.5)
    p.add_argument("--rho", type=float, default=-0.7)
    # Merton/Kou/Bates extras
    p.add_argument("--jump-intensity", type=float, default=1.0)
    p.add_argument("--jump-mean", type=float, default=-0.05)
    p.add_argument("--jump-std", type=float, default=0.1)
    p.add_argument("--p-up", type=float, default=0.4,
                   help="Kou: probability a jump is upward")
    p.add_argument("--eta1", type=float, default=10.0,
                   help="Kou: up-jump decay (>1)")
    p.add_argument("--eta2", type=float, default=5.0,
                   help="Kou: down-jump decay")
    # NIG extras (pure-jump Levy; --sigma unused)
    p.add_argument("--nig-alpha", type=float, default=15.0,
                   help="NIG: tail heaviness (> |nig-beta + 1|)")
    p.add_argument("--nig-beta", type=float, default=-5.0,
                   help="NIG: skewness (< 0 skews the down-tail)")
    p.add_argument("--nig-delta", type=float, default=0.5,
                   help="NIG: scale per unit time")
    # Variance-gamma extras (--sigma is the subordinated BM scale)
    p.add_argument("--vg-theta", type=float, default=-0.14,
                   help="VG: subordinated drift (< 0 skews the down-tail)")
    p.add_argument("--vg-nu", type=float, default=0.2,
                   help="VG: subordinator variance rate (kurtosis; "
                        "needs dt <= nu)")
    # SABR extras (--sigma is alpha, --beta the CEV exponent, --rho the corr)
    p.add_argument("--nu", type=float, default=0.3,
                   help="SABR vol-of-vol")
    # rough Bergomi extras (--v0 is xi0, --rho the spot-vol corr)
    p.add_argument("--hurst", type=float, default=0.1,
                   help="rough Bergomi Hurst exponent (< 0.5 = rough)")
    p.add_argument("--eta", type=float, default=1.5,
                   help="rough Bergomi vol-of-vol")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")


def cli_process(flags, device="cuda"):
    """The process ``price <flags>`` simulates (``flags`` a list of the
    subcommand's flags, such as ``["--process", "kou", "--steps",
    "252"]``), on ``device``, and the parsed arguments."""
    import argparse

    from montecarlo_tpu_torch.cli.pricing_models import build_process
    from montecarlo_tpu_torch.device import resolve_device

    parser = argparse.ArgumentParser()
    add_parsers(parser.add_subparsers())
    args = parser.parse_args(["price", *flags])
    proc = build_process(args, args.maturity / args.steps,
                         resolve_device(device))
    return proc, args


def resolve_cli_device(name: str):
    """The device of ``--device``; no card for ``cuda`` exits."""
    from montecarlo_tpu_torch.device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e


def cmd_price(args) -> int:
    from montecarlo_tpu_torch.cli import pricing_models as pm
    from montecarlo_tpu_torch.cli.pricing_modes import (run_max_call,
                                                        run_rbergomi)
    from montecarlo_tpu_torch.engine import (black_scholes_call,
                                             black_scholes_digital,
                                             discount_factor)

    if args.target_se is not None and (args.payoff not in VANILLA
                                       or args.process == "rbergomi"):
        raise SystemExit("--target-se applies to vanilla European payoffs "
                         "(call/put/digital) outside the own-simulator "
                         "process (rbergomi)")
    if args.bridge and args.process != "gbm":
        raise SystemExit("--bridge requires --process gbm (constant vol for "
                         "the bridge law)")
    if args.process == "rbergomi":
        return run_rbergomi(args)
    device = resolve_cli_device(args.device)
    dt = args.maturity / args.steps
    proc = pm.build_process(args, dt, device)
    sampler = pm.build_sampler(args, proc)
    disc = float(discount_factor(args.rate, args.maturity))
    if args.payoff == "max-call":
        return run_max_call(args, dt, disc, device)
    if args.payoff in PATH_DEPENDENT:
        est = _estimate_functional(args, proc, sampler, disc, dt)
    else:
        est = _estimate_vanilla(args, proc, sampler, disc, device)

    out = {"price": float(est["price"]), "std_err": float(est["std_err"]),
           "n_paths": int(est["n_paths"])}
    oracle = {"call": black_scholes_call,
              "digital": black_scholes_digital}.get(args.payoff)
    if args.process == "gbm" and oracle is not None:
        out["black_scholes"] = oracle(args.s0, args.strike, args.rate,
                                      args.sigma, args.maturity)
    pm.append_oracles(out, args)
    print(json.dumps(out))
    return 0


#: Randomizations of every Sobol estimate (the JAX CLI's).
N_REPLICATES = 8


def _rqmc_paths(args) -> int:
    """``--paths`` rounded down to whole replicates; fewer than 8 paths per
    replicate exits (the JAX CLI's message; its check stops at one)."""
    paths = (args.paths // N_REPLICATES) * N_REPLICATES
    if paths < 8 * N_REPLICATES:
        raise SystemExit("QMC needs --paths >= 64 (8 replicated "
                         "randomizations)")
    return paths


def _estimate_vanilla(args, proc, sampler, disc, device):
    """Vanilla terminal payoffs: the fixed-path estimate (K2), the
    tolerance loops (``--target-se``: K3 chunks, iid or RQMC) or RQMC
    replication for every Sobol sampler."""
    from montecarlo_tpu_torch.cli.pricing_models import (
        sobol_replicate_factory)
    from montecarlo_tpu_torch.engine import (VanillaPayoff, mc_estimate,
                                             price_to_tolerance,
                                             price_to_tolerance_rqmc,
                                             rqmc_estimate, terminal_prices)

    payoff = VanillaPayoff(args.payoff, args.strike)
    on_card = device.type == "cuda"
    if args.target_se is not None:
        if args.sampler == "plain":
            return price_to_tolerance(
                proc, payoff, target_std_err=args.target_se, seed=args.seed,
                n_steps=args.steps, discount=disc,
                chunk_paths=(1 << 22) if on_card else (1 << 16))
        if args.sampler == "sobol-device":
            return price_to_tolerance_rqmc(
                proc, payoff, target_std_err=args.target_se, seed=args.seed,
                n_steps=args.steps, discount=disc,
                chunk_paths=(1 << 18) if on_card else (1 << 12))
        raise SystemExit("--target-se supports --sampler plain (iid chunked "
                         "loop) or sobol-device (replicated-randomization "
                         "RQMC loop)")
    if args.sampler.startswith("sobol"):
        paths = _rqmc_paths(args)
        return rqmc_estimate(
            proc, payoff, paths, args.steps, seed=args.seed,
            sampler_factory=sobol_replicate_factory(
                args, proc, paths // N_REPLICATES),
            n_replicates=N_REPLICATES, discount=disc)
    terminal = terminal_prices(proc, args.paths, args.steps, seed=args.seed,
                               sampler=sampler)
    return mc_estimate(payoff(terminal), disc)


def _estimate_functional(args, proc, sampler, disc, dt):
    """Path-dependent European payoffs: running functionals folded into
    the time loop (K4), only the ones the payoff reads; RQMC replication
    for the Sobol samplers."""
    import torch

    from montecarlo_tpu_torch.cli.pricing_models import (
        sobol_replicate_factory)
    from montecarlo_tpu_torch.engine import (
        ARITH_MEAN, RUNNING_MAX, RUNNING_MIN, asian_call,
        barrier_survival_up, european_call, lookback_call_floating,
        mc_estimate, rqmc_estimate, simulate_functionals, up_and_out_call)

    if args.payoff == "asian":
        functionals = {"avg": ARITH_MEAN}
    elif args.payoff == "lookback":
        functionals = {"min": RUNNING_MIN}
    elif args.bridge:
        functionals = {}
    else:
        functionals = {"max": RUNNING_MAX}
    barrier = args.barrier or 1.2 * args.strike
    if args.payoff in ("up-and-out", "up-and-in") and args.bridge:
        functionals["surv"] = barrier_survival_up(barrier, args.sigma, dt)
    if args.payoff == "asian":
        payoff_of = lambda o: asian_call(o["avg"], args.strike)
    elif args.payoff == "lookback":
        payoff_of = lambda o: lookback_call_floating(o["terminal"],
                                                     o["min"])
    elif args.bridge:
        # Knock-out and knock-in from the SAME survival probability
        # (in-out parity: KO + KI = vanilla, continuous barrier).
        def payoff_of(o):
            w = (o["surv"] if args.payoff == "up-and-out"
                 else 1.0 - o["surv"])
            return european_call(o["terminal"], args.strike) * w
    elif args.payoff == "up-and-in":
        payoff_of = lambda o: torch.where(
            o["max"] >= barrier, european_call(o["terminal"], args.strike),
            0.0)
    else:
        payoff_of = lambda o: up_and_out_call(
            o["terminal"], o["max"], args.strike, barrier)
    if args.sampler.startswith("sobol"):
        paths = _rqmc_paths(args)
        return rqmc_estimate(
            proc, payoff_of, paths, args.steps, seed=args.seed,
            sampler_factory=sobol_replicate_factory(
                args, proc, paths // N_REPLICATES),
            n_replicates=N_REPLICATES, discount=disc,
            functionals=functionals)
    out = simulate_functionals(proc, args.paths, args.steps, seed=args.seed,
                               sampler=sampler, functionals=functionals)
    return mc_estimate(payoff_of(out), disc)
