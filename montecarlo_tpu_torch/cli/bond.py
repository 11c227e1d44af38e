"""`bond` — short-rate bond and bond-option pricing.

The port of ``montecarlo_tpu/cli/bond.py`` with its flags, defaults and
JSON keys: the zero-coupon bond by simulation (``zcb_price_mc``: K4 folding
the trapezoid discount integral) against its closed form under ``--model
vasicek|cir|hullwhite|g2pp`` (Hull-White fitted to a sloped synthetic
forward curve, against that curve's discount factor); ``--option``, the
Vasicek bond call by simulation (K4) against Jamshidian's formula;
``--cap`` (``--floor``), the Vasicek cap's closed form with a Monte Carlo
cross-check on the rate paths (the torch time loop, as the JAX package's
scan); ``--swaption --model g2pp``, the European payer swaption by the
Brigo–Mercurio quadrature (host float64, no simulation); ``--swaption``
on Vasicek, the Bermudan payer swaption by pathwise-discounted LSM in
float64 (``engine.bermudan``, 16 steps a quarterly period, the par strike
unless ``--swap-strike``) and, with one exercise date, Jamshidian's
European beside it.  ``--model lmm``: the LIBOR market model on a
``--tenor`` grid to ``--maturity`` (flat forwards at ``--r0``, flat vol
``--lmm-sigma``, ``--corr-beta``, ``--lmm-shift``), float32 on the torch
loop (no kernel runs the LMM): the zero-coupon bond by the bank-account
martingale E[1/B(T)] against the initial curve, ``--caplet`` against its
Black closed form, ``--swaption`` (expiry a quarter of the way, par
strike unless ``--swap-strike``) against Rebonato's approximation, with
``--n-exercise N`` > 1 the co-terminal Bermudan by LSM beside it.
``--device cuda`` (the default; an error without a card) or ``cpu`` (the
kernels' plain versions).
"""

from __future__ import annotations

import json


def add_parsers(sub):
    p = sub.add_parser("bond", help="short-rate bond / bond-option pricing")
    p.add_argument("--model", default="vasicek",
                   choices=["vasicek", "cir", "hullwhite", "g2pp", "lmm"])
    p.add_argument("--r0", type=float, default=0.03)
    p.add_argument("--kappa", type=float, default=0.8,
                   help="mean-reversion speed (a for hullwhite)")
    p.add_argument("--theta", type=float, default=0.05,
                   help="long-run level (vasicek/cir)")
    p.add_argument("--sigma", type=float, default=0.015)
    p.add_argument("--maturity", type=float, default=2.0, help="years")
    p.add_argument("--paths", type=int, default=1 << 16)
    p.add_argument("--steps", type=int, default=128)
    p.add_argument("--option", action="store_true",
                   help="European call on a bond: expiry --t1, bond "
                        "maturity --maturity (vasicek only)")
    p.add_argument("--t1", type=float, default=1.0)
    p.add_argument("--option-strike", type=float, default=None,
                   help="default: ATM forward bond price")
    p.add_argument("--fwd-slope", type=float, default=0.005,
                   help="hullwhite: slope of the synthetic forward curve")
    p.add_argument("--g2pp-b", type=float, default=0.1,
                   help="g2pp: second-factor mean reversion b")
    p.add_argument("--g2pp-eta", type=float, default=0.01,
                   help="g2pp: second-factor volatility eta")
    p.add_argument("--g2pp-rho", type=float, default=-0.7,
                   help="g2pp: factor correlation rho")
    p.add_argument("--cap", action="store_true",
                   help="price a cap on the simple rate (strip of "
                        "zero-bond puts, closed form; --floor for the "
                        "floor; --cap-strike defaults to r0) with an MC "
                        "cross-check; requires --model vasicek")
    p.add_argument("--floor", action="store_true",
                   help="with --cap: price the floor instead")
    p.add_argument("--cap-strike", type=float, default=None)
    p.add_argument("--cap-resets", type=int, default=4,
                   help="number of caplets (quarterly from 0.25y)")
    p.add_argument("--swaption", action="store_true",
                   help="Bermudan payer swaption by pathwise-discounted "
                        "LSM (vasicek; --n-exercise 1 = European, checked "
                        "against Jamshidian); with --model g2pp the "
                        "European payer swaption by the Brigo-Mercurio "
                        "quadrature; with --model lmm the European payer "
                        "swaption, MC vs the Rebonato frozen-weight "
                        "approximation (--n-exercise > 1 adds the "
                        "Bermudan)")
    p.add_argument("--caplet", action="store_true",
                   help="lmm: MC caplet vs its exact Black closed form "
                        "(struck at the forward; reset at --t1 snapped to "
                        "the tenor grid)")
    p.add_argument("--lmm-sigma", type=float, default=0.2,
                   help="lmm: flat lognormal forward vol")
    p.add_argument("--lmm-shift", type=float, default=0.0,
                   help="lmm: displaced-diffusion shift")
    p.add_argument("--corr-beta", type=float, default=0.1,
                   help="lmm: forward-correlation decay "
                        "exp(-beta |T_j - T_k|)")
    p.add_argument("--tenor", type=float, default=0.25,
                   help="lmm: forward tenor delta (the simulation grid)")
    p.add_argument("--swap-strike", type=float, default=None,
                   help="fixed rate (default: ~par)")
    p.add_argument("--periods", type=int, default=8,
                   help="swaption: quarterly payment count")
    p.add_argument("--n-exercise", type=int, default=4,
                   help="swaption: number of Bermudan exercise dates")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu "
                        "(the kernels' plain PyTorch versions)")


def _cap(args, device) -> dict:
    """The Vasicek cap (floor): closed form, and an MC cross-check that
    simulates the rate to the last reset, reads each caplet's simple rate
    off the reset-date bond and discounts pathwise to the payment date via
    D(0, T_i) P(T_i, T_i + delta), in float32."""
    import numpy as np
    import torch

    from montecarlo_tpu_torch.engine import mc_estimate, simulate
    from montecarlo_tpu_torch.engine.rates import (vasicek_bond_from_rate,
                                                   vasicek_cap_price)
    from montecarlo_tpu_torch.processes import Vasicek

    delta = 0.25
    resets = delta * np.arange(1, args.cap_resets + 1)
    k_cap = args.cap_strike if args.cap_strike is not None else args.r0
    cf_cap = float(vasicek_cap_price(
        args.r0, args.kappa, args.theta, args.sigma, k_cap, resets, delta,
        floor=args.floor))
    t_last = float(resets[-1])
    n_mc = min(args.steps, 256)
    mc_dt = t_last / n_mc
    proc = Vasicek.create(args.r0, args.kappa, args.theta, args.sigma, mc_dt,
                          device=device)
    paths = simulate(proc, args.paths, n_mc, seed=args.seed, mode="paths")
    mid = 0.5 * (paths[:-1] + paths[1:]) * mc_dt
    cum = torch.cat([torch.zeros((1, args.paths), dtype=paths.dtype,
                                 device=paths.device),
                     torch.cumsum(mid, dim=0)], dim=0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    total = 0.0
    for t_i in resets:
        k_i = int(round(float(t_i) / mc_dt))
        p_i = vasicek_bond_from_rate(paths[k_i], args.kappa, args.theta,
                                     args.sigma, delta)
        lib = (1.0 / p_i - 1.0) / f32(delta)
        pay = (torch.clamp(k_cap - lib, min=0.0) if args.floor
               else torch.clamp(lib - k_cap, min=0.0))
        total = total + torch.exp(-cum[k_i]) * p_i * delta * pay
    est = mc_estimate(total)
    return {"instrument": "floor" if args.floor else "cap",
            "strike": k_cap, "resets": args.cap_resets,
            "closed_form": round(cf_cap, 8),
            "mc_price": round(float(est["price"]), 8),
            "mc_std_err": round(float(est["std_err"]), 8)}


def _g2pp_swaption(args, device) -> dict:
    """The European payer swaption under G2++: expiry 0.25, quarterly
    payments to --periods quarters, strike at par unless --swap-strike."""
    from montecarlo_tpu_torch.processes import (G2PP, g2pp_swaption,
                                                g2pp_zcb)

    delta = 0.25
    t0 = delta
    pays = [t0 + (i + 1) * delta for i in range(args.periods - 1)]
    proc = G2PP.create(args.r0, args.kappa, args.sigma, args.g2pp_b,
                       args.g2pp_eta, args.g2pp_rho, delta / 16,
                       device=device)
    if args.swap_strike is None:
        ps = [float(g2pp_zcb(proc, t)) for t in pays]
        strike = (float(g2pp_zcb(proc, t0)) - ps[-1]) / (delta * sum(ps))
    else:
        strike = args.swap_strike
    px = g2pp_swaption(proc, strike, t0, pays, delta, payer=True)
    return {"g2pp_european_swaption": round(px, 8),
            "strike": round(float(strike), 8), "expiry": t0,
            "periods": args.periods}


def _vasicek_swaption(args, device) -> dict:
    """The Bermudan payer swaption under Vasicek: quarterly periods of 16
    steps, exercise at the first ``--n-exercise`` resets into the swap
    paying to ``--periods`` quarters, in float64 (the process's leaves
    too, as the JAX command builds it), at the forward par rate of the
    swap entered at the first reset unless ``--swap-strike``."""
    import torch

    from montecarlo_tpu_torch.engine.bermudan import (
        bermudan_swaption_lsm, vasicek_swaption_jamshidian)
    from montecarlo_tpu_torch.engine.rates import vasicek_zcb
    from montecarlo_tpu_torch.processes import Vasicek

    delta, spp = 0.25, 16
    zcb = lambda t: vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma,
                                t)
    if args.swap_strike is None:
        # K = (P(delta) - P(n delta)) / (delta sum_{i>=2} P(i delta)): the
        # float leg starts at the first reset, the annuity one period on.
        ps = [zcb(i * delta) for i in range(2, args.periods + 1)]
        strike = ((zcb(delta) - ps[-1]) / (delta * sum(ps)) if ps
                  else args.theta)
    else:
        strike = args.swap_strike
    proc = Vasicek(**{k: torch.tensor(v, dtype=torch.float64, device=device)
                      for k, v in dict(r0=args.r0, kappa=args.kappa,
                                       theta=args.theta, sigma=args.sigma,
                                       dt=delta / spp).items()})
    res = bermudan_swaption_lsm(
        proc, strike, n_paths=args.paths, steps_per_period=spp,
        n_periods=args.periods, n_exercise=args.n_exercise, seed=args.seed)
    out = {"bermudan_swaption": float(res["price"]),
           "std_err": float(res["std_err"]), "strike": float(strike),
           "n_exercise": args.n_exercise}
    if args.n_exercise == 1:
        out["jamshidian_european"] = vasicek_swaption_jamshidian(
            (args.kappa, args.theta, args.sigma), strike, t0=delta,
            delta=delta, n_periods=args.periods - 1, r0=args.r0)
    return out


def _bond_lmm(args, device) -> dict:
    """``bond --model lmm``: the zero-coupon bond, ``--caplet`` or
    ``--swaption`` (and its Bermudan) on a flat curve, float32."""
    import numpy as np
    import torch

    from montecarlo_tpu_torch.engine.simulate import simulate
    from montecarlo_tpu_torch.processes import (LMM, lmm_caplet_mc,
                                                lmm_par_strike,
                                                lmm_swaption_mc, lmm_zcb0)

    f32 = torch.float32
    delta = args.tenor
    k_fwd = max(int(round(args.maturity / delta)), 2)
    m = LMM.create([args.r0] * k_fwd, [args.lmm_sigma] * k_fwd, delta,
                   corr_beta=args.corr_beta, shift=args.lmm_shift,
                   dtype=f32, device=device)
    if args.caplet:
        k_idx = min(max(int(round(args.t1 / delta)), 1), k_fwd - 1)
        strike = (args.option_strike if args.option_strike is not None
                  else args.r0)
        est = lmm_caplet_mc(m, k_idx, strike, args.paths, seed=args.seed,
                            dtype=f32)
        return {"instrument": "caplet", "reset": k_idx * delta,
                "strike": strike,
                "mc_price": round(est["price"], 8),
                "mc_std_err": round(est["std_err"], 8),
                "black_exact": round(est["black"], 8)}
    if args.swaption:
        s = max(k_fwd // 4, 1)
        strike = (args.swap_strike if args.swap_strike is not None
                  else lmm_par_strike(m, s, k_fwd))
        est = lmm_swaption_mc(m, s, k_fwd, strike, args.paths,
                              seed=args.seed, dtype=f32)
        out = {"instrument": "lmm_european_swaption",
               "expiry": s * delta, "strike": round(float(strike), 8),
               "periods": k_fwd - s,
               "mc_price": round(est["price"], 8),
               "mc_std_err": round(est["std_err"], 8),
               "rebonato": round(est["rebonato"], 8)}
        if args.n_exercise > 1:
            from montecarlo_tpu_torch.engine.bermudan import (
                lmm_bermudan_swaption_lsm)

            n_ex = min(args.n_exercise, k_fwd - s)
            berm = lmm_bermudan_swaption_lsm(
                m, float(strike), s, k_fwd, n_exercise=n_ex,
                n_paths=args.paths, seed=args.seed, dtype=f32)
            out["instrument"] = "lmm_bermudan_swaption"
            out["bermudan_price"] = round(float(berm["price"]), 8)
            out["n_exercise"] = n_ex
        return out
    obs = simulate(m, args.paths, k_fwd, seed=args.seed, dtype=f32,
                   observe=lambda p, s_: p.exposure_obs(s_))
    d = torch.exp(-obs[:, -1]).cpu().numpy().astype(np.float64)
    return {"zcb_price": round(float(d.mean()), 8),
            "std_err": round(float(d.std(ddof=1) / np.sqrt(args.paths)), 8),
            "closed_form": round(lmm_zcb0(m, k_fwd), 8),
            "forwards": k_fwd, "tenor": delta}


def build_model(args, device):
    """(process, closed-form P(0, T)) of ``--model`` (not lmm) over
    ``--steps`` steps to ``--maturity`` on ``device``."""
    import numpy as np

    from montecarlo_tpu_torch.engine.rates import cir_zcb, vasicek_zcb
    from montecarlo_tpu_torch.processes import (CIR, G2PP, HullWhite,
                                                Vasicek, g2pp_zcb)

    T, n_steps = args.maturity, args.steps
    dt = T / n_steps
    if args.model == "vasicek":
        proc = Vasicek.create(args.r0, args.kappa, args.theta, args.sigma,
                              dt, device=device)
        return proc, vasicek_zcb(args.r0, args.kappa, args.theta,
                                 args.sigma, T)
    if args.model == "cir":
        proc = CIR.create(args.r0, args.kappa, args.theta, args.sigma, dt,
                          device=device)
        return proc, cir_zcb(args.r0, args.kappa, args.theta, args.sigma, T)
    if args.model == "g2pp":
        proc = G2PP.create(args.r0, args.kappa, args.sigma, args.g2pp_b,
                           args.g2pp_eta, args.g2pp_rho, dt, device=device)
        return proc, float(g2pp_zcb(proc, T))
    t_grid = np.arange(n_steps + 1) * dt
    fwd = args.r0 + args.fwd_slope * t_grid
    proc = HullWhite.from_forward_curve(fwd, a=args.kappa, sigma=args.sigma,
                                        dt=dt, device=device)
    return proc, float(np.exp(-np.trapezoid(fwd, t_grid)))


def cmd_bond(args) -> int:
    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device
    from montecarlo_tpu_torch.engine.rates import (bond_option_mc,
                                                   vasicek_bond_option,
                                                   vasicek_zcb, zcb_price_mc)
    from montecarlo_tpu_torch.processes import Vasicek

    device = resolve_cli_device(args.device)
    if args.model == "lmm":
        print(json.dumps(_bond_lmm(args, device)))
        return 0
    T, n_steps = args.maturity, args.steps
    proc, cf = build_model(args, device)

    if args.cap:
        if args.model != "vasicek":
            raise SystemExit("--cap requires --model vasicek")
        print(json.dumps(_cap(args, device)))
        return 0
    if args.swaption:
        if args.model == "g2pp":
            print(json.dumps(_g2pp_swaption(args, device)))
            return 0
        if args.model != "vasicek":
            raise SystemExit("--swaption requires --model vasicek or g2pp")
        print(json.dumps(_vasicek_swaption(args, device)))
        return 0
    if args.option:
        if args.model != "vasicek":
            raise SystemExit("--option requires --model vasicek (affine "
                             "closed-form bond at expiry)")
        t1 = args.t1
        strike = args.option_strike or (
            vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma, T)
            / vasicek_zcb(args.r0, args.kappa, args.theta, args.sigma, t1))
        proc = Vasicek.create(args.r0, args.kappa, args.theta, args.sigma,
                              t1 / n_steps, device=device)
        est = bond_option_mc(proc, t1, T, strike, n_steps, args.paths,
                             seed=args.seed)
        out = {"bond_option_price": float(est["price"]),
               "std_err": float(est["std_err"]),
               "strike": strike,
               "jamshidian": vasicek_bond_option(
                   args.r0, args.kappa, args.theta, args.sigma, t1, T,
                   strike)}
    else:
        est = zcb_price_mc(proc, T, n_steps, args.paths, seed=args.seed)
        out = {"zcb_price": float(est["price"]),
               "std_err": float(est["std_err"]),
               "closed_form": cf}
    print(json.dumps(out))
    return 0
