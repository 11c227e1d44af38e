"""`calibrate` — fit Heston, SABR, VG, NIG, Merton or Kou to an
implied-vol surface, or Vasicek to payer-swaption premia (Adam on exact
gradients through the differentiable pricers).

The port of ``montecarlo_tpu/cli/calibrate.py``, float32 on ``--device``
(the card by default), as the JAX command runs without x64.  Without
``--surface`` each model generates a demo surface from known parameters
and recovers them (``demo_truth`` in the JSON).  ``--model lmm`` is the
LMM's two-stage market-model calibration, demo only as in the JAX command
(host float64): a co-terminal cap strip from a humped vol curve, the vols
bootstrapped back from it, then the correlation decay fitted to three
European swaptions' Rebonato premia.
"""

from __future__ import annotations

import json

#: The strike x maturity grid of the Heston and Lévy demos.
DEMO_STRIKES = (80.0, 90.0, 100.0, 110.0, 120.0)
DEMO_MATURITIES = (0.25, 0.5, 1.0)

#: The Lévy demos' generating parameters, in each CF's argument order.
LEVY_DEMOS = {
    "vg": dict(sigma=0.18, theta=-0.12, nu=0.25),
    "nig": dict(alpha=12.0, beta=-4.0, delta=0.4),
    "merton": dict(sigma=0.15, lam=0.8, jump_mean=-0.08, jump_std=0.12),
    "kou": dict(sigma=0.15, lam=1.0, p_up=0.35, eta1=9.0, eta2=4.0),
}
HESTON_DEMO = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7)
VASICEK_DEMO = dict(kappa=0.8, theta=0.05, sigma=0.015)


def add_parsers(sub):
    p = sub.add_parser("calibrate",
                       help="fit Heston/SABR/VG/NIG/Merton/Kou to an "
                            "implied-vol surface, Vasicek to swaptions")
    p.add_argument("--model", default="heston",
                   choices=["heston", "sabr", "vg", "nig", "merton",
                            "kou", "vasicek", "lmm"])
    p.add_argument("--surface", default=None,
                   help="CSV with header strike,maturity,iv (long form); "
                        "vasicek: header expiry,pay_dt,strike,periods,"
                        "price (payer-swaption quotes); omit for the demo")
    p.add_argument("--s0", type=float, default=100.0,
                   help="spot (heston, Levy) / forward (sabr)")
    p.add_argument("--rate", type=float, default=0.03)
    p.add_argument("--beta", type=float, default=0.7,
                   help="SABR beta (fixed by convention)")
    p.add_argument("--maturity", type=float, default=1.0,
                   help="SABR smile maturity (single-expiry fit)")
    p.add_argument("--iters", type=int, default=800)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; an error without a card) or cpu")


def _demo_grid():
    import numpy as np

    return (np.array(DEMO_STRIKES * len(DEMO_MATURITIES)),
            np.repeat(DEMO_MATURITIES, len(DEMO_STRIKES)))


def demo_surface(model: str, args, device):
    """``(strikes, maturities, ivs, truth)`` of ``model``'s demo, as numpy
    float64 arrays of the float32 values computed on ``device``."""
    import numpy as np
    import torch

    from montecarlo_tpu_torch.engine.implied_vol import implied_vol_call

    f32 = dict(dtype=torch.float32, device=device)
    if model == "sabr":
        from montecarlo_tpu_torch.processes import sabr_hagan_iv

        # alpha in CEV units: a 20% lognormal ATM vol at f0.
        truth = dict(alpha=0.2 * args.s0 ** (1.0 - args.beta), nu=0.35,
                     rho=-0.4)
        strikes = np.linspace(0.8, 1.25, 10) * args.s0
        mats = np.full(10, args.maturity)
        ivs = sabr_hagan_iv(args.s0, torch.tensor(strikes, **f32),
                            args.maturity, truth["alpha"], args.beta,
                            truth["nu"], truth["rho"])
        return strikes, mats, ivs.cpu().double().numpy(), truth
    strikes, mats = _demo_grid()
    ks, ts = torch.tensor(strikes, **f32), torch.tensor(mats, **f32)
    if model == "heston":
        from montecarlo_tpu_torch.engine.heston_analytic import (
            HestonParams, heston_call_cf)

        truth = dict(HESTON_DEMO)
        prices = heston_call_cf(args.s0, ks, ts, args.rate, HestonParams(
            **{k: torch.tensor(v, **f32) for k, v in truth.items()}))
    else:
        from montecarlo_tpu_torch.engine import cf_pricing as cf

        truth = dict(LEVY_DEMOS[model])
        make_cf = getattr(cf, f"{model}_log_cf_tensor")
        phi = make_cf(torch.tensor(args.s0, **f32), args.rate,
                      *truth.values(), ts)
        prices = cf.cf_call_price_impl(phi, args.s0, ks, ts, args.rate)
    ivs = implied_vol_call(prices, args.s0, ks, args.rate, ts)
    return strikes, mats, ivs.cpu().double().numpy(), truth


def _vasicek(args, device) -> dict:
    import numpy as np
    import torch

    from montecarlo_tpu_torch.engine.rates_calibration import (
        calibrate_vasicek_to_swaptions, vasicek_swaption_prices)

    demo = None
    if args.surface:
        rows = np.genfromtxt(args.surface, delimiter=",", names=True)
        exp_, pdt, ks, nper, px = (
            np.atleast_1d(rows[c]).astype(np.float64)
            for c in ("expiry", "pay_dt", "strike", "periods", "price"))
        nper = nper.astype(int)
    else:
        demo = dict(VASICEK_DEMO)
        grid = [(t0, m, k) for t0 in (1.0, 2.0, 3.0) for m in (4, 8)
                for k in (0.036, 0.045, 0.054)]
        exp_ = [g[0] for g in grid]
        pdt = [0.5] * len(grid)
        ks = [g[2] for g in grid]
        nper = [g[1] for g in grid]
        px = vasicek_swaption_prices(
            args.rate, demo["kappa"], demo["theta"], demo["sigma"], exp_,
            pdt, ks, nper, dtype=torch.float32,
            device=device).cpu().double().numpy()
    fit = calibrate_vasicek_to_swaptions(
        exp_, pdt, ks, nper, px, r0=args.rate,
        n_iters=max(args.iters, 1500), device=device)
    out = {k: round(float(v), 6) for k, v in fit.items()}
    if demo is not None:
        out["demo_truth"] = demo
    return out


#: The LMM demo: tenor, forwards, the generating correlation decay and the
#: swaptions (start, end) quoted.
LMM_DEMO = dict(delta=0.25, k_fwd=16, corr_beta=0.35,
                swaptions=((2, 8), (4, 16), (8, 16)))


def _lmm(args, device) -> dict:
    """Cap strip -> per-tenor vols (exact Black inversion), then
    swaptions -> the correlation decay (Rebonato map); the demo's quotes
    from a humped vol curve and a known decay, recovered."""
    import numpy as np
    from scipy.stats import norm

    from montecarlo_tpu_torch.engine.rates_calibration import (
        bootstrap_lmm_vols, calibrate_lmm_corr_to_swaptions)
    from montecarlo_tpu_torch.processes import (LMM, lmm_par_strike,
                                                lmm_swaption_rebonato)

    if args.surface:
        raise SystemExit("--model lmm is demo-only in the CLI (cap-strip + "
                         "swaption file formats vary by desk); call "
                         "engine.rates_calibration.bootstrap_lmm_vols / "
                         "calibrate_lmm_corr_to_swaptions directly")
    delta, k_fwd = LMM_DEMO["delta"], LMM_DEMO["k_fwd"]
    beta_true = LMM_DEMO["corr_beta"]
    t = delta * np.arange(k_fwd)
    sig_true = 0.12 + 0.25 * (0.3 + t) * np.exp(-0.8 * t)  # humped
    f0 = np.full(k_fwd, args.rate)
    m_true = LMM.create(f0, sig_true, delta, corr_beta=beta_true,
                        device=device)
    # The co-terminal ATM-forward cap strip: sums of exact Black caplets.
    p = np.cumprod(1.0 / (1.0 + delta * f0))

    def black(f, k_, sd):
        d1 = (np.log(f / k_) + 0.5 * sd * sd) / sd
        return f * norm.cdf(d1) - k_ * norm.cdf(d1 - sd)

    caplets = np.array([delta * p[k] * black(
        f0[k], args.rate, sig_true[k] * np.sqrt(k * delta))
        for k in range(1, k_fwd)])
    sig_fit = bootstrap_lmm_vols(f0, delta, args.rate, np.cumsum(caplets))
    quotes = []
    for s, e in LMM_DEMO["swaptions"]:
        k_par = lmm_par_strike(m_true, s, e)
        quotes.append((s, e, k_par,
                       lmm_swaption_rebonato(m_true, s, e, k_par)))
    fit = calibrate_lmm_corr_to_swaptions(f0, sig_fit, delta, quotes)
    return {"corr_beta": round(fit["corr_beta"], 6),
            "rmse_rel": round(fit["rmse_rel"], 9),
            "vol_max_abs_err": round(
                float(np.abs(sig_fit[1:] - sig_true[1:]).max()), 9),
            "demo_truth": {"corr_beta": beta_true,
                           "vols": "humped, recovered exactly"}}


def cmd_calibrate(args) -> int:
    import numpy as np

    from montecarlo_tpu_torch.cli.pricing import resolve_cli_device

    device = resolve_cli_device(args.device)
    if args.model == "lmm":
        print(json.dumps(_lmm(args, device)))
        return 0
    if args.model == "vasicek":
        print(json.dumps(_vasicek(args, device)))
        return 0

    if args.surface:
        rows = np.genfromtxt(args.surface, delimiter=",", names=True)
        strikes = np.atleast_1d(rows["strike"]).astype(np.float64)
        mats = np.atleast_1d(rows["maturity"]).astype(np.float64)
        ivs = np.atleast_1d(rows["iv"]).astype(np.float64)
        demo = None
    else:
        strikes, mats, ivs, demo = demo_surface(args.model, args, device)

    if args.model == "heston":
        from montecarlo_tpu_torch.engine.heston_analytic import (
            calibrate_heston_to_ivs)

        est = calibrate_heston_to_ivs(strikes, mats, ivs, s0=args.s0,
                                      r=args.rate, n_iters=args.iters,
                                      device=device)
        out = {k: round(float(v), 6) for k, v in est._asdict().items()}
    elif args.model in ("vg", "nig", "merton", "kou"):
        from montecarlo_tpu_torch.engine.levy_calibration import (
            calibrate_levy_to_ivs)

        fit = calibrate_levy_to_ivs(args.model, strikes, mats, ivs,
                                    s0=args.s0, r=args.rate,
                                    n_iters=max(args.iters, 1500),
                                    device=device)
        out = {k: round(float(v), 6) for k, v in fit.items()}
    else:
        if not np.allclose(mats, mats[0]):
            raise SystemExit("SABR fits one expiry at a time; the surface "
                             "has mixed maturities")
        from montecarlo_tpu_torch.processes import calibrate_sabr

        fit = calibrate_sabr(strikes, ivs, f0=args.s0, T=float(mats[0]),
                             beta=args.beta, n_iters=max(args.iters, 2000),
                             device=device)
        out = {k: round(float(v), 6) for k, v in fit.items()}
    if demo is not None:
        out["demo_truth"] = demo
    print(json.dumps(out))
    return 0
