"""Process, sampler and oracle construction for the `price` subcommand, as
in ``montecarlo_tpu/cli/pricing_models.py::build_process``,
``::build_sampler``, ``::sobol_replicate_factory`` and
``::append_oracles``."""

from __future__ import annotations

import math


def build_process(args, dt, device):
    """The ``--process`` table (rbergomi runs its own sampler in
    ``pricing_modes``)."""
    from montecarlo_tpu_torch import processes as P

    common = dict(dt=dt, device=device)
    heston = dict(s0=args.s0, v0=args.v0, mu=args.rate, kappa=args.kappa,
                  theta=args.theta, xi=args.xi, rho=args.rho)
    jumps = dict(lam=args.jump_intensity, jump_mean=args.jump_mean,
                 jump_std=args.jump_std)
    if args.process == "heston":
        return P.Heston.create(**heston, **common)
    if args.process == "heston-qe":
        return P.HestonQE.create(**heston, **common)
    if args.process in ("bates", "bates-qe"):
        cls = P.Bates if args.process == "bates" else P.BatesQE
        return cls.create(**heston, **jumps, **common)
    if args.process == "merton":
        return P.Merton.create(s0=args.s0, mu=args.rate, sigma=args.sigma,
                               **jumps, **common)
    if args.process == "kou":
        return P.Kou.create(s0=args.s0, mu=args.rate, sigma=args.sigma,
                            lam=args.jump_intensity, p_up=args.p_up,
                            eta1=args.eta1, eta2=args.eta2, **common)
    if args.process == "nig":
        return P.NIG.create(s0=args.s0, mu=args.rate, alpha=args.nig_alpha,
                            beta=args.nig_beta, delta=args.nig_delta,
                            **common)
    if args.process == "vg":
        return P.VarianceGamma.create(s0=args.s0, mu=args.rate,
                                      sigma=args.sigma, theta=args.vg_theta,
                                      nu=args.vg_nu, **common)
    if args.process == "sabr":
        # The T-forward of the spot, f0 = s0 e^{rT}, driftless under the
        # forward measure (discounting by --rate prices the same spot);
        # --sigma is the lognormal alpha, rescaled by f0^(1 - beta).
        f0 = args.s0 * math.exp(args.rate * args.maturity)
        return P.SABR.create(f0=f0, alpha=args.sigma * f0 ** (1.0 - args.beta),
                             beta=args.beta, nu=args.nu, rho=args.rho,
                             **common)
    return P.GBM.create(s0=args.s0, mu=args.rate, sigma=args.sigma, **common)


def cf_oracle(args):
    """The characteristic function of ln S_T the JAX CLI prices the call
    with (Kou, NIG, VG, Bates, BatesQE), or None."""
    from montecarlo_tpu_torch.engine import cf_pricing as cf
    from montecarlo_tpu_torch.processes import bates_log_cf

    T = args.maturity
    if args.process == "kou":
        return cf.kou_log_cf(args.s0, args.rate, args.sigma,
                             args.jump_intensity, args.p_up, args.eta1,
                             args.eta2, T)
    if args.process == "nig":
        return cf.nig_log_cf(args.s0, args.rate, args.nig_alpha,
                             args.nig_beta, args.nig_delta, T)
    if args.process == "vg":
        return cf.vg_log_cf(args.s0, args.rate, args.sigma, args.vg_theta,
                            args.vg_nu, T)
    if args.process in ("bates", "bates-qe"):
        return bates_log_cf(args.s0, args.rate, v0=args.v0,
                            kappa=args.kappa, theta=args.theta, xi=args.xi,
                            rho=args.rho, lam=args.jump_intensity,
                            jump_mean=args.jump_mean,
                            jump_std=args.jump_std, T=T)
    return None


def append_oracles(out, args) -> None:
    """``cf_price`` beside the call's estimate where the JAX CLI prints one
    (a finite characteristic-function price)."""
    phi = cf_oracle(args) if args.payoff == "call" else None
    if phi is None:
        return
    from montecarlo_tpu_torch.engine.cf_pricing import cf_call_price

    price = cf_call_price(phi, args.s0, args.strike, args.maturity,
                          args.rate)
    if math.isfinite(price):
        out["cf_price"] = price


def _mixed(proc) -> bool:
    return proc is not None and any(
        k != "normal" for k in getattr(proc, "draw_kinds",
                                       ("normal",) * proc.n_draws))


def check_sampler_args(args, proc) -> None:
    """The JAX CLI's refusals: the in-kernel Sobol samplers substitute
    normals for every draw, and the bridge orders a single draw."""
    if args.sampler in ("sobol-device", "sobol-bridge") and _mixed(proc):
        raise SystemExit(
            f"--sampler {args.sampler} substitutes normals for every draw "
            f"in-kernel, but {args.process} consumes non-normal uniforms — "
            "use `--sampler sobol` (host mixed-draw QMC) or plain/antithetic "
            "sampling")
    if args.sampler == "sobol-bridge" and proc.n_draws != 1:
        raise SystemExit("--sampler sobol-bridge requires a single-draw "
                         "process (gbm)")


def build_sampler(args, proc):
    """The ``--sampler`` of a single run: plain or antithetic.  A Sobol
    sampler gives None after :func:`check_sampler_args`: every Sobol
    branch builds one sampler per replicate with
    :func:`sobol_replicate_factory`."""
    from montecarlo_tpu_torch.samplers import AntitheticSampler, PlainSampler

    check_sampler_args(args, proc)
    if args.sampler == "plain":
        return PlainSampler()
    if args.sampler == "antithetic":
        return AntitheticSampler()
    return None


def sobol_replicate_factory(args, proc, n_per: int):
    """Per-replicate sampler factory for RQMC, a fresh scramble per
    replicate: the bridge and device samplers re-scramble their direction
    numbers with ``seed + r``, the host table is rebuilt with scipy's seed
    ``seed + r`` over ``n_per`` points."""
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)
    from montecarlo_tpu_torch.samplers import SobolSampler

    dev = proc.device
    if args.sampler == "sobol-bridge":
        return lambda r: SobolBridgeKernelSampler.create(
            args.steps, scramble_seed=args.seed + r, device=dev)
    if args.sampler == "sobol":
        return lambda r: SobolSampler.for_process(
            proc, n_per, args.steps, seed=args.seed + r)
    return lambda r: SobolDeviceSampler.create(
        args.steps, proc.n_draws, scramble_seed=args.seed + r, device=dev)
