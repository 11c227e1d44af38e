"""Sampler construction for the `price` subcommand, as in
``montecarlo_tpu/cli/pricing_models.py::build_sampler`` and
``::sobol_replicate_factory``."""

from __future__ import annotations


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
