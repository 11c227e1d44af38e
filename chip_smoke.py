#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``montecarlo_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernels from ``montecarlo_tpu_torch/csrc`` and, in phases:

1. prints the card (``nvidia-smi`` name and power limit), the build time
   and each kernel's registers, stack frame and spills (``-Xptxas -v``);
2. K0: Threefry words, uniforms and exp32 of the device build against the
   plain PyTorch versions on 2^20 counters (bitwise), Box-Muller and log32
   (bitwise fraction, max difference); the Sobol integer, Owen key,
   scrambled uniform and Sobol normal of 2^20 (id, dim) pairs and ndtri32
   (bitwise);
3. K1, K2 and K3 (GBM; K2 and K3 also Heston; plain and antithetic) and
   K4 (every device functional, GBM and Heston, plain and antithetic)
   against their plain versions at 2^18 paths x {252, 17} steps;
4. each kernel against its plain version again, and both timed, at the
   shapes the main paths give it;
5. the main paths through the CLI entry, each with the launch counters
   reset just before and read just after:
   - the European path: ``price`` with fixed paths (K2, plain and
     antithetic), ``price --target-se 1e-3`` (K3) and ``bench`` (K1), each
     price held against Black-Scholes;
   - the path-dependent path (K4): ``price --payoff asian`` (GBM plain and
     antithetic, Heston), ``up-and-out --bridge`` and ``up-and-in
     --bridge`` at 2^20 paths x 252 steps, ``note --type autocall`` and
     ``--type cliquet``, each run raising K4's count; the GBM Asian price
     lies between the geometric Asian closed form and Black-Scholes, the
     engine's geometric Asian within 5 std-err of its closed form, and
     knock-out plus knock-in adds up to the vanilla call of the same seed;
6. the rough-Bergomi path (K5, the factor product, K6), launch counters
   reset just before and read just after: ``price --process rbergomi`` at
   2^20 x 252 (twice: the same seed gives the same bits) and at the
   default 100000 paths, each run raising K5's and K6's counts; ``--eta 0
   --rho 0 --rate 0`` against Black-Scholes with sigma = sqrt(xi0); the
   sampler's martingale test at 2^20 x 252; a 65536 x 16 run on the card
   against ``--device cpu``;
7. the multi-asset path (K7, and K2-K4 on the correlated basket): K7 at
   A in {5, 16, 20, 64, 128} assets x T in {7, 8} on 2^16 paths (and once
   with ids wrapping past 2^32), and at ``bench --basket``'s 2^18 x 512 x
   A = 128 against the plain version on a 2^14-path slice, all bitwise;
   K2, K3 and K4 ({avg}, {avg, mx, mn}) on BasketGBM at A in {3, 5, 16,
   17}, plain and antithetic, bitwise; the basket's mean and variance
   against the lognormal closed form (K7 at A in {16, 32}, K2 at A = 5);
   K2, K3 and K4 bitwise and timed at the shapes the path below gives
   them (K2 at each ``bench --basket`` row, K3 at two of
   ``price_to_tolerance``'s 2^22 x 252 chunks, K4 at the basket Asian's
   2^20 x 252); then, launch counters reset just before and read just
   after, ``bench --basket``, ``price --payoff max-call`` at 5 assets
   (2^20 x 252) and at 1 asset (against Black-Scholes), the worst-of note
   below the one-asset note, ``price_to_tolerance`` on a 5-asset basket
   call (K3) and ``simulate_functionals`` for its Asian (K4), priced
   below the call;
8. the GARCH path (K2-K4 on GarchProc): K2, K3 and K4 ({avg, mx, mn}) on
   the bootstrap GARCH against their plain versions bitwise, plain and
   antithetic, at 2^18 paths (2^18 - 37 for K2 and K4) x {20, 17, 252}
   steps on 2- and 5-year synthetic tables, ids wrapping past 2^32 once;
   K2 timed at a VaR chunk (2^24 x 20) and at 2^20 x 252 per table, K3 at
   2^24 x 20, K4 at 2^20 x 252, each beside its plain version and bound;
   then, counters reset around each call: ``garch_monte_carlo`` (20 days,
   5-year history) at 1000, 30000 and 2^22 sims with the paths kept (no
   K2) and at 2^22 without (one K2 launch; terminals bitwise the kept
   run's, bands within a bin width), the 30000-sim statistics against a
   NumPy oracle of the reference recurrence (4 sigma), antithetic bands
   and spread, ``fit_params``; ``portfolio_var_on_device`` at 2^30 x 20
   in 2^24-path chunks on GARCH and GBM (one K2 launch per chunk; GBM's
   VaR at its closed form; the sketch at 2^22 within its grid errors of
   the exact statistics of the same terminals) and ``var --on-device``
   (the JAX CLI's keys); the VaR at 2^28 and ``garch_monte_carlo`` under
   the profiler (device busy share, kernels by device time);
9. randomized QMC (K2-K4 under Sobol and bridge-Sobol draws): K2, K3 and
   K4 under each draw source against their plain versions bitwise at 2^18
   and 2^18 - 37 paths x {252, 17, 9} steps on tables built for exactly
   the run's steps, ids crossing 2^30; each timed with its bound at the
   QMC path's shapes (the Threefry K2 beside the Sobol one; K3's rows add
   the kernel's device time from the profiler as ``device_ms``, since at
   2^18 paths its wrapper's merges can leave the card idle between
   launches); then, launch counters reset just before and read just after
   each run: ``price --sampler sobol-device --target-se 1e-3`` (the RQMC
   wall-clock to std-err 1e-3; K3 under Sobol), ``--sampler sobol-bridge``
   (K2 under the bridge), ``--process heston --sampler sobol-device`` (K2
   under Sobol), the Asian under both samplers at 2^20 paths (K4),
   ``--sampler sobol`` at 65536 (the host table on the torch loop, no
   kernel) and ``price_to_tolerance_rqmc`` with bridge replicates (K3
   under the bridge), each vanilla price within 4 replicate std-errs +
   1e-4 of Black-Scholes, each run launching its kernel; the tolerance
   run's wall-clock is then broken down under the profiler, outside the
   counted runs;
10. the jump, Levy, QE and SABR processes on K2-K4 (MertonProc, KouProc,
   BatesProc, NigProc, HestonQEProc, BatesQEProc, VgProc, SabrProc): K2, K3
   and K4 ({avg, geo, mx, mn}) on each against its plain version bitwise,
   plain and antithetic (SABR also under Sobol draws), at 2^18 paths
   (2^18 - 37 for K2 and K4) x 17 steps with ids from 2^30 - 1000, at 252
   steps K2 antithetic and K4 plain, and the K0 gamma-table inversion on
   2^20 uniforms; each K2 timed (and held bitwise) at
   2^20 x 252 beside its plain version and bound, K3 on Merton at two
   2^22 x 252 tolerance chunks, K4 {avg} on Kou and VG at 2^20 x 252; then,
   launch counters reset just before and read just after each run: ``price
   --process <p> --paths 1048576 --steps 252`` for the eight (K2), gated
   within 4 std-err plus a stated slack by the CF price (kou, nig, vg,
   bates, bates-qe), merton_call_series (merton), Heston's CF (heston-qe)
   and the martingale E[F_T] = f0 (sabr, from ``--strike 0``); ``price
   --process merton --target-se 1e-3`` (K3), ``--process kou --payoff
   asian`` (K4) and ``--process merton --sampler sobol`` (the host table
   on the torch loop, no kernel);
11. local and stochastic-local volatility on K2-K4 (LocalVolProc, SlvProc
   with its per-step leverage row read through a pointer and an offset,
   the port of JAX's KernelRows, and SlvKnotsProc): K2, K3 and K4 ({avg,
   geo, mx, mn}) against their plain versions bitwise at 2^18 paths (2^18
   - 37 for K2 and K4) x 17 steps with ids from 2^30 - 1000, on the CLI's
   CEV surface, a time-dependent surface of 16 time knots, the CLI's
   calibrated SLV and its ``slv_to_kernel`` SLVKnots, plain, antithetic
   and under Sobol draws (local vol under the bridge too), the SLV of 17
   rows also at 23 steps (the clamp), at 252 steps K2 antithetic and K4
   plain; ``calibrate_slv`` at 2^17 particles x 252 steps timed by the host
   clock, twice at one seed (bitwise equal rows), once under the profiler,
   and at 2^14 x 64 against
   ``--device cpu`` within rtol 5e-4; K2 on each of the three timed at
   2^20 x 252 beside its plain version and bound, K3 on the SLV at two
   2^22 x 252 tolerance chunks, K4 {avg} on the SLV at 2^20 x 252; then,
   launch counters reset just before and read just after each run:
   ``price --process cev --paths 1048576 --steps 252`` (K2, within 5
   std-err + 0.05 of the CEV closed form), ``price --process slv`` at the
   same shape for K = 85, 100, 115 (K2, within 4 std-err + 0.0075 BS +
   0.03 of Black-Scholes at the demo surface's implied vol), the engine's
   ``terminal_prices`` on ``slv_to_kernel`` of that SLV (K2), ``--process
   slv --target-se 1e-3`` (K3), ``--payoff asian`` on SLV (K4, below its
   call), ``--sampler sobol-device`` on SLV and ``sobol-bridge`` on CEV
   (K2 under each), each vanilla under its gate.

Phase 3 also holds K5 (2^18 paths x {504, 756, 37} columns, ids wrapping
past 2^32) and K6 (2^18 x {252, 17} steps, fed one joint matrix) against
their plain versions bitwise; phase 4 times them at 2^20 x 504 and 2^20 x
252, checks the factor product against a float64 product under a
process-wide TF32 setting, and times the whole sampler at
``experiments/rbergomi_bench.py``'s 2^17 x 256 and at the CLI's 2^20 x 252,
each with its K5 / product / K6 split;

then prints one JSON line describing the kernels (each with its least
time on the card, ``bound_ms``, from the bytes it must move and the
operations it must do at the shape it was timed at) and, last, the
``{"ok": true, "device": ...}`` line.  Any failure prints its traceback and
exits non-zero; without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import subprocess
import sys
import time
import traceback

PRICE_RTOL = 2e-6    # kernel vs plain version, terminal prices
MOMENT_RTOL = 1e-6   # kernel vs plain version, block (mean, M2)
BITWISE = 0.0        # K4-K6 and Heston K2/K3 vs plain version: same bits
# The card's rBergomi CLI price against --device cpu: cuBLAS and the CPU
# BLAS sum the factor product in their own orders and the platforms' libm
# differ in Box-Muller and pow, the two float orders JAX holds its own
# sampler's tails to within rtol 3e-5.
RBERGOMI_CPU_RTOL = 3e-5
WRAP = 2**32 - 500   # a path offset whose ids wrap past 2^32
# The multi-asset path's engine calls on the 5-asset bench basket:
# price_to_tolerance on the call at this strike, in chunks of 2^22 paths x
# 252 steps, and the arithmetic-average Asian call at 2^20 x 252.
BASKET_STRIKE, TOL_CHUNK, TOL_STEPS, ASIAN_PATHS = 100.0, 1 << 22, 252, 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def log_resources(ptxas: str) -> None:
    """One line per kernel from ``nvcc -Xptxas -v``: registers, stack frame
    and spills (nothing when the library was already built)."""
    name = frame = None
    for line in ptxas.splitlines():
        if "Function properties for" in line:
            name = line.split("for", 1)[1].strip()
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            log(f"  {name}: {regs}; {frame}")
            name = frame = None


def compare(name, got, want, rtol=None):
    """Print and return (bitwise fraction, max |diff|, max relative diff);
    raise when ``rtol`` is given and exceeded."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    rel = diff / want.abs().clamp(min=1e-30)
    same = float((got == want).double().mean())
    max_abs, max_rel = float(diff.max()), float(rel.max())
    log(f"  {name}: bitwise {same:.6f}, max abs {max_abs:.3e}, "
        f"max rel {max_rel:.3e}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    if rtol is not None and max_rel > rtol:
        raise AssertionError(f"{name}: max rel {max_rel:.3e} > {rtol:.1e}")
    return same, max_abs, max_rel


def cuda_ms(fn, reps: int):
    """Milliseconds per call of ``fn`` by CUDA events, after one warm-up,
    and the last call's result."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def timed_check(times, errs, key, label, kernel, plain, reps, rtol, *, bnd,
                fields=(None,)):
    """Time ``kernel`` (``reps`` calls) and ``plain`` (one call) by CUDA
    events, log both beside ``bnd`` = (least ms, "bytes" or "operations")
    at this shape, and compare their outputs within ``rtol``.  The first
    row of kernel ``key`` is the one its kernels-line entry reports."""
    import torch

    ms, got = cuda_ms(kernel, reps)
    plain_ms, want = cuda_ms(plain, 1)
    times.setdefault(key, {"ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bnd[0], "bound_by": bnd[1]})
    log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})")
    if isinstance(got, dict):
        fields = tuple(got)
    for f in fields:
        if f is None:
            g, w = got, want
        elif isinstance(got, dict):
            g, w = got[f], want[f]
        else:
            g, w = getattr(got, f), getattr(want, f)
        _, max_abs, _ = compare(f"{label}{'' if f is None else ' ' + f}",
                                g, w, rtol)
        errs[key] = max(errs.get(key, 0.0), max_abs)
    del got, want
    torch.cuda.synchronize()


def phase_k0(torch):
    import numpy as np

    from montecarlo_tpu_torch.ops.rng_check import (rng_check,
                                                    rng_check_reference)

    n = 1 << 20
    rng = np.random.default_rng(2024)
    dev = torch.device("cuda")
    c0 = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.int64)).to(dev)
    c1 = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.int64)).to(dev)
    x_exp = torch.from_numpy(rng.uniform(-25, 25, n).astype(np.float32)).to(
        dev)
    x_log = torch.from_numpy(
        np.exp(rng.uniform(-19, 19, n)).astype(np.float32)).to(dev)
    k0, k1 = 0x9E3779B9, 0x7F4A7C15
    got = rng_check(k0, k1, c0, c1, x_exp, x_log)
    want = rng_check_reference(k0, k1, c0, c1, x_exp, x_log)
    torch.cuda.synchronize()
    for name in ("bits0", "bits1", "u0", "u1", "exp32"):
        same = bool(torch.equal(got[name], want[name]))
        log(f"  {name}: bitwise {same}")
        if not same:
            raise AssertionError(f"K0 {name} differs from the plain version")
    for name in ("z0", "z1", "log32"):
        _, max_abs, _ = compare(name, got[name], want[name])
        if max_abs > 1e-6:
            raise AssertionError(f"K0 {name}: max abs {max_abs:.3e} > 1e-6")
    # The Sobol normal: random (id, dim) pairs of a 504-dim table, ids
    # near 2^30 and 2^32 included; ndtri32 on uniforms and its tails.
    from montecarlo_tpu_torch.ops.rng_check import (sobol_check,
                                                    sobol_check_reference)
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    sv = SobolDeviceSampler.create(252, 2, device="cuda").sv
    ids = c0.clone()
    ids[:4096] = (1 << 30) - 2048 + torch.arange(4096, device=dev)
    dims = torch.from_numpy(rng.integers(0, 504, n)).to(dev)
    u = torch.from_numpy(np.concatenate([
        rng.uniform(0, 1, n - 56), 2.0 ** -np.arange(1, 33),
        1 - 2.0 ** -np.arange(1, 25)]).astype(np.float32)).to(dev)
    got = sobol_check(k0, k1, sv, ids, dims, u)
    want = sobol_check_reference(k0, k1, sv, ids, dims, u)
    torch.cuda.synchronize()
    for name in want:
        same = bool(torch.equal(got[name], want[name]))
        log(f"  {name}: bitwise {same}")
        if not same:
            compare(name, got[name].double(), want[name].double())
            raise AssertionError(f"K0 {name} differs from the plain version")


def phase_parity(torch, errs):
    from montecarlo_tpu_torch.engine import VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_terminal,
                                          fused_terminal_reference,
                                          gbm_terminal, gbm_terminal_reference)
    from montecarlo_tpu_torch.processes import GBM

    n = 1 << 18
    for steps in (252, 17):
        proc = GBM.create(100.0, 0.03, 0.2, 1.0 / steps, device="cuda")
        kw = dict(seed=11, path_offset=12345)
        cases = [
            ("K1", "gbm_terminal",
             gbm_terminal(proc, n, steps, **kw),
             gbm_terminal_reference(proc, n, steps, **kw)),
            ("K2 plain", "fused_terminal",
             fused_terminal(proc, n, steps, **kw),
             fused_terminal_reference(proc, n, steps, **kw)),
            ("K2 antithetic", "fused_terminal",
             fused_terminal(proc, n, steps, antithetic=True, **kw),
             fused_terminal_reference(proc, n, steps, antithetic=True, **kw)),
        ]
        for label, key, got, want in cases:
            _, max_abs, _ = compare(f"{label} {n}x{steps}", got, want,
                                    PRICE_RTOL)
            errs[key] = max(errs.get(key, 0.0), max_abs)
        for kind in ("call", "digital"):
            pay = VanillaPayoff(kind, 105.0)
            got = fused_block_moments(proc, pay, n, steps, **kw)
            want = fused_block_moments_reference(proc, pay, n, steps, **kw)
            for field in ("mean", "m2"):
                _, max_abs, _ = compare(
                    f"K3 {kind} {field} {n}x{steps}", getattr(got, field),
                    getattr(want, field), MOMENT_RTOL)
                errs["fused_block_moments"] = max(
                    errs.get("fused_block_moments", 0.0), max_abs)
        torch.cuda.synchronize()
        phase_parity_slice2(torch, errs, n, steps)
    phase_parity_rbergomi(torch, errs, n)
    # The whole CLI path on the card against the port's CPU path (plain
    # versions, CPU libm): same draws, float32 round-off apart.
    small = ["price", "--paths", "65536", "--steps", "17"]
    on_card, _ = run_cli(small)
    on_cpu, _ = run_cli(small + ["--device", "cpu"])
    for key in ("price", "std_err"):
        rel = abs(on_card[key] - on_cpu[key]) / abs(on_cpu[key])
        log(f"  CLI {key} cuda vs cpu, 65536x17: rel {rel:.3e}")
        if rel > 1e-5:
            raise AssertionError(f"CLI {key}: cuda {on_card[key]} vs cpu "
                                 f"{on_cpu[key]}")


def heston(steps, device="cuda"):
    from montecarlo_tpu_torch.processes import Heston

    return Heston.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.5, -0.7,
                         1.0 / steps, device=device)


def functional_groups(steps):
    """Every device functional, in K4's groups of at most four."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                             RUNNING_MAX, RUNNING_MIN,
                                             autocallable,
                                             barrier_survival_up,
                                             cliquet_sum, realized_variance,
                                             trapezoid_integral)

    dt = 1.0 / steps
    period = steps // 4 if steps % 4 == 0 else steps
    return [
        {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
         "mn": RUNNING_MIN},
        {"surv": barrier_survival_up(110.0, 0.2, dt),
         "cl": cliquet_sum(max(steps // 4, 1), -0.02, 0.03),
         "rv": realized_variance(), "tr": trapezoid_integral(dt)},
        {"ac": autocallable(period, 100.0, 0.02, 0.03 * dt, 70.0, 100.0)},
    ]


def phase_parity_slice2(torch, errs, n, steps):
    """Heston K2/K3 and K4 (every functional, GBM and Heston) against
    their plain versions, bitwise."""
    from montecarlo_tpu_torch.engine import VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)
    from montecarlo_tpu_torch.processes import GBM

    kw = dict(seed=11, path_offset=12345)
    hp = heston(steps)
    for anti in (False, True):
        label = f"{n}x{steps} {'antithetic' if anti else 'plain'}"
        _, max_abs, _ = compare(
            f"K2 Heston {label}",
            fused_terminal(hp, n, steps, antithetic=anti, **kw),
            fused_terminal_reference(hp, n, steps, antithetic=anti, **kw),
            BITWISE)
        errs["fused_terminal"] = max(errs["fused_terminal"], max_abs)
        pay = VanillaPayoff("call", 105.0)
        got = fused_block_moments(hp, pay, n, steps, antithetic=anti, **kw)
        want = fused_block_moments_reference(hp, pay, n, steps,
                                             antithetic=anti, **kw)
        for field in ("mean", "m2"):
            _, max_abs, _ = compare(f"K3 Heston call {field} {label}",
                                    getattr(got, field),
                                    getattr(want, field), BITWISE)
            errs["fused_block_moments"] = max(errs["fused_block_moments"],
                                              max_abs)
        for kind, proc in (("GBM", GBM.create(100.0, 0.03, 0.2, 1.0 / steps,
                                              device="cuda")),
                           ("Heston", hp)):
            for fns in functional_groups(steps):
                got = fused_functionals(proc, n, steps, functionals=fns,
                                        antithetic=anti, **kw)
                want = fused_functionals_reference(
                    proc, n, steps, functionals=fns, antithetic=anti, **kw)
                for k in want:
                    _, max_abs, _ = compare(f"K4 {kind} {k} {label}",
                                            got[k], want[k], BITWISE)
                    errs["fused_functionals"] = max(
                        errs.get("fused_functionals", 0.0), max_abs)
                del got, want
        torch.cuda.synchronize()


def rbergomi_model(steps, device="cuda", **kw):
    """The CLI's default model (xi0 = 0.04, eta = 1.5, rho = -0.7, H = 0.1,
    T = 1) unless ``kw`` says otherwise."""
    from montecarlo_tpu_torch.processes import RoughBergomi

    args = dict(s0=100.0, xi0=0.04, eta=1.5, rho=-0.7, h=0.1, T=1.0)
    args.update(kw)
    return RoughBergomi.create(n_steps=steps, device=device, **args)


def phase_parity_rbergomi(torch, errs, n):
    """K5 at n x {504, 756, 37} columns (2T and 3T for T = 252, and an odd
    count) and K6 at n x {252, 17} steps, fed the same joint matrix,
    against their plain versions, bitwise; path ids wrap past 2^32."""
    from montecarlo_tpu_torch.ops import (normal_matrix,
                                          normal_matrix_reference,
                                          rbergomi_terminal,
                                          rbergomi_terminal_reference)
    from montecarlo_tpu_torch.precision import factor_product

    for cols in (504, 756, 37):
        kw = dict(path_offset=WRAP, device="cuda")
        _, max_abs, _ = compare(
            f"K5 {n}x{cols} offset 2^32-500",
            normal_matrix(21, 3, n, cols, **kw),
            normal_matrix_reference(21, 3, n, cols, **kw), BITWISE)
        errs["normal_matrix"] = max(errs.get("normal_matrix", 0.0), max_abs)
        torch.cuda.synchronize()
    for steps in (252, 17):
        model = rbergomi_model(steps)
        z = normal_matrix(21, 3, n, 2 * steps, path_offset=WRAP,
                          device="cuda")
        args = (factor_product(model.chol, z), model.tpow(),
                model.kernel_params(), 21, 3)
        kw = dict(n_steps=steps, path_offset=WRAP)
        _, max_abs, _ = compare(f"K6 {n}x{steps} offset 2^32-500",
                                rbergomi_terminal(*args, **kw),
                                rbergomi_terminal_reference(*args, **kw),
                                BITWISE)
        errs["rbergomi_terminal"] = max(errs.get("rbergomi_terminal", 0.0),
                                        max_abs)
        del z, args
        torch.cuda.synchronize()


def phase_main_shapes(torch, errs):
    """Each kernel against its plain version, and both timed, at the
    shapes the main path gives it: K1 at bench's 2^20 x 1024, K2 at the
    CLI's 2^20 x 252 (plain and antithetic), K3 at the tolerance run's
    2^22 x 252 chunks, first and last (path ids up to ~1.6e8)."""
    from montecarlo_tpu_torch.engine import VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_terminal,
                                          fused_terminal_reference,
                                          gbm_terminal, gbm_terminal_reference)
    from montecarlo_tpu_torch.processes import GBM

    t = {}
    check = functools.partial(timed_check, t, errs)
    n1, s1 = 1 << 20, 1024
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s1, device="cuda")
    check("gbm_terminal", f"K1 {n1}x{s1}",
          lambda: gbm_terminal(gbm, n1, s1, seed=1000),
          lambda: gbm_terminal_reference(gbm, n1, s1, seed=1000),
          3, PRICE_RTOL, bnd=step_bound(n1, s1, extra_fp=EXP32_FP))
    n2, s2 = 1 << 20, 252
    proc = GBM.create(100.0, 0.03, 0.2, 1.0 / s2, device="cuda")
    for anti in (False, True):
        check("fused_terminal",
              f"K2 {'antithetic' if anti else 'plain'} {n2}x{s2}",
              lambda: fused_terminal(proc, n2, s2, seed=0, antithetic=anti),
              lambda: fused_terminal_reference(proc, n2, s2, seed=0,
                                               antithetic=anti),
              10, PRICE_RTOL, bnd=step_bound(n2, s2, extra_fp=EXP32_FP))
    n3 = 1 << 22
    pay = VanillaPayoff("call", 105.0)
    for off in (0, 37 * n3):
        check("fused_block_moments", f"K3 call {n3}x{s2} offset {off}",
              lambda: fused_block_moments(proc, pay, n3, s2, seed=0,
                                          path_offset=off),
              lambda: fused_block_moments_reference(proc, pay, n3, s2,
                                                    seed=0, path_offset=off),
              5, MOMENT_RTOL, fields=("mean", "m2"),
              bnd=step_bound(n3, s2, out_bytes=8 / 128,
                             extra_fp=EXP32_FP + 8))
    main_shapes_slice2(torch, check)
    main_shapes_rbergomi(torch, check)
    return t


def main_shapes_slice2(torch, check):
    """K4 at the path-dependent path's shapes: GBM 2^20 x 252 with the
    Asian CLI's {avg}, the app's {avg, mx, mn} and the bridge's {surv};
    Heston {avg}; the autocall note's 2^17 x 252.  Heston K2 and K3 at the
    European path's shapes."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MAX,
                                             RUNNING_MIN, VanillaPayoff,
                                             autocallable,
                                             barrier_survival_up)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)
    from montecarlo_tpu_torch.processes import GBM

    n, steps = 1 << 20, 252
    dt = 1.0 / steps
    gbm = GBM.create(100.0, 0.03, 0.2, dt, device="cuda")
    hp = heston(steps)
    gbm_obs = 3 + EXP32_FP  # a GBM step and the exp32 of its observation
    heston_step = dict(draws=2, step_fp=HESTON_STEP_FP)
    cases = [
        ("K4 GBM {avg}", gbm, n, {"avg": ARITH_MEAN},
         step_bound(n, steps, step_fp=gbm_obs + 1, out_bytes=8,
                    extra_fp=EXP32_FP)),
        ("K4 GBM {avg,mx,mn}", gbm, n,
         {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN},
         step_bound(n, steps, step_fp=gbm_obs + 3, out_bytes=16,
                    extra_fp=EXP32_FP)),
        # The bridge survival: four float32 operations, an exp32, a product.
        ("K4 GBM {surv}", gbm, n,
         {"surv": barrier_survival_up(126.0, 0.2, dt)},
         step_bound(n, steps, step_fp=3 + 5 + EXP32_FP, out_bytes=8,
                    extra_fp=EXP32_FP)),
        ("K4 Heston {avg}", hp, n, {"avg": ARITH_MEAN},
         step_bound(n, steps, draws=2,
                    step_fp=HESTON_STEP_FP + EXP32_FP + 1, out_bytes=8,
                    extra_fp=EXP32_FP)),
        ("K4 GBM autocall", gbm, 1 << 17,
         {"note": autocallable(63, 100.0, 0.02, 0.03 * dt, 70.0, 100.0)},
         step_bound(1 << 17, steps, step_fp=gbm_obs + 2, out_bytes=8,
                    extra_fp=EXP32_FP)),
    ]
    for label, proc, paths, fns, bnd in cases:
        check("fused_functionals", f"{label} {paths}x{steps}",
              lambda: fused_functionals(proc, paths, steps, seed=0,
                                        functionals=fns),
              lambda: fused_functionals_reference(proc, paths, steps,
                                                  seed=0, functionals=fns),
              10, BITWISE, bnd=bnd)
    for anti in (False, True):
        label = f"K2 Heston {'antithetic' if anti else 'plain'}"
        check("fused_terminal", f"{label} {n}x{steps}",
              lambda: fused_terminal(hp, n, steps, seed=0, antithetic=anti),
              lambda: fused_terminal_reference(hp, n, steps, seed=0,
                                               antithetic=anti),
              10, BITWISE,
              bnd=step_bound(n, steps, extra_fp=EXP32_FP, **heston_step))
    n3 = 1 << 22
    pay = VanillaPayoff("call", 105.0)
    check("fused_block_moments", f"K3 Heston call {n3}x{steps}",
          lambda: fused_block_moments(hp, pay, n3, steps, seed=0),
          lambda: fused_block_moments_reference(hp, pay, n3, steps, seed=0),
          5, BITWISE, fields=("mean", "m2"),
          bnd=step_bound(n3, steps, out_bytes=8 / 128,
                         extra_fp=EXP32_FP + 8, **heston_step))


def main_shapes_rbergomi(torch, check):
    """K5 at the CLI's 2^20 x 504 and K6 at 2^20 x 252, fed the CLI's joint
    matrix, each against its plain version and both timed."""
    from montecarlo_tpu_torch.ops import (normal_matrix,
                                          normal_matrix_reference,
                                          rbergomi_terminal,
                                          rbergomi_terminal_reference)
    from montecarlo_tpu_torch.precision import factor_product

    n, steps = 1 << 20, 252
    pairs = (steps + 1) // 2
    # K5: one cipher call per column pair, 4 bytes out per entry.
    check("normal_matrix", f"K5 {n}x{2 * steps}",
          lambda: normal_matrix(0, 0, n, 2 * steps, device="cuda"),
          lambda: normal_matrix_reference(0, 0, n, 2 * steps,
                                          device="cuda"),
          10, BITWISE,
          bnd=bound(4 * n * 2 * steps, int32=n * steps * CIPHER_INT,
                    fp32=n * steps * BOXMULLER_FP))
    model = rbergomi_model(steps)
    joint = factor_product(model.chol, normal_matrix(0, 0, n, 2 * steps,
                                                     device="cuda"))
    args = (joint, model.tpow(), model.kernel_params(), 0, 0)
    # K6: reads the (2T, N) joint matrix, one cipher call per step pair,
    # per step an exp32 and 11 more float32 operations.
    check("rbergomi_terminal", f"K6 {n}x{steps}",
          lambda: rbergomi_terminal(*args, n_steps=steps),
          lambda: rbergomi_terminal_reference(*args, n_steps=steps),
          10, BITWISE,
          bnd=bound(4 * n * (2 * steps + 1), int32=n * pairs * CIPHER_INT,
                    fp32=n * (pairs * BOXMULLER_FP
                              + steps * (11 + EXP32_FP))))


def phase_factor_precision(torch):
    """The factor product on the card against a float64 product of the
    same float32 operands, at the CLI's 2^20 x 252, with a process-wide
    TF32 setting in force (the sampler must override it and restore it).

    Bound: every entry within gamma_2T = 2T*u/(1 - 2T*u), u = 2^-24, of
    (|chol| @ |z|), the rounding bound of a float32 dot product of length
    2T in any summation order (3.0e-5 at T = 252).  TF32 rounds both
    operands to 11 significant bits: on the first row, a single product,
    that rounding alone is of order 2^-11 = 4.9e-4 of |chol| @ |z|.  The
    same product taken with TF32 left on is measured beside it as the
    control."""
    from montecarlo_tpu_torch.ops import normal_matrix
    from montecarlo_tpu_torch.precision import factor_product

    n, steps = 1 << 20, 252
    model = rbergomi_model(steps)
    z = normal_matrix(4, 0, n, 2 * steps, device="cuda")
    nu = 2 * steps * 2.0**-24
    gamma = nu / (1 - nu)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        joint = factor_product(model.chol, z)
        restored = torch.get_float32_matmul_precision() == "high"
        tf32 = torch.matmul(model.chol, z)   # the control: TF32 allowed
    finally:
        torch.set_float32_matmul_precision(before)
    chol64, z64 = model.chol.double(), z.double()
    del z
    ref = chol64 @ z64
    scale = chol64.abs() @ z64.abs()
    del z64
    out = {}
    for name, got in (("true float32", joint), ("TF32 control", tf32)):
        err = (got.double() - ref).abs()
        out[name] = (float(err.max()), float((err / scale).max()))
        log(f"  factor product {n}x{2 * steps}, {name}: max abs err "
            f"{out[name][0]:.3e}, max err / (|chol| @ |z|) "
            f"{out[name][1]:.3e} (bound {gamma:.3e})")
        del err
    del ref, scale, joint, tf32
    torch.cuda.synchronize()
    if not restored:
        raise AssertionError("the sampler left the matmul precision changed")
    if out["true float32"][1] > gamma:
        raise AssertionError("factor product outside the float32 bound")


def phase_sampler_split(torch, n, steps, reps, **kw):
    """The whole sampler at n x steps, and its split into K5, the factor
    product and K6, by CUDA events; the host's model set-up (the float64
    Cholesky factor) by the host clock."""
    from montecarlo_tpu_torch.ops import normal_matrix, rbergomi_terminal
    from montecarlo_tpu_torch.processes import rbergomi_simulate
    from montecarlo_tpu_torch.precision import factor_product

    t0 = time.perf_counter()
    model = rbergomi_model(steps, **kw)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    whole, s_t = cuda_ms(lambda: rbergomi_simulate(model, n, seed=0), reps)
    k5, z = cuda_ms(lambda: normal_matrix(0, 0, n, 2 * steps,
                                          device="cuda"), reps)
    mm, joint = cuda_ms(lambda: factor_product(model.chol, z), reps)
    tpow, params = model.tpow(), model.kernel_params()
    k6, prices = cuda_ms(lambda: rbergomi_terminal(joint, tpow, params, 0, 0,
                                                   n_steps=steps), reps)
    if not torch.equal(prices, s_t):
        raise AssertionError("the timed pieces differ from the sampler")
    rate = n * steps / (whole * 1e-3)
    parts = k5 + mm + k6
    log(f"  sampler {n}x{steps}: {whole:.3f} ms, {rate:.4e} path-steps/s; "
        f"K5 {k5:.3f} ms ({100 * k5 / parts:.1f}%), product {mm:.3f} ms "
        f"({100 * mm / parts:.1f}%), K6 {k6:.3f} ms "
        f"({100 * k6 / parts:.1f}%); model set-up on the host "
        f"{setup:.3f} s")
    del z, joint, prices, s_t
    torch.cuda.synchronize()


def run_cli(argv):
    from montecarlo_tpu_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{argv}: exit code {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1]), wall


def check_price(label, out):
    price, se, bs = out["price"], out["std_err"], out["black_scholes"]
    ok = math.isfinite(price) and abs(price - bs) < 5 * se + 1e-3
    log(f"  {label}: {json.dumps(out)} -> |price - bs| = "
        f"{abs(price - bs):.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{label}: price {price} vs Black-Scholes {bs}")


def phase_main_path(torch):
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    fixed = ["price", "--paths", "1048576", "--steps", "252"]
    vanilla, _ = run_cli(fixed)
    check_price("price --paths 1048576 --steps 252", vanilla)
    out, _ = run_cli(fixed + ["--sampler", "antithetic"])
    check_price("price ... --sampler antithetic", out)
    out, wall = run_cli(["price", "--target-se", "1e-3", "--steps", "252"])
    check_price("price --target-se 1e-3 --steps 252", out)
    if not out["std_err"] <= 1e-3:
        raise AssertionError(f"target-se run stopped at {out['std_err']}")
    log(f"  wall-clock to std-err 1e-3: {wall:.3f} s "
        f"({out['n_paths']} paths)")
    bench, _ = run_cli(["bench"])
    log(f"  bench: {json.dumps(bench)}")
    counts = launch_counts()
    log(f"  launches on the European path: {counts}")
    missing = [k for k in ("gbm_terminal", "fused_terminal",
                           "fused_block_moments") if counts[k] < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return counts, bench, wall, out["n_paths"], vanilla


def run_k4_cli(argv):
    """One CLI run of the path-dependent path; it must launch K4."""
    from montecarlo_tpu_torch.ops import launch_counts

    before = launch_counts()["fused_functionals"]
    out, wall = run_cli(argv)
    launched = launch_counts()["fused_functionals"] - before
    log(f"  {' '.join(argv)}: {json.dumps(out)} ({launched} K4 launches, "
        f"{wall:.3f} s wall-clock)")
    if launched < 1:
        raise AssertionError(f"{argv}: K4 was not launched")
    values = [v for v in out.values() if isinstance(v, float)]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{argv}: non-finite output {out}")
    return out


def phase_path_dependent(torch, vanilla):
    """The path-dependent path through the CLI and the engine, launch
    counters reset just before and read just after.  ``vanilla`` is the
    European path's ``price --paths 1048576 --steps 252`` output."""
    import numpy as np

    from montecarlo_tpu_torch.engine import (GEO_MEAN, asian_call,
                                             geometric_asian_call_closed_form,
                                             mc_estimate,
                                             simulate_functionals)
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts
    from montecarlo_tpu_torch.processes import GBM

    reset_launch_counts()
    fixed = ["--paths", "1048576", "--steps", "252"]
    asian = run_k4_cli(["price", "--payoff", "asian", *fixed])
    run_k4_cli(["price", "--payoff", "asian", *fixed, "--sampler",
                "antithetic"])
    hest = run_k4_cli(["price", "--payoff", "asian", *fixed, "--process",
                       "heston"])
    ko = run_k4_cli(["price", "--payoff", "up-and-out", "--bridge", *fixed])
    ki = run_k4_cli(["price", "--payoff", "up-and-in", "--bridge", *fixed])
    note = run_k4_cli(["note", "--type", "autocall"])
    leg = run_k4_cli(["note", "--type", "cliquet"])
    # The engine's geometric Asian on the card against its closed form.
    s0, k, r, sigma, steps = 100.0, 105.0, 0.03, 0.2, 252
    proc = GBM.create(s0, r, sigma, 1.0 / steps, device="cuda")
    out = simulate_functionals(proc, 1 << 20, steps, seed=0,
                               functionals={"geo": GEO_MEAN})
    est = mc_estimate(asian_call(out["geo"], k), float(np.exp(-r)))
    geo, se = float(est["price"]), float(est["std_err"])
    cf = geometric_asian_call_closed_form(s0, k, r, sigma, 1.0, steps)
    counts = launch_counts()
    log(f"  launches on the path-dependent path: {counts}")
    ok_geo = abs(geo - cf) < 5 * se + 1e-3
    log(f"  geometric Asian {geo:.6f} +- {se:.2e} vs closed form {cf:.6f}: "
        f"{'ok' if ok_geo else 'FAIL'}")
    parity = ko["price"] + ki["price"]
    ok_parity = abs(parity - vanilla["price"]) <= 1e-5 * vanilla["price"]
    log(f"  KO + KI = {ko['price']:.6f} + {ki['price']:.6f} = {parity:.6f} "
        f"vs call {vanilla['price']:.6f}: {'ok' if ok_parity else 'FAIL'}")
    # AM >= GM pathwise, and the Asian averages away volatility.
    bs, a = vanilla["black_scholes"], asian["price"]
    ok_asian = cf - 5 * asian["std_err"] < a < bs
    log(f"  Asian {a:.6f} between the geometric closed form {cf:.6f} and "
        f"Black-Scholes {bs:.6f}: {'ok' if ok_asian else 'FAIL'}")
    checks = {"geometric Asian vs closed form": ok_geo,
              "KO + KI = vanilla": ok_parity,
              "GM <= Asian <= BS": ok_asian,
              "Heston Asian > 0": hest["price"] > 0,
              "autocall note in (0.5, 1.2)":
                  0.5 < note["autocall_note"] < 1.2,
              "cliquet leg >= 0": leg["cliquet_leg"] >= 0,
              "K4 launched": counts["fused_functionals"] >= 1}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path-dependent checks failed: {failed}")
    return counts


def run_rbergomi_cli(argv):
    """One CLI run of the rough-Bergomi path; it must launch K5 and K6."""
    from montecarlo_tpu_torch.ops import launch_counts

    keys = ("normal_matrix", "rbergomi_terminal")
    before = launch_counts()
    out, wall = run_cli(["price", "--process", "rbergomi", *argv])
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in keys}
    log(f"  price --process rbergomi {' '.join(argv)}: {json.dumps(out)} "
        f"({launched} launches, {wall:.3f} s wall-clock)")
    if min(launched.values()) < 1:
        raise AssertionError(f"{argv}: K5 or K6 was not launched")
    if not (math.isfinite(out["price"]) and math.isfinite(out["std_err"])):
        raise AssertionError(f"{argv}: non-finite output {out}")
    return out, wall


def phase_rbergomi(torch):
    """The rough-Bergomi path through the CLI and the sampler, launch
    counters reset just before and read just after."""
    from montecarlo_tpu_torch.engine import black_scholes_call
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts
    from montecarlo_tpu_torch.processes import rbergomi_simulate

    reset_launch_counts()
    full = ["--paths", "1048576", "--steps", "252"]
    first, wall = run_rbergomi_cli(full)
    again, _ = run_rbergomi_cli(full)
    default, _ = run_rbergomi_cli([])
    flat, _ = run_rbergomi_cli([*full, "--eta", "0", "--rho", "0",
                                "--rate", "0"])
    bs = black_scholes_call(100.0, 105.0, 0.0, math.sqrt(0.04), 1.0)
    s_t = rbergomi_simulate(rbergomi_model(252), 1 << 20, seed=0).double()
    mean, se = float(s_t.mean()), float(s_t.std() / math.sqrt(s_t.numel()))
    del s_t
    small = ["--paths", "65536", "--steps", "16"]
    on_card, _ = run_rbergomi_cli(small)
    on_cpu, _ = run_cli(["price", "--process", "rbergomi", *small,
                         "--device", "cpu"])
    counts = launch_counts()
    log(f"  launches on the rough-Bergomi path: {counts}")
    rel = max(abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k])
              for k in ("price", "std_err"))
    checks = {
        "same seed, same bits": first == again,
        "eta = 0 is Black-Scholes":
            abs(flat["price"] - bs) < 5 * flat["std_err"] + 1e-3,
        "martingale": abs(mean - 100.0) < 5 * se,
        "card vs cpu 65536x16": rel <= RBERGOMI_CPU_RTOL,
        "default --paths 100000": default["n_paths"] == 100000,
    }
    log(f"  eta = 0: {flat['price']:.6f} +- {flat['std_err']:.2e} vs "
        f"Black-Scholes {bs:.6f}; mean S_T {mean:.6f} +- {se:.2e} vs 100; "
        f"card vs cpu rel {rel:.3e} (rtol {RBERGOMI_CPU_RTOL:.0e}); "
        f"2^20 x 252 CLI wall-clock {wall:.3f} s")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"rough-Bergomi checks failed: {failed}")
    return counts


# Peak rates of one H100 SXM at its full 700 W: HBM and float32 from the
# data sheet; int32 from the Hopper white paper's 64 INT32 lanes per SM x
# 132 SMs x the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
INT32_PER_S = 132 * 64 * 1.98e9
# Lower bounds on the operations of the device math: Threefry-2x32-20 is 20
# rounds of add, rotate and xor plus the key injections, at least 64 int32
# operations after three-input adds; exp32 at least 20 float32 operations;
# Box-Muller's uniforms and products 7 (its log, sqrt, sin and cos are not
# counted, so every bound below is loose where they matter).
CIPHER_INT, EXP32_FP, BOXMULLER_FP = 64, 20, 7


def bound(n_bytes, int32=0.0, fp32=0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and each kind of operation over its peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(int32 / INT32_PER_S, fp32 / FP32_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def step_bound(n, steps, draws=1, step_fp=3, out_bytes=4, extra_fp=0):
    """A fused time loop over n paths: ``draws`` cipher calls per step pair
    (and a Box-Muller pair each), ``step_fp`` float32 operations per step,
    ``extra_fp`` per path (prices, epilogue), ``out_bytes`` per path."""
    pairs = (steps + 1) // 2
    calls = n * pairs * draws
    return bound(n * out_bytes, int32=calls * CIPHER_INT,
                 fp32=calls * BOXMULLER_FP + n * (steps * step_fp + extra_fp))


def basket_bound(n, steps, a_n, observe=False, out_bytes=4, extra_fp=0):
    """BasketProc in the fused loop: A cipher calls per step pair; per step
    the unrolled Cholesky (A(A+1)/2 multiplies, A(A-1)/2 adds) and the
    grouped increment (3A); the basket value (A exp32 and A multiply-adds)
    once per path, and after every step too when ``observe`` (K4's
    price-space observation, plus its fold)."""
    value = a_n * (EXP32_FP + 2)
    step_fp = a_n * a_n + 3 * a_n + (value + 1 if observe else 0)
    return step_bound(n, steps, draws=a_n, step_fp=step_fp,
                      out_bytes=out_bytes, extra_fp=value + extra_fp)


def k7_bound(n, steps, a_n):
    """K7: per pair A cipher calls, two correlations (2A^2), two updates
    (6A); then A exp32 and the weighted sum; 4 bytes out per path."""
    pairs = (steps + 1) // 2
    calls = n * pairs * a_n
    fp = (calls * BOXMULLER_FP + n * pairs * (2 * a_n * a_n + 6 * a_n)
          + n * (a_n * (EXP32_FP + 2)))
    return bound(4 * n, int32=calls * CIPHER_INT, fp32=fp)


HESTON_STEP_FP = 17  # the full-truncation step's multiplies, adds, max


def run_cli_rows(argv):
    """A CLI run that prints one JSON object per line: all of them."""
    from montecarlo_tpu_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{argv}: exit code {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines()], wall


def basket_closed_form(basket, t):
    """Mean and variance of the basket value at time t under correlated
    GBM, from the float32 leaves taken to float64."""
    import numpy as np

    from montecarlo_tpu_torch.convert import process_to_numpy

    leaves = {k: v.astype(np.float64)
              for k, v in process_to_numpy(basket).items()}
    a_n = leaves["s0"].shape[0]
    chol = leaves["chol_flat"].reshape(a_n, a_n)
    mean_s = leaves["s0"] * np.exp(leaves["mu"] * t)
    sig, w = leaves["sigma"], leaves["weights"]
    cov = np.outer(mean_s, mean_s) * (
        np.exp(np.outer(sig, sig) * (chol @ chol.T) * t) - 1.0)
    return float(w @ mean_s), float(w @ cov @ w)


def moments_gate(label, vals, basket, t):
    """tests/test_basket_kernel.py's gate: mean within 4 se, variance
    within 6 sqrt(2/n) var of the closed form."""
    vals = vals.double()
    n = vals.numel()
    mean, var = float(vals.mean()), float(vals.var())
    exact_mean, exact_var = basket_closed_form(basket, t)
    se = math.sqrt(var / n)
    ok = (abs(mean - exact_mean) < 4 * se + 1e-6
          and abs(var - exact_var) < 6 * exact_var * math.sqrt(2.0 / n))
    log(f"  {label}: mean {mean:.6f} vs {exact_mean:.6f} (se {se:.2e}), "
        f"var {var:.4f} vs {exact_var:.4f}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: moments off the closed form")


def phase_basket_parity(torch, errs, times):
    """K7 and BasketProc K2-K4 against their plain versions, bitwise, at
    small shapes and at the multi-asset path's own, and the closed-form
    gates; the K7 row of ``times`` is its bench shape's."""
    from montecarlo_tpu_torch.bench import (BASKET_PATHS, BASKET_STEPS,
                                            K2_ASSETS, bench_basket)
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MAX,
                                             RUNNING_MIN, VanillaPayoff)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference,
                                          packed_basket_terminal,
                                          packed_basket_terminal_reference)

    def k7_check(label, basket, n, steps, offset=0, full=None):
        kw = dict(seed=13, path_offset=offset)
        got = (packed_basket_terminal(basket, n, steps, **kw) if full is None
               else full[offset:offset + n])
        _, max_abs, _ = compare(label, got, packed_basket_terminal_reference(
            basket, n, steps, **kw), BITWISE)
        errs["packed_basket_terminal"] = max(
            errs.get("packed_basket_terminal", 0.0), max_abs)

    n = 1 << 16
    for a_n in (5, 16, 20, 64, 128):
        basket = bench_basket(a_n)
        for steps in (7, 8):
            k7_check(f"K7 A={a_n} {n}x{steps}", basket, n, steps)
    k7_check(f"K7 A=16 {n}x8 offset 2^32-2^15", bench_basket(16), n, 8,
             offset=2**32 - 2**15)
    torch.cuda.synchronize()
    # The bench's widest row, its 2^14-path tail recomputed by the plain
    # version through path_offset (results are shard-invariant).
    nb, tb, sl = BASKET_PATHS, BASKET_STEPS, 1 << 14
    wide = bench_basket(128)
    k7_ms, full = cuda_ms(lambda: packed_basket_terminal(wide, nb, tb,
                                                         seed=13), 3)
    t0 = time.perf_counter()
    k7_check(f"K7 A=128 {nb}x{tb}, paths [{nb - sl}, {nb})", wide, sl, tb,
             offset=nb - sl, full=full)
    torch.cuda.synchronize()
    k7_plain_ms = 1e3 * (time.perf_counter() - t0)
    del full
    k7_bnd = k7_bound(nb, tb, 128)
    times["packed_basket_terminal"] = {
        "ms": k7_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bnd[0],
        "bound_by": k7_bnd[1], "shape": f"{nb} paths x {tb} steps x 128 assets",
        "plain_shape": f"{sl} paths x {tb} steps x 128 assets"}
    log(f"  K7 A=128 {nb}x{tb}: kernel {k7_ms:.3f} ms, bound "
        f"{k7_bnd[0]:.4f} ms ({k7_bnd[1]}); plain version on {sl} of its "
        f"paths {k7_plain_ms:.3f} ms (host clock, with the comparison)")

    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN}
    pay = VanillaPayoff("call", 95.0)
    n, steps = 1 << 14, 17
    for a_n in (3, 5, 16, 17):
        basket = bench_basket(a_n)
        for anti in (False, True):
            label = f"A={a_n} {n}x{steps} {'antithetic' if anti else 'plain'}"
            kw = dict(seed=17, path_offset=WRAP, antithetic=anti)
            cases = [
                ("K2", "fused_terminal", fused_terminal(basket, n, steps, **kw),
                 fused_terminal_reference(basket, n, steps, **kw))]
            got = fused_block_moments(basket, pay, n, steps, **kw)
            want = fused_block_moments_reference(basket, pay, n, steps, **kw)
            cases += [(f"K3 call {f}", "fused_block_moments",
                       getattr(got, f), getattr(want, f))
                      for f in ("mean", "m2")]
            want = fused_functionals_reference(basket, n, steps,
                                               functionals=fns, **kw)
            got = fused_functionals(basket, n, steps, functionals=fns, **kw)
            one = fused_functionals(basket, n, steps,
                                    functionals={"avg": ARITH_MEAN}, **kw)
            cases += [(f"K4 {{avg,mx,mn}} {k}", "fused_functionals", got[k],
                       want[k]) for k in want]
            cases += [(f"K4 {{avg}} {k}", "fused_functionals", one[k],
                       want[k]) for k in one]
            for name, key, g, w in cases:
                _, max_abs, _ = compare(f"{name} basket {label}", g, w,
                                        BITWISE)
                errs[key] = max(errs.get(key, 0.0), max_abs)
            del cases, got, want, one
    torch.cuda.synchronize()

    # Closed-form gates on the card.
    for a_n in (16, 32):
        basket = bench_basket(a_n, seed=1)
        moments_gate(f"K7 A={a_n} 65536x16",
                     packed_basket_terminal(basket, 1 << 16, 16, seed=11),
                     basket, 16 / 252)
    basket = bench_basket(5, seed=1)
    moments_gate("K2 basket A=5 262144x64",
                 fused_terminal(basket, 1 << 18, 64, seed=11), basket,
                 64 / 252)

    # K2, K3 and K4 on the basket at the shapes the multi-asset path gives
    # them, kernel against plain version bitwise, both timed: K2 at each of
    # bench --basket's rows (seed 1000 is its first timed launch), K3 at
    # price_to_tolerance's 2^22 x 252 chunks on the 5-asset call (the first
    # and the 31st), K4 at the engine's basket Asian (phase_multi_asset).
    check = functools.partial(timed_check, times, errs)
    for a_n in K2_ASSETS:
        basket = bench_basket(a_n)
        check("fused_terminal", f"K2 basket A={a_n} {nb}x{tb}",
              lambda: fused_terminal(basket, nb, tb, seed=1000),
              lambda: fused_terminal_reference(basket, nb, tb, seed=1000),
              3, BITWISE, bnd=basket_bound(nb, tb, a_n))
    basket = bench_basket(5)
    n3, s3 = TOL_CHUNK, TOL_STEPS
    tol_pay = VanillaPayoff("call", BASKET_STRIKE)
    for chunk in (0, 30):
        check("fused_block_moments",
              f"K3 basket A=5 call {n3}x{s3} chunk {chunk}",
              lambda: fused_block_moments(basket, tol_pay, n3, s3,
                                          seed=0, path_offset=chunk * n3),
              lambda: fused_block_moments_reference(
                  basket, tol_pay, n3, s3, seed=0,
                  path_offset=chunk * n3),
              3, BITWISE, fields=("mean", "m2"),
              bnd=basket_bound(n3, s3, 5, out_bytes=8 / 128, extra_fp=8))
    n4 = ASIAN_PATHS
    check("fused_functionals", f"K4 basket A=5 {{avg}} {n4}x{s3}",
          lambda: fused_functionals(basket, n4, s3, seed=0,
                                    functionals={"avg": ARITH_MEAN}),
          lambda: fused_functionals_reference(
              basket, n4, s3, seed=0, functionals={"avg": ARITH_MEAN}),
          3, BITWISE, bnd=basket_bound(n4, s3, 5, observe=True, out_bytes=8))


def phase_multi_asset(torch):
    """The multi-asset path through the CLI and the engine, launch counters
    reset just before and read just after."""
    from montecarlo_tpu_torch.bench import bench_basket
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                             asian_call, black_scholes_call,
                                             mc_estimate, price_to_tolerance,
                                             simulate_functionals)
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    rows, wall = run_cli_rows(["bench", "--basket"])
    for row in rows:
        a_n, n, t = row["n_assets"], row["n_paths"], row["n_steps"]
        ms_, by = (k7_bound(n, t, a_n)
                   if row["kernel"] == "packed_basket_terminal"
                   else basket_bound(n, t, a_n))
        log(f"  bench --basket: {json.dumps(row)}; bound {ms_:.4f} ms ({by})")
    log(f"  bench --basket wall-clock {wall:.3f} s")
    mc5, wall5 = run_cli(["price", "--payoff", "max-call", "--n-assets", "5",
                          "--asset-corr", "0.5", "--paths", "1048576",
                          "--steps", "252"])
    log(f"  price --payoff max-call --n-assets 5 --asset-corr 0.5 --paths "
        f"1048576 --steps 252: {json.dumps(mc5)} ({wall5:.3f} s wall-clock)")
    mc1, wall1 = run_cli(["price", "--payoff", "max-call", "--n-assets",
                          "1"])
    bs = black_scholes_call(100.0, 105.0, 0.03, 0.2, 1.0)
    log(f"  price --payoff max-call --n-assets 1: {json.dumps(mc1)} vs "
        f"Black-Scholes {bs:.6f} ({wall1:.3f} s wall-clock)")
    one, wall_n1 = run_cli(["note", "--type", "autocall"])
    three, wall_n3 = run_cli(["note", "--type", "autocall", "--n-assets",
                              "3"])
    log(f"  note --type autocall: {json.dumps(one)} ({wall_n1:.3f} s); "
        f"--n-assets 3: {json.dumps(three)} ({wall_n3:.3f} s wall-clock)")
    basket = bench_basket(5)  # weights 1/5
    disc = math.exp(-0.03)
    t0 = time.perf_counter()
    est = price_to_tolerance(basket, VanillaPayoff("call", BASKET_STRIKE),
                             target_std_err=1e-3, seed=0,
                             chunk_paths=TOL_CHUNK, n_steps=TOL_STEPS,
                             discount=disc)
    price, se = float(est["price"]), float(est["std_err"])
    wall_tol = time.perf_counter() - t0
    log(f"  price_to_tolerance, 5-asset basket call (K3): {price:.6f} +- "
        f"{se:.2e}, {int(est['n_paths'])} paths in {est['n_chunks']} "
        f"chunks, {wall_tol:.3f} s wall-clock")
    # The basket's arithmetic-average Asian call through the engine: the
    # one user path here that folds a basket functional (K4 on BasketProc).
    k4_before = launch_counts()["fused_functionals"]
    t0 = time.perf_counter()
    out = simulate_functionals(basket, ASIAN_PATHS, TOL_STEPS, seed=0,
                               functionals={"avg": ARITH_MEAN})
    asian = mc_estimate(asian_call(out["avg"], BASKET_STRIKE), disc)
    a_price, a_se = float(asian["price"]), float(asian["std_err"])
    wall_asian = time.perf_counter() - t0
    k4_basket = launch_counts()["fused_functionals"] - k4_before
    del out
    log(f"  simulate_functionals, 5-asset basket Asian call (K4): "
        f"{a_price:.6f} +- {a_se:.2e}, {ASIAN_PATHS} x {TOL_STEPS}, "
        f"{k4_basket} K4 launches, {wall_asian:.3f} s wall-clock")
    counts = launch_counts()
    log(f"  launches on the multi-asset path: {counts}")
    se1, se3 = one["std_err"], three["std_err"]
    checks = {
        "bench rows": [(r["kernel"], r["n_assets"]) for r in rows] == [
            ("packed_basket_terminal", a) for a in (8, 16, 32, 64, 128)] + [
            ("fused_terminal", a) for a in (5, 8, 16)],
        "bench rates finite": all(math.isfinite(r["path_steps_per_sec"])
                                  and r["path_steps_per_sec"] > 0
                                  for r in rows),
        "max-call A=5 finite, above the one-asset call":
            math.isfinite(mc5["price"]) and mc5["price"] > mc1["price"],
        "max-call A=1 is Black-Scholes":
            abs(mc1["price"] - bs) < 5 * mc1["std_err"] + 1e-3,
        "worst-of note below the one-asset note":
            three["autocall_note"] < one["autocall_note"] - 4 * (se1 + se3),
        "basket tolerance run reached 1e-3":
            math.isfinite(price) and se <= 1e-3,
        # A submartingale's average is worth less than its end.
        "basket Asian in (0, basket call)":
            0 < a_price < price + 5 * (a_se + se),
        # Only baskets launch K7, K2 and K3 in this phase (the max-call and
        # the worst-of note run the torch loop); the one-asset note also
        # launches K4, so K4's basket launch is counted around its call.
        "K7, K2, K3 launched": all(counts[k] >= 1 for k in (
            "packed_basket_terminal", "fused_terminal",
            "fused_block_moments")),
        "K4 launched by the basket Asian": k4_basket >= 1,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"multi-asset checks failed: {failed}")
    return counts


# ---- phase 8: the GARCH path -------------------------------------------------

# Per GARCH step beyond the cipher: the uniform (a shift, a convert; an add
# and a multiply), the index (a multiply and a floor; a convert and a min),
# an IEEE sqrt counted as one, and the recurrence's 7 multiplies and adds.
GARCH_STEP_FP, GARCH_STEP_INT = 12, 4
# The reference's fixed GARCH parameters (reference app.py:601-603) and the
# app's 20-day horizon; the parity oracle's path count
# (tests/test_reference_parity.py).
GARCH_DAYS, ORACLE_SIMS = 20, 30_000
VAR_PATHS, VAR_CHUNK, VAR_BINS = 1 << 30, 1 << 24, 8192
#: The JAX CLI's `var` keys (engine/streaming.py::risk_dict).
VAR_KEYS = {"percentiles", "expected_return", "expected_vol", "prob_profit",
            "var_95", "var_95_std_err", "var_95_grid_err", "cvar_95",
            "cvar_95_grid_err", "std_err", "n_paths", "sketch_oob_fraction"}


def garch_bound(n, steps, out_bytes=4, extra_fp=0):
    """GarchProc in the fused loop: one cipher call per step pair, per step
    ``GARCH_STEP_FP`` float32 and ``GARCH_STEP_INT`` int32 operations,
    ``exp32`` once per path (the table is read from cache, not counted)."""
    pairs = (steps + 1) // 2
    return bound(n * out_bytes,
                 int32=n * (pairs * CIPHER_INT + steps * GARCH_STEP_INT),
                 fp32=n * (steps * GARCH_STEP_FP + EXP32_FP + extra_fp))


def garch_history(n_returns, seed=21):
    """The feature columns garch_monte_carlo reads, from a synthetic
    history of ``n_returns`` log returns (``data/synthetic.py``): log_ret
    (NaN first, as the feature layer has it) and rvol_20, the ddof-1
    rolling std over 20 days times sqrt(252) (quant/rolling.py), computed
    in numpy; and the spot."""
    import numpy as np

    from montecarlo_tpu_torch.data import generate_ohlcv

    close = generate_ohlcv(n_days=n_returns + 1, seed=seed)["Close"]
    log_ret = np.concatenate([[np.nan], np.diff(np.log(close))])
    win = np.lib.stride_tricks.sliding_window_view(log_ret[1:], 20)
    rvol = np.concatenate([np.full(20, np.nan),
                           win.std(axis=1, ddof=1) * np.sqrt(252.0)])
    return {"log_ret": log_ret, "rvol_20": rvol}, float(close[-1])


def garch_process(data, s0):
    from montecarlo_tpu_torch.processes import GARCHBootstrap

    r = data["log_ret"][1:]
    return GARCHBootstrap.create(r, s0=s0, var0=data["rvol_20"][-1] ** 2
                                 / 252.0, device="cuda")


def phase_garch_parity(torch, errs, times):
    """K2, K3 and K4 ({avg, mx, mn}) on GarchProc against their plain
    versions, bitwise, plain and antithetic, at 2^18 paths (K2 and K4 at
    2^18 - 37) x {20, 17, 252} steps on the 2- and 5-year tables, one run
    of each with ids wrapping past 2^32; then K2, K3 and K4 timed beside
    their plain versions and bounds at the GARCH path's shapes."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MAX,
                                             RUNNING_MIN, VanillaPayoff)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)

    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN}
    n = 1 << 18
    procs = {}
    for years, n_ret in ((2, 503), (5, 1259)):
        data, s0 = garch_history(n_ret)
        procs[years] = garch_process(data, s0)
        pay = VanillaPayoff("put", s0)
        for steps in (20, 17, 252):
            for anti in (False, True):
                off = WRAP if steps == 17 else 12345
                kw = dict(seed=19, path_offset=off, antithetic=anti)
                label = (f"{years}y {n}x{steps} "
                         f"{'antithetic' if anti else 'plain'} offset {off}")
                p = procs[years]
                cases = [("K2", "fused_terminal",
                          fused_terminal(p, n - 37, steps, **kw),
                          fused_terminal_reference(p, n - 37, steps, **kw))]
                got = fused_block_moments(p, pay, n, steps, **kw)
                want = fused_block_moments_reference(p, pay, n, steps, **kw)
                cases += [(f"K3 put {f}", "fused_block_moments",
                           getattr(got, f), getattr(want, f))
                          for f in ("mean", "m2")]
                got = fused_functionals(p, n - 37, steps, functionals=fns,
                                        **kw)
                want = fused_functionals_reference(p, n - 37, steps,
                                                   functionals=fns, **kw)
                cases += [(f"K4 {k}", "fused_functionals", got[k], want[k])
                          for k in want]
                for name, key, g, w in cases:
                    _, max_abs, _ = compare(f"{name} GARCH {label}", g, w,
                                            BITWISE)
                    errs[key] = max(errs.get(key, 0.0), max_abs)
                del cases, got, want
        torch.cuda.synchronize()

    check = functools.partial(timed_check, times, errs)
    five = procs[5]
    nv, sv = VAR_CHUNK, GARCH_DAYS
    chunk = {}
    timed_check(chunk, errs, "fused_terminal",
                f"K2 GARCH 5y {nv}x{sv} (a VaR chunk)",
                lambda: fused_terminal(five, nv, sv, seed=0,
                                       path_offset=7 * nv),
                lambda: fused_terminal_reference(five, nv, sv, seed=0,
                                                 path_offset=7 * nv),
                10, BITWISE, bnd=garch_bound(nv, sv))
    rates = {}
    for years, p in procs.items():
        n2, s2 = 1 << 20, 252
        key = f"K2 GARCH {years}y {n2}x{s2}"
        t = {}
        timed_check(t, errs, "fused_terminal", key,
                    lambda: fused_terminal(p, n2, s2, seed=0),
                    lambda: fused_terminal_reference(p, n2, s2, seed=0),
                    10, BITWISE, bnd=garch_bound(n2, s2))
        rates[years] = n2 * s2 / (t["fused_terminal"]["ms"] * 1e-3)
        log(f"  {key}: {rates[years]:.4e} path-steps/s "
            f"({p.table.numel()}-entry table)")
    pay = VanillaPayoff("put", float(five.s0))
    check("fused_block_moments", f"K3 GARCH 5y put {nv}x{sv}",
          lambda: fused_block_moments(five, pay, nv, sv, seed=0),
          lambda: fused_block_moments_reference(five, pay, nv, sv, seed=0),
          10, BITWISE, fields=("mean", "m2"),
          bnd=garch_bound(nv, sv, out_bytes=8 / 128, extra_fp=8))
    n4, s4 = 1 << 20, 252
    check("fused_functionals", f"K4 GARCH 5y {{avg,mx,mn}} {n4}x{s4}",
          lambda: fused_functionals(five, n4, s4, seed=0, functionals=fns),
          lambda: fused_functionals_reference(five, n4, s4, seed=0,
                                              functionals=fns),
          10, BITWISE, bnd=garch_bound(n4, s4, out_bytes=16))
    log(f"  K2 GARCH path-steps/s at 2^20 x 252: 2-year table "
        f"{rates[2]:.4e}, 5-year table {rates[5]:.4e}")
    return procs, chunk["fused_terminal"]["ms"]


def garch_oracle(returns, s0, var0, n_sims, n_days, rng):
    """tests/test_reference_parity.py's NumPy oracle of the reference
    recurrence (app.py:600-657), float64."""
    import numpy as np

    std_returns = returns / (returns.std() + 1e-10)
    prices = np.full(n_sims, s0)
    var = np.full(n_sims, var0)
    for _ in range(n_days):
        r = rng.choice(std_returns, size=n_sims) * np.sqrt(var)
        prices = prices * np.exp(r)
        var = 1e-5 + 0.10 * r**2 + 0.85 * var
    p = {q: np.percentile(prices, q) for q in (1, 5, 10, 25, 50, 75, 90, 95,
                                               99)}
    return {"percentiles": p,
            "expected_return": (prices.mean() / s0 - 1) * 100,
            "expected_vol": prices.std() / s0 * 100,
            "prob_profit": (prices > s0).mean() * 100,
            "var_95": (s0 - p[5]) / s0 * 100,
            "cvar_95": (s0 - prices[prices <= p[5]].mean()) / s0 * 100}


def run_counted(fn, *args, **kw):
    """(result, wall-clock s, K2/K3/K4 launches) of one call, the launch
    counters reset just before and read just after."""
    import torch

    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, launch_counts()


def phase_garch_mc(torch, chunk_ms):
    """garch_monte_carlo through the API on the 5-year synthetic history,
    20 days, the counters reset around each call; ``chunk_ms`` is K2's
    time for a 2^24 x 20 chunk, from which each call's K2 share is
    estimated."""
    import numpy as np

    from montecarlo_tpu_torch.api import garch_monte_carlo
    from montecarlo_tpu_torch.processes.garch_fit import fit_garch

    data, s0 = garch_history(1259)
    returns = data["log_ret"][1:]
    var0 = data["rvol_20"][-1] ** 2 / 252.0
    checks, runs = {}, {}
    for n_sims, keep in ((1000, True), (ORACLE_SIMS, True), (1 << 22, True),
                         (1 << 22, False)):
        out, wall, counts = run_counted(garch_monte_carlo, data, n_sims,
                                        GARCH_DAYS, s0, seed=4,
                                        keep_paths=keep)
        k2 = counts["fused_terminal"]
        runs[(n_sims, keep)] = out
        share = 100 * k2 * chunk_ms * 1e-3 * (n_sims / VAR_CHUNK) / wall
        log(f"  garch_monte_carlo {n_sims} sims x {GARCH_DAYS} days, "
            f"keep_paths={keep}: {wall:.3f} s wall-clock, {k2} K2 launches "
            f"(K2 ~{share:.1f}% of it); var_95 {out['var_95']:.4f}%, "
            f"cvar_95 {out['cvar_95']:.4f}%")
        checks[f"K2 launches at {n_sims}, keep_paths={keep}"] = (
            k2 == (0 if keep else 1))
        finite = all(np.isfinite(v) for k, v in out.items()
                     if isinstance(v, float))
        checks[f"finite at {n_sims}, keep_paths={keep}"] = finite and bool(
            np.isfinite(out["final_prices"]).all())
    kept, sketched = runs[(1 << 22, True)], runs[(1 << 22, False)]
    checks["K2 terminals = the kept paths' last row, bitwise"] = (
        np.array_equal(kept["final_prices"], sketched["final_prices"]))
    fp = sketched["final_prices"]
    width = 1.5 * (float(fp.max() - fp.min()) + 1e-6) / 2048
    off = max(float(np.max(np.abs(kept["path_percentiles"][k]
                                  - sketched["path_percentiles"][k])))
              for k in kept["path_percentiles"])
    log(f"  histogram bands vs exact bands at 2^22: max |diff| {off:.3e} "
        f"(one bin width {width:.3e})")
    checks["histogram bands within a bin width"] = off <= width
    del kept, sketched, runs[(1 << 22, True)], runs[(1 << 22, False)]

    ours = runs[(ORACLE_SIMS, True)]
    rng = np.random.default_rng(0)
    reps = [garch_oracle(returns, s0, var0, ORACLE_SIMS, GARCH_DAYS, rng)
            for _ in range(5)]

    def k_sigma(name, val, vals):
        mean, se = np.mean(vals), max(np.std(vals, ddof=1), 1e-6)
        ok = abs(val - mean) < 4.0 * se + 1e-9
        log(f"  oracle {name}: ours {val:.5f}, oracle {mean:.5f} +- "
            f"{se:.5f}: {'ok' if ok else 'FAIL'}")
        checks[f"oracle {name}"] = ok

    for k in ("expected_return", "expected_vol", "prob_profit", "var_95",
              "cvar_95"):
        k_sigma(k, ours[k], [r[k] for r in reps])
    for q in (1, 5, 10, 25, 50, 75, 90, 95, 99):
        k_sigma(f"p{q}", ours["percentiles"][f"p{q}"],
                [r["percentiles"][q] for r in reps])

    # tests/test_api.py's antithetic gate: the bands agree within noise,
    # and the expected return's spread over seeds shrinks.
    n_a = 1 << 22
    (plain, anti), wall, _ = run_counted(lambda: [
        garch_monte_carlo(data, n_a, GARCH_DAYS, s0, seed=1,
                          keep_paths=False, antithetic=a)
        for a in (False, True)])
    band = {k: o["percentiles"]["p95"] - o["percentiles"]["p5"]
            for k, o in (("plain", plain), ("antithetic", anti))}
    spread = {}
    for a in (False, True):
        er = [garch_monte_carlo(data, 1 << 16, GARCH_DAYS, s0, seed=s,
                                keep_paths=False,
                                antithetic=a)["expected_return"]
              for s in range(8)]
        spread[a] = float(np.std(er, ddof=1))
    log(f"  antithetic at 2^22: p95 - p5 band {band['antithetic']:.4f} vs "
        f"plain {band['plain']:.4f} ({wall:.3f} s for both); expected "
        f"return's std over 8 seeds at 2^16: {spread[True]:.5f} vs plain "
        f"{spread[False]:.5f}")
    checks["antithetic band agrees within 1%"] = (
        abs(band["antithetic"] / band["plain"] - 1) < 0.01)
    checks["antithetic shrinks the expected return's spread"] = (
        spread[True] < spread[False])

    (fitted, est), wall, _ = run_counted(lambda: (
        garch_monte_carlo(data, 1000, GARCH_DAYS, s0, seed=4,
                          fit_params=True),
        fit_garch(returns)))
    log(f"  fit_params=True at 1000 sims (and the fit again): {wall:.3f} s; "
        f"omega {est.omega:.3e}, alpha {est.alpha:.4f}, beta "
        f"{est.beta:.4f}; var_95 {fitted['var_95']:.4f}%")
    checks["fitted alpha + beta < 1"] = (est.alpha + est.beta < 1
                                         and min(est) > 0)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"garch_monte_carlo checks failed: {failed}")


def phase_garch_var(torch, procs, chunk_ms):
    """portfolio_var_on_device at 2^30 paths x 20 days in 2^24-path
    chunks, 8192 bins, on GARCH (5-year table) and on GBM at the var CLI's
    defaults; the sketch against the exact statistics of the same K2
    terminals at 2^22; ``var --on-device`` at its defaults."""
    import numpy as np

    from montecarlo_tpu_torch.api import portfolio_var_on_device
    from montecarlo_tpu_torch.ops import fused_terminal
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.stats.risk import terminal_statistics

    checks = {}
    five = procs[5]
    gbm = GBM.create(s0=100.0, mu=0.05, sigma=0.25, dt=1 / 252,
                     device="cuda")
    n_chunks = VAR_PATHS // VAR_CHUNK
    out = {}
    for name, proc in (("GARCH 5y", five), ("GBM", gbm)):
        s0 = float(proc.s0)
        res, wall, counts = run_counted(
            portfolio_var_on_device, proc, VAR_PATHS, GARCH_DAYS, s0,
            seed=0, bins=VAR_BINS, chunk_paths=VAR_CHUNK)
        k2 = counts["fused_terminal"]
        passes = k2 // n_chunks
        out[name] = res
        share = (f"K2 ~{100 * k2 * chunk_ms * 1e-3 / wall:.1f}% of it"
                 if name.startswith("GARCH") else "")
        log(f"  portfolio_var_on_device {name}, {VAR_PATHS} x {GARCH_DAYS} "
            f"in {n_chunks} chunks: {wall:.3f} s wall-clock, "
            f"{VAR_PATHS / wall:.4e} paths/s, {k2} K2 launches ({passes} "
            f"pass(es)) {share}; {json.dumps(res)}")
        checks[f"{name}: K2 launched once per chunk"] = (
            k2 == passes * n_chunks and passes in (1, 2))
        checks[f"{name}: n_paths"] = res["n_paths"] == VAR_PATHS
    # The lognormal closed form of the GBM p5 (float32 dt as the process).
    g = out["GBM"]
    t = GARCH_DAYS * float(np.float32(1 / 252))
    z05 = -1.6448536269514729
    p5 = 100.0 * math.exp((0.05 - 0.5 * 0.25**2) * t + 0.25 * math.sqrt(t)
                          * z05)
    var_cf = (100.0 - p5) / 100.0 * 100.0
    tol = g["var_95_grid_err"] + 4 * g["var_95_std_err"]
    log(f"  GBM var_95 {g['var_95']:.5f}% vs closed form {var_cf:.5f}% "
        f"(tolerance {tol:.5f}%)")
    checks["GBM var_95 at the closed form"] = abs(g["var_95"] - var_cf) < tol

    # One 2^22 chunk on GARCH: the sketch against the exact statistics of
    # the same K2 terminals (same seed, same ids).
    n1 = 1 << 22
    s0 = float(five.s0)
    sk = portfolio_var_on_device(five, n1, GARCH_DAYS, s0, seed=5,
                                 bins=VAR_BINS, chunk_paths=n1)
    exact = terminal_statistics(fused_terminal(five, n1, GARCH_DAYS, seed=5),
                                s0)
    for k in ("var_95", "cvar_95"):
        d = abs(sk[k] - float(exact[k]))
        log(f"  GARCH {k} at 2^22, sketch {sk[k]:.5f}% vs exact "
            f"{float(exact[k]):.5f}%: |diff| {d:.2e} (grid error "
            f"{sk[k + '_grid_err']:.2e})")
        checks[f"GARCH {k} sketch within its grid error"] = (
            d <= sk[k + "_grid_err"])

    res, wall = run_cli(["var", "--on-device"])
    log(f"  var --on-device: {json.dumps(res)} ({wall:.3f} s wall-clock)")
    checks["var --on-device keys are the JAX CLI's"] = set(res) == VAR_KEYS
    checks["var --on-device n_paths"] = res["n_paths"] == 1 << 22
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"VaR checks failed: {failed}")


def profile_call(torch, label, fn):
    """One call of ``fn`` under torch.profiler (CPU and CUDA activity):
    logs its wall-clock, the device time summed over kernels, the device's
    busy share of the wall-clock and the kernels that took most of it.
    Only device events count (an operator's own row repeats the time of
    the kernels it launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows) * 1e-6
    if busy == 0:
        log(f"  profile {label}: {wall:.3f} s wall-clock (profiled); the "
            "profiler saw no device time: busy share not measured")
        return
    rows.sort(reverse=True)
    top = "; ".join(f"{k[:60]} x{c} {us * 1e-3:.1f} ms "
                    f"({100 * us * 1e-6 / busy:.0f}%)" for us, c, k in rows[:6])
    log(f"  profile {label}: {wall:.3f} s wall-clock (profiled), device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%); {top}")


def device_ms(torch, fn, reps, kernel="fused_kernel"):
    """Device milliseconds per call of ``fn`` spent in the kernels whose
    name holds ``kernel``, from ``reps`` profiled calls after one warm-up:
    the card's time without the host's launch gaps (K3's wrapper launches
    ~36 small merge operations after its kernel).  None when the profiler
    sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    return us * 1e-3 / reps if us > 0 else None


def phase_garch_profile(torch, procs):
    """Where the GARCH path's time goes: the VaR at 2^28 x 20 (16 chunks)
    on GARCH and GBM, and garch_monte_carlo at 2^22 without the paths and
    at 30000 sims with them, each under the profiler."""
    from montecarlo_tpu_torch.api import (garch_monte_carlo,
                                          portfolio_var_on_device)
    from montecarlo_tpu_torch.processes import GBM

    gbm = GBM.create(s0=100.0, mu=0.05, sigma=0.25, dt=1 / 252,
                     device="cuda")
    for name, proc in (("GARCH 5y", procs[5]), ("GBM", gbm)):
        profile_call(torch, f"portfolio_var_on_device {name} 2^28 x 20",
                     lambda: portfolio_var_on_device(
                         proc, 1 << 28, GARCH_DAYS, float(proc.s0), seed=0,
                         bins=VAR_BINS, chunk_paths=VAR_CHUNK))
    data, s0 = garch_history(1259)
    for n_sims, keep in ((1 << 22, False), (ORACLE_SIMS, True)):
        profile_call(torch, f"garch_monte_carlo {n_sims} keep_paths={keep}",
                     lambda: garch_monte_carlo(data, n_sims, GARCH_DAYS, s0,
                                               seed=4, keep_paths=keep))


# ---- phase 9: randomized QMC ------------------------------------------------

# Per Sobol normal beyond the Gray-code XORs (counted from this run's ids):
# the Gray code (2), the shift, two bit reversals, the key add, the Owen
# hash's four multiplies and XORs, the uniform's shift; then the uniform's
# convert, add and multiply and ndtri32's three rationals, clamps and
# selects (at least 50 float32 operations; its log and sqrt not counted).
# The Owen key is one Threefry call per dimension and launch: it does not
# depend on the path, so the bound counts it once (the kernel computes it
# per path).
SOBOL_INT, NDTRI_FP = 16, 52
RQMC_REPS = 8
#: The RQMC cells: the tolerance run's per-replicate chunk (K2/K3), the
#: path-dependent CLI's 2^20 paths over 8 replicates (K4), the steps.
QMC_CHUNK, QMC_FUNC, QMC_STEPS = 1 << 18, 1 << 17, 252


def gray_xors(torch, n, path_offset=0):
    """The Gray-code XORs one Sobol dimension takes over this run's ids:
    the set bits of gray(id) below bit 30, summed over the n ids."""
    ids = (torch.arange(n, dtype=torch.int64, device="cuda")
           + path_offset) & 0xFFFFFFFF
    g = (ids ^ (ids >> 1)) & ((1 << 30) - 1)
    total = torch.zeros((), dtype=torch.int64, device="cuda")
    for k in range(30):
        total += ((g >> k) & 1).sum()
    return int(total)


def sobol_bound(torch, n, steps, draws=1, step_fp=3, out_bytes=4,
                extra_fp=0, path_offset=0, bridge=None):
    """A fused loop over n paths whose draws are Sobol normals: n * steps *
    draws of them (or n * T for a bridge of T dims, plus 2L float32
    operations per step for ``bridge=(T, L)``), each dimension's XORs from
    this run's ids, ``step_fp`` per step and ``extra_fp`` per path."""
    dims = bridge[0] if bridge else steps * draws
    normals = n * dims
    plan = 2 * bridge[1] * n * steps if bridge else 0
    return bound(n * out_bytes,
                 int32=(normals * SOBOL_INT + dims * CIPHER_INT
                        + dims * gray_xors(torch, n, path_offset)),
                 fp32=(normals * NDTRI_FP + plan
                       + n * (steps * step_fp + extra_fp)))


def phase_qmc_parity(torch, errs):
    """K2, K3 and K4 under SobolDraws (GBM; Heston at 17 steps) and
    BridgeDraws (GBM) against their plain versions, bitwise, at 2^18 paths (K2 and K4 at
    2^18 - 37) x {252, 17, 9} steps on tables built for exactly the run's
    steps, ids crossing 2^30 (where the Gray code stops being read)."""
    from montecarlo_tpu_torch.engine import ARITH_MEAN, RUNNING_MAX
    from montecarlo_tpu_torch.engine import VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n = 1 << 18
    off = (1 << 30) - 1000
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
    pay = VanillaPayoff("call", 105.0)
    for steps in (252, 17, 9):
        gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / steps, device="cuda")
        cases = [("sobol", gbm, SobolDeviceSampler.create(
            steps, 1, scramble_seed=steps, device="cuda"))]
        if steps == 17:
            hp = heston(steps)
            cases.append(("sobol", hp, SobolDeviceSampler.create(
                steps, 2, scramble_seed=1, device="cuda")))
        cases.append(("bridge", gbm, SobolBridgeKernelSampler.create(
            steps, scramble_seed=steps, device="cuda")))
        for source, proc, smp in cases:
            kw = dict(seed=13, path_offset=off, sampler=smp)
            tag = f"{type(proc).__name__} {source} {steps} steps"
            got = [("K2", "fused_terminal",
                    fused_terminal(proc, n - 37, steps, **kw),
                    fused_terminal_reference(proc, n - 37, steps, **kw))]
            m = fused_block_moments(proc, pay, n, steps, **kw)
            want_m = fused_block_moments_reference(proc, pay, n, steps, **kw)
            got += [(f"K3 {f}", "fused_block_moments", getattr(m, f),
                     getattr(want_m, f)) for f in ("mean", "m2")]
            fo = fused_functionals(proc, n - 37, steps, functionals=fns, **kw)
            want_f = fused_functionals_reference(proc, n - 37, steps,
                                                 functionals=fns, **kw)
            got += [(f"K4 {k}", "fused_functionals", fo[k], want_f[k])
                    for k in want_f]
            for label, key, g, w in got:
                _, max_abs, _ = compare(f"{label} {tag}", g, w, BITWISE)
                key = f"{key}_{source}"
                errs[key] = max(errs.get(key, 0.0), max_abs)
            del got, m, want_m, fo, want_f
            torch.cuda.synchronize()


def phase_qmc_shapes(torch, errs, times):
    """The Sobol and bridge kernels against their plain versions and both
    timed, with their bounds, at the QMC path's shapes: K2 and K3 on GBM at
    the RQMC tolerance run's 2^18 x 252 replicate chunk; K2 on Heston at
    the CLI's 2^17 x 252 replicate and at 2^20 x 252; the bridge's K2 at
    2^18 x 252; K4 {avg} at the Asian CLI's 2^17 x 252 replicate under
    both samplers; the Threefry K2 beside them at 2^18 x 252."""
    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    check = functools.partial(timed_check, times, errs)

    def k3_device(key, label, fn):
        """A K3 row adds its kernel's device time as ``device_ms`` beside
        ``ms``, the wrapper's event time like every other row's, which at
        2^18 paths includes the host's merge launches."""
        d = device_ms(torch, fn, 10)
        row = times[key]
        row["device_ms"] = d
        log(f"  {label}: kernel "
            + ("not measured (the profiler saw no device time)" if d is None
               else f"{d:.3f} ms of device time per call (profiler)")
            + f", wrapper {row['ms']:.3f} ms (events)")

    n, s = QMC_CHUNK, QMC_STEPS
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    dev = SobolDeviceSampler.create(s, 1, device="cuda")
    bridge = SobolBridgeKernelSampler.create(s, device="cuda")
    t_l = (bridge.n_steps, bridge.width)
    pay = VanillaPayoff("call", 105.0)
    # The replicate chunk at chunk index 5 (ids 5 * 2^18 onwards).
    off = 5 * n
    check("fused_terminal_sobol", f"K2 GBM sobol {n}x{s}",
          lambda: fused_terminal(gbm, n, s, seed=1, sampler=dev),
          lambda: fused_terminal_reference(gbm, n, s, seed=1, sampler=dev),
          10, BITWISE, bnd=sobol_bound(torch, n, s, extra_fp=EXP32_FP))
    check("fused_block_moments_sobol", f"K3 GBM sobol call {n}x{s} "
          f"offset {off}",
          lambda: fused_block_moments(gbm, pay, n, s, seed=1, sampler=dev,
                                      path_offset=off),
          lambda: fused_block_moments_reference(gbm, pay, n, s, seed=1,
                                                sampler=dev, path_offset=off),
          10, BITWISE, fields=("mean", "m2"),
          bnd=sobol_bound(torch, n, s, out_bytes=8 / 128,
                          extra_fp=EXP32_FP + 8, path_offset=off))
    k3_device("fused_block_moments_sobol", f"K3 GBM sobol {n}x{s}",
              lambda: fused_block_moments(gbm, pay, n, s, seed=1, sampler=dev,
                                          path_offset=off))
    for nh in (QMC_FUNC, 1 << 20):
        hp = heston(s)
        hs = SobolDeviceSampler.create(s, 2, device="cuda")
        check("fused_terminal_sobol", f"K2 Heston sobol {nh}x{s}",
              lambda: fused_terminal(hp, nh, s, seed=1, sampler=hs),
              lambda: fused_terminal_reference(hp, nh, s, seed=1,
                                               sampler=hs),
              10, BITWISE,
              bnd=sobol_bound(torch, nh, s, draws=2, step_fp=HESTON_STEP_FP,
                              extra_fp=EXP32_FP))
    check("fused_terminal_bridge", f"K2 GBM bridge {n}x{s}",
          lambda: fused_terminal(gbm, n, s, seed=1, sampler=bridge),
          lambda: fused_terminal_reference(gbm, n, s, seed=1, sampler=bridge),
          10, BITWISE,
          bnd=sobol_bound(torch, n, s, extra_fp=EXP32_FP, bridge=t_l))
    check("fused_block_moments_bridge", f"K3 GBM bridge call {n}x{s}",
          lambda: fused_block_moments(gbm, pay, n, s, seed=1, sampler=bridge),
          lambda: fused_block_moments_reference(gbm, pay, n, s, seed=1,
                                                sampler=bridge),
          10, BITWISE, fields=("mean", "m2"),
          bnd=sobol_bound(torch, n, s, out_bytes=8 / 128,
                          extra_fp=EXP32_FP + 8, bridge=t_l))
    k3_device("fused_block_moments_bridge", f"K3 GBM bridge {n}x{s}",
              lambda: fused_block_moments(gbm, pay, n, s, seed=1,
                                          sampler=bridge))
    fns = {"avg": ARITH_MEAN}
    nf = QMC_FUNC
    obs = 3 + EXP32_FP + 1  # a GBM step, its observation's exp32, the fold
    for key, smp, bridged in (("fused_functionals_sobol", dev, None),
                              ("fused_functionals_bridge", bridge, t_l)):
        check(key, f"K4 GBM {{avg}} {key.rsplit('_', 1)[1]} {nf}x{s}",
              lambda: fused_functionals(gbm, nf, s, seed=1, sampler=smp,
                                        functionals=fns),
              lambda: fused_functionals_reference(gbm, nf, s, seed=1,
                                                  sampler=smp,
                                                  functionals=fns),
              10, BITWISE,
              bnd=sobol_bound(torch, nf, s, step_fp=obs, out_bytes=8,
                              extra_fp=EXP32_FP, bridge=bridged))
    t = {}
    timed_check(t, errs, "fused_terminal", f"K2 GBM threefry {n}x{s}",
                lambda: fused_terminal(gbm, n, s, seed=1),
                lambda: fused_terminal_reference(gbm, n, s, seed=1),
                10, BITWISE, bnd=step_bound(n, s, extra_fp=EXP32_FP))
    ratio = times["fused_terminal_sobol"]["ms"] / t["fused_terminal"]["ms"]
    log(f"  K2 GBM at {n}x{s}: Sobol draws {ratio:.2f}x the Threefry "
        "draws' time")


def check_rqmc_price(label, out):
    """Black-Scholes gate of an RQMC vanilla price: within 4 replicate
    std-errs plus 1e-4."""
    price, se, bs = out["price"], out["std_err"], out["black_scholes"]
    ok = math.isfinite(price) and abs(price - bs) < 4 * se + 1e-4
    log(f"  {label}: {json.dumps(out)} -> |price - bs| = "
        f"{abs(price - bs):.3e}, 4 se + 1e-4 = {4 * se + 1e-4:.3e} "
        f"({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{label}: price {price} vs Black-Scholes {bs}")


def run_qmc(totals, label, kernels, fn):
    """One run of the QMC path, the launch counters reset just before and
    read just after (``run_counted``): each of ``kernels`` must have
    launched in it, and nothing else (no kernel at all when it is empty);
    its launches are added to ``totals``.  Returns (result, wall s)."""
    out, wall, counts = run_counted(fn)
    launched = {k: n for k, n in counts.items() if n}
    log(f"  {label}: {launched or 'no kernel'} launched, {wall:.3f} s")
    if set(launched) != set(kernels):
        raise AssertionError(f"{label}: launched {launched}, expected "
                             f"{list(kernels)}")
    for k, n in launched.items():
        totals[k] = totals.get(k, 0) + n
    return out, wall


def phase_qmc_path(torch):
    """The QMC path through the CLI and the engine, each run counted by
    itself (``run_qmc``): ``price --sampler sobol-device --target-se
    1e-3`` (RQMC, K3 under Sobol), ``--sampler sobol-bridge`` (K2 under the
    bridge) and ``--sampler sobol-device --process heston`` (K2 under
    Sobol) at 2^20 paths, the Asian under both samplers (K4), ``--sampler
    sobol`` at 65536 paths (the host table on the torch loop, no kernel),
    and ``price_to_tolerance_rqmc`` with bridge replicates to 1e-3 through
    the engine (K3 under the bridge).  Then, outside the counted runs, the
    tolerance run's wall-clock broken down under the profiler.  Returns
    the runs' launches per kernel, the RQMC wall-clock and its paths."""
    from montecarlo_tpu_torch.engine import (VanillaPayoff,
                                             black_scholes_call,
                                             discount_factor,
                                             price_to_tolerance_rqmc)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    counts = {}
    base = ["price", "--steps", str(QMC_STEPS)]

    def cli(argv, *kernels):
        label = "price " + " ".join(argv[1:])
        return run_qmc(counts, label, kernels, lambda: run_cli(argv)[0])

    tol = base + ["--sampler", "sobol-device", "--target-se", "1e-3"]
    out, wall = cli(tol, "fused_block_moments_sobol")
    check_rqmc_price("price --sampler sobol-device --target-se 1e-3", out)
    if not out["std_err"] <= 1e-3:
        raise AssertionError(f"RQMC target-se run stopped at "
                             f"{out['std_err']}")
    chunks = out["n_paths"] // (QMC_CHUNK * RQMC_REPS)
    log(f"  RQMC wall-clock to std-err 1e-3: {wall:.3f} s ({out['n_paths']} "
        f"paths, {chunks} chunks of {RQMC_REPS} x {QMC_CHUNK}; "
        f"{counts['fused_block_moments_sobol']} K3 launches)")
    big = base + ["--paths", str(1 << 20)]
    vanilla, _ = cli(big + ["--sampler", "sobol-bridge"],
                     "fused_terminal_bridge")
    check_rqmc_price("price --sampler sobol-bridge --paths 1048576", vanilla)
    heston_out, _ = cli(big + ["--sampler", "sobol-device", "--process",
                               "heston"], "fused_terminal_sobol")
    log(f"  price --process heston --sampler sobol-device --paths 1048576: "
        f"{json.dumps(heston_out)}")
    asians = {}
    for smp, k4 in (("sobol-bridge", "fused_functionals_bridge"),
                    ("sobol-device", "fused_functionals_sobol")):
        asians[smp], _ = cli(big + ["--sampler", smp, "--payoff", "asian"],
                             k4)
        log(f"  price --payoff asian --sampler {smp} --paths 1048576: "
            f"{json.dumps(asians[smp])}")
    host, _ = cli(base + ["--sampler", "sobol", "--paths", "65536"])
    check_rqmc_price("price --sampler sobol --paths 65536 (host table, "
                     "torch loop)", host)
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / QMC_STEPS, device="cuda")
    est, w_bridge = run_qmc(
        counts, "price_to_tolerance_rqmc, bridge replicates, to 1e-3",
        ("fused_block_moments_bridge",),
        lambda: price_to_tolerance_rqmc(
            gbm, VanillaPayoff("call", 105.0), target_std_err=1e-3, seed=0,
            n_steps=QMC_STEPS, discount=discount_factor(0.03, 1.0),
            chunk_paths=QMC_CHUNK,
            sampler_factory=lambda r: SobolBridgeKernelSampler.create(
                QMC_STEPS, scramble_seed=r, device="cuda")))
    check_rqmc_price("price_to_tolerance_rqmc, bridge replicates", {
        "price": float(est["price"]), "std_err": float(est["std_err"]),
        "n_paths": int(est["n_paths"]),
        "black_scholes": black_scholes_call(100.0, 105.0, 0.03, 0.2, 1.0)})
    log(f"  bridge RQMC to std-err 1e-3: {w_bridge:.3f} s, "
        f"{est['n_chunks']} chunk(s)")
    log(f"  launches on the QMC path: {counts}")
    # Where the RQMC tolerance run's wall-clock goes (not counted): the
    # replicates' samplers built on the host, then the engine's run under
    # the profiler.
    t1 = time.perf_counter()
    for r in range(RQMC_REPS):
        SobolDeviceSampler.create(QMC_STEPS, 1, scramble_seed=r,
                                  device="cuda")
    torch.cuda.synchronize()
    log(f"  {RQMC_REPS} SobolDeviceSampler tables of {QMC_STEPS} dims built "
        f"in {time.perf_counter() - t1:.3f} s")
    profile_call(torch, "price_to_tolerance_rqmc to std-err 1e-3",
                 lambda: price_to_tolerance_rqmc(
                     gbm, VanillaPayoff("call", 105.0), target_std_err=1e-3,
                     seed=0, n_steps=QMC_STEPS,
                     discount=discount_factor(0.03, 1.0),
                     chunk_paths=QMC_CHUNK))
    checks = {
        "bridge Asian below the call": (asians["sobol-bridge"]["price"]
                                        < vanilla["price"]),
        "Asians of both samplers within 4 se": abs(
            asians["sobol-bridge"]["price"] - asians["sobol-device"]["price"])
        < 4 * (asians["sobol-bridge"]["std_err"]
               + asians["sobol-device"]["std_err"]) + 1e-4,
        "Heston finite": math.isfinite(heston_out["price"]),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"QMC path: failed {failed}")
    return counts, wall, out["n_paths"]


# ---- phase 10: jump, Levy, QE and SABR processes on K2-K4 -------------------

#: The processes of phase 10, in PROCESS_CODES order, and per process the
#: Threefry calls per step pair that give normals (a Box-Muller pair each)
#: and uniforms (two uniform_from_bits each), and the float32 adds and
#: multiplies of one step (selects and compares counted as one each;
#: log32, logf, sqrtf and the Box-Muller transcendentals not counted, so
#: every bound below is loose where they matter; exp32 and ndtri32's
#: rationals are float32 arithmetic and counted).
JUMP_KINDS = ("merton", "kou", "bates", "nig", "heston-qe", "bates-qe", "vg",
              "sabr")
UNIFORM_FP = 6  # two halves: a shift, a convert, an add and a multiply
QE_STEP_FP = 50 + NDTRI_FP
JUMP_COST = {
    "merton": (2, 1, 12),                   # 4 Poisson selects + 8
    "kou": (1, 5, 4 + 4 * 5 + 4),           # Poisson, 4 jump sizes, 4
    "bates": (3, 1, HESTON_STEP_FP + 4 + 4),
    "nig": (2, 1, 16),
    "heston-qe": (1, 1, QE_STEP_FP + 7),
    "bates-qe": (2, 2, QE_STEP_FP + 7 + 4 + 4),
    "vg": (1, 2, NDTRI_FP + 30 + 2 * EXP32_FP + 8 + 6),
    "sabr": (2, 0, 2 * EXP32_FP + 12),
}
#: The phase's shapes: K2 at the CLI's 2^20 x 252, K3 at
#: price_to_tolerance's 2^22 x 252 chunks, K4 {avg} at 2^20 x 252.
JUMP_PATHS, JUMP_STEPS, JUMP_TOL_CHUNK = 1 << 20, 252, 1 << 22


def jump_bound(kind, n, steps, out_bytes=4, extra_fp=0, observe_fp=0):
    """The least time of ``kind``'s fused loop over n paths: its cipher
    calls per step pair at CIPHER_INT int32 operations each (BOXMULLER_FP
    or UNIFORM_FP float32 beside), its step's float32 operations (plus
    ``observe_fp`` per step for K4's observation and fold), exp32 once per
    path for the prices (SABR's prices are its state: none) plus
    ``extra_fp``, and ``out_bytes`` per path."""
    normal, uniform, step_fp = JUMP_COST[kind]
    pairs = (steps + 1) // 2
    calls = n * pairs * (normal + uniform)
    price_fp = 0 if kind == "sabr" else EXP32_FP
    return bound(n * out_bytes, int32=calls * CIPHER_INT,
                 fp32=(n * pairs * (normal * BOXMULLER_FP
                                    + uniform * UNIFORM_FP)
                       + n * (steps * (step_fp + observe_fp) + price_fp
                              + extra_fp)))


def jump_process(kind, steps):
    """The process ``price --process kind --steps steps`` simulates, on
    the card, with the CLI's defaults."""
    from montecarlo_tpu_torch.cli.pricing import cli_process

    return cli_process(["--process", kind, "--steps", str(steps)], "cuda")[0]


def phase_jump_parity(torch, errs):
    """K2, K3 and K4 ({avg, geo, mx, mn}) on each of the eight new
    functors against their plain versions, bitwise, with ids from 2^30 -
    1000: at 17 steps each kernel plain and antithetic (SABR also under
    Sobol draws), K3 at 2^18 paths, K2 and K4 at 2^18 - 37; at 252 steps
    (the odd final step not taken: 126 pairs) K2 antithetic (SABR also
    under Sobol draws) and K4 plain at 2^18 - 37, where phase 10's timed
    launches add K2 plain at 2^20 for every process and K3 on Merton at
    2^22.  A 252-step plain version takes seconds (hundreds of eager
    operations per step), so 252-step runs are kept to these.  Then the K0
    gamma functions on 2^20 uniforms."""
    import numpy as np

    from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                             RUNNING_MAX, RUNNING_MIN,
                                             VanillaPayoff)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)
    from montecarlo_tpu_torch.ops.rng_check import (gamma_check,
                                                    gamma_check_reference)
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    n = 1 << 18
    off = (1 << 30) - 1000
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
           "mn": RUNNING_MIN}
    pay = VanillaPayoff("call", 105.0)
    for kind in JUMP_KINDS:
        t0 = time.perf_counter()
        for steps in (17, JUMP_STEPS):
            proc = jump_process(kind, steps)
            every = ("K2", "K3", "K4")
            runs = ([("plain", dict(), every), ("antithetic",
                                                dict(antithetic=True), every)]
                    if steps == 17 else
                    [("antithetic", dict(antithetic=True), ("K2",)),
                     ("plain", dict(), ("K4",))])
            if kind == "sabr":
                runs.append(("sobol", dict(sampler=SobolDeviceSampler.create(
                    steps, 2, scramble_seed=steps, device="cuda")),
                    every if steps == 17 else ("K2",)))
            for label, draw, kernels in runs:
                kw = dict(seed=17, path_offset=off, **draw)
                sfx = "_sobol" if label == "sobol" else f"_{kind}"
                tag = f"{kind} {steps} steps {label}"
                cases = []
                if "K2" in kernels:
                    cases.append(("K2", "fused_terminal" + sfx,
                                  fused_terminal(proc, n - 37, steps, **kw),
                                  fused_terminal_reference(proc, n - 37,
                                                           steps, **kw)))
                if "K3" in kernels:
                    got = fused_block_moments(proc, pay, n, steps, **kw)
                    want = fused_block_moments_reference(proc, pay, n, steps,
                                                         **kw)
                    cases += [(f"K3 {f}", "fused_block_moments" + sfx,
                               getattr(got, f), getattr(want, f))
                              for f in ("mean", "m2")]
                if "K4" in kernels:
                    got = fused_functionals(proc, n - 37, steps,
                                            functionals=fns, **kw)
                    want = fused_functionals_reference(
                        proc, n - 37, steps, functionals=fns, **kw)
                    cases += [(f"K4 {k}", "fused_functionals" + sfx, got[k],
                               want[k]) for k in want]
                for name, key, g, w in cases:
                    _, max_abs, _ = compare(f"{name} {tag}", g, w, BITWISE)
                    errs[key] = max(errs.get(key, 0.0), max_abs)
                del cases
            torch.cuda.synchronize()
        log(f"  {kind} parity: {time.perf_counter() - t0:.1f} s")
    vg = jump_process("vg", JUMP_STEPS)
    rng = np.random.default_rng(10)
    m = 1 << 20
    u_w, u_b = (torch.from_numpy(rng.uniform(0, 1, m).astype(np.float32))
                .cuda() for _ in range(2))
    x = torch.from_numpy(rng.uniform(-95, 2, m).astype(np.float32)).cuda()
    got = gamma_check(vg, u_w, u_b, x)
    want = gamma_check_reference(vg, u_w, u_b, x)
    torch.cuda.synchronize()
    for name in want:
        same = bool(torch.equal(got[name], want[name]))
        log(f"  K0 {name} 2^20 uniforms (VG's table, a = dt/nu): bitwise "
            f"{same}")
        if not same:
            compare(name, got[name], want[name])
            raise AssertionError(f"K0 {name} differs from the plain version")


def phase_jump_shapes(torch, errs, times):
    """Each new K2 timed at the CLI's 2^20 x 252 beside its plain version
    and bound, K3 on Merton at price_to_tolerance's 2^22 x 252 (chunks 0
    and 7), K4 {avg} on Kou and VG at 2^20 x 252; each checked bitwise.
    Returns the K2 rates in path-steps/s."""
    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)

    n, s = JUMP_PATHS, JUMP_STEPS
    rates = {}
    for kind in JUMP_KINDS:
        proc = jump_process(kind, s)
        key = f"fused_terminal_{kind}"
        timed_check(times, errs, key, f"K2 {kind} {n}x{s}",
                    lambda: fused_terminal(proc, n, s, seed=0),
                    lambda: fused_terminal_reference(proc, n, s, seed=0),
                    10, BITWISE, bnd=jump_bound(kind, n, s))
        rates[kind] = n * s / (times[key]["ms"] * 1e-3)
    merton = jump_process("merton", s)
    pay = VanillaPayoff("call", 105.0)
    nt = JUMP_TOL_CHUNK
    for chunk in (0, 7):
        off = chunk * nt
        timed_check(times, errs, "fused_block_moments_merton",
                    f"K3 merton call {nt}x{s} chunk {chunk}",
                    lambda: fused_block_moments(merton, pay, nt, s, seed=0,
                                                path_offset=off),
                    lambda: fused_block_moments_reference(
                        merton, pay, nt, s, seed=0, path_offset=off),
                    5, BITWISE, fields=("mean", "m2"),
                    bnd=jump_bound("merton", nt, s, out_bytes=8 / 128,
                                   extra_fp=8))
    fns = {"avg": ARITH_MEAN}
    for kind in ("kou", "vg"):
        proc = jump_process(kind, s)
        timed_check(times, errs, f"fused_functionals_{kind}",
                    f"K4 {kind} {{avg}} {n}x{s}",
                    lambda: fused_functionals(proc, n, s, seed=0,
                                              functionals=fns),
                    lambda: fused_functionals_reference(proc, n, s, seed=0,
                                                        functionals=fns),
                    10, BITWISE,
                    bnd=jump_bound(kind, n, s, out_bytes=8,
                                   observe_fp=EXP32_FP + 1))
    log("  K2 path-steps/s at 2^20 x 252: " + ", ".join(
        f"{k} {r:.4e}" for k, r in rates.items()))
    return rates


#: Each CLI run's slack beside 4 std-err against its oracle: the JAX
#: tests' 2e-3 where the scheme is exact in law (Merton, Kou, NIG, VG: the
#: truncated Poisson's error is below float32), test_bates.py's 0.08 for
#: the full-truncation Euler Bates, 0.02 for the QE schemes' bias at 252
#: steps, 1e-3 for SABR's martingale.
JUMP_SLACK = {"merton": 2e-3, "kou": 2e-3, "nig": 2e-3, "vg": 2e-3,
              "bates": 0.08, "heston-qe": 0.02, "bates-qe": 0.02,
              "sabr": 1e-3}


def check_oracle(label, out, oracle, slack):
    """A CLI price within 4 std-err plus ``slack`` of its oracle."""
    price, se = out["price"], out["std_err"]
    ok = math.isfinite(price) and abs(price - oracle) < 4 * se + slack
    log(f"  {label}: {json.dumps(out)} -> oracle {oracle:.6f}, |diff| "
        f"{abs(price - oracle):.3e}, 4 se + {slack:g} = "
        f"{4 * se + slack:.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{label}: price {price} vs oracle {oracle}")


def counted_cli(argv, *kernels):
    """One CLI run, its launch counters reset just before and read just
    after (``run_qmc``: exactly ``kernels`` launched): (JSON, wall s,
    launches by kernel)."""
    got = {}
    out, wall = run_qmc(got, "price " + " ".join(argv[1:]), kernels,
                        lambda: run_cli(argv)[0])
    return out, wall, got


def phase_jump_path(torch):
    """The slice's main path through the CLI, each run counted by itself:
    ``price --process <p> --paths 1048576 --steps 252`` for the eight
    processes (K2), gated by their oracles (the CF price for kou, nig, vg,
    bates and bates-qe; merton_call_series for merton; Heston's CF for
    heston-qe; SABR by the martingale disc E[F_T] = s0, from ``--strike
    0``); ``--target-se 1e-3`` on Merton (K3), ``--payoff asian`` on Kou
    (K4, below Kou's call), ``--sampler sobol`` on Merton (the host's
    mixed-draw table on the torch loop, no kernel).  Returns each
    kernel-line entry's launches."""
    from montecarlo_tpu_torch.engine import cf_pricing
    from montecarlo_tpu_torch.processes import (bates_log_cf,
                                                merton_call_series)

    base = ["price", "--paths", str(JUMP_PATHS), "--steps", str(JUMP_STEPS)]
    oracles = {
        "merton": merton_call_series(100.0, 105.0, 0.03, 0.2, 1.0, -0.05,
                                     0.1, 1.0),
        "heston-qe": cf_pricing.cf_call_price(
            bates_log_cf(100.0, 0.03, 0.04, 2.0, 0.04, 0.5, -0.7, 0.0,
                         -0.05, 0.1, 1.0), 100.0, 105.0, 1.0, 0.03)}
    launches, outs = {}, {}
    for kind in JUMP_KINDS:
        out, _, got = counted_cli(base + ["--process", kind],
                                  "fused_terminal")
        launches[f"fused_terminal_{kind}"] = got["fused_terminal"]
        outs[kind] = out
        if kind == "sabr":
            continue
        # The JAX CLI prints cf_price for every process here but these two.
        if ("cf_price" in out) == (kind in oracles):
            raise AssertionError(f"{kind}: keys {sorted(out)}")
        check_oracle(f"{kind} vs its oracle", out,
                     oracles[kind] if kind in oracles else out["cf_price"],
                     JUMP_SLACK[kind])
    fwd, _, got = counted_cli(base + ["--process", "sabr", "--strike", "0"],
                              "fused_terminal")
    launches["fused_terminal_sabr"] += got["fused_terminal"]
    check_oracle("sabr martingale: disc E[F_T] = s0 (--strike 0)", fwd,
                 100.0, JUMP_SLACK["sabr"])
    if not 0 < outs["sabr"]["price"] < fwd["price"]:
        raise AssertionError(f"sabr call {outs['sabr']} outside (0, s0)")
    tol, wall, got = counted_cli(
        ["price", "--process", "merton", "--target-se", "1e-3", "--steps",
         str(JUMP_STEPS)], "fused_block_moments")
    launches["fused_block_moments_merton"] = got["fused_block_moments"]
    check_oracle("merton --target-se 1e-3 vs merton_call_series", tol,
                 oracles["merton"], JUMP_SLACK["merton"])
    if not tol["std_err"] <= 1e-3:
        raise AssertionError(f"merton target-se run stopped at "
                             f"{tol['std_err']}")
    log(f"  merton wall-clock to std-err 1e-3: {wall:.3f} s "
        f"({tol['n_paths']} paths, {got['fused_block_moments']} K3 "
        "launches)")
    asian, _, got = counted_cli(base + ["--process", "kou", "--payoff",
                                        "asian"], "fused_functionals")
    launches["fused_functionals_kou"] = got["fused_functionals"]
    if not 0 < asian["price"] < outs["kou"]["price"]:
        raise AssertionError(f"kou Asian {asian} not below its call")
    sobol, _, _ = counted_cli(["price", "--process", "merton", "--sampler",
                               "sobol", "--paths", "65536", "--steps",
                               str(JUMP_STEPS)])
    check_oracle("merton --sampler sobol (host table, torch loop) vs "
                 "merton_call_series", sobol, oracles["merton"],
                 JUMP_SLACK["merton"])
    log(f"  launches on the jump/Levy/QE/SABR path: {launches}")
    return launches



# ---- phase 11: local and stochastic-local volatility on K2-K4 ----------------

#: Per surface functor: the Threefry calls per step pair (a Box-Muller pair
#: each) and the float32 operations of one step, counted as HESTON_STEP_FP
#: is (adds, multiplies, selects, clamps; the IEEE divisions as one each;
#: sqrtf and the table loads not counted).  The knot index and
#: interpolation (u, floor, two clamps, frac's clamps, the two products
#: and the sum) 12; the time blend (its coordinate 5, the two hat weights
#: 9, two lanes of two knots 8) 22; the log-moneyness 1.
SURFACE_KNOTS_FP, SURFACE_BLEND_FP = 12, 22
SURFACE_COST = {
    "local_vol": (1, SURFACE_KNOTS_FP + SURFACE_BLEND_FP + 1 + 8),
    "slv": (2, HESTON_STEP_FP + SURFACE_KNOTS_FP + 1 + 4),
    "slv_knots": (2, HESTON_STEP_FP + SURFACE_KNOTS_FP + SURFACE_BLEND_FP
                  + 1 + 4),
}
#: The phase's shapes: K2 and K4 at the CLI's 2^20 x 252, K3 at
#: price_to_tolerance's 2^22 x 252 chunks, the calibration at the CLI's
#: 2^17 particles x 252 steps, its card-against-CPU check at 2^14 x 64.
SURFACE_PATHS, SURFACE_STEPS, SURFACE_TOL_CHUNK = 1 << 20, 252, 1 << 22
#: tests/test_torch_slv.py's calibration tolerance (the same rows computed
#: with other summation orders and other libm normals): every leverage
#: entry within rtol 5e-4, the mean relative difference below 1e-5.
CALIB_RTOL, CALIB_MEAN_RTOL = 5e-4, 1e-5


def surface_bound(kind, proc, n, steps, out_bytes=4, extra_fp=0,
                  observe_fp=0):
    """The least time of ``kind``'s fused loop over n paths: its cipher
    calls per step pair, its step's float32 operations (plus
    ``observe_fp`` per step for K4), exp32 for the prices plus
    ``extra_fp`` per path; ``out_bytes`` per path out and the surface
    table read once."""
    draws, step_fp = SURFACE_COST[kind]
    table = proc.lev_rows if kind == "slv" else (
        proc.lev_flat if kind == "slv_knots" else proc.vol_flat)
    pairs = (steps + 1) // 2
    calls = n * pairs * draws
    return bound(n * out_bytes + 4 * table.numel(),
                 int32=calls * CIPHER_INT,
                 fp32=calls * BOXMULLER_FP
                 + n * (steps * (step_fp + observe_fp) + EXP32_FP
                        + extra_fp))


def surface_procs(steps, paths=SURFACE_PATHS):
    """The surface processes on the card: the CLI's CEV surface, a
    time-dependent local-vol surface (16 time knots from 16 steps on), the
    SLV ``price --process slv --paths <paths>`` calibrates (exact rows, one
    per step) and its ``slv_to_kernel`` SLVKnots."""
    import numpy as np

    from montecarlo_tpu_torch.cli.pricing import cli_process
    from montecarlo_tpu_torch.processes import LocalVolGBM, slv_to_kernel

    flags = ["--steps", str(steps), "--paths", str(paths)]
    slv = cli_process(["--process", "slv", *flags], "cuda")[0]
    return {
        "cev": cli_process(["--process", "cev", *flags], "cuda")[0],
        "tdep": LocalVolGBM.create(
            100.0, 0.03, 1.0 / steps, steps,
            lambda t, x: 0.2 + 0.1 * np.tanh(np.log(x / 100.0)) + 0.05 * t,
            device="cuda"),
        "slv": slv, "slv_knots": slv_to_kernel(slv)}


def phase_surface_parity(torch, errs):
    """K2, K3 and K4 ({avg, geo, mx, mn}) on LocalVolProc (the CEV and the
    time-dependent surface), SlvProc (the CLI's calibrated SLV: the
    KernelRows read) and SlvKnotsProc against their plain versions,
    bitwise, ids from 2^30 - 1000: at 17 steps plain, antithetic and under
    Sobol draws (local vol under the bridge too), K3 at 2^18 paths, K2 and
    K4 at 2^18 - 37; the SLV of 17 rows also at 23 steps (the clamp past
    its last row); at 252 steps K2 antithetic and K4 plain on the CEV, SLV
    and SLVKnots."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                             RUNNING_MAX, RUNNING_MIN,
                                             VanillaPayoff)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n = 1 << 18
    off = (1 << 30) - 1000
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
           "mn": RUNNING_MIN}
    pay = VanillaPayoff("call", 105.0)
    every = ("K2", "K3", "K4")
    key = {"cev": "local_vol", "tdep": "local_vol", "slv": "slv",
           "slv_knots": "slv_knots"}
    for steps in (17, SURFACE_STEPS):
        procs = surface_procs(steps)
        for kind, proc in procs.items():
            if steps != 17 and kind == "tdep":
                continue
            t0 = time.perf_counter()
            runs = []
            for n_steps in ((17, 23) if steps == 17 and kind == "slv"
                            else (steps,)):
                if steps != 17:
                    runs += [("antithetic", n_steps, dict(antithetic=True),
                              ("K2",)), ("plain", n_steps, {}, ("K4",))]
                    continue
                runs += [("plain", n_steps, {}, every),
                         ("antithetic", n_steps, dict(antithetic=True),
                          every),
                         ("sobol", n_steps, dict(
                             sampler=SobolDeviceSampler.create(
                                 n_steps, proc.n_draws, scramble_seed=n_steps,
                                 device="cuda")), every)]
                if proc.n_draws == 1:
                    runs.append(("bridge", n_steps, dict(
                        sampler=SobolBridgeKernelSampler.create(
                            n_steps, scramble_seed=n_steps,
                            device="cuda")), every))
            for label, n_steps, draw, kernels in runs:
                kw = dict(seed=17, path_offset=off, **draw)
                sfx = (f"_{label}" if label in ("sobol", "bridge")
                       else f"_{key[kind]}")
                tag = f"{kind} {n_steps} steps {label}"
                cases = []
                if "K2" in kernels:
                    cases.append(("K2", "fused_terminal" + sfx,
                                  fused_terminal(proc, n - 37, n_steps, **kw),
                                  fused_terminal_reference(proc, n - 37,
                                                           n_steps, **kw)))
                if "K3" in kernels:
                    got = fused_block_moments(proc, pay, n, n_steps, **kw)
                    want = fused_block_moments_reference(proc, pay, n,
                                                         n_steps, **kw)
                    cases += [(f"K3 {f}", "fused_block_moments" + sfx,
                               getattr(got, f), getattr(want, f))
                              for f in ("mean", "m2")]
                if "K4" in kernels:
                    got = fused_functionals(proc, n - 37, n_steps,
                                            functionals=fns, **kw)
                    want = fused_functionals_reference(
                        proc, n - 37, n_steps, functionals=fns, **kw)
                    cases += [(f"K4 {k}", "fused_functionals" + sfx, got[k],
                               want[k]) for k in want]
                for name, ekey, g, w in cases:
                    _, max_abs, _ = compare(f"{name} {tag}", g, w, BITWISE)
                    errs[ekey] = max(errs.get(ekey, 0.0), max_abs)
                del cases
            torch.cuda.synchronize()
            log(f"  {kind} parity at {steps} steps: "
                f"{time.perf_counter() - t0:.1f} s")


def phase_surface_calibration(torch):
    """``calibrate_slv`` on the card: the CLI's 2^17 particles x 252 steps
    by the host clock (twice: bitwise equal rows) and once under the
    profiler (the device's busy share, the kernels and their launches),
    and at 2^14 x 64 against the same calibration on the CPU within
    CALIB_RTOL.  Returns the host seconds of the timed calibrations."""
    import numpy as np

    from montecarlo_tpu_torch.processes import LocalVolGBM, calibrate_slv
    from montecarlo_tpu_torch.processes.dupire import local_vol_fn_from_ivs

    # The CLI's demo surface (cli/pricing_models.py::_slv) at its defaults.
    ks = np.linspace(0.7, 1.4, 15) * 100.0
    ivs = (0.2 - 0.1 * np.log(ks / 100.0))[None, :].repeat(2, 0)
    fn = local_vol_fn_from_ivs(ks, np.array([0.5, 1.0]), ivs, s0=100.0,
                               rate=0.03)
    mixing = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7)

    def calibrate(device, steps, particles):
        lv = LocalVolGBM.create(100.0, 0.03, 1.0 / steps, steps, fn,
                                x_min=-0.9, x_max=0.9, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = calibrate_slv(lv, n_steps=steps, n_particles=particles,
                             seed=0, **mixing).lev_rows
        if device == "cuda":
            torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    calibrate("cuda", 16, 1 << 12)  # warm-up: torch's first launches
    walls = []
    rows = []
    for _ in range(2):
        r, wall = calibrate("cuda", SURFACE_STEPS, 1 << 17)
        rows.append(r)
        walls.append(wall)
    same = bool(torch.equal(rows[0], rows[1]))
    log(f"  calibrate_slv 2^17 particles x {SURFACE_STEPS} steps on the "
        f"card: {walls[0]:.3f} s, {walls[1]:.3f} s; twice at one seed "
        f"bitwise {same}")
    profile_call(torch, f"calibrate_slv 2^17 x {SURFACE_STEPS}",
                 lambda: calibrate("cuda", SURFACE_STEPS, 1 << 17))
    if not same or not bool(torch.isfinite(rows[0]).all()):
        raise AssertionError("calibrate_slv: rows differ between two runs "
                             "at one seed, or are not finite")
    card, _ = calibrate("cuda", 64, 1 << 14)
    cpu, _ = calibrate("cpu", 64, 1 << 14)
    rel = (card.cpu().double() - cpu.double()).abs() / cpu.double().abs()
    log(f"  calibrate_slv 2^14 x 64, card against --device cpu: max rel "
        f"{float(rel.max()):.3e} (< {CALIB_RTOL:g}), mean rel "
        f"{float(rel.mean()):.3e} (< {CALIB_MEAN_RTOL:g})")
    if float(rel.max()) >= CALIB_RTOL or float(rel.mean()) >= CALIB_MEAN_RTOL:
        raise AssertionError("calibrate_slv: the card's rows are off the "
                             "CPU's")
    return walls


def phase_surface_shapes(torch, errs, times):
    """K2 on the CEV surface, the SLV and its SLVKnots at the CLI's 2^20 x
    252 beside the plain version and bound, K3 on the SLV at two 2^22 x
    252 tolerance chunks (0 and 7), K4 {avg} on the SLV at 2^20 x 252; each
    bitwise."""
    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)

    n, s = SURFACE_PATHS, SURFACE_STEPS
    procs = surface_procs(s)
    procs = {"local_vol": procs["cev"], "slv": procs["slv"],
             "slv_knots": procs["slv_knots"]}
    for kind, proc in procs.items():
        timed_check(times, errs, f"fused_terminal_{kind}",
                    f"K2 {kind} {n}x{s}",
                    lambda: fused_terminal(proc, n, s, seed=0),
                    lambda: fused_terminal_reference(proc, n, s, seed=0),
                    10, BITWISE, bnd=surface_bound(kind, proc, n, s))
    slv = procs["slv"]
    pay = VanillaPayoff("call", 105.0)
    nt = SURFACE_TOL_CHUNK
    for chunk in (0, 7):
        off = chunk * nt
        timed_check(times, errs, "fused_block_moments_slv",
                    f"K3 slv call {nt}x{s} chunk {chunk}",
                    lambda: fused_block_moments(slv, pay, nt, s, seed=0,
                                                path_offset=off),
                    lambda: fused_block_moments_reference(
                        slv, pay, nt, s, seed=0, path_offset=off),
                    5, BITWISE, fields=("mean", "m2"),
                    bnd=surface_bound("slv", slv, nt, s, out_bytes=8 / 128,
                                      extra_fp=8))
    fns = {"avg": ARITH_MEAN}
    timed_check(times, errs, "fused_functionals_slv",
                f"K4 slv {{avg}} {n}x{s}",
                lambda: fused_functionals(slv, n, s, seed=0, functionals=fns),
                lambda: fused_functionals_reference(slv, n, s, seed=0,
                                                    functionals=fns),
                10, BITWISE,
                bnd=surface_bound("slv", slv, n, s, out_bytes=8,
                                  observe_fp=EXP32_FP + 1))
    log("  K2 path-steps/s at 2^20 x 252: " + ", ".join(
        f"{k} {n * s / (times[f'fused_terminal_{k}']['ms'] * 1e-3):.4e}"
        for k in procs))


def cev_call(s0, k, r, sigma, beta, t):
    """The CEV call's noncentral chi-square closed form
    (tests/test_local_vol.py:60-78) for sigma_LN(S) = sigma (S/s0)^(beta -
    1)."""
    from scipy.stats import ncx2

    delta = sigma * s0 ** (1 - beta)
    v = (delta ** 2 / (2 * r * (beta - 1))
         * (math.exp(2 * r * (beta - 1) * t) - 1))
    a = (k * math.exp(-r * t)) ** (2 * (1 - beta)) / ((1 - beta) ** 2 * v)
    b = 1 / (1 - beta)
    c = s0 ** (2 * (1 - beta)) / ((1 - beta) ** 2 * v)
    return float(s0 * (1 - ncx2.cdf(a, b + 2, c))
                 - k * math.exp(-r * t) * ncx2.cdf(c, b, a))


def phase_surface_path(torch):
    """The slice's main path through the CLI (and one engine call), each
    run counted by itself: ``price --process cev --paths 1048576 --steps
    252`` (K2, within 5 std-err + 0.05 of the CEV closed form); ``price
    --process slv`` at the same shape for K = 85, 100, 115 (K2, the
    calibration first; each within 4 std-err + 0.0075 BS + 0.03 of
    Black-Scholes at the demo surface's iv(K) = 0.2 - 0.1 log(K/100),
    tests/test_slv.py's gate); the engine's ``terminal_prices`` on the
    100-strike SLV's ``slv_to_kernel`` (K2, the same gate); ``--target-se
    1e-3`` on SLV (K3), ``--payoff asian`` on SLV (K4, below its call),
    ``--sampler sobol-device`` on SLV (K2 under Sobol draws) and
    ``--sampler sobol-bridge`` on CEV (K2 under the bridge), each vanilla
    under its gate.  Returns each kernels-line entry's launches."""
    from montecarlo_tpu_torch.cli.pricing import cli_process
    from montecarlo_tpu_torch.engine import (black_scholes_call, mc_estimate,
                                             terminal_prices)
    from montecarlo_tpu_torch.processes import slv_to_kernel

    n, s = SURFACE_PATHS, SURFACE_STEPS
    base = ["price", "--paths", str(n), "--steps", str(s)]
    disc = math.exp(-0.03)
    cev = cev_call(100.0, 105.0, 0.03, 0.2, 0.7, 1.0)

    def iv_bs(k):
        return black_scholes_call(100.0, k, 0.03,
                                  0.2 - 0.1 * math.log(k / 100.0), 1.0)

    def slv_slack(k):  # beside 4 std-err: tests/test_slv.py:69's gate
        return 0.0075 * iv_bs(k) + 0.03

    launches = {}
    out, wall, got = counted_cli(base + ["--process", "cev"],
                                 "fused_terminal")
    launches["fused_terminal_local_vol"] = got["fused_terminal"]
    check_oracle("cev vs the noncentral chi-square closed form (5 se + "
                 "0.05)", out, cev, out["std_err"] + 0.05)
    launches["fused_terminal_slv"] = 0
    calls = {}
    for k in (85.0, 100.0, 115.0):
        out, wall, got = counted_cli(
            base + ["--process", "slv", "--strike", f"{k:g}"],
            "fused_terminal")
        launches["fused_terminal_slv"] += got["fused_terminal"]
        calls[k] = out
        check_oracle(f"slv K={k:g} vs Black-Scholes at iv(K) ({wall:.3f} s "
                     "with its calibration)", out, iv_bs(k), slv_slack(k))
    slv, _ = cli_process(["--process", "slv", "--steps", str(s), "--paths",
                          str(n)], "cuda")
    knots = slv_to_kernel(slv)
    pay = lambda x: torch.clamp(x - 100.0, min=0.0)
    est, wall, got = run_counted(
        lambda: {k: float(v) for k, v in mc_estimate(
            pay(terminal_prices(knots, n, s, seed=0)), disc).items()})
    if set(k for k, v in got.items() if v) != {"fused_terminal"}:
        raise AssertionError(f"slv_to_kernel run launched {got}")
    launches["fused_terminal_slv_knots"] = got["fused_terminal"]
    check_oracle("SLVKnots (slv_to_kernel, 16 knots) K=100 vs Black-Scholes "
                 "at iv(100)", est, iv_bs(100.0), slv_slack(100.0))
    tol, wall, got = counted_cli(
        ["price", "--process", "slv", "--target-se", "1e-3", "--steps",
         str(s)], "fused_block_moments")
    launches["fused_block_moments_slv"] = got["fused_block_moments"]
    check_oracle("slv --target-se 1e-3 vs Black-Scholes at iv(105)", tol,
                 iv_bs(105.0), slv_slack(105.0))
    if not tol["std_err"] <= 1e-3:
        raise AssertionError(f"slv target-se run stopped at "
                             f"{tol['std_err']}")
    log(f"  slv wall-clock to std-err 1e-3: {wall:.3f} s "
        f"({tol['n_paths']} paths, {got['fused_block_moments']} K3 "
        "launches, the 100000-particle calibration included)")
    asian, _, got = counted_cli(
        base + ["--process", "slv", "--payoff", "asian"], "fused_functionals")
    launches["fused_functionals_slv"] = got["fused_functionals"]
    call105, _, _ = counted_cli(base + ["--process", "slv"], "fused_terminal")
    if not 0 < asian["price"] < call105["price"]:
        raise AssertionError(f"slv Asian {asian} not below its call "
                             f"{call105}")
    log(f"  slv Asian {asian['price']:.6f} below its call "
        f"{call105['price']:.6f}")
    qmc, _, _ = counted_cli(base + ["--process", "slv", "--sampler",
                                    "sobol-device"], "fused_terminal_sobol")
    check_oracle("slv --sampler sobol-device vs Black-Scholes at iv(105)",
                 qmc, iv_bs(105.0), slv_slack(105.0))
    bridge, _, _ = counted_cli(base + ["--process", "cev", "--sampler",
                                       "sobol-bridge"],
                               "fused_terminal_bridge")
    check_oracle("cev --sampler sobol-bridge vs the closed form (5 se + "
                 "0.05)", bridge, cev, bridge["std_err"] + 0.05)
    log(f"  launches on the local-vol/SLV path: {launches}")
    return launches

#: Each kernel's wrapper, CUDA source and the TPU kernel it replaces.
KERNELS = [
    ("gbm_terminal", "gbm_kernel.cu", "gbm_kernel.py:118"),
    ("fused_terminal", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals", "fused_engine.cu", "fused_engine.py:390"),
    ("normal_matrix", "rng_kernel.cu", "rng_kernel.py:67"),
    ("rbergomi_terminal", "rbergomi_kernel.cu", "rbergomi_kernel.py:73"),
    ("packed_basket_terminal", "basket_kernel.cu", "basket_kernel.py:131"),
    ("fused_terminal_sobol", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments_sobol", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals_sobol", "fused_engine.cu", "fused_engine.py:390"),
    ("fused_terminal_bridge", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments_bridge", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals_bridge", "fused_engine.cu", "fused_engine.py:390"),
    *((f"fused_terminal_{k}", "fused_engine.cu", "fused_engine.py:231")
      for k in JUMP_KINDS),
    ("fused_block_moments_merton", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals_kou", "fused_engine.cu", "fused_engine.py:390"),
    ("fused_terminal_local_vol", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_terminal_slv", "fused_engine.cu",
     "fused_engine.py:231 (KernelRows: fused_engine.py:44)"),
    ("fused_terminal_slv_knots", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments_slv", "fused_engine.cu",
     "fused_engine.py:478 (KernelRows: fused_engine.py:44)"),
    ("fused_functionals_slv", "fused_engine.cu",
     "fused_engine.py:390 (KernelRows: fused_engine.py:44)"),
]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        import montecarlo_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of a checkout that holds "
              "montecarlo_tpu_torch/", file=sys.stderr)
        return 1
    from montecarlo_tpu_torch.ops import _build

    try:
        card = card_line()
        log(card)
        log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
        t0 = time.perf_counter()
        ptxas = _build.build(("-Xptxas", "-v"))
        _build.load_library()
        log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s"
            f" ({_build.library_path().name})")
        log_resources(ptxas)
        log("phase 2: K0 device math vs plain versions, 2^20 counters")
        phase_k0(torch)
        log("phase 3: K1-K6 vs plain versions, 2^18 paths")
        errs = {}
        phase_parity(torch, errs)
        log("phase 4: K1-K6 vs plain versions and times, main-path shapes")
        times = phase_main_shapes(torch, errs)
        phase_factor_precision(torch)
        # experiments/rbergomi_bench.py's shape, then the CLI's default
        # model at its 2^20 x 252.
        phase_sampler_split(torch, 1 << 17, 256, 20, xi0=0.235**2, eta=1.9,
                            rho=-0.9, h=0.07)
        phase_sampler_split(torch, 1 << 20, 252, 5)
        log("phase 5: main paths through the CLI")
        counts, bench, wall, n_paths, vanilla = phase_main_path(torch)
        counts["fused_functionals"] = phase_path_dependent(
            torch, vanilla)["fused_functionals"]
        log("phase 6: the rough-Bergomi path through the CLI")
        rb = phase_rbergomi(torch)
        for k in ("normal_matrix", "rbergomi_terminal"):
            counts[k] = rb[k]
        log("phase 7: the multi-asset path (K7; K2-K4 on the basket)")
        t7 = time.perf_counter()
        phase_basket_parity(torch, errs, times)
        counts["packed_basket_terminal"] = phase_multi_asset(torch)[
            "packed_basket_terminal"]
        log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")
        log("phase 8: the GARCH path (K2-K4 on GarchProc; "
            "garch_monte_carlo, portfolio_var_on_device, var --on-device)")
        t8 = time.perf_counter()
        procs, chunk_ms = phase_garch_parity(torch, errs, times)
        phase_garch_mc(torch, chunk_ms)
        phase_garch_var(torch, procs, chunk_ms)
        phase_garch_profile(torch, procs)
        log(f"  phase 8 took {time.perf_counter() - t8:.1f} s, on {card}")
        log("phase 9: randomized QMC (Sobol and bridge-Sobol draws in "
            "K2-K4; RQMC through the CLI)")
        t9 = time.perf_counter()
        phase_qmc_parity(torch, errs)
        phase_qmc_shapes(torch, errs, times)
        qmc_counts, rqmc_wall, rqmc_paths = phase_qmc_path(torch)
        for name, *_ in KERNELS:
            if name.endswith(("_sobol", "_bridge")):
                counts[name] = qmc_counts[name]
        log(f"  RQMC wall-clock to std-err 1e-3 {rqmc_wall:.3f} s "
            f"({rqmc_paths} paths) against the iid loop's {wall:.3f} s "
            f"({n_paths} paths), on {card}")
        log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")
        log("phase 10: jump, Levy, QE and SABR processes on K2-K4")
        t10 = time.perf_counter()
        phase_jump_parity(torch, errs)
        t_shapes = time.perf_counter()
        phase_jump_shapes(torch, errs, times)
        t_path = time.perf_counter()
        counts.update(phase_jump_path(torch))
        log(f"  phase 10: parity {t_shapes - t10:.1f} s, timed shapes "
            f"{t_path - t_shapes:.1f} s, CLI path "
            f"{time.perf_counter() - t_path:.1f} s")
        log(f"  phase 10 took {time.perf_counter() - t10:.1f} s, on {card}")
        log("phase 11: local and stochastic-local volatility on K2-K4 "
            "(LocalVolProc, SlvProc's KernelRows read, SlvKnotsProc)")
        t11 = time.perf_counter()
        phase_surface_parity(torch, errs)
        t_calib = time.perf_counter()
        phase_surface_calibration(torch)
        t_shapes = time.perf_counter()
        phase_surface_shapes(torch, errs, times)
        t_path = time.perf_counter()
        counts.update(phase_surface_path(torch))
        log(f"  phase 11: parity {t_calib - t11:.1f} s, calibration "
            f"{t_shapes - t_calib:.1f} s, timed shapes "
            f"{t_path - t_shapes:.1f} s, CLI path "
            f"{time.perf_counter() - t_path:.1f} s")
        log(f"  phase 11 took {time.perf_counter() - t11:.1f} s, on {card}")
        k3_ms = times["fused_block_moments"]["ms"]
        kernel_s = k3_ms * 1e-3 * n_paths / (1 << 22)
        log(f"  K1 {bench['value']:.6e} path-steps/s, wall-clock to "
            f"std-err 1e-3 {wall:.3f} s, on {card}")
        log(f"  tolerance run: {n_paths >> 22} K3 chunks x {k3_ms:.3f} ms = "
            f"{kernel_s:.3f} s of kernel time, "
            f"{100 * kernel_s / wall:.1f}% of its wall-clock")
    except Exception:  # report every failure with its traceback
        traceback.print_exc()
        return 1

    # K1's time is the bench's, at the shape phase 4 timed and bounded.
    times["gbm_terminal"]["ms"] = bench["ms_per_rep"]
    kernels = []
    for name, source, replaces in KERNELS:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "montecarlo_tpu_torch/csrc/" + source,
            "replaces": "montecarlo_tpu/ops/" + replaces,
            "launches": counts[name], "max_abs_err": errs[name],
            **times[name],
            # No single PyTorch call computes Threefry-keyed paths.
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
