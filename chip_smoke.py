#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``montecarlo_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
CUDA kernels from ``montecarlo_tpu_torch/csrc`` and, in phases:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. K0: Threefry words, uniforms and exp32 of the device build against the
   plain PyTorch versions on 2^20 counters (bitwise), Box-Muller and log32
   (bitwise fraction, max difference);
3. K1, K2 (plain and antithetic) and K3 against their plain versions at
   2^18 paths x {252, 17} steps;
4. each kernel against its plain version again, and both timed, at the
   shapes the main path gives it;
5. the main path through the CLI entry — ``price`` with fixed paths (K2,
   plain and antithetic), ``price --target-se 1e-3`` (K3) and ``bench``
   (K1) — with launch counters reset just before and read just after, and
   each price held against Black-Scholes;

then prints one JSON line describing the kernels and, last, the
``{"ok": true, "device": ...}`` line.  Any failure prints its traceback and
exits non-zero; without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time
import traceback

PRICE_RTOL = 2e-6    # kernel vs plain version, terminal prices
MOMENT_RTOL = 1e-6   # kernel vs plain version, block (mean, M2)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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

    def check(key, label, kernel, plain, reps, rtol, fields=(None,)):
        ms, got = cuda_ms(kernel, reps)
        plain_ms, want = cuda_ms(plain, 1)
        t.setdefault(key, ms)
        t.setdefault(key + "_plain", plain_ms)
        log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        for f in fields:
            g, w = (got, want) if f is None else (getattr(got, f),
                                                  getattr(want, f))
            _, max_abs, _ = compare(f"{label}{'' if f is None else ' ' + f}",
                                    g, w, rtol)
            errs[key] = max(errs.get(key, 0.0), max_abs)
        del got, want
        torch.cuda.synchronize()

    n1, s1 = 1 << 20, 1024
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s1, device="cuda")
    check("gbm_terminal", f"K1 {n1}x{s1}",
          lambda: gbm_terminal(gbm, n1, s1, seed=1000),
          lambda: gbm_terminal_reference(gbm, n1, s1, seed=1000),
          3, PRICE_RTOL)
    n2, s2 = 1 << 20, 252
    proc = GBM.create(100.0, 0.03, 0.2, 1.0 / s2, device="cuda")
    for anti in (False, True):
        check("fused_terminal",
              f"K2 {'antithetic' if anti else 'plain'} {n2}x{s2}",
              lambda: fused_terminal(proc, n2, s2, seed=0, antithetic=anti),
              lambda: fused_terminal_reference(proc, n2, s2, seed=0,
                                               antithetic=anti),
              10, PRICE_RTOL)
    n3 = 1 << 22
    pay = VanillaPayoff("call", 105.0)
    for off in (0, 37 * n3):
        check("fused_block_moments", f"K3 call {n3}x{s2} offset {off}",
              lambda: fused_block_moments(proc, pay, n3, s2, seed=0,
                                          path_offset=off),
              lambda: fused_block_moments_reference(proc, pay, n3, s2,
                                                    seed=0, path_offset=off),
              5, MOMENT_RTOL, fields=("mean", "m2"))
    return t


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
    out, _ = run_cli(fixed)
    check_price("price --paths 1048576 --steps 252", out)
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
    log(f"  launches on the main path: {counts}")
    missing = [k for k, v in counts.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return counts, bench, wall, out["n_paths"]


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
        _build.load_library()
        log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s"
            f" ({_build.library_path().name})")
        log("phase 2: K0 device math vs plain versions, 2^20 counters")
        phase_k0(torch)
        log("phase 3: K1/K2/K3 vs plain versions, 2^18 paths")
        errs = {}
        phase_parity(torch, errs)
        log("phase 4: K1/K2/K3 vs plain versions and times, main-path "
            "shapes")
        times = phase_main_shapes(torch, errs)
        log("phase 5: main path through the CLI")
        counts, bench, wall, n_paths = phase_main_path(torch)
        kernel_s = times["fused_block_moments"] * 1e-3 * n_paths / (1 << 22)
        log(f"  K1 {bench['value']:.6e} path-steps/s, wall-clock to "
            f"std-err 1e-3 {wall:.3f} s, on {card}")
        log(f"  tolerance run: {n_paths >> 22} K3 chunks x "
            f"{times['fused_block_moments']:.3f} ms = {kernel_s:.3f} s of "
            f"kernel time, {100 * kernel_s / wall:.1f}% of its wall-clock")
    except Exception:  # report every failure with its traceback
        traceback.print_exc()
        return 1

    src = "montecarlo_tpu_torch/csrc/"
    kernels = [
        {"name": "gbm_terminal", "route": "cuda",
         "source": src + "gbm_kernel.cu",
         "replaces": "montecarlo_tpu/ops/gbm_kernel.py:118",
         "launches": counts["gbm_terminal"],
         "max_abs_err": errs["gbm_terminal"], "ms": bench["ms_per_rep"],
         "plain_ms": times["gbm_terminal_plain"]},
        {"name": "fused_terminal", "route": "cuda",
         "source": src + "fused_engine.cu",
         "replaces": "montecarlo_tpu/ops/fused_engine.py:231",
         "launches": counts["fused_terminal"],
         "max_abs_err": errs["fused_terminal"],
         "ms": times["fused_terminal"],
         "plain_ms": times["fused_terminal_plain"]},
        {"name": "fused_block_moments", "route": "cuda",
         "source": src + "fused_engine.cu",
         "replaces": "montecarlo_tpu/ops/fused_engine.py:478",
         "launches": counts["fused_block_moments"],
         "max_abs_err": errs["fused_block_moments"],
         "ms": times["fused_block_moments"],
         "plain_ms": times["fused_block_moments_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
