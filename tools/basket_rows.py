"""K2-K4 on the correlated basket at the main paths' shapes, timed on the
card: the rows ROADMAP ranks the basket by, for comparing two checkouts
(run it from the root of each, in turns, in one call) and variants of the
basket's translation unit.

Rows (CUDA events, one warm-up, then ``--reps`` calls; each beside its
bound from ``chip_smoke.basket_bound``/``k7_bound``):

- K2 on the basket at ``bench --basket``'s 2^18 paths x 512 steps, A = 5,
  8, 16 (seed 1000), and at A = 32 (BasketProc<128>, on no main path);
- K3 on the 5-asset call at ``price_to_tolerance``'s 2^22 x 252 chunk;
- K4 {avg} on the 5-asset basket at the basket Asian's 2^20 x 252;
- K7 at 2^18 x 512, A = 8 and 16, the yardstick at the same shape;
- ``price_to_tolerance`` on the 5-asset call to std-err 1e-3 (host clock,
  31 K3 chunks), twice.

Each row prints one JSON line with a SHA-256 of its output bytes, so two
checkouts that must agree bitwise can be compared line by line.

``--sass`` writes the SASS of the basket's K2, K3 and K4 kernels (5
assets, and K2 at 16; plain Threefry) from the built library to
``--out-dir`` and prints their instruction counts by opcode.
``--variants`` rebuilds the basket's K2-K4 from edited copies of
``csrc/fused_basket.cuh`` and ``csrc/basket_step.cuh`` (VARIANTS: every
A's step pairs streamed, or staged; 1 or 4 Threefry calls in lock step
for every A; A <= 8
on ``BasketProc<8>``, capacity 8 with the runtime A and the pair's draws
all made before its steps; A <= 16 on ``BasketProc<16>``, the functor
before the redesign) and times the K2, K3 and K4 rows on each.
Needs one CUDA card and nvcc; run from the root of a checkout:

    python3 tools/basket_rows.py [--label NAME] [--sass] [--variants [NAMES]]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

# Text edits of the variants: (file, old, new); each old text must be
# there once.
_LANES = ("basket_step.cuh",
          "return n_assets >= 4 ? 2 : 1;")
_STAGED = ("basket_step.cuh", "return n_assets > 8;")
_FIXED = ("fused_basket.cuh", "  if (dims <= bstep::kMaxAssets) {\n")
VARIANTS = {
    "streamed": [(*_STAGED, "return false;")],
    "staged": [(*_STAGED, "return true;")],
    "lanes 1": [(*_LANES, "return 1;")],
    "lanes 4": [(*_LANES, "return 4;")],
    "capacity 8": [(*_FIXED, "  if (dims <= 8) {\n    return launch_source<"
                    "Launcher, BasketProc<8>>(a, dims, blocks, s, args...);"
                    "\n  }\n" + _FIXED[1])],
    "capacity 16": [(*_FIXED, "  if (dims <= 16) {\n    return launch_source<"
                     "Launcher, BasketProc<16>>(a, dims, blocks, s, "
                     "args...);\n  }\n" + _FIXED[1])],
}


def log(row: dict) -> None:
    print(json.dumps(row), flush=True)


def cuda_ms(torch, fn, reps: int):
    """Milliseconds per call of ``fn`` by CUDA events after a quarter
    second of warm-up calls (the clocks ramp up), and the last call's
    result."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.25:
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


def digest(out) -> str:
    """SHA-256 (first 16 hex digits) of a result's bytes, in field order."""
    h = hashlib.sha256()
    parts = (out.values() if isinstance(out, dict)
             else (out.mean, out.m2) if hasattr(out, "m2") else (out,))
    for t in parts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_rows(torch, label: str, reps: int, full: bool) -> None:
    """The K2, K3 and K4 rows on the basket (and, when ``full``, K7, the
    A = 32 row and price_to_tolerance)."""
    import chip_smoke as cs
    from montecarlo_tpu_torch.bench import (BASKET_PATHS, BASKET_STEPS,
                                            bench_basket)
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                             price_to_tolerance)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal,
                                          packed_basket_terminal)

    n, t = BASKET_PATHS, BASKET_STEPS
    rows = [(f"K2 A={a} {n}x{t}", cs.basket_bound(n, t, a),
             lambda b=bench_basket(a): fused_terminal(b, n, t, seed=1000))
            for a in (5, 8, 16)]
    b5 = bench_basket(5)
    pay = VanillaPayoff("call", cs.BASKET_STRIKE)
    n3, s3, n4 = cs.TOL_CHUNK, cs.TOL_STEPS, cs.ASIAN_PATHS
    rows += [
        (f"K3 A=5 call {n3}x{s3}",
         cs.basket_bound(n3, s3, 5, out_bytes=8 / 128, extra_fp=8),
         lambda: fused_block_moments(b5, pay, n3, s3, seed=0)),
        (f"K4 A=5 {{avg}} {n4}x{s3}",
         cs.basket_bound(n4, s3, 5, observe=True, out_bytes=8),
         lambda: fused_functionals(b5, n4, s3, seed=0,
                                   functionals={"avg": ARITH_MEAN}))]
    if full:
        rows += [(f"K2 A=32 {n}x{t}", cs.basket_bound(n, t, 32),
                  lambda b=bench_basket(32): fused_terminal(b, n, t,
                                                            seed=1000))]
        rows += [(f"K7 A={a} {n}x{t}", cs.k7_bound(n, t, a),
                  lambda b=bench_basket(a): packed_basket_terminal(
                      b, n, t, seed=1000)) for a in (8, 16)]
    for name, (bnd, by), fn in rows:
        ms, out = cuda_ms(torch, fn, reps)
        log({"label": label, "row": name, "ms": round(ms, 4),
             "bound_ms": round(bnd, 4), "bound_by": by,
             "digest": digest(out)})
        del out
    if full:
        for rep in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est = price_to_tolerance(b5, pay, target_std_err=1e-3, seed=0,
                                     chunk_paths=n3, n_steps=s3,
                                     discount=math.exp(-0.03))
            price = float(est["price"])
            wall = time.perf_counter() - t0
            log({"label": label, "row": f"price_to_tolerance A=5 rep {rep}",
                 "s": round(wall, 4), "chunks": est["n_chunks"],
                 "price": price, "std_err": float(est["std_err"])})


def sass(label: str, out_dir: Path) -> None:
    """The basket's K3 (RowMoments) and K4 kernels at 5 assets under plain
    Threefry draws: their SASS to ``out_dir`` and their opcode counts."""
    from montecarlo_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    kernels = re.split(r"\n\s*Function : ", text)[1:]
    # The functor at 5 assets: BasketFixed<5>, or BasketProc<16> before
    # it; K2 also at 16 assets.
    for body in kernels:
        name = body.split("\n", 1)[0].strip()
        if "ThreefryDrawsILb0E" not in name:
            continue
        kind = ("K4" if "fused_functional_kernel" in name else
                "K3" if "RowMoments" in name else
                "K2" if "StoreTerminal" in name else None)
        if "BasketFixedILi16E" in name and kind == "K2":
            kind = "K2-16"
        elif not re.search(r"BasketFixedILi5E|BasketProcILi16E", name):
            kind = None
        if kind is None:
            continue
        ops = Counter()
        for line in body.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+"
                         r"(?:\.[A-Z0-9_]+)*)", line)
            if m:
                ops[m.group(1)] += 1
        (out_dir / f"sass_{label}_{kind}.txt").write_text(body)
        keys = ("FMUL", "FADD", "FFMA", "FRND", "FRND.FLOOR", "MUFU.LG2",
                "MUFU.EX2", "MUFU.SIN", "MUFU.COS", "MUFU.RSQ", "MUFU.SQRT",
                "IADD3", "LOP3.LUT", "SHF.L.W.U32.HI", "LDS", "LDS.128",
                "LDG.E", "LDG.E.CONSTANT", "LDC", "BRA", "BSSY", "F2I.NTZ",
                "I2F", "FSETP.GEU.AND", "FMNMX")
        log({"label": label, "sass": kind, "function": name[-80:],
             "instructions": sum(ops.values()),
             "ops": {k: ops[k] for k in keys if ops[k]},
             "top": ops.most_common(12)})


def build_variant(name: str, edits) -> ctypes.CDLL:
    """The library's K2-K4 (fused_engine.cu, the fused_basket*.cu, common.cu)
    with ``edits`` made to copies of the sources; the loaded library."""
    from montecarlo_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants" / name.replace(" ", "_")
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(_build.CSRC, out)
    for fname, old, new in edits:
        src = (out / fname).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"{fname}: the text of variant {name!r} is "
                               f"not there once")
        (out / fname).write_text(src.replace(old, new))
    objs = []
    procs = []
    for stem in ("fused_engine", "fused_basket", "fused_basket_k3",
                 "fused_basket_k4", "fused_basket_k4_even", "common"):
        obj = out / f"{stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(obj),
             str(out / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        _build._finish(p.args, p)
    so = out / "libvariant.so"
    link = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
            *map(str, objs)]
    _build._finish(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    lib = ctypes.CDLL(str(so))
    lib.mc_error_string.argtypes = [ctypes.c_int]
    lib.mc_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=ROOT.name)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS),
                    default="", help="comma-separated names (all if none)")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("basket_rows: no CUDA card", file=sys.stderr)
        return 1
    from montecarlo_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_library()
    log({"label": args.label, "card": card,
         "library_s": round(time.perf_counter() - t0, 1)})
    out_dir = Path(args.out_dir)
    out_dir.mkdir(exist_ok=True)
    if args.sass:
        sass(args.label, out_dir)
    libs = {}
    names = [v for v in args.variants.split(",") if v]
    if names:
        with ThreadPoolExecutor(len(names)) as ex:
            libs = dict(zip(names, ex.map(
                build_variant, names, [VARIANTS[v] for v in names])))
    kernel_rows(torch, args.label, args.reps, full=True)
    main_lib = _build.load_library
    try:
        for name, lib in libs.items():
            _build.load_library = lambda lib=lib: lib
            kernel_rows(torch, f"{args.label} {name}", args.reps, full=False)
    finally:
        _build.load_library = main_lib
    if libs:
        kernel_rows(torch, f"{args.label} again", args.reps, full=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
