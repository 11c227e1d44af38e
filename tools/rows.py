"""Rows of the port's K2-K7 at the main paths' shapes, timed on the
card: the rows ROADMAP ranks the redesigns by, for comparing two checkouts
(run it from the root of each, in turns, in one call) and variants of the
kernels' sources.

Row sets (``ROW_SETS``):

- ``basket``: K2 on the basket at ``bench --basket``'s 2^18 paths x 512
  steps, A = 5, 8, 16 (seed 1000); K3 on the 5-asset call at
  ``price_to_tolerance``'s 2^22 x 252 chunk; K4 {avg} on the 5-asset basket
  at the basket Asian's 2^20 x 252; on the checkout's own library also K2
  at A = 32 (BasketProc<128>, on no main path), K7 at A = 8 and 16 and
  ``price_to_tolerance`` on the 5-asset call to std-err 1e-3 (host clock,
  twice);
- ``slv_sobol``: SLV (``chip_smoke.surface_procs``: the CLI's calibrated
  SLV, its SLVKnots and the CEV surface): K2 at 2^20 x 252 on each, K3 on
  the SLV call at two 2^22 x 252 tolerance chunks (0 and 7), K4 {avg} on
  the SLV at 2^20 x 252; Heston's K2, K3 and K4 at the same shapes, the
  rate SLV is held to.  Sobol (phase 9's shapes): K2 and K3 on GBM at the
  RQMC chunk 2^18 x 252 (K3 at chunk offset 5 x 2^18), K4 {avg} at 2^17 x
  252, the same under bridge-Sobol draws, K2 on Heston at 2^17 and 2^20 x
  252, and the Threefry K2 on GBM at 2^18 x 252 beside them; first, on the
  checkout's own library, the Sobol K2 as ``chip_smoke.py`` times it (one
  warm-up call, then 10, on a card left idle by the builds).
- ``rbergomi``: K6 at the CLI's 2^20 x 252, at
  ``experiments/rbergomi_bench.py``'s 2^17 x 256 (its model) and at an
  unaligned 2^20 - 3 x 252 (the plain-load form), each on the joint
  matrix of K5's draws and the factor product; the sampler's K5, product
  and whole ``rbergomi_simulate`` at 2^20 x 252 and 2^17 x 256.
- ``sabr_surface``: K2 at the CLI's 2^20 x 252 on SABR (plain and
  antithetic), local vol (the CLI's CEV surface and a time-dependent one,
  16 time knots each; the CEV also under Sobol and bridge draws), SLVKnots and the
  exact-rows SLV, each launch on a surface on knots with its row build (a
  new process object a call); K3 on the SLV and the CEV call at a 2^22 x
  252 tolerance chunk; K4 {avg} on the CEV at 2^20 x 252; as controls K6
  at 2^20 x 252, the Threefry K2 on GBM at 2^20 x 252 and its K3 at 2^22 x
  252; on the checkout's own library also the row builder alone at 252 x
  128.  Its SASS is that of the Threefry K2 on each functor (SLVKnots'
  own where a checkout has one), K3 on SLV and K6's ring.
- ``qe_vg``: K2 at the CLI's 2^20 x 252 on HestonQE, BatesQE and VG,
  plain and antithetic, and on HestonQE and BatesQE where Feller's
  condition holds (kappa 2, theta 0.04, xi 0.3); K3 on the HestonQE call
  at a 2^22 x 252 tolerance chunk; K4 {avg} on VG at 2^20 x 252; as
  controls K2 on Merton and NIG (which keep ``normal_pair``) at 2^20 x
  252 and the Sobol and bridge K2 on GBM at 2^18 x 252 (which keep
  ``ndtri32``); on the ``qe mix counter`` variant only, the share of
  warp-steps of the QE step that are all quadratic, all exponential or
  mixed at the CLI's and Feller's sets.  Its SASS is that of K2 on the
  five functors, K3 on HestonQE and the Sobol and bridge K2.  Variants:
  HestonQE on the selected QE step, BatesQE on the warp-uniform one, the
  parent's ``ndtri32`` in the QE step, the three functors' normals from
  ``sinf`` and ``cosf``, VG over its two tables.
- ``mgarch``: the 8-asset CCC and DCC books of ``chip_smoke.py``'s phase
  14 (``state_proc``): K2 at the VaR chunk 2^24 x 10, plain and
  antithetic, and at 2^20 x 252, K3 on the 95% put and K4 {mn} at the
  chunk; DCC's K2 at the chunk under Sobol draws and at 3 and 5 assets
  (an odd A keeps the pair's draws); as controls the 5-asset term
  basket's K2 at 2^20 x 252, Vasicek's K2 at 2^20 x 252 (a SincosDraws
  functor), GARCH's K2 at its VaR chunk (2^24 x 20, the 5-year table) and
  GBM's Threefry K2 at 2^20 x 252.  Its SASS is that of the Threefry K2
  and K3 on CCC and DCC at A = 8 and DCC's K2 at 3 and 5, at the chunk;
  its resources the registers, stack and local bytes (a spill's) and the
  warps an SM they leave, of every ``StateProc`` kernel.  Variants, each one
  element of the redesign undone: the constants loaded from device memory
  (``constants loaded``), DCC's c qbar_ij recomputed every step (``c qbar
  in the step``), the pair's draws at an even A (``pair draws``), DCC's
  whole factor before the rows (``factor then rows``); and ``Q in shared
  memory`` (DCC's Q in a [word][thread] column of shared memory), ``pair
  loop`` (a pass of the time loop a step pair, not a step), ``24 warps``
  (``__launch_bounds__(128, 6)``) and both of the last but one.
- ``snapshot``: the surface's snapshot launches of ``chip_smoke.py``'s
  2-, 4- and 6-maturity grids on GBM at 2^17 and 2^20 x 252 and the
  4-maturity grid on Heston at 2^20 (in a checkout that has snapshots:
  the snapshot kernel, or K4's generic fold four snapshots a launch in
  an older one), each beside one bound for either (one time loop to the
  last maturity, a price a path for each maturity) and with the digest
  of the grid's rows in maturity order, however the checkout's launches
  key them; as controls the generic fold on GBM's {mn} (the lookback),
  {mx} (the barrier) and {avg, geo, mx, mn}, Heston's {mn} at 2^20 x 252
  and CCC's and DCC's {mn} at the VaR chunk, GBM's fixed K4 {avg} and K2
  at 2^20 x 252.  Its SASS is that of the snapshot kernel and of K4 on
  the generic fold on GBM and Heston, the fixed {avg} and K2; its
  resources the registers of both kernels on GBM and Heston.  Variant:
  the snapshot kernel's latch marked unlikely (``latch unlikely``).
- ``fold_state``: K4 {trap} on the bond models (Vasicek, CIR, Hull-White,
  G2++; ``chip_smoke.rate_procs``) and K4 {avg} on the 5-asset term
  basket (``state_proc``), both at 2^20 x 252, which run a fixed fold
  where the checkout has one and the generic fold in an older one; as
  controls the same models' K2 at 2^20 x 252, the term basket's K2 and
  its K3 (the call) at a 2^22 x 252 chunk, GBM's fixed K4 {avg} at 2^20 x
  252, and CCC's and DCC's K4 {mn} at the VaR chunk 2^24 x 10 (their
  by-value kernels keep the generic fold).  Its SASS is that of K4 on
  each row's fixed fold and on the generic fold and of K2, under plain
  Threefry draws; its resources the registers and warps an SM of K2 and
  K4 on the rate functors and the term basket.

A kernel row is timed by CUDA events after a quarter second of warm-up,
then ``--reps`` calls, beside its bound from ``chip_smoke``'s bound
functions (the checkout's own); the K3 rows also give the kernel's device
time from the profiler.  Each row prints one JSON line with a SHA-256 of
its output bytes, so two checkouts that must agree bitwise print the same
digests.

``--sass`` writes the SASS of the set's kernels (``sass`` of the set) from
the built library, and from each variant's, to ``--out-dir`` and prints
each kernel's opcode counts: in the whole kernel, in its hottest loop (the
span of its largest backward branch) and on that loop's hot path, with the
hot path's issue floor (warp instructions over 4 schedulers x 132 SMs x
1.98 GHz) at the set's shape (2^22 x 252, K6's 2^20 x 252): one pass per
step pair, or per stage of K steps where the kernel's symbol names a
stage loop (K6's ring, ``rbergomi_ring_kernel<K, S>``).

``--variants`` rebuilds the library from edited copies of the sources (the
set's ``variants``) and times the set's rows on each, the rows of the
checkout's own library left out; a variant with rows of its own (a
counting variant) runs only those.  ``--rounds`` repeats the rows (and the
variants').  Needs one CUDA card and nvcc; run from the root of a
checkout:

    python3 tools/rows.py SET [--label L] [--reps N] [--rounds N]
                          [--sass | --sass-only] [--variants [NAMES]]
                          [--out-dir DIR]
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
from typing import Callable, NamedTuple

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))

# Warp instructions an H100 SXM issues per second: 4 schedulers per SM x
# 132 SMs x the 1.98 GHz boost clock.
WARP_ISSUE_PER_S = 4 * 132 * 1.98e9


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


class Row(NamedTuple):
    name: str
    measure: Callable   # (torch, reps) -> the row's fields
    own: bool = False   # on the checkout's own library only
    only: str = ""      # on this variant's library only


def timed(name, bnd, fn, profile=False, own=False, view=None) -> Row:
    """A kernel row: ``fn`` by CUDA events beside its bound ``bnd`` (ms,
    bound_by), with the profiler's device time when ``profile``: of the
    kernels whose names hold ``fused_kernel``, or the string ``profile``
    gives; the digest of ``view(out)`` where a ``view`` is given."""
    def measure(torch, reps):
        import chip_smoke as cs

        ms, out = cuda_ms(torch, fn, reps)
        row = {"ms": round(ms, 4), "bound_ms": round(bnd[0], 4),
               "bound_by": bnd[1],
               "digest": digest(out if view is None else view(out))}
        del out
        if profile:
            d = cs.device_ms(torch, fn, reps, *(
                (profile,) if isinstance(profile, str) else ()))
            row["device_ms"] = None if d is None else round(d, 4)
        return row
    return Row(name, measure, own)


# ---------------------------------------------------------------- basket

def basket_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.bench import (BASKET_PATHS, BASKET_STEPS,
                                            bench_basket)
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                             price_to_tolerance)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal,
                                          packed_basket_terminal)

    n, t = BASKET_PATHS, BASKET_STEPS
    rows = [timed(f"K2 A={a} {n}x{t}", cs.basket_bound(n, t, a),
                  lambda b=bench_basket(a): fused_terminal(b, n, t,
                                                           seed=1000))
            for a in (5, 8, 16)]
    b5 = bench_basket(5)
    pay = VanillaPayoff("call", cs.BASKET_STRIKE)
    n3, s3, n4 = cs.TOL_CHUNK, cs.TOL_STEPS, cs.ASIAN_PATHS
    rows += [
        timed(f"K3 A=5 call {n3}x{s3}",
              cs.basket_bound(n3, s3, 5, out_bytes=8 / 128, extra_fp=8),
              lambda: fused_block_moments(b5, pay, n3, s3, seed=0)),
        timed(f"K4 A=5 {{avg}} {n4}x{s3}",
              cs.basket_bound(n4, s3, 5, observe=True, out_bytes=8),
              lambda: fused_functionals(b5, n4, s3, seed=0,
                                        functionals={"avg": ARITH_MEAN})),
        timed(f"K2 A=32 {n}x{t}", cs.basket_bound(n, t, 32),
              lambda b=bench_basket(32): fused_terminal(b, n, t, seed=1000),
              own=True)]
    rows += [timed(f"K7 A={a} {n}x{t}", cs.k7_bound(n, t, a),
                   lambda b=bench_basket(a): packed_basket_terminal(
                       b, n, t, seed=1000), own=True) for a in (8, 16)]

    def tolerance(torch, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = price_to_tolerance(b5, pay, target_std_err=1e-3, seed=0,
                                 chunk_paths=n3, n_steps=s3,
                                 discount=math.exp(-0.03))
        price = float(est["price"])
        return {"s": round(time.perf_counter() - t0, 4),
                "chunks": est["n_chunks"], "price": price,
                "std_err": float(est["std_err"])}
    rows += [Row(f"price_to_tolerance A=5 rep {rep}", tolerance, True)
             for rep in range(2)]
    return rows


# Text edits of the variants: (file, old, new); each old text must be
# there once.
_LANES = ("basket_step.cuh",
          "return n_assets >= 4 ? 2 : 1;")
_STAGED = ("basket_step.cuh", "return n_assets > 8;")
_FIXED = ("fused_basket.cuh", "  if (dims <= bstep::kMaxAssets) {\n")
BASKET_VARIANTS = {
    # Every A's step pairs streamed, or staged.
    "streamed": [(*_STAGED, "return false;")],
    "staged": [(*_STAGED, "return true;")],
    # 1 or 4 Threefry calls in lock step for every A.
    "lanes 1": [(*_LANES, "return 1;")],
    "lanes 4": [(*_LANES, "return 4;")],
    # A <= 8 on BasketProc<8>: capacity 8 with the runtime A and the
    # pair's draws all made before its steps.
    "capacity 8": [(*_FIXED, "  if (dims <= 8) {\n    return launch_source<"
                    "Launcher, BasketProc<8>>(a, dims, blocks, s, args...);"
                    "\n  }\n" + _FIXED[1])],
    # A <= 16 on BasketProc<16>, the runtime-A functor BasketFixed<A>
    # replaced.
    "capacity 16": [(*_FIXED, "  if (dims <= 16) {\n    return launch_source<"
                     "Launcher, BasketProc<16>>(a, dims, blocks, s, "
                     "args...);\n  }\n" + _FIXED[1])],
}

# The kernels --sass reads: (tag, regular expressions that must all match
# the mangled name).  Under plain Threefry draws; the A = 5 functor is
# BasketProc<16> in the capacity variants.
_B5 = "BasketFixedILi5E|BasketProcILi(8|16)E"
BASKET_SASS = (
    ("K2 A=5", ("fused_kernel", _B5, "StoreTerminal", "ThreefryDrawsILb0E")),
    ("K3 A=5", ("fused_kernel", _B5, "RowMoments", "ThreefryDrawsILb0E")),
    ("K4 A=5", ("fused_functional_kernel", _B5, "ThreefryDrawsILb0E")),
    ("K2 A=16", ("fused_kernel", "BasketFixedILi16E|BasketProcILi16E",
                 "StoreTerminal", "ThreefryDrawsILb0E")),
)


# ------------------------------------------------------------- slv_sobol

def slv_sobol_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    avg = {"avg": ARITH_MEAN}
    s = cs.SURFACE_STEPS
    nq, nf = cs.QMC_CHUNK, cs.QMC_FUNC
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    dev = SobolDeviceSampler.create(s, 1, device="cuda")

    def k2_sobol():
        return fused_terminal(gbm, nq, s, seed=1, sampler=dev)

    def as_smoke(torch, reps):
        ms, out = cs.cuda_ms(k2_sobol, 10)
        return {"ms": round(ms, 4), "digest": digest(out)}
    rows = [Row(f"K2 gbm sobol {nq}x{s} after one warm-up call", as_smoke,
                True)]
    n, nt = cs.SURFACE_PATHS, cs.SURFACE_TOL_CHUNK
    procs = cs.surface_procs(s)
    slv = procs["slv"]
    pay = VanillaPayoff("call", 105.0)
    rows += [timed(f"K2 {kind} {n}x{s}", cs.surface_bound(kind, proc, n, s),
                   lambda p=proc: fused_terminal(p, n, s, seed=0))
             for kind, proc in (("slv", slv),
                                ("slv_knots", procs["slv_knots"]),
                                ("local_vol", procs["cev"]))]
    rows += [timed(f"K3 slv call {nt}x{s} chunk {c}",
                   cs.surface_bound("slv", slv, nt, s, out_bytes=8 / 128,
                                    extra_fp=8),
                   lambda off=c * nt: fused_block_moments(
                       slv, pay, nt, s, seed=0, path_offset=off),
                   profile=True)
             for c in (0, 7)]
    rows.append(timed(f"K4 slv {{avg}} {n}x{s}",
                      cs.surface_bound("slv", slv, n, s, out_bytes=8,
                                       observe_fp=cs.EXP32_FP + 1),
                      lambda: fused_functionals(slv, n, s, seed=0,
                                                functionals=avg)))
    hp = cs.heston(s)
    hfp = cs.HESTON_STEP_FP
    rows += [
        timed(f"K2 heston {n}x{s}",
              cs.step_bound(n, s, draws=2, step_fp=hfp,
                            extra_fp=cs.EXP32_FP),
              lambda: fused_terminal(hp, n, s, seed=0)),
        timed(f"K3 heston call {nt}x{s}",
              cs.step_bound(nt, s, draws=2, step_fp=hfp, out_bytes=8 / 128,
                            extra_fp=cs.EXP32_FP + 8),
              lambda: fused_block_moments(hp, pay, nt, s, seed=0),
              profile=True),
        timed(f"K4 heston {{avg}} {n}x{s}",
              cs.step_bound(n, s, draws=2, step_fp=hfp + cs.EXP32_FP + 1,
                            out_bytes=8, extra_fp=cs.EXP32_FP),
              lambda: fused_functionals(hp, n, s, seed=0, functionals=avg))]
    hs = SobolDeviceSampler.create(s, 2, device="cuda")
    bridge = SobolBridgeKernelSampler.create(s, device="cuda")
    t_l = (bridge.n_steps, bridge.width)
    off = 5 * nq
    obs = 3 + cs.EXP32_FP + 1
    for src, smp, br in (("sobol", dev, None), ("bridge", bridge, t_l)):
        rows += [
            timed(f"K2 gbm {src} {nq}x{s}",
                  cs.sobol_bound(torch, nq, s, extra_fp=cs.EXP32_FP,
                                 bridge=br),
                  lambda smp=smp: fused_terminal(gbm, nq, s, seed=1,
                                                 sampler=smp)),
            timed(f"K3 gbm {src} call {nq}x{s}",
                  cs.sobol_bound(torch, nq, s, out_bytes=8 / 128,
                                 extra_fp=cs.EXP32_FP + 8, path_offset=off,
                                 bridge=br),
                  lambda smp=smp: fused_block_moments(
                      gbm, pay, nq, s, seed=1, sampler=smp, path_offset=off),
                  profile=True),
            timed(f"K4 gbm {{avg}} {src} {nf}x{s}",
                  cs.sobol_bound(torch, nf, s, step_fp=obs, out_bytes=8,
                                 extra_fp=cs.EXP32_FP, bridge=br),
                  lambda smp=smp: fused_functionals(
                      gbm, nf, s, seed=1, sampler=smp, functionals=avg))]
    rows += [timed(f"K2 heston sobol {nh}x{s}",
                   cs.sobol_bound(torch, nh, s, draws=2, step_fp=hfp,
                                  extra_fp=cs.EXP32_FP),
                   lambda nh=nh: fused_terminal(hp, nh, s, seed=1,
                                                sampler=hs))
             for nh in (nf, 1 << 20)]
    rows.append(timed(f"K2 gbm threefry {nq}x{s}",
                      cs.step_bound(nq, s, extra_fp=cs.EXP32_FP),
                      lambda: fused_terminal(gbm, nq, s, seed=1)))
    return rows


_LEV = ("processes.cuh", """    const float lev =
        static_cast<const Leverage*>(this)->at(s.log_s - log_s0, t);
""")
_STEP_TOP = ("processes.cuh", """  __device__ State step(State s, const float* eps, int t) const {
    const float z1 = eps[0], z2 = eps[1];
""")
_AT = ("processes.cuh", """    const int k = t < 0 ? 0 : (t < n_rows ? t : n_rows - 1);
    return mc::interp_row(lev + (int64_t)k * mc::kKnots, x, x0, dx);
""")
_STAGED_AT = """    // Rows t and t + 1 in a shared double buffer, one barrier a step
    // (every thread of the block is at the same t; 128 threads, one
    // float each).
    __shared__ float rows[2 * mc::kKnots];
    const int tid = threadIdx.x;
    if (t == 0) rows[tid] = __ldg(lev + tid);
    __syncthreads();
    const float* cur = rows + (t & 1) * mc::kKnots;
    const int k = t + 1 < n_rows ? t + 1 : n_rows - 1;
    rows[((t + 1) & 1) * mc::kKnots + tid] = __ldg(lev + k * mc::kKnots + tid);
    float frac;
    const int i = mc::knot_index((x - x0) / dx, &frac);
    return cur[i] * (1.0f - frac) + cur[i + 1] * frac;
"""
# a / d for a divisor fixed over a launch: r = RN(1/d) once, then q0 = a r
# and two fused multiply-add corrections (Markstein), the IEEE division
# for |a| or d outside [2^-60, 2^60], zero, subnormal, infinite or NaN.
_QUOTIENT = """#if defined(__CUDA_ARCH__)
#define MC_FMA(a, b, c) __fmaf_rn(a, b, c)
#else
#define MC_FMA(a, b, c) fmaf(a, b, c)
#endif
struct QuotientBy {
  float d, r, lo;
  MC_HD explicit QuotientBy(float divisor)
      : d(divisor), r(1.0f / divisor),
        lo(divisor >= 0x1p-60f && divisor <= 0x1p60f ? 0x1p-60f
                                                     : INFINITY) {}
  MC_HD float operator()(float a) const {
    const float m = fabsf(a);
    if (m >= lo && m <= 0x1p60f) {
      const float q0 = a * r;
      const float q1 = MC_FMA(MC_FMA(-d, q0, a), r, q0);
      return MC_FMA(MC_FMA(-d, q1, a), r, q1);
    }
    return a / d;
  }
};

"""
_RECIPROCAL = [
    ("surface.cuh", "MC_HD int knot_index(float u, float* frac) {",
     _QUOTIENT + "MC_HD int knot_index(float u, float* frac) {"),
    ("surface.cuh", """MC_HD float interp_row(const float* row, float x, float x0, float dx) {
  float frac;
  const int i = knot_index((x - x0) / dx, &frac);""",
     """MC_HD float interp_row(const float* row, float x, float x0,
                       const QuotientBy& dx) {
  float frac;
  const int i = knot_index(dx(x - x0), &frac);"""),
    ("processes.cuh", "  float log_s0, rate, dt, sq_dt, x0, dx;",
     "  float log_s0, rate, dt, sq_dt, x0;\n"
     "  mc::QuotientBy dx{1.0f};"),
    ("processes.cuh", "    dx = leaves[4];",
     "    dx = mc::QuotientBy(leaves[4]);"),
    ("processes.cuh",
     "  float log_s0, rate, v0, kappa, theta, xi, rho, rho_perp, dt, x0, dx;",
     "  float log_s0, rate, v0, kappa, theta, xi, rho, rho_perp, dt, x0;\n"
     "  mc::QuotientBy dx{1.0f};"),
    ("processes.cuh", "    dx = leaves[9];",
     "    dx = mc::QuotientBy(leaves[9]);"),
]
_WARP_X = ("sobol_warp.cuh", "    const uint32_t x = warp_sobol_bits(lane, "
           "sv + (size_t)dim * kSobolBits);\n    return shifted_normal(x, "
           "keys[dim % kKeyChunk]);")
SLV_SOBOL_VARIANTS = {
    # The surfaces' division by dx as a reciprocal taken once and two fused
    # multiply-add corrections (QuotientBy); the time knots' division by
    # dt_knot is the row builder's, once per step and lane.
    "reciprocal division": _RECIPROCAL,
    # The leverage read first in the SLV step, before the variance's root.
    "lev first": [(*_LEV, ""), (*_STEP_TOP, _STEP_TOP[1].replace(
        "{\n", "{\n" + _LEV[1], 1))],
    # SLV's row staged in shared memory, double-buffered.
    "staged row": [(*_AT, _STAGED_AT)],
    # The Owen key computed per normal again (the walk stays the warp's).
    "key per normal": [("sobol_warp.cuh",
                        "    return shifted_normal(x, keys[dim % "
                        "kKeyChunk]);",
                        "    return shifted_normal(x, sobol_key(k0, k1, "
                        "dim));")],
    # Each lane's own loop over its Gray code's set bits again (the keys
    # stay staged).
    "loop walk": [
        ("sobol_warp.cuh", "  WarpLane lane;\n  uint32_t staged",
         "  WarpLane lane;\n  uint32_t id_;\n  uint32_t staged"),
        ("sobol_warp.cuh",
         "threadIdx.x & (kWarp - 1)) {}",
         "threadIdx.x & (kWarp - 1)), id_(id) {}"),
        (*_WARP_X, "    const uint32_t x = sobol_bits(sv + (size_t)dim * "
         "kSobolBits, id_);\n    return shifted_normal(x, keys[dim % "
         "kKeyChunk]);")],
}

SLV_SOBOL_SASS = (
    ("K3 slv", ("fused_kernel", "SlvProc", "RowMoments",
                "ThreefryDrawsILb0E")),
    ("K3 heston", ("fused_kernel", "HestonProc", "RowMoments",
                   "ThreefryDrawsILb0E")),
    ("K3 slv_knots", ("fused_kernel", "SlvKnotsProc", "RowMoments",
                      "ThreefryDrawsILb0E")),
    ("K3 local_vol", ("fused_kernel", "LocalVolProc", "RowMoments",
                      "ThreefryDrawsILb0E")),
    ("K2 gbm sobol", ("fused_kernel", "GbmProc", "StoreTerminal",
                      "SobolDraws")),
    ("K2 gbm bridge", ("fused_kernel", "GbmProc", "StoreTerminal",
                       "BridgeDraws")),
)


# ----------------------------------------------------------- fold_bridge

def fold_bridge_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.cli.pricing import cli_process
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                             RUNNING_MAX, RUNNING_MIN,
                                             VanillaPayoff, autocallable,
                                             barrier_survival_up,
                                             cliquet_sum)
    from montecarlo_tpu_torch.bench import bench_basket
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    s, n = 252, 1 << 20
    dt = 1.0 / s
    gbm = GBM.create(100.0, 0.03, 0.2, dt, device="cuda")
    obs = 3 + cs.EXP32_FP  # a GBM step and its observation's exp32
    sets = {
        "{avg}": ({"avg": ARITH_MEAN}, obs + 1, 8),
        "{avg,mx,mn}": ({"avg": ARITH_MEAN, "mx": RUNNING_MAX,
                         "mn": RUNNING_MIN}, obs + 3, 16),
        "{surv}": ({"surv": barrier_survival_up(126.0, 0.2, dt)},
                   3 + 5 + cs.EXP32_FP, 8),
        "{avg,geo,mx,mn} (generic)": (
            {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
             "mn": RUNNING_MIN}, obs + 4, 20)}

    def k4(proc, paths, fns, **kw):
        return lambda: fused_functionals(proc, paths, s, seed=0,
                                         functionals=fns, **kw)
    rows = []
    for tag, (fns, step_fp, out) in sets.items():
        rows.append(timed(f"K4 gbm {tag} {n}x{s}",
                          cs.step_bound(n, s, step_fp=step_fp,
                                        out_bytes=out, extra_fp=cs.EXP32_FP),
                          k4(gbm, n, fns)))
    avg = sets["{avg}"][0]
    rows.append(timed(f"K4 gbm {{avg}} antithetic {n}x{s}",
                      cs.step_bound(n, s, step_fp=obs + 1, out_bytes=8,
                                    extra_fp=cs.EXP32_FP),
                      k4(gbm, n, avg, antithetic=True)))
    # The notes' shapes: 2^17 paths, 4 periods of 63 steps.
    nn = 1 << 17
    for tag, fn in (("autocall", autocallable(63, 100.0, 0.02, 0.03 * dt,
                                              70.0, 100.0)),
                    ("cliquet", cliquet_sum(63, -0.02, 0.03))):
        rows.append(timed(f"K4 gbm {tag} {nn}x{s}",
                          cs.step_bound(nn, s, step_fp=obs + 2, out_bytes=8,
                                        extra_fp=cs.EXP32_FP),
                          k4(gbm, nn, {tag: fn})))
    hp = cs.heston(s)
    rows.append(timed(f"K4 heston {{avg}} {n}x{s}",
                      cs.step_bound(n, s, draws=2,
                                    step_fp=(cs.HESTON_STEP_FP + cs.EXP32_FP
                                             + 1),
                                    out_bytes=8, extra_fp=cs.EXP32_FP),
                      k4(hp, n, avg)))
    garch = cs.garch_process(*cs.garch_history(1259))
    mxmn = sets["{avg,mx,mn}"][0]
    rows.append(timed(f"K4 garch 5y {{avg,mx,mn}} {n}x{s}",
                      cs.garch_bound(n, s, out_bytes=16), k4(garch, n, mxmn)))
    rows.append(timed(f"K4 basket A=5 {{avg}} {n}x{s}",
                      cs.basket_bound(n, s, 5, observe=True, out_bytes=8),
                      k4(bench_basket(5), n, avg)))
    kou = cs.jump_process("kou", s)
    rows.append(timed(f"K4 kou {{avg}} {n}x{s}",
                      cs.jump_bound("kou", n, s, out_bytes=8,
                                    observe_fp=cs.EXP32_FP + 1),
                      k4(kou, n, avg)))
    slv = cli_process(["--process", "slv", "--steps", str(s), "--paths",
                       str(n)], "cuda")[0]
    rows.append(timed(f"K4 slv {{avg}} {n}x{s}",
                      cs.surface_bound("slv", slv, n, s, out_bytes=8,
                                       observe_fp=cs.EXP32_FP + 1),
                      k4(slv, n, avg)))
    # The Threefry K2 and K3 on GBM at the main path's shapes.
    pay = VanillaPayoff("call", 105.0)
    n3 = 1 << 22
    rows += [
        timed(f"K2 gbm threefry {n}x{s}",
              cs.step_bound(n, s, extra_fp=cs.EXP32_FP),
              lambda: fused_terminal(gbm, n, s, seed=0)),
        timed(f"K2 gbm threefry antithetic {n}x{s}",
              cs.step_bound(n, s, extra_fp=cs.EXP32_FP),
              lambda: fused_terminal(gbm, n, s, seed=0, antithetic=True)),
        timed(f"K3 gbm call {n3}x{s}",
              cs.step_bound(n3, s, out_bytes=8 / 128,
                            extra_fp=cs.EXP32_FP + 8),
              lambda: fused_block_moments(gbm, pay, n3, s, seed=0),
              profile=True)]
    # Sobol and bridge-Sobol draws at phase 9's shapes; the bridge also at
    # 1024 steps, where its dims span four chunks of staged keys.
    nq, nf = cs.QMC_CHUNK, cs.QMC_FUNC
    dev = SobolDeviceSampler.create(s, 1, device="cuda")
    bridge = SobolBridgeKernelSampler.create(s, device="cuda")
    off = 5 * nq
    for src, smp in (("sobol", dev), ("bridge", bridge)):
        br = (smp.n_steps, smp.width) if src == "bridge" else None
        rows += [
            timed(f"K2 gbm {src} {nq}x{s}",
                  cs.sobol_bound(torch, nq, s, extra_fp=cs.EXP32_FP,
                                 bridge=br),
                  lambda smp=smp: fused_terminal(gbm, nq, s, seed=1,
                                                 sampler=smp)),
            timed(f"K3 gbm {src} call {nq}x{s}",
                  cs.sobol_bound(torch, nq, s, out_bytes=8 / 128,
                                 extra_fp=cs.EXP32_FP + 8, path_offset=off,
                                 bridge=br),
                  lambda smp=smp: fused_block_moments(
                      gbm, pay, nq, s, seed=1, sampler=smp, path_offset=off),
                  profile=True),
            timed(f"K4 gbm {{avg}} {src} {nf}x{s}",
                  cs.sobol_bound(torch, nf, s, step_fp=obs + 1, out_bytes=8,
                                 extra_fp=cs.EXP32_FP, bridge=br),
                  lambda smp=smp: fused_functionals(
                      gbm, nf, s, seed=1, sampler=smp, functionals=avg))]
    s4 = 1024
    g4 = GBM.create(100.0, 0.03, 0.2, 1.0 / s4, device="cuda")
    b4 = SobolBridgeKernelSampler.create(s4, device="cuda")
    rows.append(timed(f"K2 gbm bridge {nq}x{s4}",
                      cs.sobol_bound(torch, nq, s4, extra_fp=cs.EXP32_FP,
                                     bridge=(b4.n_steps, b4.width)),
                      lambda: fused_terminal(g4, nq, s4, seed=1,
                                             sampler=b4)))
    return rows


def _fold(*codes) -> str:
    """The K4 kernel of a functional set: the generic kernel of a tree
    whose fold is data (no ``Fold`` in its name), or the instantiation of
    ``codes``."""
    return "^(?!.*Fold)|FixedFoldIJ" + "".join(f"Li{c}E" for c in codes) \
        + "EE"


FOLD_BRIDGE_SASS = (
    ("K4 gbm {avg}", ("fused_functional_kernel", "GbmProc",
                      "ThreefryDrawsILb0E", _fold(0))),
    ("K4 gbm {avg,mx,mn}", ("fused_functional_kernel", "GbmProc",
                            "ThreefryDrawsILb0E", _fold(0, 2, 3))),
    ("K4 gbm {surv}", ("fused_functional_kernel", "GbmProc",
                       "ThreefryDrawsILb0E", _fold(4))),
    ("K4 gbm {avg} sobol", ("fused_functional_kernel", "GbmProc",
                            "SobolDraws", _fold(0))),
    ("K4 gbm {avg} bridge", ("fused_functional_kernel", "GbmProc",
                             "BridgeDraws", _fold(0))),
    ("K2 gbm threefry", ("fused_kernel", "GbmProc", "StoreTerminal",
                         "ThreefryDrawsILb0E")),
    ("K2 gbm sobol", ("fused_kernel", "GbmProc", "StoreTerminal",
                      "SobolDraws")),
    ("K2 gbm bridge", ("fused_kernel", "GbmProc", "StoreTerminal",
                       "BridgeDraws")),
)


# ------------------------------------------------------------- rbergomi

# experiments/rbergomi_bench.py's model (its T = 1).
BENCH_MODEL = dict(xi0=0.235**2, eta=1.9, rho=-0.9, h=0.07)


def k6_row(n, s, **kw) -> Row:
    """K6 at n x s on the joint matrix of K5's draws and the factor
    product, beside chip_smoke.py's K6 bound: the joint matrix read and the
    prices written; a cipher call a pair, an exp32 and 11 float32
    operations a step."""
    import chip_smoke as cs
    from montecarlo_tpu_torch.ops import normal_matrix, rbergomi_terminal
    from montecarlo_tpu_torch.precision import factor_product

    model = cs.rbergomi_model(s, **kw)
    z = normal_matrix(0, 0, n, 2 * s, device="cuda")
    args = (factor_product(model.chol, z), model.tpow(),
            model.kernel_params(), 0, 0)
    del z
    pairs = (s + 1) // 2
    bnd = cs.bound(4 * n * (2 * s + 1), int32=n * pairs * cs.CIPHER_INT,
                   fp32=n * (pairs * cs.BOXMULLER_FP + s * (11 + cs.EXP32_FP)))
    return timed(f"K6 {n}x{s}", bnd,
                 lambda: rbergomi_terminal(*args, n_steps=s))


def rbergomi_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.ops import normal_matrix
    from montecarlo_tpu_torch.precision import factor_product
    from montecarlo_tpu_torch.processes import rbergomi_simulate

    rows = [k6_row(n, s, **kw)
            for n, s, kw in ((1 << 20, 252, {}), (1 << 17, 256, BENCH_MODEL),
                             ((1 << 20) - 3, 252, {}))]
    for n, s, kw in ((1 << 20, 252, {}), (1 << 17, 256, BENCH_MODEL)):
        model = cs.rbergomi_model(s, **kw)
        pairs = s  # K5: a cipher call per column pair of its 2T columns
        rows.append(timed(
            f"K5 {n}x{2 * s}",
            cs.bound(4 * n * 2 * s, int32=n * pairs * cs.CIPHER_INT,
                     fp32=n * pairs * cs.BOXMULLER_FP),
            lambda n=n, s=s: normal_matrix(0, 0, n, 2 * s, device="cuda")))
        z = normal_matrix(0, 0, n, 2 * s, device="cuda")
        # The product: 2 (2T)^2 N float32 operations at 67 TFLOP/s.
        rows.append(timed(f"product {2 * s}x{2 * s} @ {2 * s}x{n}",
                          cs.bound(4 * n * 4 * s, fp32=2 * (2 * s) ** 2 * n),
                          lambda m=model, z=z: factor_product(m.chol, z)))

        def sampler(torch, reps, m=model, n=n):
            ms, out = cuda_ms(torch, lambda: rbergomi_simulate(m, n, seed=0),
                              reps)
            return {"ms": round(ms, 4), "digest": digest(out)}
        rows.append(Row(f"sampler {n}x{s}", sampler))
    return rows


_RING = ("rbergomi_ring.cuh", "constexpr int kStageSteps = 4;  // K: steps a "
         "stage holds\nconstexpr int kStages = 3;      // S: slots of a warp's "
         "ring\n")


def _ring_shape(k, s):
    return [(*_RING, f"constexpr int kStageSteps = {k};\nconstexpr int "
             f"kStages = {s};\n")]


RBERGOMI_VARIANTS = {
    # (a): every shape on the plain-load form, the next pair's four values
    # loaded into registers before the current pair runs.
    "register double buffer": [
        ("rbergomi_kernel.cu", "  if (n_paths % 4 != 0 || (uintptr_t)joint "
         "% 16 != 0) {\n    return (int)cudaErrorInvalidValue;\n  }\n",
         "  return mc_rbergomi_terminal_unaligned(out, joint, tpow, params, "
         "n_paths, n_steps, path_offset, k0, k1, stream);\n"),
        ("rbergomi_kernel.cu", "// The ring form.  Refuses",
         "extern \"C\" int mc_rbergomi_terminal_unaligned(\n    float*, "
         "const float*, const float*, const float*, int64_t, int64_t, "
         "uint32_t,\n    uint32_t, uint32_t, void*);\n\n"
         "// The ring form.  Refuses")],
    # Box-Muller's sine and cosine from sinf and cosf, a range reduction
    # each (rng.cuh's boxmuller_pair, the parent's).
    "sinf and cosf": [("rbergomi_kernel.cu",
                       "  mc::boxmuller_sincos(b0, b1, z0, z1);\n}",
                       "  mc::boxmuller_pair(b0, b1, z0, z1);\n}")],
    # (b) at other stage depths K and ring slots S.
    "ring K=2 S=3": _ring_shape(2, 3),
    "ring K=4 S=2": _ring_shape(4, 2),
    "ring K=8 S=2": _ring_shape(8, 2),
    "ring K=8 S=3": _ring_shape(8, 3),
}

RBERGOMI_SASS = (
    ("K6", ("rbergomi_terminal_kernel",)),
    ("K6 ring", ("rbergomi_ring_kernel",)),
)


# --------------------------------------------------------- sabr_surface

def sabr_surface_rows(torch):
    import dataclasses

    import chip_smoke as cs
    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n, s, nt = 1 << 20, 252, 1 << 22
    sabr = cs.jump_process("sabr", s)
    rows = [timed(f"K2 sabr{tag} {n}x{s}", cs.jump_bound("sabr", n, s),
                  lambda kw=kw: fused_terminal(sabr, n, s, seed=0, **kw))
            for tag, kw in (("", {}), (" antithetic", {"antithetic": True}))]
    procs = cs.surface_procs(s)

    def fresh(proc, **kw):
        """K2 with its row build: a new process object a call."""
        return lambda: fused_terminal(dataclasses.replace(proc), n, s,
                                      **kw)
    for kind, tag, proc in (("local_vol", "cev", procs["cev"]),
                            ("local_vol", "16 knots", procs["tdep"]),
                            ("slv_knots", "slv_knots", procs["slv_knots"]),
                            ("slv", "slv", procs["slv"])):
        rows.append(timed(f"K2 {kind} {tag} {n}x{s}",
                          cs.surface_bound(kind, proc, n, s),
                          fresh(proc, seed=0)))
    cev = procs["cev"]
    step_fp = cs.SURFACE_COST["local_vol"][1]
    for src, smp in (("sobol", SobolDeviceSampler.create(s, 1,
                                                         device="cuda")),
                     ("bridge", SobolBridgeKernelSampler.create(
                         s, device="cuda"))):
        br = (smp.n_steps, smp.width) if src == "bridge" else None
        rows.append(timed(f"K2 local_vol cev {src} {n}x{s}",
                          cs.sobol_bound(torch, n, s, step_fp=step_fp,
                                         extra_fp=cs.EXP32_FP, bridge=br),
                          fresh(cev, seed=1, sampler=smp)))
    pay = VanillaPayoff("call", 105.0)
    rows += [
        timed(f"K3 slv call {nt}x{s}",
              cs.surface_bound("slv", procs["slv"], nt, s, out_bytes=8 / 128,
                               extra_fp=8),
              lambda: fused_block_moments(procs["slv"], pay, nt, s, seed=0),
              profile=True),
        timed(f"K3 local_vol cev call {nt}x{s}",
              cs.surface_bound("local_vol", cev, nt, s, out_bytes=8 / 128,
                               extra_fp=8),
              lambda: fused_block_moments(dataclasses.replace(cev), pay, nt,
                                          s, seed=0),
              profile=True),
        timed(f"K4 local_vol cev {{avg}} {n}x{s}",
              cs.surface_bound("local_vol", cev, n, s, out_bytes=8,
                               observe_fp=cs.EXP32_FP + 1),
              lambda: fused_functionals(dataclasses.replace(cev), n, s,
                                        seed=0,
                                        functionals={"avg": ARITH_MEAN}))]
    # The controls: K6, the Threefry GBM K2 and K3.
    rows.append(k6_row(n, s))
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    rows += [
        timed(f"K2 gbm threefry {n}x{s}",
              cs.step_bound(n, s, extra_fp=cs.EXP32_FP),
              lambda: fused_terminal(gbm, n, s, seed=0)),
        timed(f"K3 gbm call {nt}x{s}",
              cs.step_bound(nt, s, out_bytes=8 / 128,
                            extra_fp=cs.EXP32_FP + 8),
              lambda: fused_block_moments(gbm, pay, nt, s, seed=0),
              profile=True)]
    from montecarlo_tpu_torch import ops

    if hasattr(ops, "surface_rows"):  # the row builder, where it exists
        rows += [timed(f"row builder {tag} 252x128",
                       cs.bound(4 * (p.vol_flat.numel() + s * 128),
                                fp32=s * 128 * cs.SURFACE_ROW_FP),
                       lambda p=p: ops.surface_rows(p.vol_flat, s, p.dt,
                                                    p.dt_knot), own=True)
                 for tag, p in (("cev", cev), ("16 knots", procs["tdep"]))]
    return rows


# SabrProc's Box-Muller pairs from sinf and cosf, a range reduction each
# (rng.cuh's boxmuller_pair, NormalDraws<2>'s).
_SABR_DRAWS = ("processes.cuh", """    mc::boxmuller_sincos(b0, b1, &eps0[0], &eps0[1]);
    mc::boxmuller_sincos(c0, c1, &eps1[0], &eps1[1]);""")
_SABR_CIPHER = ("processes.cuh", """    uint32_t b0, b1, c0, c1;
    mc::threefry2x32(k0, k1, id, 2u * j, &b0, &b1);
    mc::threefry2x32(k0, k1, id, 2u * j + 1u, &c0, &c1);""")
_SABR_POW = ("processes.cuh", """    const float pw =
        f_plus > 0.0f ? mc::exp32(beta * mc::log32(f_plus)) : at_zero;""")
SABR_SURFACE_VARIANTS = {
    "sabr sinf and cosf": [(*_SABR_DRAWS, _SABR_DRAWS[1].replace(
        "boxmuller_sincos", "boxmuller_pair"))],
    # The pair's two cipher calls in lock step.
    "sabr cipher lanes 2": [(*_SABR_CIPHER, """    uint32_t in0[2] = {id, id}, in1[2] = {2u * j, 2u * j + 1u};
    uint32_t o0[2], o1[2];
    mc::threefry2x32_lanes<2>(k0, k1, in0, in1, o0, o1);
    const uint32_t b0 = o0[0], b1 = o1[0], c0 = o0[1], c1 = o1[1];""")],
    # F+^beta under a branch, taken only where F+ > 0, in place of the
    # select of two computed sides.
    "sabr power branch": [(*_SABR_POW, """    float pw = at_zero;
    if (f_plus > 0.0f) pw = mc::exp32(beta * mc::log32(f_plus));""")],
}

_K2 = ("fused_kernel", "StoreTerminal", "ThreefryDrawsILb0E")
SABR_SURFACE_SASS = (
    ("K2 sabr", ("SabrProc", *_K2)),
    ("K2 local_vol", ("LocalVolProc", *_K2)),
    ("K2 slv_knots", ("SlvKnotsProc", *_K2)),
    ("K2 slv", ("SlvProc", *_K2)),
    ("K3 slv", ("fused_kernel", "SlvProc", "RowMoments",
                "ThreefryDrawsILb0E")),
    ("K2 gbm threefry", ("GbmProc", *_K2)),
    ("K6 ring", ("rbergomi_ring_kernel",)),
)


# --------------------------------------------------------------- qe_vg

#: The QE processes where Feller's condition holds (2 kappa theta = 0.16 >
#: xi^2 = 0.09): every step takes the quadratic branch.
FELLER = ["--kappa", "2", "--theta", "0.04", "--xi", "0.3"]


def _qe_mix(kind, flags, n, s):
    """The counting row of ``kind`` (``price --process kind`` with
    ``flags``): K2 at n x s once on the counting variant's library, then
    its warp-steps that were all quadratic, all exponential or mixed."""
    def measure(torch, reps):
        import numpy as np

        from montecarlo_tpu_torch.cli.pricing import cli_process
        from montecarlo_tpu_torch.ops import _build, fused_terminal

        lib = _build.load_library()
        read = lib.mc_qe_mix
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        counts = np.zeros(3, np.uint64)
        proc = cli_process(["--process", kind, "--steps", str(s), *flags],
                           "cuda")[0]
        torch.cuda.synchronize()
        read(counts.ctypes.data, 1)
        out = fused_terminal(proc, n, s, seed=0)
        torch.cuda.synchronize()
        read(counts.ctypes.data, 1)
        total = int(counts.sum())
        return {"warp_steps": total, "digest": digest(out),
                **{k: round(int(c) / total, 6) for k, c in
                   zip(("all_quadratic", "all_exponential", "mixed"),
                       counts)}}
    return measure


def qe_vg_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.cli.pricing import cli_process
    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n, s, nt = 1 << 20, 252, 1 << 22
    procs = {kind: cs.jump_process(kind, s)
             for kind in ("heston-qe", "bates-qe", "vg", "merton", "nig")}
    rows = []
    for kind in ("heston-qe", "bates-qe", "vg"):
        rows += [timed(f"K2 {kind}{tag} {n}x{s}", cs.jump_bound(kind, n, s),
                       lambda p=procs[kind], kw=kw: fused_terminal(
                           p, n, s, seed=0, **kw))
                 for tag, kw in (("", {}), (" antithetic",
                                            {"antithetic": True}))]
    for kind in ("heston-qe", "bates-qe"):
        feller = cli_process(["--process", kind, "--steps", str(s),
                              *FELLER], "cuda")[0]
        rows.append(timed(f"K2 {kind} feller {n}x{s}",
                          cs.jump_bound(kind, n, s),
                          lambda p=feller: fused_terminal(p, n, s, seed=0)))
    pay = VanillaPayoff("call", 105.0)
    rows += [
        timed(f"K3 heston-qe call {nt}x{s}",
              cs.jump_bound("heston-qe", nt, s, out_bytes=8 / 128,
                            extra_fp=8),
              lambda: fused_block_moments(procs["heston-qe"], pay, nt, s,
                                          seed=0),
              profile=True),
        timed(f"K4 vg {{avg}} {n}x{s}",
              cs.jump_bound("vg", n, s, out_bytes=8,
                            observe_fp=cs.EXP32_FP + 1),
              lambda: fused_functionals(procs["vg"], n, s, seed=0,
                                        functionals={"avg": ARITH_MEAN}))]
    # The controls: Merton and NIG keep normal_pair, the Sobol and bridge
    # sources ndtri32.
    rows += [timed(f"K2 {kind} {n}x{s}", cs.jump_bound(kind, n, s),
                   lambda p=procs[kind]: fused_terminal(p, n, s, seed=0))
             for kind in ("merton", "nig")]
    nq = cs.QMC_CHUNK
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    for src, smp in (("sobol", SobolDeviceSampler.create(s, 1,
                                                         device="cuda")),
                     ("bridge", SobolBridgeKernelSampler.create(
                         s, device="cuda"))):
        br = (smp.n_steps, smp.width) if src == "bridge" else None
        rows.append(timed(f"K2 gbm {src} {nq}x{s}",
                          cs.sobol_bound(torch, nq, s, extra_fp=cs.EXP32_FP,
                                         bridge=br),
                          lambda smp=smp: fused_terminal(gbm, nq, s, seed=1,
                                                         sampler=smp)))
    # The branch mix, on the counting variant's library only.
    rows += [Row(f"qe mix {kind}{tag} {n}x{s}", _qe_mix(kind, flags, n, s),
                 only=QE_MIX)
             for kind in ("heston-qe", "bates-qe")
             for tag, flags in (("", []), (" feller", FELLER))]
    return rows


QE_MIX = "qe mix counter"
_QE_TOP = ("qe_step.cuh", "struct QECore {\n")
_QE_TEST = ("qe_step.cuh", "    return *s2 <= 1.5f * *m2;\n")
_QE_ZQ = "    const float zq = sqrtf(b2) + ndtri32_unit(u);\n"
_HESTON_QE = ("processes.cuh", "qe.step_warp_uniform(s.v, eps[1], &k0s, "
              "&sq);")
_BATES_QE = ("processes.cuh", "    const float v_new = qe.step(s.v, eps[1], "
             "&k0s, &sq);")
_VG_AT = ("processes.cuh", "      : quad(leaves + ((8 + 2 * n_table + 3) & "
          "~3)), n(n_table) {\n")
_VG_STEP = ("processes.cuh", "nu * mc::gamma_from_uniforms_quad32(a, "
            "eps[0], eps[1], z0, dz, quad, n);")
QE_VG_VARIANTS = {
    # HestonQE on the selected form, both branches on every warp.
    "selected heston-qe": [(*_HESTON_QE, "qe.step(s.v, eps[1], &k0s, &sq);")],
    # BatesQE on the warp-uniform form.
    "warp-uniform bates-qe": [(*_BATES_QE, _BATES_QE[1].replace(
        "qe.step(", "qe.step_warp_uniform("))],
    # The parent's inverse normal in the QE step (its three rationals).
    "qe ndtri32": [("qe_step.cuh", _QE_ZQ + tail, _QE_ZQ.replace(
        "ndtri32_unit", "ndtri32") + tail)
        for tail in ("    const float den", "    const float v_quad")],
    # The three functors' normals from sinf and cosf (normal_pair's).
    "sinf and cosf": [("processes.cuh",
                       "  mc::boxmuller_sincos(b0, b1, z0, z1);\n}",
                       "  mc::boxmuller_pair(b0, b1, z0, z1);\n}")],
    # VG over its two tables, four 4-byte loads a step (the launch leaves
    # keep them before the interleaved table).
    "vg two tables": [
        (*_VG_AT, "      : quad(leaves + 8), n(n_table) {\n"),
        (*_VG_STEP, "nu * mc::gamma_from_uniforms_table32(a, eps[0], eps[1], "
         "z0, dz, quad, quad + n, n);")],
    # Counts each warp-step of the QE step as all quadratic, all
    # exponential or mixed (mc_qe_mix reads and zeroes the counts).
    QE_MIX: [
        (*_QE_TOP, "#ifdef __CUDACC__\nstatic __device__ unsigned long "
         "long qe_mix[3];\n#endif\n\n" + _QE_TOP[1]),
        (*_QE_TEST, """    const bool quad = *s2 <= 1.5f * *m2;
#ifdef __CUDA_ARCH__
    const unsigned act = __activemask();
    const unsigned q = __ballot_sync(act, quad);
    if ((threadIdx.x & 31u) == (unsigned)(__ffs(act) - 1)) {
      atomicAdd(&qe_mix[q == act ? 0 : (q == 0u ? 1 : 2)], 1ull);
    }
#endif
    return quad;
"""),
        ("fused_engine.cu", "// K2: terminal prices, out (n_paths,).\n",
         """// The QE branch counts into out (3,) on the host; zeroed after.
extern "C" int mc_qe_mix(unsigned long long* out, int reset) {
  cudaMemcpyFromSymbol(out, mc::qe_mix, 3 * sizeof(unsigned long long));
  if (reset) {
    const unsigned long long zero[3] = {0, 0, 0};
    cudaMemcpyToSymbol(mc::qe_mix, zero, sizeof(zero));
  }
  return (int)cudaGetLastError();
}

// K2: terminal prices, out (n_paths,).
""")],
}

QE_VG_SASS = tuple(
    (f"K2 {tag}", (proc, *_K2)) for tag, proc in (
        ("heston-qe", "HestonQEProc"), ("bates-qe", "BatesQEProc"),
        ("vg", "VgProc"), ("merton", "MertonProc"), ("nig", "NigProc"))) + (
    ("K3 heston-qe", ("fused_kernel", "HestonQEProc", "RowMoments",
                      "ThreefryDrawsILb0E")),
    ("K2 gbm sobol", ("fused_kernel", "GbmProc", "StoreTerminal",
                      "SobolDraws")),
    ("K2 gbm bridge", ("fused_kernel", "GbmProc", "StoreTerminal",
                       "BridgeDraws")))


# ---------------------------------------------------------------- mgarch

def mgarch_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.engine import RUNNING_MIN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler

    nv, d = cs.STATE_VAR_CHUNK, cs.STATE_VAR_DAYS
    n, s = 1 << 20, 252
    rows = []
    for kind in ("ccc-garch", "dcc-garch"):
        book = cs.state_proc(kind, 8, d)
        long = cs.state_proc(kind, 8, s)
        put = VanillaPayoff("put", 0.95 * float(torch.dot(book.weights,
                                                          book.s0)))
        rows += [
            timed(f"K2 {kind} A=8 {nv}x{d}", cs.state_bound(kind, 8, nv, d),
                  lambda p=book: fused_terminal(p, nv, d, seed=0)),
            timed(f"K2 {kind} A=8 antithetic {nv}x{d}",
                  cs.state_bound(kind, 8, nv, d),
                  lambda p=book: fused_terminal(p, nv, d, seed=0,
                                                antithetic=True)),
            timed(f"K2 {kind} A=8 {n}x{s}", cs.state_bound(kind, 8, n, s),
                  lambda p=long: fused_terminal(p, n, s, seed=0)),
            timed(f"K3 {kind} A=8 95% put {nv}x{d}",
                  cs.state_bound(kind, 8, nv, d, out_bytes=8 / 128,
                                 extra_fp=8),
                  lambda p=book, put=put: fused_block_moments(p, put, nv, d,
                                                              seed=0),
                  profile="mcf::"),
            timed(f"K4 {kind} A=8 {{mn}} {nv}x{d}",
                  cs.state_bound(kind, 8, nv, d, out_bytes=8, observe=True),
                  lambda p=book: fused_functionals(
                      p, nv, d, seed=0, functionals={"mn": RUNNING_MIN}))]
    dcc = cs.state_proc("dcc-garch", 8, d)
    sobol = SobolDeviceSampler.create(d, 8, scramble_seed=13, device="cuda")
    rows.append(timed(f"K2 dcc-garch A=8 sobol {nv}x{d}",
                      cs.state_bound("dcc-garch", 8, nv, d),
                      lambda: fused_terminal(dcc, nv, d, seed=0,
                                             sampler=sobol)))
    for a_n in (3, 5):
        p = cs.state_proc("dcc-garch", a_n, d)
        rows.append(timed(f"K2 dcc-garch A={a_n} {nv}x{d}",
                          cs.state_bound("dcc-garch", a_n, nv, d),
                          lambda p=p: fused_terminal(p, nv, d, seed=0)))
    # The controls: the term basket (a leaves pointer, the pair's draws at
    # A = 5), Vasicek (SincosDraws<1>), GARCH and GBM.
    tb = cs.state_proc("term-basket", 5, s)
    vas = cs.rate_procs(s)["vasicek"]
    garch = cs.garch_process(*cs.garch_history(1259))
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    gv, gd = cs.VAR_CHUNK, cs.GARCH_DAYS
    rows += [
        timed(f"K2 term-basket A=5 {n}x{s}",
              cs.state_bound("term-basket", 5, n, s),
              lambda: fused_terminal(tb, n, s, seed=0)),
        timed(f"K2 vasicek {n}x{s}", cs.rate_bound("vasicek", n, s),
              lambda: fused_terminal(vas, n, s, seed=0)),
        timed(f"K2 garch 5y {gv}x{gd}", cs.garch_bound(gv, gd),
              lambda: fused_terminal(garch, gv, gd, seed=0)),
        timed(f"K2 gbm threefry {n}x{s}",
              cs.step_bound(n, s, extra_fp=cs.EXP32_FP),
              lambda: fused_terminal(gbm, n, s, seed=0))]
    return rows


_DCC_STEP = """      c.g.update(i, z, out.log_s, out.var);
      const float ae = c.a * eta[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        out.q[tri(i, j)] = (c.cqbar[i * A + j] + ae * eta[j]) +
                           c.b * s.q[tri(i, j)];
      }
    }
    return out;
"""
_DCC_FACTOR = """        l[tri(i, j)] = j == i ? sqrtf(max_nan(sum, kDccEps))
                              : sum / l[tri(j, j)];
      }
      const float dinv"""
_K2_HEAD = """    const __grid_constant__ typename Proc::Leaves leaves, int64_t n_paths,
    int n_steps, uint32_t path_offset, uint32_t k0, uint32_t k1,
    Draws draws, Epilogue epilogue) {"""
_K4_HEAD = """    const __grid_constant__ typename Proc::Leaves leaves, int64_t n_paths,
    int n_steps, uint32_t path_offset, uint32_t k0, uint32_t k1,
    Draws draws, FunctionalSpec spec, float* __restrict__ out) {"""
_GLOBAL_LEAVES = """        typename Proc::Leaves* dev;
        cudaMallocAsync((void**)&dev, sizeof lv, s);
        cudaMemcpyAsync(dev, &lv, sizeof lv, cudaMemcpyHostToDevice, s);
"""
_RUN_STEP = """    for (int t = 0; t < n_steps; ++t) {
      float eps[A];
      step_normals<A>(k0, k1, did, mirror, t, eps);
      st = this->step(st, eps, t);
      after(t);
    }
"""
_Q_SHARED = r"""// DccStep with Q in shared memory: a [word][thread] column of kPairs
// words a path, read and written once a step, in place, a row at a time.
template <int A>
struct DccStepShared {
  using Leaves = DccLeaves<A>;
  static constexpr int kPairs = A * (A + 1) / 2;
  static constexpr int kStride = 128;  // a block's threads
  struct State {
    float log_s[A];
    float var[A];
  };
  MC_HD static constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }
  const Leaves& c;
  float* q;
  __device__ explicit DccStepShared(const Leaves& leaves) : c(leaves) {
    __shared__ float qs[kPairs * kStride];
    q = qs + threadIdx.x;
  }
  __device__ State init() const {
    State s;
    c.g.start(s.log_s, s.var);
#pragma unroll
    for (int i = 0; i < A; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) q[tri(i, j) * kStride] = c.qbar[i * A + j];
    }
    return s;
  }
  __device__ State step(const State& s, const float* eps, int) const {
    float l[kPairs];
    float eta[A];
    State out;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      float qi[A];
#pragma unroll
      for (int j = 0; j <= i; ++j) qi[j] = q[tri(i, j) * kStride];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float sum = qi[j];
#pragma unroll
        for (int k = 0; k < j; ++k) sum = sum - l[tri(i, k)] * l[tri(j, k)];
        l[tri(i, j)] = j == i ? sqrtf(max_nan(sum, kDccEps))
                              : sum / l[tri(j, j)];
      }
      const float dinv = 1.0f / sqrtf(max_nan(qi[i], kDccEps));
      float z = (l[tri(i, 0)] * dinv) * eps[0];
#pragma unroll
      for (int b = 1; b <= i; ++b) z = z + (l[tri(i, b)] * dinv) * eps[b];
      eta[i] = z;
      out.log_s[i] = s.log_s[i];
      out.var[i] = s.var[i];
      c.g.update(i, z, out.log_s, out.var);
      const float ae = c.a * eta[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        q[tri(i, j) * kStride] = (c.cqbar[i * A + j] + ae * eta[j]) +
                                 c.b * qi[j];
      }
    }
    return out;
  }
  __device__ float prices(const State& s) const {
    return book_value<A>(c.w, s.log_s);
  }
};

}  // namespace mc
"""
MGARCH_VARIANTS = {
    # Element 1 undone: the launch leaves in device memory, every constant
    # a load through a pointer.
    "constants loaded": [
        ("fused_mgarch.cuh", _K2_HEAD, _K2_HEAD.replace(
            "const __grid_constant__ typename Proc::Leaves leaves",
            "const typename Proc::Leaves* __restrict__ leaves")),
        ("fused_mgarch.cuh", _K4_HEAD, _K4_HEAD.replace(
            "const __grid_constant__ typename Proc::Leaves leaves",
            "const typename Proc::Leaves* __restrict__ leaves")),
        ("fused_mgarch.cuh", "  const Proc proc(leaves);\n  typename Proc",
         "  const Proc proc(*leaves);\n  typename Proc"),
        ("fused_mgarch.cuh", "  const Proc proc(leaves);\n  const Needs",
         "  const Proc proc(*leaves);\n  const Needs"),
        ("fused_mgarch.cuh", """        state_kernel<Proc, Draws, Epilogue><<<blocks, kRow, 0, s>>>(
            lv, n_paths, n_steps, path_offset, k0, k1, draws, epilogue);
""", _GLOBAL_LEAVES + """        state_kernel<Proc, Draws, Epilogue><<<blocks, kRow, 0, s>>>(
            dev, n_paths, n_steps, path_offset, k0, k1, draws, epilogue);
        cudaFreeAsync(dev, s);
"""),
        ("fused_mgarch.cuh", """        state_functional_kernel<Proc, Draws><<<blocks, kRow, 0, s>>>(
            lv, n_paths, n_steps, path_offset, k0, k1, draws, spec, out);
""", _GLOBAL_LEAVES + """        state_functional_kernel<Proc, Draws><<<blocks, kRow, 0, s>>>(
            dev, n_paths, n_steps, path_offset, k0, k1, draws, spec, out);
        cudaFreeAsync(dev, s);
""")],
    # Element 2 undone for DCC: c qbar_ij recomputed every step (the same
    # bits).
    "c qbar in the step": [
        ("mgarch_steps.cuh", "(c.cqbar[i * A + j] + ae * eta[j])",
         "(((1.0f - c.a) - c.b) * c.qbar[i * A + j] + ae * eta[j])")],
    # Element 3 undone: ThreefryDraws' pair at every A.
    "pair draws": [
        ("fused_mgarch.cuh",
         "    : std::bool_constant<ByValue<Step>::value && A % 2 == 0> {};",
         "    : std::false_type {};")],
    # Element 4 undone: DCC's whole factor first, then each row's eta,
    # update and recursion.
    "factor then rows": [
        ("mgarch_steps.cuh", _DCC_FACTOR, """        l[tri(i, j)] = j == i ? sqrtf(max_nan(sum, kDccEps))
                              : sum / l[tri(j, j)];
      }
    }
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const float dinv"""),
        ("mgarch_steps.cuh", _DCC_STEP, """      c.g.update(i, z, out.log_s, out.var);
    }
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const float ae = c.a * eta[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        out.q[tri(i, j)] = (c.cqbar[i * A + j] + ae * eta[j]) +
                           c.b * s.q[tri(i, j)];
      }
    }
    return out;
""")],
    "Q in shared memory": [
        ("mgarch_steps.cuh", "}  // namespace mc\n", _Q_SHARED),
        ("fused_dcc.cu", "kDccGarch, mc::DccStep)",
         "kDccGarch, mc::DccStepShared)"),
        ("fused_dcc_k4.cu", "kDccGarch, mc::DccStep)",
         "kDccGarch, mc::DccStepShared)")],
    # A pass of the time loop a step pair, each step's draws just before
    # it.
    "pair loop": [
        ("fused_mgarch.cuh", _RUN_STEP, """    const int n_pairs = (n_steps + 1) / 2;
    for (int j = 0; j < n_pairs; ++j) {
      float eps[A];
      step_normals<A>(k0, k1, did, mirror, 2 * j, eps);
      st = this->step(st, eps, 2 * j);
      after(2 * j);
      if (2 * j + 1 < n_steps) {
        step_normals<A>(k0, k1, did, mirror, 2 * j + 1, eps);
        st = this->step(st, eps, 2 * j + 1);
        after(2 * j + 1);
      }
    }
""")],
}
# 24 warps an SM: at most 80 registers a thread; and with Q in shared
# memory.
_BOUNDS = [
    ("fused_mgarch.cuh", "__global__ void state_kernel(",
     "__global__ void __launch_bounds__(kRow, 6) state_kernel("),
    ("fused_mgarch.cuh", "__global__ void state_functional_kernel(",
     "__global__ void __launch_bounds__(kRow, 6) state_functional_kernel(")]
MGARCH_VARIANTS["24 warps"] = _BOUNDS
MGARCH_VARIANTS["Q in shared memory, 24 warps"] = (
    MGARCH_VARIANTS["Q in shared memory"] + _BOUNDS)

# K2 and K3 under plain Threefry draws, the parent's fused_kernel or the
# change's state_kernel.
_STATE_K = r"(fused|state)_kernel"
MGARCH_SASS = tuple(
    (f"K{k} {tag}", (_STATE_K, rf"{step}[A-Za-z]*ILi{a_n}E", epi,
                     "ThreefryDrawsILb0E"))
    for k, epi in ((2, "StoreTerminal"), (3, "RowMoments"))
    for tag, step, a_n in (("ccc A=8", "CccStep", 8),
                           ("dcc A=8", "DccStep", 8),
                           ("dcc A=3", "DccStep", 3),
                           ("dcc A=5", "DccStep", 5))
    if k == 2 or a_n == 8) + (
    ("K2 dcc A=8 antithetic", (_STATE_K, r"DccStep[A-Za-z]*ILi8E",
                               "StoreTerminal", "ThreefryDrawsILb1E")),)


# ------------------------------------------------------------ fold_state

def fold_state_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MIN,
                                             VanillaPayoff,
                                             trapezoid_integral)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_functionals, fused_terminal)
    from montecarlo_tpu_torch.processes import GBM

    n, s = 1 << 20, 252
    procs = cs.rate_procs(s)
    tb = cs.state_proc("term-basket", 5, s)
    avg = {"avg": ARITH_MEAN}
    rows = []
    # The rows: K4 {trap} on the bond models at the bond path's shape, K4
    # {avg} on the 5-asset term basket at its Asian's.
    for kind in cs.RATE_MODELS:
        p = procs[kind]
        fns = {"trap": trapezoid_integral(float(p.dt))}
        rows.append(timed(f"K4 {kind} {{trap}} {n}x{s}",
                          cs.rate_bound(kind, n, s, out_bytes=8,
                                        observe_fp=3),
                          lambda p=p, fns=fns: fused_functionals(
                              p, n, s, seed=0, functionals=fns)))
    rows.append(timed(f"K4 term-basket A=5 {{avg}} {n}x{s}",
                      cs.state_bound("term-basket", 5, n, s, out_bytes=8,
                                     observe=True),
                      lambda: fused_functionals(tb, n, s, seed=0,
                                                functionals=avg)))
    # The controls: the same loops' K2 (and the term basket's K3), GBM's
    # fixed K4 {avg}, and CCC's and DCC's K4 {mn} at the VaR chunk, whose
    # by-value kernels keep the generic fold.
    for kind in cs.RATE_MODELS:
        rows.append(timed(f"K2 {kind} {n}x{s}", cs.rate_bound(kind, n, s),
                          lambda p=procs[kind]: fused_terminal(p, n, s,
                                                               seed=0)))
    nt = cs.TOL_CHUNK
    call = VanillaPayoff("call", float(torch.dot(tb.weights, tb.s0)))
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    rows += [
        timed(f"K2 term-basket A=5 {n}x{s}",
              cs.state_bound("term-basket", 5, n, s),
              lambda: fused_terminal(tb, n, s, seed=0)),
        timed(f"K3 term-basket A=5 call {nt}x{s}",
              cs.state_bound("term-basket", 5, nt, s, out_bytes=8 / 128,
                             extra_fp=8),
              lambda: fused_block_moments(tb, call, nt, s, seed=0),
              profile="mcf::"),
        timed(f"K4 gbm {{avg}} {n}x{s}",
              cs.step_bound(n, s, step_fp=3 + cs.EXP32_FP + 1, out_bytes=8,
                            extra_fp=cs.EXP32_FP),
              lambda: fused_functionals(gbm, n, s, seed=0, functionals=avg))]
    nv, d = cs.STATE_VAR_CHUNK, cs.STATE_VAR_DAYS
    for kind in ("ccc-garch", "dcc-garch"):
        rows.append(timed(f"K4 {kind} A=8 {{mn}} {nv}x{d}",
                          cs.state_bound(kind, 8, nv, d, out_bytes=8,
                                         observe=True),
                          lambda p=cs.state_proc(kind, 8, d):
                          fused_functionals(p, nv, d, seed=0,
                                            functionals={"mn": RUNNING_MIN})))
    return rows


# K4 under plain Threefry draws on the fixed fold of the row's set (none in
# the parent) and on the generic one, and K2 beside them: (tag, step, the
# fixed fold's mangled codes).
_FOLD_STEPS = (("vasicek", "VasicekStep", "Li8E"),
               ("cir", "CirStep", "Li8E"),
               ("hullwhite", "HullWhiteStep", "Li8E"),
               ("g2pp", "G2ppStep", "Li8E"),
               ("term-basket A=5", "TermBasketStepILi5E", "Li0E"))
_TF = "ThreefryDrawsILb0E"
FOLD_STATE_SASS = tuple(
    (f"K4 {kind} {tag}", ("fused_functional_kernel", step, _TF, fold))
    for kind, step, codes in _FOLD_STEPS
    for tag, fold in (("fixed", f"FixedFoldIJ{codes}EE"),
                      ("generic", "SpecFold"))
) + tuple((f"K2 {kind}", ("fused_kernel", step, "StoreTerminal", _TF))
          for kind, step, _ in _FOLD_STEPS) + (
    ("K4 gbm {avg} fixed", ("fused_functional_kernel", "GbmProc", _TF,
                            "FixedFoldIJLi0EEE")),)
FOLD_STATE_RESOURCES = (r"fused_(functional_)?kernel.*(VasicekStep|CirStep|"
                        r"HullWhiteStep|G2ppStep|TermBasketStep).*"
                        r"(StoreTerminal|ThreefryDraws.*Fold)")


# ------------------------------------------------------------ snapshot

def grid_rows(out: dict) -> dict:
    """A maturity grid's rows in maturity order, however a checkout's
    launches key them: the snapshots ``m<step>`` by step, then the
    terminal of the last launch (grouped launches key theirs ``m<step>
    (launch g)`` and ``terminal (launch g)``)."""
    snaps, terms = {}, {}
    for key, v in out.items():
        m = re.fullmatch(r"(?:m(\d+)|terminal)(?: \(launch (\d+)\))?", key)
        if m.group(1) is None:
            terms[int(m.group(2) or 0)] = v
        else:
            snaps[int(m.group(1))] = v
    rows = [snaps[s] for s in sorted(snaps)] + [terms[max(terms)]]
    return dict(enumerate(rows))


def snapshot_rows(torch):
    import chip_smoke as cs
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                             RUNNING_MAX, RUNNING_MIN)
    from montecarlo_tpu_torch.ops import fused_functionals, fused_terminal
    from montecarlo_tpu_torch.processes import GBM

    s = 252
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    hp = cs.heston(s)
    rows = []
    # The rows, in a checkout that has snapshots: each grid's launches on
    # GBM at 2^17 and 2^20 x 252, the 4-maturity grid on Heston at 2^20,
    # each beside the work of the grid whatever computes it (one loop to
    # the last maturity; a price and 4 bytes a path for each maturity).
    def grid_bound(n, grid, draws=1, step_fp=3):
        return cs.step_bound(n, grid[-1], draws=draws, step_fp=step_fp,
                             out_bytes=4 * len(grid),
                             extra_fp=cs.EXP32_FP * len(grid))

    if hasattr(cs, "snapshot_launches"):
        for n in cs.SNAPSHOT_PATHS:
            for m, grid in cs.SNAPSHOT_GRIDS.items():
                rows.append(timed(
                    f"K4 gbm snapshot {m} maturities {n}x{s}",
                    grid_bound(n, grid),
                    lambda n=n, g=grid: cs.snapshot_launches(gbm, n, g),
                    view=grid_rows))
        n = cs.SNAPSHOT_PATHS[-1]
        rows.append(timed(
            f"K4 heston snapshot 4 maturities {n}x{s}",
            grid_bound(n, cs.IV_GRID, draws=2, step_fp=cs.HESTON_STEP_FP),
            lambda: cs.snapshot_launches(hp, n, cs.IV_GRID),
            view=grid_rows))
    # The controls, on the generic fold (whose switch the snapshot case
    # joins) and off it: the lookback's {mn} and the barrier's {mx} and
    # {avg, geo, mx, mn} on GBM at 2^20 x 252, CCC's and DCC's {mn} at the
    # VaR chunk; GBM's fixed K4 {avg} and K2 at 2^20 x 252.
    n, obs = 1 << 20, 3 + cs.EXP32_FP
    sets = {"{mn}": ({"mn": RUNNING_MIN}, obs + 1, 8),
            "{mx}": ({"mx": RUNNING_MAX}, obs + 1, 8),
            "{avg,geo,mx,mn}": ({"avg": ARITH_MEAN, "geo": GEO_MEAN,
                                 "mx": RUNNING_MAX, "mn": RUNNING_MIN},
                                obs + 4, 20),
            "{avg} (fixed)": ({"avg": ARITH_MEAN}, obs + 1, 8)}
    for tag, (fns, step_fp, out) in sets.items():
        rows.append(timed(f"K4 gbm {tag} {n}x{s}",
                          cs.step_bound(n, s, step_fp=step_fp, out_bytes=out,
                                        extra_fp=cs.EXP32_FP),
                          lambda fns=fns: fused_functionals(
                              gbm, n, s, seed=0, functionals=fns)))
    rows.append(timed(f"K4 heston {{mn}} {n}x{s}",
                      cs.step_bound(n, s, draws=2,
                                    step_fp=cs.HESTON_STEP_FP + obs - 2,
                                    out_bytes=8, extra_fp=cs.EXP32_FP),
                      lambda: fused_functionals(
                          hp, n, s, seed=0,
                          functionals={"mn": RUNNING_MIN})))
    nv, d = cs.STATE_VAR_CHUNK, cs.STATE_VAR_DAYS
    for kind in ("ccc-garch", "dcc-garch"):
        rows.append(timed(f"K4 {kind} A=8 {{mn}} {nv}x{d}",
                          cs.state_bound(kind, 8, nv, d, out_bytes=8,
                                         observe=True),
                          lambda p=cs.state_proc(kind, 8, d):
                          fused_functionals(p, nv, d, seed=0,
                                            functionals={"mn": RUNNING_MIN})))
    rows.append(timed(f"K2 gbm {n}x{s}", cs.step_bound(n, s),
                      lambda: fused_terminal(gbm, n, s, seed=0)))
    return rows


# The snapshot kernel's latch marked unlikely, so that the compiler lays
# it out off the time loop's straight path.
SNAPSHOT_VARIANTS = {"latch unlikely": [(
    "fused_k4_snapshot.cu", "    if (fold.due_at(t + 1)) latch(t + 1);",
    "    if (__builtin_expect(fold.due_at(t + 1), 0)) latch(t + 1);")]}

SNAPSHOT_SASS = (
    ("K4 gbm snapshot kernel", ("fused_snapshot_kernel", "GbmProc", _TF)),
    ("K4 heston snapshot kernel", ("fused_snapshot_kernel", "HestonProc",
                                   _TF)),
    ("K4 gbm generic", ("fused_functional_kernel", "GbmProc", _TF,
                        "SpecFold")),
    ("K4 heston generic", ("fused_functional_kernel", "HestonProc", _TF,
                           "SpecFold")),
    ("K4 gbm {avg} fixed", ("fused_functional_kernel", "GbmProc", _TF,
                            "FixedFoldIJLi0EEE")),
    ("K2 gbm", ("fused_kernel", "GbmProc", "StoreTerminal", _TF)),
)


class RowSet(NamedTuple):
    rows: Callable      # torch -> [Row]
    variants: dict      # name -> [(file, old, new)]
    sass: tuple         # (tag, patterns)
    floor_shape: tuple = (1 << 22, 252)  # (paths, steps) of the SASS floor
    resources: str = ""  # the kernels whose registers the set reports


ROW_SETS = {
    "basket": RowSet(basket_rows, BASKET_VARIANTS, BASKET_SASS),
    "slv_sobol": RowSet(slv_sobol_rows, SLV_SOBOL_VARIANTS, SLV_SOBOL_SASS),
    "fold_bridge": RowSet(fold_bridge_rows, {}, FOLD_BRIDGE_SASS),
    "rbergomi": RowSet(rbergomi_rows, RBERGOMI_VARIANTS, RBERGOMI_SASS,
                       (1 << 20, 252)),
    "sabr_surface": RowSet(sabr_surface_rows, SABR_SURFACE_VARIANTS,
                           SABR_SURFACE_SASS, (1 << 20, 252)),
    "qe_vg": RowSet(qe_vg_rows, QE_VG_VARIANTS, QE_VG_SASS, (1 << 20, 252)),
    "mgarch": RowSet(mgarch_rows, MGARCH_VARIANTS, MGARCH_SASS,
                     (1 << 24, 10), "StateProc"),
    "fold_state": RowSet(fold_state_rows, {}, FOLD_STATE_SASS,
                         (1 << 20, 252), FOLD_STATE_RESOURCES),
    "snapshot": RowSet(snapshot_rows, SNAPSHOT_VARIANTS, SNAPSHOT_SASS,
                       (1 << 20, 252),
                       r"fused_(functional_kernel|snapshot_kernel)"
                       r".*(GbmProc|HestonProc).*ThreefryDrawsILb0E"),
}


# ------------------------------------------------------------------ SASS

_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z0-9]+(?:\.[A-Z0-9_]+)*)(.*)")


def parse_sass(body: str):
    """[(address, opcode, operands, predicated)] of one kernel's SASS."""
    out = []
    for line in body.splitlines():
        m = _SASS_LINE.match(line)
        if m:
            out.append((int(m.group(1), 16), m.group(3), m.group(4),
                        m.group(2) is not None))
    return out


def _target(rest: str) -> int:
    return int(re.search(r"0x([0-9a-f]+)", rest).group(1), 16)


def hottest_loop(ins):
    """The instructions from the target of the largest backward branch to
    that branch: the kernel's outer time loop."""
    best = None
    for addr, op, rest, _ in ins:
        if op.startswith("BRA") and re.search(r"0x[0-9a-f]+", rest):
            tgt = _target(rest)
            if tgt < addr and (best is None or addr - tgt > best[1] - best[0]):
                best = (tgt, addr)
    if best is None:
        return []
    return [x for x in ins if best[0] <= x[0] <= best[1]]


def nested_loop(ins):
    """The largest loop inside the hottest loop (the bridge's loop over the
    levels it reloads at a step, each a Sobol normal), or []."""
    loop = hottest_loop(ins)
    best = None
    for addr, op, rest, _ in loop:
        if op.startswith("BRA") and re.search(r"0x[0-9a-f]+", rest):
            tgt = _target(rest)
            if (loop[0][0] < tgt < addr < loop[-1][0]
                    and (best is None or addr - tgt > best[1] - best[0])):
                best = (tgt, addr)
    if best is None:
        return []
    return [x for x in ins if best[0] <= x[0] <= best[1]]


def hot_path(ins, loop=None):
    """The instructions one pass of a loop (the hottest by default)
    issues when no slow path runs: from its head to its back-edge,
    following every branch, where a forward conditional branch is taken
    when the code it skips is a slow path (at most 8 instructions around
    a CALL, the IEEE division's and square root's, or code holding a loop
    of its own, the sine's and cosine's argument reduction) and falls
    through otherwise; an unconditional branch back (from a block the
    compiler placed after the loop) is followed.  A walk that passes as
    many instructions as the kernel has, or runs off its end, raises."""
    loop = hottest_loop(ins) if loop is None else loop
    if not loop:
        return []
    back = loop[-1][0]
    at = {x[0]: k for k, x in enumerate(ins)}
    k, path = at[loop[0][0]], []
    while k < len(ins) and len(path) < len(ins):
        addr, op, rest, pred = ins[k]
        path.append(ins[k])
        if addr == back:
            return path
        if op.startswith("BRA") and _target(rest) > addr:
            skipped = [x for x in ins if addr < x[0] < _target(rest)]
            slow = (len(skipped) <= 8 and any(
                o.startswith("CALL") for _, o, _, _ in skipped)) or any(
                o.startswith("BRA") and _target(r) < a
                for a, o, r, _ in skipped)
            if not pred or slow:
                k = at[_target(rest)]
                continue
        elif op.startswith("BRA") and not pred:
            k = at[_target(rest)]
            continue
        k += 1
    raise ValueError(f"no hot path from {loop[0][0]:#x} to its back-edge "
                     f"{back:#x}")


def stage_steps(name: str) -> int:
    """The steps one pass of a kernel's time loop takes: K in K6's ring
    (``rbergomi_ring_kernel<K, S>``), one in CCC's and DCC's by-value
    kernels at an even A under Threefry draws (``StateProc::run``), else a
    step pair."""
    m = re.search(r"rbergomi_ring_kernelILi(\d+)E", name)
    if m:
        return int(m.group(1))
    m = re.search(r"state_(?:functional_)?kernel.*?Step[A-Za-z]*ILi(\d+)E"
                  r".*ThreefryDraws", name)
    return 1 if m and int(m.group(1)) % 2 == 0 else 2


def passes(name: str, steps: int) -> int:
    """Passes of the time loop of kernel ``name`` over ``steps`` steps."""
    return -(-steps // stage_steps(name))


def sass_bodies(so: Path):
    """[(mangled name, SASS text)] of every kernel in library ``so``."""
    from montecarlo_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    return [(body.split("\n", 1)[0].strip(), body)
            for body in re.split(r"\n\s*Function : ", text)[1:]]


def sass(label: str, out_dir: Path, so: Path, kernels,
         shape=(1 << 22, 252)) -> None:
    """The SASS of ``kernels`` ((tag, patterns)) from library ``so``, to
    ``out_dir``, and their opcode counts: the whole kernel, its hottest
    loop and that loop's hot path (and per step pair), the hot path of the
    largest loop inside it (the bridge's reloads), and the hot path's
    issue floor at ``shape`` = (paths, steps): a pass per warp per step
    pair, or per stage of K6's ring."""
    n, steps = shape
    for name, body in sass_bodies(so):
        for tag, pats in kernels:
            if not all(re.search(p, name) for p in pats):
                continue
            ins = parse_sass(body)
            loop, hot = hottest_loop(ins), hot_path(ins)
            try:
                inner = hot_path(ins, nested_loop(ins))
            except ValueError:  # a loop off the hot path that exits early
                inner = []      # (the snapshot kernel's latch)
            fname = f"sass_{label}_{tag}.txt".replace(" ", "_")
            (out_dir / fname).write_text(body)
            floor = (-(-n // 32) * passes(name, steps) * len(hot)
                     / WARP_ISSUE_PER_S)
            log({"label": label, "sass": tag, "function": name[-90:],
                 "instructions": len(ins), "loop_instructions": len(loop),
                 "hot_instructions": len(hot),
                 "hot_per_pair": round(2 * len(hot) / stage_steps(name), 1),
                 "nested_hot_instructions": len(inner),
                 "floor_shape": f"{n}x{steps}",
                 "hot_issue_floor_ms": round(1e3 * floor, 4),
                 "hot_ops": dict(Counter(o for _, o, _, _ in hot)
                                 .most_common()),
                 "top": Counter(o for _, o, _, _ in ins).most_common(10)})


def warps_per_sm(regs: int, shared: int = 0, threads: int = 128) -> int:
    """The warps an H100 SM holds of a kernel of ``regs`` registers a
    thread (allocated per warp in units of 256) and ``shared`` bytes of
    static shared memory a block (228 KB an SM, 1 KB reserved a block), in
    blocks of ``threads``."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = min(64, 65536 // per_warp)
    blocks = min(32, warps // (threads // 32))
    if shared:
        blocks = min(blocks, 233472 // (shared + 1024))
    return blocks * (threads // 32)


def _kernel_tag(name: str) -> str:
    """K2, K3 or K4 (with its fold: fixed and its codes, or generic), the
    step, A (StateProc) or D (RateProc) and the draw source of a StateProc
    or RateProc kernel's mangled name."""
    k = ("K4 snapshot" if "snapshot_kernel" in name else
         "K4" if "functional" in name else
         "K3" if "RowMoments" in name else "K2")
    if k == "K4":
        fold = re.search(r"FixedFoldIJ((?:Li\d+E)+)E", name)
        k += (" fixed {" + ",".join(re.findall(r"\d+", fold.group(1))) + "}"
              if fold else " generic")
    step = re.search(r"\d([A-Za-z]+Step[A-Za-z]*)ILi(\d+)E", name)
    rate = re.search(r"mc\d+([A-Za-z][A-Za-z0-9]*Step)ELi(\d+)E", name)
    src = ("sobol" if "SobolDraws" in name else
           "bridge" if "BridgeDraws" in name else
           "antithetic" if "ThreefryDrawsILb1E" in name else "plain")
    if step:
        return f"{k} {step.group(1)} A={step.group(2)} {src}"
    if rate:
        return f"{k} {rate.group(1)} D={rate.group(2)} {src}"
    return f"{k} {name[:60]}"


def res_usage(so: Path) -> dict:
    """{mangled name: {"REG": n, "STACK": n, "SHARED": n, "LOCAL": n,
    ...}} of every kernel in library ``so`` (cuobjdump -res-usage)."""
    from montecarlo_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-res-usage", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name is not None and "REG:" in line:
            out[name] = {k: int(v) for k, v in
                         re.findall(r"(\w+)(?:\[\d+\])?:(\d+)", line)}
            name = None
    return out


def resources(label: str, so: Path, pattern: str) -> None:
    """Registers, stack and local bytes of every kernel in library ``so``
    whose mangled name matches ``pattern``, with the warps an SM they
    leave: one line a kernel.  Stack or local bytes are a spill's (or a
    local array's)."""
    for name, use in res_usage(so).items():
        if re.search(pattern, name):
            log({"label": label, "resources": _kernel_tag(name),
                 "reg": use.get("REG"), "stack": use.get("STACK"),
                 "local": use.get("LOCAL"), "shared": use.get("SHARED"),
                 "warps_per_sm": warps_per_sm(use.get("REG", 255),
                                              use.get("SHARED", 0))})


# -------------------------------------------------------------- variants

def apply_edits(src_dir: Path, edits, name: str) -> None:
    """Make a variant's ``edits`` to the sources in ``src_dir``; each old
    text must be there once."""
    for fname, old, new in edits:
        src = (src_dir / fname).read_text()
        if src.count(old) != 1:
            raise RuntimeError(f"{fname}: the text of variant {name!r} is "
                               f"not there once")
        (src_dir / fname).write_text(src.replace(old, new))


def _includes(src: Path, seen=None) -> set:
    """The file names ``src`` includes with quotes, transitively."""
    seen = set() if seen is None else seen
    for name in re.findall(r'#include "([^"]+)"', src.read_text()):
        if name not in seen:
            seen.add(name)
            _includes(src.with_name(name), seen)
    return seen


def _compile(srcs, out: Path):
    """nvcc of each source into ``out``, all started together; the
    objects."""
    from montecarlo_tpu_torch.ops import _build

    objs, procs = [], []
    for src in srcs:
        obj = out / f"{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for p in procs:
        _build._finish(p.args, p)
    return objs


def build_variants(variants: dict) -> dict:
    """{name: shared object} for ``variants`` ({name: edits}): each built
    from copies of the sources with its edits made; the units no
    variant's edits reach are compiled once and linked into every one."""
    from montecarlo_tpu_torch.ops import _build

    root = _build.BUILD_DIR / "variants"
    if root.exists():
        shutil.rmtree(root)
    edited = {f for edits in variants.values() for f, _, _ in edits}
    units = sorted(_build.CSRC.glob("*.cu"))
    touched = [u for u in units if ({u.name} | _includes(u)) & edited]
    shared = root / "shared"
    shared.mkdir(parents=True)
    dirs = {}
    for name, edits in variants.items():
        out = root / name.replace(" ", "_")
        shutil.copytree(_build.CSRC, out)
        apply_edits(out, edits, name)
        dirs[name] = out
    jobs = [(shared, [u for u in units if u not in touched])]
    jobs += [(out, [out / u.name for u in touched]) for out in dirs.values()]
    with ThreadPoolExecutor(len(jobs)) as ex:
        objs = dict(zip([j[0] for j in jobs],
                        ex.map(lambda j: _compile(j[1], j[0]), jobs)))
    sos = {}
    for name, out in dirs.items():
        so = out / "libvariant.so"
        link = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                *map(str, objs[shared] + objs[out])]
        _build._finish(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        sos[name] = so
    return sos


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    lib.mc_error_string.argtypes = [ctypes.c_int]
    lib.mc_error_string.restype = ctypes.c_char_p
    return lib


def run_rows(torch, label: str, reps: int, rows) -> None:
    for row in rows:
        log({"label": label, "row": row.name, **row.measure(torch, reps)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("set", choices=sorted(ROW_SETS))
    ap.add_argument("--label", default=ROOT.name)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sass-only", action="store_true",
                    help="the SASS counts, no rows timed")
    ap.add_argument("--variants", nargs="?", const="all", default="",
                    help="comma-separated names (all if none)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times the rows are taken")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args()
    rs = ROW_SETS[args.set]
    names = (list(rs.variants) if args.variants == "all"
             else [v for v in args.variants.split(",") if v])
    import torch

    if not torch.cuda.is_available():
        print("rows: no CUDA card", file=sys.stderr)
        return 1
    from montecarlo_tpu_torch.ops import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_library()
    log({"label": args.label, "set": args.set, "card": card,
         "library_s": round(time.perf_counter() - t0, 1)})
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sos = build_variants({v: rs.variants[v] for v in names}) if names else {}
    if args.sass or args.sass_only:
        sass(args.label, out_dir, _build.library_path(), rs.sass,
             rs.floor_shape)
        for name, so in sos.items():
            sass(f"{args.label} {name}", out_dir, so, rs.sass, rs.floor_shape)
        if rs.resources:
            resources(args.label, _build.library_path(), rs.resources)
            for name, so in sos.items():
                resources(f"{args.label} {name}", so, rs.resources)
    if args.sass_only:
        return 0
    rows = rs.rows(torch)
    main_lib = _build.load_library
    for rnd in range(args.rounds):
        run_rows(torch, args.label if rnd == 0 else
                 f"{args.label} round {rnd + 1}", args.reps,
                 [r for r in rows if not r.only and (rnd == 0 or not r.own)])
        try:
            for name, so in sos.items():
                lib = load(so)
                _build.load_library = lambda lib=lib: lib
                # A variant that has rows of its own (a counting one) runs
                # only those.
                own_rows = [r for r in rows if r.only == name]
                run_rows(torch, f"{args.label} {name}", args.reps,
                         own_rows or [r for r in rows
                                      if not r.own and not r.only])
        finally:
            _build.load_library = main_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
