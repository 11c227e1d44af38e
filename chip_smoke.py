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
   (bitwise); the QE and VG functors' inverse normal (``ndtri32_unit``)
   against ``ndtri32`` on every float32 in [2^-24, 1 - 2^-24] (0
   mismatches) and against the plain ``ndtri32`` on all 2^23 uniforms;
3. K1, K2 and K3 (GBM; K2 and K3 also Heston; plain and antithetic) and
   K4 (every device functional, GBM and Heston, plain and antithetic)
   against their plain versions at 2^18 paths x {252, 17} steps;
4. each kernel against its plain version again, and both timed, at the
   shapes the main paths give it; K4 on the generic fold and on each fold
   fixed at compile time (the Asian's {avg}, the app's {avg, mx, mn}, the
   bridge barrier's {surv}, the notes) beside its SASS issue floor (the
   time loop's hot path from ``cuobjdump``, ``tools/rows.py``'s reader);
5. the main paths through the CLI entry, each with the launch counters
   reset just before and read just after:
   - the European path: ``price`` with fixed paths (K2, plain and
     antithetic), ``price --target-se 1e-3`` (K3) and ``bench`` (K1), each
     price held against Black-Scholes;
   - the path-dependent path (K4): ``price --payoff asian`` (GBM plain and
     antithetic, Heston), ``up-and-out --bridge`` and ``up-and-in
     --bridge`` at 2^20 paths x 252 steps, ``note --type autocall`` and
     ``--type cliquet``, each run raising K4's count (and, for the sets
     of FixedFolds, the fixed folds' count); the GBM Asian price
     lies between the geometric Asian closed form and Black-Scholes, the
     engine's geometric Asian within 5 std-err of its closed form, and
     knock-out plus knock-in adds up to the vanilla call of the same seed;
6. the rough-Bergomi path (K5, the factor product, K6), launch counters
   reset just before and read just after: ``price --process rbergomi`` at
   2^20 x 252 (twice: the same seed gives the same bits), at the
   default 100000 paths and at 99999 paths (K6's plain-load form), each
   run raising K5's count and its K6 form's; ``--eta 0
   --rho 0 --rate 0`` against Black-Scholes with sigma = sqrt(xi0); the
   sampler's martingale test at 2^20 x 252; a 65536 x 16 run on the card
   against ``--device cpu``;
7. the multi-asset path (K7, and K2-K4 on the correlated basket): K7 at
   A in {1, 2, 5, 16, 20, 33, 64, 127, 128} assets x T in {7, 8} on 2^16
   paths, at A in {5, 20, 33, 127} on a ragged 2^16 + 17 (and once with
   ids wrapping past 2^32), and at ``bench --basket``'s 2^18 x 512 x A =
   128 against the plain version on a 2^14-path slice, all bitwise; K7
   timed at each ``bench --basket`` asset count beside its bound, its
   FMA-free issue floor, its registers and shared memory per block, and a
   cuBLAS yardstick of the correlation alone;
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
   in 2^24-path chunks on GARCH and GBM (one K2 launch per chunk, and one
   for the pilot range; GBM's VaR at its closed form; the sketch at 2^22 within its grid errors of
   the exact statistics of the same terminals) and ``var --on-device``
   (the JAX CLI's keys); the VaR at 2^28 and ``garch_monte_carlo`` under
   the profiler (device busy share, kernels by device time);
9. randomized QMC (K2-K4 under Sobol and bridge-Sobol draws): K2, K3 and
   K4 under each draw source against their plain versions bitwise at 2^18
   and 2^18 - 37 paths x {252, 17, 9} steps on tables built for exactly
   the run's steps, ids crossing 2^30, and at 2^12 and 2^12 + 13 paths x
   17 steps with ids from 2^32 - 40 (a partial last warp, and the wrap
   inside a warp of the warp-shared Gray-code walk), K4 on a fixed fold
   ({avg}) and on the generic one; each timed with its bound (the
   bridge's without scratch: its normals stay in registers) and, for the
   bridge and K4 rows, its SASS issue floor at the
   QMC path's shapes (the Threefry K2 beside the Sobol one; K3's rows add
   the kernel's device time from the profiler as ``device_ms``, since at
   2^18 paths its wrapper's merges can leave the card idle between
   launches); then, launch counters reset just before and read just after
   each run: ``price --sampler sobol-device --target-se 1e-3`` (the RQMC
   wall-clock to std-err 1e-3; K3 under Sobol), ``--sampler sobol-bridge``
   (K2 under the bridge), ``--process heston --sampler sobol-device`` (K2
   under Sobol), the Asian under both samplers at 2^20 paths (K4 on its
   fixed fold),
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
   steps K2 antithetic and K4 plain, K2 on the QE pair where every warp
   is quadratic or most are exponential, and the K0 gamma-table
   inversion on 2^20 uniforms; each K2 timed (and held bitwise) at
   2^20 x 252 beside its plain version, bound and SASS issue floor, K3 on
   Merton at two 2^22 x 252 tolerance chunks and on HestonQE at one (with
   its floor), K4 {avg} on Kou and VG at 2^20 x 252 (VG's with its
   floor); then,
   launch counters reset just before and read just after each run: ``price
   --process <p> --paths 1048576 --steps 252`` for the eight (K2), gated
   within 4 std-err plus a stated slack by the CF price (kou, nig, vg,
   bates, bates-qe), merton_call_series (merton), Heston's CF (heston-qe)
   and the martingale E[F_T] = f0 (sabr, from ``--strike 0``); ``price
   --process merton --target-se 1e-3`` (K3), ``--process kou --payoff
   asian`` (K4) and ``--process merton --sampler sobol`` (the host table
   on the torch loop, no kernel);
11. local and stochastic-local volatility on K2-K4 (LocalVolProc and
   SlvProc, each reading its step's row through a pointer and an offset,
   the port of JAX's KernelRows; the surfaces on time knots, local vol and
   SLVKnots, read the rows the row builder blends once per (process,
   n_steps), SLVKnots on SlvProc): the row builder against ``blend_rows``
   bitwise at 2, 3 and 16 time knots, to 7 steps past the horizon; K2, K3
   and K4 ({avg, geo, mx, mn}) against their plain versions bitwise at
   2^18 paths (2^18 - 37 for K2 and K4) x 17 steps (9 too) with ids from
   2^30 - 1000, on the CLI's
   CEV surface, a time-dependent surface of 16 time knots, the CLI's
   calibrated SLV and its ``slv_to_kernel`` SLVKnots, plain, antithetic
   and under Sobol draws (local vol under the bridge too), the SLV of 17
   rows also at 23 steps (the clamp), at 252 steps K2 antithetic and K4
   plain; ``calibrate_slv`` at 2^17 particles x 252 steps timed by the host
   clock, twice at one seed (bitwise equal rows), once under the profiler,
   and at 2^14 x 64 against
   ``--device cpu`` within rtol 5e-4; K2 on each of the three (local vol
   also on the 16-knot surface and under Sobol and bridge draws) timed at
   2^20 x 252, each launch on a surface on knots with its row build,
   beside its plain version, bound (and the per-path blend's bound it had
   before the row builder) and SASS issue floor, the row builder alone,
   K3 on the SLV at two
   2^22 x 252 tolerance chunks, K4 {avg} on the SLV at 2^20 x 252; then,
   launch counters reset just before and read just after each run:
   ``price --process cev --paths 1048576 --steps 252`` (K2, within 5
   std-err + 0.05 of the CEV closed form), ``price --process slv`` at the
   same shape for K = 85, 100, 115 (K2, within 4 std-err + 0.0075 BS +
   0.03 of Black-Scholes at the demo surface's implied vol), the engine's
   ``terminal_prices`` on ``slv_to_kernel`` of that SLV (K2), ``--process
   slv --target-se 1e-3`` (K3), ``--payoff asian`` on SLV (K4, below its
   call), ``--sampler sobol-device`` on SLV and ``sobol-bridge`` on CEV
   (K2 under each), ``--process cev --target-se 1e-3`` (K3 chunks on one
   row build), each vanilla under its gate;
12. the sharded and streaming path (``parallel/``, ``engine/streaming.py``,
   the streaming ``var``) on a one-rank NCCL mesh whose collectives run on
   the card: launch counters reset just before and read just after,
   ``sharded_mc_estimate`` on the GBM 105-call, ``sharded_terminal_sketch``
   and ``sharded_functional_estimate`` {avg} at 2^22 x 252 (K2, K4),
   ``sharded_rbergomi_estimate`` at 2^20 x 252 (K5 and K6 on 4096-path
   blocks), a ``streaming_estimate`` of 2^22 x 252 in 2^20-path chunks
   stopped by its progress callback after chunk 2 and resumed from its
   .npz over the mesh, and ``var --paths 2^26 --days 20`` (64 K2 chunks
   and the pilot range's launch);
   then each result bitwise the unsharded computation (K2's terminals,
   ``block_moments``, ``moments_reduce``), a 4-rank mesh emulated rank by
   rank (the sharded functions run on each rank's mesh, their collectives'
   inputs combined in rank order) bitwise world size 1, K2 at path offsets
   2^31 - 4096 and 2^32 - 4096 bitwise its plain version, the resumed
   stream bitwise the one-shot run, the estimate within 5 std-err of
   Black-Scholes, the ``var`` keys and its var_95 at the closed form; and
   the world-size-1 sharded estimate timed against the unsharded one in
   turns (the sharded overhead) beside the streaming ``var``'s
   wall-clock.
13. the short-rate and term-structure processes on K2-K4 (RateProc over
   csrc/rate_steps.cuh, in csrc/fused_rates.cu: Euler GBM, term-structure
   GBM, Vasicek, CIR, Hull-White, G2++): K2, K3 (a digital) and K4 ({trap,
   avg}) on each against its plain version bitwise at 2^18 paths (2^18 -
   37 for K2 and K4) x 64 steps with ids from 2^30 - 1000, under Threefry
   plain and antithetic, Sobol and (one draw) bridge draws, G2++ under the
   bridge routed away from the kernels; K4 {trap} alone bitwise on each,
   the bond models' plain and antithetic launches counted as fixed-fold
   launches (FixedFold<kTrapezoid>), every other run on the generic fold;
   a run one step longer than the
   curves refused before any launch; K2 on each and K4 {trap} on each bond
   model timed at the bond path's 2^20 x 252, K3 on the Vasicek digital
   at 2^22 x 252, each beside its plain version, bound and SASS issue
   floor (K4's on its fixed fold, with its registers); then, launch
   counters reset just
   before and read just after each run: ``bond --paths 1048576 --steps 252`` for the four models (K4, on its fixed fold)
   against their closed forms (4 std-err plus the JAX tests' slack), ``bond
   --option`` (K4, fixed) against Jamshidian, ``bond --cap`` (the torch loop)
   against its closed form, ``bond --model g2pp --swaption`` (the host
   quadrature) against exact-transition Monte Carlo on the card, and the
   engine's ``terminal_prices`` on Vasicek (K2: the OU law), Euler GBM (K2:
   its exact mean) and a dividend-paying term-structure GBM (K2: the
   forward), ``payoff_block_moments`` of a Vasicek digital (K3: the normal
   law), each wall-clock by the host clock.
14. the multi-asset state processes on K2-K4 (StateProc over
   csrc/mgarch_steps.cuh, in csrc/fused_term_basket{,_k4}.cu, fused_ccc.cu
   and fused_dcc{,_k4}.cu: TermBasketGBM, CCC-GARCH, DCC-GARCH at 1..8
   assets): K2, K3 (a put) and K4 ({avg, mn}) on each against its plain
   version bitwise at A = 3 and 8, 2^18 paths (2^18 - 37 for K2 and K4) x
   17 steps with ids from 2^30 - 1000, under Threefry plain and antithetic
   and Sobol draws; the term basket's K4 {avg} at every A, plain and
   antithetic, bitwise and counted as fixed-fold launches
   (FixedFold<kArithMean>), CCC's and DCC's {mn} counted as generic ones;
   9 assets routed to the torch loop, the bridge and a run
   past the term basket's curves refused, before any launch; K2 on each
   timed at 2^20 x 252 (the term basket at 5 assets, the books at 8), and
   K2, K3 (a 95% put) and K4 ({mn}) on the books at a VaR chunk's 2^24 x
   10, the term basket's K3 at a tolerance chunk's 2^22 x 252 and K4
   {avg} at 2^20 x 252, each beside its plain version and bound (K2, K3
   and the term basket's K4 beside their SASS issue floors); then, launch
   counters reset just
   before and read just after each run: on the 5-asset term basket over
   252-step curves ``terminal_prices`` (K2, the forward),
   ``price_to_tolerance`` on its ATM call to std-err 1e-3 (K3) and its
   Asian by ``simulate_functionals`` (K4 on its fixed fold, below the
   call); on the 8-asset
   CCC and DCC books ``portfolio_var_on_device`` at 2^28 x 10 days (K2),
   the sketch at 2^20 within its grid errors of the exact statistics, the
   stream ``portfolio_var`` at 2^24 at the device sketch, K2 against a
   NumPy oracle of the recurrence fed the same normals, a put's
   ``payoff_block_moments`` (K3) and the running minimum (K4, generic).

15. greeks, variance reduction and the implied-vol surface (the snapshot
   kernel, csrc/fused_k4_snapshot.cu; K2): K4 on snapshot sets, the
   snapshot kernel, on GBM and Heston against its plain version and K4's
   bitwise at 2^18 - 37 paths x 17 and 252 steps, plain and antithetic
   (and at 17 steps under Sobol draws, GBM also the bridge), snapshots at
   steps 0, 1, the middle one twice, the last and one past it, each
   bitwise K2's terminal of a run stopped at its step, one launch a call
   and none of K4's; a six-maturity grid in one launch bitwise one
   torch-loop run; the snapshot launches of 2-, 4- and 6-maturity grids
   timed at 2^17 and 2^20 x 252 beside their plain version, bound, SASS
   issue floor and K2; then, counters
   reset just before and read just after each run: ``greeks`` at the JAX
   command's 200,000 paths and 126 steps (its 252 halved since PR 25, to
   keep the script inside its limit; pathwise on GBM and Heston, LR on a GBM
   digital through K2, second order on GBM at width 1.5 and on Heston,
   ``--mesh 1`` on a one-rank NCCL mesh), each with its wall-clock, peak
   memory and busy share, against Black-Scholes's delta (0.01), vega
   (3%), gamma (15%) and the digital's delta (4 std-err + 1e-4); the
   pathwise passes' split and peak with and without remat;
   ``mc_implied_vol_surface`` on GBM and Heston at 2^17 over 4 and 6
   maturities (one snapshot launch each), GBM flat at sigma within 0.01 where
   4 std-err of a cell's price move its iv by at most 0.01, Heston
   skewed; ``importance_sampled_estimate`` on
   a 150 call and ``cv_estimate`` at 2^20 x 252 on K2 within 4 std-err of
   Black-Scholes.  The surfaces' snapshot launches count in the snapshot
   kernel's entry of the kernels line, the LR, IS and CV runs' in K2's.
16. calibration, multilevel Monte Carlo and the gamma Newton sampler: the
   seven ``calibrate --model`` demos (heston, vg, nig, merton, kou,
   vasicek, sabr) on the card, one process each, all at once, each
   recovering its parameters to the JAX tests' tolerances, with its
   wall-clock and Adam steps/s; the
   calibrators' pricers (Heston's CF, the four Levy CFs, the Vasicek
   swaptions) on the card in float32 and float64 against the CPU's float64
   within stated bounds; the busy share of 50 Adam steps of the Heston
   and VG fits; then, launch counters reset just before and read just
   after each run: ``price --mlmc --mlmc-rmse 0.01`` on Euler GBM (within
   4 rmse of Black-Scholes; level 0 on K2, counted in the rate functors'
   K2 row) and Heston (within 4 rmse of its CF price; K2's Heston row),
   a coupled level's busy share, the Asian telescope's levels 0 (K4's
   {avg} on its fixed fold) and 2 on exact GBM; level 0 through K2 and
   K4 bitwise its torch loop at those runs' shapes; levels 0 and 2 over
   a one-rank NCCL mesh bitwise the unsharded levels; and
   ``gamma_from_uniforms32`` on 2^20 draws against the CPU.
17. American and Bermudan exercise (no kernel: the torch loop and eager
   regressions, as JAX's scan), each command with its wall-clock and the
   card's busy share from the profiler's device events: ``price
   --american --american-bound`` on the American put of
   tests/test_american.py at the CLI's 100,000 x 252 (the bracket holds
   the 1000-step binomial price: lower - 4 std-err - 0.05 <= binomial <=
   upper + 4 std-err), on Heston (upper >= lower - 4 std-err), ``--payoff
   asian --american`` against the European Asian (K4, counted), the
   published 2-asset max-call bracket (13.902), ``greeks --american``
   (delta within 0.02 of the binomial central difference), ``bond
   --swaption --n-exercise 1`` within 4 std-err of Jamshidian and ``4``
   dates above it; ``sharded_lsm_price`` (2^16 x 252) within 4 std-err
   of ``lsm_price`` and ``sharded_andersen_broadie_bound`` (4096 x 256 x
   252) on a one-rank NCCL mesh, the dual's per-path maxima over 2
   emulated ranks' ids bitwise the unsharded run's; ``lsm_policy`` in
   float64 on the card within rtol 1e-9 of the CPU's at 2^14 x 16.  The
   busy share is profiled for the put with its bound, the max-call and
   the 4-date swaption (the profiler takes ~25 us of its own a device
   operation to collect; PERF.md has the others' from a run of this
   phase alone).
18. the LIBOR market model, the equity-Vasicek hybrid, Heston exposure
   and the ``stress`` command (no kernel but stress's K2): the LMM at
   ``experiments/lmm_bench.py``'s (K, paths) = (16, 2^19), (32, 2^18) and
   (64, 2^17) over K steps in float32, each after one warm run timed by
   the host clock (live-forward updates/s, n K (K - 1) / 2 a run) and
   profiled (device operations a step, busy share), gated by the ZCB
   martingale E[1/B(T_K)] against ``lmm_zcb0`` and ``lmm_caplet_mc`` (2^17
   paths, float64, as the test) against Black (4 std-err plus
   tests/test_lmm.py's slack); then, launch
   counters reset just before and read just after each run: ``bond
   --model lmm`` (against the initial curve), ``--caplet`` (Black),
   ``--swaption`` (Rebonato) and ``--swaption --n-exercise 4`` (above the
   European less 4 std-err), ``calibrate --model lmm`` (beta and the vols
   recovered), ``price --process hybrid`` (its closed form), Heston
   exposure's accrued variance (the CIR expectation), each without a
   kernel launch, and ``stress --process gbm|heston`` at the command's
   65,536 x 64 with ``--grid 5``, 34 K2 launches each, every GBM scenario
   within 4 std-err of Black-Scholes at its bumped (s0, sigma); and the
   kernel-route grid at 2^14 x 16 bitwise the grid through the torch loop
   on GBM and Heston.

Phase 3 also holds K5 (2^18 paths x {504, 756, 37} columns, ids wrapping
past 2^32) and K6 (2^18 and 2^18 - 3 paths, its ring and its plain-load
form, x {252, 17} steps, fed one joint matrix) against their plain
versions bitwise; phase 4 times them at 2^20 x 504 and at 2^20 and 2^20 -
3 x 252 (K6 beside its SASS issue floor), checks the factor product
against a float64 product under a process-wide TF32 setting, and times
the whole sampler at
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
    and spills (nothing when the library was already built), then each
    source's compile seconds; raise if a kernel spills."""
    name = frame = None
    spills = []
    for line in ptxas.splitlines():
        if "Function properties for" in line:
            name = line.split("for", 1)[1].strip()
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and name:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            log(f"  {name}: {regs}; {frame}")
            if frame and not frame.endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spills.append(name)
            name = frame = None
        elif line.startswith("nvcc "):
            log(f"  {line}")
    if spills:
        raise AssertionError(f"kernels that spill: {spills}")


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


def cuda_ms(fn, reps: int, warm: bool = True):
    """Milliseconds per call of ``fn`` by CUDA events, after one warm-up
    call unless ``warm`` is False, and the last call's result."""
    import torch

    out = fn() if warm else None
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
                fields=(None,), floor=None):
    """Time ``kernel`` (``reps`` calls) and ``plain`` (one call) by CUDA
    events, log both beside ``bnd`` = (least ms, "bytes" or "operations")
    at this shape (and ``floor``, the kernel's SASS issue floor in ms,
    where given), and compare their outputs within ``rtol``.  The first
    row of kernel ``key`` is the one its kernels-line entry reports."""
    import torch

    ms, got = cuda_ms(kernel, reps)
    # The plain version is timed on its first call at this shape, with no
    # warm-up: the parity runs before have loaded its eager ops, and its
    # seconds of host-bound launches dwarf the allocations a first call
    # makes; a warm-up call doubled the script's ~150 s of plain versions
    # (PR 25).
    plain_ms, want = cuda_ms(plain, 1, warm=False)
    times.setdefault(key, {"ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bnd[0], "bound_by": bnd[1]})
    log(f"  {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bnd[0]:.4f} ms ({bnd[1]})"
        + ("" if floor is None else f", SASS issue floor {floor:.4f} ms"))
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
    # The functors' inverse normal (ndtri32_unit: the QE step's and VG's)
    # against ndtri32 on every float32 of its range, and against the plain
    # ndtri32 on every uniform_from_bits value.
    from montecarlo_tpu_torch.ops.rng_check import (
        UNIT_RANGE, ndtri_unit_check, ndtri_unit_check_reference)

    t0 = time.perf_counter()
    got = ndtri_unit_check(dev)
    want = ndtri_unit_check_reference(dev)
    torch.cuda.synchronize()
    n_range = UNIT_RANGE[1] - UNIT_RANGE[0] + 1
    same = bool(torch.equal(got["uniforms"], want))
    log(f"  ndtri32_unit: {n_range} float32 in [2^-24, 1 - 2^-24], "
        f"mismatches against ndtri32 {got['mismatches']} (first "
        f"{got['first_bits']}); 2^23 uniforms bitwise the plain ndtri32 "
        f"{same} ({time.perf_counter() - t0:.2f} s)")
    if got["mismatches"] != 0 or not same:
        raise AssertionError("K0 ndtri32_unit differs from ndtri32")


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
    count), K6's Box-Muller sine and cosine on all 2^23 angles, and K6 at
    n and n - 3 paths (its ring and its plain-load form, each seen to
    launch) x {252, 17} steps, fed the same joint matrix, against their
    plain versions, bitwise; path ids wrap past 2^32."""
    from montecarlo_tpu_torch.ops import (PATH_KERNELS, normal_matrix,
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
    from montecarlo_tpu_torch.ops.rbergomi_kernel import (
        boxmuller_angles, boxmuller_angles_reference)

    # K6's and SabrProc's Box-Muller takes sine and cosine from one
    # sincosf (rng.cuh's boxmuller_angle_sincos): every angle.
    same = bool(torch.equal(boxmuller_angles("cuda"),
                            boxmuller_angles_reference("cuda")))
    log(f"  Box-Muller sin and cos from one sincosf (K6, SabrProc), all "
        f"2^23 angles: bitwise {same}")
    if not same:
        raise AssertionError("rng.cuh's sincosf differs from sin and cos")
    for key, paths in (("rbergomi_terminal", n),
                       ("rbergomi_terminal_unaligned", n - 3)):
        for steps in (252, 17):
            model = rbergomi_model(steps)
            z = normal_matrix(21, 3, paths, 2 * steps, path_offset=WRAP,
                              device="cuda")
            args = (factor_product(model.chol, z), model.tpow(),
                    model.kernel_params(), 21, 3)
            kw = dict(n_steps=steps, path_offset=WRAP)
            before = PATH_KERNELS[key].launches
            got = rbergomi_terminal(*args, **kw)
            if PATH_KERNELS[key].launches != before + 1:
                raise AssertionError(f"K6 {paths}x{steps}: {key} did not "
                                     "launch")
            _, max_abs, _ = compare(
                f"K6 {paths}x{steps} offset 2^32-500 ({key})", got,
                rbergomi_terminal_reference(*args, **kw), BITWISE)
            errs[key] = max(errs.get(key, 0.0), max_abs)
            del z, args, got
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
    """K4 at the path-dependent path's shapes, each beside its SASS issue
    floor: GBM 2^20 x 252 with the generic fold ({avg, geo, mx, mn}, a set
    outside FixedFolds) and with the fixed folds of the Asian CLI's {avg}
    (plain and antithetic), the app's {avg, mx, mn} and the bridge's
    {surv}; Heston {avg}; the notes' 2^17 x 252 (the autocall and the
    cliquet leg).  Heston K2 and K3 at the European path's shapes."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                             RUNNING_MAX, RUNNING_MIN,
                                             VanillaPayoff, autocallable,
                                             barrier_survival_up,
                                             cliquet_sum)
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
    pairs = (steps + 1) // 2
    tf = "ThreefryDrawsILb0E"
    # (key, label, process, paths, functionals, bound, SASS patterns,
    # antithetic): the generic fold's row first, the entry of
    # fused_functionals; then the fixed folds'.
    cases = [
        ("fused_functionals", "K4 GBM {avg,geo,mx,mn} (generic fold)", gbm,
         n, {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX,
             "mn": RUNNING_MIN},
         step_bound(n, steps, step_fp=gbm_obs + 4, out_bytes=20,
                    extra_fp=EXP32_FP),
         k4_sass("GbmProc", tf, "SpecFold"), False),
        ("fused_functionals_fixed", "K4 GBM {avg}", gbm, n,
         {"avg": ARITH_MEAN},
         step_bound(n, steps, step_fp=gbm_obs + 1, out_bytes=8,
                    extra_fp=EXP32_FP),
         k4_sass("GbmProc", tf, (0,)), False),
        ("fused_functionals_fixed", "K4 GBM {avg} antithetic", gbm, n,
         {"avg": ARITH_MEAN},
         step_bound(n, steps, step_fp=gbm_obs + 1, out_bytes=8,
                    extra_fp=EXP32_FP),
         k4_sass("GbmProc", "ThreefryDrawsILb1E", (0,)), True),
        ("fused_functionals_fixed", "K4 GBM {avg,mx,mn}", gbm, n,
         {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN},
         step_bound(n, steps, step_fp=gbm_obs + 3, out_bytes=16,
                    extra_fp=EXP32_FP),
         k4_sass("GbmProc", tf, (0, 2, 3)), False),
        # The bridge survival: four float32 operations, an exp32, a product.
        ("fused_functionals_fixed", "K4 GBM {surv}", gbm, n,
         {"surv": barrier_survival_up(126.0, 0.2, dt)},
         step_bound(n, steps, step_fp=3 + 5 + EXP32_FP, out_bytes=8,
                    extra_fp=EXP32_FP),
         k4_sass("GbmProc", tf, (4,)), False),
        ("fused_functionals_fixed", "K4 Heston {avg}", hp, n,
         {"avg": ARITH_MEAN},
         step_bound(n, steps, draws=2,
                    step_fp=HESTON_STEP_FP + EXP32_FP + 1, out_bytes=8,
                    extra_fp=EXP32_FP),
         k4_sass("HestonProc", tf, (0,)), False),
        ("fused_functionals_fixed", "K4 GBM autocall", gbm, 1 << 17,
         {"note": autocallable(63, 100.0, 0.02, 0.03 * dt, 70.0, 100.0)},
         step_bound(1 << 17, steps, step_fp=gbm_obs + 2, out_bytes=8,
                    extra_fp=EXP32_FP),
         k4_sass("GbmProc", tf, (6,)), False),
        ("fused_functionals_fixed", "K4 GBM cliquet leg", gbm, 1 << 17,
         {"leg": cliquet_sum(63, -0.02, 0.03)},
         step_bound(1 << 17, steps, step_fp=gbm_obs + 1, out_bytes=8,
                    extra_fp=EXP32_FP),
         k4_sass("GbmProc", tf, (5,)), False),
    ]
    for key, label, proc, paths, fns, bnd, pats, anti in cases:
        check(key, f"{label} {paths}x{steps}",
              lambda: fused_functionals(proc, paths, steps, seed=0,
                                        functionals=fns, antithetic=anti),
              lambda: fused_functionals_reference(proc, paths, steps,
                                                  seed=0, functionals=fns,
                                                  antithetic=anti),
              10, BITWISE, bnd=bnd,
              floor=issue_floor(pats, paths, pairs))
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
    """K5 at the CLI's 2^20 x 504 and K6 at 2^20 x 252 (its ring form) and
    at 2^20 - 3 x 252 (its plain-load form), fed the CLI's joint matrix,
    each against its plain version and both timed, K6 beside its SASS
    issue floor."""
    from montecarlo_tpu_torch.ops import (normal_matrix,
                                          normal_matrix_reference,
                                          rbergomi_terminal,
                                          rbergomi_terminal_reference)
    from montecarlo_tpu_torch.precision import factor_product

    n, steps = 1 << 20, 252
    # K5: one cipher call per column pair, 4 bytes out per entry.
    check("normal_matrix", f"K5 {n}x{2 * steps}",
          lambda: normal_matrix(0, 0, n, 2 * steps, device="cuda"),
          lambda: normal_matrix_reference(0, 0, n, 2 * steps,
                                          device="cuda"),
          10, BITWISE,
          bnd=bound(4 * n * 2 * steps, int32=n * steps * CIPHER_INT,
                    fp32=n * steps * BOXMULLER_FP))
    model = rbergomi_model(steps)
    # K6's ring form at the CLI's N, its plain-load form at an N % 4 != 0.
    for key, paths in (("rbergomi_terminal", n),
                       ("rbergomi_terminal_unaligned", n - 3)):
        joint = factor_product(model.chol, normal_matrix(
            0, 0, paths, 2 * steps, device="cuda"))
        args = (joint, model.tpow(), model.kernel_params(), 0, 0)
        check(key, f"K6 {paths}x{steps}",
              lambda: rbergomi_terminal(*args, n_steps=steps),
              lambda: rbergomi_terminal_reference(*args, n_steps=steps),
              10, BITWISE, bnd=k6_bound(paths, steps),
              floor=k6_floor(paths, steps))
        del joint, args


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
              "K4 launched": counts["fused_functionals"] >= 1,
              "K4's fixed folds launched":
                  counts["fused_functionals_fixed"] >= 1}
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"path-dependent checks failed: {failed}")
    return counts


def run_rbergomi_cli(argv, k6="rbergomi_terminal"):
    """One CLI run of the rough-Bergomi path; it must launch K5 and K6's
    form ``k6``."""
    from montecarlo_tpu_torch.ops import launch_counts

    keys = ("normal_matrix", k6)
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
    # A path count that is not a multiple of 4: K6's plain-load form.
    ragged, _ = run_rbergomi_cli(["--paths", "99999"],
                                 "rbergomi_terminal_unaligned")
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
        "--paths 99999 within 5 std-err of the default's price":
            abs(ragged["price"] - default["price"])
            < 5 * math.hypot(ragged["std_err"], default["std_err"]),
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


# Warp instructions an H100 SXM issues per second: 4 schedulers per SM x
# 132 SMs x the 1.98 GHz boost clock (tools/rows.py's).
WARP_ISSUE_PER_S = 4 * 132 * 1.98e9


def _rows_tool():
    """tools/rows.py, the SASS reader."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tools" / "rows.py"
    spec = importlib.util.spec_from_file_location("rows_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _sass_bodies():
    """[(mangled name, SASS text)] of the built library's kernels."""
    from montecarlo_tpu_torch.ops import _build

    return _rows_tool().sass_bodies(_build.library_path())


def issue_floor(patterns, n, passes, loads=0):
    """The SASS issue floor (ms) of the kernel whose mangled name matches
    every regular expression of ``patterns``: per warp of the n paths,
    ``passes`` passes of its time loop's hot path (a step pair under
    Threefry draws, a step under the Sobol sources; a callable of the
    mangled name where the symbol says, as K6's ring names its stage
    depth) and ``loads`` of the hot path of the largest loop inside it
    (the bridge's T reloads, each a Sobol normal), at the card's warp
    issue rate.  The hot path is one pass when no slow path runs
    (tools/rows.py); a lower bound of the kernel's time where the bound's
    operation counts leave out instructions (Box-Muller, divisions,
    control)."""
    import re

    rows = _rows_tool()
    found = [(name, body) for name, body in _sass_bodies()
             if all(re.search(p, name) for p in patterns)]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} kernels match {patterns}")
    name, body = found[0]
    if callable(passes):
        passes = passes(name)
    ins = rows.parse_sass(body)
    hot = len(rows.hot_path(ins))
    nested = len(rows.hot_path(ins, rows.nested_loop(ins))) if loads else 0
    warps = -(-n // 32)
    return 1e3 * warps * (passes * hot + loads * nested) / WARP_ISSUE_PER_S


def k4_sass(proc, draws, fold):
    """The patterns of K4's kernel on functor ``proc`` under ``draws``
    with ``fold`` (``SpecFold`` or a FixedFold's codes)."""
    if not isinstance(fold, str):
        fold = "FixedFoldIJ" + "".join(f"Li{c}E" for c in fold) + "EE"
    return ("fused_functional_kernel", proc, draws, fold)


def step_bound(n, steps, draws=1, step_fp=3, out_bytes=4, extra_fp=0):
    """A fused time loop over n paths: ``draws`` cipher calls per step pair
    (and a Box-Muller pair each), ``step_fp`` float32 operations per step,
    ``extra_fp`` per path (prices, epilogue), ``out_bytes`` per path."""
    pairs = (steps + 1) // 2
    calls = n * pairs * draws
    return bound(n * out_bytes, int32=calls * CIPHER_INT,
                 fp32=calls * BOXMULLER_FP + n * (steps * step_fp + extra_fp))


def k6_bound(n, steps):
    """K6: reads the (2T, N) joint matrix and writes N prices; a cipher
    call a step pair, per step an exp32 and 11 more float32 operations."""
    pairs = (steps + 1) // 2
    return bound(4 * n * (2 * steps + 1), int32=n * pairs * CIPHER_INT,
                 fp32=n * (pairs * BOXMULLER_FP + steps * (11 + EXP32_FP)))


def k6_floor(n, steps):
    """K6's SASS issue floor at n x steps, for the form the wrapper takes
    there: the ring's time loop passes a stage of K steps, the plain-load
    form's a step pair."""
    from montecarlo_tpu_torch.ops.rbergomi_kernel import ring_aligned

    rows = _rows_tool()
    pats = (("rbergomi_ring_kernel",) if ring_aligned(n, 0)
            else ("rbergomi_terminal_kernel",))
    return issue_floor(pats, n, lambda name: rows.passes(name, steps))


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


def k7_ops(n, steps, a_n):
    """K7's counted operations (int32, float32): per pair A cipher calls,
    two correlations (2A^2), two updates (6A); then A exp32 and the
    weighted sum."""
    pairs = (steps + 1) // 2
    calls = n * pairs * a_n
    fp = (calls * BOXMULLER_FP + n * pairs * (2 * a_n * a_n + 6 * a_n)
          + n * (a_n * (EXP32_FP + 2)))
    return calls * CIPHER_INT, fp


def k7_bound(n, steps, a_n):
    """K7: its operations over their peak rates; 4 bytes out per path."""
    int32, fp = k7_ops(n, steps, a_n)
    return bound(4 * n, int32=int32, fp32=fp)


def k7_issue_floor(n, steps, a_n):
    """K7's FMA-free issue floor (ms): the same counted operations, each a
    warp instruction of its own (built with -fmad=false, so no multiply and
    add fuse) sharing the schedulers' issue slots, over 32 lanes."""
    int32, fp = k7_ops(n, steps, a_n)
    return 1e3 * (int32 + fp) / 32 / WARP_ISSUE_PER_S


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
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    def basket_cases(basket, label, n, steps, kw):
        """K2, K3 and K4 ({avg, mx, mn} and {avg}) on the basket, bitwise
        against their plain versions."""
        cases = [
            ("K2", "fused_terminal_basket",
             fused_terminal(basket, n, steps, **kw),
             fused_terminal_reference(basket, n, steps, **kw))]
        got = fused_block_moments(basket, pay, n, steps, **kw)
        want = fused_block_moments_reference(basket, pay, n, steps, **kw)
        cases += [(f"K3 call {f}", "fused_block_moments_basket",
                   getattr(got, f), getattr(want, f))
                  for f in ("mean", "m2")]
        want = fused_functionals_reference(basket, n, steps,
                                           functionals=fns, **kw)
        got = fused_functionals(basket, n, steps, functionals=fns, **kw)
        one = fused_functionals(basket, n, steps,
                                functionals={"avg": ARITH_MEAN}, **kw)
        cases += [(f"K4 {{avg,mx,mn}} {k}", "fused_functionals_basket",
                   got[k], want[k]) for k in want]
        cases += [(f"K4 {{avg}} {k}", "fused_functionals_basket", one[k],
                   want[k]) for k in one]
        for name, key, g, w in cases:
            _, max_abs, _ = compare(f"{name} basket {label}", g, w, BITWISE)
            errs[key] = max(errs.get(key, 0.0), max_abs)

    def k7_check(label, basket, n, steps, offset=0, full=None):
        kw = dict(seed=13, path_offset=offset)
        got = (packed_basket_terminal(basket, n, steps, **kw) if full is None
               else full[offset:offset + n])
        _, max_abs, _ = compare(label, got, packed_basket_terminal_reference(
            basket, n, steps, **kw), BITWISE)
        errs["packed_basket_terminal"] = max(
            errs.get("packed_basket_terminal", 0.0), max_abs)

    n = 1 << 16
    for a_n in (1, 2, 5, 16, 20, 33, 64, 127, 128):
        basket = bench_basket(a_n)
        for steps in (7, 8):
            k7_check(f"K7 A={a_n} {n}x{steps}", basket, n, steps)
    for a_n in (5, 20, 33, 127):  # a ragged last block in every tier
        k7_check(f"K7 A={a_n} {n + 17}x7", bench_basket(a_n), n + 17, 7)
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
    phase_k7_rows(torch)

    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX, "mn": RUNNING_MIN}
    pay = VanillaPayoff("call", 95.0)
    n, steps = 1 << 14, 17
    # Every BasketFixed<A> edge (1, 2, 3, 4, 5, 8, 9, 16) and
    # BasketProc<128> (17).
    for a_n in (1, 2, 3, 4, 5, 8, 9, 16, 17):
        basket = bench_basket(a_n)
        for anti in (False, True):
            label = f"A={a_n} {n}x{steps} {'antithetic' if anti else 'plain'}"
            kw = dict(seed=17, path_offset=WRAP, antithetic=anti)
            basket_cases(basket, label, n, steps, kw)
    # Sobol draws (dimension t A + d, streamed in d order) at two asset
    # counts, and the bridge-Sobol source on a basket of one asset.
    for a_n in (5, 16):
        smp = SobolDeviceSampler.create(steps, a_n, scramble_seed=3)
        basket_cases(bench_basket(a_n), f"A={a_n} {n}x{steps} sobol-device",
                     n, steps, dict(seed=17, path_offset=WRAP, sampler=smp))
    smp = SobolBridgeKernelSampler.create(steps, scramble_seed=2)
    basket_cases(bench_basket(1), f"A=1 {n}x{steps} sobol-bridge", n, steps,
                 dict(seed=17, path_offset=2**30 - 300, sampler=smp))
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
        check("fused_terminal_basket", f"K2 basket A={a_n} {nb}x{tb}",
              lambda: fused_terminal(basket, nb, tb, seed=1000),
              lambda: fused_terminal_reference(basket, nb, tb, seed=1000),
              3, BITWISE, bnd=basket_bound(nb, tb, a_n))
    basket = bench_basket(5)
    n3, s3 = TOL_CHUNK, TOL_STEPS
    tol_pay = VanillaPayoff("call", BASKET_STRIKE)
    for chunk in (0, 30):
        check("fused_block_moments_basket",
              f"K3 basket A=5 call {n3}x{s3} chunk {chunk}",
              lambda: fused_block_moments(basket, tol_pay, n3, s3,
                                          seed=0, path_offset=chunk * n3),
              lambda: fused_block_moments_reference(
                  basket, tol_pay, n3, s3, seed=0,
                  path_offset=chunk * n3),
              3, BITWISE, fields=("mean", "m2"),
              bnd=basket_bound(n3, s3, 5, out_bytes=8 / 128, extra_fp=8))
    n4 = ASIAN_PATHS
    check("fused_functionals_basket", f"K4 basket A=5 {{avg}} {n4}x{s3}",
          lambda: fused_functionals(basket, n4, s3, seed=0,
                                    functionals={"avg": ARITH_MEAN}),
          lambda: fused_functionals_reference(
              basket, n4, s3, seed=0, functionals={"avg": ARITH_MEAN}),
          3, BITWISE, bnd=basket_bound(n4, s3, 5, observe=True, out_bytes=8))
    # BasketProc<128> (17..128 assets; on no main path): K2 at A = 32,
    # its plain version held at A = 17 above.
    wide = bench_basket(32)
    ms, out = cuda_ms(lambda: fused_terminal(wide, nb, tb, seed=1000), 3)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("K2 basket A=32: non-finite values")
    bnd, by = basket_bound(nb, tb, 32)
    log(f"  K2 basket A=32 {nb}x{tb} (BasketProc<128>): kernel {ms:.3f} ms, "
        f"bound {bnd:.4f} ms ({by})")


def phase_k7_rows(torch):
    """K7 at each ``bench --basket`` asset count (2^18 x 512), by CUDA
    events, beside its bound, its FMA-free issue floor and its launch's
    registers and shared memory; and, as a yardstick only, the dense
    correlation alone by cuBLAS (``torch.matmul`` of (2^18 x A) by (A x A)
    in true float32, FMA allowed) times 512 steps: not the same function,
    not a port, on no path."""
    from montecarlo_tpu_torch.bench import (BASKET_PATHS, BASKET_STEPS,
                                            K7_ASSETS, bench_basket)
    from montecarlo_tpu_torch.ops import packed_basket_terminal
    from montecarlo_tpu_torch.ops.basket_kernel import k7_attributes

    n, t = BASKET_PATHS, BASKET_STEPS
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for a_n in K7_ASSETS:
            basket = bench_basket(a_n)
            ms, out = cuda_ms(lambda: packed_basket_terminal(
                basket, n, t, seed=1000), 3)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"K7 A={a_n}: non-finite values")
            bnd, by = k7_bound(n, t, a_n)
            floor = k7_issue_floor(n, t, a_n)
            attr = k7_attributes(a_n)
            z = torch.randn(n, a_n, device="cuda")
            chol_t = basket.chol_flat.reshape(a_n, a_n).t().contiguous()
            mm_ms, _ = cuda_ms(lambda: z @ chol_t, 5)
            del out, z
            log(f"  K7 A={a_n} {n}x{t}: {ms:.3f} ms; bound {bnd:.4f} ms "
                f"({by}, {100 * bnd / ms:.1f}%); FMA-free issue floor "
                f"{floor:.3f} ms ({100 * floor / ms:.1f}%); "
                f"{attr['registers']} registers, {attr['local_bytes']} B "
                f"local, {attr['shared_bytes']} B shared per block of "
                f"{attr['paths_per_block']} paths; yardstick torch.matmul "
                f"({n}x{a_n})x({a_n}x{a_n}) fp32 {mm_ms:.4f} ms x {t} steps "
                f"= {mm_ms * t:.3f} ms")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
    counts["fused_functionals_basket"] = k4_basket
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
        # One launch a chunk a pass, and one for the pilot range.
        k2 = counts["fused_terminal"]
        passes = (k2 - 1) // n_chunks
        out[name] = res
        share = (f"K2 ~{100 * k2 * chunk_ms * 1e-3 / wall:.1f}% of it"
                 if name.startswith("GARCH") else "")
        log(f"  portfolio_var_on_device {name}, {VAR_PATHS} x {GARCH_DAYS} "
            f"in {n_chunks} chunks: {wall:.3f} s wall-clock, "
            f"{VAR_PATHS / wall:.4e} paths/s, {k2} K2 launches ({passes} "
            f"pass(es)) {share}; {json.dumps(res)}")
        checks[f"{name}: K2 launched once per chunk and for the pilot"] = (
            k2 == passes * n_chunks + 1 and passes in (1, 2))
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
# once per block).
SOBOL_INT, NDTRI_FP = 16, 52
# The QE and VG functors' inverse normal, ndtri32_unit (csrc/rng.cuh), is
# one rational with its coefficients selected: a subtract, the |q| compare,
# the central r, 1 - u and the min, the tail's negated log, the shifted
# argument and its select, the numerator's 3 multiplies, 3 adds and 4
# selects, the denominator's 3, 3 and 3, the sign's compare and 2 selects
# and the product: 33 float32 operations (its log, sqrt and division not
# counted), where NDTRI_FP counts ndtri32's three rationals.
NDTRI_UNIT_FP = 33
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
    draws of them (or n * T for a bridge of T dims, plus its plan's L
    multiplies and L adds per step for ``bridge=(T, L)``), each
    dimension's XORs from this run's ids, ``step_fp`` per step and
    ``extra_fp`` per path.  Bytes: the output, and for the bridge its plan
    read once (T rows of L dims and weights and a level mask, and the T x
    30 direction numbers); it keeps its normals in registers and writes no
    scratch."""
    dims = bridge[0] if bridge else steps * draws
    normals = n * dims
    plan = 2 * bridge[1] * n * steps if bridge else 0
    tables = 4 * bridge[0] * (2 * bridge[1] + 1 + 30) if bridge else 0
    return bound(n * out_bytes + tables,
                 int32=(normals * SOBOL_INT + dims * CIPHER_INT
                        + dims * gray_xors(torch, n, path_offset)),
                 fp32=(normals * NDTRI_FP + plan
                       + n * (steps * step_fp + extra_fp)))


def phase_qmc_parity(torch, errs):
    """K2, K3 and K4 under SobolDraws (GBM; Heston at 17 steps) and
    BridgeDraws (GBM) against their plain versions, bitwise, at 2^18 paths
    (K2 and K4 at 2^18 - 37, not a multiple of 32) x {252, 17, 9} steps on
    tables built for exactly the run's steps, ids crossing 2^30 (where the
    Gray code stops being read); at 17 steps also on 2^12 paths (K2 and
    K4 at 2^12 + 13) with ids from 2^32 - 40, wrapping inside a warp."""
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

    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
    pay = VanillaPayoff("call", 105.0)
    # (steps, paths, path offset): ids crossing 2^30 at 2^18 paths (K2 and
    # K4 at 2^18 - 37, a partial last warp); at 17 steps also ids from 40
    # below 2^32 (the wrap inside a warp) on 2^12 paths (K2 and K4 at 2^12
    # + 13: a last block with one warp of 13 active lanes).
    runs = [(s, 1 << 18, (1 << 30) - 1000) for s in (252, 17, 9)]
    runs.append((17, 1 << 12, 2**32 - 40))
    for steps, n, off in runs:
        ragged = n - 37 if n > 1 << 12 else n + 13
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
            tag = (f"{type(proc).__name__} {source} {steps} steps, {n} "
                   f"paths from {off}")
            got = [("K2", "fused_terminal",
                    fused_terminal(proc, ragged, steps, **kw),
                    fused_terminal_reference(proc, ragged, steps, **kw))]
            m = fused_block_moments(proc, pay, n, steps, **kw)
            want_m = fused_block_moments_reference(proc, pay, n, steps, **kw)
            got += [(f"K3 {f}", "fused_block_moments", getattr(m, f),
                     getattr(want_m, f)) for f in ("mean", "m2")]
            fo = fused_functionals(proc, ragged, steps, functionals=fns,
                                   **kw)
            want_f = fused_functionals_reference(proc, ragged, steps,
                                                 functionals=fns, **kw)
            got += [(f"K4 {k}", "fused_functionals", fo[k], want_f[k])
                    for k in want_f]
            # {avg}: a fixed fold (FixedFolds), {avg, mx} the generic one.
            avg = {"avg": ARITH_MEAN}
            fo = fused_functionals(proc, ragged, steps, functionals=avg,
                                   **kw)
            want_f = fused_functionals_reference(proc, ragged, steps,
                                                 functionals=avg, **kw)
            got += [(f"K4 fixed {k}", "fused_functionals_fixed", fo[k],
                     want_f[k]) for k in want_f]
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
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                             VanillaPayoff)
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
    # The bridge's floor: a step's hot path per step, a reload's per dim.
    bridge_floor = functools.partial(issue_floor, passes=s,
                                     loads=bridge.n_steps)
    check("fused_terminal_bridge", f"K2 GBM bridge {n}x{s}",
          lambda: fused_terminal(gbm, n, s, seed=1, sampler=bridge),
          lambda: fused_terminal_reference(gbm, n, s, seed=1, sampler=bridge),
          10, BITWISE,
          bnd=sobol_bound(torch, n, s, extra_fp=EXP32_FP, bridge=t_l),
          floor=bridge_floor(("fused_kernel", "GbmProc", "BridgeDraws",
                              "StoreTerminal"), n))
    check("fused_block_moments_bridge", f"K3 GBM bridge call {n}x{s}",
          lambda: fused_block_moments(gbm, pay, n, s, seed=1, sampler=bridge),
          lambda: fused_block_moments_reference(gbm, pay, n, s, seed=1,
                                                sampler=bridge),
          10, BITWISE, fields=("mean", "m2"),
          bnd=sobol_bound(torch, n, s, out_bytes=8 / 128,
                          extra_fp=EXP32_FP + 8, bridge=t_l),
          floor=bridge_floor(("fused_kernel", "GbmProc", "BridgeDraws",
                              "RowMoments"), n))
    k3_device("fused_block_moments_bridge", f"K3 GBM bridge {n}x{s}",
              lambda: fused_block_moments(gbm, pay, n, s, seed=1,
                                          sampler=bridge))
    nf = QMC_FUNC
    obs = 3 + EXP32_FP + 1  # a GBM step, its observation's exp32, the fold
    # The Asian CLI's {avg} on its fixed fold, and {avg, geo} (outside
    # FixedFolds) on the generic fold, under both samplers.
    sets = (("fused_functionals_fixed", "{avg}", {"avg": ARITH_MEAN}, obs,
             8, (0,)),
            ("fused_functionals", "{avg,geo}",
             {"avg": ARITH_MEAN, "geo": GEO_MEAN}, obs + 1, 12, "SpecFold"))
    for source, smp, bridged, draws in (
            ("sobol", dev, None, "SobolDraws"),
            ("bridge", bridge, t_l, "BridgeDraws")):
        for key, tag, fns, fp, out_bytes, fold in sets:
            pats = k4_sass("GbmProc", draws, fold)
            check(f"{key}_{source}", f"K4 GBM {tag} {source} {nf}x{s}",
                  lambda: fused_functionals(gbm, nf, s, seed=1, sampler=smp,
                                            functionals=fns),
                  lambda: fused_functionals_reference(gbm, nf, s, seed=1,
                                                      sampler=smp,
                                                      functionals=fns),
                  10, BITWISE,
                  bnd=sobol_bound(torch, nf, s, step_fp=fp,
                                  out_bytes=out_bytes, extra_fp=EXP32_FP,
                                  bridge=bridged),
                  floor=(issue_floor(pats, nf, s, loads=s) if bridged
                         else issue_floor(pats, nf, s)))
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
    for smp, source in (("sobol-bridge", "bridge"), ("sobol-device", "sobol")):
        asians[smp], _ = cli(big + ["--sampler", smp, "--payoff", "asian"],
                             f"fused_functionals_{source}",
                             f"fused_functionals_fixed_{source}")
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
#: every bound below is loose where they matter; exp32 and
#: ndtri32_unit's rational, the QE and VG functors' inverse normal, are
#: float32 arithmetic and counted).
JUMP_KINDS = ("merton", "kou", "bates", "nig", "heston-qe", "bates-qe", "vg",
              "sabr")
UNIFORM_FP = 6  # two halves: a shift, a convert, an add and a multiply
QE_STEP_FP = 50 + NDTRI_UNIT_FP
JUMP_COST = {
    "merton": (2, 1, 12),                   # 4 Poisson selects + 8
    "kou": (1, 5, 4 + 4 * 5 + 4),           # Poisson, 4 jump sizes, 4
    "bates": (3, 1, HESTON_STEP_FP + 4 + 4),
    "nig": (2, 1, 16),
    "heston-qe": (1, 1, QE_STEP_FP + 7),
    "bates-qe": (2, 2, QE_STEP_FP + 7 + 4 + 4),
    "vg": (1, 2, NDTRI_UNIT_FP + 30 + 2 * EXP32_FP + 8 + 6),
    "sabr": (2, 0, 2 * EXP32_FP + 12),
}
#: QE parameter sets beside the CLI's (66% of warp-steps all quadratic,
#: the rest mixed): Feller's condition holds (every step quadratic), and
#: a vol of vol of 3 (at 17 steps the exponential branch below v ~ 1).
QE_MIXES = {"feller": ["--kappa", "2", "--theta", "0.04", "--xi", "0.3"],
            "exponential": ["--xi", "3"]}
#: The phase's shapes: K2 at the CLI's 2^20 x 252, K3 at
#: price_to_tolerance's 2^22 x 252 chunks, K4 {avg} at 2^20 x 252.
JUMP_PATHS, JUMP_STEPS, JUMP_TOL_CHUNK = 1 << 20, 252, 1 << 22
#: Each process's functor in csrc/processes.cuh.
FUNCTORS = {"merton": "MertonProc", "kou": "KouProc", "bates": "BatesProc",
            "nig": "NigProc", "heston-qe": "HestonQEProc",
            "bates-qe": "BatesQEProc", "vg": "VgProc", "sabr": "SabrProc",
            "local_vol": "LocalVolProc", "slv": "SlvProc",
            "slv_knots": "SlvProc"}


def k2_floor(kind, n, steps, draws="ThreefryDrawsILb0E"):
    """The SASS issue floor of K2 on ``kind``'s functor at n x steps under
    ``draws`` (plain Threefry by default: a pass of its time loop a step
    pair; a step under the Sobol sources, the bridge's T reloads beside)."""
    if draws.startswith("Threefry"):
        return issue_floor(("fused_kernel", FUNCTORS[kind], "StoreTerminal",
                            draws), n, (steps + 1) // 2)
    return issue_floor(("fused_kernel", FUNCTORS[kind], "StoreTerminal",
                        draws), n, steps,
                       loads=steps if draws == "BridgeDraws" else 0)


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
    operations per step), so 252-step runs are kept to these.  Then K2 on
    HestonQE and BatesQE at QE_MIXES' sets (17 steps, plain and
    antithetic), and the K0 gamma functions on 2^20 uniforms."""
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
    # The QE step where every warp takes the quadratic branch (Feller's
    # condition holds) and where most take the exponential one (vol of
    # vol 3): K2 at 17 steps, plain and antithetic.
    from montecarlo_tpu_torch.cli.pricing import cli_process

    for kind in ("heston-qe", "bates-qe"):
        for mix, flags in QE_MIXES.items():
            proc = cli_process(["--process", kind, "--steps", "17", *flags],
                               "cuda")[0]
            for label, draw in (("plain", {}),
                                ("antithetic", {"antithetic": True})):
                kw = dict(seed=17, path_offset=off, **draw)
                _, max_abs, _ = compare(
                    f"K2 {kind} {mix} 17 steps {label}",
                    fused_terminal(proc, n - 37, 17, **kw),
                    fused_terminal_reference(proc, n - 37, 17, **kw),
                    BITWISE)
                key = f"fused_terminal_{kind}"
                errs[key] = max(errs.get(key, 0.0), max_abs)
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
    """Each new K2 timed at the CLI's 2^20 x 252 beside its plain version,
    bound and SASS issue floor, K3 on Merton at price_to_tolerance's 2^22 x
    252 (chunks 0 and 7) and on HestonQE (chunk 0, with its floor), K4
    {avg} on Kou and VG at 2^20 x 252 (VG's with its floor); each checked
    bitwise.  Returns the K2 rates in path-steps/s."""
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
                    10, BITWISE, bnd=jump_bound(kind, n, s),
                    floor=k2_floor(kind, n, s))
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
    # K3 on the HestonQE call at a tolerance chunk, beside its SASS issue
    # floor.
    qe = jump_process("heston-qe", s)
    timed_check(times, errs, "fused_block_moments_heston-qe",
                f"K3 heston-qe call {nt}x{s}",
                lambda: fused_block_moments(qe, pay, nt, s, seed=0),
                lambda: fused_block_moments_reference(qe, pay, nt, s,
                                                      seed=0),
                5, BITWISE, fields=("mean", "m2"),
                bnd=jump_bound("heston-qe", nt, s, out_bytes=8 / 128,
                               extra_fp=8),
                floor=issue_floor(("fused_kernel", FUNCTORS["heston-qe"],
                                   "RowMoments", "ThreefryDrawsILb0E"),
                                  nt, (s + 1) // 2))
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
                                   observe_fp=EXP32_FP + 1),
                    floor=None if kind == "kou" else issue_floor(
                        k4_sass(FUNCTORS[kind], "ThreefryDrawsILb0E", (0,)),
                        n, (s + 1) // 2))
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
                                        "asian"], "fused_functionals",
                                "fused_functionals_fixed")
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
#: interpolation of the step's row (u, floor, two clamps, frac's clamps,
#: the two products and the sum) 12; the log-moneyness 1.  The surfaces
#: on time knots (local vol, SLVKnots) read rows the row builder blends
#: once per step and lane: a lane's time coordinate 5, its two hat weights
#: 9, its two knots 4 (SURFACE_ROW_FP).  Until the row builder the blend
#: ran per path and step, two lanes of it (SURFACE_BLEND_FP = 5 + 9 + 8);
#: ``surface_bound(..., per_path_blend=True)`` is that older bound, printed
#: beside the new one.
SURFACE_KNOTS_FP, SURFACE_BLEND_FP, SURFACE_ROW_FP = 12, 22, 18
SURFACE_COST = {
    "local_vol": (1, SURFACE_KNOTS_FP + 1 + 8),
    "slv": (2, HESTON_STEP_FP + SURFACE_KNOTS_FP + 1 + 4),
    "slv_knots": (2, HESTON_STEP_FP + SURFACE_KNOTS_FP + 1 + 4),
}
BLENDED = ("local_vol", "slv_knots")
#: The phase's shapes: K2 and K4 at the CLI's 2^20 x 252, K3 at
#: price_to_tolerance's 2^22 x 252 chunks, the calibration at the CLI's
#: 2^17 particles x 252 steps, its card-against-CPU check at 2^14 x 64.
SURFACE_PATHS, SURFACE_STEPS, SURFACE_TOL_CHUNK = 1 << 20, 252, 1 << 22
#: tests/test_torch_slv.py's calibration tolerance (the same rows computed
#: with other summation orders and other libm normals): every leverage
#: entry within rtol 5e-4, the mean relative difference below 1e-5.
CALIB_RTOL, CALIB_MEAN_RTOL = 5e-4, 1e-5


def surface_bound(kind, proc, n, steps, out_bytes=4, extra_fp=0,
                  observe_fp=0, per_path_blend=False):
    """The least time of ``kind``'s fused loop over n paths: its cipher
    calls per step pair, its step's float32 operations (plus
    ``observe_fp`` per step for K4), exp32 for the prices plus
    ``extra_fp`` per path; ``out_bytes`` per path out and the surface
    table read once.  A surface on time knots adds its row build, once:
    SURFACE_ROW_FP a lane of each step's row, the rows written and read
    once.  ``per_path_blend``: the bound before the row builder, the time
    blend in every path's step and no rows."""
    draws, step_fp = SURFACE_COST[kind]
    table = proc.lev_rows if kind == "slv" else (
        proc.lev_flat if kind == "slv_knots" else proc.vol_flat)
    pairs = (steps + 1) // 2
    calls = n * pairs * draws
    rows = steps * 128 if kind in BLENDED else 0
    row_fp = rows * SURFACE_ROW_FP
    if per_path_blend and kind in BLENDED:
        rows, row_fp = 0, 0
        step_fp += SURFACE_BLEND_FP
    return bound(n * out_bytes + 4 * (table.numel() + 2 * rows),
                 int32=calls * CIPHER_INT,
                 fp32=calls * BOXMULLER_FP + row_fp
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
    phase_surface_rows(torch, errs)
    for steps in (17, SURFACE_STEPS):
        procs = surface_procs(steps)
        for kind, proc in procs.items():
            if steps != 17 and kind == "tdep":
                continue
            t0 = time.perf_counter()
            runs = []
            for n_steps in ((17, 23) if steps == 17 and kind == "slv"
                            else (9, 17) if steps == 17
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


def phase_surface_rows(torch, errs):
    """The row builder against ``blend_rows`` (the plain version) on the
    card, bitwise: the CLI's CEV surface and the time-dependent one (16
    time knots each), a 3-knot surface and the SLVKnots table, every step
    to 7 past the horizon (where the knot coordinate clamps)."""
    import numpy as np

    from montecarlo_tpu_torch.ops import surface_rows
    from montecarlo_tpu_torch.processes import LocalVolGBM
    from montecarlo_tpu_torch.processes.local_vol import blend_rows

    procs = surface_procs(17)
    procs["3 knots"] = LocalVolGBM.create(
        100.0, 0.03, 1.0 / 17, 17,
        lambda t, x: 0.2 + 0.1 * np.tanh(np.log(x / 100.0)) + 0.05 * t,
        n_time_knots=3, device="cuda")
    for kind in ("cev", "3 knots", "tdep", "slv_knots"):
        proc = procs[kind]
        table = proc.lev_flat if kind == "slv_knots" else proc.vol_flat
        for steps in (17, SURFACE_STEPS):
            n_rows = steps + 7
            _, max_abs, _ = compare(
                f"row builder {kind} ({proc.n_time_knots} knots) "
                f"{n_rows}x128",
                surface_rows(table, n_rows, proc.dt, proc.dt_knot),
                blend_rows(table.reshape(-1, 128), list(range(n_rows)),
                           proc.dt, proc.dt_knot), BITWISE)
            errs["surface_rows"] = max(errs.get("surface_rows", 0.0),
                                       max_abs)


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
    """The row builder at 252 x 128 (the CLI's CEV surface and the
    time-dependent one, 16 time knots each), K2 on the CEV surface, the SLV and its SLVKnots at
    the CLI's 2^20 x 252 (local vol also on the 16-knot surface and under
    Sobol and bridge draws; each launch on a surface on knots with its row
    build: a new process object a call) beside the plain version, bound
    (and the per-path blend's) and SASS issue floor, K3 on the SLV at two
    2^22 x 252 tolerance chunks (0 and 7), K4 {avg} on the SLV at 2^20 x
    252; each bitwise."""
    import dataclasses

    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference,
                                          surface_rows)
    from montecarlo_tpu_torch.processes.local_vol import blend_rows
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n, s = SURFACE_PATHS, SURFACE_STEPS
    all_procs = surface_procs(s)
    for tag in ("cev", "tdep"):
        lv = all_procs[tag]
        rows = s * 128
        timed_check(times, errs, "surface_rows",
                    f"row builder {tag} ({lv.n_time_knots} knots) {s}x128",
                    lambda: surface_rows(lv.vol_flat, s, lv.dt, lv.dt_knot),
                    lambda: blend_rows(lv.vol_flat.reshape(-1, 128),
                                       list(range(s)), lv.dt, lv.dt_knot),
                    50, BITWISE,
                    bnd=bound(4 * (lv.vol_flat.numel() + rows),
                              fp32=rows * SURFACE_ROW_FP))
    procs = {"local_vol": all_procs["cev"], "slv": all_procs["slv"],
             "slv_knots": all_procs["slv_knots"]}
    for kind, proc in procs.items():
        label = f"K2 {kind} {n}x{s}"
        timed_check(times, errs, f"fused_terminal_{kind}", label,
                    lambda: fused_terminal(dataclasses.replace(proc), n, s,
                                           seed=0),
                    lambda: fused_terminal_reference(proc, n, s, seed=0),
                    10, BITWISE, bnd=surface_bound(kind, proc, n, s),
                    floor=k2_floor(kind, n, s))
        if kind in BLENDED:
            old = surface_bound(kind, proc, n, s, per_path_blend=True)
            log(f"  {label}: the per-path blend's bound {old[0]:.4f} ms "
                f"({old[1]})")
    tdep = all_procs["tdep"]
    timed_check(times, errs, "fused_terminal_local_vol",
                f"K2 local_vol 16 knots {n}x{s}",
                lambda: fused_terminal(dataclasses.replace(tdep), n, s,
                                       seed=0),
                lambda: fused_terminal_reference(tdep, n, s, seed=0),
                10, BITWISE, bnd=surface_bound("local_vol", tdep, n, s),
                floor=k2_floor("local_vol", n, s))
    cev = procs["local_vol"]
    step_fp = SURFACE_COST["local_vol"][1]
    for src, smp in (
            ("SobolDraws", SobolDeviceSampler.create(s, 1, device="cuda")),
            ("BridgeDraws", SobolBridgeKernelSampler.create(s,
                                                            device="cuda"))):
        br = (smp.n_steps, smp.width) if src == "BridgeDraws" else None
        key = ("fused_terminal_sobol" if src == "SobolDraws"
               else "fused_terminal_bridge")
        timed_check(times, errs, key, f"K2 local_vol {src} {n}x{s}",
                    lambda: fused_terminal(dataclasses.replace(cev), n, s,
                                           seed=1, sampler=smp),
                    lambda: fused_terminal_reference(cev, n, s, seed=1,
                                                     sampler=smp),
                    10, BITWISE,
                    bnd=sobol_bound(torch, n, s, step_fp=step_fp,
                                    extra_fp=EXP32_FP, bridge=br),
                    floor=k2_floor("local_vol", n, s, src))
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
                                 "fused_terminal", "surface_rows")
    launches["fused_terminal_local_vol"] = got["fused_terminal"]
    launches["surface_rows"] = got["surface_rows"]
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
    if set(k for k, v in got.items() if v) != {"fused_terminal",
                                               "surface_rows"}:
        raise AssertionError(f"slv_to_kernel run launched {got}")
    launches["fused_terminal_slv_knots"] = got["fused_terminal"]
    launches["surface_rows"] += got["surface_rows"]
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
        base + ["--process", "slv", "--payoff", "asian"], "fused_functionals",
        "fused_functionals_fixed")
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
    bridge, _, got = counted_cli(base + ["--process", "cev", "--sampler",
                                         "sobol-bridge"],
                                 "fused_terminal_bridge", "surface_rows")
    launches["surface_rows"] += got["surface_rows"]
    check_oracle("cev --sampler sobol-bridge vs the closed form (5 se + "
                 "0.05)", bridge, cev, bridge["std_err"] + 0.05)
    # A tolerance run's chunks share one row build.
    tol, wall, got = counted_cli(
        ["price", "--process", "cev", "--target-se", "1e-3", "--steps",
         str(s)], "fused_block_moments", "surface_rows")
    launches["surface_rows"] += got["surface_rows"]
    check_oracle("cev --target-se 1e-3 vs the closed form (5 se + 0.05)",
                 tol, cev, tol["std_err"] + 0.05)
    if got["surface_rows"] != 1 or not tol["std_err"] <= 1e-3:
        raise AssertionError(f"cev target-se run: {got}, std-err "
                             f"{tol['std_err']}")
    log(f"  cev wall-clock to std-err 1e-3: {wall:.3f} s "
        f"({tol['n_paths']} paths, {got['fused_block_moments']} K3 "
        f"launches on {got['surface_rows']} row build)")
    log(f"  launches on the local-vol/SLV path: {launches}")
    return launches

#: Each kernel's wrapper, CUDA source and the TPU kernel it replaces.
# --- phase 12: the sharded and streaming path --------------------------------

#: Phase 12's shapes: the sharded estimators at 2^22 x 252 (rough Bergomi
#: at 2^20 x 252), the emulated mesh's ranks, the stream's chunks and the
#: streaming ``var``'s paths.
SHARD_PATHS, SHARD_STEPS, RB_SHARD_PATHS = 1 << 22, 252, 1 << 20
EMULATED_RANKS = 4
STREAM_TOTAL, STREAM_CHUNK = 1 << 22, 1 << 20
STREAM_GRID = dict(lo=40.0, hi=260.0, bins=4096)
VAR_STREAM_PATHS = 1 << 26


def unsharded(values):
    """The unsharded estimate: ``block_moments`` over 4096-path blocks,
    then ``moments_reduce``'s fixed tree."""
    from montecarlo_tpu_torch.parallel import block_moments
    from montecarlo_tpu_torch.stats.welford import moments_reduce

    return moments_reduce(block_moments(values))


def gbm_var_closed_form(days, mu=0.05, sigma=0.25):
    """The lognormal var_95 (percent of spot) of GBM over ``days`` steps
    of the float32 dt the process holds."""
    import numpy as np

    t = days * float(np.float32(1 / 252))
    z05 = -1.6448536269514729
    return 100.0 - 100.0 * math.exp((mu - 0.5 * sigma**2) * t
                                    + sigma * math.sqrt(t) * z05)


def emulated_rank(device, rank):
    """Rank ``rank`` of an ``EMULATED_RANKS``-rank paths mesh, run in this
    process: its collectives hand back the rank's own tensor and keep it in
    ``sent``, in call order, for the caller to combine over the ranks."""
    from dataclasses import dataclass, field

    from montecarlo_tpu_torch.parallel import PATHS_AXIS, Mesh

    @dataclass(frozen=True, eq=False)
    class EmulatedRank(Mesh):
        sent: list = field(default_factory=list)

        def all_gather(self, x, axis):
            self._check(x)
            self.sent.append(x)
            return x

        def all_reduce(self, x, op, axes):
            self._check(x)
            self.sent.append(x)
            return x.clone()

    return EmulatedRank(shape={PATHS_AXIS: EMULATED_RANKS},
                        coords={PATHS_AXIS: rank}, device=device,
                        groups={PATHS_AXIS: None}, backend=None)


def phase_sharded_path(torch, mesh, tmp):
    """The main path of phase 12, launch counters reset just before and
    read just after: ``sharded_mc_estimate``, ``sharded_terminal_sketch``
    and ``sharded_functional_estimate`` {avg} on GBM at 2^22 x 252,
    ``sharded_rbergomi_estimate`` at 2^20 x 252, a ``streaming_estimate``
    stopped by its progress callback after chunk 2 and resumed from its
    .npz over the mesh, and ``var --paths 2^26 --days 20`` (the streaming
    route).  Returns (results, launch counts, the var's wall-clock)."""
    import os

    from montecarlo_tpu_torch.engine import ARITH_MEAN, VanillaPayoff
    from montecarlo_tpu_torch.engine.streaming import streaming_estimate
    from montecarlo_tpu_torch.ops import launch_counts, reset_launch_counts
    from montecarlo_tpu_torch.parallel import (sharded_functional_estimate,
                                               sharded_mc_estimate,
                                               sharded_rbergomi_estimate,
                                               sharded_terminal_sketch)
    from montecarlo_tpu_torch.processes import GBM

    gbm = GBM.create(100.0, 0.03, 0.2, 1 / 252, device="cuda")
    disc = math.exp(-0.03 * SHARD_STEPS / 252)
    n, t = SHARD_PATHS, SHARD_STEPS
    call = VanillaPayoff("call", 105.0)
    model = rbergomi_model(SHARD_STEPS)
    ckpt = os.path.join(tmp, "stream.npz")

    def stop_after_two(done, total, se):
        if done == 2 * STREAM_CHUNK:
            raise KeyboardInterrupt("stopped after chunk 2")

    reset_launch_counts()
    out = {"gbm": gbm, "model": model, "disc": disc}
    out["est"] = sharded_mc_estimate(gbm, call, n, t, seed=0, mesh=mesh,
                                     discount=disc)
    out["sketch"] = sharded_terminal_sketch(gbm, n, t, seed=0, mesh=mesh,
                                            lo=40.0, hi=260.0, bins=8192)
    out["asian"] = sharded_functional_estimate(
        gbm, {"avg": ARITH_MEAN},
        lambda o: torch.clamp(o["avg"] - 105.0, min=0.0), n, t, seed=0,
        mesh=mesh, discount=disc)
    out["rbergomi"] = sharded_rbergomi_estimate(
        model, lambda s: torch.clamp(s - 100.0, min=0.0), RB_SHARD_PATHS,
        seed=0, mesh=mesh)
    kw = dict(seed=2, chunk_paths=STREAM_CHUNK, checkpoint_path=ckpt,
              **STREAM_GRID)
    try:
        streaming_estimate(gbm, STREAM_TOTAL, t, progress_callback=stop_after_two,
                           **kw)
        raise AssertionError("the stream was not stopped after chunk 2")
    except KeyboardInterrupt:
        pass
    out["resumed"] = streaming_estimate(gbm, STREAM_TOTAL, t, mesh=mesh,
                                        **kw)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out["var"], var_wall = run_cli(
            ["var", "--paths", str(VAR_STREAM_PATHS), "--days", "20"])
    torch.cuda.synchronize()
    counts = launch_counts()
    lines = err.getvalue().splitlines()
    progress = [line for line in lines if "paths, std-err" in line]
    log(f"  var --paths {VAR_STREAM_PATHS} --days 20: {len(progress)} "
        f"progress lines on stderr, the last {progress[-1].strip()!r}; "
        f"{len(lines) - len(progress)} other lines")
    return out, counts, var_wall


def phase_sharded(torch):
    """Phase 12: a one-rank NCCL mesh on the card; its main path
    (``phase_sharded_path``), then each result held bitwise against the
    unsharded computation; a 4-rank mesh emulated rank by rank; K2 at
    path offsets past 2^31 against its plain version; the resumed stream
    against the one-shot run; the sharded overhead at world size 1.
    Returns phase 12's launch counts."""
    import tempfile

    import torch.distributed as dist

    from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                             black_scholes_call,
                                             simulate_functionals,
                                             terminal_prices)
    from montecarlo_tpu_torch.engine.streaming import streaming_estimate
    from montecarlo_tpu_torch.ops import (fused_terminal,
                                          fused_terminal_reference)
    from montecarlo_tpu_torch.parallel import (make_mesh,
                                               sharded_functional_estimate,
                                               sharded_mc_estimate,
                                               sharded_terminal_sketch)
    from montecarlo_tpu_torch.processes import rbergomi_simulate
    from montecarlo_tpu_torch.stats.quantiles import sketch_from_array
    from montecarlo_tpu_torch.stats.welford import (MomentState,
                                                    moments_reduce,
                                                    std_error)

    card = card_line()
    torch.cuda.set_device(0)
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            log(f"  mesh {mesh.shape} on {mesh.device}, backend "
                f"{mesh.backend}")
            checks["the mesh runs NCCL on the card"] = (
                mesh.backend == "nccl" and mesh.device.type == "cuda"
                and mesh.groups["paths"] is not None)
            t0 = time.perf_counter()
            res, counts, var_wall = phase_sharded_path(torch, mesh, tmp)
            log(f"  the main path took {time.perf_counter() - t0:.1f} s; "
                f"launches: {counts}")
            # K2: the two sharded calls, the stream's 4 chunks, the var's
            # chunks and its pilot range.
            want = {"fused_terminal": (2 + 4 + VAR_STREAM_PATHS // (1 << 20)
                                       + 1),
                    "fused_functionals": 1, "fused_functionals_fixed": 1,
                    "normal_matrix": RB_SHARD_PATHS // 4096,
                    "rbergomi_terminal": RB_SHARD_PATHS // 4096}
            for k, v in want.items():
                checks[f"{k} launched {v} times on the main path"] = (
                    counts[k] == v)

            gbm, disc = res["gbm"], res["disc"]
            n, t = SHARD_PATHS, SHARD_STEPS
            d = torch.tensor(disc, dtype=torch.float32, device="cuda")
            call = VanillaPayoff("call", 105.0)
            term = fused_terminal(gbm, n, t, seed=0)
            ref = unsharded(call(term))
            est = res["est"]
            checks["estimate bitwise unsharded"] = (
                torch.equal(est["price"], d * ref.mean)
                and torch.equal(est["std_err"], d * std_error(ref)))
            bs = float(black_scholes_call(100.0, 105.0, 0.03, 0.2,
                                          t * float(gbm.dt)))
            price, se = float(est["price"]), float(est["std_err"])
            log(f"  sharded_mc_estimate 2^22 x 252: price {price:.6f} +- "
                f"{se:.6f}, Black-Scholes {bs:.6f}")
            checks["estimate at Black-Scholes"] = abs(price - bs) < 5 * se

            sk, mo = res["sketch"]
            sk_ref = sketch_from_array(term, 40.0, 260.0, 8192)
            term_ref = unsharded(term)
            checks["sketch bitwise unsharded"] = (
                torch.equal(sk.counts, sk_ref.counts.to(torch.int64))
                and torch.equal(sk.vmin, sk_ref.vmin)
                and torch.equal(sk.vmax, sk_ref.vmax)
                and float(sk.underflow) == float(sk_ref.underflow)
                and float(sk.overflow) == float(sk_ref.overflow)
                and all(torch.equal(a, b) for a, b in zip(mo, term_ref)))

            asian = lambda o: torch.clamp(o["avg"] - 105.0, min=0.0)
            fn_ref = unsharded(asian(simulate_functionals(
                gbm, n, t, seed=0, functionals={"avg": ARITH_MEAN})))
            checks["functional estimate bitwise unsharded"] = torch.equal(
                res["asian"]["price"], d * fn_ref.mean)
            log(f"  sharded_functional_estimate {{avg}}: "
                f"{float(res['asian']['price']):.6f} (below the call: "
                f"{float(res['asian']['price']) < price})")
            checks["Asian below the call"] = (
                float(res["asian"]["price"]) < price)

            model = res["model"]
            rb_pay = lambda s: torch.clamp(s - 100.0, min=0.0)
            blocks = torch.cat([rb_pay(rbergomi_simulate(
                model, 4096, seed=0, path_offset=4096 * b))
                for b in range(RB_SHARD_PATHS // 4096)])
            rb_ref = unsharded(blocks)
            rb = res["rbergomi"]
            checks["rBergomi estimate bitwise unsharded"] = torch.equal(
                rb["price"], rb_ref.mean)
            flat = rb_pay(rbergomi_simulate(model, RB_SHARD_PATHS, seed=0))
            log(f"  sharded_rbergomi_estimate 2^20 x 252: "
                f"{float(rb['price']):.6f} +- {float(rb['std_err']):.6f}; "
                f"one 2^20-wide sampler call (another cuBLAS blocking): "
                f"{float(flat.double().mean()):.6f}")
            # The JAX package's own bound between its fixed-width blocks
            # and one wide call (tests/test_sharded_rbergomi.py).
            checks["rBergomi blocks within 1e-4 of one wide call"] = (
                abs(float(rb["price"]) - float(flat.double().mean()))
                <= 1e-4 * float(rb["price"]))

            # The 4-rank mesh: each rank's shard body, run by the sharded
            # function itself on that rank's mesh, its collectives' inputs
            # gathered here in rank order and merged.
            def over_ranks(fn):
                ranks = [emulated_rank(mesh.device, r)
                         for r in range(EMULATED_RANKS)]
                for rank in ranks:
                    fn(rank)
                return [[rank.sent[i] for rank in ranks]
                        for i in range(len(ranks[0].sent))]

            def merged(parts):
                return moments_reduce(MomentState(*torch.cat(parts).T))

            est4 = merged(*over_ranks(lambda m: sharded_mc_estimate(
                gbm, call, n, t, seed=0, mesh=m, discount=disc)))
            checks["4 emulated ranks bitwise world size 1 (estimate)"] = (
                torch.equal(d * est4.mean, est["price"])
                and torch.equal(d * std_error(est4), est["std_err"]))
            ints, exts, moms = over_ranks(lambda m: sharded_terminal_sketch(
                gbm, n, t, seed=0, mesh=m, lo=40.0, hi=260.0, bins=8192))
            ints = sum(ints)
            checks["4 emulated ranks bitwise world size 1 (sketch)"] = (
                torch.equal(ints[:8192], sk.counts)
                and float(ints[8192]) == float(sk.underflow)
                and float(ints[8193]) == float(sk.overflow)
                and torch.equal(torch.stack(exts).min(0).values,
                                torch.stack([sk.vmin, -sk.vmax]))
                and all(torch.equal(a, b)
                        for a, b in zip(merged(moms), mo)))
            fn4 = merged(*over_ranks(lambda m: sharded_functional_estimate(
                gbm, {"avg": ARITH_MEAN}, asian, n, t, seed=0, mesh=m,
                discount=disc)))
            checks["4 emulated ranks bitwise world size 1 (functional)"] = (
                torch.equal(d * fn4.mean, res["asian"]["price"]))

            for off in (2**31 - 4096, 2**32 - 4096):
                got = fused_terminal(gbm, 8192, t, seed=0, path_offset=off)
                plain = fused_terminal_reference(gbm, 8192, t, seed=0,
                                                 path_offset=off)
                same, _, _ = compare(f"K2 at path offset {off}", got, plain,
                                     BITWISE)
                checks[f"K2 at offset {off} bitwise plain"] = same == 1.0

            oneshot = streaming_estimate(gbm, STREAM_TOTAL, t, seed=2,
                                         chunk_paths=STREAM_TOTAL,
                                         **STREAM_GRID)
            resumed = res["resumed"]
            checks["resumed stream bitwise the one-shot run"] = (
                resumed.paths_done == STREAM_TOTAL
                and all((getattr(resumed, k) == getattr(oneshot, k)).all()
                        for k in ("block_mean", "block_m2", "block_count"))
                and (resumed.sketch.counts == oneshot.sketch.counts).all())

            v = res["var"]
            cf = gbm_var_closed_form(20)
            tol = v["var_95_grid_err"] + 4 * v["var_95_std_err"]
            log(f"  var --paths {VAR_STREAM_PATHS} --days 20 (streaming): "
                f"{var_wall:.3f} s wall-clock, {VAR_STREAM_PATHS / var_wall:.4e}"
                f" paths/s, var_95 {v['var_95']:.5f}% vs closed form "
                f"{cf:.5f}% (tolerance {tol:.5f}%), on {card}")
            checks["var keys are the JAX CLI's"] = set(v) == VAR_KEYS
            checks["var n_paths"] = v["n_paths"] == VAR_STREAM_PATHS
            checks["var_95 at the closed form"] = abs(v["var_95"] - cf) < tol

            # The sharded overhead at world size 1 (ROADMAP item 5's cell).
            def flat_run():
                r = unsharded(call(terminal_prices(gbm, n, t, seed=0)))
                return d * r.mean

            def sharded_run():
                return sharded_mc_estimate(gbm, call, n, t, seed=0,
                                           mesh=mesh, discount=disc)["price"]

            times = {}
            for name, fn in (("unsharded", flat_run), ("sharded", sharded_run),
                             ("sharded ", sharded_run),
                             ("unsharded ", flat_run)):
                ms, _ = cuda_ms(fn, 5)
                times.setdefault(name.strip(), []).append(ms)
            log(f"  estimate at 2^22 x 252, world size 1: sharded "
                f"{times['sharded']} ms, unsharded {times['unsharded']} ms "
                f"(CUDA events, 5 calls each, in turns), overhead "
                f"{min(times['sharded']) / min(times['unsharded']) - 1:+.2%},"
                f" on {card}")
        finally:
            dist.destroy_process_group()
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"  {name}: {'ok' if ok else 'FAIL'}")
    if failed:
        raise AssertionError(f"phase 12 checks failed: {failed}")
    return counts

# ---- phase 13: the short-rate and term-structure processes on K2-K4 ----------

#: The phase's processes (csrc/fused_rates.cu's RateProc over
#: csrc/rate_steps.cuh): the bond command's four models, and Euler GBM and
#: term-structure GBM, which only the engine calls.
RATE_KINDS = ("euler-gbm", "term-gbm", "vasicek", "cir", "hullwhite", "g2pp")
#: Per process: the Threefry calls per step pair (a Box-Muller pair each),
#: the float32 operations of one step as csrc/rate_steps.cuh counts them
#: (multiplies, adds, max and selects; the IEEE division and sqrtf not
#: counted) and those of its prices once a path (exp32 for term GBM, G2++'s
#: two adds).
RATE_COST = {"euler-gbm": (1, 3, 0), "term-gbm": (1, 8, EXP32_FP),
             "vasicek": (1, 5, 0), "cir": (1, 7, 0), "hullwhite": (1, 5, 0),
             "g2pp": (2, 9, 2)}
#: Each process's step in csrc/rate_steps.cuh (its kernels' symbols name
#: RateProc<mc::Step, D>).
RATE_STEP = {"euler-gbm": "EulerGbmStep", "term-gbm": "TermGbmStep",
             "vasicek": "VasicekStep", "cir": "CirStep",
             "hullwhite": "HullWhiteStep", "g2pp": "G2ppStep"}
RATE_MODELS = ("vasicek", "cir", "hullwhite", "g2pp")
#: K2 and K4 at the bond path's 2^20 x 252; K3 at a tolerance chunk's
#: 2^22 x 252; the bitwise parity at 2^18 x 64.
RATE_PATHS, RATE_STEPS, RATE_TOL_CHUNK = 1 << 20, 252, 1 << 22
RATE_PARITY_PATHS, RATE_PARITY_STEPS = 1 << 18, 64
#: Each bond model's slack beside 4 std-err against its closed form, its
#: JAX test's: the trapezoid bias under Vasicek's exact transition
#: (tests/test_rates.py:44), CIR's full-truncation Euler (:49), Hull-White
#: repricing its input curve (:75), G2++'s 1e-5 of the price
#: (tests/test_g2pp.py:52); the bond option's trapezoid bias (:63).
RATE_SLACK = {"vasicek": 5e-5, "cir": 3e-4, "hullwhite": 2e-4,
              "g2pp": 1e-5, "option": 5e-5}


def bond_args(argv):
    """The ``bond`` command's parsed arguments for ``argv`` (its flags)."""
    import argparse

    from montecarlo_tpu_torch.cli import bond

    parser = argparse.ArgumentParser()
    bond.add_parsers(parser.add_subparsers())
    return parser.parse_args(["bond", *argv])


def rate_procs(steps):
    """The processes of phase 13 on the card over ``steps`` steps: the
    bond command's four models as ``bond --model <m> --steps <steps>``
    builds them (Hull-White on a curve of ``steps`` entries), Euler GBM at
    the price command's GBM, and a term-structure GBM on seeded curves of
    ``steps`` entries."""
    import numpy as np

    from montecarlo_tpu_torch.cli import bond
    from montecarlo_tpu_torch.processes import EulerGBM, TermStructureGBM

    procs = {m: bond.build_model(bond_args(["--model", m, "--steps",
                                            str(steps)]), "cuda")[0]
             for m in RATE_MODELS}
    rng = np.random.default_rng(steps)
    procs["euler-gbm"] = EulerGBM.create(100.0, 0.03, 0.2, 1 / 252,
                                         device="cuda")
    procs["term-gbm"] = TermStructureGBM.from_curves(
        100.0, rng.uniform(0.0, 0.05, steps), rng.uniform(0.1, 0.3, steps),
        1 / 252, device="cuda")
    return procs


def rate_bound(kind, n, steps, out_bytes=4, extra_fp=0, observe_fp=0):
    """``step_bound`` with the process's draws, step and price counts
    (RATE_COST), plus ``observe_fp`` a step (K4's observation and
    fold)."""
    draws, step_fp, price_fp = RATE_COST[kind]
    return step_bound(n, steps, draws=draws, step_fp=step_fp + observe_fp,
                      out_bytes=out_bytes, extra_fp=price_fp + extra_fp)


def rate_floor(kind, n, steps, epilogue="StoreTerminal"):
    """The SASS issue floor of K2 (or K3 with ``epilogue="RowMoments"``)
    on ``kind``'s functor under plain Threefry draws: a pass of the time
    loop a step pair."""
    return issue_floor(("fused_kernel", RATE_STEP[kind], epilogue,
                        "ThreefryDrawsILb0E"), n, (steps + 1) // 2)


def rate_k4_sass(kind):
    """The patterns of K4 {trap} on ``kind``'s functor under plain
    Threefry draws, on its fixed fold (FixedFold<kTrapezoid>, the code 8).
    The generic fold has no floor: the SASS walker follows its switch over
    the codes down more than the one case a {trap} run takes."""
    return k4_sass(RATE_STEP[kind], "ThreefryDrawsILb0E", (8,))


def phase_rate_parity(torch, errs):
    """K2, K3 (a digital) and K4 ({trap, avg}, the generic fold, and
    {trap} alone) on the six functors against their plain versions,
    bitwise, at 2^18 paths (2^18 - 37 for K2 and K4) x 64 steps, ids from
    2^30 - 1000, under every draw source each takes: Threefry plain and
    antithetic, Sobol, and the bridge for the five of one draw (G2++ under
    the bridge goes to the torch loop, as in the JAX package, where the
    sampler refuses it); {trap} alone counted as a fixed-fold launch on the
    bond models under Threefry draws and as a generic one elsewhere; then
    the refusal of a run one step longer than the curves, before any
    launch."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                             kernel_route,
                                             trapezoid_integral)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference,
                                          launch_counts)
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n, steps = RATE_PARITY_PATHS, RATE_PARITY_STEPS
    off = (1 << 30) - 1000
    procs = rate_procs(steps)
    for kind in RATE_KINDS:
        t0 = time.perf_counter()
        proc = procs[kind]
        pay = VanillaPayoff("digital", 100.0 if "gbm" in kind else 0.04)
        fns = {"trap": trapezoid_integral(float(proc.dt)), "avg": ARITH_MEAN}
        runs = [("plain", {}), ("antithetic", {"antithetic": True}),
                ("sobol", {"sampler": SobolDeviceSampler.create(
                    steps, proc.n_draws, scramble_seed=13, device="cuda")})]
        bridge = SobolBridgeKernelSampler.create(steps, scramble_seed=13,
                                                 device="cuda")
        if proc.n_draws == 1:
            runs.append(("bridge", {"sampler": bridge}))
        elif kernel_route(proc, bridge, steps):
            raise AssertionError(f"{kind}: the bridge routed to the kernels")
        for label, draw in runs:
            kw = dict(seed=23, path_offset=off, **draw)
            tag = f"{kind} {steps} steps {label}"
            cases = [("K2", "fused_terminal_rates",
                      fused_terminal(proc, n - 37, steps, **kw),
                      fused_terminal_reference(proc, n - 37, steps, **kw))]
            got = fused_block_moments(proc, pay, n, steps, **kw)
            want = fused_block_moments_reference(proc, pay, n, steps, **kw)
            cases += [(f"K3 {f}", "fused_block_moments_rates",
                       getattr(got, f), getattr(want, f))
                      for f in ("mean", "m2")]
            got = fused_functionals(proc, n - 37, steps, functionals=fns,
                                    **kw)
            want = fused_functionals_reference(proc, n - 37, steps,
                                               functionals=fns, **kw)
            cases += [(f"K4 {k}", "fused_functionals_rates", got[k], want[k])
                      for k in want]
            # {trap} alone: the bond models' fixed fold under Threefry
            # draws, the generic fold elsewhere; the launch counted so.
            trap = {"trap": fns["trap"]}
            fixed = kind in RATE_MODELS and label in ("plain", "antithetic")
            sfx = {"sobol": "_sobol", "bridge": "_bridge"}.get(label, "")
            before = launch_counts()
            got = fused_functionals(proc, n - 37, steps, functionals=trap,
                                    **kw)
            ran = {k: v - before[k] for k, v in launch_counts().items()
                   if v != before[k]}
            expect = {f"fused_functionals{sfx}": 1}
            if fixed:
                expect["fused_functionals_fixed"] = 1
            if ran != expect:
                raise AssertionError(f"K4 {{trap}} {tag}: launched {ran}, "
                                     f"expected {expect}")
            want = fused_functionals_reference(proc, n - 37, steps,
                                               functionals=trap, **kw)
            fold = "fixed" if fixed else "generic"
            cases += [(f"K4 {{trap}} {fold} {k}", "fused_functionals_rates",
                       got[k], want[k]) for k in want]
            for name, key, g, w in cases:
                _, max_abs, _ = compare(f"{name} {tag}", g, w, BITWISE)
                errs[key] = max(errs.get(key, 0.0), max_abs)
            del cases, got, want
        torch.cuda.synchronize()
        log(f"  {kind} parity: {time.perf_counter() - t0:.1f} s")
    before = launch_counts()
    fns = {"avg": ARITH_MEAN}
    for kind in ("term-gbm", "hullwhite"):
        for run in (lambda: fused_terminal(procs[kind], n, steps + 1, seed=0),
                    lambda: fused_functionals(procs[kind], n, steps + 1,
                                              seed=0, functionals=fns)):
            try:
                run()
            except ValueError as e:
                log(f"  {kind} at {steps + 1} steps refused: {e}")
            else:
                raise AssertionError(f"{kind}: {steps + 1} steps ran on a "
                                     f"curve of {steps}")
    if launch_counts() != before:
        raise AssertionError("a refused run launched a kernel")


def phase_rate_shapes(torch, errs, times):
    """K2 on each functor and K4 {trap} on each bond model (its fixed
    fold, with its registers) at the bond path's 2^20 x 252, K3 on the
    Vasicek digital at a 2^22 x 252 chunk, each timed (CUDA events) beside
    its plain version, bound and SASS issue floor, and checked bitwise.
    The kernels-line entries report Vasicek's rows."""
    from montecarlo_tpu_torch.engine import VanillaPayoff, trapezoid_integral
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)

    n, s = RATE_PATHS, RATE_STEPS
    procs = rate_procs(s)
    rates = {}
    for kind in RATE_KINDS:
        proc = procs[kind]
        key = f"fused_terminal_rates {kind}"
        timed_check(times, errs, key, f"K2 {kind} {n}x{s}",
                    lambda: fused_terminal(proc, n, s, seed=0),
                    lambda: fused_terminal_reference(proc, n, s, seed=0),
                    10, BITWISE, bnd=rate_bound(kind, n, s),
                    floor=rate_floor(kind, n, s))
        rates[kind] = n * s / (times[key]["ms"] * 1e-3)
    for kind in RATE_MODELS:
        proc = procs[kind]
        fns = {"trap": trapezoid_integral(float(proc.dt))}
        timed_check(times, errs, f"fused_functionals_rates {kind}",
                    f"K4 {kind} {{trap}} {n}x{s} "
                    f"({kernel_regs(rate_k4_sass(kind))})",
                    lambda: fused_functionals(proc, n, s, seed=0,
                                              functionals=fns),
                    lambda: fused_functionals_reference(proc, n, s, seed=0,
                                                        functionals=fns),
                    10, BITWISE,
                    bnd=rate_bound(kind, n, s, out_bytes=8, observe_fp=3),
                    floor=issue_floor(rate_k4_sass(kind), n, (s + 1) // 2))
    # The kernels-line entries: Vasicek's rows, every row's error.
    for name, kinds in (("fused_terminal_rates", RATE_KINDS),
                        ("fused_functionals_rates", RATE_MODELS)):
        times[name] = times[f"{name} vasicek"]
        errs[name] = max([errs.get(name, 0.0)]
                         + [errs[f"{name} {k}"] for k in kinds])
    vas, nt = procs["vasicek"], RATE_TOL_CHUNK
    pay = VanillaPayoff("digital", 0.05)
    timed_check(times, errs, "fused_block_moments_rates",
                f"K3 vasicek digital {nt}x{s}",
                lambda: fused_block_moments(vas, pay, nt, s, seed=0),
                lambda: fused_block_moments_reference(vas, pay, nt, s,
                                                      seed=0),
                5, BITWISE, fields=("mean", "m2"),
                bnd=rate_bound("vasicek", nt, s, out_bytes=8 / 128,
                               extra_fp=8),
                floor=rate_floor("vasicek", nt, s, "RowMoments"))
    log("  K2 path-steps/s at 2^20 x 252: " + ", ".join(
        f"{k} {r:.4e}" for k, r in rates.items()))


def check_closed_form(label, price, se, cf, slack):
    """A Monte Carlo price within 4 std-err plus ``slack`` of its closed
    form."""
    ok = math.isfinite(price) and abs(price - cf) < 4 * se + slack
    log(f"  {label}: {price:.8f} +- {se:.3e} -> closed form {cf:.8f}, "
        f"|diff| {abs(price - cf):.3e}, 4 se + {slack:g} = "
        f"{4 * se + slack:.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"{label}: {price} vs closed form {cf}")


def g2pp_expiry_state(torch, argv):
    """The ``bond --model g2pp --swaption`` model on the card and, by its
    exact transition on the torch loop (16 steps to the expiry 0.25, 2^20
    paths), the factor state at expiry and the pathwise trapezoid
    discount: (state, discount, model), for the swaption by Monte Carlo
    with the coupon bond at expiry in closed form."""
    from montecarlo_tpu_torch.processes import G2PP
    from montecarlo_tpu_torch.rng.threefry import key_from_seed
    from montecarlo_tpu_torch.samplers import PlainSampler

    a = bond_args(argv)
    delta, n, steps = 0.25, RATE_PATHS, 16
    m = G2PP.create(a.r0, a.kappa, a.sigma, a.g2pp_b, a.g2pp_eta,
                    a.g2pp_rho, delta / steps, device="cuda")
    k0, k1 = key_from_seed(3)
    ids = torch.arange(n, dtype=torch.int64, device="cuda")
    state = m.init_state(ids)
    r_prev = m.prices(state).double()
    integral = torch.zeros(n, dtype=torch.float64, device="cuda")
    for t in range(steps):
        state = m.step(state, PlainSampler().draws(m, k0, k1, ids, t), t)
        r = m.prices(state).double()
        integral = integral + 0.5 * (r_prev + r) * (delta / steps)
        r_prev = r
    return state, torch.exp(-integral), m


def phase_rate_path(torch, card):
    """The slice's path through the CLI and the engine, each run counted
    by itself (``run_qmc``: exactly the named kernels launched): ``bond
    --paths 1048576 --steps 252`` for the four models (K4 on its fixed
    fold: each launch counted as a fixed-fold one too), each against its
    closed form; ``bond --option`` (K4, fixed) against Jamshidian; ``bond
    --cap`` (the torch loop, no kernel) against its closed form
    (tests/test_rates.py::test_cli_bond_cap's gate); ``bond --model g2pp
    --swaption`` (host quadrature, no kernel) against exact-transition
    Monte Carlo on the card; the engine's ``terminal_prices`` on Vasicek
    (K2: r_T's mean and variance against the exact OU law), on Euler GBM
    (K2: E[S_T] = s0 (1 + mu dt)^T) and on a dividend-paying
    term-structure GBM (K2: the forward), and ``payoff_block_moments`` of
    the digital r_T > theta (K3: against the normal law).  Returns each
    kernels-line entry's launches."""
    import numpy as np

    from montecarlo_tpu_torch.engine import (VanillaPayoff,
                                             payoff_block_moments,
                                             terminal_prices)
    from montecarlo_tpu_torch.processes import (EulerGBM, TermStructureGBM,
                                                g2pp_bond)
    from montecarlo_tpu_torch.stats.welford import moments_reduce, std_error

    totals, walls = {}, {}
    base = ["bond", "--paths", str(RATE_PATHS), "--steps", str(RATE_STEPS)]
    k4 = ("fused_functionals", "fused_functionals_fixed")
    for model in RATE_MODELS:
        out, walls[model] = run_qmc(
            totals, f"bond --model {model}", k4,
            lambda: run_cli(base + ["--model", model])[0])
        check_closed_form(f"bond --model {model} zcb", out["zcb_price"],
                          out["std_err"], out["closed_form"],
                          RATE_SLACK[model] * (out["closed_form"]
                                               if model == "g2pp" else 1.0))
    out, walls["option"] = run_qmc(
        totals, "bond --option", k4,
        lambda: run_cli(["bond", "--option"])[0])
    if totals["fused_functionals_fixed"] != totals["fused_functionals"]:
        raise AssertionError(f"bond: {totals['fused_functionals']} K4 "
                             f"launches, {totals['fused_functionals_fixed']}"
                             " of them on the fixed fold")
    check_closed_form("bond --option", out["bond_option_price"],
                      out["std_err"], out["jamshidian"],
                      RATE_SLACK["option"])
    out, walls["cap"] = run_qmc(totals, "bond --cap", (),
                                lambda: run_cli(["bond", "--cap"])[0])
    ok = abs(out["mc_price"] - out["closed_form"]) \
        < 5 * out["mc_std_err"] + 1e-6
    log(f"  bond --cap: {json.dumps(out)} ({'ok' if ok else 'FAIL'})")
    if not ok:
        raise AssertionError(f"bond --cap: {out}")
    argv = ["--model", "g2pp", "--swaption"]
    out, walls["swaption"] = run_qmc(totals, "bond --model g2pp --swaption",
                                     (), lambda: run_cli(["bond", *argv])[0])
    state, disc, m = g2pp_expiry_state(torch, argv)
    pays = [0.25 + (i + 1) * 0.25 for i in range(out["periods"] - 1)]
    cs = [out["strike"] * 0.25] * len(pays)
    cs[-1] += 1.0
    cb = sum(c * g2pp_bond(m, state.x.double(), state.y.double(), t - 0.25)
             for c, t in zip(cs, pays))
    v = disc * torch.clamp(1.0 - cb, min=0.0)
    check_closed_form("bond --model g2pp --swaption vs exact-transition MC",
                      float(v.mean()), float(v.std() / math.sqrt(v.numel())),
                      out["g2pp_european_swaption"], 1e-6)

    n, s = RATE_PATHS, RATE_STEPS
    procs = rate_procs(s)
    vas = procs["vasicek"]
    a = bond_args([])
    r_t, walls["terminal_prices vasicek"] = run_qmc(
        totals, "terminal_prices(vasicek)", ("fused_terminal",),
        lambda: terminal_prices(vas, n, s, seed=2))
    r_t = r_t.double()
    T = a.maturity
    mean_cf = a.theta + (a.r0 - a.theta) * math.exp(-a.kappa * T)
    var_cf = a.sigma**2 / (2 * a.kappa) * (1 - math.exp(-2 * a.kappa * T))
    se = float(r_t.std()) / math.sqrt(n)
    check_closed_form("Vasicek E[r_T] (K2)", float(r_t.mean()), se, mean_cf,
                      0.0)
    if abs(float(r_t.var()) - var_cf) >= 0.05 * var_cf:
        raise AssertionError(f"Vasicek Var[r_T] {float(r_t.var())} vs "
                             f"{var_cf}")
    p_cf = 0.5 * math.erfc((a.theta - mean_cf) / math.sqrt(2 * var_cf))
    st, walls["payoff_block_moments vasicek"] = run_qmc(
        totals, "payoff_block_moments(vasicek, digital r_T > theta)",
        ("fused_block_moments",),
        lambda: payoff_block_moments(vas, VanillaPayoff("digital", a.theta),
                                     n, s, seed=4))
    st = moments_reduce(st)
    check_closed_form("Vasicek P(r_T > theta) (K3)", float(st.mean),
                      float(std_error(st)), p_cf, 0.0)
    euler = EulerGBM.create(100.0, 0.05, 0.3, 1 / 252, device="cuda")
    s_t, walls["terminal_prices euler-gbm"] = run_qmc(
        totals, "terminal_prices(euler-gbm)", ("fused_terminal",),
        lambda: terminal_prices(euler, n, s, seed=5))
    s_t = s_t.double()
    mu32 = float(np.float32(0.05))
    check_closed_form("Euler GBM E[S_T] = s0 (1 + mu dt)^T (K2)",
                      float(s_t.mean()), float(s_t.std()) / math.sqrt(n),
                      100.0 * (1 + mu32 * float(np.float32(1 / 252))) ** s,
                      0.0)
    term = TermStructureGBM.with_dividend(100.0, 0.05, 0.02, 0.2, 1 / 252, s,
                                          device="cuda")
    f_t, walls["terminal_prices term-gbm"] = run_qmc(
        totals, "terminal_prices(term-gbm, q = 2%)", ("fused_terminal",),
        lambda: terminal_prices(term, n, s, seed=6))
    f_t = f_t.double()
    check_closed_form("term-structure GBM forward s0 e^{(r - q)T} (K2)",
                      float(f_t.mean()), float(f_t.std()) / math.sqrt(n),
                      100.0 * math.exp(0.03), 0.0)
    log("  bond path wall-clocks (host clock): " + ", ".join(
        f"{k} {w:.3f} s" for k, w in walls.items()) + f", on {card}")
    launches = {"fused_terminal_rates": totals.get("fused_terminal", 0),
                "fused_block_moments_rates": totals.get(
                    "fused_block_moments", 0),
                "fused_functionals_rates": totals.get("fused_functionals",
                                                      0)}
    log(f"  launches on the rates path: {launches}, of K4's "
        f"{totals['fused_functionals_fixed']} on the fixed fold")
    if min(launches.values()) < 1:
        raise AssertionError(f"kernels never launched on the rates path: "
                             f"{launches}")
    return launches


# ---- phase 14: the multi-asset state processes ------------------------------

STATE_KINDS = ("term-basket", "ccc-garch", "dcc-garch")
#: Each process's step in csrc/mgarch_steps.cuh (its kernels' symbols name
#: StateProc<mc::Step<A>, A>), its kernels-line suffix and its unit.
STATE_STEP = {"term-basket": "TermBasketStep", "ccc-garch": "CccStep",
              "dcc-garch": "DccStep"}
STATE_KEY = {"term-basket": "term_basket", "ccc-garch": "ccc",
             "dcc-garch": "dcc"}
STATE_UNIT = {"term-basket": "fused_term_basket.cu",
              "ccc-garch": "fused_ccc.cu", "dcc-garch": "fused_dcc.cu"}
#: K4's unit where it is not the process's own (the term basket's and
#: DCC's, built apart).
STATE_K4_UNIT = {"term-basket": "fused_term_basket_k4.cu",
                 "dcc-garch": "fused_dcc_k4.cu"}
#: The slice's books: the 5-asset term basket of the pricing path, the
#: 8-asset CCC and DCC books of the VaR path.
STATE_ASSETS = {"term-basket": 5, "ccc-garch": 8, "dcc-garch": 8}
#: The bitwise parity at 2^18 x 17; the VaR at 2^28 x 10 days in 2^24-path
#: chunks (the K2, K3 and K4 rows of the books at that chunk), the stream
#: at 2^24 in 2^22-path chunks; the term basket's K2 and K4 at 2^20 x 252,
#: its K3 at price_to_tolerance's 2^22 x 252 chunks.
STATE_PARITY_PATHS, STATE_PARITY_STEPS = 1 << 18, 17
STATE_VAR_PATHS, STATE_VAR_DAYS, STATE_VAR_CHUNK = 1 << 28, 10, 1 << 24
STATE_STREAM_PATHS, STATE_STREAM_CHUNK = 1 << 24, 1 << 22
#: The DCC book's (a, b), the JAX tests'.
DCC_AB = (0.05, 0.9)


def state_book(a_n):
    """(corr, s0, var0, weights) of an A-asset book from
    ``np.random.default_rng(a_n)``: half a sample correlation of 4A draws
    and half the identity, spots in [50, 150], daily variances in [1e-4,
    4e-4] (1.0-2.0% a day), equal weights."""
    import numpy as np

    rng = np.random.default_rng(a_n)
    c = np.atleast_2d(np.corrcoef(rng.normal(size=(a_n, 4 * a_n))))
    return (0.5 * c + 0.5 * np.eye(a_n), rng.uniform(50.0, 150.0, a_n),
            rng.uniform(1e-4, 4e-4, a_n), np.full(a_n, 1.0 / a_n))


def state_curves(a_n, steps):
    """The term basket's (mu, sigma) curves over ``steps`` days: a forward
    rate rising from 2% to 4% less a dividend yield in [0, 2%] per asset,
    and each asset's vol in [0.15, 0.35] falling to 0.8 of itself (a
    forward-vol strip)."""
    import numpy as np

    rng = np.random.default_rng(100 + a_n)
    x = np.arange(steps) / max(steps, 1)
    q = rng.uniform(0.0, 0.02, a_n)
    vol = rng.uniform(0.15, 0.35, a_n)
    return ((0.02 + 0.02 * x)[None, :] - q[:, None],
            vol[:, None] * (1.0 - 0.2 * x)[None, :])


def state_proc(kind, a_n, steps, device="cuda"):
    """``kind`` on the A-asset book on the card: the term basket on
    ``steps``-day curves at dt = 1/252; CCC and DCC at GARCH(1,1) (omega,
    alpha, beta) = (0.02 var0, 0.08, 0.9) per asset (long-run variance
    var0), DCC at DCC_AB."""
    from montecarlo_tpu_torch.processes import (CCCGarch, DCCGarch,
                                                TermBasketGBM)

    corr, s0, var0, w = state_book(a_n)
    if kind == "term-basket":
        mu, sig = state_curves(a_n, steps)
        return TermBasketGBM.create(s0, mu, sig, corr, w, 1 / 252,
                                    device=device)
    g = dict(omega=0.02 * var0, alpha=[0.08] * a_n, beta=[0.9] * a_n)
    if kind == "ccc-garch":
        return CCCGarch.create(s0, var0, corr=corr, weights=w, device=device,
                               **g)
    return DCCGarch.create(s0, var0, qbar=corr, weights=w, a_dcc=DCC_AB[0],
                           b_dcc=DCC_AB[1], device=device, **g)


def state_step_fp(kind, a_n):
    """The float32 operations of one step as csrc/mgarch_steps.cuh counts
    them (multiplies, adds, max; the IEEE divisions and sqrtf not
    counted): the correlated draws' A^2, the term basket's 8 an asset, CCC's
    7, and DCC's Cholesky (a multiply and a subtraction a term, a max a
    pivot), row scales (a max each), scaling (a multiply an entry) and
    recursion (4 an entry and a eta_i a row: c qbar_ij is the wrapper's,
    once a launch)."""
    fp = a_n * a_n + (8 if kind == "term-basket" else 7) * a_n
    if kind == "dcc-garch":
        pairs = a_n * (a_n + 1) // 2
        chol = sum(2 * j for i in range(a_n) for j in range(i + 1)) + a_n
        fp += chol + a_n + pairs + 4 * pairs + a_n
    return fp


def state_bound(kind, a_n, n, steps, out_bytes=4, extra_fp=0,
                observe=False):
    """``step_bound`` with A cipher calls a step pair, the step's
    operations (``state_step_fp``) and the portfolio value (A exp32 and A
    multiply-adds) once a path, and after every step too when ``observe``
    (K4's observation, plus its fold)."""
    value = a_n * (EXP32_FP + 2)
    step_fp = state_step_fp(kind, a_n) + (value + 1 if observe else 0)
    return step_bound(n, steps, draws=a_n, step_fp=step_fp,
                      out_bytes=out_bytes, extra_fp=value + extra_fp)


def state_floor(kind, a_n, n, steps, epilogue="StoreTerminal"):
    """The SASS issue floor of K2 (or K3 with ``epilogue="RowMoments"``)
    on ``kind``'s functor at A assets under plain Threefry draws: a pass of
    the time loop a step pair, or a step in CCC's and DCC's kernels at an
    even A (``tools/rows.py::stage_steps``).  K4's generic fold has no
    floor (``rate_k4_sass``); the term basket's fixed one does
    (``term_basket_k4_sass``)."""
    return issue_floor(state_sass(kind, a_n, epilogue), n,
                       lambda name: _rows_tool().passes(name, steps))


def state_sass(kind, a_n, epilogue="StoreTerminal"):
    """The patterns of K2 (K3) on ``kind``'s functor at A assets under
    plain Threefry draws: CCC's and DCC's by-value kernel (state_kernel,
    csrc/fused_mgarch.cuh), the term basket's fused_kernel."""
    kernel = "fused_kernel" if kind == "term-basket" else "state_kernel"
    return (kernel, f"{STATE_STEP[kind]}ILi{a_n}E", epilogue,
            "ThreefryDrawsILb0E")


@functools.lru_cache(maxsize=1)
def _res_usage():
    """{mangled name: resources} of the built library's kernels."""
    from montecarlo_tpu_torch.ops import _build

    return _rows_tool().res_usage(_build.library_path())


def term_basket_k4_sass(a_n):
    """The patterns of K4 {avg} on the term basket at A assets under plain
    Threefry draws, on its fixed fold (FixedFold<kArithMean>)."""
    return k4_sass(f"TermBasketStepILi{a_n}E", "ThreefryDrawsILb0E", (0,))


def kernel_regs(patterns):
    """'R registers, W warps an SM' of the one kernel whose mangled name
    matches every regular expression of ``patterns``."""
    import re

    found = [u for name, u in _res_usage().items()
             if all(re.search(p, name) for p in patterns)]
    if len(found) != 1:
        raise AssertionError(f"{len(found)} kernels match {patterns}")
    regs = found[0]["REG"]
    warps = _rows_tool().warps_per_sm(regs, found[0].get("SHARED", 0))
    return f"{regs} registers, {warps} warps an SM"


def state_regs(kind, a_n, epilogue="StoreTerminal"):
    """``kernel_regs`` of the kernel ``state_sass`` names."""
    return kernel_regs(state_sass(kind, a_n, epilogue))


def phase_state_parity(torch, errs):
    """K2, K3 (a put at the start value) and K4 ({avg, mn}) on the three
    functors against their plain versions, bitwise, at A = 3 and 8, 2^18
    paths (2^18 - 37 for K2 and K4) x 17 steps, ids from 2^30 - 1000,
    under Threefry plain and antithetic and Sobol draws; the term basket's
    K4 {avg} at every A, plain and antithetic, each launch counted as a
    fixed-fold one, and CCC's and DCC's {mn} at 8 assets, counted as
    generic ones; then, before any launch, the refusals: 9 assets (routed
    to the torch loop), the bridge at 1 and 8 assets, a term basket run one
    step past its curves."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MIN,
                                             VanillaPayoff, kernel_route,
                                             simulate, terminal_prices)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference,
                                          launch_counts)
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    n, steps = STATE_PARITY_PATHS, STATE_PARITY_STEPS
    off = (1 << 30) - 1000
    fns = {"avg": ARITH_MEAN, "mn": RUNNING_MIN}
    for kind in STATE_KINDS:
        key = STATE_KEY[kind]
        for a_n in (3, 8):
            t0 = time.perf_counter()
            proc = state_proc(kind, a_n, steps)
            pay = VanillaPayoff("put", float(torch.dot(proc.weights,
                                                       proc.s0)))
            runs = [("plain", {}), ("antithetic", {"antithetic": True}),
                    ("sobol", {"sampler": SobolDeviceSampler.create(
                        steps, a_n, scramble_seed=13, device="cuda")})]
            for label, draw in runs:
                kw = dict(seed=23, path_offset=off, **draw)
                tag = f"{kind} A={a_n} {steps} steps {label}"
                cases = [("K2", f"fused_terminal_{key}",
                          fused_terminal(proc, n - 37, steps, **kw),
                          fused_terminal_reference(proc, n - 37, steps,
                                                   **kw))]
                got = fused_block_moments(proc, pay, n, steps, **kw)
                want = fused_block_moments_reference(proc, pay, n, steps,
                                                     **kw)
                cases += [(f"K3 {f}", f"fused_block_moments_{key}",
                           getattr(got, f), getattr(want, f))
                          for f in ("mean", "m2")]
                got = fused_functionals(proc, n - 37, steps, functionals=fns,
                                        **kw)
                want = fused_functionals_reference(proc, n - 37, steps,
                                                   functionals=fns, **kw)
                cases += [(f"K4 {k}", f"fused_functionals_{key}", got[k],
                           want[k]) for k in want]
                for name, ekey, g, w in cases:
                    _, max_abs, _ = compare(f"{name} {tag}", g, w, BITWISE)
                    errs[ekey] = max(errs.get(ekey, 0.0), max_abs)
                del cases, got, want
            torch.cuda.synchronize()
            log(f"  {kind} A={a_n} parity: {time.perf_counter() - t0:.1f} s")
    # K4's folds: the term basket's {avg} on its fixed fold at every A,
    # plain and antithetic; CCC's and DCC's {mn} on the generic fold.
    t0 = time.perf_counter()
    folds = [("term-basket", a_n, {"avg": ARITH_MEAN}, anti, True)
             for a_n in range(1, 9) for anti in (False, True)]
    folds += [(kind, 8, {"mn": RUNNING_MIN}, False, False)
              for kind in ("ccc-garch", "dcc-garch")]
    for kind, a_n, one, anti, fixed in folds:
        proc = state_proc(kind, a_n, steps)
        kw = dict(seed=29, path_offset=off, antithetic=anti)
        tag = (f"K4 {set(one)} {'fixed' if fixed else 'generic'} {kind} "
               f"A={a_n} {steps} steps {'antithetic' if anti else 'plain'}")
        before = launch_counts()
        got = fused_functionals(proc, n - 37, steps, functionals=one, **kw)
        ran = {k: v - before[k] for k, v in launch_counts().items()
               if v != before[k]}
        expect = {"fused_functionals": 1}
        if fixed:
            expect["fused_functionals_fixed"] = 1
        if ran != expect:
            raise AssertionError(f"{tag}: launched {ran}, expected {expect}")
        want = fused_functionals_reference(proc, n - 37, steps,
                                           functionals=one, **kw)
        for k in want:
            _, max_abs, _ = compare(f"{tag} {k}", got[k], want[k], BITWISE)
            key = f"fused_functionals_{STATE_KEY[kind]}"
            errs[key] = max(errs.get(key, 0.0), max_abs)
        del got, want
    torch.cuda.synchronize()
    log(f"  K4 folds parity: {time.perf_counter() - t0:.1f} s")
    before = launch_counts()
    bridge = SobolBridgeKernelSampler.create(10, scramble_seed=13,
                                             device="cuda")
    for kind in STATE_KINDS:
        nine = state_proc(kind, 9, 10)
        if kernel_route(nine, None, 10):
            raise AssertionError(f"{kind}: 9 assets routed to the kernels")
        if not torch.equal(terminal_prices(nine, 4096, 10, seed=1),
                           simulate(nine, 4096, 10, seed=1)):
            raise AssertionError(f"{kind}: 9 assets off the torch loop")
        refused = [(f"{kind} A=9", lambda: fused_terminal(nine, 4096, 10,
                                                          seed=1))]
        for a_n in (1, 8):
            proc = state_proc(kind, a_n, 10)
            if kernel_route(proc, bridge, 10):
                raise AssertionError(f"{kind}: the bridge routed to the "
                                     "kernels")
            refused.append((f"{kind} A={a_n} under the bridge",
                            lambda p=proc: fused_terminal(p, 4096, 10, seed=1,
                                                          sampler=bridge)))
        if kind == "term-basket":
            refused.append(("term basket 11 steps on 10-day curves",
                            lambda: fused_functionals(
                                state_proc(kind, 3, 10), 4096, 11, seed=1,
                                functionals=fns)))
        for label, run in refused:
            try:
                run()
            except ValueError as e:
                log(f"  {label} refused: {e}")
            else:
                raise AssertionError(f"{label}: ran on the kernels")
    if launch_counts() != before:
        raise AssertionError("a refused or rerouted run launched a kernel")


def phase_state_shapes(torch, errs, times):
    """Each functor's K2 at 2^20 x 252 (the term basket at 5 assets, CCC
    and DCC at 8) beside its plain version, bound and SASS issue floor;
    CCC's and DCC's K2, K3 (a 95% put) and K4 ({mn}) at a VaR chunk's 2^24
    x 10, the term basket's K3 (its call) at a tolerance chunk's 2^22 x
    252 (with floors) and K4 ({avg}, its fixed fold, with its floor and
    registers) at the Asian's 2^20 x 252; each timed by CUDA events and
    checked bitwise.  The kernels-line entries report
    the rows at the path's shapes: the term basket's 2^20 x 252 K2, CCC's
    and DCC's VaR chunk."""
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MIN,
                                             VanillaPayoff)
    from montecarlo_tpu_torch.ops import (fused_block_moments,
                                          fused_block_moments_reference,
                                          fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal,
                                          fused_terminal_reference)

    n, s = 1 << 20, 252
    rates = {}
    for kind in STATE_KINDS:
        a_n, key = STATE_ASSETS[kind], STATE_KEY[kind]
        proc = state_proc(kind, a_n, s)
        row = f"fused_terminal_{key} {n}x{s}"
        timed_check(times, errs, row, f"K2 {kind} A={a_n} {n}x{s} "
                    f"({state_regs(kind, a_n)})",
                    lambda: fused_terminal(proc, n, s, seed=0),
                    lambda: fused_terminal_reference(proc, n, s, seed=0),
                    10, BITWISE, bnd=state_bound(kind, a_n, n, s),
                    floor=state_floor(kind, a_n, n, s))
        rates[kind] = n * s / (times[row]["ms"] * 1e-3)
        errs[f"fused_terminal_{key}"] = max(errs.get(f"fused_terminal_{key}",
                                                     0.0), errs[row])
        if kind == "term-basket":
            times[f"fused_terminal_{key}"] = times[row]
            nt, v0 = TOL_CHUNK, float(torch.dot(proc.weights, proc.s0))
            call = VanillaPayoff("call", v0)
            timed_check(times, errs, f"fused_block_moments_{key}",
                        f"K3 term basket call {nt}x{s}",
                        lambda: fused_block_moments(proc, call, nt, s,
                                                    seed=0),
                        lambda: fused_block_moments_reference(
                            proc, call, nt, s, seed=0),
                        5, BITWISE, fields=("mean", "m2"),
                        bnd=state_bound(kind, a_n, nt, s, out_bytes=8 / 128,
                                        extra_fp=8),
                        floor=state_floor(kind, a_n, nt, s, "RowMoments"))
            fns = {"avg": ARITH_MEAN}
            k4 = term_basket_k4_sass(a_n)
            timed_check(times, errs, f"fused_functionals_{key}",
                        f"K4 term basket {{avg}} {n}x{s} "
                        f"({kernel_regs(k4)})",
                        lambda: fused_functionals(proc, n, s, seed=0,
                                                  functionals=fns),
                        lambda: fused_functionals_reference(
                            proc, n, s, seed=0, functionals=fns),
                        10, BITWISE,
                        bnd=state_bound(kind, a_n, n, s, out_bytes=8,
                                        observe=True),
                        floor=issue_floor(k4, n, (s + 1) // 2))
            continue
        nv, d = STATE_VAR_CHUNK, STATE_VAR_DAYS
        proc = state_proc(kind, a_n, d)
        v0 = float(torch.dot(proc.weights, proc.s0))
        timed_check(times, errs, f"fused_terminal_{key}",
                    f"K2 {kind} A={a_n} VaR chunk {nv}x{d} "
                    f"({state_regs(kind, a_n)})",
                    lambda: fused_terminal(proc, nv, d, seed=0),
                    lambda: fused_terminal_reference(proc, nv, d, seed=0),
                    10, BITWISE, bnd=state_bound(kind, a_n, nv, d),
                    floor=state_floor(kind, a_n, nv, d))
        put = VanillaPayoff("put", 0.95 * v0)
        timed_check(times, errs, f"fused_block_moments_{key}",
                    f"K3 {kind} 95% put {nv}x{d} "
                    f"({state_regs(kind, a_n, 'RowMoments')})",
                    lambda: fused_block_moments(proc, put, nv, d, seed=0),
                    lambda: fused_block_moments_reference(proc, put, nv, d,
                                                          seed=0),
                    5, BITWISE, fields=("mean", "m2"),
                    bnd=state_bound(kind, a_n, nv, d, out_bytes=8 / 128,
                                    extra_fp=8),
                    floor=state_floor(kind, a_n, nv, d, "RowMoments"))
        fns = {"mn": RUNNING_MIN}
        timed_check(times, errs, f"fused_functionals_{key}",
                    f"K4 {kind} {{mn}} {nv}x{d}",
                    lambda: fused_functionals(proc, nv, d, seed=0,
                                              functionals=fns),
                    lambda: fused_functionals_reference(proc, nv, d, seed=0,
                                                        functionals=fns),
                    5, BITWISE,
                    bnd=state_bound(kind, a_n, nv, d, out_bytes=8,
                                    observe=True))
    log("  K2 path-steps/s at 2^20 x 252: " + ", ".join(
        f"{k} {r:.4e}" for k, r in rates.items()))


def garch_book_oracle(proc, kind, n, days, seed):
    """The book's terminal values by an independent float64 NumPy port of
    its recurrence (tests/test_dcc_garch.py's oracle: DCC's R normalized
    from Q and factorized by np.linalg.cholesky per path; CCC's correlation
    factorized once), fed the process's own normals for paths 0 .. n-1."""
    import numpy as np
    import torch

    from montecarlo_tpu_torch.rng.threefry import key_from_seed

    a_n = proc.n_assets
    k0, k1 = key_from_seed(seed, 0)
    ids = torch.arange(n, dtype=torch.int64, device=proc.device)
    f64 = lambda t: t.double().cpu().numpy()
    s0, var0, w = f64(proc.s0), f64(proc.var0), f64(proc.weights)
    om, al, be = f64(proc.omega), f64(proc.alpha), f64(proc.beta)
    log_s = np.log(s0)[None, :] * np.ones((n, a_n))
    var = var0[None, :] * np.ones((n, a_n))
    if kind == "dcc-garch":
        qbar = f64(proc.qbar_flat).reshape(a_n, a_n)
        a_d, b_d = float(proc.a_dcc), float(proc.b_dcc)
        q = np.broadcast_to(qbar, (n, a_n, a_n)).copy()
    else:
        chol = f64(proc.chol_flat).reshape(a_n, a_n)
    for t in range(days):
        eps = np.stack([f64(e) for e in proc.draws(k0, k1, ids, t)], axis=1)
        if kind == "dcc-garch":
            d = 1.0 / np.sqrt(np.einsum("kii->ki", q))
            r = q * d[:, :, None] * d[:, None, :]
            eta = np.einsum("kij,kj->ki", np.linalg.cholesky(r), eps)
        else:
            eta = eps @ chol.T
        ret = np.sqrt(var) * eta
        log_s = log_s + ret
        var = om + al * ret**2 + be * var
        if kind == "dcc-garch":
            q = ((1 - a_d - b_d) * qbar + a_d * eta[:, :, None]
                 * eta[:, None, :] + b_d * q)
    return (w[None, :] * np.exp(log_s)).sum(axis=1)


def term_basket_forward(proc, steps):
    """E[V_T] = sum_a w_a s0_a exp(sum_t mu_a(t) dt), from the process's
    float32 leaves in float64."""
    import numpy as np

    f64 = lambda t: t.double().cpu().numpy()
    mu = f64(proc.mu_t)[:, :steps]
    return float((f64(proc.weights) * f64(proc.s0)
                  * np.exp(mu.sum(axis=1) * float(proc.dt))).sum())


def phase_state_path(torch, card):
    """The slice's path through the engine API, each run counted by itself
    (``run_qmc``: exactly the named kernels launched): on the 5-asset term
    basket over 252-step curves, ``terminal_prices`` at 2^20 x 252 (K2,
    the forward within 4 std-err), ``price_to_tolerance`` on its ATM call
    to std-err 1e-3 in 2^22 x 252 chunks (K3) and its arithmetic Asian by
    ``simulate_functionals`` at 2^20 x 252 (K4 on its fixed fold, below
    the call); on the
    8-asset CCC and DCC books, ``portfolio_var_on_device`` at 2^28 x 10 in
    2^24-path chunks (K2 once a chunk a pass and once for the pilot), the
    stream ``portfolio_var`` at 2^24 in 2^22-path chunks against the
    device sketch of the same paths, ``payoff_block_moments`` of a 95% put
    (K3, at the mean of the put over K2's terminals of the same paths)
    and the 10-day running minimum by ``simulate_functionals`` (K4, at
    most the terminal and the start, to exp32's rounding); beside them,
    runs made only to check (``checked``, not in the launch counts): the
    sketch at 2^20 within its grid errors of the exact statistics of the
    same K2 terminals, the device sketch at 2^24, K2 at 4096 paths
    against a NumPy oracle of the recurrence fed the same normals (rtol
    5e-4, tests/test_dcc_garch.py's) and K2's terminals under the put.
    Returns each kernels-line entry's launches: the entry calls' alone."""
    import numpy as np

    from montecarlo_tpu_torch.api import (portfolio_var,
                                          portfolio_var_on_device)
    from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MIN,
                                             VanillaPayoff, asian_call,
                                             mc_estimate,
                                             payoff_block_moments,
                                             price_to_tolerance,
                                             simulate_functionals,
                                             terminal_prices)
    from montecarlo_tpu_torch.ops import fused_terminal
    from montecarlo_tpu_torch.stats.risk import terminal_statistics
    from montecarlo_tpu_torch.stats.welford import moments_reduce, std_error

    walls, launches, checks, checked = {}, {}, {}, {}
    totals = {k: {} for k in STATE_KINDS}
    s = TOL_STEPS
    tb = state_proc("term-basket", STATE_ASSETS["term-basket"], s)
    tot = totals["term-basket"]
    v0 = float(torch.dot(tb.weights, tb.s0))
    v_t, walls["terminal_prices term basket"] = run_qmc(
        tot, "terminal_prices(term basket, 2^20 x 252)", ("fused_terminal",),
        lambda: terminal_prices(tb, ASIAN_PATHS, s, seed=6))
    v_t = v_t.double()
    check_closed_form("term basket forward E[V_T] (K2)", float(v_t.mean()),
                      float(v_t.std()) / math.sqrt(ASIAN_PATHS),
                      term_basket_forward(tb, s), 0.0)
    disc = math.exp(-0.03)
    est, walls["price_to_tolerance term basket"] = run_qmc(
        tot, "price_to_tolerance(term basket ATM call, 1e-3)",
        ("fused_block_moments",),
        lambda: price_to_tolerance(tb, VanillaPayoff("call", v0),
                                   target_std_err=1e-3, seed=0,
                                   chunk_paths=TOL_CHUNK, n_steps=s,
                                   discount=disc))
    price, se = float(est["price"]), float(est["std_err"])
    out, walls["asian term basket"] = run_qmc(
        tot, "simulate_functionals(term basket Asian, 2^20 x 252)",
        ("fused_functionals", "fused_functionals_fixed"),
        lambda: simulate_functionals(tb, ASIAN_PATHS, s, seed=0,
                                     functionals={"avg": ARITH_MEAN}))
    asian = mc_estimate(asian_call(out["avg"], v0), disc)
    a_price, a_se = float(asian["price"]), float(asian["std_err"])
    del out
    log(f"  term basket ATM call {price:.6f} +- {se:.2e} "
        f"({int(est['n_paths'])} paths, {est['n_chunks']} chunks); Asian "
        f"{a_price:.6f} +- {a_se:.2e}")
    checks["term basket tolerance run reached 1e-3"] = (
        math.isfinite(price) and se <= 1e-3)
    checks["term basket Asian below its call"] = (
        math.isfinite(a_price) and a_price < price + 4 * (se + a_se))

    days, n1 = STATE_VAR_DAYS, 1 << 20
    n_chunks = STATE_VAR_PATHS // STATE_VAR_CHUNK
    for kind in ("ccc-garch", "dcc-garch"):
        proc = state_proc(kind, STATE_ASSETS[kind], days)
        tot = totals[kind]
        v0 = float(torch.dot(proc.weights, proc.s0))
        res, walls[f"VaR {kind}"] = run_qmc(
            tot, f"portfolio_var_on_device({kind}, 2^28 x {days})",
            ("fused_terminal",),
            lambda: portfolio_var_on_device(proc, STATE_VAR_PATHS, days, v0,
                                            seed=0, bins=VAR_BINS,
                                            chunk_paths=STATE_VAR_CHUNK))
        k2 = tot["fused_terminal"]
        log(f"  portfolio_var_on_device {kind}: {walls[f'VaR {kind}']:.3f} "
            f"s, {STATE_VAR_PATHS / walls[f'VaR {kind}']:.4e} paths/s, "
            f"{k2} K2 launches; {json.dumps(res)}")
        checks[f"{kind}: K2 once a chunk and for the pilot"] = k2 in (
            n_chunks + 1, 2 * n_chunks + 1)
        checks[f"{kind}: n_paths"] = res["n_paths"] == STATE_VAR_PATHS
        checks[f"{kind}: VaR finite and positive"] = (
            math.isfinite(res["var_95"]) and 0 < res["var_95"]
            < res["cvar_95"])
        sk, _ = run_qmc(checked, f"portfolio_var_on_device({kind}, 2^20)",
                        ("fused_terminal",),
                        lambda: portfolio_var_on_device(
                            proc, n1, days, v0, seed=5, bins=VAR_BINS,
                            chunk_paths=n1))
        term, _ = run_qmc(checked, f"fused_terminal({kind}, 2^20)",
                          ("fused_terminal",),
                          lambda: fused_terminal(proc, n1, days, seed=5))
        exact = terminal_statistics(term, v0)
        for k in ("var_95", "cvar_95"):
            d = abs(sk[k] - float(exact[k]))
            log(f"  {kind} {k} at 2^20, sketch {sk[k]:.5f}% vs exact "
                f"{float(exact[k]):.5f}%: |diff| {d:.2e} (grid error "
                f"{sk[k + '_grid_err']:.2e})")
            checks[f"{kind} {k} sketch within its grid error"] = (
                d <= sk[k + "_grid_err"])
        stream, walls[f"stream {kind}"] = run_qmc(
            tot, f"portfolio_var({kind}, 2^24, stream)", ("fused_terminal",),
            lambda: portfolio_var(proc, STATE_STREAM_PATHS, days, v0, seed=0,
                                  bins=VAR_BINS,
                                  chunk_paths=STATE_STREAM_CHUNK))
        dev, _ = run_qmc(checked, f"portfolio_var_on_device({kind}, 2^24)",
                         ("fused_terminal",),
                         lambda: portfolio_var_on_device(
                             proc, STATE_STREAM_PATHS, days, v0, seed=0,
                             bins=VAR_BINS, chunk_paths=STATE_STREAM_CHUNK))
        d = abs(stream["var_95"] - dev["var_95"])
        log(f"  {kind} stream var_95 {stream['var_95']:.5f}% vs device "
            f"{dev['var_95']:.5f}% at 2^24 ({walls[f'stream {kind}']:.3f} s "
            f"host clock)")
        checks[f"{kind} stream at the device sketch"] = (
            d <= dev["var_95_grid_err"])
        n_or = 4096
        got, _ = run_qmc(checked, f"fused_terminal({kind}, {n_or})",
                         ("fused_terminal",),
                         lambda: fused_terminal(proc, n_or, days, seed=0))
        want = garch_book_oracle(proc, kind, n_or, days, 0)
        rel = float(np.max(np.abs(got.double().cpu().numpy() - want)
                           / np.abs(want)))
        log(f"  {kind} K2 vs the NumPy oracle at {n_or} x {days}: max rel "
            f"{rel:.2e}")
        checks[f"{kind} at its NumPy oracle"] = rel < 5e-4
        put = VanillaPayoff("put", 0.95 * v0)
        st, walls[f"put {kind}"] = run_qmc(
            tot, f"payoff_block_moments({kind}, 95% put, 2^24)",
            ("fused_block_moments",),
            lambda: payoff_block_moments(proc, put, STATE_VAR_CHUNK, days,
                                         seed=7))
        st = moments_reduce(st)
        term, _ = run_qmc(checked, f"fused_terminal({kind}, 2^24)",
                          ("fused_terminal",),
                          lambda: fused_terminal(proc, STATE_VAR_CHUNK, days,
                                                 seed=7))
        want = float(put(term).double().mean())
        log(f"  {kind} 95% put {float(st.mean):.6f} +- "
            f"{float(std_error(st)):.2e} (K3) vs {want:.6f} over K2's paths")
        checks[f"{kind} put at the K2 paths' mean"] = (
            abs(float(st.mean) - want) <= 1e-5 * max(want, 1e-3))
        mn, walls[f"min {kind}"] = run_qmc(
            tot, f"simulate_functionals({kind}, running min, 2^22)",
            ("fused_functionals",),
            lambda: simulate_functionals(proc, 1 << 22, days, seed=7,
                                         functionals={"mn": RUNNING_MIN}))
        # run_qmc held it to ("fused_functionals",): the generic fold.
        start = proc.prices(proc.init_state(torch.zeros(1, dtype=torch.int64,
                                                        device="cuda")))
        # The minimum is folded in log space and finalized by exp32:
        # exp32(log32(x)) is within a few ULPs of x, hence the 1e-6.
        top = torch.minimum(mn["terminal"], start) * (1 + 1e-6)
        checks[f"{kind} running min below terminal and start"] = bool(
            (mn["mn"] <= top).all())
        log(f"  {kind} 10-day running minimum: mean "
            f"{float(mn['mn'].mean()):.4f} against the start "
            f"{float(start):.4f}")
        del mn, term, got
    log("  state path wall-clocks (host clock): " + ", ".join(
        f"{k} {w:.3f} s" for k, w in walls.items()) + f", on {card}")
    for kind in STATE_KINDS:
        for name in ("fused_terminal", "fused_block_moments",
                     "fused_functionals"):
            launches[f"{name}_{STATE_KEY[kind]}"] = totals[kind].get(name, 0)
    log(f"  launches on the state path: {launches}; in the runs made only "
        f"to check: {checked}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"state path checks failed: {failed}")
    if min(launches.values()) < 1:
        raise AssertionError(f"kernels never launched on the state path: "
                             f"{launches}")
    return launches


# ---- Phase 15: greeks, variance reduction and the implied-vol surface ----

#: The JAX greeks command's defaults (200,000 paths, S0 100, K 105, r 0.03,
#: sigma 0.2, 1 year; its Heston: v0 0.04, kappa 2, theta 0.04, xi 0.5,
#: rho -0.7) at half its 252 steps: the depth cut that keeps the whole
#: script inside its time limit (PR 25).
GREEKS_PATHS, GREEKS_STEPS, GREEKS_STRIKE, GREEKS_RATE = 200_000, 126, 105.0, 0.03
#: The surface: 2^17 paths (mc_implied_vol_surface's default), the
#: maturities 21, 63, 126 and 252 steps and a six-maturity grid (one
#: launch of the snapshot kernel each), strikes 70 to 130 by 7.5.
IV_PATHS = 1 << 17
IV_GRID = [21, 63, 126, 252]
IV_GRID6 = [21, 42, 63, 126, 189, 252]
IV_STRIKES = [70.0 + 7.5 * k for k in range(9)]
#: K4's snapshot grids timed: 2, 4 and 6 maturities over 252 steps.
SNAPSHOT_GRIDS = {2: [126, 252], 4: IV_GRID, 6: IV_GRID6}
#: The variance-reduction estimators' shape and the IS strike.
VR_PATHS, VR_STEPS, IS_STRIKE = 1 << 20, 252, 150.0
#: The snapshot parity runs (paths, step counts) and the timed shapes
#: (paths, steps): the surface's 2^17 and a 2^20 beside K2's rows.
SNAPSHOT_PARITY = ((1 << 18) - 37, (17, 252))
SNAPSHOT_PATHS, SNAPSHOT_STEPS = (1 << 17, 1 << 20), 252
#: The snapshot kernel on GBM and Heston under plain Threefry draws.
SNAPSHOT_SASS = {kind: ("fused_snapshot_kernel", functor, "ThreefryDrawsILb0E")
                 for kind, functor in (("gbm", "GbmProc"),
                                       ("heston", "HestonProc"))}


def snapshot_bound(n, grid, draws=1, step_fp=3):
    """The least time of a maturity grid's prices, whatever computes them:
    one time loop to the last maturity over n paths with ``draws`` cipher
    calls a step pair and ``step_fp`` a step, a price's exp32 a path for
    each maturity (each snapshot and the terminal) and 4 bytes out a path
    for each."""
    m = len(grid)
    return step_bound(n, grid[-1], draws=draws, step_fp=step_fp,
                      out_bytes=4 * m, extra_fp=EXP32_FP * m)


def snapshot_launches(proc, n, grid, k4=None):
    """The surface's launches of a maturity grid: ``fused_functionals``
    (the snapshot kernel) with a snapshot at each maturity before the
    last, one run to the last; ``k4`` another function of its signature,
    such as :func:`snapshot_plain`."""
    from montecarlo_tpu_torch.engine.surface import price_snapshot
    from montecarlo_tpu_torch.ops import fused_functionals

    return (k4 or fused_functionals)(proc, n, grid[-1], seed=0, functionals={
        f"m{s}": price_snapshot(s) for s in grid[:-1]})


def snapshot_plain(proc, n, n_steps, *, functionals, **kw):
    """The snapshot kernel's plain version (``fused_snapshots_reference``)
    on a set of snapshots, keyed as ``fused_functionals`` keys them."""
    from montecarlo_tpu_torch.ops import fused_snapshots_reference

    steps = [f.device(n_steps).period for f in functionals.values()]
    rows = fused_snapshots_reference(proc, n, n_steps, steps, **kw)
    return {"terminal": rows[0],
            **{k: rows[j + 1] for j, k in enumerate(functionals)}}


def snapshot_counted(fn, *args, **kw):
    """(result, the snapshot kernel's launches, K4's) of one call, summed
    over the draw sources."""
    from montecarlo_tpu_torch.ops import launch_counts

    def counts():
        c = launch_counts()
        return [sum(c[f"{name}{sfx}"] for sfx in ("", "_sobol", "_bridge"))
                for name in ("fused_functionals_snapshot",
                             "fused_functionals")]

    before = counts()
    out = fn(*args, **kw)
    after = counts()
    return out, after[0] - before[0], after[1] - before[1]


def phase_snapshot_parity(torch, errs):
    """The snapshot kernel (csrc/fused_k4_snapshot.cu) on GBM and Heston
    against its plain version and K4's bitwise, plain and antithetic, at
    2^18 - 37 paths with ids from 2^30 - 1000 x 17 and 252 steps,
    snapshots at steps 0, 1, the middle one twice, the last and one past
    it, out of order; at 17 steps also under Sobol draws (and the bridge
    on GBM); each snapshot bitwise K2's terminal of a run stopped at its
    step (0: the spot), the last one the kernel's own terminal, the one
    past it 0; each call one launch of the snapshot kernel and none of
    K4's; the six-maturity grid in one launch bitwise one torch-loop run
    holding every snapshot."""
    from montecarlo_tpu_torch.engine import simulate_functionals
    from montecarlo_tpu_torch.engine.surface import (price_snapshot,
                                                     snapshot_terminals)
    from montecarlo_tpu_torch.ops import (fused_functionals,
                                          fused_functionals_reference,
                                          fused_terminal)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                                SobolDeviceSampler)

    (n, all_steps), off = SNAPSHOT_PARITY, (1 << 30) - 1000
    checks = 0
    for steps in all_steps:
        procs = {"gbm": GBM.create(100.0, 0.03, 0.2, 1.0 / steps,
                                   device="cuda"),
                 "heston": heston(steps)}
        mid = steps // 2 | 1
        picks = (mid, 0, steps, steps + 1, 1, mid)
        fns = {f"s{k}": price_snapshot(s) for k, s in enumerate(picks)}
        for kind, proc in procs.items():
            sources = {"plain": {}, "antithetic": {"antithetic": True}}
            if steps == all_steps[0]:
                sources["sobol"] = {"sampler": SobolDeviceSampler.create(
                    steps, proc.n_draws, scramble_seed=3, device="cuda")}
                if kind == "gbm":
                    sources["bridge"] = {
                        "sampler": SobolBridgeKernelSampler.create(
                            steps, scramble_seed=4, device="cuda")}
            for src, extra in sources.items():
                kw = dict(seed=7, path_offset=off, **extra)
                got, snaps, k4 = snapshot_counted(
                    fused_functionals, proc, n, steps, functionals=fns, **kw)
                if (snaps, k4) != (1, 0):
                    raise AssertionError(
                        f"{kind} {src}: {snaps} snapshot and {k4} K4 "
                        "launches, not 1 and 0")
                plain = snapshot_plain(proc, n, steps, functionals=fns, **kw)
                k4_plain = fused_functionals_reference(
                    proc, n, steps, functionals=fns, **kw)
                for k in plain:
                    _, max_abs, _ = compare(
                        f"K4 snapshot kernel {kind} {k} T={steps} {src}",
                        got[k], plain[k], BITWISE)
                    errs["fused_functionals_snapshot"] = max(
                        errs.get("fused_functionals_snapshot", 0.0), max_abs)
                    if not torch.equal(got[k], k4_plain[k]):
                        raise AssertionError(f"{kind} {k} T={steps} {src}: "
                                             "not K4's plain version")
                for k, s in enumerate(picks):
                    want = (fused_terminal(proc, n, s, **kw) if s <= steps
                            else torch.zeros_like(got["terminal"]))
                    if not torch.equal(got[f"s{k}"], want):
                        raise AssertionError(
                            f"{kind} snapshot at step {s} of {steps} is "
                            f"not K2's terminal at {s} steps ({src})")
                    checks += 1
                if not torch.equal(got["s2"], got["terminal"]):
                    raise AssertionError("the last snapshot is not the "
                                         "kernel's terminal")
    proc = heston(IV_GRID6[-1])
    rows, snaps, k4 = snapshot_counted(snapshot_terminals, proc, n, IV_GRID6,
                                       seed=3)
    if (snaps, k4) != (1, 0):
        raise AssertionError(f"the six-maturity grid took {snaps} snapshot "
                             f"and {k4} K4 launches, not 1 and 0")
    one = simulate_functionals(proc, n, IV_GRID6[-1], seed=3,
                               prefer_fused=False, functionals={
        f"m{j}": price_snapshot(s) for j, s in enumerate(IV_GRID6)})
    for j in range(len(IV_GRID6)):
        if not torch.equal(rows[j], one[f"m{j}"]):
            raise AssertionError(f"grid row {j}: the snapshot launch "
                                 "differs from one torch-loop run")
    log(f"  {checks} snapshots bitwise K2's terminal at their step (0 past "
        "the run); the six-maturity grid's one snapshot launch bitwise one "
        "torch-loop run")


def phase_snapshot_shapes(torch, errs, times):
    """The surface's snapshot launches of the 2-, 4- and 6-maturity grids
    on GBM at 2^17 and 2^20 paths x 252 steps (and the 4-maturity grid on
    Heston), one launch each, timed beside their plain version, bound and
    SASS issue floor, and K2 at the same shape: what the snapshots add to
    the terminal's loop."""
    from montecarlo_tpu_torch.ops import fused_terminal
    from montecarlo_tpu_torch.processes import GBM

    s = SNAPSHOT_STEPS
    gbm = GBM.create(100.0, 0.03, 0.2, 1.0 / s, device="cuda")
    regs = {k: kernel_regs(p) for k, p in SNAPSHOT_SASS.items()}
    for n in SNAPSHOT_PATHS:
        k2_ms, _ = cuda_ms(lambda: fused_terminal(gbm, n, s, seed=0), 10)
        log(f"  K2 gbm {n}x{s}: {k2_ms:.3f} ms (bound "
            f"{step_bound(n, s)[0]:.4f} ms), beside the snapshot grids")
        for m, grid in SNAPSHOT_GRIDS.items():
            timed_check(times, errs, "fused_functionals_snapshot",
                        f"K4 gbm snapshot grid of {m} maturities {n}x{s} "
                        f"({regs['gbm']})",
                        lambda g=grid: snapshot_launches(gbm, n, g),
                        lambda g=grid: snapshot_launches(gbm, n, g,
                                                         snapshot_plain),
                        10, BITWISE, bnd=snapshot_bound(n, grid),
                        floor=issue_floor(SNAPSHOT_SASS["gbm"], n,
                                          (s + 1) // 2))
    hp, n = heston(s), SNAPSHOT_PATHS[-1]
    timed_check(times, errs, "fused_functionals_snapshot",
                f"K4 heston snapshot grid of 4 maturities {n}x{s} "
                f"({regs['heston']})",
                lambda: snapshot_launches(hp, n, IV_GRID),
                lambda: snapshot_launches(hp, n, IV_GRID, snapshot_plain),
                10, BITWISE,
                bnd=snapshot_bound(n, IV_GRID, draws=2,
                                   step_fp=HESTON_STEP_FP),
                floor=issue_floor(SNAPSHOT_SASS["heston"], n, (s + 1) // 2))


def greeks_argv(*extra):
    return ["greeks", "--paths", str(GREEKS_PATHS), "--steps",
            str(GREEKS_STEPS), *extra]


def busy_share(torch, fn):
    """(wall-clock s, device busy s, device operations) of one call of
    ``fn`` under torch.profiler's CUDA activity, summed from its raw
    device events (kernels, copies, sets on one stream): the eager time
    loops launch ~10^5 kernels a call, too many for ``key_averages``'
    parse."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return wall, sum(e.duration_ns() for e in events) * 1e-9, len(events)


def measured_cli(torch, label, argv, profile=True):
    """One CLI run: its JSON, host wall-clock, peak device memory and
    K2/K3/K4 launches (counters reset just before, read just after), then,
    under ``profile``, the same run again under the profiler for the
    device's busy share (None without)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (out, _), wall, counts = run_counted(run_cli, argv)
    peak = torch.cuda.max_memory_allocated() / 2**20
    msg = (f"  {label}: {json.dumps(out)}; {wall:.3f} s wall-clock, peak "
           f"{peak:.1f} MiB, launches "
           f"{ {k: v for k, v in counts.items() if v} }")
    share = None
    if profile:
        p_wall, busy, n_ops = busy_share(torch, lambda: run_cli(argv))
        share = busy / p_wall
        msg += (f"; profiled {p_wall:.3f} s, device busy {busy:.3f} s "
                f"({100 * share:.1f}%) in {n_ops} device operations")
    log(msg)
    return out, wall, peak, share, counts


def pathwise_split(torch, proc, remat):
    """(forward s, backward s, peak MiB) of ``price_and_greeks``' two
    passes on ``proc`` at the command's shape, by the host clock around
    synchronised passes, and the draws alone (s): the 252 steps' normals
    without the step arithmetic."""
    import dataclasses

    from montecarlo_tpu_torch.engine.greeks import float_leaves
    from montecarlo_tpu_torch.engine.simulate import path_ids_for, simulate
    from montecarlo_tpu_torch.rng.threefry import key_from_seed

    n, s = GREEKS_PATHS, GREEKS_STEPS
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in float_leaves(proc).items()}
    p = dataclasses.replace(proc, **leaves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    price = torch.mean(torch.clamp(simulate(p, n, s, seed=0, remat=remat)
                                   - GREEKS_STRIKE, min=0.0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(price, list(leaves.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**20
    k0, k1 = key_from_seed(0, 0)
    ids = path_ids_for(n, 0, proc.device)
    t3 = time.perf_counter()
    for t in range(s):
        proc.draws(k0, k1, ids, t)
    torch.cuda.synchronize()
    return t1 - t0, t2 - t1, peak, time.perf_counter() - t3


def phase_greeks_path(torch, card):
    """The ``greeks`` command at the JAX command's 200,000 paths and
    ``GREEKS_STEPS``: pathwise on GBM and Heston, LR on a GBM digital (K2),
    second order on GBM (width 1.5) and Heston, and ``--mesh 1`` on a
    one-rank NCCL mesh, each with its wall-clock, peak memory, busy share
    and launches, against Black-Scholes's delta, vega, gamma and the
    digital's delta; the pathwise passes' split and peak with and without
    remat.  Returns the K2 launches of the path."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from scipy.stats import norm

    from montecarlo_tpu_torch.engine.greeks import (black_scholes_delta,
                                                    black_scholes_vega)
    from montecarlo_tpu_torch.processes import GBM

    k, r, sig, t = GREEKS_STRIKE, GREEKS_RATE, 0.2, 1.0
    bs_delta = float(black_scholes_delta(100.0, k, r, sig, t))
    bs_vega = float(black_scholes_vega(100.0, k, r, sig, t))
    d1 = (math.log(100.0 / k) + (r + sig ** 2 / 2) * t) / sig
    d2 = d1 - sig
    bs_gamma = float(norm.pdf(d1)) / (100.0 * sig)
    disc = math.exp(-r * t)
    dig_delta = disc * float(norm.pdf(d2)) / (100.0 * sig)
    checks, k2 = {}, 0
    gbm, _, _, _, c = measured_cli(torch, "greeks pathwise gbm",
                                   greeks_argv())
    checks["pathwise GBM delta within 0.01 of Black-Scholes"] = (
        abs(gbm["d_s0"] - bs_delta) < 0.01)
    checks["pathwise GBM vega within 3% of Black-Scholes"] = (
        abs(gbm["d_sigma"] - bs_vega) / bs_vega < 0.03)
    checks["pathwise runs the torch loop, no kernel"] = not any(c.values())
    hes, *_ = measured_cli(torch, "greeks pathwise heston",
                           greeks_argv("--process", "heston"))
    checks["Heston grads finite, delta in (0, 1)"] = (
        all(math.isfinite(v) for v in hes.values())
        and 0.0 < hes["d_s0"] < 1.0)
    lr, _, _, _, c = measured_cli(
        torch, "greeks lr digital gbm",
        greeks_argv("--method", "lr", "--payoff", "digital"))
    k2 += c["fused_terminal"]
    checks["LR terminal prices through K2 (1 launch)"] = (
        c["fused_terminal"] == 1)
    checks["LR digital delta within 4 std-err + 1e-4 of its closed form"] = (
        abs(lr["delta"] - dig_delta) < 4 * lr["delta_std_err"] + 1e-4)
    so, *_ = measured_cli(torch, "greeks second-order gbm",
                          greeks_argv("--method", "second-order",
                                      "--smooth-width", "1.5"))
    checks["second-order gamma within 15% of Black-Scholes"] = (
        abs(so["gamma"] - bs_gamma) < 0.15 * bs_gamma)
    so_h, *_ = measured_cli(torch, "greeks second-order heston",
                            greeks_argv("--method", "second-order",
                                        "--process", "heston"))
    checks["Heston second order finite"] = all(
        math.isfinite(v) for v in so_h.values())
    log(f"  Black-Scholes delta {bs_delta:.6f}, vega {bs_vega:.6f}, gamma "
        f"{bs_gamma:.6f}; the digital's delta {dig_delta:.6f}")
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            mesh, *_ = measured_cli(torch, "greeks --mesh 1 (NCCL)",
                                    greeks_argv("--mesh", "1"))
        finally:
            dist.destroy_process_group()
    rounded = -(-GREEKS_PATHS // 4096) * 4096
    checks[f"--mesh 1 on {rounded} paths: delta within 0.01 of BS"] = (
        mesh["n_paths"] == rounded and abs(mesh["d_s0"] - bs_delta) < 0.01
        and mesh["d_s0_std_err"] > 0)
    proc = GBM.create(100.0, r, sig, t / GREEKS_STEPS, device="cuda")
    for kind, p in (("gbm", proc), ("heston", heston(GREEKS_STEPS))):
        for remat in (False, True):
            fwd, bwd, peak, draws = pathwise_split(torch, p, remat)
            log(f"  pathwise {kind} remat={remat}: forward {fwd:.3f} s "
                f"(the draws alone {draws:.3f} s), backward {bwd:.3f} s, "
                f"peak {peak:.1f} MiB, on {card}")
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"  {'ok' if ok else 'FAIL'}: {name}")
    if failed:
        raise AssertionError(f"greeks checks failed: {failed}")
    return k2


def phase_iv_surface_path(torch, card):
    """``mc_implied_vol_surface`` on GBM and Heston at 2^17 paths over
    steps 21, 63, 126, 252 and the six-maturity grid, one launch of the
    snapshot kernel each and none of K4's, strikes 70 to 130 by 7.5,
    launches counted around each call: GBM flat at sigma within 0.01
    (tests/test_surface.py's bound) on every cell where four standard
    errors of its price move its iv by at most 0.01 (the wings carry too
    few paying paths, or too little time value beside the forward's
    error, to invert); Heston skewed at 1 year.  Returns the snapshot kernel's launches."""
    import numpy as np

    from montecarlo_tpu_torch.engine import (black_scholes_vega,
                                             mc_implied_vol_surface)
    from montecarlo_tpu_torch.processes import GBM

    s, r, sig = IV_GRID[-1], 0.03, 0.2
    gbm = GBM.create(100.0, r, sig, 1.0 / s, device="cuda")
    checks, snaps = {}, 0
    for kind, proc in (("gbm", gbm), ("heston", heston(s))):
        for grid in (IV_GRID, IV_GRID6):
            surf, wall, c = run_counted(
                mc_implied_vol_surface, proc, IV_STRIKES, grid, 1.0 / s,
                rate=r, n_paths=IV_PATHS, seed=3)
            snaps += c["fused_functionals_snapshot"]
            checks[f"{kind} {len(grid)} maturities: 1 snapshot launch, 0 "
                   "K4 launches"] = (c["fused_functionals_snapshot"] == 1
                                     and c["fused_functionals"] == 0)
            ivs, mats = surf["ivs"], surf["maturities"]
            log(f"  {kind} surface, {len(grid)} maturities: {wall:.3f} s "
                f"wall-clock, {c['fused_functionals_snapshot']} snapshot "
                f"launches, {c['fused_functionals']} K4 launches, NaN "
                f"cells {int(np.isnan(ivs).sum())} of {ivs.size}; ivs at "
                f"1 y {np.round(ivs[-1], 4).tolist()}, on {card}")
            if kind == "gbm":
                # A cell's iv error is its price's error over vega; the
                # call is 1-Lipschitz in S_T, so its discounted standard
                # error is at most S0 sqrt(exp(sigma^2 T) - 1) / sqrt(N).
                vega = black_scholes_vega(100.0, np.asarray(IV_STRIKES)[None],
                                          r, sig, mats[:, None]).numpy()
                se = (100.0 * np.sqrt(np.expm1(sig ** 2 * mats))[:, None]
                      / math.sqrt(IV_PATHS))
                m = 4 * se / vega <= 0.01
                err = np.abs(ivs[m] - sig) if m.any() else np.array([np.nan])
                checks[f"gbm {len(grid)} maturities flat within 0.01 on "
                       f"{int(m.sum())} cells"] = bool(
                    m.sum() >= len(grid) and np.isfinite(ivs[m]).all()
                    and err.max() < 0.01)
                log(f"  gbm surface: max |iv - sigma| {err.max():.2e} on "
                    f"the {int(m.sum())} cells where 4 std-err of the price "
                    "move the iv by at most 0.01")
            else:
                row = ivs[-1]
                checks[f"heston {len(grid)} maturities skewed at 1 y"] = bool(
                    np.isfinite(row[2:7]).all() and row[2] > row[4] > row[6])
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"  {'ok' if ok else 'FAIL'}: {name}")
    if failed:
        raise AssertionError(f"surface checks failed: {failed}")
    return snaps


def phase_variance_reduction_path(torch, card):
    """``importance_sampled_estimate`` on a 150-strike GBM call and
    ``cv_estimate`` (the terminal price as the control of the 105 call) at
    2^20 x 252, each on K2, within 4 std-err of Black-Scholes.  Returns
    the K2 launches."""
    from montecarlo_tpu_torch.engine import (black_scholes_call, cv_estimate,
                                             importance_sampled_estimate,
                                             mc_estimate, shift_to_strike,
                                             terminal_prices)
    from montecarlo_tpu_torch.processes import GBM

    n, s, r, sig = VR_PATHS, VR_STEPS, 0.03, 0.2
    proc = GBM.create(100.0, r, sig, 1.0 / s, device="cuda")
    disc = math.exp(-r)
    checks = {}
    shift = float(shift_to_strike(proc, IS_STRIKE, s))
    est, wall, c = run_counted(
        importance_sampled_estimate, proc,
        lambda x: torch.clamp(x - IS_STRIKE, min=0.0), n, s, seed=5,
        shift=shift, discount=disc)
    k2 = c["fused_terminal"]
    bs = black_scholes_call(100.0, IS_STRIKE, r, sig, 1.0)
    log(f"  IS 150-call: {float(est['price']):.6e} +- "
        f"{float(est['std_err']):.2e} (Black-Scholes {bs:.6e}), ess "
        f"{float(est['ess']):.1f} of {n}, shift {shift:.5f}; {wall:.3f} s, "
        f"K2 launches {c['fused_terminal']}, on {card}")
    checks["IS within 4 std-err of Black-Scholes"] = (
        abs(float(est["price"]) - bs) < 4 * float(est["std_err"]))
    checks["IS on K2 (1 launch)"] = c["fused_terminal"] == 1

    def cv():
        term = terminal_prices(proc, n, s, seed=6)
        pay = torch.clamp(term - GREEKS_STRIKE, min=0.0)
        return (cv_estimate(pay, term, 100.0 * math.exp(r), discount=disc),
                mc_estimate(pay, disc))

    (est, plain), wall, c = run_counted(cv)
    k2 += c["fused_terminal"]
    bs = black_scholes_call(100.0, GREEKS_STRIKE, r, sig, 1.0)
    log(f"  CV 105-call: {float(est['price']):.6f} +- "
        f"{float(est['std_err']):.2e} (plain {float(plain['std_err']):.2e}; "
        f"Black-Scholes {bs:.6f}), beta {float(est['beta']):.4f}, variance "
        f"ratio {float(est['variance_ratio']):.4f}; {wall:.3f} s, K2 "
        f"launches {c['fused_terminal']}")
    checks["CV within 4 std-err of Black-Scholes"] = (
        abs(float(est["price"]) - bs) < 4 * float(est["std_err"]))
    checks["CV on K2 (1 launch), below plain's error"] = (
        c["fused_terminal"] == 1
        and float(est["std_err"]) < float(plain["std_err"]))
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"  {'ok' if ok else 'FAIL'}: {name}")
    if failed:
        raise AssertionError(f"variance-reduction checks failed: {failed}")
    return k2


# ---- Phase 16: calibration, multilevel Monte Carlo, the gamma sampler -------

#: The calibrate demos, each with its gate (the JAX tests' tolerances:
#: tests/test_heston_analytic.py, test_levy_calibration.py,
#: test_rates_calibration.py's CLI test, test_sabr_calibration.py).
CALIBRATE_MODELS = ("heston", "vg", "nig", "merton", "kou", "vasicek",
                    "sabr")
#: The card's pricers in float32 against the CPU's float64 forms at the
#: demos' parameters: Heston's and the Levy CF prices (0.02-26) within
#: 2e-4 absolute (s0 P1 - K e^{-rT} P2, two terms of ~100 carrying
#: float32 rounding through 96-256 complex nodes: 2-6e-5 on the CPU's
#: float32), the swaption premia (1.4e-4 to 0.044) within 1e-6 absolute;
#: in float64 on the card within 1e-9 (premia rtol 1e-10).
PRICER_F32_ATOL, SWAPTION_F32_ATOL = 2e-4, 1e-6
#: The MLMC command's target RMSE (JAX's default) and the Asian telescope
#: and sharded level's shape.
MLMC_RMSE, MLMC_LEVEL_PATHS = 0.01, 1 << 18
#: The gamma Newton sampler on the card against the CPU: 2^20 draws.
GAMMA_DRAWS = 1 << 20


def calibrate_gate(out, ivs_err=None):
    """The JAX tests' gate of one ``calibrate`` demo's JSON."""
    truth = out["demo_truth"]
    if "v0" in out:
        return ivs_err < 0.004 and abs(out["v0"] - truth["v0"]) < 0.02
    if "kappa" in out:
        return (out["rmse_rel"] < 2e-3
                and abs(out["kappa"] - truth["kappa"]) < 0.1)
    if "nu" in truth and "rho" in truth:   # SABR
        return (out["rmse_vol"] < 5e-4
                and abs(out["alpha"] - truth["alpha"]) / truth["alpha"] < 0.05
                and abs(out["nu"] - truth["nu"]) < 0.05
                and abs(out["rho"] - truth["rho"]) < 0.08)
    if "theta" in truth:                   # VG
        return out["rmse_vol"] < 5e-4 and all(
            abs(out[k] - v) < 0.01 * max(abs(v), 0.1)
            for k, v in truth.items())
    if "delta" in truth:                   # NIG
        return (out["rmse_vol"] < 5e-4
                and abs(out["delta"] - truth["delta"]) < 0.02
                and abs(out["beta"] - truth["beta"]) < 0.2
                and abs(out["alpha"] - truth["alpha"]) < 0.5)
    slack = 0.015 if "jump_mean" in truth else 0.02   # Merton, Kou
    return (out["rmse_vol"] < 1e-3
            and abs(out["sigma"] - truth["sigma"]) < slack)


def heston_demo_iv_error(torch, out):
    """The worst implied-vol error of a Heston fit's repriced demo surface
    (on the card) against the demo's."""
    from montecarlo_tpu_torch.cli.calibrate import demo_surface
    from montecarlo_tpu_torch.engine.heston_analytic import (HestonParams,
                                                             heston_call_cf)
    from montecarlo_tpu_torch.engine.implied_vol import implied_vol_call

    class Args:
        s0, rate = 100.0, 0.03

    ks, ts, ivs, _ = demo_surface("heston", Args, torch.device("cuda"))
    f32 = dict(dtype=torch.float32, device="cuda")
    fit = HestonParams(**{k: torch.tensor(out[k], **f32)
                          for k in HestonParams._fields})
    kt, tt = torch.tensor(ks, **f32), torch.tensor(ts, **f32)
    fit_iv = implied_vol_call(heston_call_cf(100.0, kt, tt, 0.03, fit), 100.0,
                              kt, 0.03, tt)
    return float(torch.max(torch.abs(fit_iv.double().cpu()
                                     - torch.tensor(ivs))))


def phase_pricers(torch, card):
    """The calibrators' pricers on the card (float32 and float64) against
    the CPU's float64 forms at the demos' parameters."""
    from montecarlo_tpu_torch.cli.calibrate import (DEMO_MATURITIES,
                                                    DEMO_STRIKES,
                                                    HESTON_DEMO, LEVY_DEMOS,
                                                    VASICEK_DEMO)
    from montecarlo_tpu_torch.engine import cf_pricing as cf
    from montecarlo_tpu_torch.engine import heston_analytic as ha
    from montecarlo_tpu_torch.engine import rates_calibration as rc

    ks = DEMO_STRIKES * len(DEMO_MATURITIES)
    ts = [t for t in DEMO_MATURITIES for _ in DEMO_STRIKES]
    grid = [(t0, m, k) for t0 in (1.0, 2.0, 3.0) for m in (4, 8)
            for k in (0.036, 0.045, 0.054)]

    def prices(dtype, device):
        t = lambda x: torch.tensor(x, dtype=dtype, device=device)
        out = {"heston": ha.heston_call_cf(100.0, t(ks), t(ts), 0.03,
                                           ha.HestonParams(**{
                                               k: t(v) for k, v in
                                               HESTON_DEMO.items()}))}
        for m, p in LEVY_DEMOS.items():
            phi = getattr(cf, f"{m}_log_cf_tensor")(t(100.0), 0.03,
                                                    *p.values(), t(ts))
            out[m] = cf.cf_call_price_impl(phi, 100.0, t(ks), t(ts), 0.03)
        out["vasicek"] = rc.vasicek_swaption_prices(
            0.03, *VASICEK_DEMO.values(), [g[0] for g in grid],
            [0.5] * len(grid), [g[2] for g in grid], [g[1] for g in grid],
            dtype=dtype, device=device)
        return {k: v.cpu().double() for k, v in out.items()}

    ref = prices(torch.float64, "cpu")
    got32 = prices(torch.float32, "cuda")
    got64 = prices(torch.float64, "cuda")
    ok = True
    for name, want in ref.items():
        e32 = float((got32[name] - want).abs().max())
        e64 = float((got64[name] - want).abs().max())
        b32 = SWAPTION_F32_ATOL if name == "vasicek" else PRICER_F32_ATOL
        b64 = (1e-10 * float(want.abs().max()) if name == "vasicek"
               else 1e-9)
        good = e32 <= b32 and e64 <= b64
        ok &= good
        log(f"  pricer {name}: card float32 max |err| {e32:.3e} (bound "
            f"{b32:.0e}), card float64 {e64:.3e} (bound {b64:.1e}) against "
            f"the CPU's float64 ({'ok' if good else 'FAIL'})")
    return ok


#: Adam steps of each fit timed alone (PR 24 took 100; 50 since PR 25, a
#: depth cut that keeps the whole script inside its time limit).
FIT_STEPS = 50


def calibration_busy_shares(torch, card):
    """The Heston-to-IVs and VG fits alone on their demo surfaces:
    ``FIT_STEPS`` Adam steps timed by the host clock, then half as many
    under the profiler for the device's busy share."""
    from montecarlo_tpu_torch.cli.calibrate import demo_surface
    from montecarlo_tpu_torch.engine import heston_analytic as ha
    from montecarlo_tpu_torch.engine import levy_calibration as lc

    class Args:
        s0, rate, beta, maturity = 100.0, 0.03, 0.7, 1.0

    dev = torch.device("cuda")
    shares = {}
    for model in ("heston", "vg"):
        ks, ts, ivs, _ = demo_surface(model, Args, dev)
        if model == "heston":
            raw0 = torch.tensor(ha.RAW0, dtype=torch.float32, device=dev)
            fit = lambda n: ha._calibrate_iv(ks, ts, ivs, 100.0, 0.03, raw0,
                                             n, 96, 0.05)
        else:
            raw0 = torch.tensor(lc.FAMILIES["vg"][2], dtype=torch.float32,
                                device=dev)
            fit = lambda n: lc._calibrate_iv("vg", ks, ts, ivs, 100.0, 0.03,
                                             raw0, n, 0.03)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(FIT_STEPS)
        torch.cuda.synchronize()
        alone = time.perf_counter() - t0
        half = FIT_STEPS // 2
        wall, busy, n_ops = busy_share(torch, lambda: fit(half))
        shares[model] = busy / wall
        log(f"  {model} fit alone: {FIT_STEPS} Adam steps {alone:.3f} s "
            f"({FIT_STEPS / alone:.1f} steps/s); {half} profiled "
            f"{wall:.3f} s, device busy {busy:.3f} s "
            f"({100 * busy / wall:.1f}%) in {n_ops} device operations "
            f"({n_ops / half:.0f} a step), on {card}")
    return shares


#: One ``calibrate`` command in a process of its own, timed around the
#: CLI's entry (``cli.main``) in that process: its JSON on stdout, its
#: wall-clock on stderr's last line.
TIMED_CLI = ("import sys, time\n"
             "from montecarlo_tpu_torch.cli import main\n"
             "t0 = time.perf_counter()\n"
             "rc = main(sys.argv[1:])\n"
             "print(time.perf_counter() - t0, file=sys.stderr)\n"
             "sys.exit(rc)\n")


def calibrate_demos(models, while_running, timeout=600):
    """Every ``calibrate --model M`` demo of ``models`` on the card, each
    in a process of its own, all at once (each eager fit keeps a host core
    busy and the card a few per cent busy, so they share the card and the
    host's cores); ``while_running()`` runs here meanwhile.  Returns
    ({model: (JSON, wall-clock s of the command in its process)},
    ``while_running()``'s result); every process is waited for, or killed
    at ``timeout``."""
    import os

    import montecarlo_tpu_torch

    root = os.path.dirname(os.path.dirname(montecarlo_tpu_torch.__file__))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": root}
    procs = {m: subprocess.Popen(
        [sys.executable, "-c", TIMED_CLI, "calibrate", "--model", m],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for m in models}
    out = {}
    try:
        meanwhile = while_running()
        for m, p in procs.items():
            stdout, stderr = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"calibrate --model {m}: exit code "
                                     f"{p.returncode}: {stderr[-2000:]}")
            out[m] = (json.loads(stdout.strip().splitlines()[-1]),
                      float(stderr.strip().splitlines()[-1]))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    return out, meanwhile


def phase_calibration(torch, card):
    """Every ``calibrate --model`` demo on the card (the default device),
    seven processes at once: its JSON, wall-clock and Adam steps/s, gated
    by the JAX tests' tolerances; meanwhile the pricers run against the
    CPU's float64; then two fits alone, timed and profiled.  (``--model
    lmm`` is phase 18's.)"""
    t0 = time.perf_counter()
    demos, checks = calibrate_demos(CALIBRATE_MODELS, lambda: {
        "pricers on the card against the CPU's float64":
        phase_pricers(torch, card)})
    log(f"  the seven calibrate demos, one process each, all at once: "
        f"{time.perf_counter() - t0:.1f} s, on {card}")
    for model in CALIBRATE_MODELS:
        steps = {"heston": 800, "sabr": 2000}.get(model, 1500)
        out, wall = demos[model]
        err = heston_demo_iv_error(torch, out) if model == "heston" else None
        ok = calibrate_gate(out, err)
        checks[f"calibrate --model {model} recovers its demo"] = ok
        extra = f", worst iv error {err:.2e}" if err is not None else ""
        log(f"  calibrate --model {model}: {json.dumps(out)}{extra}; "
            f"{wall:.3f} s in its process beside the six others, "
            f"{steps / wall:.1f} Adam steps/s ({'ok' if ok else 'FAIL'}), "
            f"on {card}")
    shares = calibration_busy_shares(torch, card)
    return checks, shares


def mlmc_call(label, argv):
    """One ``price --mlmc`` run, launch counters reset just before and
    read just after: (JSON, wall-clock s, launches)."""
    (out, _), wall, counts = run_counted(run_cli, argv)
    log(f"  {label}: {json.dumps(out)}; {wall:.3f} s, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return out, wall, counts


def phase_mlmc(torch, card):
    """``price --mlmc`` on Euler GBM (against Black-Scholes) and Heston
    (against its CF price), level 0 on K2; the Asian telescope's levels 0
    (K4 {avg} on its fixed fold) and 2 on exact GBM; level 0 through K2
    and K4 bitwise its torch loop at those runs' shapes; a level sharded
    over a one-rank NCCL mesh bitwise the unsharded level.  Returns
    (checks, launches by kernel row)."""
    import tempfile

    import torch.distributed as dist

    from montecarlo_tpu_torch.engine import mlmc
    from montecarlo_tpu_torch.engine.heston_analytic import (HestonParams,
                                                             heston_call_cf)
    from montecarlo_tpu_torch.parallel import make_mesh
    from montecarlo_tpu_torch.processes import GBM, EulerGBM, Heston

    checks, rows = {}, {}
    rmse = ["--mlmc-rmse", str(MLMC_RMSE)]
    gbm, wall, c = mlmc_call("price --mlmc (Euler GBM)",
                             ["price", "--mlmc", *rmse])
    rows["fused_terminal_rates"] = c["fused_terminal"]
    log(f"  Euler GBM ladder {gbm['level_paths']}, vs single-level cost "
        f"{gbm['vs_single_level_cost']:.3f}x, {wall:.3f} s, on {card}")
    checks["MLMC Euler GBM within 4 rmse of Black-Scholes"] = (
        abs(gbm["price"] - gbm["black_scholes"]) < 4 * MLMC_RMSE)
    checks["MLMC Euler GBM level 0 on K2"] = c["fused_terminal"] > 0
    hes, wall, c = mlmc_call("price --mlmc --process heston",
                             ["price", "--mlmc", *rmse, "--process",
                              "heston"])
    rows["fused_terminal"] = c["fused_terminal"]
    cf = float(heston_call_cf(100.0, 105.0, 1.0, 0.03, HestonParams(
        *(torch.tensor(v, dtype=torch.float64)
          for v in (0.04, 2.0, 0.04, 0.5, -0.7)))))
    log(f"  Heston ladder {hes['level_paths']}, vs single-level cost "
        f"{hes['vs_single_level_cost']:.3f}x, {wall:.3f} s; the CF price "
        f"{cf:.6f}, on {card}")
    checks["MLMC Heston within 4 rmse of its CF price"] = (
        abs(hes["price"] - cf) < 4 * MLMC_RMSE)
    checks["MLMC Heston level 0 on K2"] = c["fused_terminal"] > 0
    heston_at = lambda n: Heston.create(
        s0=100.0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7,
        dt=1.0 / n, device="cuda")
    p_wall, busy, n_ops = busy_share(torch, lambda: mlmc.mlmc_level_moments(
        heston_at, lambda s: torch.clamp(s - 105.0, min=0.0), 3, 1 << 16,
        seed=0, n0_steps=4))
    log(f"  a coupled Heston level (3: 32 fine steps, 65536 paths) "
        f"profiled: {p_wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / p_wall:.1f}%) in {n_ops} device operations, on "
        f"{card}")

    call = lambda s: torch.clamp(s - 100.0, min=0.0)
    exact = lambda n: GBM.create(100.0, 0.05, 0.2, 1.0 / n, device="cuda")
    (l0, l2), wall, c = run_counted(lambda: [
        mlmc.mlmc_level_moments(exact, call, lvl, MLMC_LEVEL_PATHS, seed=21,
                                n0_steps=4, payoff_on="mean")
        for lvl in (0, 2)])
    for key in ("fused_functionals", "fused_functionals_fixed"):
        rows[key] = c[key]
    v0 = float(l0[0].m2 / l0[0].count)
    v2 = float(l2[0].m2 / l2[0].count)
    log(f"  Asian telescope (exact GBM, {MLMC_LEVEL_PATHS} paths): level 0 "
        f"mean {float(l0[0].mean):.6f} var {v0:.4e}, level 2 mean Y "
        f"{float(l2[0].mean):.3e} var Y {v2:.4e}; {wall:.3f} s, launches "
        f"{ {k: v for k, v in c.items() if v} }")
    checks["Asian telescope: level 0 on K4's fixed {avg}"] = (
        c["fused_functionals_fixed"] == 1)
    checks["Asian telescope: var Y_2 < 1% of var P_0"] = 0 < v2 < 0.01 * v0

    euler = lambda n: EulerGBM.create(100.0, 0.05, 0.2, 1.0 / n,
                                      device="cuda")
    # Level 0 through K2/K4 against its torch loop, bitwise, at the shapes
    # the runs above give it: a run of mlmc.RUN_PATHS paths x 4 steps
    # (Euler GBM, Heston) and the telescope's 2^18 x 4 ({avg}).
    for label, make, n, on in (
            ("Euler GBM (K2)", euler, mlmc.RUN_PATHS, "terminal"),
            ("Heston (K2)", heston_at, mlmc.RUN_PATHS, "terminal"),
            ("exact GBM {avg} (K4)", exact, MLMC_LEVEL_PATHS, "mean")):
        proc = make(4)
        kern = mlmc._level0_values(proc, call, n, 4, 0, 0, 1 << 16, on)
        loop, _ = mlmc._coupled_values(proc, None, call, n, 4, 1, 0, 0,
                                       torch.float32, 1 << 16, on)
        same = torch.equal(kern, loop)
        checks[f"MLMC level 0 of {label} bitwise its torch loop"] = same
        log(f"  level 0 of {label}, {n} paths x 4 steps from path 65536: "
            f"bitwise the torch loop: {same}")
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            for lvl in (0, 2):
                kw = dict(seed=31, n0_steps=4, path_offset=4096)
                sh, wall, c = run_counted(
                    mlmc.mlmc_level_moments, euler, call, lvl,
                    MLMC_LEVEL_PATHS, mesh=mesh, **kw)
                rows["fused_terminal_rates"] += c["fused_terminal"]
                un = mlmc.mlmc_level_moments(euler, call, lvl,
                                             MLMC_LEVEL_PATHS, **kw)
                same = all(torch.equal(a, b) for a, b in
                           zip(tuple(sh[0]) + tuple(sh[1]),
                               tuple(un[0]) + tuple(un[1])))
                checks[f"level {lvl} over the NCCL mesh bitwise unsharded"] \
                    = same
                log(f"  level {lvl} on {mesh.shape} ({mesh.backend}): mean "
                    f"Y {float(sh[0].mean):.6e}, {wall:.3f} s, bitwise the "
                    f"unsharded level: {same}")
        finally:
            dist.destroy_process_group()
    return checks, rows


def phase_gamma_newton(torch, card):
    """``gamma_from_uniforms32`` on 2^20 uniform pairs on the card against
    the CPU: the largest ULP difference, and the test file's bound."""
    from montecarlo_tpu_torch.rng.gamma import gamma_from_uniforms32
    from montecarlo_tpu_torch.rng.normal import uniform_draw

    ids = torch.arange(GAMMA_DRAWS, dtype=torch.int64, device="cuda")
    u_w, u_b = uniform_draw(3, 0, ids, 0), uniform_draw(3, 0, ids, 1)
    a = 0.02 + 0.98 * uniform_draw(3, 0, ids, 2)
    t0 = time.perf_counter()
    card_g = gamma_from_uniforms32(a, u_w, u_b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = gamma_from_uniforms32(a.cpu(), u_w.cpu(), u_b.cpu())
    got = card_g.cpu()
    normal = host >= torch.finfo(torch.float32).tiny
    ulps = (got.view(torch.int32).long()
            - host.view(torch.int32).long()).abs()
    bound = 64 * 2.0 ** -24 * (1.0 + torch.log(u_b.cpu().double()).abs()
                               / a.cpu().double())
    rel = ((got.double() - host.double()).abs() / host.double())[normal]
    ok = bool((rel <= bound[normal]).all()) and bool(
        ((got - host).abs()[~normal] <= 16 * 2.0 ** -126).all())
    log(f"  gamma_from_uniforms32, {GAMMA_DRAWS} draws (a in [0.02, 1]): "
        f"card {1e3 * wall:.3f} ms; max ULP difference from the CPU "
        f"{int(ulps[normal].max())} where normal "
        f"({100 * float((ulps == 0).double().mean()):.2f}% bitwise), "
        f"{int((~normal).sum())} below the normal range; within the "
        f"stated bound: {ok}, on {card}")
    return {"gamma Newton sampler within its bound of the CPU": ok}


def phase_calibration_mlmc(torch, card):
    """Phase 16.  Returns (the K2/K4 launches of MLMC's level 0 by kernel
    row, the fits' busy shares)."""
    t0 = time.perf_counter()
    checks, shares = phase_calibration(torch, card)
    t1 = time.perf_counter()
    mchecks, rows = phase_mlmc(torch, card)
    checks.update(mchecks)
    t2 = time.perf_counter()
    checks.update(phase_gamma_newton(torch, card))
    log(f"  phase 16: calibration {t1 - t0:.1f} s, MLMC {t2 - t1:.1f} s, "
        f"gamma {time.perf_counter() - t2:.1f} s")
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"  {'ok' if ok else 'FAIL'}: {name}")
    if failed:
        raise AssertionError(f"phase 16 checks failed: {failed}")
    return rows, shares

#: Phase 17: the American put of tests/test_american.py (the CLI's 100,000
#: paths x 252 steps), the published 2-asset max-call (Andersen-Broadie
#: 2004: 13.902), the sharded LSM's and dual's sizes, and the card-against-
#: CPU float64 LSM's.
AMERICAN_PUT = ["--payoff", "put", "--s0", "36", "--strike", "40", "--rate",
                "0.06", "--sigma", "0.2", "--maturity", "1"]
MAX_CALL = ["--payoff", "max-call", "--n-assets", "2", "--s0", "100",
            "--strike", "100", "--rate", "0.05", "--div", "0.10", "--sigma",
            "0.2", "--asset-corr", "0", "--maturity", "3", "--steps", "9"]
MAX_CALL_TRUE = 13.902
SHARDED_LSM = (1 << 16, 252)
SHARDED_AB = (4096, 256, 252)  # one 4096-path block
#: The sharded dual's policy: ``lsm_policy`` at this many paths.
SHARDED_POLICY = 1 << 15
CPU_LSM = (1 << 14, 16)


def american_sharded(torch, checks):
    """``sharded_lsm_price`` and ``sharded_andersen_broadie_bound`` on a
    one-rank NCCL mesh: the LSM within 4 std-err of ``lsm_price``; the
    dual's per-path maxima over 2 emulated ranks' ids bitwise the
    unsharded run's, and its bound the unsharded maxima's block states."""
    import tempfile

    import torch.distributed as dist

    from montecarlo_tpu_torch.engine.american import (_ab_best, lsm_policy,
                                                      lsm_price)
    from montecarlo_tpu_torch.engine.simulate import path_ids_for
    from montecarlo_tpu_torch.parallel import (block_moments, make_mesh,
                                               sharded_andersen_broadie_bound,
                                               sharded_lsm_price)
    from montecarlo_tpu_torch.processes import GBM
    from montecarlo_tpu_torch.stats.welford import moments_reduce

    n, steps = SHARDED_LSM
    outer, inner, ab_steps = SHARDED_AB
    r, dt = 0.06, 1.0 / steps
    gbm = GBM.create(36.0, r, 0.2, dt)
    put = lambda s: torch.clamp(40.0 - s, min=0.0)
    kw = dict(rate=r, dt=dt, degree=3)
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh()
            t0 = time.perf_counter()
            lsm = sharded_lsm_price(gbm, put, n, steps, seed=0, mesh=mesh,
                                    **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, policy = lsm_policy(gbm, put, SHARDED_POLICY, steps, seed=0,
                                   **kw)
            t2 = time.perf_counter()
            ab = sharded_andersen_broadie_bound(
                gbm, put, policy, outer, inner, ab_steps, seed=1, mesh=mesh,
                **kw)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        finally:
            dist.destroy_process_group()
    plain = lsm_price(gbm, put, n, steps, seed=0, **kw)
    full = _ab_best(gbm, put, policy, path_ids_for(outer, 0, "cuda"), inner,
                    ab_steps, seed=1, value_degree=None, dtype=torch.float32,
                    **kw)
    half = outer // 2
    ranks = torch.cat([
        _ab_best(gbm, put, policy, path_ids_for(half, k * half, "cuda"),
                 inner, ab_steps, seed=1, value_degree=None,
                 dtype=torch.float32, **kw)
        for k in range(2)])
    whole = moments_reduce(block_moments(full))
    log(f"  sharded LSM {n} x {steps} on the NCCL mesh: "
        f"{float(lsm['price']):.6f} +- {float(lsm['std_err']):.6f} in "
        f"{t1 - t0:.3f} s; lsm_price {float(plain['price']):.6f}; sharded "
        f"dual {outer} x {inner}: {float(ab['upper']):.6f} +- "
        f"{float(ab['std_err']):.6f} in {t3 - t2:.3f} s")
    checks["sharded LSM within 4 std-err of lsm_price"] = (
        abs(float(lsm["price"]) - float(plain["price"]))
        < 4 * float(plain["std_err"]))
    checks["dual's per-path maxima on 2 emulated ranks bitwise unsharded"] = (
        torch.equal(ranks, full))
    checks["sharded dual's bound = the unsharded maxima's block states"] = (
        torch.equal(ab["upper"], whole.mean))


def american_card_vs_cpu(torch, checks):
    """``lsm_policy`` in float64 (float64 leaves) on the card against the
    same call on the CPU: price within rtol 1e-9 (the platforms' float64
    log, sin and cos; sums in each device's order)."""
    from montecarlo_tpu_torch.engine.american import lsm_policy
    from montecarlo_tpu_torch.processes import GBM

    n, steps = CPU_LSM
    vals = dict(s0=36.0, mu=0.06, sigma=0.2, dt=1.0 / steps)
    put = lambda s: torch.clamp(40.0 - s, min=0.0)
    got = {}
    for dev in ("cuda", "cpu"):
        gbm = GBM(**{k: torch.tensor(v, dtype=torch.float64, device=dev)
                     for k, v in vals.items()})
        got[dev], _ = lsm_policy(gbm, put, n, steps, seed=4, rate=0.06,
                                 dt=1.0 / steps, degree=3,
                                 dtype=torch.float64)
    card, cpu = float(got["cuda"]["price"]), float(got["cpu"]["price"])
    log(f"  lsm_policy float64 at {n} x {steps}: card {card!r}, CPU "
        f"{cpu!r}, rel {abs(card - cpu) / cpu:.3e}")
    checks["float64 LSM on the card within rtol 1e-9 of the CPU"] = (
        abs(card - cpu) <= 1e-9 * abs(cpu))


def phase_american(torch, card):
    """Phase 17: American and Bermudan exercise (9c) on the card, through
    the CLI and the engine, each command's wall-clock and busy share; the
    American paths launch no kernel (the torch loop, as JAX's scan), the
    European Asian they are held against launches K4.  Returns the
    European Asian's K2-K4 launches."""
    from montecarlo_tpu_torch.engine.american import binomial_american_put

    t0 = time.perf_counter()
    checks = {}
    put, *_ = measured_cli(torch, "price --american --american-bound (GBM "
                           "put)", ["price", "--american", "--american-bound",
                                    *AMERICAN_PUT])
    tree = binomial_american_put(36.0, 40.0, 0.06, 0.2, 1.0, 1000)
    lo, lo_se = put["price"], put["std_err"]
    hi, hi_se = put["upper_bound"], put["upper_bound_std_err"]
    log(f"  binomial (1000 steps) {tree:.6f}: bracket [{lo:.6f}, "
        f"{hi:.6f}]")
    checks["GBM put: lower - 4 se - 0.05 <= binomial <= upper + 4 se"] = (
        lo - 4 * lo_se - 0.05 <= tree <= hi + 4 * hi_se)
    # Heston's busy share is not profiled: its 4x10^5 device operations
    # cost the profiler ~20 s to collect, and its loop is the GBM put's
    # kind (PERF.md's PR 25 entry has it from a run of this phase alone).
    hes, *_ = measured_cli(torch, "price --american --american-bound "
                           "--process heston", ["price", "--american",
                                                "--american-bound",
                                                "--process", "heston",
                                                *AMERICAN_PUT], profile=False)
    checks["Heston put: upper >= lower - 4 se"] = (
        hes["upper_bound"] >= hes["price"] - 4 * hes["std_err"])
    asian, *_, c = measured_cli(torch, "price --payoff asian --american",
                                ["price", "--payoff", "asian", "--american"],
                                profile=False)
    checks["the American paths launch no kernel"] = not any(c.values())
    euro, *_, k4 = measured_cli(torch, "price --payoff asian (K4)",
                                ["price", "--payoff", "asian"],
                                profile=False)
    checks["the European Asian launches K4"] = (
        k4["fused_functionals"] + k4["fused_functionals_fixed"] >= 1)
    checks["American Asian >= European Asian - 4 se"] = (
        asian["price"] >= euro["price"] - 4 * euro["std_err"])
    mx, *_ = measured_cli(torch, "price --payoff max-call --american "
                          "--american-bound", ["price", *MAX_CALL,
                                               "--american",
                                               "--american-bound"])
    checks[f"max-call bracket holds {MAX_CALL_TRUE}"] = (
        mx["price"] - 4 * mx["std_err"] <= MAX_CALL_TRUE
        <= mx["upper_bound"] + 4 * mx["upper_bound_std_err"])
    g, *_ = measured_cli(torch, "greeks --american (put)",
                         ["greeks", "--american", *AMERICAN_PUT],
                         profile=False)
    h = 0.25
    fd = (binomial_american_put(36.0 + h, 40.0, 0.06, 0.2, 1.0, 1500)
          - binomial_american_put(36.0 - h, 40.0, 0.06, 0.2, 1.0, 1500)) \
        / (2 * h)
    log(f"  binomial central-difference delta {fd:.6f}")
    checks["American put delta within 0.02 of the binomial difference"] = (
        abs(g["delta"] - fd) < 0.02)
    one, *_ = measured_cli(torch, "bond --swaption --n-exercise 1",
                           ["bond", "--swaption", "--n-exercise", "1"],
                           profile=False)
    checks["European swaption within 4 se of Jamshidian"] = (
        abs(one["bermudan_swaption"] - one["jamshidian_european"])
        < 4 * one["std_err"])
    four, *_ = measured_cli(torch, "bond --swaption --n-exercise 4",
                            ["bond", "--swaption", "--n-exercise", "4"])
    checks["4 exercise dates >= the European"] = (
        four["bermudan_swaption"] >= one["bermudan_swaption"])
    t1 = time.perf_counter()
    american_sharded(torch, checks)
    t2 = time.perf_counter()
    american_card_vs_cpu(torch, checks)
    log(f"  phase 17: the CLI {t1 - t0:.1f} s, sharded "
        f"{t2 - t1:.1f} s, card against CPU "
        f"{time.perf_counter() - t2:.1f} s, on {card}")
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"  {'ok' if ok else 'FAIL'}: {name}")
    if failed:
        raise AssertionError(f"phase 17 checks failed: {failed}")
    return k4


#: Phase 18: experiments/lmm_bench.py's (forwards, paths) shapes and
#: model; the stress command's default shape.
LMM_SHAPES = ((16, 1 << 19), (32, 1 << 18), (64, 1 << 17))
STRESS_PATHS, STRESS_STEPS, STRESS_GRID = 65536, 64, 5


def lmm_bench_model(k):
    from montecarlo_tpu_torch.processes import LMM

    return LMM.create([0.03] * k, [0.2] * k, 0.25, corr_beta=0.1)


def lmm_shapes(torch, card, checks):
    """The LMM at each of LMM_SHAPES: a warm run, a timed run (host
    clock, synchronised), a profiled run; the ZCB martingale and a caplet
    against Black at the shape.  Returns {K: updates/s}."""
    from montecarlo_tpu_torch.engine.simulate import simulate
    from montecarlo_tpu_torch.processes import lmm_caplet_mc, lmm_zcb0

    rates = {}
    for k, n in LMM_SHAPES:
        m = lmm_bench_model(k)

        def run(seed=0):
            return simulate(m, n, k, seed=seed,
                            observe=lambda p, s: p.exposure_obs(s))

        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = run(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        updates = n * k * (k - 1) // 2
        p_wall, busy, n_ops = busy_share(torch, lambda: run(2))
        rates[k] = updates / wall
        d = torch.exp(-obs[:, -1].double())
        se = float(d.std()) / math.sqrt(n)
        zcb, cf = float(d.mean()), lmm_zcb0(m, k)
        # tests/test_lmm.py's caplet gate: 2^17 paths in float64.
        cap = lmm_caplet_mc(m, k // 2, 0.03, 1 << 17, seed=3)
        log(f"  LMM K={k} paths 2^{n.bit_length() - 1}: {wall * 1e3:.1f} ms "
            f"a run, {rates[k]:.6e} live-forward updates/s; profiled "
            f"{p_wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
            f"({100 * busy / p_wall:.1f}%), {n_ops / k:.1f} device "
            f"operations a step; E[1/B(T_K)] {zcb:.8f} +- {se:.2e} vs "
            f"P(0, T_K) {cf:.8f}; caplet {cap['price']:.8f} +- "
            f"{cap['std_err']:.2e} vs Black {cap['black']:.8f}, on {card}")
        checks[f"LMM K={k}: E[1/B(T_K)] within 4 se + 2e-5 of P(0, T_K)"] = (
            abs(zcb - cf) < 4 * se + 2e-5)
        checks[f"LMM K={k}: caplet within 4 se + 2e-4 Black of Black"] = (
            abs(cap["price"] - cap["black"])
            < 4 * cap["std_err"] + 2e-4 * cap["black"])
    return rates


def item10_commands(torch, checks):
    """``bond --model lmm`` (four instruments), ``calibrate --model lmm``,
    ``price --process hybrid`` and Heston exposure's accrued variance,
    each against its oracle and launching no kernel."""
    from montecarlo_tpu_torch.engine.simulate import simulate
    from montecarlo_tpu_torch.processes import (
        HestonExposure, heston_varswap_expected_total)

    def quiet(label, argv):
        out, *_, c = measured_cli(torch, label, argv, profile=False)
        checks[f"{label}: no kernel launched"] = not any(c.values())
        return out

    zcb = quiet("bond --model lmm", ["bond", "--model", "lmm"])
    checks["LMM ZCB within 4 se + 1e-4 of the curve"] = (
        abs(zcb["zcb_price"] - zcb["closed_form"])
        < 4 * zcb["std_err"] + 1e-4)
    cap = quiet("bond --model lmm --caplet", ["bond", "--model", "lmm",
                                              "--caplet"])
    checks["LMM caplet within 4 se + 2e-3 Black of Black"] = (
        abs(cap["mc_price"] - cap["black_exact"])
        < 4 * cap["mc_std_err"] + 2e-3 * cap["black_exact"])
    eur = quiet("bond --model lmm --swaption --n-exercise 1",
                ["bond", "--model", "lmm", "--swaption", "--maturity", "3.0",
                 "--n-exercise", "1"])
    checks["LMM swaption within 4 se + 1% of Rebonato"] = (
        abs(eur["mc_price"] - eur["rebonato"])
        < 4 * eur["mc_std_err"] + 0.01 * eur["rebonato"])
    berm = quiet("bond --model lmm --swaption --n-exercise 4",
                 ["bond", "--model", "lmm", "--swaption", "--maturity",
                  "3.0", "--n-exercise", "4"])
    checks["LMM Bermudan >= the European - 4 se"] = (
        berm["bermudan_price"] >= berm["mc_price"] - 4 * berm["mc_std_err"])
    cal = quiet("calibrate --model lmm", ["calibrate", "--model", "lmm"])
    checks["calibrate --model lmm recovers beta and the vols"] = (
        abs(cal["corr_beta"] - 0.35) < 1e-3 and cal["vol_max_abs_err"] < 1e-9)
    hyb = quiet("price --process hybrid", ["price", "--process", "hybrid"])
    checks["hybrid call within 4 se of its closed form"] = (
        abs(hyb["price"] - hyb["closed_form"]) < 4 * hyb["std_err"])
    proc = HestonExposure.create(100.0, 0.09, 0.0, 2.0, 0.04, 0.3, -0.5,
                                 1 / 252)
    (ivar, _), wall, c = run_counted(lambda: (simulate(
        proc, 1 << 20, 252, seed=5, observe=lambda p, s: s.ivar), None))
    ivar = ivar.double()
    mean, se = float(ivar.mean()), float(ivar.std()) / math.sqrt(1 << 20)
    want = heston_varswap_expected_total(proc, 1.0)
    log(f"  HestonExposure 2^20 x 252: accrued variance {mean:.8f} +- "
        f"{se:.2e} vs the CIR expectation {want:.8f}; {wall:.3f} s")
    checks["Heston exposure's ivar within 4 se + 0.003 of E[int v]"] = (
        abs(mean - want) < 4 * se + 0.003 and not any(c.values()))


def stress_path(torch, checks):
    """``stress --process gbm|heston`` at the command's defaults, 34 K2
    launches each; the command's report and grid again on the kernel
    route and through the torch loop (``prefer_fused=False``) at the same
    shape, bitwise the same, and the command's JSON equal to the kernel
    route's; every GBM scenario within 4 std-err of Black-Scholes at its
    bumped (s0, sigma), the std-err the discounted call's exact standard
    deviation over the root of the path count.  Returns the commands' K2
    launches."""
    from montecarlo_tpu_torch.api import (ladder, standard_scenarios,
                                          stress_grid, stress_report)
    from montecarlo_tpu_torch.engine import black_scholes_call
    from montecarlo_tpu_torch.processes import GBM, Heston

    import numpy as np

    r, t, k, s0, sigma = 0.03, 1.0, 105.0, 100.0, 0.2
    disc = float(np.exp(-r * t))                        # as the command's
    dt = t / STRESS_STEPS
    ba = ladder(-0.2, 0.2, STRESS_GRID)
    bb = ladder(-0.5, 0.5, STRESS_GRID)
    call = lambda s: torch.clamp(s - k, min=0.0)
    k2 = 0
    for kind, proc, fields in (
            ("gbm", GBM.create(s0=s0, mu=r, sigma=sigma, dt=dt),
             ("s0", "sigma")),
            ("heston", Heston.create(s0=s0, v0=0.04, mu=r, kappa=2.0,
                                     theta=0.04, xi=0.5, rho=-0.7, dt=dt),
             ("s0", "v0"))):
        res, *_, c = measured_cli(
            torch, f"stress --process {kind}", ["stress", "--process", kind],
            profile=kind == "gbm")
        checks[f"stress --process {kind}: 34 K2 launches"] = (
            c["fused_terminal"] == 34
            and sum(c.values()) == c["fused_terminal"])
        checks[f"stress --process {kind}: base P&L exactly 0"] = (
            res["scenarios"]["base"]["pnl"] == 0.0)
        k2 += c["fused_terminal"]

        def both(**kw):
            return (stress_report(proc, call, STRESS_PATHS, STRESS_STEPS,
                                  seed=0, fields=fields, discount=disc, **kw),
                    stress_grid(proc, call, STRESS_PATHS, STRESS_STEPS,
                                bumps_a=ba, bumps_b=bb, seed=0,
                                fields=fields, discount=disc, **kw))

        (rep, grid), f_wall, fc = run_counted(both)
        (l_rep, l_grid), l_wall, lc = run_counted(both, prefer_fused=False)
        same = (all(rep["scenarios"][n]["price"]
                    == l_rep["scenarios"][n]["price"] for n in rep["scenarios"])
                and bool((grid["prices"] == l_grid["prices"]).all()))
        cli_same = (
            all(res["scenarios"][n]["price"] == rep["scenarios"][n]["price"]
                for n in rep["scenarios"])
            and res["grid"]["prices"] == grid["prices"].round(6).tolist())
        log(f"  stress {kind} at {STRESS_PATHS} x {STRESS_STEPS}, 9 named + "
            f"{STRESS_GRID ** 2} grid scenarios: kernel route "
            f"{f_wall:.3f} s ({fc['fused_terminal']} K2 launches), torch "
            f"loop {l_wall:.3f} s ({lc['fused_terminal']}); "
            f"{'bitwise' if same else 'NOT bitwise'} the same; the command's "
            f"JSON {'equal to' if cli_same else 'NOT'} the kernel route's")
        checks[f"stress {kind}: K2 route bitwise the torch loop at the "
               f"command's shape"] = (
            same and fc["fused_terminal"] == 34
            and lc["fused_terminal"] == 0)
        checks[f"stress {kind}: the command's JSON is the kernel route's"] = (
            cli_same)
        if kind != "gbm":
            continue
        named = standard_scenarios()
        scen = [(n, *named[n], row["price"])
                for n, row in rep["scenarios"].items()]
        scen += [(f"grid {a:+.1f} {b:+.2f}", a, b, float(grid["prices"][i, j]))
                 for i, a in enumerate(ba) for j, b in enumerate(bb)]
        worst = 0.0
        for n, a, b, price in scen:
            sp, vol = s0 * (1 + a), sigma * (1 + b)
            bs = float(black_scholes_call(sp, k, r, vol, t))
            se = disc * math.sqrt(bs_call_var(sp, k, r, vol, t)
                                  / STRESS_PATHS)
            worst = max(worst, abs(price - bs) / se)
            checks[f"stress gbm {n}: within 4 se of Black-Scholes"] = (
                abs(price - bs) < 4 * se + 1e-6)
        log(f"  stress gbm: every scenario against Black-Scholes, worst "
            f"|price - bs| / se {worst:.2f}")
    return k2


def bs_call_var(s0, k, r, sigma, t):
    """The variance of the undiscounted call payoff (S_T - k)+ under GBM:
    E[S^2; S > k] - 2k E[S; S > k] + k^2 P(S > k) - E[(S_T - k)+]^2."""
    ncdf = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))
    st = sigma * math.sqrt(t)
    d1 = (math.log(s0 / k) + (r + 0.5 * sigma * sigma) * t) / st
    d2 = d1 - st
    fwd = s0 * math.exp(r * t)
    mean = fwd * ncdf(d1) - k * ncdf(d2)
    second = (fwd * fwd * math.exp(sigma * sigma * t) * ncdf(d1 + st)
              - 2 * k * fwd * ncdf(d1) + k * k * ncdf(d2))
    return second - mean * mean


def phase_item10(torch, card):
    """Phase 18: the LMM, the hybrid, Heston exposure and ``stress``.
    Returns K2's launches (stress)."""
    checks = {}
    t0 = time.perf_counter()
    rates = lmm_shapes(torch, card, checks)
    t1 = time.perf_counter()
    item10_commands(torch, checks)
    t2 = time.perf_counter()
    k2 = stress_path(torch, checks)
    log(f"  phase 18: LMM shapes {t1 - t0:.1f} s, commands {t2 - t1:.1f} "
        f"s, stress {time.perf_counter() - t2:.1f} s; LMM updates/s "
        + ", ".join(f"K={k} {v:.6e}" for k, v in rates.items())
        + f", on {card}")
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"  {'ok' if ok else 'FAIL'}: {name}")
    if failed:
        raise AssertionError(f"phase 18 checks failed: {failed}")
    return k2


KERNELS = [
    ("gbm_terminal", "gbm_kernel.cu", "gbm_kernel.py:118"),
    ("fused_terminal", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals", "fused_k4.cu", "fused_engine.py:390"),
    ("fused_functionals_fixed", "fused_k4.cu", "fused_engine.py:390"),
    ("normal_matrix", "rng_kernel.cu", "rng_kernel.py:67"),
    ("rbergomi_terminal", "rbergomi_kernel.cu", "rbergomi_kernel.py:73"),
    ("rbergomi_terminal_unaligned", "rbergomi_kernel.cu",
     "rbergomi_kernel.py:73"),
    ("packed_basket_terminal", "basket_kernel.cu", "basket_kernel.py:131"),
    ("fused_terminal_basket", "fused_basket.cu", "fused_engine.py:231"),
    ("fused_block_moments_basket", "fused_basket_k3.cu",
     "fused_engine.py:478"),
    ("fused_functionals_basket", "fused_basket_k4.cu", "fused_engine.py:390"),
    ("fused_terminal_sobol", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments_sobol", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals_sobol", "fused_k4.cu", "fused_engine.py:390"),
    ("fused_functionals_fixed_sobol", "fused_k4.cu", "fused_engine.py:390"),
    ("fused_terminal_bridge", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments_bridge", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals_bridge", "fused_k4.cu", "fused_engine.py:390"),
    ("fused_functionals_fixed_bridge", "fused_k4.cu", "fused_engine.py:390"),
    ("fused_functionals_snapshot", "fused_k4_snapshot.cu",
     "fused_engine.py:390"),
    *((f"fused_terminal_{k}", "fused_engine.cu", "fused_engine.py:231")
      for k in JUMP_KINDS),
    ("fused_block_moments_merton", "fused_engine.cu", "fused_engine.py:478"),
    ("fused_functionals_kou", "fused_k4.cu", "fused_engine.py:390"),
    ("fused_terminal_local_vol", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_terminal_slv", "fused_engine.cu",
     "fused_engine.py:231 (KernelRows: fused_engine.py:44)"),
    ("fused_terminal_slv_knots", "fused_engine.cu", "fused_engine.py:231"),
    ("fused_block_moments_slv", "fused_engine.cu",
     "fused_engine.py:478 (KernelRows: fused_engine.py:44)"),
    ("fused_functionals_slv", "fused_k4.cu",
     "fused_engine.py:390 (KernelRows: fused_engine.py:44)"),
    ("surface_rows", "fused_engine.cu",
     "fused_engine.py:231 (the surfaces' time blend traced into K2-K4)"),
    ("fused_terminal_rates", "fused_rates.cu", "fused_engine.py:231"),
    ("fused_block_moments_rates", "fused_rates.cu", "fused_engine.py:478"),
    ("fused_functionals_rates", "fused_rates.cu", "fused_engine.py:390"),
    *((f"{name}_{STATE_KEY[kind]}",
       STATE_K4_UNIT.get(kind, STATE_UNIT[kind]) if name == "fused_functionals"
       else STATE_UNIT[kind], f"fused_engine.py:{line}")
      for kind in STATE_KINDS
      for name, line in (("fused_terminal", 231),
                         ("fused_block_moments", 478),
                         ("fused_functionals", 390))),
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
        path_counts = phase_path_dependent(torch, vanilla)
        for name in ("fused_functionals", "fused_functionals_fixed"):
            counts[name] = path_counts[name]
        log("phase 6: the rough-Bergomi path through the CLI")
        rb = phase_rbergomi(torch)
        for k in ("normal_matrix", "rbergomi_terminal",
                  "rbergomi_terminal_unaligned"):
            counts[k] = rb[k]
        log("phase 7: the multi-asset path (K7; K2-K4 on the basket)")
        t7 = time.perf_counter()
        phase_basket_parity(torch, errs, times)
        multi = phase_multi_asset(torch)
        # Only baskets launch K2 and K3 on the multi-asset path; its K4
        # basket launch is counted around its own call.
        for name in ("packed_basket_terminal", "fused_functionals_basket"):
            counts[name] = multi[name]
        for name in ("fused_terminal", "fused_block_moments"):
            counts[f"{name}_basket"] = multi[name]
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
            "(LocalVolProc and SlvProc on their rows; the row builder of "
            "the surfaces on knots)")
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
        log("phase 12: the sharded and streaming path on a one-rank NCCL "
            "mesh (K2, K4, K5, K6)")
        t12 = time.perf_counter()
        for name, n in phase_sharded(torch).items():
            if name in ("fused_terminal", "fused_functionals",
                        "fused_functionals_fixed", "normal_matrix",
                        "rbergomi_terminal"):
                counts[name] += n
        log(f"  phase 12 took {time.perf_counter() - t12:.1f} s, on {card}")
        log("phase 13: the short-rate and term-structure processes on "
            "K2-K4 (RateProc in fused_rates.cu); the bond path")
        t13 = time.perf_counter()
        phase_rate_parity(torch, errs)
        t_shapes = time.perf_counter()
        phase_rate_shapes(torch, errs, times)
        t_path = time.perf_counter()
        counts.update(phase_rate_path(torch, card))
        log(f"  phase 13: parity {t_shapes - t13:.1f} s, timed shapes "
            f"{t_path - t_shapes:.1f} s, bond path "
            f"{time.perf_counter() - t_path:.1f} s")
        log(f"  phase 13 took {time.perf_counter() - t13:.1f} s, on {card}")
        log("phase 14: the multi-asset state processes on K2-K4 "
            "(StateProc in fused_term_basket{,_k4}.cu, fused_ccc.cu, "
            "fused_dcc{,_k4}.cu); the term basket's pricing and the GARCH "
            "books' VaR")
        t14 = time.perf_counter()
        phase_state_parity(torch, errs)
        t_shapes = time.perf_counter()
        phase_state_shapes(torch, errs, times)
        t_path = time.perf_counter()
        counts.update(phase_state_path(torch, card))
        log(f"  phase 14: parity {t_shapes - t14:.1f} s, timed shapes "
            f"{t_path - t_shapes:.1f} s, path "
            f"{time.perf_counter() - t_path:.1f} s")
        log(f"  phase 14 took {time.perf_counter() - t14:.1f} s, on {card}")
        log("phase 15: greeks, variance reduction and the implied-vol "
            "surface (the snapshot kernel; K2)")
        t15 = time.perf_counter()
        phase_snapshot_parity(torch, errs)
        t_shapes = time.perf_counter()
        phase_snapshot_shapes(torch, errs, times)
        t_path = time.perf_counter()
        k2 = phase_greeks_path(torch, card)
        t_surf = time.perf_counter()
        counts["fused_functionals_snapshot"] = phase_iv_surface_path(
            torch, card)
        t_vr = time.perf_counter()
        k2 += phase_variance_reduction_path(torch, card)
        counts["fused_terminal"] += k2
        log(f"  phase 15: parity {t_shapes - t15:.1f} s, timed shapes "
            f"{t_path - t_shapes:.1f} s, greeks {t_surf - t_path:.1f} s, "
            f"surface {t_vr - t_surf:.1f} s, variance reduction "
            f"{time.perf_counter() - t_vr:.1f} s")
        log(f"  phase 15 took {time.perf_counter() - t15:.1f} s, on {card}")
        log("phase 16: calibration, multilevel Monte Carlo (level 0 on K2 "
            "and K4) and the gamma Newton sampler")
        t16 = time.perf_counter()
        mlmc_rows, _ = phase_calibration_mlmc(torch, card)
        for name, n in mlmc_rows.items():
            counts[name] += n
        log(f"  phase 16 took {time.perf_counter() - t16:.1f} s, on {card}")
        log("phase 17: American and Bermudan exercise (LSM, the "
            "Andersen-Broadie dual, policy-frozen greeks, the Vasicek "
            "Bermudan swaption, sharded LSM)")
        t17 = time.perf_counter()
        for name, n in phase_american(torch, card).items():
            if name in counts:
                counts[name] += n
        log(f"  phase 17 took {time.perf_counter() - t17:.1f} s, on {card}")
        log("phase 18: the LIBOR market model, the equity-Vasicek hybrid, "
            "Heston exposure and the stress command (K2)")
        t18 = time.perf_counter()
        counts["fused_terminal"] += phase_item10(torch, card)
        log(f"  phase 18 took {time.perf_counter() - t18:.1f} s, on {card}")
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
