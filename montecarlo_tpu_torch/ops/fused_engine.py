"""K2, K3 and K4: the process-generic fused time loop.

Port of ``montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas`` (K2),
``::fused_block_moments_pallas`` (K3) and ``::fused_functionals_pallas``
(K4); the kernels are templates over a process functor (GBM, Heston, the
correlated GBM basket of at most 128 assets, the bootstrap GARCH, Merton,
Kou, Bates, NIG, HestonQE, BatesQE, variance gamma, SABR, local volatility,
SLV with exact per-step leverage rows and SLV on leverage time knots, in
``csrc/fused_rates.cu`` Euler GBM, term-structure GBM, Vasicek, CIR,
Hull-White and G2++, and in ``csrc/fused_term_basket{,_k4}.cu``,
``csrc/fused_ccc.cu`` and ``csrc/fused_dcc{,_k4}.cu`` the multi-asset state
processes TermBasketGBM, CCC-GARCH and DCC-GARCH of 1 to
``MAX_STATE_ASSETS`` assets) and a draw source in
``csrc/fused_engine.cu``.  A process on per-step curves (term-structure
GBM, Hull-White, the term basket) reads them at the step index; a run of
more steps than its curves hold is refused before any launch
(``engine.simulate.check_steps``).  The exact-rows SLV reads its
step's row through a pointer and an offset, the port of the JAX kernels'
``KernelRows``.  A surface on hat-blended time knots (local vol, SLV on
knots) has its rows blended once, one per step, by the row builder
(:func:`surface_rows`, ``csrc/fused_engine.cu::blend_rows_kernel``), once
per (process, n_steps) for every launch that follows; its functor reads
them as the exact-rows SLV does (SLV on knots runs the exact-rows SLV's
functor, ``SlvProc``).  Draw sources (``sampler=``):

- ``None``: the process's own Threefry draws (its ``draws_pair``), two
  steps per set of cipher calls, the process's antithetic mirror (per
  draw: a normal negated, a uniform reflected) on odd ids when
  ``antithetic``;
- a :class:`~montecarlo_tpu_torch.rng.sobol.SobolDeviceSampler`
  (all-normal processes): the randomized Sobol normal of dimension ``t *
  n_draws + d``, computed in the kernel from the sampler's direction
  table;
- a :class:`~montecarlo_tpu_torch.rng.sobol.SobolBridgeKernelSampler`
  (single-draw processes): per step the plan's weighted sum of O(log T)
  bridge normals, one held per tree level in registers and each computed
  once per path (``csrc/bridge_levels.cuh``); no workspace.  A plan wider
  than ``MAX_BRIDGE_LEVELS`` levels (T > 2^15 steps) is refused
  (:func:`kernel_refusal`), and so is the bridge on the multi-asset state
  processes at any asset count, as the JAX package takes it for
  single-draw processes only.

The plain versions below run the process's own ``draws_pair``/``step``/
``prices`` (or the sampler's draws) in the kernel's order and agree with
the kernels bitwise where the platform's log/sqrt/sin/cos do.  A sampler
together with ``antithetic=True`` raises ``ValueError``, as in the JAX
package.

K3 applies a :class:`VanillaPayoff` in the kernel and writes (mean, M2) per
128-path row, summed in ``tree_sum``'s fixed order; the rows are merged
into 4096-path :class:`MomentState` blocks in torch, by the same pairwise
tree as the JAX package.

K4 folds path functionals after every step, each given by its device
form (``engine.functionals.DeviceForm``), and writes the terminal prices
plus each finalized functional; any number of them, as JAX's K4 takes,
in the launches of :func:`k4_launches`.  A launch folds up to
``MAX_FUNCTIONALS``.  The sets the main paths launch run a fold fixed at
compile time where the kernels are built for it (``csrc/functionals.cuh``'s
``FixedFolds``; ``FixedFor`` in ``csrc/fused_k4.cu``, ``fused_basket.cuh``,
``fused_rates.cu`` (the bond models' {trap}) and
``fused_term_basket_k4.cu`` (the term basket's {avg})); the others the
generic fold, the codes read at run time.  A set of price snapshots only
(``engine.surface.price_snapshot``) runs the snapshot kernel
(:func:`fused_snapshots`, ``csrc/fused_k4_snapshot.cu``), up to
``MAX_SNAPSHOTS`` a launch, on the functors and draw sources of
``SNAPSHOT_SOURCES``; elsewhere the generic fold.

Each wrapper counts its launches per draw source (``K2``, ``K2_SOBOL``,
``K2_BRIDGE``, ...; ``ops.PATH_KERNELS`` names them); K4's launches that
ran a fixed fold are counted again in ``K4_FIXED``, ``K4_FIXED_SOBOL`` and
``K4_FIXED_BRIDGE``; the snapshot kernel's in ``K4_SNAPSHOT``,
``K4_SNAPSHOT_SOBOL`` and ``K4_SNAPSHOT_BRIDGE`` (and not in K4's); the
row builder's in ``SURFACE_ROWS``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import NamedTuple

import torch

from montecarlo_tpu_torch.engine.functionals import (MAX_PARAMS,
                                                     SNAPSHOT_CODE,
                                                     functional_observables)
from montecarlo_tpu_torch.engine.payoffs import VanillaPayoff
from montecarlo_tpu_torch.engine.simulate import (check_sampler, check_steps,
                                                 path_ids_for)
from montecarlo_tpu_torch.ops._build import (CudaKernel, check_cuda_tensor,
                                             check_no_grad, cuda_stream)
from montecarlo_tpu_torch.processes import (CIR, G2PP, NIG, SABR, SLV,
                                            BasketGBM, Bates, BatesQE,
                                            CCCGarch, DCCGarch, EulerGBM,
                                            GARCHBootstrap, GBM, Heston,
                                            HestonQE, HullWhite, Kou,
                                            LocalVolGBM, Merton, SLVKnots,
                                            TermBasketGBM, TermStructureGBM,
                                            VarianceGamma, Vasicek)
from montecarlo_tpu_torch.processes.basket import kernel_assets_refusal
from montecarlo_tpu_torch.processes.local_vol import KNOTS, blend_rows
from montecarlo_tpu_torch.rng.normal import log32
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            SobolDeviceSampler)
from montecarlo_tpu_torch.rng.threefry import MASK32, key_from_seed
from montecarlo_tpu_torch.stats.welford import (MomentState, moments_reduce,
                                                tree_sum)

LANES = 128          # paths per stats row (K3's block)
STATS_BLOCK = 4096   # paths per MomentState block
MAX_FUNCTIONALS = 4  # K4's functional slots a launch (kMaxFunctionals)
MAX_SNAPSHOTS = 64   # the snapshot kernel's a launch (kMaxSnapshots)

#: The processes the kernels run, by the code of their functor
#: (csrc/fused_engine.cuh::ProcessCode): SLV on knots runs SLV's, on the
#: rows blended from its knots.
PROCESS_CODES = {GBM: 0, Heston: 1, BasketGBM: 2, GARCHBootstrap: 3,
                 Merton: 4, Kou: 5, Bates: 6, NIG: 7, HestonQE: 8,
                 BatesQE: 9, VarianceGamma: 10, SABR: 11, LocalVolGBM: 12,
                 SLV: 13, SLVKnots: 13, EulerGBM: 14, TermStructureGBM: 15,
                 Vasicek: 16, CIR: 17, HullWhite: 18, G2PP: 19,
                 TermBasketGBM: 20, CCCGarch: 21, DCCGarch: 22}
#: The multi-asset state processes and the most assets their functors
#: take (csrc/mgarch_steps.cuh::kMaxStateAssets: one instantiation per
#: asset count).  Above it ``kernel_route`` sends them to the torch loop.
STATE_PROCESSES = (TermBasketGBM, CCCGarch, DCCGarch)
MAX_STATE_ASSETS = 8
#: The processes whose kernels take their constants by value: the launch
#: copies :func:`state_launch_leaves`, a host array, into the kernel's
#: parameters (csrc/fused_mgarch.cuh::state_kernel).
BY_VALUE = (CCCGarch, DCCGarch)
#: The term basket's ``dims``: A + (curve length << CURVE_SHIFT)
#: (csrc/mgarch_steps.cuh::kCurveShift; A < 2^CURVE_SHIFT).
CURVE_SHIFT = 4
#: The surfaces on time knots, by the fields their functor's leaves hold
#: before the rows: LocalVolProc's [s0, rate, dt, x0, dx], and SlvProc's
#: for SLV on knots.
ROW_HEADS = {LocalVolGBM: ("s0", "rate", "dt", "x0", "dx"),
             SLVKnots: ("s0", "rate", "v0", "kappa", "theta", "xi", "rho",
                        "dt", "x0", "dx")}

#: Draw-source codes of the kernels (csrc/fused_engine.cuh::DrawSource).
THREEFRY, SOBOL, BRIDGE = 0, 1, 2
#: The functors and draw sources the snapshot kernel is built for
#: (csrc/fused_k4_snapshot.cu::kSnapshotBuilt): GBM under every source,
#: Heston under Threefry and Sobol, the other functors of
#: csrc/processes.cuh under Threefry.
SNAPSHOT_SOURCES = {
    GBM: (THREEFRY, SOBOL, BRIDGE), Heston: (THREEFRY, SOBOL),
    **{t: (THREEFRY,) for t in (GARCHBootstrap, Merton, Kou, Bates, NIG,
                                HestonQE, BatesQE, VarianceGamma, SABR,
                                LocalVolGBM, SLV, SLVKnots)}}
#: The widest bridge plan the kernels take: the tree levels whose normals a
#: path holds in registers (csrc/bridge_levels.cuh::kMaxLevels; T <= 2^15).
MAX_BRIDGE_LEVELS = 16

_COMMON = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
           ctypes.c_uint32,
           # source, antithetic, sv, plan coeffs, plan schedule, T, L
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
_K2_ARGS = _COMMON + [ctypes.c_void_p]
_K3_ARGS = _COMMON + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
# ... n_functionals, codes, periods, params, out_stride, the fixed fold
# index it ran (int*), the stream.
_K4_ARGS = _COMMON + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p]
K2 = CudaKernel("mc_fused_terminal", _K2_ARGS)
K3 = CudaKernel("mc_fused_block_moments", _K3_ARGS)
K4 = CudaKernel("mc_fused_functionals", _K4_ARGS)
# The same entries under Sobol and bridge-Sobol draws, counted apart.
K2_SOBOL = CudaKernel("mc_fused_terminal", _K2_ARGS)
K3_SOBOL = CudaKernel("mc_fused_block_moments", _K3_ARGS)
K4_SOBOL = CudaKernel("mc_fused_functionals", _K4_ARGS)
K2_BRIDGE = CudaKernel("mc_fused_terminal", _K2_ARGS)
K3_BRIDGE = CudaKernel("mc_fused_block_moments", _K3_ARGS)
K4_BRIDGE = CudaKernel("mc_fused_functionals", _K4_ARGS)
# K4's launches that ran a fixed fold, counted again (never launched
# through these).
K4_FIXED = CudaKernel("mc_fused_functionals", _K4_ARGS)
K4_FIXED_SOBOL = CudaKernel("mc_fused_functionals", _K4_ARGS)
K4_FIXED_BRIDGE = CudaKernel("mc_fused_functionals", _K4_ARGS)
# The snapshot kernel: ... n_snapshots, steps, rows, out_stride, the stream.
_SNAPSHOT_ARGS = _COMMON + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int64, ctypes.c_void_p]
K4_SNAPSHOT = CudaKernel("mc_fused_snapshots", _SNAPSHOT_ARGS)
K4_SNAPSHOT_SOBOL = CudaKernel("mc_fused_snapshots", _SNAPSHOT_ARGS)
K4_SNAPSHOT_BRIDGE = CudaKernel("mc_fused_snapshots", _SNAPSHOT_ARGS)
# rows, table, dt, dt_knot, n_tk, n_rows, stream
SURFACE_ROWS = CudaKernel("mc_surface_rows", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
_BY_SOURCE = {"K2": (K2, K2_SOBOL, K2_BRIDGE),
              "K3": (K3, K3_SOBOL, K3_BRIDGE),
              "K4": (K4, K4_SOBOL, K4_BRIDGE),
              "K4_FIXED": (K4_FIXED, K4_FIXED_SOBOL, K4_FIXED_BRIDGE),
              "K4_SNAPSHOT": (K4_SNAPSHOT, K4_SNAPSHOT_SOBOL,
                              K4_SNAPSHOT_BRIDGE)}


def _bridge_refusal(sampler) -> Exception | None:
    if (isinstance(sampler, SobolBridgeKernelSampler)
            and sampler.width > MAX_BRIDGE_LEVELS):
        return ValueError(
            f"the kernels' bridge holds at most {MAX_BRIDGE_LEVELS} tree "
            f"levels, this plan has {sampler.width} (T = "
            f"{sampler.n_steps}); run it on the torch loop")
    return None


def _state_refusal(process, sampler) -> Exception | None:
    name = type(process).__name__
    if not 1 <= process.n_assets <= MAX_STATE_ASSETS:
        return ValueError(
            f"the kernels' {name} takes 1 to at most {MAX_STATE_ASSETS} "
            f"assets, got {process.n_assets}; run it on the torch loop")
    if isinstance(sampler, SobolBridgeKernelSampler):
        return ValueError(f"the kernels run {name} under Threefry and Sobol "
                          "draws, not the bridge; run it on the torch loop")
    return None


def kernel_refusal(process, sampler=None) -> Exception | None:
    """Why K2-K4 do not run ``process`` under ``sampler``, as the error
    their wrappers raise (a type with no functor; a basket of more assets
    than the kernels take; a multi-asset state process of more than
    MAX_STATE_ASSETS assets, or under the bridge; a bridge plan wider than
    MAX_BRIDGE_LEVELS), or None when they run it.
    ``engine.dispatch.kernel_route`` asks it before it routes a run."""
    if type(process) not in PROCESS_CODES:
        others = ", ".join(c.__name__ for c in list(PROCESS_CODES)[2:])
        return TypeError("the fused kernels run GBM and Heston (and "
                         f"{others}) in this port, got "
                         f"{type(process).__name__}")
    if isinstance(process, BasketGBM):
        err = kernel_assets_refusal(process.n_draws)
    elif isinstance(process, STATE_PROCESSES):
        err = _state_refusal(process, sampler)
    else:
        err = None
    return err if err is not None else _bridge_refusal(sampler)


def _leaves(process):
    """(process code, dims, leaves): the float32 leaves in field order,
    flattened, as the kernel's functor reads them (GBM: [s0, mu, sigma,
    dt]; Heston: [s0, v0, mu, kappa, theta, xi, rho, dt]; basket: [s0 (A),
    mu (A), sigma (A), chol_flat (A*A), weights (A), dt]; GARCH: [s0,
    var0, omega, alpha, beta, table (n_table)]; Merton: [s0, mu, sigma,
    lam, jump_mean, jump_std, dt]; Kou: [s0, mu, sigma, lam, p_up, eta1,
    eta2, dt]; Bates: Heston's with [lam, jump_mean, jump_std] before dt;
    NIG: [s0, mu, alpha, beta, delta, dt]; HestonQE and BatesQE: Heston's
    and Bates's, then [e_kdt, c1, c2, k0, k1, k2, k3, k4, mgf_a]; VG: [s0,
    mu, sigma, theta, nu, dt, gq_z0, gq_dz, gq_resid (n), gq_dresid (n)],
    its launch adding the interleaved table;
    SABR: [f0, alpha, beta, nu, rho, dt]; Euler GBM: [s0, mu, sigma, dt];
    term-structure GBM: [s0, mu_t (n), sigma_t (n), dt]; Vasicek and CIR:
    [r0, kappa, theta, sigma, dt]; Hull-White: [r0, a, sigma, theta_t (n),
    dt]; G2++: [phi, a, sigma, b, eta, rho, dt]; local vol: [s0, rate, dt, x0, dx,
    dt_knot, vol_flat (n_tk * 128)]; SLV: [s0, rate, v0, kappa, theta, xi,
    rho, dt, x0, dx, lev_rows (n_rows * 128)]; SLV on knots: SLV's up to
    dx, then [dt_knot, lev_flat (n_tk * 128)]; the term basket: [s0 (A),
    mu_t (A * n, a row an asset), sigma_t (A * n), chol_flat (A * A), weights
    (A), dt]; CCC-GARCH: [s0, var0, omega, alpha, beta (A each), chol_flat
    (A * A), weights (A)]; DCC-GARCH: [s0, var0, omega, alpha, beta (A
    each), qbar_flat (A * A), a_dcc, b_dcc, weights (A)]), and ``dims`` the
    basket's A, GARCH's table length, VG's table length n, the local-vol
    surfaces' time-knot count n_tk, SLV's row count n_rows, the curve
    length n of term-structure GBM and Hull-White, CCC's and DCC's A or
    the term basket's A + (n << CURVE_SHIFT), an integer that never passes
    through a float.  A launch on a surface on time knots or on VG
    takes :func:`_launch_leaves`' instead."""
    err = kernel_refusal(process)
    if err is not None:
        raise err
    code = PROCESS_CODES[type(process)]
    dims = process.n_draws
    if isinstance(process, GARCHBootstrap):
        dims = process.table.numel()
    elif isinstance(process, VarianceGamma):
        dims = process.gq_resid.numel()
    elif isinstance(process, (LocalVolGBM, SLVKnots)):
        dims = process.n_time_knots
    elif isinstance(process, SLV):
        dims = process.lev_rows.shape[0]
    elif isinstance(process, (TermStructureGBM, HullWhite)):
        dims = process.max_steps
    elif isinstance(process, TermBasketGBM):
        dims = process.n_assets + (process.max_steps << CURVE_SHIFT)
    fields = [getattr(process, f.name) for f in dataclasses.fields(process)]
    return code, dims, torch.cat([v.reshape(-1) for v in fields
                                  if v.is_floating_point()])


def surface_rows(table: torch.Tensor, n_rows: int, dt: torch.Tensor,
                 dt_knot: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The (n_rows, 128) float32 rows of steps 0 .. n_rows - 1 of a
    surface on time knots, ``table`` its (n_tk * 128,) knots row-major,
    ``dt`` and ``dt_knot`` its 0-d float32 leaves: the row builder
    (``csrc/fused_engine.cu::blend_rows_kernel``) on a CUDA table, the
    plain version ``blend_rows(table, range(n_rows), dt, dt_knot)`` on a
    CPU one; written into ``out`` ((n_rows * 128,) float32) when given.
    The kernel refuses fewer than 2 time knots."""
    dev = table.device
    if dev.type == "cpu":
        rows = blend_rows(table.reshape(-1, KNOTS), list(range(n_rows)), dt,
                          dt_knot)
        return rows if out is None else out.copy_(rows.reshape(out.shape))
    for name, t in (("table", table), ("dt", dt), ("dt_knot", dt_knot)):
        check_cuda_tensor(name, t, dev, torch.float32)
    if out is None:
        out = torch.empty((n_rows, KNOTS), dtype=torch.float32, device=dev)
    check_cuda_tensor("out", out, dev, torch.float32)
    if out.numel() != n_rows * KNOTS:
        raise ValueError(f"out holds {out.numel()} floats, not "
                         f"{n_rows} x {KNOTS}")
    with torch.cuda.device(dev):
        SURFACE_ROWS.launch(out.data_ptr(), table.data_ptr(), dt.data_ptr(),
                            dt_knot.data_ptr(), table.numel() // KNOTS,
                            n_rows, cuda_stream(dev))
    return out


#: The launch leaves of the surfaces on time knots, built once per
#: (process, n_steps), and of variance gamma and the by-value processes,
#: built once per process: id(process) -> (a weak reference to it, n_steps,
#: (dims, leaves)); an entry goes with its process.
_ROW_LEAVES: dict = {}


def state_launch_leaves(process) -> torch.Tensor:
    """CCC's or DCC's launch leaves, float32 on the process's device, in
    the field order of their kernels' constants (csrc/mgarch_steps.cuh::
    CccLeaves, DccLeaves): ``_leaves``' own with s0 replaced by
    ``log32(s0)``, the plain ``init_state``'s, and for DCC ``((1 - a_dcc) -
    b_dcc) * qbar_flat`` after them, the plain step's ``c_d *
    qbar_flat[i * A + j]``: each by the plain versions' own float32
    operations, so the kernels start and recur on the same bits."""
    _, _, leaves = _leaves(process)
    parts = [log32(process.s0), leaves[process.n_assets:]]
    if isinstance(process, DCCGarch):
        c_d = (1.0 - process.a_dcc) - process.b_dcc
        parts.append(c_d * process.qbar_flat)
    return torch.cat(parts)


def vg_quad_table(process: VarianceGamma) -> torch.Tensor:
    """VG's quantile table interleaved by interval, as ``VgProc`` reads it
    (``csrc/rng.cuh::gamma_from_uniforms_quad32``): (resid[i], resid[i +
    1], dresid[i], dresid[i + 1]) for i < n - 1, flattened; the same
    floats as ``gq_resid`` and ``gq_dresid``."""
    r, d = process.gq_resid, process.gq_dresid
    return torch.stack([r[:-1], r[1:], d[:-1], d[1:]], 1).reshape(-1)


def _launch_leaves(process, n_steps: int, dims: int, leaves):
    """(dims, leaves) of a launch of ``n_steps`` steps on the card:
    ``_leaves``' own; for variance gamma those, zeros to a multiple of 4
    floats and :func:`vg_quad_table` (on 16 bytes, for ``VgProc``'s
    16-byte loads); for a surface on time knots (``ROW_HEADS``) its head
    leaves and then its rows of steps 0 .. max(n_steps, 1) - 1 from
    :func:`surface_rows`, with dims the row count; for CCC and DCC
    (``BY_VALUE``) :func:`state_launch_leaves` copied to the host.  Those
    are built on the first launch of a (process, n_steps), or of the
    process for VG, CCC and DCC, and kept for the launches after it (a
    ``price_to_tolerance`` run's chunks, a VaR's); a process's leaves are
    fixed once it is made."""
    dev = process.device
    head = ROW_HEADS.get(type(process))
    vg = isinstance(process, VarianceGamma)
    by_value = isinstance(process, BY_VALUE)
    if head is None:
        check_cuda_tensor("leaves", leaves, dev, torch.float32)
        if not (vg or by_value):
            return dims, leaves
    key = id(process)
    hit = _ROW_LEAVES.get(key)
    if (hit is not None and hit[0]() is process
            and (vg or by_value or hit[1] == n_steps)):
        return hit[2]
    if by_value:
        out = state_launch_leaves(process).cpu()
    elif vg:
        out = torch.cat([leaves, leaves.new_zeros(-leaves.numel() % 4),
                         vg_quad_table(process)])
        if out.data_ptr() % 16:
            raise ValueError("VG's launch leaves must start on 16 bytes")
    else:
        dims = max(n_steps, 1)
        out = torch.empty(len(head) + dims * KNOTS, dtype=torch.float32,
                          device=dev)
        out[:len(head)] = torch.stack([getattr(process, f) for f in head])
        table = (process.vol_flat if isinstance(process, LocalVolGBM)
                 else process.lev_flat)
        surface_rows(table, dims, process.dt, process.dt_knot,
                     out=out[len(head):])
    ref = weakref.ref(process, lambda _, k=key: _ROW_LEAVES.pop(k, None))
    _ROW_LEAVES[key] = (ref, n_steps, (dims, out))
    return dims, out


def draw_source(sampler, antithetic: bool = False) -> int:
    """The kernels' draw-source code for ``sampler`` (None, a
    SobolDeviceSampler or a SobolBridgeKernelSampler)."""
    if sampler is None:
        return THREEFRY
    if antithetic:
        raise ValueError("antithetic composes with the default draws only")
    if isinstance(sampler, SobolDeviceSampler):
        return SOBOL
    if isinstance(sampler, SobolBridgeKernelSampler):
        return BRIDGE
    raise TypeError("the kernels draw from Threefry, a SobolDeviceSampler "
                    "or a SobolBridgeKernelSampler, got "
                    f"{type(sampler).__name__}; use engine.simulate")


def _check_draws(process, sampler, n_steps: int, antithetic: bool) -> int:
    check_no_grad(process)
    source = draw_source(sampler, antithetic)
    err = kernel_refusal(process, sampler)
    if err is not None:
        raise err
    check_sampler(sampler, process, n_steps)
    check_steps(process, n_steps)
    return source


def _step_draws(process, n_steps: int, k0: int, k1: int, ids,
                antithetic: bool, sampler=None):
    """(t, eps) for each step t = 0 .. n_steps - 1, in the kernels' order:
    Threefry draws one ``draws_pair`` per pair of steps (mirrored on odd
    ids when antithetic) and never takes the odd final step; a
    SobolDeviceSampler draws each step from its table; a
    SobolBridgeKernelSampler computes the T bridge normals once, then sums
    each step's padded plan row in order from 0."""
    if isinstance(sampler, SobolDeviceSampler):
        for t in range(n_steps):
            yield t, sampler.draws(process, k0, k1, ids, t)
        return
    if isinstance(sampler, SobolBridgeKernelSampler):
        z = sampler.bridge_normals(k0, k1, ids)
        plan = sampler.dims[:n_steps].tolist()
        for t in range(n_steps):
            eps = torch.zeros_like(z[0])
            for j, dim in enumerate(plan[t]):
                eps = eps + sampler.coeffs[t, j] * z[dim]
            yield t, (eps,)
        return
    draw_ids = ids >> 1 if antithetic else ids
    odd = (ids & 1).to(torch.bool)

    def mirror(eps):
        return tuple(torch.where(odd, m, e)
                     for m, e in zip(process.antithetic(eps), eps))

    for j in range((n_steps + 1) // 2):
        eps0, eps1 = process.draws_pair(k0, k1, draw_ids, j)
        if antithetic:
            eps0, eps1 = mirror(eps0), mirror(eps1)
        yield 2 * j, eps0
        if 2 * j + 1 < n_steps:  # odd final step: never taken
            yield 2 * j + 1, eps1


def fused_terminal_reference(process, n_paths: int, n_steps: int, *, seed,
                             stream=0, path_offset=0,
                             antithetic: bool = False,
                             sampler=None) -> torch.Tensor:
    """The plain PyTorch version of K2 (any process with the protocol)."""
    _check_draws(process, sampler, n_steps, antithetic)
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, process.device)
    state = process.init_state(ids)
    for t, eps in _step_draws(process, n_steps, k0, k1, ids, antithetic,
                              sampler):
        state = process.step(state, eps, t)
    return process.prices(state)


def _row_moments(pay: torch.Tensor) -> torch.Tensor:
    """(n/128, 2) per-row (mean, M2), summed in tree_sum's order."""
    pay = pay.reshape(-1, LANES)
    mean = tree_sum(pay, axis=1) / LANES
    d = pay - mean[:, None]
    return torch.stack([mean, tree_sum(d * d, axis=1)], dim=1)


def _merge_rows(rows: torch.Tensor) -> MomentState:
    """Tree-merge 128-path row states into 4096-path block states."""
    per = STATS_BLOCK // LANES
    mean = rows[:, 0].reshape(-1, per).T
    m2 = rows[:, 1].reshape(-1, per).T
    count = torch.full_like(mean, float(LANES))
    return moments_reduce(MomentState(count=count, mean=mean, m2=m2))


def _check_block_args(payoff, n_paths: int) -> None:
    if not isinstance(payoff, VanillaPayoff):
        raise TypeError("K3 evaluates a VanillaPayoff; run other payoffs "
                        "through fused_terminal")
    if n_paths < 1 or n_paths % STATS_BLOCK:
        raise ValueError(f"n_paths={n_paths} must be a positive multiple "
                         f"of {STATS_BLOCK}")


def fused_block_moments_reference(process, payoff: VanillaPayoff,
                                  n_paths: int, n_steps: int, *, seed,
                                  stream=0, path_offset=0,
                                  antithetic: bool = False,
                                  sampler=None) -> MomentState:
    """The plain PyTorch version of K3 plus the row merge."""
    _check_block_args(payoff, n_paths)
    prices = fused_terminal_reference(
        process, n_paths, n_steps, seed=seed, stream=stream,
        path_offset=path_offset, antithetic=antithetic, sampler=sampler)
    return _merge_rows(_row_moments(payoff(prices)))


def _draw_args(process, sampler, source: int, antithetic: bool) -> list:
    """The kernels' draw-source arguments (source, antithetic, sv, plan
    coeffs, plan schedule, T, L), pointers into the sampler's tables, each
    checked to lie on the process's device."""
    dev = process.device
    if source == THREEFRY:
        return [source, int(antithetic), None, None, None, 0, 0]
    check_cuda_tensor("sampler.sv", sampler.sv, dev, torch.int32)
    if source == SOBOL:
        return [source, 0, sampler.sv.data_ptr(), None, None, 0, 0]
    check_cuda_tensor("sampler.coeffs", sampler.coeffs, dev, torch.float32)
    check_cuda_tensor("sampler.schedule", sampler.schedule, dev, torch.int32)
    return [source, 0, sampler.sv.data_ptr(), sampler.coeffs.data_ptr(),
            sampler.schedule.data_ptr(), sampler.n_steps, sampler.width]


def fused_terminal(process, n_paths: int, n_steps: int, *, seed, stream=0,
                   path_offset=0, antithetic: bool = False,
                   sampler=None) -> torch.Tensor:
    """Terminal prices (n_paths,) float32: K2 on a CUDA process, the plain
    version on a CPU one.  Any ``n_paths >= 1``; the kernel masks the
    ragged edge.  ``sampler``: None (Threefry), a SobolDeviceSampler or a
    SobolBridgeKernelSampler."""
    code, dims, leaves = _leaves(process)
    source = _check_draws(process, sampler, n_steps, antithetic)
    dev = process.device
    if dev.type == "cpu":
        return fused_terminal_reference(
            process, n_paths, n_steps, seed=seed, stream=stream,
            path_offset=path_offset, antithetic=antithetic, sampler=sampler)
    if n_paths < 1 or n_steps < 0:
        raise ValueError(f"n_paths={n_paths}, n_steps={n_steps}")
    draw = _draw_args(process, sampler, source, antithetic)
    dims, leaves = _launch_leaves(process, n_steps, dims, leaves)
    out = torch.empty(n_paths, dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        _BY_SOURCE["K2"][source].launch(
            out.data_ptr(), leaves.data_ptr(), code, dims, n_paths, n_steps,
            int(path_offset) & MASK32, k0, k1, *draw, cuda_stream(dev))
    return out


def fused_block_moments(process, payoff: VanillaPayoff, n_paths: int,
                        n_steps: int, *, seed, stream=0, path_offset=0,
                        antithetic: bool = False,
                        sampler=None) -> MomentState:
    """Per-4096-path-block payoff moments with the terminal prices never
    leaving the kernel: K3 on a CUDA process, the plain version on a CPU
    one.  Returns a MomentState with leaves shaped (n_paths // 4096,).
    ``sampler`` as in :func:`fused_terminal`."""
    code, dims, leaves = _leaves(process)
    source = _check_draws(process, sampler, n_steps, antithetic)
    dev = process.device
    if dev.type == "cpu":
        return fused_block_moments_reference(
            process, payoff, n_paths, n_steps, seed=seed, stream=stream,
            path_offset=path_offset, antithetic=antithetic, sampler=sampler)
    _check_block_args(payoff, n_paths)
    if n_steps < 0:
        raise ValueError(f"n_steps={n_steps}")
    draw = _draw_args(process, sampler, source, antithetic)
    dims, leaves = _launch_leaves(process, n_steps, dims, leaves)
    rows = torch.empty((n_paths // LANES, 2), dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        _BY_SOURCE["K3"][source].launch(
            rows.data_ptr(), leaves.data_ptr(), code, dims, n_paths, n_steps,
            int(path_offset) & MASK32, k0, k1, *draw, payoff.code,
            payoff.strike, cuda_stream(dev))
    return _merge_rows(rows)


def _device_forms(items, n_steps: int):
    """The K4 device form of each (name, functional); raises TypeError for
    a functional that has none."""
    forms = []
    for name, f in items:
        if f.device is None:
            raise TypeError(f"functional {name!r} has no device form: run it "
                            "with simulate_functionals(..., "
                            "prefer_fused=False)")
        form = f.device(n_steps)
        if len(form.params) > MAX_PARAMS:
            raise ValueError(f"functional {name!r}: more than {MAX_PARAMS} "
                             "parameters")
        forms.append(form)
    return forms


def fused_functionals_reference(process, n_paths: int, n_steps: int, *,
                                seed, functionals, stream=0, path_offset=0,
                                antithetic: bool = False,
                                sampler=None) -> dict:
    """The plain PyTorch version of K4: the functionals' own torch folds,
    any number of them, one update after every step with its 1-based
    index, over the kernels' draws (:func:`_step_draws`)."""
    items = tuple(functionals.items())
    _leaves(process)
    _device_forms(items, n_steps)
    _check_draws(process, sampler, n_steps, antithetic)
    fns = [f for _, f in items]
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, process.device)
    state = process.init_state(ids)
    accs = [f.init(o) for f, o in
            zip(fns, functional_observables(process, state, fns))]
    for t, eps in _step_draws(process, n_steps, k0, k1, ids, antithetic,
                              sampler):
        state = process.step(state, eps, t)
        obs = functional_observables(process, state, fns)
        accs = [f.update(a, o, t + 1) for f, a, o in zip(fns, accs, obs)]
    out = {"terminal": process.prices(state)}
    for (name, f), a in zip(items, accs):
        out[name] = f.finalize(a, float(n_steps))
    return out


def _check_snapshots(process, steps, source: int) -> None:
    if len(steps) > MAX_SNAPSHOTS:
        raise ValueError(f"the snapshot kernel takes at most {MAX_SNAPSHOTS} "
                         f"snapshots a launch, got {len(steps)}")
    if min(steps, default=0) < 0:
        raise ValueError(f"snapshot steps must be >= 0, got {list(steps)}")
    if source not in SNAPSHOT_SOURCES.get(type(process), ()):
        raise ValueError(
            f"the snapshot kernel is not built for {type(process).__name__} "
            f"under draw source {source}; its snapshots run on K4's "
            "generic fold (k4_launches)")


def fused_snapshots_reference(process, n_paths: int, n_steps: int, steps, *,
                              seed, stream=0, path_offset=0,
                              antithetic: bool = False,
                              sampler=None) -> torch.Tensor:
    """The plain PyTorch version of the snapshot kernel: (1 + len(steps),
    n_paths) float32, row 0 the terminal prices and row k + 1 the price
    after ``steps[k]`` steps (step 0 the spot; 0 for a step past
    ``n_steps``), the price taken only at a latched step, over the
    kernels' draws (:func:`_step_draws`)."""
    _leaves(process)
    source = _check_draws(process, sampler, n_steps, antithetic)
    _check_snapshots(process, steps, source)
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, process.device)
    state = process.init_state(ids)
    out = torch.zeros((1 + len(steps), n_paths), dtype=torch.float32,
                      device=process.device)
    rows = {}
    for k, s in enumerate(steps):
        rows.setdefault(int(s), []).append(k + 1)

    def latch(t):
        if t in rows:
            out[rows[t]] = process.prices(state)

    latch(0)
    for t, eps in _step_draws(process, n_steps, k0, k1, ids, antithetic,
                              sampler):
        state = process.step(state, eps, t)
        latch(t + 1)
    out[0] = process.prices(state)
    return out


def fused_snapshots(process, n_paths: int, n_steps: int, steps, *, seed,
                    stream=0, path_offset=0, antithetic: bool = False,
                    sampler=None) -> torch.Tensor:
    """The prices after each of ``steps`` (at most ``MAX_SNAPSHOTS``, any
    order and repeats) in one run of ``n_steps``: (1 + len(steps),
    n_paths) float32, row 0 the terminal prices, row k + 1 the price after
    ``steps[k]`` steps (0: the spot; 0 past ``n_steps``).  The snapshot
    kernel (``csrc/fused_k4_snapshot.cu``) on a CUDA process, its plain
    version on a CPU one; for the functors and sources of
    ``SNAPSHOT_SOURCES`` only.  ``sampler`` as in :func:`fused_terminal`."""
    code, dims, leaves = _leaves(process)
    source = _check_draws(process, sampler, n_steps, antithetic)
    steps = [int(s) for s in steps]
    _check_snapshots(process, steps, source)
    dev = process.device
    if dev.type == "cpu":
        return fused_snapshots_reference(
            process, n_paths, n_steps, steps, seed=seed, stream=stream,
            path_offset=path_offset, antithetic=antithetic, sampler=sampler)
    if n_paths < 1 or n_steps < 0:
        raise ValueError(f"n_paths={n_paths}, n_steps={n_steps}")
    draw = _draw_args(process, sampler, source, antithetic)
    dims, leaves = _launch_leaves(process, n_steps, dims, leaves)
    out = torch.empty((1 + len(steps), n_paths), dtype=torch.float32,
                      device=dev)
    # The plan, sorted by step: each step (one past the last for any
    # later: never latched, written 0) and its output row less one.
    order = sorted(range(len(steps)), key=lambda k: steps[k])
    n = len(steps)
    plan_steps = (ctypes.c_int * max(n, 1))(
        *[min(steps[k], n_steps + 1) for k in order])
    plan_rows = (ctypes.c_int * max(n, 1))(*order)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        _BY_SOURCE["K4_SNAPSHOT"][source].launch(
            out.data_ptr(), leaves.data_ptr(), code, dims, n_paths, n_steps,
            int(path_offset) & MASK32, k0, k1, *draw, n, plan_steps,
            plan_rows, n_paths, cuda_stream(dev))
    return out


class K4Launch(NamedTuple):
    """One launch of a functional set: the snapshot kernel or K4's fold,
    its time loop's steps, and the set's entries it folds, in its output
    rows' order."""

    snapshot: bool
    n_steps: int
    items: tuple


def k4_launches(process, source: int, forms, n_steps: int) -> list:
    """The launches that fold the device forms ``forms`` over a run of
    ``n_steps`` (draw source ``source``), the run's terminal the last
    one's.  A set of snapshots only is sorted by step and split by the
    capacity of the kernel that takes it, the snapshot kernel's
    ``MAX_SNAPSHOTS`` where ``SNAPSHOT_SOURCES`` has the functor and
    source, else the generic fold's ``MAX_FUNCTIONALS``; each launch but
    the last runs to its own last step.  Any other set runs K4 in launches
    of ``MAX_FUNCTIONALS``, each over the whole run.  The draws are keyed
    by (path, step), so the launches give the bits of one run."""
    if not forms or any(f.code != SNAPSHOT_CODE for f in forms):
        chunks = [tuple(range(k, min(k + MAX_FUNCTIONALS, len(forms))))
                  for k in range(0, len(forms), MAX_FUNCTIONALS)] or [()]
        return [K4Launch(False, n_steps, c) for c in chunks]
    kernel = source in SNAPSHOT_SOURCES.get(type(process), ())
    cap = MAX_SNAPSHOTS if kernel else MAX_FUNCTIONALS
    order = sorted(range(len(forms)), key=lambda k: forms[k].period)
    chunks = [tuple(order[k:k + cap]) for k in range(0, len(order), cap)]
    return [K4Launch(kernel, n_steps if j == len(chunks) - 1
                     else min(n_steps, forms[c[-1]].period), c)
            for j, c in enumerate(chunks)]


def _fold_launch(process, n_paths: int, n_steps: int, items, forms, *,
                 seed, stream, path_offset, antithetic, sampler) -> dict:
    """One launch of K4's fold over at most ``MAX_FUNCTIONALS`` items."""
    code, dims, leaves = _leaves(process)
    source = draw_source(sampler, antithetic)
    dev = process.device
    draw = _draw_args(process, sampler, source, antithetic)
    dims, leaves = _launch_leaves(process, n_steps, dims, leaves)
    out = torch.empty((1 + len(forms), n_paths), dtype=torch.float32,
                      device=dev)
    codes = (ctypes.c_int * MAX_FUNCTIONALS)(*[f.code for f in forms])
    periods = (ctypes.c_int * MAX_FUNCTIONALS)(*[f.period for f in forms])
    params = (ctypes.c_float * (MAX_FUNCTIONALS * MAX_PARAMS))()
    for k, f in enumerate(forms):
        for q, v in enumerate(f.params):
            params[k * MAX_PARAMS + q] = v
    k0, k1 = key_from_seed(seed, stream)
    fixed = ctypes.c_int(-1)  # the FixedFolds index of the fold it ran
    with torch.cuda.device(dev):
        _BY_SOURCE["K4"][source].launch(
            out.data_ptr(), leaves.data_ptr(), code, dims, n_paths, n_steps,
            int(path_offset) & MASK32, k0, k1, *draw, len(forms), codes,
            periods, params, n_paths, ctypes.byref(fixed), cuda_stream(dev))
    if fixed.value >= 0:
        _BY_SOURCE["K4_FIXED"][source].launches += 1
    result = {"terminal": out[0]}
    for k, (name, _) in enumerate(items):
        result[name] = out[k + 1]
    return result


def fused_functionals(process, n_paths: int, n_steps: int, *, seed,
                      functionals, stream=0, path_offset=0,
                      antithetic: bool = False, sampler=None) -> dict:
    """Terminal prices plus named path functionals, ``{"terminal": ...,
    name: ...}``, each (n_paths,) float32: the launches of
    :func:`k4_launches` (K4's fold or the snapshot kernel) on a CUDA
    process, each one's plain version on a CPU one.  ``functionals`` maps
    names to :class:`PathFunctional` s with a device form, any number of
    them.  Any ``n_paths >= 1``; the kernels mask the ragged edge.
    ``sampler`` as in :func:`fused_terminal`."""
    items = tuple(functionals.items())
    _leaves(process)
    forms = _device_forms(items, n_steps)
    source = _check_draws(process, sampler, n_steps, antithetic)
    cpu = process.device.type == "cpu"
    if not cpu and (n_paths < 1 or n_steps < 0):
        raise ValueError(f"n_paths={n_paths}, n_steps={n_steps}")
    kw = dict(seed=seed, stream=stream, path_offset=path_offset,
              antithetic=antithetic, sampler=sampler)
    result = {}
    for launch in k4_launches(process, source, forms, n_steps):
        sub = [items[k] for k in launch.items]
        if launch.snapshot:
            rows = fused_snapshots(process, n_paths, launch.n_steps,
                                   [forms[k].period for k in launch.items],
                                   **kw)
            got = {"terminal": rows[0]}
            got.update((name, rows[j + 1]) for j, (name, _) in enumerate(sub))
        elif cpu:
            got = fused_functionals_reference(
                process, n_paths, launch.n_steps, functionals=dict(sub), **kw)
        else:
            got = _fold_launch(process, n_paths, launch.n_steps, sub,
                               [forms[k] for k in launch.items], **kw)
        result.update(got)  # the last launch's terminal: the whole run's
    return {"terminal": result["terminal"],
            **{name: result[name] for name, _ in items}}
