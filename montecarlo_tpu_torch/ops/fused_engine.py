"""K2, K3 and K4: the process-generic fused time loop.

Port of ``montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas`` (K2),
``::fused_block_moments_pallas`` (K3) and ``::fused_functionals_pallas``
(K4); the kernels are templates over a process functor (GBM, Heston, the
correlated GBM basket of at most 128 assets, the bootstrap GARCH, Merton,
Kou, Bates, NIG, HestonQE, BatesQE, variance gamma, SABR, local volatility,
SLV with exact per-step leverage rows and SLV on leverage time knots) and a
draw source in ``csrc/fused_engine.cu``.  The exact-rows SLV reads its
step's row through a pointer and an offset, the port of the JAX kernels'
``KernelRows``.  Draw sources (``sampler=``):

- ``None``: the process's own Threefry draws (its ``draws_pair``), two
  steps per set of cipher calls, the process's antithetic mirror (per
  draw: a normal negated, a uniform reflected) on odd ids when
  ``antithetic``;
- a :class:`~montecarlo_tpu_torch.rng.sobol.SobolDeviceSampler`
  (all-normal processes): the randomized Sobol normal of dimension ``t *
  n_draws + d``, computed in the kernel from the sampler's direction
  table;
- a :class:`~montecarlo_tpu_torch.rng.sobol.SobolBridgeKernelSampler`
  (single-draw processes): the T bridge normals once per path into a
  scratch, then per step the plan's weighted sum of O(log T) of them.  The
  scratch is a global workspace, a launch per ``BRIDGE_WORKSPACE_PATHS``
  paths.

The plain versions below run the process's own ``draws_pair``/``step``/
``prices`` (or the sampler's draws) in the kernel's order and agree with
the kernels bitwise where the platform's log/sqrt/sin/cos do.  A sampler
together with ``antithetic=True`` raises ``ValueError``, as in the JAX
package.

K3 applies a :class:`VanillaPayoff` in the kernel and writes (mean, M2) per
128-path row, summed in ``tree_sum``'s fixed order; the rows are merged
into 4096-path :class:`MomentState` blocks in torch, by the same pairwise
tree as the JAX package.

K4 folds up to four path functionals after every step, each given by its
device form (``engine.functionals.DeviceForm``), and writes the terminal
prices plus each finalized functional.

Each wrapper counts its launches per draw source (``K2``, ``K2_SOBOL``,
``K2_BRIDGE``, ...; ``ops.PATH_KERNELS`` names them).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from montecarlo_tpu_torch.engine.functionals import (MAX_PARAMS,
                                                     functional_observables)
from montecarlo_tpu_torch.engine.payoffs import VanillaPayoff
from montecarlo_tpu_torch.engine.simulate import check_sampler, path_ids_for
from montecarlo_tpu_torch.ops._build import (CudaKernel, check_cuda_tensor,
                                             cuda_stream)
from montecarlo_tpu_torch.processes import (NIG, SABR, SLV, BasketGBM,
                                            Bates, BatesQE, GARCHBootstrap,
                                            GBM, Heston, HestonQE, Kou,
                                            LocalVolGBM, Merton, SLVKnots,
                                            VarianceGamma)
from montecarlo_tpu_torch.processes.basket import check_kernel_assets
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            SobolDeviceSampler)
from montecarlo_tpu_torch.rng.threefry import MASK32, key_from_seed
from montecarlo_tpu_torch.stats.welford import (MomentState, moments_reduce,
                                                tree_sum)

LANES = 128          # paths per stats row (K3's block)
STATS_BLOCK = 4096   # paths per MomentState block
MAX_FUNCTIONALS = 4  # K4's functional slots (kMaxFunctionals)

#: The processes the kernels run, by the code of their functor
#: (csrc/fused_engine.cu::ProcessCode).
PROCESS_CODES = {GBM: 0, Heston: 1, BasketGBM: 2, GARCHBootstrap: 3,
                 Merton: 4, Kou: 5, Bates: 6, NIG: 7, HestonQE: 8,
                 BatesQE: 9, VarianceGamma: 10, SABR: 11, LocalVolGBM: 12,
                 SLV: 13, SLVKnots: 14}

#: Draw-source codes of the kernels (csrc/fused_engine.cu::DrawSource).
THREEFRY, SOBOL, BRIDGE = 0, 1, 2
#: Paths per launch on the bridge's global workspace (T floats each: 1 GB
#: at T = 252), so the workspace stays bounded at any path count.
BRIDGE_WORKSPACE_PATHS = 1 << 20

_COMMON = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
           ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
           ctypes.c_uint32,
           # source, antithetic, sv, plan dims, plan coeffs, T, L, scratch
           ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_K2_ARGS = _COMMON + [ctypes.c_void_p]
_K3_ARGS = _COMMON + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_K4_ARGS = _COMMON + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
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
_BY_SOURCE = {"K2": (K2, K2_SOBOL, K2_BRIDGE),
              "K3": (K3, K3_SOBOL, K3_BRIDGE),
              "K4": (K4, K4_SOBOL, K4_BRIDGE)}


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
    mu, sigma, theta, nu, dt, gq_z0, gq_dz, gq_resid (n), gq_dresid (n)];
    SABR: [f0, alpha, beta, nu, rho, dt]; local vol: [s0, rate, dt, x0, dx,
    dt_knot, vol_flat (n_tk * 128)]; SLV: [s0, rate, v0, kappa, theta, xi,
    rho, dt, x0, dx, lev_rows (n_rows * 128)]; SLV on knots: SLV's up to
    dx, then [dt_knot, lev_flat (n_tk * 128)]), and ``dims`` the basket's
    A, GARCH's table length, VG's table length n, the local-vol surfaces'
    time-knot count n_tk or SLV's row count n_rows, an integer that never
    passes through a float."""
    code = PROCESS_CODES.get(type(process))
    if code is None:
        others = ", ".join(c.__name__ for c in list(PROCESS_CODES)[2:])
        raise TypeError("the fused kernels run GBM and Heston (and "
                        f"{others}) in this port, got "
                        f"{type(process).__name__}")
    dims = process.n_draws
    if isinstance(process, BasketGBM):
        check_kernel_assets(dims)
    elif isinstance(process, GARCHBootstrap):
        dims = process.table.numel()
    elif isinstance(process, VarianceGamma):
        dims = process.gq_resid.numel()
    elif isinstance(process, (LocalVolGBM, SLVKnots)):
        dims = process.n_time_knots
    elif isinstance(process, SLV):
        dims = process.lev_rows.shape[0]
    fields = [getattr(process, f.name) for f in dataclasses.fields(process)]
    return code, dims, torch.cat([v.reshape(-1) for v in fields
                                  if v.is_floating_point()])


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
    source = draw_source(sampler, antithetic)
    check_sampler(sampler, process, n_steps)
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


def _draw_args(process, sampler, source: int, antithetic: bool,
               n_paths: int):
    """The kernels' draw-source arguments (source, antithetic, sv, plan
    dims, plan coeffs, T, L, scratch), the tensors they point into (which
    must outlive the launches) and the paths per launch: all of them, or
    ``BRIDGE_WORKSPACE_PATHS`` on the bridge's workspace, which holds T
    floats for each path of a launch, laid out [dim][path]."""
    dev = process.device
    if source == THREEFRY:
        return ([source, int(antithetic), None, None, None, 0, 0, None], [],
                n_paths)
    check_cuda_tensor("sampler.sv", sampler.sv, dev, torch.int32)
    if source == SOBOL:
        return ([source, 0, sampler.sv.data_ptr(), None, None, 0, 0, None],
                [sampler.sv], n_paths)
    T, L = sampler.n_steps, sampler.width
    check_cuda_tensor("sampler.dims", sampler.dims, dev, torch.int32)
    check_cuda_tensor("sampler.coeffs", sampler.coeffs, dev, torch.float32)
    per_launch = min(n_paths, BRIDGE_WORKSPACE_PATHS)
    rows = -(-per_launch // LANES) * LANES
    scratch = torch.empty(T * rows, dtype=torch.float32, device=dev)
    return ([source, 0, sampler.sv.data_ptr(), sampler.dims.data_ptr(),
             sampler.coeffs.data_ptr(), T, L, scratch.data_ptr()],
            [sampler.sv, sampler.dims, sampler.coeffs, scratch], per_launch)


def _launches(n_paths: int, per_launch: int, path_offset):
    """(first path, paths, wrapped offset) of each launch of a run."""
    for start in range(0, n_paths, per_launch):
        yield (start, min(per_launch, n_paths - start),
               (int(path_offset) + start) & MASK32)


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
    check_cuda_tensor("leaves", leaves, dev, torch.float32)
    draw, keep, per_launch = _draw_args(process, sampler, source, antithetic,
                                        n_paths)
    out = torch.empty(n_paths, dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        for start, m, off in _launches(n_paths, per_launch, path_offset):
            _BY_SOURCE["K2"][source].launch(
                out.data_ptr() + 4 * start, leaves.data_ptr(), code, dims, m,
                n_steps, off, k0, k1, *draw, cuda_stream(dev))
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
    check_cuda_tensor("leaves", leaves, dev, torch.float32)
    draw, keep, per_launch = _draw_args(process, sampler, source, antithetic,
                                        n_paths)
    rows = torch.empty((n_paths // LANES, 2), dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        for start, m, off in _launches(n_paths, per_launch, path_offset):
            _BY_SOURCE["K3"][source].launch(
                rows.data_ptr() + 8 * (start // LANES), leaves.data_ptr(),
                code, dims, m, n_steps, off, k0, k1, *draw, payoff.code,
                payoff.strike, cuda_stream(dev))
    return _merge_rows(rows)


def _device_forms(items, n_steps: int):
    """The K4 device form of each (name, functional); raises TypeError for
    a functional that has none."""
    if len(items) > MAX_FUNCTIONALS:
        raise ValueError(f"K4 folds at most {MAX_FUNCTIONALS} functionals, "
                         f"got {len(items)}")
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
    one update after every step with its 1-based index, over the kernels'
    draws (:func:`_step_draws`)."""
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


def fused_functionals(process, n_paths: int, n_steps: int, *, seed,
                      functionals, stream=0, path_offset=0,
                      antithetic: bool = False, sampler=None) -> dict:
    """Terminal prices plus named path functionals, ``{"terminal": ...,
    name: ...}``, each (n_paths,) float32: K4 on a CUDA process, the plain
    version on a CPU one.  ``functionals`` maps names to
    :class:`PathFunctional` s with a device form (at most four).  Any
    ``n_paths >= 1``; the kernel masks the ragged edge.  ``sampler`` as in
    :func:`fused_terminal`."""
    items = tuple(functionals.items())
    code, dims, leaves = _leaves(process)
    forms = _device_forms(items, n_steps)
    source = _check_draws(process, sampler, n_steps, antithetic)
    dev = process.device
    if dev.type == "cpu":
        return fused_functionals_reference(
            process, n_paths, n_steps, seed=seed, functionals=functionals,
            stream=stream, path_offset=path_offset, antithetic=antithetic,
            sampler=sampler)
    if n_paths < 1 or n_steps < 0:
        raise ValueError(f"n_paths={n_paths}, n_steps={n_steps}")
    check_cuda_tensor("leaves", leaves, dev, torch.float32)
    draw, keep, per_launch = _draw_args(process, sampler, source, antithetic,
                                        n_paths)
    out = torch.empty((1 + len(forms), n_paths), dtype=torch.float32,
                      device=dev)
    codes = (ctypes.c_int * MAX_FUNCTIONALS)(*[f.code for f in forms])
    periods = (ctypes.c_int * MAX_FUNCTIONALS)(*[f.period for f in forms])
    params = (ctypes.c_float * (MAX_FUNCTIONALS * MAX_PARAMS))()
    for k, f in enumerate(forms):
        for q, v in enumerate(f.params):
            params[k * MAX_PARAMS + q] = v
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        for start, m, off in _launches(n_paths, per_launch, path_offset):
            _BY_SOURCE["K4"][source].launch(
                out.data_ptr() + 4 * start, leaves.data_ptr(), code, dims, m,
                n_steps, off, k0, k1, *draw, len(forms), codes, periods,
                params, n_paths, cuda_stream(dev))
    result = {"terminal": out[0]}
    for k, (name, _) in enumerate(items):
        result[name] = out[k + 1]
    return result
