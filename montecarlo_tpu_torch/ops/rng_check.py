"""K0 on the card: the device functions of ``csrc/rng.cuh`` run elementwise
(``csrc/rng_check.cu``) beside their plain PyTorch versions, so a test or
``chip_smoke.py`` can hold the on-card build against ``rng/``: the cipher
and the float32 math (``rng_check``), the randomized Sobol normal with
``ndtri32`` (``sobol_check``), ``expneg_wide32`` with the
table-inverted gamma variate of variance gamma (``gamma_check``), and the
functors' inverse normal ``ndtri32_unit`` against ``ndtri32`` on every
float32 of its range and against the plain ``ndtri32`` on every uniform
(``ndtri_unit_check``); and the normals CCC's and DCC's kernels draw a step
at a time at an even asset count (``state_draws_check``, in
``csrc/fused_ccc.cu``) against the pair's draws of their plain versions."""

from __future__ import annotations

import ctypes

import torch

from montecarlo_tpu_torch.ops._build import CudaKernel, cuda_stream
from montecarlo_tpu_torch.rng.gamma import (expneg_wide32,
                                            gamma_from_uniforms_table32)
from montecarlo_tpu_torch.rng.normal import (boxmuller_pair, exp32, log32,
                                             ndtri32, uniform_from_bits)
from montecarlo_tpu_torch.rng.sobol import _owen_key, _scrambled_uniform
from montecarlo_tpu_torch.rng.threefry import MASK32, threefry2x32

K0_CHECK = CudaKernel("mc_rng_check", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
    ctypes.c_void_p])

NAMES = ("bits0", "bits1", "u0", "u1", "z0", "z1", "exp32", "log32")

K0_SOBOL_CHECK = CudaKernel("mc_sobol_check", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_void_p])

SOBOL_NAMES = ("sobol_bits", "owen_key", "uniform", "normal", "ndtri32")


def _to_i32(w: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) as int32 bit patterns (the same 4 bytes)."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(
        torch.int32).contiguous()


def rng_check_reference(k0: int, k1: int, c0, c1, x_exp, x_log) -> dict:
    """Plain versions of everything the check kernel computes.  Counters
    are word tensors (int64 holding uint32 values)."""
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    z0, z1 = boxmuller_pair(b0, b1)
    vals = (b0, b1, uniform_from_bits(b0), uniform_from_bits(b1), z0, z1,
            exp32(x_exp), log32(x_log))
    return dict(zip(NAMES, vals))


def rng_check(k0: int, k1: int, c0, c1, x_exp, x_log) -> dict:
    """The check kernel on CUDA tensors; words come back as int64 words."""
    dev = c0.device
    n = c0.numel()
    cc0, cc1 = _to_i32(c0), _to_i32(c1)
    x = torch.stack([x_exp, x_log]).to(torch.float32).contiguous()
    bits = torch.empty((2, n), dtype=torch.int32, device=dev)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        K0_CHECK.launch(bits.data_ptr(), out.data_ptr(), cc0.data_ptr(),
                        cc1.data_ptr(), x.data_ptr(), n, k0 & MASK32,
                        k1 & MASK32, cuda_stream(dev))
    words = bits.to(torch.int64) & MASK32
    return dict(zip(NAMES, (words[0], words[1], *out)))


def sobol_check_reference(k0: int, k1: int, sv, ids, dims, u) -> dict:
    """Plain versions of the Sobol check: per element i the Sobol integer
    and Owen key of (ids[i], dims[i]) in the table ``sv`` (n_dims, 30),
    the scrambled uniform, the Sobol normal, and ``ndtri32(u[i])``."""
    dims = dims.to(torch.int64)
    uniq = torch.unique(dims).tolist()
    table = torch.zeros(max(uniq) + 1 if uniq else 1, dtype=torch.int64)
    table[uniq] = torch.tensor([_owen_key(k0, k1, d) for d in uniq],
                               dtype=torch.int64)
    keys = table.to(ids.device)[dims]
    rows = sv.to(torch.int64)[dims]                      # (n, 30)
    g = ids ^ (ids >> 1)
    x = torch.zeros_like(ids)
    for k in range(rows.shape[1]):
        x = x ^ (rows[:, k] * ((g >> k) & 1))
    uniform = _scrambled_uniform(x, keys)
    vals = (x, keys, uniform, ndtri32(uniform), ndtri32(u))
    return dict(zip(SOBOL_NAMES, vals))


def sobol_check(k0: int, k1: int, sv, ids, dims, u) -> dict:
    """The Sobol check kernel on CUDA tensors: ``sv`` int32 (n_dims, 30),
    ``ids`` words, ``dims`` int (n,), ``u`` float32 (n,)."""
    dev = ids.device
    n = ids.numel()
    bits = torch.empty((2, n), dtype=torch.int32, device=dev)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    args = (sv.to(torch.int32).contiguous(), _to_i32(ids),
            dims.to(torch.int32).contiguous(),
            u.to(torch.float32).contiguous())
    with torch.cuda.device(dev):
        K0_SOBOL_CHECK.launch(bits.data_ptr(), out.data_ptr(),
                              *(a.data_ptr() for a in args), n, k0 & MASK32,
                              k1 & MASK32, cuda_stream(dev))
    words = bits.to(torch.int64) & MASK32
    return dict(zip(SOBOL_NAMES, (words[0], words[1], *out)))


K0_GAMMA_CHECK = CudaKernel("mc_gamma_check", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

GAMMA_NAMES = ("expneg_wide32", "gamma")


def _gamma_args(vg):
    """(a, z0, dz, resid, dresid) of a VarianceGamma process: the shape
    dt/nu as the process computes it and its quantile table."""
    return (vg.dt / vg.nu, vg.gq_z0, vg.gq_dz, vg.gq_resid, vg.gq_dresid)


def gamma_check_reference(vg, u_w, u_b, x) -> dict:
    """Plain versions of the gamma check: ``expneg_wide32(x)`` and the
    Gamma(dt/nu) variate of ``(u_w, u_b)`` from ``vg``'s table."""
    a, z0, dz, resid, dresid = _gamma_args(vg)
    vals = (expneg_wide32(x),
            gamma_from_uniforms_table32(a, u_w, u_b, z0, dz, resid, dresid))
    return dict(zip(GAMMA_NAMES, vals))


def gamma_check(vg, u_w, u_b, x) -> dict:
    """The gamma check kernel on CUDA tensors (float32, (n,) each) and a
    VarianceGamma process on the card."""
    dev = u_w.device
    n = u_w.numel()
    a, z0, dz, resid, dresid = _gamma_args(vg)
    args = [t.to(torch.float32).contiguous() for t in (u_w, u_b, x)]
    out = torch.empty((2, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        K0_GAMMA_CHECK.launch(out.data_ptr(), *(t.data_ptr() for t in args),
                              n, float(a), float(z0), float(dz),
                              resid.data_ptr(), dresid.data_ptr(),
                              resid.numel(), cuda_stream(dev))
    return dict(zip(GAMMA_NAMES, out))


K0_NDTRI_UNIT_CHECK = CudaKernel("mc_ndtri_unit_check", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

#: uniform_from_bits' values, (k + 1/2) 2^-23 for k < 2^23, and the float32
#: of ndtri32_unit's range, [2^-24, 1 - 2^-24], by bit pattern.
N_UNIFORMS = 1 << 23
UNIT_RANGE = (0x33800000, 0x3F7FFFFF)


def unit_uniforms(device) -> torch.Tensor:
    """Every value ``uniform_from_bits`` gives, in word order."""
    k = torch.arange(N_UNIFORMS, dtype=torch.float64, device=device)
    return ((k + 0.5) * 2.0 ** -23).to(torch.float32)


def ndtri_unit_check(device) -> dict:
    """``ndtri32_unit`` on the card: ``mismatches``, the float32 u in
    [2^-24, 1 - 2^-24] (all UNIT_RANGE[1] - UNIT_RANGE[0] + 1 of them)
    where it differs from the card's ``ndtri32`` in a bit, with
    ``first_bits`` the lowest such u's bit pattern (None when there is
    none), and ``uniforms``, its value on every ``uniform_from_bits``
    value (``unit_uniforms``' order)."""
    dev = torch.device(device)
    counts = torch.tensor([0, 2 ** 63 - 1], dtype=torch.int64, device=dev)
    uniforms = torch.empty(N_UNIFORMS, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        K0_NDTRI_UNIT_CHECK.launch(counts.data_ptr(), uniforms.data_ptr(),
                                   cuda_stream(dev))
    bad, first = counts.tolist()
    return {"mismatches": bad,
            "first_bits": None if bad == 0 else first,
            "uniforms": uniforms}


def ndtri_unit_check_reference(device) -> torch.Tensor:
    """The plain ``ndtri32`` on every ``uniform_from_bits`` value: what
    ``ndtri_unit_check``'s ``uniforms`` must equal."""
    return ndtri32(unit_uniforms(device))


K0_STATE_DRAWS_CHECK = CudaKernel("mc_state_draws_check", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
    ctypes.c_void_p])


def state_draws_check_reference(process, n_paths: int, n_steps: int, *,
                                seed, path_offset=0,
                                antithetic: bool = False) -> torch.Tensor:
    """(n_steps, A, n_paths) float32: the normals of every step as the
    plain versions of K2-K4 draw them, a ``draws_pair`` per pair of steps
    (``ops.fused_engine._step_draws``)."""
    from montecarlo_tpu_torch.engine.simulate import path_ids_for
    from montecarlo_tpu_torch.ops.fused_engine import _step_draws
    from montecarlo_tpu_torch.rng.threefry import key_from_seed

    k0, k1 = key_from_seed(seed, 0)
    ids = path_ids_for(n_paths, path_offset, process.device)
    steps = [torch.stack(eps) for _, eps in
             _step_draws(process, n_steps, k0, k1, ids, antithetic)]
    if not steps:
        return torch.empty((0, process.n_draws, n_paths),
                           dtype=torch.float32, device=process.device)
    return torch.stack(steps)


def state_draws_check(process, n_paths: int, n_steps: int, *, seed,
                      path_offset=0, antithetic: bool = False
                      ) -> torch.Tensor:
    """The same normals from the check kernel, each step's drawn just
    before it (``csrc/fused_mgarch.cuh::step_normals``): a CCC or DCC
    process on the card of 2, 4, 6 or 8 assets."""
    from montecarlo_tpu_torch.rng.threefry import key_from_seed

    dev = process.device
    a_n = process.n_draws
    if a_n not in (2, 4, 6, 8):
        raise ValueError(f"the per-step draws take an even asset count up "
                         f"to 8, got {a_n}")
    k0, k1 = key_from_seed(seed, 0)
    out = torch.empty((n_steps, a_n, n_paths), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        K0_STATE_DRAWS_CHECK.launch(out.data_ptr(), a_n, n_paths, n_steps,
                                    int(path_offset) & MASK32, k0, k1,
                                    int(antithetic), cuda_stream(dev))
    return out
