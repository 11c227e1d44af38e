"""K6: the fused rough-Bergomi price integral.

Port of ``montecarlo_tpu/ops/rbergomi_kernel.py::rbergomi_terminal_pallas``;
the kernel is ``csrc/rbergomi_kernel.cu``.  From the (2T, N) joint matrix
(W~ grid values, then Brownian increments), ``tpow`` = t_grid^{2H} and the
7-vector (xi0, eta, rho, sqrt(1-rho^2)*sqrt(dt), dt/2, log32(s0), eta^2/2)
it makes the perpendicular normals from counter (path id, T + t/2), runs
the left-point price integral and returns exp32(log S_T).  Unlike the TPU
kernel it takes any ``n_paths >= 1`` and any ``T >= 1``: an odd T ends with
the first normal of its last pair (draw column 3T-1).

The kernel has two forms, chosen here from the shape before the launch and
counted apart: ``K6`` streams each warp's rows through a shared-memory ring
of 16-byte copies (``csrc/rbergomi_ring.cuh``), which needs every row
segment on 16 bytes (``n_paths % 4 == 0`` and an aligned matrix);
``K6_UNALIGNED`` loads into registers a pair ahead, for any other shape.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops._build import (CudaKernel, check_cuda_tensor,
                                             cuda_stream)
from montecarlo_tpu_torch.rng.normal import (_TWO_PI, boxmuller_pair, exp32,
                                             uniform_from_bits)
from montecarlo_tpu_torch.rng.threefry import (MASK32, key_from_seed,
                                               threefry2x32)

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
         ctypes.c_uint32, ctypes.c_void_p]
K6 = CudaKernel("mc_rbergomi_terminal", _ARGS)
K6_UNALIGNED = CudaKernel("mc_rbergomi_terminal_unaligned", _ARGS)
K6_ANGLES = CudaKernel("mc_rbergomi_angle_check",
                       [ctypes.c_void_p, ctypes.c_void_p])
N_ANGLES = 1 << 23  # the distinct angles of Box-Muller's 23-bit uniforms

#: The most steps one launch takes: c_t = half_eta2 * tpow[t] in 48 KB of
#: shared memory.
MAX_STEPS = 48 * 1024 // 4
N_PARAMS = 7


def _check(joint, tpow, params, n_steps: int) -> None:
    if not 1 <= n_steps <= MAX_STEPS:
        raise ValueError(f"n_steps={n_steps} must be in [1, {MAX_STEPS}]")
    if (joint.dim() != 2 or joint.shape[0] != 2 * n_steps
            or joint.shape[1] < 1):
        raise ValueError(f"joint {tuple(joint.shape)} must be (2T, N) with "
                         f"T = n_steps = {n_steps} and N >= 1")
    if tuple(tpow.shape) != (n_steps,) or tuple(params.shape) != (N_PARAMS,):
        raise ValueError(f"tpow {tuple(tpow.shape)} must be ({n_steps},) and "
                         f"params {tuple(params.shape)} ({N_PARAMS},)")


def ring_aligned(n_paths: int, data_ptr: int) -> bool:
    """Whether every row segment of a (2T, n_paths) float32 matrix at
    ``data_ptr`` starts on 16 bytes, as the ring form's copies need."""
    return n_paths % 4 == 0 and data_ptr % 16 == 0


def rbergomi_terminal_reference(joint, tpow, params, seed, stream, *,
                                n_steps: int, path_offset=0) -> torch.Tensor:
    """The plain PyTorch version of K6: the same loop on (N,) tensors, the
    same operations in the same order."""
    _check(joint, tpow, params, n_steps)
    xi0, eta, rho, c_perp, half_dt, log_s0, half_eta2 = params
    T, n_paths = n_steps, joint.shape[1]
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, joint.device)
    log_s = log_s0.expand(n_paths)
    v_left = xi0.expand(n_paths)
    for t0 in range(0, T, 2):
        z_perp = boxmuller_pair(*threefry2x32(k0, k1, ids, T + t0 // 2))
        for t in range(t0, min(t0 + 2, T)):
            dws = rho * joint[T + t] + c_perp * z_perp[t - t0]
            log_s = log_s + (torch.sqrt(v_left) * dws - v_left * half_dt)
            v_left = xi0 * exp32(eta * joint[t] - half_eta2 * tpow[t])
    return exp32(log_s)


def rbergomi_terminal(joint, tpow, params, seed, stream, *, n_steps: int,
                      path_offset=0) -> torch.Tensor:
    """Terminal prices, (N,) float32: K6 (its ring form where
    ``ring_aligned``, else its plain-load form) for a CUDA ``joint``, the
    plain version for a CPU one."""
    dev = joint.device
    if dev.type == "cpu":
        return rbergomi_terminal_reference(joint, tpow, params, seed, stream,
                                           n_steps=n_steps,
                                           path_offset=path_offset)
    _check(joint, tpow, params, n_steps)
    for name, t in (("joint", joint), ("tpow", tpow), ("params", params)):
        check_cuda_tensor(name, t, dev, torch.float32)
    n_paths = joint.shape[1]
    out = torch.empty(n_paths, dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    kernel = K6 if ring_aligned(n_paths, joint.data_ptr()) else K6_UNALIGNED
    with torch.cuda.device(dev):
        kernel.launch(out.data_ptr(), joint.data_ptr(), tpow.data_ptr(),
                      params.data_ptr(), n_paths, n_steps,
                      int(path_offset) & MASK32, k0, k1, cuda_stream(dev))
    return out


def boxmuller_angles_reference(device) -> torch.Tensor:
    """(2, 2^23): sin and cos of every angle Box-Muller takes from a word,
    theta = 2 pi u(m << 9) for m < 2^23, by the plain version's ops."""
    words = torch.arange(N_ANGLES, dtype=torch.int64, device=device) << 9
    theta = _TWO_PI * uniform_from_bits(words)
    return torch.stack([torch.sin(theta), torch.cos(theta)])


def boxmuller_angles(device) -> torch.Tensor:
    """The same (2, 2^23) from K6's sincosf on the card (the plain version
    on the CPU): bitwise the plain version's, so K6's one range reduction
    for both changes no normal."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return boxmuller_angles_reference(dev)
    out = torch.empty((2, N_ANGLES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        K6_ANGLES.launch(out.data_ptr(), cuda_stream(dev))
    return out
