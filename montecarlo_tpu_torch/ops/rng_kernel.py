"""K5: the bulk normal matrix of the rough-Bergomi sampler.

Port of ``montecarlo_tpu/ops/rng_kernel.py::normal_matrix_pallas``; the
kernel is ``csrc/rng_kernel.cu``.  ``normal_matrix(...)[m, i] ==
normal_draw(seed, stream, path_offset + i, m)``: the same draw stream as
the rest of the port, in the (n_cols, n_paths) layout that the factor
product ``chol @ Z`` consumes.  Unlike the TPU kernel it takes any
``n_paths >= 1`` and any ``n_cols >= 1``.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops._build import CudaKernel, cuda_stream
from montecarlo_tpu_torch.rng.normal import boxmuller_pair
from montecarlo_tpu_torch.rng.threefry import (MASK32, key_from_seed,
                                               threefry2x32)

K5 = CudaKernel("mc_normal_matrix", [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p])

#: The most columns one launch fills (65535 chunks of 16 pairs).
MAX_COLS = 65535 * 16 * 2


def _check(n_paths: int, n_cols: int) -> None:
    if n_paths < 1 or not 1 <= n_cols <= MAX_COLS:
        raise ValueError(f"n_paths={n_paths} must be >= 1 and n_cols="
                         f"{n_cols} in [1, {MAX_COLS}]")


def normal_matrix_reference(seed, stream, n_paths: int, n_cols: int, *,
                            path_offset=0, device="cpu") -> torch.Tensor:
    """The plain PyTorch version of K5: one cipher call and Box-Muller pair
    per pair of rows, (n_paths,) at a time, so memory stays at the output
    plus a few path vectors."""
    _check(n_paths, n_cols)
    dev = resolve_device(device)
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, dev)
    out = torch.empty((n_cols, n_paths), dtype=torch.float32, device=dev)
    for j in range((n_cols + 1) // 2):
        z0, z1 = boxmuller_pair(*threefry2x32(k0, k1, ids, j))
        out[2 * j] = z0
        if 2 * j + 1 < n_cols:
            out[2 * j + 1] = z1
    return out


def normal_matrix(seed, stream, n_paths: int, n_cols: int, *, path_offset=0,
                  device="cuda") -> torch.Tensor:
    """(n_cols, n_paths) float32 standard normals of the ``normal_draw``
    stream: K5 on a CUDA device, the plain version on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return normal_matrix_reference(seed, stream, n_paths, n_cols,
                                       path_offset=path_offset, device=dev)
    _check(n_paths, n_cols)
    out = torch.empty((n_cols, n_paths), dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        K5.launch(out.data_ptr(), n_paths, n_cols, int(path_offset) & MASK32,
                  k0, k1, cuda_stream(dev))
    return out
