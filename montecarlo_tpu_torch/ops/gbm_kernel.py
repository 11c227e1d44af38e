"""K1: terminal GBM prices — the benchmark kernel.

Port of ``montecarlo_tpu/ops/gbm_kernel.py::gbm_terminal_pallas`` (its
``rng="threefry"`` mode; the TPU core-PRNG mode has no Hopper counterpart).
The kernel is ``csrc/gbm_kernel.cu``.  Same draws as the engine; like the
TPU kernel it starts from the platform ``log(s0)`` and ends with IEEE
``exp``, so it matches the engine to float32 round-off, not bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops._build import (CudaKernel, check_cuda_tensor,
                                             check_no_grad, cuda_stream)
from montecarlo_tpu_torch.processes.gbm import GBM
from montecarlo_tpu_torch.rng.normal import boxmuller_pair
from montecarlo_tpu_torch.rng.threefry import (MASK32, key_from_seed,
                                               threefry2x32)

K1 = CudaKernel("mc_gbm_terminal", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p])


def _params(process: GBM) -> torch.Tensor:
    """[drift, scale, log(s0)] float32 on the process's device, computed as
    the TPU wrapper computes them (platform log, not log32)."""
    if not isinstance(process, GBM):
        raise TypeError(f"gbm_terminal runs GBM, got {type(process).__name__}")
    check_no_grad(process)
    drift, scale = process.drift_scale()
    return torch.stack([drift, scale, torch.log(process.s0)])


def gbm_terminal_reference(process: GBM, n_paths: int, n_steps: int, *,
                           seed, stream=0, path_offset=0) -> torch.Tensor:
    """The plain PyTorch version of K1, same operations in the same order."""
    drift, scale, log_s0 = _params(process)
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, process.device)
    log_s = log_s0.expand(n_paths).clone()
    for j in range((n_steps + 1) // 2):
        z0, z1 = boxmuller_pair(*threefry2x32(k0, k1, ids, j))
        log_s = log_s + (drift + scale * z0)
        # The second step of the last pair is an exact +0.0 when n_steps
        # is odd.
        live = 2 * j + 1 < n_steps
        log_s = log_s + ((drift + scale * z1) if live else 0.0)
    return torch.exp(log_s)


def gbm_terminal(process: GBM, n_paths: int, n_steps: int, *, seed,
                 stream=0, path_offset=0) -> torch.Tensor:
    """Terminal GBM prices, (n_paths,) float32: K1 on a CUDA process, the
    plain version on a CPU one.  Any ``n_paths >= 1``."""
    params = _params(process)
    dev = process.device
    if dev.type == "cpu":
        return gbm_terminal_reference(process, n_paths, n_steps, seed=seed,
                                      stream=stream, path_offset=path_offset)
    if n_paths < 1 or n_steps < 0:
        raise ValueError(f"n_paths={n_paths}, n_steps={n_steps}")
    check_cuda_tensor("params", params, dev, torch.float32)
    out = torch.empty(n_paths, dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        K1.launch(out.data_ptr(), params.data_ptr(), n_paths, n_steps,
                  int(path_offset) & MASK32, k0, k1, cuda_stream(dev))
    return out
