"""K0 on the card: the device functions of ``csrc/rng.cuh`` run elementwise
(``csrc/rng_check.cu``) beside their plain PyTorch versions, so a test or
``chip_smoke.py`` can hold the on-card build against ``rng/``."""

from __future__ import annotations

import ctypes

import torch

from montecarlo_tpu_torch.ops._build import CudaKernel, cuda_stream
from montecarlo_tpu_torch.rng.normal import (boxmuller_pair, exp32, log32,
                                             uniform_from_bits)
from montecarlo_tpu_torch.rng.threefry import MASK32, threefry2x32

K0_CHECK = CudaKernel("mc_rng_check", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
    ctypes.c_void_p])

NAMES = ("bits0", "bits1", "u0", "u1", "z0", "z1", "exp32", "log32")


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
    # uint32 words travel as int32 bit patterns (same 4 bytes).
    to_i32 = lambda w: torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(
        torch.int32).contiguous()
    cc0, cc1 = to_i32(c0), to_i32(c1)
    x = torch.stack([x_exp, x_log]).to(torch.float32).contiguous()
    bits = torch.empty((2, n), dtype=torch.int32, device=dev)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        K0_CHECK.launch(bits.data_ptr(), out.data_ptr(), cc0.data_ptr(),
                        cc1.data_ptr(), x.data_ptr(), n, k0 & MASK32,
                        k1 & MASK32, cuda_stream(dev))
    words = bits.to(torch.int64) & MASK32
    return dict(zip(NAMES, (words[0], words[1], *out)))
