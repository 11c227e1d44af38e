"""K7: terminal values of a correlated GBM basket, up to 128 assets.

Port of ``montecarlo_tpu/ops/basket_kernel.py::packed_basket_terminal_pallas``
(oracle ``packed_basket_terminal_reference``); the kernel is
``csrc/basket_kernel.cu``.  The draw convention is the TPU kernel's and is
asset-major: draw (path p, asset a, step t) is Box-Muller component
``t & 1`` of the Threefry call ``(p, a * n_pairs + t // 2)``, so it differs
from BasketGBM's ``t * A + d`` under one seed.  The TPU's lane packing and
power-of-two asset padding are layout only and are left out: nothing is
padded, and the results do not depend on a block size.  Unlike the TPU
kernel it takes any ``n_paths >= 1``.

Both versions take ``log32``/``exp32`` where the JAX package takes
``jnp.log``/``jnp.exp`` (an ULP or so apart), sum the correlation over b in
ascending order and the basket over the assets in order, so kernel and
plain version agree bitwise; against the JAX package they agree within
rtol 2e-6.  The kernel's block schedule (a register-tiled triangular
correlation over draws in shared memory) is ``csrc/basket_tile.cuh``,
which tests/test_torch_basket_tile.py also runs on the host.
"""

from __future__ import annotations

import ctypes

import torch

from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops._build import (CudaKernel, check_cuda_tensor,
                                             check_no_grad, cuda_stream,
                                             load_library)
from montecarlo_tpu_torch.processes.basket import check_kernel_assets
from montecarlo_tpu_torch.rng.normal import boxmuller_pair, exp32, log32
from montecarlo_tpu_torch.rng.threefry import (MASK32, key_from_seed,
                                               threefry2x32)

K7 = CudaKernel("mc_packed_basket_terminal", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
    ctypes.c_uint32, ctypes.c_void_p])


def k7_attributes(n_assets: int) -> dict:
    """The launch K7 makes for an ``n_assets`` basket, from
    ``cudaFuncGetAttributes``: registers and local memory per thread,
    dynamic shared memory per block (bytes) and paths per block.  Needs a
    card; launches nothing."""
    check_kernel_assets(n_assets)
    lib = load_library()
    fn = lib.mc_packed_basket_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = (ctypes.c_int * 4)()
    err = fn(n_assets, ctypes.cast(vals, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"mc_packed_basket_attributes: CUDA error {err} "
                           f"({lib.mc_error_string(err).decode()})")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "paths_per_block"), vals))


def _check(basket, n_paths: int, n_steps: int) -> int:
    check_no_grad(basket)
    a_n = basket.n_assets
    check_kernel_assets(a_n)
    if n_paths < 1 or n_steps < 0:
        raise ValueError(f"n_paths={n_paths}, n_steps={n_steps}")
    return a_n


def _constants(basket) -> torch.Tensor:
    """(4, A) float32 rows: drift, scale, log32(s0), weights."""
    drift, scale = basket.drift_scale()
    return torch.stack([drift, scale, log32(basket.s0), basket.weights])


def packed_basket_terminal_reference(basket, n_paths: int, n_steps: int, *,
                                     seed, stream=0, path_offset=0
                                     ) -> torch.Tensor:
    """The plain PyTorch version of K7 on (n_paths, A) tensors: the same
    counters and the same float32 operations in the same order (the
    correlation a loop over b, not a matmul, whose order is not fixed)."""
    a_n = _check(basket, n_paths, n_steps)
    drift, scale, log_s0, w = _constants(basket)
    chol = basket.chol_flat.reshape(a_n, a_n)
    dev = basket.device
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, dev)[:, None]
    asset = torch.arange(a_n, dtype=torch.int64, device=dev)[None, :]
    n_pairs = (n_steps + 1) // 2
    log_s = log_s0.expand(n_paths, a_n)
    for j in range(n_pairs):
        c1 = (asset * n_pairs + j) & MASK32
        z0, z1 = boxmuller_pair(*threefry2x32(k0, k1, ids, c1))
        zc0 = chol[:, 0] * z0[:, :1]
        zc1 = chol[:, 0] * z1[:, :1]
        for b in range(1, a_n):
            rows = asset >= b  # asset a sums L[a, b] z_b for b <= a only
            zc0 = torch.where(rows, zc0 + chol[:, b] * z0[:, b:b + 1], zc0)
            zc1 = torch.where(rows, zc1 + chol[:, b] * z1[:, b:b + 1], zc1)
        log_s = (log_s + drift) + scale * zc0
        if 2 * j + 1 < n_steps:
            log_s = (log_s + drift) + scale * zc1
        else:  # the odd final step: an exact +0.0
            log_s = (log_s + 0.0) + 0.0
    weighted = w * exp32(log_s)
    out = weighted[:, 0]
    for a in range(1, a_n):
        out = out + weighted[:, a]
    return out


def packed_basket_terminal(basket, n_paths: int, n_steps: int, *, seed,
                           stream=0, path_offset=0) -> torch.Tensor:
    """Terminal basket values ``weights . S_T``, (n_paths,) float32: K7
    for a CUDA basket, the plain version for a CPU one.  Results are
    shard-invariant under ``path_offset``."""
    dev = basket.device
    if dev.type == "cpu":
        return packed_basket_terminal_reference(
            basket, n_paths, n_steps, seed=seed, stream=stream,
            path_offset=path_offset)
    a_n = _check(basket, n_paths, n_steps)
    params = _constants(basket).contiguous()
    chol = basket.chol_flat
    check_cuda_tensor("params", params, dev, torch.float32)
    check_cuda_tensor("chol_flat", chol, dev, torch.float32)
    out = torch.empty(n_paths, dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        K7.launch(out.data_ptr(), params.data_ptr(), chol.data_ptr(), a_n,
                  n_paths, n_steps, int(path_offset) & MASK32, k0, k1,
                  cuda_stream(dev))
    return out
