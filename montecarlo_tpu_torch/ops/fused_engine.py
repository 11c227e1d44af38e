"""K2 and K3: the process-generic fused time loop.

Port of ``montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas`` (K2)
and ``::fused_block_moments_pallas`` (K3); the kernels are one template in
``csrc/fused_engine.cu``.  The plain versions below run the process's own
``draws_pair``/``step``/``prices`` in the kernel's order — two steps per
cipher call, the antithetic mirror on odd ids, the odd final step dropped by
a select — and agree with the kernels bitwise where the platform's
log/sqrt/sin/cos do.

K3 applies a :class:`VanillaPayoff` in the kernel and writes (mean, M2) per
128-path row, summed in ``tree_sum``'s fixed order; the rows are merged
into 4096-path :class:`MomentState` blocks in torch, by the same pairwise
tree as the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from montecarlo_tpu_torch.engine.payoffs import VanillaPayoff
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops._build import (CudaKernel, check_cuda_tensor,
                                             cuda_stream)
from montecarlo_tpu_torch.processes.gbm import GBM
from montecarlo_tpu_torch.rng.threefry import MASK32, key_from_seed
from montecarlo_tpu_torch.stats.welford import (MomentState, moments_reduce,
                                                tree_sum)

LANES = 128          # paths per stats row (K3's block)
STATS_BLOCK = 4096   # paths per MomentState block

_COMMON = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
           ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
K2 = CudaKernel("mc_fused_terminal_gbm", _COMMON + [ctypes.c_void_p])
K3 = CudaKernel("mc_fused_block_moments_gbm",
                _COMMON + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _leaves(process) -> torch.Tensor:
    """The process's leaves, float32 in field order, as the kernel's
    functor reads them (GBM: [s0, mu, sigma, dt])."""
    if not isinstance(process, GBM):
        raise TypeError("the fused kernels run GBM in this port, got "
                        f"{type(process).__name__}")
    return torch.stack([getattr(process, f.name)
                        for f in dataclasses.fields(process)])


def fused_terminal_reference(process, n_paths: int, n_steps: int, *, seed,
                             stream=0, path_offset=0,
                             antithetic: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K2 (any process with the protocol)."""
    k0, k1 = key_from_seed(seed, stream)
    ids = path_ids_for(n_paths, path_offset, process.device)
    draw_ids = ids >> 1 if antithetic else ids
    odd = (ids & 1).to(torch.bool)

    def mirror(eps):
        return tuple(torch.where(odd, m, e)
                     for m, e in zip(process.antithetic(eps), eps))

    state = process.init_state(ids)
    for j in range((n_steps + 1) // 2):
        eps0, eps1 = process.draws_pair(k0, k1, draw_ids, j)
        if antithetic:
            eps0, eps1 = mirror(eps0), mirror(eps1)
        state = process.step(state, eps0, 2 * j)
        stepped = process.step(state, eps1, 2 * j + 1)
        if 2 * j + 1 < n_steps:  # odd final step: dropped
            state = stepped
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
                                  antithetic: bool = False) -> MomentState:
    """The plain PyTorch version of K3 plus the row merge."""
    _check_block_args(payoff, n_paths)
    prices = fused_terminal_reference(
        process, n_paths, n_steps, seed=seed, stream=stream,
        path_offset=path_offset, antithetic=antithetic)
    return _merge_rows(_row_moments(payoff(prices)))


def fused_terminal(process, n_paths: int, n_steps: int, *, seed, stream=0,
                   path_offset=0, antithetic: bool = False) -> torch.Tensor:
    """Terminal prices (n_paths,) float32: K2 on a CUDA process, the plain
    version on a CPU one.  Any ``n_paths >= 1``; the kernel masks the
    ragged edge."""
    leaves = _leaves(process)
    dev = process.device
    if dev.type == "cpu":
        return fused_terminal_reference(
            process, n_paths, n_steps, seed=seed, stream=stream,
            path_offset=path_offset, antithetic=antithetic)
    if n_paths < 1 or n_steps < 0:
        raise ValueError(f"n_paths={n_paths}, n_steps={n_steps}")
    check_cuda_tensor("leaves", leaves, dev, torch.float32)
    out = torch.empty(n_paths, dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        K2.launch(out.data_ptr(), leaves.data_ptr(), n_paths, n_steps,
                  int(path_offset) & MASK32, k0, k1, int(antithetic),
                  cuda_stream(dev))
    return out


def fused_block_moments(process, payoff: VanillaPayoff, n_paths: int,
                        n_steps: int, *, seed, stream=0, path_offset=0,
                        antithetic: bool = False) -> MomentState:
    """Per-4096-path-block payoff moments with the terminal prices never
    leaving the kernel: K3 on a CUDA process, the plain version on a CPU
    one.  Returns a MomentState with leaves shaped (n_paths // 4096,)."""
    leaves = _leaves(process)
    dev = process.device
    if dev.type == "cpu":
        return fused_block_moments_reference(
            process, payoff, n_paths, n_steps, seed=seed, stream=stream,
            path_offset=path_offset, antithetic=antithetic)
    _check_block_args(payoff, n_paths)
    if n_steps < 0:
        raise ValueError(f"n_steps={n_steps}")
    check_cuda_tensor("leaves", leaves, dev, torch.float32)
    rows = torch.empty((n_paths // LANES, 2), dtype=torch.float32, device=dev)
    k0, k1 = key_from_seed(seed, stream)
    with torch.cuda.device(dev):
        K3.launch(rows.data_ptr(), leaves.data_ptr(), n_paths, n_steps,
                  int(path_offset) & MASK32, k0, k1, int(antithetic),
                  payoff.code, payoff.strike, cuda_stream(dev))
    return _merge_rows(rows)
