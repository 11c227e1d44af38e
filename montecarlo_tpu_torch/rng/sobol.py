"""Randomized Sobol points generated per step from the global path id.

The port of ``montecarlo_tpu/rng/sobol.py``:

    point(i, dim) = XOR_{k : bit k of gray(i)} V[dim, k]

with V the Joe-Kuo direction numbers (scipy's table, taken once when a
sampler is built) and gray(i) = i ^ (i >> 1).  Each dimension is randomized
by a hash-based Owen scramble keyed by Threefry(seed, stream, dim, 0x50B0),
so a draw stays a pure function of (seed, stream, global path id,
dimension) and the streams are shard-invariant.

Words are int64 tensors holding uint32 values, as in ``rng/threefry.py``.
The Owen hash multiplies words by 32-bit constants, which would pass 2^63
in int64: each constant is split into 16-bit halves, so every partial
product stays below 2^48, and the sum is masked to 32 bits.  Sobol
integers, Owen-hashed words and uniforms equal the JAX package's bitwise;
the normals go through ``ndtri32``, which calls the platform's log.

The samplers keep the JAX package's table layouts (``sv`` (n_dims, 30),
the bridge plan's ``dims``/``coeffs`` (T, L)) as int32/float32 tensors on
the process's device; every direction number is below 2^30, so int32 holds
it exactly and the kernels read it as uint32 through a plain pointer.  The
kernels' bridge also reads the plan's load schedule (``bridge_schedule``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from montecarlo_tpu_torch.device import resolve_device
from montecarlo_tpu_torch.rng.normal import ndtri32, uniform_from_bits
from montecarlo_tpu_torch.rng.threefry import MASK32, random_bits

BITS = 30
#: Counter word of the per-dimension Owen-hash key.
OWEN_KEY_WORD = 0x50B0
_OWEN_CONSTANTS = (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6)


def direction_numbers(n_dims: int) -> np.ndarray:
    """(n_dims, 30) uint32 Joe-Kuo direction numbers from scipy's table.

    scipy keeps them in the private ``_sv`` attribute; a scipy without it
    raises here rather than falling back to another table."""
    from scipy.stats import qmc

    eng = qmc.Sobol(d=n_dims, scramble=False, bits=BITS)
    sv = getattr(eng, "_sv", None)
    if sv is None:
        raise RuntimeError("this scipy's qmc.Sobol has no _sv table of "
                           "direction numbers")
    return np.asarray(sv, np.uint32)


def lms_scramble(sv: np.ndarray, seed: int) -> np.ndarray:
    """Matousek linear matrix scramble of Sobol direction numbers: each
    dimension's generating matrix left-multiplied by a random unit
    lower-triangular bit matrix, on the host, once per sampler."""
    rng = np.random.default_rng(seed)
    d, n_bits = sv.shape
    # bits[dim, k, i] = bit i (MSB-first) of direction number k.
    shifts = (n_bits - 1 - np.arange(n_bits, dtype=np.uint32))
    bits = (sv[:, :, None] >> shifts[None, None, :]) & 1  # (d, 30, 30)
    m = rng.integers(0, 2, size=(d, n_bits, n_bits), dtype=np.uint32)
    tril = np.tril(np.ones((n_bits, n_bits), np.uint32), -1)
    m = m * tril + np.eye(n_bits, dtype=np.uint32)
    # v'[i] = XOR_j m[i, j] & v[j]  (GF(2) matvec per direction number).
    out_bits = (np.einsum("dij,dkj->dki", m, bits) & 1).astype(np.uint32)
    return (out_bits << shifts[None, None, :]).sum(axis=2).astype(np.uint32)


def sobol_bits(sv_row: torch.Tensor, path_ids: torch.Tensor) -> torch.Tensor:
    """Raw Sobol integers in [0, 2^30) of one dimension: ``sv_row`` its 30
    direction numbers, ``path_ids`` word tensors of point indices."""
    row = sv_row.to(torch.int64)
    g = path_ids ^ (path_ids >> 1)  # Gray code
    x = torch.zeros_like(path_ids)
    for k in range(BITS):
        x = x ^ (row[k] * ((g >> k) & 1))
    return x


def _reverse32(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse uint32 words (the 5-step butterfly)."""
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & MASK32


def _mul32(y: torch.Tensor, c: int) -> torch.Tensor:
    """``y * c mod 2^32`` for uint32 words y and a 32-bit constant c, with
    every partial product below 2^48."""
    lo = y * (c & 0xFFFF)
    hi = ((y * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _scrambled_uniform(x: torch.Tensor, shift_bits) -> torch.Tensor:
    """Owen-scrambled Sobol integer -> float32 uniform in (0, 1): the
    Laine-Karras hash keyed by the Threefry word ``shift_bits`` in the
    bit-reversed domain, then the top 23 bits with a half-ulp centre,
    exact in float32 (see the JAX package's docstring for why a plain
    digital shift is not enough)."""
    y = _reverse32((x << (32 - BITS)) & MASK32)
    y = (y + shift_bits) & MASK32
    for c in _OWEN_CONSTANTS:
        y = y ^ _mul32(y, c)
    return uniform_from_bits(_reverse32(y))


def _shifted_normal(x: torch.Tensor, shift_bits) -> torch.Tensor:
    """Owen-scrambled Sobol integer -> standard normal (float32)."""
    return ndtri32(_scrambled_uniform(x, shift_bits))


@functools.lru_cache(maxsize=1 << 16)
def _owen_key(seed: int, stream: int, dim: int) -> int:
    """The Owen-hash key word of one dimension, a python int."""
    return int(random_bits(seed, stream, dim, OWEN_KEY_WORD)[0])


def _sobol_normal(sv, seed, stream, path_ids, dim: int) -> torch.Tensor:
    """The randomized Sobol normal of each path id in dimension ``dim``."""
    return _shifted_normal(sobol_bits(sv[dim], path_ids),
                           _owen_key(int(seed), int(stream), int(dim)))


def _device_table(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype,
                           device=resolve_device(device))


@dataclass(frozen=True)
class SobolDeviceSampler:
    """Randomized Sobol normals computed per step from the path id.

    The dimension of (step t, draw d) is ``t * n_draws + d``.  The torch
    loop calls :meth:`draws`; K2-K4 compute the same stream in the kernel
    from ``sv`` (``ops/fused_engine.py``).  Normals only: every dimension
    goes through the inverse CDF, so processes with uniform draw slots are
    refused (``engine.simulate.check_sampler``).
    """

    sv: torch.Tensor  # (n_dims, 30) int32 direction numbers

    normals_only = True

    @property
    def n_dims(self) -> int:
        return self.sv.shape[0]

    def draws(self, process, seed, stream, path_ids, t):
        D = process.n_draws
        return tuple(_sobol_normal(self.sv, seed, stream, path_ids,
                                   int(t) * D + d) for d in range(D))

    def validate(self, process, n_steps: int) -> None:
        """Every (step, draw) dimension must lie in the table."""
        need = n_steps * process.n_draws
        if self.n_dims < need:
            raise ValueError(
                f"Sobol table has {self.n_dims} dimensions but this run "
                f"needs n_steps*n_draws = {n_steps}*{process.n_draws} = "
                f"{need}; build with SobolDeviceSampler.create({n_steps}, "
                f"{process.n_draws})")

    @classmethod
    def create(cls, n_steps: int, n_draws: int = 1,
               scramble_seed: int | None = 0,
               device="cuda") -> "SobolDeviceSampler":
        """``scramble_seed`` applies a linear matrix scramble to the
        direction numbers (None keeps the raw Joe-Kuo numbers)."""
        sv = direction_numbers(n_steps * n_draws)
        if scramble_seed is not None:
            sv = lms_scramble(sv, scramble_seed)
        return cls(sv=_device_table(sv, torch.int32, device))


def brownian_bridge_matrix(n_steps: int) -> np.ndarray:
    """(T, T) matrix B with ``increments = z @ B.T`` in the bridge order:
    z_0 sets the endpoint, then midpoints of the widest intervals.  Each
    row has O(log T) nonzeros, and the rows are orthonormal."""
    T = n_steps
    a = np.zeros((T + 1, T))
    a[T, 0] = np.sqrt(float(T))
    k = 1
    segments = [(0, T)]
    while segments:
        nxt = []
        for (l, r) in segments:
            if r - l <= 1:
                continue
            mid = (l + r) // 2
            a[mid] = ((r - mid) * a[l] + (mid - l) * a[r]) / (r - l)
            a[mid, k] += np.sqrt((mid - l) * (r - mid) / (r - l))
            k += 1
            nxt += [(l, mid), (mid, r)]
        segments = nxt
    assert k == T, (k, T)
    return np.diff(a, axis=0)


def _bridge_tables(n_steps: int, scramble_seed):
    """(sv, dims, coeffs) numpy tables of the bridge construction: the
    (optionally LMS-scrambled) direction numbers, and per step the
    contributing bridge dims and weights, rows padded to a fixed width L
    with (dim 0, coeff 0)."""
    b = brownian_bridge_matrix(n_steps)
    nnz = [np.nonzero(row)[0] for row in b]
    width = max(len(ix) for ix in nnz)
    dims = np.zeros((n_steps, width), np.int32)
    coeffs = np.zeros((n_steps, width), np.float32)
    for t, ix in enumerate(nnz):
        dims[t, :len(ix)] = ix
        coeffs[t, :len(ix)] = b[t, ix]
    sv = direction_numbers(n_steps)
    if scramble_seed is not None:
        sv = lms_scramble(sv, scramble_seed)
    return sv, dims, coeffs


def bridge_schedule(dims: np.ndarray) -> np.ndarray:
    """(2T + 1,) int32 load schedule of a bridge plan (T, L): the kernels
    hold one bridge normal per slot, the dim of a tree level
    (csrc/bridge_levels.cuh), and compute a normal only when a slot takes
    a new dim.  Entries 0 .. T are the offsets of each step's loads (step
    t's are loads first[t] .. first[t + 1] - 1); then the loads in step
    order, each ``level << 16 | dim``, slots in order within a step.  A
    padded slot (dim 0 past slot 0, coefficient 0) is never loaded: its
    product is a zero whatever finite normal the level holds, and adding a
    zero leaves the sum's bits as they are."""
    dims = np.asarray(dims)
    T, L = dims.shape
    change = np.ones(dims.shape, bool)
    change[1:] = dims[1:] != dims[:-1]
    change[:, 1:] &= dims[:, 1:] != 0
    t, j = np.nonzero(change)  # row-major: step order, slots in order
    first = np.searchsorted(t, np.arange(T + 1))
    loads = (j.astype(np.int64) << 16) | dims[t, j]
    return np.concatenate([first, loads]).astype(np.int32)


@dataclass(frozen=True)
class SobolBridgeDeviceSampler:
    """Randomized Sobol with Brownian-bridge ordering, evaluated per step:
    ``eps_t = sum_j coeffs[t, j] * sobol_normal(dims[t, j])``, summed over
    the padded slots in order from 0.  Single-draw, normals only."""

    sv: torch.Tensor      # (T, 30) int32 direction numbers
    dims: torch.Tensor    # (T, L) int32 contributing bridge dims
    coeffs: torch.Tensor  # (T, L) float32 combination weights

    normals_only = True

    @property
    def n_steps(self) -> int:
        return int(self.dims.shape[0])

    @property
    def width(self) -> int:
        return int(self.dims.shape[1])

    def validate(self, process, n_steps: int) -> None:
        if process.n_draws != 1:
            raise ValueError("bridge sampler supports n_draws == 1")
        if n_steps > self.n_steps:
            name = type(self).__name__
            raise ValueError(
                f"bridge sampler built for {self.n_steps} steps but this run "
                f"has {n_steps}; build with {name}.create({n_steps})")

    def draws(self, process, seed, stream, path_ids, t):
        if process.n_draws != 1:
            raise ValueError("bridge sampler supports n_draws == 1")
        t = int(t)
        eps = torch.zeros(path_ids.shape, dtype=torch.float32,
                          device=path_ids.device)
        for dim, c in zip(self.dims[t].tolist(), self.coeffs[t]):
            eps = eps + c * _sobol_normal(self.sv, seed, stream, path_ids,
                                          dim)
        return (eps,)

    @classmethod
    def create(cls, n_steps: int, scramble_seed: int | None = 0,
               device="cuda"):
        sv, dims, coeffs = _bridge_tables(n_steps, scramble_seed)
        return cls(sv=_device_table(sv, torch.int32, device),
                   dims=_device_table(dims, torch.int32, device),
                   coeffs=_device_table(coeffs, torch.float32, device))


@dataclass(frozen=True)
class SobolBridgeKernelSampler(SobolBridgeDeviceSampler):
    """Bridge Sobol for K2-K4: the kernel holds one bridge normal per tree
    level, computes each of the T normals once per path when its level
    first needs it (``schedule``, the plan's loads), and combines each
    step's O(log T) normals with the plan's weights, in the same
    padded-slot order as :class:`SobolBridgeDeviceSampler` — the same
    stream, which the inherited :meth:`draws` computes on the torch loop.
    The JAX package keeps these tables transposed for its kernel
    (``sv_t``, ``dims_t``, ``coeffs_t``); here they keep the device
    sampler's layout.  Single-draw, normals only."""

    schedule: torch.Tensor  # (2T + 1,) int32 loads (bridge_schedule)

    @classmethod
    def create(cls, n_steps: int, scramble_seed: int | None = 0,
               device="cuda"):
        sv, dims, coeffs = _bridge_tables(n_steps, scramble_seed)
        return cls(sv=_device_table(sv, torch.int32, device),
                   dims=_device_table(dims, torch.int32, device),
                   coeffs=_device_table(coeffs, torch.float32, device),
                   schedule=_device_table(bridge_schedule(dims),
                                          torch.int32, device))

    def as_device_sampler(self) -> SobolBridgeDeviceSampler:
        return SobolBridgeDeviceSampler(sv=self.sv, dims=self.dims,
                                        coeffs=self.coeffs)

    def bridge_normals(self, seed, stream, path_ids) -> torch.Tensor:
        """The T bridge normals of every path, (T, n_paths) float32: the
        values the kernels hold per tree level, each computed once per
        path."""
        return torch.stack([_sobol_normal(self.sv, seed, stream, path_ids, d)
                            for d in range(self.n_steps)])
