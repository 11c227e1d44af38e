"""Uniform and normal variates from Threefry counters, on torch tensors.

The same functions as ``montecarlo_tpu/rng/normal.py``, keyed only by
(seed, stream, global path id, draw index).  float32 throughout: every
constant is rounded to float32 once, as the JAX package does, so the
integer-only steps (`uniform_from_bits`, `exp32`) agree with it bitwise and
the ones that call the platform's log/sqrt/sin/cos agree to a few ULP.
"""

from __future__ import annotations

import numpy as np
import torch

from montecarlo_tpu_torch.rng.threefry import MASK32, as_words, random_bits

F32 = torch.float32


def _f32(x: float) -> float:
    """A python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


_TWO_PI = _f32(6.283185307179586)


def _device(x):
    return x.device if torch.is_tensor(x) else None


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Map uint32 words to a float32 uniform in the *open* interval (0, 1):
    u = ((bits >> 9) + 0.5) * 2^-23, exact at every step."""
    hi = (bits >> 9).to(F32)
    return (hi + 0.5) * _f32(2.0 ** -23)


def boxmuller_pair(b0: torch.Tensor, b1: torch.Tensor):
    """Two independent standard normals from two uint32 word tensors."""
    u1 = uniform_from_bits(b0)
    u2 = uniform_from_bits(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def normal_pair(seed: int, stream: int, c0, c1):
    """The canonical Box-Muller pair for counter (c0, c1)."""
    b0, b1 = random_bits(seed, stream, c0, c1)
    return boxmuller_pair(b0, b1)


def normal_draw(seed: int, stream: int, path_ids, draw_index):
    """One standard normal per (global path id, draw index): component
    ``m & 1`` of the Box-Muller pair from counter ``(i, m >> 1)``."""
    m = as_words(draw_index, _device(path_ids))
    z0, z1 = normal_pair(seed, stream, path_ids, m >> 1)
    return torch.where((m & 1) == 0, z0, z1)


def normal_matrix(seed: int, stream: int, path_ids, t: int, n_draws: int):
    """``n_draws`` normals per path for step ``t``, shaped
    ``path_ids.shape + (n_draws,)``, with draw index ``m = t*n_draws + d``."""
    ids = as_words(path_ids)
    m = (int(t) * n_draws + torch.arange(n_draws, device=ids.device)) & MASK32
    return normal_draw(seed, stream, ids[..., None], m)


def uniform_draw(seed: int, stream: int, path_ids, draw_index):
    """One uniform(0,1) per (global path id, draw index), same convention as
    :func:`normal_draw`."""
    m = as_words(draw_index, _device(path_ids))
    b0, b1 = random_bits(seed, stream, path_ids, m >> 1)
    return uniform_from_bits(torch.where((m & 1) == 0, b0, b1))


def uniform_pair(seed: int, stream: int, c0, c1):
    """Both uniform halves of one cipher call (draw indices 2*c1, 2*c1+1)."""
    b0, b1 = random_bits(seed, stream, c0, c1)
    return uniform_from_bits(b0), uniform_from_bits(b1)


_LOG2E = _f32(1.4426950408889634)
_LN2_HI = _f32(0.693359375)
_LN2_LO = _f32(-2.12194440054690583e-4)
_EXP_POLY = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def exp32(x: torch.Tensor) -> torch.Tensor:
    """Accurate float32 exp from IEEE-exact f32 mul/add and integer shifts
    (Cody-Waite reduction + the Cephes expf polynomial) — bitwise equal to
    ``montecarlo_tpu.rng.normal.exp32`` on every backend.  Domain |x| <= 20;
    inputs outside clamp to the boundary."""
    x = torch.clamp(x.to(F32), -20.0, 20.0)
    nf = torch.floor(x * _LOG2E + 0.5)
    r = x - nf * _LN2_HI
    r = r - nf * _LN2_LO
    p = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        p = p * r + c
    er = p * r * r + r + 1.0
    # 2^n via two exact integer shifts (n split so both stay in [0, 31]).
    n = nf.to(torch.int32)
    n1 = n >> 1  # arithmetic shift: floor(n/2)
    n2 = n - n1
    one = torch.ones_like(n)
    s1 = (one << (n1 + 15)).to(F32)
    s2 = (one << (n2 + 15)).to(F32)
    return er * s1 * (s2 * _f32(2.0 ** -30))


_LOG_LO = _f32(2.5e-9)
_LOG_HI = _f32(5e8)


def log32(x: torch.Tensor) -> torch.Tensor:
    """Accurate float32 log: one Newton step y + (x*exp32(-y) - 1) from the
    platform log's seed.  Domain [2.5e-9, 5e8]; inputs clamp to it."""
    x = torch.clamp(x.to(F32), _LOG_LO, _LOG_HI)
    y = torch.log(x)
    return y + (x * exp32(-y) - 1.0)


# Wichura's AS241 PPND7 coefficients, float32.
_C_NUM = tuple(_f32(c) for c in (59.109374720, 159.29113202, 50.434271938,
                                 3.3871327179))
_C_DEN = tuple(_f32(c) for c in (67.187563600, 78.757757664, 17.895169469,
                                 1.0))
_M_NUM = tuple(_f32(c) for c in (0.17023821103, 1.3067284816, 2.7568153900,
                                 1.4234372777))
_M_DEN = tuple(_f32(c) for c in (0.12021132975, 0.73700164250, 1.0))
_F_NUM = tuple(_f32(c) for c in (0.017337203997, 0.42868294337, 3.0812263860,
                                 6.6579051150))
_F_DEN = tuple(_f32(c) for c in (0.012258202635, 0.24197894225, 1.0))


def _horner(coeffs, r):
    acc = coeffs[0] * r + coeffs[1]
    for c in coeffs[2:]:
        acc = acc * r + c
    return acc


def ndtri32(u: torch.Tensor) -> torch.Tensor:
    """Inverse standard-normal CDF (AS241 PPND7, ~1e-7 absolute), float32,
    same operation order as ``montecarlo_tpu.rng.normal.ndtri32``.  Input in
    the open interval (0, 1)."""
    u = u.to(F32)
    q = u - 0.5
    r_c = _f32(0.180625) - q * q
    central = q * _horner(_C_NUM, r_c) / _horner(_C_DEN, r_c)
    p_tail = torch.clamp(torch.minimum(u, 1.0 - u), _f32(1e-30), 0.5)
    r_t = torch.sqrt(-torch.log(p_tail))
    mid = _horner(_M_NUM, r_t - 1.6) / _horner(_M_DEN, r_t - 1.6)
    far = _horner(_F_NUM, r_t - 5.0) / _horner(_F_DEN, r_t - 5.0)
    tail = torch.where(r_t <= 5.0, mid, far)
    tail = torch.where(q < 0, -tail, tail)
    return torch.where(torch.abs(q) <= _f32(0.425), central, tail)


def index_from_uniform(u: torch.Tensor, n: int) -> torch.Tensor:
    """floor(u*n) with an n-1 clamp for the u->1 edge, int32."""
    idx = torch.floor(u.to(F32) * float(np.float32(n))).to(torch.int32)
    return torch.clamp(idx, max=int(n) - 1)


def categorical_draw(seed: int, stream: int, path_ids, draw_index, n: int):
    """A uniform integer index in [0, n) per (path, draw)."""
    return index_from_uniform(uniform_draw(seed, stream, path_ids,
                                           draw_index), n)
