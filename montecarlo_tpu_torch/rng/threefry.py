"""Threefry-2x32-20 counter-based RNG on torch tensors.

Same cipher, key and counter convention as the JAX package
(``montecarlo_tpu/rng/threefry.py``):

- key   = (k0, k1) = (seed_lo32, seed_hi32 XOR stream)
- c0    = global path id  (uint32)
- c1    = draw index      (uint32)

torch's CPU ``uint32`` lacks add, shifts and comparisons, so every 32-bit
word is carried in an ``int64`` tensor masked to ``0xFFFFFFFF`` after each
add and shift.  The values are then exactly the JAX uint32 words, on the CPU
and on the card alike; the CUDA kernels compute the same words in native
``uint32_t`` (``csrc/rng.cuh``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# Rotation schedule for Threefry-2x32 (Salmon et al. 2011, table 2).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Threefry key-schedule parity constant for 32-bit words.
_PARITY = 0x1BD11BDA


def as_words(x, device=None) -> torch.Tensor:
    """A uint32 word tensor (int64 holding values in [0, 2^32)) from a python
    int, a numpy array or a tensor; negative or wide values wrap mod 2^32."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds.

    Args:
      k0, k1: key words (python ints).
      c0, c1: counter words (word tensors or ints, broadcastable).

    Returns:
      (x0, x1): two int64 word tensors of the broadcast shape.
    """
    k0, k1 = int(k0) & MASK32, int(k1) & MASK32
    x0 = (as_words(c0) + k0) & MASK32
    x1 = (as_words(c1) + k1) & MASK32
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    for j in range(5):  # 5 blocks of 4 rounds = 20 rounds
        for r in _ROTATIONS[j % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(j + 1) % 3]) & MASK32
        x1 = (x1 + ks[(j + 2) % 3] + (j + 1)) & MASK32
    return x0, x1


def key_from_seed(seed: int, stream: int = 0):
    """The (k0, k1) key words of a 64-bit seed and a stream id, as python
    ints.  Distinct ``stream`` values give independent draw streams."""
    seed = int(seed)
    k0 = seed & MASK32
    k1 = ((seed >> 32) & MASK32) ^ (int(stream) & MASK32)
    return k0, k1


def random_bits(seed: int, stream: int, c0, c1):
    """64 bits of pseudo-randomness per (c0, c1) counter pair."""
    k0, k1 = key_from_seed(seed, stream)
    return threefry2x32(k0, k1, c0, c1)
