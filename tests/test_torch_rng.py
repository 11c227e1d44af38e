"""Port RNG core (montecarlo_tpu_torch.rng) against the JAX package.

Tolerances: Threefry words, uniforms, uniform/categorical draws and exp32
are integer-exact or IEEE-exact float32 on both sides, so they must match
bitwise.  Box-Muller normals and ndtri32 go through each platform's own
log/sqrt/sin/cos: absolute difference <= 1e-6.  log32 is one Newton step
from the platform log; it agrees to 1 ULP where |log x| >= 1 (every
price-scale spot), and near x = 1, where the step's own rounding (~2^-24
absolute) exceeds the result's ULP, to 2 ULP of 1.0 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.rng import normal as jnormal
from montecarlo_tpu.rng import threefry as jthreefry
from montecarlo_tpu_torch import rng as trng

torch.set_num_threads(1)

N = 1 << 14


def _words(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _counters(seed=0, n=N):
    r = np.random.default_rng(seed)
    key = r.integers(0, 2**32, 2, dtype=np.uint32)
    c0 = r.integers(0, 2**32, n, dtype=np.uint32)
    c1 = r.integers(0, 2**32, n, dtype=np.uint32)
    return key, c0, c1


def test_threefry_bitwise_matches_jax():
    key, c0, c1 = _counters()
    j0, j1 = jthreefry.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                    c0, c1)
    t0, t1 = trng.threefry2x32(int(key[0]), int(key[1]), _words(c0),
                               _words(c1))
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answer_vectors(key, ctr, want):
    """Random123's published known-answer tests for Threefry-2x32-20."""
    x0, x1 = trng.threefry2x32(key[0], key[1], ctr[0], ctr[1])
    assert (int(x0), int(x1)) == want


@pytest.mark.parametrize("seed,stream", [(0, 0), (7, 3),
                                         (2**40 + 12345, 9),
                                         (2**64 - 1, 2**32 - 1)])
def test_key_from_seed_matches_jax(seed, stream):
    jk = jthreefry.key_from_seed(seed, stream)
    assert trng.key_from_seed(seed, stream) == tuple(int(k) for k in jk)


def test_uniforms_bitwise_and_open():
    _, c0, _ = _counters(1)
    c0[:4] = [0, 1, 2**32 - 1, 2**31]
    want = np.asarray(jnormal.uniform_from_bits(jnp.asarray(c0)))
    got = trng.uniform_from_bits(_words(c0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    assert got.min() > 0.0 and got.max() < 1.0


def test_exp32_bitwise_matches_jax():
    x = np.random.default_rng(2).uniform(-25, 25, N).astype(np.float32)
    x[:3] = [0.0, -20.0, 20.0]
    want = np.asarray(jnormal.exp32(jnp.asarray(x)))
    np.testing.assert_array_equal(trng.exp32(torch.from_numpy(x)).numpy(),
                                  want)


def test_log32_within_one_ulp_of_jax():
    x = np.exp(np.random.default_rng(3).uniform(-19, 19, N)).astype(
        np.float32)
    x = np.concatenate([x, np.float32([50.0, 100.0, 105.0, 150.0])])
    want = np.asarray(jnormal.log32(jnp.asarray(x)))
    got = trng.log32(torch.from_numpy(x)).numpy()
    far = np.abs(want) >= 1.0
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps[far].max() <= 1
    assert np.abs(got - want)[~far].max() <= 2 * np.spacing(np.float32(1.0))


def test_boxmuller_and_normal_draw_within_1e6():
    key, c0, c1 = _counters(4)
    jb = jthreefry.threefry2x32(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                c0, c1)
    tb = trng.threefry2x32(int(key[0]), int(key[1]), _words(c0), _words(c1))
    for j, t in zip(jnormal.boxmuller_pair(*jb), trng.boxmuller_pair(*tb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6)
    ids = np.arange(N, dtype=np.uint32)
    for m in (0, 1, 6, 7):
        j = np.asarray(jnormal.normal_draw(11, 2, jnp.asarray(ids), m))
        t = trng.normal_draw(11, 2, _words(ids), m).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_normal_matrix_convention():
    ids = _words(np.arange(256))
    mat = trng.normal_matrix(99, 0, ids, t=7, n_draws=3)
    assert mat.shape == (256, 3)
    for d in range(3):
        torch.testing.assert_close(mat[:, d],
                                   trng.normal_draw(99, 0, ids, 21 + d),
                                   rtol=0, atol=0)


def test_uniform_and_categorical_draws_bitwise():
    ids = np.arange(4096, dtype=np.uint32)
    for m in (0, 3):
        j = np.asarray(jnormal.uniform_draw(21, 1, jnp.asarray(ids), m))
        t = trng.uniform_draw(21, 1, _words(ids), m).numpy()
        np.testing.assert_array_equal(t, j)
    j = np.asarray(jnormal.categorical_draw(5, 2, jnp.asarray(ids), 4, 17))
    t = trng.categorical_draw(5, 2, _words(ids), 4, 17).numpy()
    np.testing.assert_array_equal(t, j)
    u0, u1 = trng.uniform_pair(21, 1, _words(ids), 1)
    np.testing.assert_array_equal(u0.numpy(), trng.uniform_draw(
        21, 1, _words(ids), 2).numpy())
    np.testing.assert_array_equal(u1.numpy(), trng.uniform_draw(
        21, 1, _words(ids), 3).numpy())


def test_ndtri32_within_1e6():
    u = np.random.default_rng(5).uniform(1e-7, 1 - 1e-7, N).astype(
        np.float32)
    want = np.asarray(jnormal.ndtri32(jnp.asarray(u), jnp.float32))
    got = trng.ndtri32(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_path_ids_wrap_mod_2_32():
    from montecarlo_tpu.engine.simulate import path_ids_for as jids
    from montecarlo_tpu_torch.engine import path_ids_for

    off = 2**32 - 5
    want = np.asarray(jids(10, off)).astype(np.int64)
    np.testing.assert_array_equal(path_ids_for(10, off).numpy(), want)
