"""The port's gamma Newton sampler (``rng/gamma.py``: ``gamma1p32``,
``gamma_icdf_boost32``, ``gamma_from_uniforms32``) against the JAX
package's ``rng/gamma.py`` and scipy.

Tolerances, and why:

- ``gamma1p32``: bitwise (float32 multiplies and adds of the same
  constants in the same order on both sides).
- ``gamma_icdf_boost32``: within 64 float32 ULPs of JAX's (measured 39 on
  2^17 (b, u) pairs, 80% bitwise): ``log32`` takes each platform's log as
  its seed and ``ndtri32``'s tail its platform's log and sqrt (torch's
  float32 sqrt on the CPU is not the IEEE root for ~0.6% of arguments),
  and 4 Newton steps carry a one-ULP difference in a residual into the
  quantile.
- ``gamma_from_uniforms32``: relative difference within 64 ULPs x (1 +
  |ln u_boost| / a) where JAX's value is a normal float32 (measured 31 of
  that unit): the boost factor ``exp(log32(u) / a)`` multiplies a log's
  one-ULP difference by 1/a.  Below the float32 normal range (a few in a
  thousand draws at a ~ 0.01) within 16 x 2^-126 absolute.
- The quantile against scipy's float64 inverse at the float32 inputs:
  rtol 1.6e-6 over u in [1e-6, 1 - 6e-8], b in (1, 2] (the bound the JAX
  module states; its own test asserts 5e-6).
- Moments, KS and the tiny-shape tail mass: tests/test_gamma_rng.py's
  gates on the port's own uniforms.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.rng import gamma as jg
from montecarlo_tpu_torch.rng import gamma as tg
from montecarlo_tpu_torch.rng.normal import uniform_draw

N = 1 << 17
EPS32 = 2.0 ** -24


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_gamma1p32_bitwise_jax():
    a = np.concatenate([np.linspace(0.0, 1.0, 1001),
                        np.random.default_rng(0).uniform(0, 1, N)])
    a = a.astype(np.float32)
    want = np.asarray(jg.gamma1p32(jnp.asarray(a)))
    got = tg.gamma1p32(torch.from_numpy(a)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_gamma_icdf_boost32_within_64_ulps_of_jax():
    rng = np.random.default_rng(1)
    b = rng.uniform(1.0, 2.0, N).astype(np.float32)
    b[0], b[1] = np.float32(2.0), np.nextafter(np.float32(1.0), 2)
    u = rng.uniform(1e-6, 1.0 - 6e-8, N).astype(np.float32)
    u[:4] = [1e-6, 0.02, 0.5, 1.0 - 6e-8]
    want = np.asarray(jg.gamma_icdf_boost32(jnp.asarray(b), jnp.asarray(u)))
    got = tg.gamma_icdf_boost32(torch.from_numpy(b),
                                torch.from_numpy(u)).numpy()
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    assert _ulps(got, want).max() <= 64


def test_gamma_from_uniforms32_within_the_stated_bound_of_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0.01, 1.0, N).astype(np.float32)
    u_w = rng.uniform(0.0, 1.0, N).astype(np.float32)
    u_b = rng.uniform(0.0, 1.0, N).astype(np.float32)
    want = np.asarray(jg.gamma_from_uniforms32(
        jnp.asarray(a), jnp.asarray(u_w), jnp.asarray(u_b)))
    got = tg.gamma_from_uniforms32(torch.from_numpy(a), torch.from_numpy(u_w),
                                   torch.from_numpy(u_b)).numpy()
    assert np.all(got >= 0) and np.all(np.isfinite(got))
    normal = want >= np.finfo(np.float32).tiny
    bound = 64 * EPS32 * (1.0 + np.abs(np.log(u_b.astype(np.float64))) / a)
    rel = np.abs(got - want)[normal] / want[normal]
    assert np.all(rel <= bound[normal])
    assert np.all(np.abs(got - want)[~normal] <= 16 * 2.0 ** -126)
    # The port's definition: the boost identity on its own pieces.
    w = tg.gamma_icdf_boost32(torch.from_numpy(a) + 1.0,
                              torch.from_numpy(u_w))
    boost = tg.expneg_wide32(tg.log32(torch.from_numpy(u_b))
                             / torch.from_numpy(a))
    assert torch.equal(torch.from_numpy(got), w * boost)


@pytest.mark.parametrize("b", [1.02, 1.2, 1.5, 1.8, 2.0])
def test_gamma_icdf_vs_scipy(b):
    """tests/test_gamma_rng.py's float32-faithful oracles: the lower tail
    inverts P at the float32 u, the upper tail Q at 1 - u."""
    from scipy.special import gammainccinv, gammaincinv

    lo = np.geomspace(1e-6, 0.5, 50)
    hi = np.geomspace(6e-8, 0.5, 50)
    u = np.concatenate([lo, 1.0 - hi]).astype(np.float32)
    ref = np.concatenate([
        gammaincinv(b, lo.astype(np.float32).astype(np.float64)),
        gammainccinv(b, 1.0 - (1.0 - hi).astype(np.float32)
                     .astype(np.float64))])
    got = tg.gamma_icdf_boost32(b, torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1.6e-6)


def _uniform_pairs(n, seed):
    ids = torch.arange(n, dtype=torch.int64)
    return uniform_draw(seed, 0, ids, 0), uniform_draw(seed, 0, ids, 1)


@pytest.mark.parametrize("a", [0.05, 0.3, 1.0])
def test_gamma_sample_moments(a):
    u_w, u_b = _uniform_pairs(1 << 16, seed=11)
    g = tg.gamma_from_uniforms32(a, u_w, u_b).numpy().astype(np.float64)
    n = g.size
    assert g.min() >= 0.0
    assert abs(g.mean() - a) < 5 * g.std() / np.sqrt(n)
    se_var = np.sqrt(((g - g.mean()) ** 4).mean() / n)
    assert abs(g.var() - a) < 5 * se_var


@pytest.mark.parametrize("a", [0.5, 0.9])
def test_gamma_sample_ks(a):
    from scipy.stats import kstest

    u_w, u_b = _uniform_pairs(1 << 14, seed=29)
    g = tg.gamma_from_uniforms32(a, u_w, u_b).numpy().astype(np.float64)
    assert kstest(g, "gamma", args=(a,)).pvalue > 1e-4


def test_gamma_tiny_shape_tail_mass():
    from scipy.stats import gamma as gamma_dist

    a = 0.02
    u_w, u_b = _uniform_pairs(1 << 16, seed=5)
    g = tg.gamma_from_uniforms32(a, u_w, u_b).numpy().astype(np.float64)
    n = g.size
    for thr in (1e-6, 1e-3, 0.1):
        frac = (g > thr).mean()
        ref = gamma_dist.sf(thr, a)
        se = np.sqrt(ref * (1 - ref) / n)
        assert abs(frac - ref) < 5 * se + 1e-4, (thr, frac, ref)
    assert abs(g.mean() - a) < 5 * g.std() / np.sqrt(n)


def test_gamma_reflection_anticorrelates():
    u_w, u_b = _uniform_pairs(1 << 14, seed=3)
    g = tg.gamma_from_uniforms32(0.5, u_w, u_b).numpy()
    g_anti = tg.gamma_from_uniforms32(0.5, 1.0 - u_w, 1.0 - u_b).numpy()
    assert np.corrcoef(g, g_anti)[0, 1] < -0.3

