"""Heston with its accrued variance in the port (``montecarlo_tpu_torch/
processes/heston_exposure.py``) against the JAX package's on the CPU, and
tests/test_exposure_varswap.py's variance-swap contracts on the port.

Tolerances, and why: a step is Heston's full-truncation Euler in the JAX
package's order (the port's ``processes/heston.py`` grouping), but
XLA:CPU may contract an a*b + c into an FMA where the port rounds twice,
and the normals and the root go through each platform's log, sin, cos
and sqrt: paths (S, v, ivar) within PATH_RTOL = 1e-5 in float32 and
1e-12 in float64, the variance and its accrual also absolutely within
ATOL = 1e-6 in float32, as tests/test_torch_heston.py holds Heston's
state: near v = 0 the truncated root amplifies a last-ULP difference
(measured 4.4e-7 at worst over 32 steps).  The
closures and ``im_norm`` on the same float64 arrays: rtol 1e-13.  The
accrued variance's mean against ``heston_varswap_expected_total`` at 4
std-err plus the Euler scheme's O(dt) bias at 64 steps (2% of it).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.simulate import simulate as jsimulate
from montecarlo_tpu.processes import heston_exposure as jx
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine.simulate import simulate
from montecarlo_tpu_torch.processes import heston_exposure as tx

torch.set_num_threads(1)

ARGS = dict(s0=100.0, v0=0.05, r=0.02, kappa=1.5, theta=0.04, xi=0.6,
            rho=-0.7)
PATH_RTOL = {jnp.float32: 1e-5, jnp.float64: 1e-12}
ATOL = {jnp.float32: 1e-6, jnp.float64: 1e-15}
TORCH = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def _models(T, n_steps, dtype=jnp.float32):
    return (jx.HestonExposure.create(**ARGS, dt=T / n_steps, dtype=dtype),
            tx.HestonExposure.create(**ARGS, dt=T / n_steps,
                                     dtype=TORCH[dtype], device="cpu"))


def _obs(jm, tm, n, steps, dtype, seed=2):
    want = np.asarray(jsimulate(jm, n, steps, seed=seed, mode="paths",
                                dtype=dtype,
                                observe=lambda p, s: p.exposure_obs(s)))
    got = simulate(tm, n, steps, seed=seed, mode="paths",
                   dtype=TORCH[dtype],
                   observe=lambda p, s: p.exposure_obs(s)).numpy()
    return got, want


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_paths_match_jax(dtype):
    """The xi = 0.6 set hits v <= 0 on some paths: the truncated root."""
    jm, tm = _models(1.0, 32, dtype)
    got, want = _obs(jm, tm, 1024, 32, dtype)
    assert got.shape == want.shape == (33, 1024, 3)
    assert (got[..., 1] < 0).any()
    np.testing.assert_allclose(got[..., 0], want[..., 0],
                               rtol=PATH_RTOL[dtype])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:],
                               rtol=PATH_RTOL[dtype], atol=ATOL[dtype])


def test_create_converts_and_refuses_as_jax():
    jm, tm = _models(1.0, 8)
    fields = {k: np.asarray(v) for k, v in jm._asdict().items()}
    conv = process_from_numpy("heston_exposure", fields, device="cpu")
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      fields[name], err_msg=name)
        # convert's leaves are 1-element arrays where create's are 0-d.
        leaf = getattr(tm, name)
        assert torch.equal(getattr(conv, name).reshape(leaf.shape), leaf)
    for bad, match in ((dict(kappa=0.0), "kappa"), (dict(rho=-1.5), "rho")):
        with pytest.raises(ValueError, match=match):
            tx.HestonExposure.create(**{**ARGS, **bad}, dt=0.1,
                                     device="cpu")


def test_closures_and_protocol_match_jax():
    jm, tm = _models(1.0, 16, jnp.float64)
    got, _ = _obs(jm, tm, 512, 16, jnp.float64)
    obs = np.moveaxis(got, -1, 1)                       # (T+1, 3, N)
    dvs = np.random.default_rng(1).standard_normal(obs.shape)
    o_t, d_t = torch.from_numpy(obs), torch.from_numpy(dvs)
    o_j, d_j = jnp.asarray(obs), jnp.asarray(dvs)
    np.testing.assert_array_equal(tm.wwr_state(o_t).numpy(),
                                  np.asarray(jm.wwr_state(o_j)))
    np.testing.assert_allclose(tm.im_norm(d_t, o_t, 10 / 252).numpy(),
                               np.asarray(jm.im_norm(d_j, o_j, 10 / 252)),
                               rtol=1e-13)
    par = tx.heston_varswap_expected_total(tm, 1.0)
    assert par == jx.heston_varswap_expected_total(jm, 1.0)
    pairs = [(tx.heston_forward_value_fn(tm, 101.0, 1.0),
              jx.heston_forward_value_fn(jm, 101.0, 1.0)),
             (tx.heston_varswap_value_fn(tm, par, 1.0, notional=2.0),
              jx.heston_varswap_value_fn(jm, par, 1.0, notional=2.0))]
    for tv, jv in pairs:
        for i in (0, 5, 16):
            np.testing.assert_allclose(tv(o_t[i], i / 16).numpy(),
                                       np.asarray(jv(o_j[i], i / 16)),
                                       rtol=1e-13, atol=1e-15)
    varswap = tx.heston_varswap_value_fn(tm, par, 1.0)
    # The par strike's t = 0 mark is exactly zero; past T the swap is gone.
    assert float(torch.max(torch.abs(varswap(o_t[0], 0.0)))) < 1e-15
    assert float(torch.max(torch.abs(varswap(o_t[16], 1.5)))) == 0.0


def test_accrued_variance_is_the_cir_expectation():
    _, tm = _models(1.0, 64)
    ivar = simulate(tm, 1 << 14, 64, seed=9,
                    observe=lambda p, s: s.ivar).double().numpy()
    want = tx.heston_varswap_expected_total(tm, 1.0)
    se = ivar.std(ddof=1) / np.sqrt(ivar.size)
    assert abs(ivar.mean() - want) < 4 * se + 0.02 * want, (ivar.mean(),
                                                             want)
