"""The port's variance reducers (``engine/control_variate.py``,
``engine/importance.py``) and the quanto pair (``engine/payoffs.py``)
against the JAX package's and their closed forms.

Both sides run in float32.  Tolerances, and why:

- ``cv_estimate`` on the same float32 inputs: rtol 1e-5 (the means and sums
  are taken in another order); ``variance_ratio`` rtol 1e-4 (a ratio of
  two sums of squares of differences).
- ``importance_sampled_estimate``: the shifted GBM's terminal prices agree
  within 2e-6 relative (the normals within 4.8e-7), the weights are an
  exp of a sum of ~T normals: price and std-err rtol 1e-4, ``ess`` rtol
  1e-4; the shift bitwise (the same float32 operations).
- ``stratified_terminal_estimate``: the uniforms are bitwise JAX's; the
  inverse normal is ``torch.special.ndtri`` against
  ``jax.scipy.special.ndtri``, two float32 implementations that differ by
  a few ULPs: the normals within 2e-6 absolute, the price rtol 1e-5, the
  replicate std-err rtol 1e-3 (a difference of close replicate means).
- The quanto closed form in float64 on both sides: rtol 1e-12.
- The JAX tests' own gates (tests/test_samplers.py, test_engine.py) run on
  the port at their sizes and bounds.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import ndtri as jndtri

from montecarlo_tpu.engine import control_variate as jcv
from montecarlo_tpu.engine import importance as jis
from montecarlo_tpu.engine import payoffs as jpay
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.rng.normal import uniform_draw as juniform
from montecarlo_tpu_torch.engine import (black_scholes_call,
                                         black_scholes_quanto_call,
                                         cv_estimate, european_call,
                                         importance_sampled_estimate,
                                         mc_estimate, quanto_drift,
                                         shift_to_strike, simulate,
                                         stratified_terminal_estimate)
from montecarlo_tpu_torch.engine.importance import STRATA_STREAM
from montecarlo_tpu_torch.processes import GBM
from montecarlo_tpu_torch.rng.normal import uniform_draw

S0, R, SIGMA, STRIKE, N_STEPS = 100.0, 0.03, 0.2, 105.0, 64
F32 = jnp.float32


def _gbm():
    return GBM.create(S0, R, SIGMA, 1 / 252, device="cpu")


def _jgbm():
    return JGBM.create(S0, R, SIGMA, 1 / 252, dtype=F32)


def _call(k):
    return lambda s: torch.clamp(s - k, min=0.0)


def _jcall(k):
    return lambda s: jnp.maximum(s - k, 0.0)


def test_cv_estimate_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.lognormal(4.6, 0.2, 1 << 14).astype(np.float32)
    y = np.maximum(x - STRIKE, 0).astype(np.float32)
    got = cv_estimate(torch.from_numpy(y), torch.from_numpy(x), 101.0,
                      discount=0.97)
    want = jcv.cv_estimate(jnp.asarray(y), jnp.asarray(x), 101.0,
                           discount=0.97)
    assert set(got) == set(want)
    for k in ("price", "std_err", "n_paths", "beta"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["variance_ratio"]),
                               float(want["variance_ratio"]), rtol=1e-4)


def test_control_variate_reduces_std_err():
    """tests/test_samplers.py's gate on the port: the terminal price as the
    control of a European call."""
    n, t = 1 << 15, N_STEPS / 252
    terminal = simulate(_gbm(), n, N_STEPS, seed=42)
    payoff = european_call(terminal, STRIKE)
    disc = float(np.exp(-R * t))
    plain = mc_estimate(payoff, disc)
    cv = cv_estimate(payoff, terminal, control_mean=S0 * np.exp(R * t),
                     discount=disc)
    assert float(cv["std_err"]) < 0.7 * float(plain["std_err"])
    assert float(cv["variance_ratio"]) < 0.5
    assert abs(float(cv["price"]) - float(plain["price"])) < \
        4 * float(plain["std_err"])


@pytest.mark.parametrize("strike", [130.0, 180.0])
def test_importance_sampling_matches_jax_and_black_scholes(strike):
    """The 2.6-sigma and 5.9-sigma OTM calls of tests/test_samplers.py: the
    port against JAX's estimator, Black-Scholes within 5 std-err, and (at
    130) a fraction of plain Monte Carlo's error."""
    n, t = 1 << 16, N_STEPS / 252
    disc = float(np.exp(-R * t))
    proc = _gbm()
    shift = shift_to_strike(proc, strike, N_STEPS)
    jshift = jis.shift_to_strike(_jgbm(), strike, N_STEPS)
    assert float(shift) == float(jshift)
    out = importance_sampled_estimate(proc, _call(strike), n, N_STEPS,
                                      seed=3, shift=float(shift),
                                      discount=disc)
    jout = jis.importance_sampled_estimate(_jgbm(), _jcall(strike), n,
                                           N_STEPS, seed=3,
                                           shift=float(jshift),
                                           discount=disc, dtype=F32)
    assert set(out) == set(jout)
    for k in ("price", "std_err", "ess"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-4,
                                   err_msg=k)
    assert out["n_paths"] == n
    bs = black_scholes_call(S0, strike, R, SIGMA, t)
    assert abs(float(out["price"]) - bs) < 5 * float(out["std_err"])
    if strike == 130.0:
        plain = mc_estimate(european_call(simulate(proc, n, N_STEPS, seed=3),
                                          strike), disc)
        assert float(out["std_err"]) < 0.3 * float(plain["std_err"])
    else:
        assert float(out["std_err"]) < 0.1 * bs
    assert 0.0 < float(out["ess"]) < n


def test_importance_sampling_zero_shift_is_plain():
    n, steps = 1 << 14, 16
    plain = mc_estimate(european_call(simulate(_gbm(), n, steps, seed=5),
                                      STRIKE))
    is0 = importance_sampled_estimate(_gbm(), _call(STRIKE), n, steps,
                                      seed=5, shift=0.0)
    np.testing.assert_allclose(float(is0["price"]), float(plain["price"]),
                               rtol=1e-5)
    assert float(is0["ess"]) == pytest.approx(n, rel=1e-5)


def test_stratified_matches_jax_and_black_scholes():
    n, t = 1 << 14, N_STEPS / 252
    disc = float(np.exp(-R * t))
    ids = torch.arange(n, dtype=torch.int64)
    v = uniform_draw(3, STRATA_STREAM, ids, 0)
    jv = juniform(3, STRATA_STREAM, jnp.arange(n, dtype=jnp.uint32),
                  jnp.uint32(0), F32)
    assert np.array_equal(v.numpy(), np.asarray(jv))
    u = torch.clamp((ids.to(torch.float32) + v) / torch.tensor(float(n)),
                    1e-7, 1 - 1e-7)
    np.testing.assert_allclose(torch.special.ndtri(u).numpy(),
                               np.asarray(jndtri(jnp.asarray(u.numpy()))),
                               rtol=0, atol=2e-6)
    out = stratified_terminal_estimate(_gbm(), _call(STRIKE), n, seed=3,
                                       t_years=t, discount=disc)
    jout = jis.stratified_terminal_estimate(_jgbm(), _jcall(STRIKE), n,
                                            seed=3, t_years=t, discount=disc,
                                            dtype=F32)
    assert set(out) == set(jout) and out["n_paths"] == n
    np.testing.assert_allclose(float(out["price"]), float(jout["price"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["std_err"]), float(jout["std_err"]),
                               rtol=1e-3)
    # tests/test_samplers.py's gate.
    bs = black_scholes_call(S0, STRIKE, R, SIGMA, t)
    assert abs(float(out["price"]) - bs) < 5 * float(out["std_err"]) + 1e-4
    plain = mc_estimate(european_call(simulate(_gbm(), n, N_STEPS, seed=3),
                                      STRIKE), disc)
    assert float(out["std_err"]) < 0.1 * float(plain["std_err"])


def test_stratified_refusals():
    """JAX's two refusals: a path count the replicates do not divide, and
    more than 2^24 paths in float32 (the port's only width)."""
    with pytest.raises(ValueError, match="divisible"):
        stratified_terminal_estimate(_gbm(), _call(STRIKE), 1000, seed=1,
                                     t_years=1.0, n_replicates=16)
    with pytest.raises(ValueError, match="2\\^24"):
        stratified_terminal_estimate(_gbm(), _call(STRIKE), (1 << 24) + 16,
                                     seed=1, t_years=1.0)


def test_quanto_pair_matches_jax_and_monte_carlo():
    """tests/test_engine.py's quanto gate on the port, and the closed form
    against JAX's in float64."""
    s0, k, r_d, r_f = 100.0, 105.0, 0.05, 0.01
    sig, sig_fx, rho, t = 0.25, 0.12, -0.45, 1.0
    mu = quanto_drift(r_f, sig, sig_fx, rho)
    assert mu == jpay.quanto_drift(r_f, sig, sig_fx, rho)
    cf = black_scholes_quanto_call(s0, k, r_d, r_f, sig, sig_fx, rho, t)
    assert cf.dtype == torch.float64
    np.testing.assert_allclose(float(cf), float(jpay.black_scholes_quanto_call(
        s0, k, r_d, r_f, sig, sig_fx, rho, t)), rtol=1e-12)
    steps = 64
    term = simulate(GBM.create(s0, mu, sig, t / steps, device="cpu"),
                    1 << 17, steps, seed=9)
    est = mc_estimate(european_call(term, k), float(np.exp(-r_d * t)))
    assert abs(float(est["price"]) - float(cf)) < 4 * float(est["std_err"])
    cf0 = float(black_scholes_quanto_call(s0, k, r_d, r_f, sig, sig_fx, 0.0,
                                          t))
    bs_rf = black_scholes_call(s0, k, r_f, sig, t) * np.exp((r_f - r_d) * t)
    np.testing.assert_allclose(cf0, bs_rf, rtol=1e-10)
