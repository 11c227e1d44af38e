"""The equity-Vasicek hybrid in the port (``montecarlo_tpu_torch/
processes/hybrid.py``) against the JAX package's on the CPU, and
tests/test_hybrid.py's contracts on the port.

Tolerances, and why: the create-time constants (the host float64
transition Cholesky, e^{-kappa dt}, B(dt)) are the same float64 numbers
rounded once: bitwise.  A step is the JAX package's float operations in
its order, but XLA:CPU may contract an a*b + c into an FMA where the port
rounds twice, and the normals go through each platform's log, sin and
cos: paths (S, r, int r) within PATH_RTOL = 1e-5 in float32 (measured
below 1e-6) and 1e-12 in float64; ``hybrid_price_mc``'s mean and std-err
(float32 sums in each library's order) at the same rtol.  The closed form
is the same float64 Python arithmetic: rtol 1e-14.  The contracts are
tests/test_hybrid.py's at 4 std-err.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine.simulate import simulate as jsimulate
from montecarlo_tpu.processes import hybrid as jh
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine.simulate import simulate
from montecarlo_tpu_torch.processes import hybrid as th

torch.set_num_threads(1)

S0, R0, KAP, TH, SR, SS, RHO = 100.0, 0.03, 0.6, 0.05, 0.015, 0.22, -0.35
PATH_RTOL = {jnp.float32: 1e-5, jnp.float64: 1e-12}
TORCH = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def _models(T, n_steps, dtype=jnp.float32, rho=RHO):
    args = (S0, R0, KAP, TH, SR, SS, rho, T / n_steps)
    return (jh.EquityVasicekHybrid.create(*args, dtype=dtype),
            th.EquityVasicekHybrid.create(*args, dtype=TORCH[dtype],
                                          device="cpu"))


@pytest.mark.parametrize("rho", [RHO, 1.0])
def test_create_matches_jax_and_converts(rho):
    jm, tm = _models(5.0, 4, rho=rho)
    fields = {k: np.asarray(v) for k, v in jm._asdict().items()}
    conv = process_from_numpy("hybrid", fields, device="cpu")
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      fields[name], err_msg=name)
        # convert's leaves are 1-element arrays where create's are 0-d.
        leaf = getattr(tm, name)
        assert torch.equal(getattr(conv, name).reshape(leaf.shape), leaf)
    with pytest.raises(ValueError, match="kappa"):
        th.EquityVasicekHybrid.create(S0, R0, 0.0, TH, SR, SS, RHO, 0.1,
                                      device="cpu")
    with pytest.raises(ValueError, match="rho"):
        th.EquityVasicekHybrid.create(S0, R0, KAP, TH, SR, SS, 1.5, 0.1,
                                      device="cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_paths_match_jax(dtype):
    jm, tm = _models(2.0, 16, dtype)
    want = np.asarray(jsimulate(jm, 1024, 16, seed=5, mode="paths",
                                dtype=dtype,
                                observe=lambda p, s: p.exposure_obs(s)))
    got = simulate(tm, 1024, 16, seed=5, mode="paths", dtype=TORCH[dtype],
                   observe=lambda p, s: p.exposure_obs(s)).numpy()
    assert got.shape == want.shape == (17, 1024, 3)
    np.testing.assert_allclose(got, want, rtol=PATH_RTOL[dtype],
                               atol=1e-12)
    obs = np.moveaxis(got, -1, 1)
    dvs = np.random.default_rng(3).standard_normal(obs.shape)
    o_t, d_t = torch.from_numpy(obs), torch.from_numpy(dvs)
    o_j, d_j = jnp.asarray(obs), jnp.asarray(dvs)
    np.testing.assert_array_equal(tm.wwr_state(o_t).numpy(),
                                  np.asarray(jm.wwr_state(o_j)))
    for a, b in ((tm.pathwise_discount(o_t), jm.pathwise_discount(o_j)),
                 (tm.im_norm(d_t, o_t, 10 / 252),
                  jm.im_norm(d_j, o_j, 10 / 252))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=PATH_RTOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("payoff", ["call", "put"])
def test_price_mc_matches_jax(dtype, payoff):
    jm, tm = _models(5.0, 8, dtype)
    k = 110.0
    jpay = ((lambda s: jnp.maximum(s - k, 0.0)) if payoff == "call"
            else (lambda s: jnp.maximum(k - s, 0.0)))
    tpay = ((lambda s: torch.clamp(s - k, min=0.0)) if payoff == "call"
            else (lambda s: torch.clamp(k - s, min=0.0)))
    want = jh.hybrid_price_mc(jm, jpay, 4096, 8, seed=3, dtype=dtype)
    got = th.hybrid_price_mc(tm, tpay, 4096, 8, seed=3, dtype=TORCH[dtype])
    assert got["n_paths"] == want["n_paths"] == 4096
    for key in ("price", "std_err"):
        assert got[key].dtype == TORCH[dtype]
        assert float(got[key]) == pytest.approx(float(want[key]),
                                                rel=PATH_RTOL[dtype]), key


def test_closed_form_and_contracts_on_the_port():
    """The closed form equals JAX's; tests/test_hybrid.py: the 5y call at
    4 steps within 4 std-err of it (no discretization error), and the
    discounted stock a martingale at s0."""
    k, T = 110.0, 5.0
    cf = th.hybrid_call_closed_form(S0, k, T, R0, KAP, TH, SR, SS, RHO)
    assert cf == pytest.approx(jh.hybrid_call_closed_form(
        S0, k, T, R0, KAP, TH, SR, SS, RHO), rel=1e-14)
    _, tm = _models(T, 4)
    est = th.hybrid_price_mc(tm, lambda s: torch.clamp(s - k, min=0.0),
                             1 << 15, 4, seed=3)
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"])
    _, tm = _models(2.0, 8)
    est = th.hybrid_price_mc(tm, lambda s: s, 1 << 15, 8, seed=7)
    assert abs(float(est["price"]) - S0) < 4 * float(est["std_err"])
