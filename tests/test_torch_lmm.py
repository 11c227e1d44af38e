"""The LIBOR market model in the port (``montecarlo_tpu_torch/processes/
lmm.py``, the LMM Bermudan of ``engine/bermudan.py`` and the LMM
calibration of ``engine/rates_calibration.py``) against the JAX package's
on the CPU, and tests/test_lmm.py's contracts on the port.

Tolerances, and why:

- ``LMM.draws`` (one ``normal_matrix`` call a step) is the same integer
  and float work as the per-draw mixin: bitwise, at K in {1, 2, 3, 16}
  (odd K splits a Box-Muller pair across two steps).
- Paths (``exposure_obs`` rows): the step's two products (``z @ chol.T``,
  ``w @ corr_drift``) are summed in the BLAS's order, not XLA's, and
  ``log1p`` and the normals' log, sin and cos are each platform's: within
  PATH_RTOL = {float32: 1e-5, float64: 1e-9} (measured below 1e-6 and
  1e-15).  Row 0's log B is exactly 0 on both sides.
- Estimators (caplet, swaption, Bermudan) over those paths: float64 at
  RTOL64 = 1e-12 (the sums' orders; no exercise decision flips at these
  sizes), float32 at PATH_RTOL.
- Host float64 closed forms and the calibration over the same float32
  leaves: rtol 1e-13 (the same NumPy and SciPy arithmetic; the
  golden-section beta exactly).
- The exposure protocol on the same arrays: float64 at 1e-12 (the
  three-operand einsum's contraction order).
- The gradient through ``create`` (tensors that require grad) against
  ``jax.grad`` of the same function, float64: rtol 1e-9.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import bermudan as jb
from montecarlo_tpu.engine import rates_calibration as jrc
from montecarlo_tpu.engine.simulate import simulate as jsimulate
from montecarlo_tpu.processes import lmm as jl
from montecarlo_tpu.samplers import SobolSampler as JSobol
from montecarlo_tpu_torch.engine import bermudan as tb
from montecarlo_tpu_torch.engine import rates_calibration as trc
from montecarlo_tpu_torch.engine.simulate import simulate
from montecarlo_tpu_torch.processes import lmm as tl
from montecarlo_tpu_torch.processes.base import NormalDrawsMixin
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from montecarlo_tpu_torch.samplers import SobolSampler

torch.set_num_threads(1)

K, DELTA = 8, 0.25
F0 = 0.03 + 0.004 * np.arange(K) / K
SIG = 0.22 - 0.06 * np.arange(K) / K
PATH_RTOL = {jnp.float32: 1e-5, jnp.float64: 1e-9}
RTOL64 = 1e-12
TORCH = {jnp.float32: torch.float32, jnp.float64: torch.float64}


def _vols(form):
    """``create``'s vol arguments of each form."""
    if form == "vector":
        return dict(sigma=SIG)
    if form == "table":
        t = np.arange(K)[:, None]
        return dict(sigma=SIG[None, :] * (1.0 + 0.05 * t))
    return dict(vol_ttm=0.15 + 0.05 * np.exp(-0.5 * np.arange(K)))


def _models(dtype=jnp.float64, form="vector", shift=0.0, **kw):
    args = dict(corr_beta=0.1, shift=shift, **_vols(form), **kw)
    return (jl.LMM.create(F0, delta=DELTA, dtype=dtype, **args),
            tl.LMM.create(F0, delta=DELTA, dtype=TORCH[dtype], device="cpu",
                          **args))


def _obs(jm, tm, n, steps, dtype, seed=3):
    want = jsimulate(jm, n, steps, seed=seed, mode="paths", dtype=dtype,
                     observe=lambda p, s: p.exposure_obs(s))
    got = simulate(tm, n, steps, seed=seed, mode="paths",
                   dtype=TORCH[dtype],
                   observe=lambda p, s: p.exposure_obs(s))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("k", [1, 2, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_draws_bitwise_the_per_draw_stream(k, dtype):
    m = tl.LMM.create(np.full(k, 0.03), np.full(k, 0.2), DELTA,
                      device="cpu")
    k0, k1 = key_from_seed(11, 2)
    ids = torch.arange(2**32 - 40, 2**32 + 60) & 0xFFFFFFFF
    for t in range(3):
        got = m.draws(k0, k1, ids, t, dtype)
        want = NormalDrawsMixin.draws(m, k0, k1, ids, t, dtype)
        assert len(got) == k
        for a, b in zip(got, want):
            assert a.dtype == dtype
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["vector", "table", "ttm"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_paths_match_jax(form, dtype):
    """Every forward and log B at every date, K + 1 steps (one past the
    last reset: everything frozen), shift 0.01."""
    jm, tm = _models(dtype, form, shift=0.01)
    got, want = _obs(jm, tm, 512, K + 1, dtype)
    assert got.shape == want.shape == (K + 2, 512, K + 1)
    np.testing.assert_allclose(got, want, rtol=PATH_RTOL[dtype], atol=0)
    assert (got[0, :, -1] == 0).all()
    # Dead forwards stay frozen at their fixings.
    for i in range(1, K):
        np.testing.assert_array_equal(got[i + 1:, :, i - 1],
                                      np.broadcast_to(got[i, :, i - 1],
                                                      got[i + 1:, :, 0].shape))


def test_create_matches_jax_leaves_and_refusals():
    from montecarlo_tpu_torch.convert import process_from_numpy

    for form in ("vector", "table", "ttm"):
        jm, tm = _models(jnp.float32, form, shift=0.005)
        fields = {k: np.asarray(v) for k, v in jm._asdict().items()}
        conv = process_from_numpy("lmm", fields, device="cpu")
        for name in jm._fields:
            leaf = getattr(tm, name)
            np.testing.assert_array_equal(leaf.numpy(), fields[name],
                                          err_msg=name)
            # convert's 0-d leaves come across as 1-element arrays.
            assert torch.equal(getattr(conv, name).reshape(leaf.shape), leaf)
    for args, kw, match in [
            ((F0, SIG, DELTA), dict(dt=0.5), "dt .* must equal delta"),
            (([-0.01, 0.02], [0.2, 0.2], DELTA), {}, "positive"),
            (([0.03], [0.2, 0.2], DELTA), {}, r"sigma must be \(1,\)"),
            (([0.03, 0.03], [0.2, 0.2], DELTA), dict(corr=np.eye(3)),
             "corr must be"),
            (([0.03], [0.2], DELTA), dict(shift=-0.01), "nonnegative"),
            ((F0,), dict(delta=DELTA), "exactly one"),
            ((F0, SIG, DELTA), dict(vol_ttm=SIG), "exactly one")]:
        with pytest.raises(ValueError, match=match):
            jl.LMM.create(*args, **kw)
        with pytest.raises(ValueError, match=match):
            tl.LMM.create(*args, **kw, device="cpu")
    with pytest.raises(ValueError, match="start"):
        tl.lmm_swap_value_fn(_models()[1], 0.03, 5, 5)
    np.testing.assert_array_equal(tl.exp_decay_corr(8, 0.3, 0.25),
                                  jl.exp_decay_corr(8, 0.3, 0.25))


def test_exposure_protocol_and_closures_match_jax():
    """``wwr_state``, ``im_norm``, ``pathwise_discount``,
    ``lmm_swap_value_fn`` at every date and ``lmm_swaption_rebonato`` on
    the same float64 arrays as JAX."""
    jm, tm = _models(jnp.float64, "table", shift=0.01)
    got, _ = _obs(jm, tm, 256, K, jnp.float64)
    obs = np.moveaxis(got, -1, 1)                       # (T+1, K+1, N)
    rng = np.random.default_rng(5)
    dvs = rng.standard_normal(obs.shape)
    o_t, d_t = torch.from_numpy(obs), torch.from_numpy(dvs)
    o_j, d_j = jnp.asarray(obs), jnp.asarray(dvs)
    np.testing.assert_array_equal(tm.wwr_state(o_t).numpy(),
                                  np.asarray(jm.wwr_state(o_j)))
    np.testing.assert_array_equal(tm.wwr_state(o_t[None]).numpy(),
                                  np.asarray(jm.wwr_state(o_j[None])))
    np.testing.assert_allclose(tm.pathwise_discount(o_t).numpy(),
                               np.asarray(jm.pathwise_discount(o_j)),
                               rtol=RTOL64)
    np.testing.assert_allclose(tm.im_norm(d_t, o_t, 10 / 252).numpy(),
                               np.asarray(jm.im_norm(d_j, o_j, 10 / 252)),
                               rtol=RTOL64, atol=1e-300)
    par = tl.lmm_par_strike(tm, 2, 7)
    assert par == jl.lmm_par_strike(jm, 2, 7)
    tv = tl.lmm_swap_value_fn(tm, par, 2, 7)
    jv = jl.lmm_swap_value_fn(jm, par, 2, 7)
    for i in (0, 2, 5, K):
        np.testing.assert_allclose(tv(o_t[i], i * DELTA).numpy(),
                                   np.asarray(jv(o_j[i], i * DELTA)),
                                   rtol=RTOL64, atol=1e-17)
    # The t = 0 mark of the par swap is 0; a fixed leg above par is short.
    assert abs(float(tv(o_t[0], 0.0)[0])) < 1e-15
    for s, e, strike in ((1, 8, par), (3, 6, 0.035), (6, 7, 0.031)):
        assert tl.lmm_swaption_rebonato(tm, s, e, strike) == pytest.approx(
            jl.lmm_swaption_rebonato(jm, s, e, strike), rel=1e-13)
    for i in (0, 3, K):
        assert tl.lmm_zcb0(tm, i) == jl.lmm_zcb0(jm, i)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_caplet_swaption_and_bermudan_match_jax(dtype):
    jm, tm = _models(dtype, "vector", shift=0.005)
    td = TORCH[dtype]
    rtol = RTOL64 if dtype == jnp.float64 else PATH_RTOL[dtype]
    want = jl.lmm_caplet_mc(jm, 5, 0.031, 2048, seed=11, dtype=dtype)
    got = tl.lmm_caplet_mc(tm, 5, 0.031, 2048, seed=11, dtype=td)
    for k in ("price", "std_err"):
        assert got[k] == pytest.approx(want[k], rel=rtol), k
    assert got["black"] == pytest.approx(want["black"], rel=1e-13)
    strike = tl.lmm_par_strike(tm, 2, K)
    want = jl.lmm_swaption_mc(jm, 2, K, strike, 2048, seed=5, dtype=dtype)
    got = tl.lmm_swaption_mc(tm, 2, K, strike, 2048, seed=5, dtype=td)
    for k in ("price", "std_err"):
        assert got[k] == pytest.approx(want[k], rel=rtol), k
    assert got["rebonato"] == pytest.approx(want["rebonato"], rel=1e-13)
    # One date is the European (below); float32's Bermudan is also held
    # through ``bond --model lmm --swaption`` in tests/test_torch_rates.py.
    for n_ex in ((1, 4) if dtype == jnp.float64 else (4,)):
        b_want = jb.lmm_bermudan_swaption_lsm(
            jm, strike, 2, K, n_exercise=n_ex, n_paths=2048, seed=5,
            dtype=dtype)
        b_got = tb.lmm_bermudan_swaption_lsm(
            tm, strike, 2, K, n_exercise=n_ex, n_paths=2048, seed=5,
            dtype=td)
        for k in ("price", "std_err"):
            assert float(b_got[k]) == pytest.approx(float(b_want[k]),
                                                    rel=rtol), (n_ex, k)
        if n_ex == 1:
            # JAX's contract: one date is the European at the same seed.
            assert float(b_got["price"]) == pytest.approx(got["price"],
                                                          rel=1e-12)


def test_bermudan_contracts_on_the_port():
    """tests/test_lmm.py::test_bermudan_swaption_lsm at 2^13 paths: more
    dates never lose value beyond 3 std-err, eight add it, and
    ``n_exercise`` outside [1, end - start] raises."""
    _, tm = _models()
    s, e, n = 2, K, 1 << 13
    strike = tl.lmm_par_strike(tm, s, e)
    eur = tl.lmm_swaption_mc(tm, s, e, strike, n, seed=11)
    prices = [float(tb.lmm_bermudan_swaption_lsm(
        tm, strike, s, e, n_exercise=n_ex, n_paths=n, seed=11)["price"])
        for n_ex in (1, 2, 4, 6)]
    assert prices[0] == pytest.approx(eur["price"], rel=1e-12)
    for a, b in zip(prices, prices[1:]):
        assert b > a - 3 * eur["std_err"], prices
    assert prices[-1] > prices[0] + 2 * eur["std_err"], prices
    with pytest.raises(ValueError, match="n_exercise"):
        tb.lmm_bermudan_swaption_lsm(tm, strike, s, e, n_exercise=7,
                                     n_paths=64, seed=1)
    with pytest.raises(ValueError, match="start"):
        tb.lmm_bermudan_swaption_lsm(tm, strike, 0, e, n_exercise=1,
                                     n_paths=64, seed=1)


def test_oracles_on_the_port():
    """tests/test_lmm.py's caplet-Black and ZCB-martingale gates at 2^12
    paths: 4 std-err plus its slack."""
    _, tm = _models()
    for k_idx, strike in ((3, 0.030), (6, 0.034)):
        est = tl.lmm_caplet_mc(tm, k_idx, strike, 1 << 12, seed=11)
        assert abs(est["price"] - est["black"]) \
            < 4 * est["std_err"] + 2e-4 * est["black"], est
    obs = simulate(tm, 1 << 12, K, seed=3, mode="paths",
                   dtype=torch.float64,
                   observe=lambda p, s: p.exposure_obs(s))
    for i in (3, K):
        d = torch.exp(-obs[i, :, -1]).numpy()
        se = d.std(ddof=1) / np.sqrt(d.size)
        assert abs(d.mean() - tl.lmm_zcb0(tm, i)) < 4 * se + 2e-5, i


def test_sobol_sampler_as_jax():
    """tests/test_lmm.py::test_deterministic_and_sobol_eligible: the same
    seed gives the same bits, and the float64 Sobol caplet equals JAX's
    (rtol 1e-12) and Black's within 5e-5."""
    jm, tm = _models()
    a, _ = _obs(jm, tm, 256, K, jnp.float64, seed=9)
    b, _ = _obs(jm, tm, 256, K, jnp.float64, seed=9)
    np.testing.assert_array_equal(a, b)
    js = JSobol.for_process(jm, 4096, 7, seed=1, dtype=jnp.float64)
    ts = SobolSampler.for_process(tm, 4096, 7, seed=1, dtype=torch.float64)
    np.testing.assert_array_equal(ts.z.numpy(), np.asarray(js.z))
    want = jl.lmm_caplet_mc(jm, 6, 0.031, 4096, seed=3, sampler=js)
    got = tl.lmm_caplet_mc(tm, 6, 0.031, 4096, seed=3, sampler=ts)
    assert got["price"] == pytest.approx(want["price"], rel=RTOL64)
    assert abs(got["price"] - got["black"]) < 5e-5, got


def _cap_strip(f0, delta, strike, sig):
    from scipy.stats import norm

    p = np.cumprod(1.0 / (1.0 + delta * f0))

    def black(f, k_, sd):
        d1 = (np.log(f / k_) + 0.5 * sd * sd) / sd
        return f * norm.cdf(d1) - k_ * norm.cdf(d1 - sd)

    return np.cumsum([delta * p[k] * black(f0[k], strike,
                                           sig[k] * np.sqrt(k * delta))
                      for k in range(1, len(f0))])


def test_calibration_matches_jax():
    """Both bootstraps and the correlation fit on tests/test_lmm.py's
    calibration round trip: equal to JAX's and recovering the truth."""
    delta, k_fwd, beta_true, strike = 0.25, 8, 0.45, 0.03
    t = delta * np.arange(k_fwd)
    sig_true = 0.12 + 0.25 * (0.3 + t) * np.exp(-0.8 * t)
    f0 = np.full(k_fwd, 0.03)
    caps = _cap_strip(f0, delta, strike, sig_true)
    got = trc.bootstrap_lmm_vols(f0, delta, strike, caps)
    np.testing.assert_array_equal(got, jrc.bootstrap_lmm_vols(
        f0, delta, strike, caps))
    np.testing.assert_allclose(got[1:], sig_true[1:], atol=1e-10)
    m_true = tl.LMM.create(f0, sig_true, delta, corr_beta=beta_true,
                           device="cpu")
    quotes = [(s, e, tl.lmm_par_strike(m_true, s, e),
               tl.lmm_swaption_rebonato(m_true, s, e,
                                        tl.lmm_par_strike(m_true, s, e)))
              for s, e in ((2, 6), (3, 8), (5, 8))]
    fit = trc.calibrate_lmm_corr_to_swaptions(f0, got, delta, quotes)
    assert fit == jrc.calibrate_lmm_corr_to_swaptions(f0, got, delta,
                                                      quotes)
    assert abs(fit["corr_beta"] - beta_true) < 1e-4, fit
    # The time-homogeneous bootstrap: caplet k's total variance is
    # delta * sum_{m < k} ttm[m]^2.
    ttm = 0.2 - 0.05 * np.arange(k_fwd) / k_fwd
    sig_eff = np.array([np.sqrt(np.mean(np.square(ttm[:k]))) if k else 0.0
                        for k in range(k_fwd)])
    strip = _cap_strip(f0, delta, strike, sig_eff)
    got = trc.bootstrap_lmm_ttm_vols(f0, delta, strike, strip)
    np.testing.assert_array_equal(got, jrc.bootstrap_lmm_ttm_vols(
        f0, delta, strike, strip))
    np.testing.assert_allclose(got[:-1], ttm[:-1], atol=1e-10)
    bad = caps.copy()
    bad[3] = bad[2]
    for mod in (trc, jrc):
        with pytest.raises(ValueError, match="strictly increasing"):
            mod.bootstrap_lmm_vols(f0, delta, strike, bad)
    bad2 = caps.copy()
    bad2[-1] = bad2[-2] + 1.0
    with pytest.raises(ValueError, match="bound"):
        trc.bootstrap_lmm_vols(f0, delta, strike, bad2)


@pytest.mark.parametrize("form", ["ttm"])
def test_gradient_through_create_matches_jax_grad(form):
    """A swap's discounted t = 2 value, differentiated through ``create``
    in (f0, vols, shift), float64, against ``jax.grad``."""
    vols = _vols(form)
    key = next(iter(vols))

    def jax_fn(f0, v, shift):
        m = jl.LMM.create(f0, delta=DELTA, shift=shift, dtype=jnp.float64,
                          **{key: v})
        obs = jsimulate(m, 256, 2, seed=4, dtype=jnp.float64,
                        observe=lambda p, s: p.exposure_obs(s))
        val = jl.lmm_swap_value_fn(m, 0.031, 2, K, dtype=jnp.float64)(
            obs.T, 2 * DELTA)
        return jnp.mean(val * jnp.exp(-obs[:, -1]))

    want = jax.grad(jax_fn, argnums=(0, 1, 2))(
        jnp.asarray(F0), jnp.asarray(vols[key]), jnp.asarray(0.01))
    leaves = [torch.tensor(F0, requires_grad=True),
              torch.tensor(vols[key], requires_grad=True),
              torch.tensor(0.01, dtype=torch.float64, requires_grad=True)]
    m = tl.LMM.create(leaves[0], delta=DELTA, shift=leaves[2],
                      dtype=torch.float64, device="cpu",
                      **{key: leaves[1]})
    obs = simulate(m, 256, 2, seed=4, dtype=torch.float64,
                   observe=lambda p, s: p.exposure_obs(s))
    val = tl.lmm_swap_value_fn(m, 0.031, 2, K, dtype=torch.float64)(
        obs.T, 2 * DELTA)
    got = torch.autograd.grad(torch.mean(val * torch.exp(-obs[:, -1])),
                              leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-14)
