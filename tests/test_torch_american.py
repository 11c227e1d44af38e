"""American and Bermudan exercise in the port (``montecarlo_tpu_torch/
engine/american.py``) against the JAX package's ``engine/american.py`` on
the CPU, and the JAX tests' oracle contracts on the port.

Tolerances, and why:

- float64 on both sides (float64 leaves, the JAX package's float64 draws):
  the paths agree to the platforms' float64 ``log``, ``sin`` and ``cos``
  (ULPs), and the sums, Gram products and 4x4 to 15x15 solves run in each
  library's own order, so a regression's betas move by ~1e-12 relative and
  no exercise decision flips at these sizes.  Price, std-err and the dual's
  upper bound within rtol 1e-9; the policies (betas, means, stds) and the
  greeks' gradients within rtol 1e-6 of the largest entry of each array (a
  beta near zero carries the others' absolute error).
- float32 on both sides: the paths are the same bits or ULPs apart, but
  the standardizations and Gram products are float32 sums in two orders
  (~1e-7 relative), which moves a continuation value by ~1e-6 and can
  flip the exercise decision of a path that sits that close to the
  boundary.  A flipped path moves its discounted cashflow by at most the
  strike (a put pays <= K), so the price may move by FLIPS * K / n_paths
  beyond rtol 1e-6; FLIPS = 4 (the runs below measure 0 or 1).
- ``binomial_american_put`` is the same NumPy code: bitwise.
- The oracle contracts are the JAX tests' (tests/test_american*.py) at
  sizes that keep this file near 30 s: 4 std-err plus their stated slack.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import american as ja
from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.processes import GARCHBootstrap as JGARCH
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu.processes import MultiGBM as JMulti
from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN,
                                         black_scholes_call,
                                         black_scholes_put, max_call,
                                         mc_estimate, simulate,
                                         simulate_functionals)
from montecarlo_tpu_torch.engine import american as ta
from montecarlo_tpu_torch.engine.greeks import float_leaves
from montecarlo_tpu_torch.processes import (GBM, GARCHBootstrap, Heston,
                                            MultiGBM)

torch.set_num_threads(1)

F64 = torch.float64
RTOL64, POLICY_RTOL = 1e-9, 1e-6
RTOL32, FLIPS = 1e-6, 4
N, STEPS = 4096, 16
S0, K, R, SIG, T = 36.0, 40.0, 0.06, 0.2, 1.0
DT = T / STEPS
HESTON = dict(s0=100.0, v0=0.04, mu=0.05, kappa=1.5, theta=0.04, xi=0.5,
              rho=-0.7, dt=0.5 / STEPS)


def _f64(proc, jproc):
    """The port's process on the JAX float64 process's leaves."""
    return dataclasses.replace(proc, **{
        k: torch.tensor(np.asarray(getattr(jproc, k))[:v.numel()]
                        if v.dim() else np.asarray(getattr(jproc, k)),
                        dtype=F64).reshape(v.shape)
        for k, v in float_leaves(proc).items()})


def _gbm_pair(s0=S0, dtype=F64):
    vals = dict(s0=s0, mu=R, sigma=SIG, dt=DT)
    tp = GBM.create(**vals, device="cpu")
    if dtype == F64:
        jp = JGBM.create(**vals, dtype=jnp.float64)
        return jp, _f64(tp, jp)
    return JGBM.create(**vals), tp


def _heston_pair():
    jp = JHeston.create(**HESTON, dtype=jnp.float64)
    return jp, _f64(Heston.create(**HESTON, device="cpu"), jp)


def _garch_pair():
    r = np.random.default_rng(5).standard_t(5, 400) * 0.012
    kw = dict(s0=100.0, var0=0.012 ** 2)
    jp = JGARCH.create(r, dtype=jnp.float64, **kw)
    return jp, _f64(GARCHBootstrap.create(r, device="cpu", **kw), jp)


def _multi_pair(s0=100.0, n_ex=9):
    vals = dict(s0=[s0] * 2, mu=[0.05 - 0.10] * 2, sigma=[0.2] * 2,
                corr=np.eye(2), dt=3.0 / n_ex)
    jp = JMulti.create(**vals, dtype=jnp.float64)
    return jp, _f64(MultiGBM.create(**vals, device="cpu"), jp)


def _jput(s):
    return jnp.maximum(K - s, 0.0)


def _tput(s):
    return torch.clamp(K - s, min=0.0)


def _close(got, want, rtol, keys=("price", "std_err")):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   err_msg=k)
    assert got["n_paths"] == want["n_paths"]


def _close_policy(got, want, rtol=POLICY_RTOL):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == F64
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rtol * np.abs(w).max())


# --- the oracle ----------------------------------------------------------------

@pytest.mark.parametrize("s0,n", [(36.0, 200), (40.0, 500), (44.0, 1000)])
def test_binomial_american_put_bitwise(s0, n):
    assert ta.binomial_american_put(s0, K, R, SIG, T, n) == \
        ja.binomial_american_put(s0, K, R, SIG, T, n)


# --- float64 parity ------------------------------------------------------------

def test_lsm_policy_float64_matches_jax():
    jp, tp = _gbm_pair()
    kw = dict(seed=1, rate=R, dt=DT, degree=3)
    jr, jpol = ja.lsm_policy(jp, _jput, N, STEPS, dtype=jnp.float64, **kw)
    tr, tpol = ta.lsm_policy(tp, _tput, N, STEPS, dtype=F64, **kw)
    _close(tr, jr, RTOL64)
    assert tpol[0].shape == (STEPS - 1, 8)
    _close_policy(tpol, jpol)


def test_lsm_price_and_exercise_policy_float64_match_jax():
    jp, tp = _gbm_pair()
    kw = dict(seed=4, rate=R, dt=DT, degree=2)
    _close(ta.lsm_price(tp, _tput, N, STEPS, dtype=F64, **kw),
           ja.lsm_price(jp, _jput, N, STEPS, dtype=jnp.float64, **kw),
           RTOL64)
    _close_policy(
        ta.lsm_exercise_policy(tp, _tput, N, STEPS, dtype=F64, **kw),
        ja.lsm_exercise_policy(jp, _jput, N, STEPS, dtype=jnp.float64, **kw))


def test_andersen_broadie_float64_matches_jax():
    jp, tp = _gbm_pair()
    kw = dict(seed=1, rate=R, dt=DT, degree=3)
    _, jpol = ja.lsm_policy(jp, _jput, N, STEPS, dtype=jnp.float64, **kw)
    _, tpol = ta.lsm_policy(tp, _tput, N, STEPS, dtype=F64, **kw)
    want = ja.andersen_broadie_bound(jp, _jput, jpol, 1024, 64, STEPS,
                                     dtype=jnp.float64, **{**kw, "seed": 2})
    got = ta.andersen_broadie_bound(tp, _tput, tpol, 1024, 64, STEPS,
                                    dtype=F64, **{**kw, "seed": 2})
    _close(got, want, RTOL64, keys=("upper", "std_err"))


def test_dual_inner_ids_wrap_mod_2_32():
    """Outer ids just below 2^32: the inner ids ``ids * n_inner + j``
    wrap mod 2^32 as JAX's uint32 ids do."""
    from montecarlo_tpu.engine.simulate import path_ids_for as jids
    from montecarlo_tpu_torch.engine.simulate import path_ids_for

    jp, tp = _gbm_pair()
    kw = dict(seed=1, rate=R, dt=DT, degree=3)
    _, jpol = ja.lsm_policy(jp, _jput, N, STEPS, dtype=jnp.float64, **kw)
    _, tpol = ta.lsm_policy(tp, _tput, N, STEPS, dtype=F64, **kw)
    off = 2**32 - 40
    want = ja._ab_best(jp, _jput, jpol, jids(64, off), 32, STEPS, seed=9,
                       rate=R, dt=DT, degree=3, value_degree=None,
                       dtype=jnp.float64)
    got = ta._ab_best(tp, _tput, tpol, path_ids_for(64, off), 32, STEPS,
                      seed=9, rate=R, dt=DT, degree=3, value_degree=None,
                      dtype=F64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL64)


@pytest.mark.parametrize("kind", ["heston", "garch"])
def test_stochastic_vol_float64_matches_jax(kind):
    jp, tp = _heston_pair() if kind == "heston" else _garch_pair()
    k = 100.0
    jpay = lambda s: jnp.maximum(k - s, 0.0)
    tpay = lambda s: torch.clamp(k - s, min=0.0)
    kw = dict(seed=7, rate=0.05, dt=0.5 / STEPS, degree=2, value_degree=3)
    jr, jpol = ja.lsm_policy_sv(jp, jpay, N, STEPS, dtype=jnp.float64, **kw)
    tr, tpol = ta.lsm_policy_sv(tp, tpay, N, STEPS, dtype=F64, **kw)
    _close(tr, jr, RTOL64)
    assert tpol[1].shape == (STEPS - 1, 2)
    _close_policy(tpol, jpol)
    kw.pop("value_degree")
    _close(ta.lsm_price_sv(tp, tpay, N, STEPS, dtype=F64, **kw),
           ja.lsm_price_sv(jp, jpay, N, STEPS, dtype=jnp.float64, **kw),
           RTOL64)
    if kind == "garch":
        # JAX's GARCH reads its table in 128-lane rows, which refuses the
        # dual's (outer, inner) ids; the port's 2-D step is held below.
        return
    want = ja.andersen_broadie_bound_sv(jp, jpay, jpol, 512, 32, STEPS,
                                        dtype=jnp.float64, value_degree=3,
                                        **{**kw, "seed": 8})
    got = ta.andersen_broadie_bound_sv(tp, tpay, tpol, 512, 32, STEPS,
                                       dtype=F64, value_degree=3,
                                       **{**kw, "seed": 8})
    _close(got, want, RTOL64, keys=("upper", "std_err"))


@pytest.mark.parametrize("name", ["arith", "geo"])
def test_path_dependent_float64_matches_jax(name):
    """The average-price put on the arithmetic mean (price space) and on
    the geometric one (log space: log of the float64 paths)."""
    jp, tp = _gbm_pair(100.0)
    jfun, tfun = ((jf.ARITH_MEAN, ARITH_MEAN) if name == "arith"
                  else (jf.GEO_MEAN, GEO_MEAN))
    kw = dict(seed=3, rate=R, dt=DT, degree=2)
    want = ja.lsm_price_path_dependent(
        jp, lambda s, a: jnp.maximum(100.0 - a, 0.0), jfun, N, STEPS,
        dtype=jnp.float64, **kw)
    got = ta.lsm_price_path_dependent(
        tp, lambda s, a: torch.clamp(100.0 - a, min=0.0), tfun, N, STEPS,
        dtype=F64, **kw)
    _close(got, want, RTOL64)


@pytest.mark.parametrize("sort_assets", [True, False])
def test_multi_asset_float64_matches_jax(sort_assets):
    """The 2-asset max-call, its policy and the dual."""
    jp, tp = _multi_pair()
    jpay = lambda p: jnp.maximum(jnp.max(p, axis=-1) - 100.0, 0.0)
    tpay = lambda p: max_call(p, 100.0)
    kw = dict(seed=11, rate=0.05, dt=3.0 / 9, degree=3, value_degree=3,
              sort_assets=sort_assets)
    jr, jpol = ja.lsm_policy_multi(jp, jpay, N, 9, dtype=jnp.float64, **kw)
    tr, tpol = ta.lsm_policy_multi(tp, tpay, N, 9, dtype=F64, **kw)
    _close(tr, jr, RTOL64)
    assert tpol[0].shape == (8, 10)
    _close_policy(tpol, jpol)
    want = ja.andersen_broadie_bound_multi(
        jp, jpay, jpol, 512, 32, 9, dtype=jnp.float64, **kw)
    got = ta.andersen_broadie_bound_multi(tp, tpay, tpol, 512, 32, 9,
                                          dtype=F64, **kw)
    _close(got, want, RTOL64, keys=("upper", "std_err"))


def test_multi_basis_order_is_jaxs():
    assert ta._multi_indices(3, 3) == ja._multi_indices(3, 3)
    x = np.random.default_rng(0).normal(size=(5, 3))
    np.testing.assert_allclose(
        ta._basis_multi(torch.tensor(x), 3).numpy(),
        np.asarray(ja._basis_multi(jnp.asarray(x), 3)), rtol=1e-15)
    np.testing.assert_allclose(
        ta._basis2(torch.tensor(x[:, 0]), torch.tensor(x[:, 1]), 3).numpy(),
        np.asarray(ja._basis2(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]),
                              3)), rtol=1e-15)


@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_american_greeks_float64_match_jax(kind):
    """Price and the gradient of every float leaf under a frozen policy."""
    if kind == "gbm":
        (jp, tp), k, rate, dt = _gbm_pair(), K, R, DT
    else:
        (jp, tp), k, rate, dt = _heston_pair(), 100.0, 0.05, 0.5 / STEPS
    jpay = lambda s: jnp.maximum(k - s, 0.0)
    tpay = lambda s: torch.clamp(k - s, min=0.0)
    kw = dict(seed=3, rate=rate, dt=dt, degree=3)
    jpol = ja.lsm_exercise_policy(jp, jpay, N, STEPS, dtype=jnp.float64,
                                  **kw)
    tpol = ta.lsm_exercise_policy(tp, tpay, N, STEPS, dtype=F64, **kw)
    jprice, jg = ja.american_price_and_greeks(jp, jpay, jpol, N, STEPS,
                                              dtype=jnp.float64, **kw)
    tprice, tg = ta.american_price_and_greeks(tp, tpay, tpol, N, STEPS,
                                              dtype=F64, **kw)
    np.testing.assert_allclose(float(tprice), float(jprice), rtol=RTOL64)
    for name in float_leaves(tp):
        want = float(getattr(jg, name))
        np.testing.assert_allclose(float(getattr(tg, name)), want,
                                   rtol=POLICY_RTOL, atol=1e-12, err_msg=name)
    assert float(tg.s0) < 0.0  # a put's delta


# --- float32 parity --------------------------------------------------------------

def test_float32_matches_jax_within_flips():
    """lsm_policy and the dual in float32 on both sides (see the module
    docstring for FLIPS)."""
    jp, tp = _gbm_pair(dtype=torch.float32)
    kw = dict(seed=1, rate=R, dt=DT, degree=3)
    jr, jpol = ja.lsm_policy(jp, _jput, N, STEPS, **kw)
    tr, tpol = ta.lsm_policy(tp, _tput, N, STEPS, **kw)
    assert tr["price"].dtype == torch.float32
    assert abs(float(tr["price"]) - float(jr["price"])) <= (
        RTOL32 * float(jr["price"]) + FLIPS * K / N)
    want = ja.andersen_broadie_bound(jp, _jput, jpol, 512, 64, STEPS,
                                     **{**kw, "seed": 2})
    got = ta.andersen_broadie_bound(tp, _tput, tpol, 512, 64, STEPS,
                                    **{**kw, "seed": 2})
    # The dual takes no decision: its surrogate moves with the betas.
    np.testing.assert_allclose(float(got["upper"]), float(want["upper"]),
                               rtol=1e-4)


# --- 2-D states -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gbm", "heston", "multigbm", "garch"])
def test_processes_step_a_2d_state_on_2d_ids(kind):
    """The dual steps an (outer, inner) state on (outer, inner) ids: each
    process gives bitwise what its 1-D step gives on the flattened ids."""
    from montecarlo_tpu_torch.engine.simulate import path_ids_for

    proc = {"gbm": lambda: _gbm_pair()[1],
            "heston": lambda: _heston_pair()[1],
            "multigbm": lambda: _multi_pair()[1],
            "garch": lambda: _garch_pair()[1]}[kind]()
    ids = path_ids_for(24, 5).reshape(4, 6)
    state = type(proc.init_state(ids[:, 0]))(*(
        x.to(F64)[:, None].expand(4, 6, *x.shape[1:])
        for x in proc.init_state(ids[:, 0])))
    eps2 = ta._draws(proc, 3, 0xAB51, ids, 2, F64)
    got = proc.prices(proc.step(state, eps2, 2))
    flat = type(state)(*(x.reshape(24, *x.shape[2:]) for x in state))
    eps1 = ta._draws(proc, 3, 0xAB51, ids.reshape(-1), 2, F64)
    want = proc.prices(proc.step(flat, eps1, 2))
    assert torch.equal(got.reshape(want.shape), want)


def test_default_aux_needs_a_variance_leaf():
    _, tp = _gbm_pair()
    with pytest.raises(ValueError, match="aux_fn"):
        ta.lsm_price_sv(tp, _tput, 64, 4, seed=0, rate=R, dt=DT, dtype=F64)


# --- the JAX tests' oracle contracts on the port ---------------------------------

def test_lsm_and_dual_bracket_the_binomial_put():
    """tests/test_american.py's bracket (T = 0.5, 32 dates), at 2^14
    paths and a 1024 x 64 dual."""
    s0, k, r, sigma, t, steps = 100.0, 105.0, 0.05, 0.2, 0.5, 32
    proc = GBM.create(s0, r, sigma, t / steps, device="cpu")
    put = lambda s: torch.clamp(k - s, min=0.0)
    kw = dict(rate=r, dt=t / steps, degree=3)
    res, policy = ta.lsm_policy(proc, put, 1 << 14, steps, seed=3, **kw)
    ab = ta.andersen_broadie_bound(proc, put, policy, 1024, 64, steps,
                                   seed=4, **kw)
    lo, lo_se = float(res["price"]), float(res["std_err"])
    hi, hi_se = float(ab["upper"]), float(ab["std_err"])
    exact = ta.binomial_american_put(s0, k, r, sigma, t, 2000)
    assert lo - 4 * lo_se - 0.05 <= exact <= hi + 4 * hi_se, (lo, hi, exact)
    # (JAX's own gap gate, 0.2, needs its 512 inner samples.)
    assert lo < hi + 4 * (lo_se + hi_se), (lo, hi)


def test_american_put_dominates_european_and_call_is_european():
    proc = GBM.create(S0, R, SIG, DT, device="cpu")
    put = ta.lsm_price(proc, _tput, 1 << 14, STEPS, seed=3, rate=R, dt=DT)
    assert float(put["price"]) > float(black_scholes_put(S0, K, R, SIG, T)) \
        + 0.1
    proc = GBM.create(100.0, R, SIG, DT, device="cpu")
    call = ta.lsm_price(proc, lambda s: torch.clamp(s - 105.0, min=0.0),
                        1 << 14, STEPS, seed=5, rate=R, dt=DT)
    euro = float(black_scholes_call(100.0, 105.0, R, SIG, T))
    assert abs(float(call["price"]) - euro) < \
        4 * float(call["std_err"]) + 0.03


def test_max_call_brackets_the_published_value():
    """2 assets, S0 = K = 100, r 5%, dividend 10%, 9 dates over 3 years:
    LSM and the dual bracket the published 13.902."""
    proc = MultiGBM.create([100.0] * 2, [-0.05] * 2, [0.2] * 2, np.eye(2),
                           3.0 / 9, device="cpu")
    pay = lambda p: max_call(p, 100.0)
    kw = dict(rate=0.05, dt=3.0 / 9, degree=3, value_degree=3)
    res, policy = ta.lsm_policy_multi(proc, pay, 1 << 14, 9, seed=11, **kw)
    ub = ta.andersen_broadie_bound_multi(proc, pay, policy, 1024, 64, 9,
                                         seed=12, **kw)
    lo, lo_se = float(res["price"]), float(res["std_err"])
    hi, hi_se = float(ub["upper"]), float(ub["std_err"])
    assert lo - 4 * lo_se <= 13.902 <= hi + 4 * hi_se, (lo, hi)
    assert lo <= hi


def test_asian_lsm_properties():
    """tests/test_american.py's American-Asian contracts: European parity at
    ``exercise_from = T``, and more exercise rights add value."""
    n, steps, k = 1 << 13, 16, 100.0
    proc = GBM.create(100.0, R, SIG, T / steps, device="cpu")
    put = lambda s, a: torch.clamp(k - a, min=0.0)
    kw = dict(seed=3, rate=R, dt=T / steps)
    euro_lsm = ta.lsm_price_path_dependent(proc, put, ARITH_MEAN, n, steps,
                                           exercise_from=steps, **kw)
    out = simulate_functionals(proc, n, steps, seed=3,
                               functionals={"avg": ARITH_MEAN})
    euro = mc_estimate(torch.clamp(k - out["avg"], min=0.0),
                       float(np.exp(-R * T)))
    np.testing.assert_allclose(float(euro_lsm["price"]),
                               float(euro["price"]), rtol=1e-5)
    amer = ta.lsm_price_path_dependent(proc, put, ARITH_MEAN, n, steps, **kw)
    half = ta.lsm_price_path_dependent(proc, put, ARITH_MEAN, n, steps,
                                       exercise_from=steps // 2, **kw)
    se = float(euro["std_err"])
    assert float(amer["price"]) >= float(half["price"]) - 2 * se
    assert float(half["price"]) >= float(euro_lsm["price"]) - 2 * se
    assert float(amer["price"]) > float(euro_lsm["price"]) + se


def test_american_put_delta_against_the_binomial_difference():
    """tests/test_american_greeks.py's delta gate (0.02 of the CRR central
    difference) at 2^15 paths x 50 dates."""
    steps = 50
    proc = GBM.create(S0, R, SIG, T / steps, device="cpu")
    kw = dict(seed=3, rate=R, dt=T / steps, degree=3)
    policy = ta.lsm_exercise_policy(proc, _tput, 1 << 15, steps, **kw)
    price, g = ta.american_price_and_greeks(proc, _tput, policy, 1 << 15,
                                            steps, **kw)
    h = 0.25
    fd = (ta.binomial_american_put(S0 + h, K, R, SIG, T, 1500)
          - ta.binomial_american_put(S0 - h, K, R, SIG, T, 1500)) / (2 * h)
    assert abs(float(g.s0) - fd) < 0.02, (float(g.s0), fd)
    assert 4.0 < float(price) < 4.8
    assert torch.equal(g.s0.reshape(()), g.s0)  # a 0-d gradient


def test_lsm_on_the_float32_loop_is_simulate_paths():
    """The float32 LSM reads the torch loop's paths: the exercise value at
    the last date is the payoff of ``simulate``'s terminal prices."""
    proc = GBM.create(S0, R, SIG, DT, device="cpu")
    euro = ta.lsm_price_path_dependent(
        proc, lambda s, a: torch.clamp(K - s, min=0.0), ARITH_MEAN, 1024,
        STEPS, seed=2, rate=R, dt=DT, exercise_from=STEPS)
    term = simulate(proc, 1024, STEPS, seed=2)
    want = torch.exp(torch.tensor(-R * DT)) ** STEPS * _tput(term)
    np.testing.assert_allclose(float(euro["price"]), float(want.mean()),
                               rtol=1e-5)
