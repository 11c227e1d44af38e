"""The Vasicek Bermudan swaption in the port (``montecarlo_tpu_torch/
engine/bermudan.py``) against the JAX package's ``engine/bermudan.py`` on
the CPU, and tests/test_bermudan.py's contracts on the port.

Tolerances, and why: both sides run float64 leaves and float64 draws
(``bermudan_swaption_lsm``'s default dtype); the short-rate paths agree to
~1e-17 (the platforms' float64 log, sin and cos in Box-Muller), and the
trapezoid discount, the cumulative sum, the 4x4 solves and the means run
in each library's order.  No exercise decision flips at these sizes, so
price and std-err agree within rtol 1e-12.  Jamshidian's closed form is
the same float64 Python arithmetic over the same zero-coupon formula on
both sides: rtol 1e-13.  The contracts are tests/test_bermudan.py's, at 4
std-err plus its stated slack.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import bermudan as jb
from montecarlo_tpu.processes import Vasicek as JVasicek
from montecarlo_tpu_torch.engine import bermudan as tb
from montecarlo_tpu_torch.engine.rates import (vasicek_bond_option,
                                               vasicek_zcb)
from montecarlo_tpu_torch.processes import Vasicek

torch.set_num_threads(1)

R0, KAPPA, THETA, SIGMA = 0.03, 0.5, 0.04, 0.012
SPP, N_PERIODS, DELTA = 16, 8, 0.25
DT = DELTA / SPP
RTOL = 1e-12


def _models():
    vals = dict(r0=R0, kappa=KAPPA, theta=THETA, sigma=SIGMA, dt=DT)
    return (JVasicek.create(*vals.values(), dtype=jnp.float64),
            Vasicek(**{k: torch.tensor(v, dtype=torch.float64)
                       for k, v in vals.items()}))


def _par_strike():
    ps = [vasicek_zcb(R0, KAPPA, THETA, SIGMA, i * DELTA)
          for i in range(2, N_PERIODS + 1)]
    p1 = vasicek_zcb(R0, KAPPA, THETA, SIGMA, DELTA)
    return (p1 - ps[-1]) / (DELTA * sum(ps))


@pytest.mark.parametrize("n_exercise,strike,seed", [
    (1, None, 0), (2, None, 1), (4, None, 3), (7, 0.035, 5)])
def test_bermudan_swaption_matches_jax(n_exercise, strike, seed):
    jm, tm = _models()
    strike = _par_strike() if strike is None else strike
    kw = dict(n_paths=4096, steps_per_period=SPP, n_periods=N_PERIODS,
              n_exercise=n_exercise, seed=seed, degree=3)
    want = jb.bermudan_swaption_lsm(jm, strike, **kw)
    got = tb.bermudan_swaption_lsm(tm, strike, **kw)
    assert got["price"].dtype == torch.float64
    for k in ("price", "std_err"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)
    assert got["n_paths"] == want["n_paths"] == 4096


@pytest.mark.parametrize("params,strike,t0,periods", [
    ((KAPPA, THETA, SIGMA), 0.04, 0.25, 7),
    ((0.8, 0.05, 0.015), 0.03, 1.0, 4),
    ((0.2, 0.02, 0.02), 0.06, 0.5, 10)])
def test_jamshidian_matches_jax(params, strike, t0, periods):
    want = jb.vasicek_swaption_jamshidian(params, strike, t0, DELTA, periods,
                                          R0)
    got = tb.vasicek_swaption_jamshidian(params, strike, t0, DELTA, periods,
                                         R0)
    np.testing.assert_allclose(got, want, rtol=1e-13)
    assert got > 0


def test_european_limit_matches_jamshidian():
    """One exercise date is the European payer swaption: within 4 std-err
    + 5e-5 of Jamshidian (tests/test_bermudan.py at 2^15 paths)."""
    strike = _par_strike()
    res = tb.bermudan_swaption_lsm(_models()[1], strike, n_paths=1 << 15,
                                   steps_per_period=SPP,
                                   n_periods=N_PERIODS, n_exercise=1,
                                   seed=0)
    cf = tb.vasicek_swaption_jamshidian((KAPPA, THETA, SIGMA), strike,
                                        t0=DELTA, delta=DELTA,
                                        n_periods=N_PERIODS - 1, r0=R0)
    assert abs(float(res["price"]) - cf) < 4 * float(res["std_err"]) + 5e-5


def test_more_exercise_dates_add_value():
    strike = _par_strike()
    prices = []
    for n_ex in (1, 2, 4):
        res = tb.bermudan_swaption_lsm(_models()[1], strike, n_paths=1 << 14,
                                       steps_per_period=SPP,
                                       n_periods=N_PERIODS,
                                       n_exercise=n_ex, seed=1)
        prices.append((float(res["price"]), float(res["std_err"])))
    for (lo, lo_se), (hi, hi_se) in zip(prices, prices[1:]):
        assert hi > lo - 2 * (lo_se + hi_se), prices
    assert prices[-1][0] > prices[0][0] + prices[0][1], prices


def test_deterministic_and_float64():
    kw = dict(n_paths=1 << 12, steps_per_period=SPP, n_periods=N_PERIODS,
              n_exercise=3, seed=9)
    a = tb.bermudan_swaption_lsm(_models()[1], 0.04, **kw)
    b = tb.bermudan_swaption_lsm(_models()[1], 0.04, **kw)
    assert torch.equal(a["price"], b["price"])
    assert a["price"].dtype == torch.float64


def test_jamshidian_degenerates_to_bond_option():
    """One payment: the swaption is (1 + K delta) puts on the bond paying
    at t0 + delta, struck at 1 / (1 + K delta)."""
    k, t0 = 0.04, 0.5
    cf = tb.vasicek_swaption_jamshidian((KAPPA, THETA, SIGMA), k, t0, DELTA,
                                        1, R0)
    direct = (1 + k * DELTA) * vasicek_bond_option(
        R0, KAPPA, THETA, SIGMA, t0, t0 + DELTA, 1 / (1 + k * DELTA),
        call=False)
    assert abs(cf - direct) < 1e-12


@pytest.mark.parametrize("n_exercise", [0, N_PERIODS])
def test_n_exercise_bounds_validated(n_exercise):
    for fn, model in ((jb.bermudan_swaption_lsm, _models()[0]),
                      (tb.bermudan_swaption_lsm, _models()[1])):
        with pytest.raises(ValueError, match="must be in"):
            fn(model, 0.05, n_paths=256, steps_per_period=4,
               n_periods=N_PERIODS, n_exercise=n_exercise, seed=0)
