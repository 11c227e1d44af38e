"""Port estimators (mc_estimate, price_to_tolerance) against the JAX package.

Tolerances: the same paths are simulated on both sides (normals within
1e-6); the moments are summed in each framework's own order and, for
price_to_tolerance, the port's CPU path sums 128-path rows in tree order
where JAX sums 4096-path blocks: rtol 1e-5 on price and std-err, and the
same number of chunks.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import mc_estimate as jmc_estimate
from montecarlo_tpu.engine import price_to_tolerance as jptt
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (VanillaPayoff, black_scholes_call,
                                         mc_estimate, price_to_tolerance,
                                         simulate)

torch.set_num_threads(1)

DISC = math.exp(-0.03)


def _pair(dt):
    jp = JGBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=dt)
    return jp, process_from_numpy(
        "gbm", {k: np.asarray(v) for k, v in jp._asdict().items()},
        device="cpu")


def test_mc_estimate_matches_jax():
    jp, tp = _pair(1 / 16)
    want = jmc_estimate(jnp.maximum(jsimulate(jp, 2048, 16, seed=1) - 100.0,
                                    0.0), DISC)
    got = mc_estimate(VanillaPayoff("call", 100.0)(
        simulate(tp, 2048, 16, seed=1)), DISC)
    for k in ("price", "std_err", "n_paths"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_mc_estimate_promotes_bool_payoffs():
    payoffs = torch.tensor([True, False, True, True])
    est = mc_estimate(payoffs, 0.5)
    assert float(est["price"]) == pytest.approx(0.375)


@pytest.mark.parametrize("kind", ["call", "digital"])
def test_price_to_tolerance_matches_jax(kind):
    jp, tp = _pair(1 / 16)
    jpay = {"call": lambda s: jnp.maximum(s - 100.0, 0.0),
            "digital": lambda s: (s > 100.0).astype(jnp.float32)}[kind]
    target = {"call": 0.06, "digital": 0.0035}[kind]
    want = jptt(jp, jpay, target_std_err=target, seed=11,
                chunk_paths=1 << 14, n_steps=16, discount=DISC)
    got = price_to_tolerance(tp, VanillaPayoff(kind, 100.0),
                             target_std_err=target, seed=11,
                             chunk_paths=1 << 14, n_steps=16, discount=DISC)
    assert got["n_chunks"] == int(want["n_chunks"]) > 1
    assert float(got["std_err"]) <= target
    for k in ("price", "std_err", "n_paths"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_price_to_tolerance_converges_to_black_scholes():
    _, tp = _pair(1 / 8)
    est = price_to_tolerance(tp, VanillaPayoff("call", 105.0),
                             target_std_err=0.05, seed=0,
                             chunk_paths=1 << 14, n_steps=8, discount=DISC)
    bs = black_scholes_call(100.0, 105.0, 0.03, 0.2, 1.0)
    assert abs(float(est["price"]) - bs) < 5 * float(est["std_err"]) + 1e-3


def test_price_to_tolerance_rejects_path_id_overflow():
    _, tp = _pair(1 / 8)
    with pytest.raises(ValueError, match="2\\^32"):
        price_to_tolerance(tp, VanillaPayoff("call", 105.0),
                           target_std_err=1e-3, seed=0, chunk_paths=1 << 23,
                           max_chunks=1024)
