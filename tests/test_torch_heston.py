"""The port's Heston (processes/heston.py) and the fused kernels' plain
versions on Heston (K2, K3) against the JAX package.

Tolerances: the draw words are the same; the normals differ by each
platform's log/sqrt/sin/cos (<= 4.8e-7 absolute) and XLA may contract the
step's a*b+c into an FMA (the JAX package holds its own Heston kernel to
its scan within rtol 2e-6 for that reason).  Prices: rtol 2e-6.  One step
from the same state and draws: the float32 operations are the same up to
XLA's contraction, rtol 1e-6 and atol 1e-7 (the variance near 0).  K3's
block moments sum in each framework's own order: rtol 1e-5.  Inside the
port, the pair draws and the kernel order agree with the time loop
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu.processes.heston import HestonState as JState
from montecarlo_tpu.samplers import AntitheticSampler as JAntithetic
from montecarlo_tpu_torch.convert import process_from_numpy, process_to_numpy
from montecarlo_tpu_torch.engine import (VanillaPayoff, payoff_block_moments,
                                         simulate, terminal_prices)
from montecarlo_tpu_torch.ops import (fused_block_moments_reference,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.processes import Heston, HestonState
from montecarlo_tpu_torch.samplers import AntitheticSampler
from montecarlo_tpu_torch.stats import moments_from_array

torch.set_num_threads(1)

N = 16 * 128
PRICE_RTOL = 2e-6


def _pair(xi=0.5):
    jp = JHeston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0, theta=0.04,
                        xi=xi, rho=-0.7, dt=1 / 252)
    return jp, process_from_numpy(
        "heston", {k: np.asarray(v) for k, v in jp._asdict().items()},
        device="cpu")


def test_convert_round_trip_and_field_order():
    jp, tp = _pair()
    assert [f for f in process_to_numpy(tp)] == [
        "s0", "v0", "mu", "kappa", "theta", "xi", "rho", "dt"]
    for k, v in process_to_numpy(tp).items():
        assert v.dtype == np.float32
        assert v == np.float32(getattr(jp, k)), k
    assert Heston.n_draws == 2


@pytest.mark.parametrize("n_steps", [1, 16, 17])
@pytest.mark.parametrize("sampler", ["plain", "antithetic"])
@pytest.mark.parametrize("mode", ["terminal", "paths"])
def test_simulate_matches_jax(n_steps, sampler, mode):
    jp, tp = _pair()
    js = JAntithetic() if sampler == "antithetic" else None
    ts = AntitheticSampler() if sampler == "antithetic" else None
    want = np.asarray(jsimulate(jp, N, n_steps, seed=5, sampler=js,
                                mode=mode, path_offset=77))
    got = simulate(tp, N, n_steps, seed=5, sampler=ts, mode=mode,
                   path_offset=77).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PRICE_RTOL)


def test_step_matches_jax_including_truncation():
    """One step from the same state and draws, with the variance negative,
    zero and positive (the full-truncation branches)."""
    jp, tp = _pair()
    rng = np.random.default_rng(3)
    n = 4096
    log_s = rng.uniform(4.0, 5.0, n).astype(np.float32)
    v = rng.uniform(-0.02, 0.1, n).astype(np.float32)
    v[:256] = 0.0
    z = rng.standard_normal((2, n)).astype(np.float32)
    want = jp.step(JState(jnp.asarray(log_s), jnp.asarray(v)),
                   (jnp.asarray(z[0]), jnp.asarray(z[1])), 0)
    got = tp.step(HestonState(torch.from_numpy(log_s), torch.from_numpy(v)),
                  (torch.from_numpy(z[0]), torch.from_numpy(z[1])), 0)
    np.testing.assert_allclose(got.log_s.numpy(), np.asarray(want.log_s),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v),
                               rtol=1e-6, atol=1e-7)
    assert (got.v.numpy() < 0).any()  # the stored variance may go negative


def test_draws_pair_equals_draws():
    _, tp = _pair()
    ids = torch.arange(1000, dtype=torch.int64) + 2**32 - 300 & 0xFFFFFFFF
    for j in (0, 5):
        eps0, eps1 = tp.draws_pair(7, 1, ids, j)
        for e, t in ((eps0, 2 * j), (eps1, 2 * j + 1)):
            d = tp.draws(7, 1, ids, t)
            assert all(torch.equal(a, b) for a, b in zip(e, d))


@pytest.mark.parametrize("n_steps", [1, 16, 17])
@pytest.mark.parametrize("antithetic", [False, True])
def test_k2_plain_version_matches_jax_simulate(n_steps, antithetic):
    jp, tp = _pair(xi=0.9)  # a vol of vol that drives v below 0
    js = JAntithetic() if antithetic else None
    want = np.asarray(jsimulate(jp, N, n_steps, seed=11, sampler=js,
                                path_offset=256))
    got = fused_terminal_reference(tp, N, n_steps, seed=11, path_offset=256,
                                   antithetic=antithetic)
    np.testing.assert_allclose(got.numpy(), want, rtol=PRICE_RTOL)
    ts = AntitheticSampler() if antithetic else None
    scan = simulate(tp, N, n_steps, seed=11, sampler=ts, path_offset=256)
    assert torch.equal(got, scan)
    assert torch.equal(terminal_prices(tp, N, n_steps, seed=11, sampler=ts,
                                       path_offset=256), got)


@pytest.mark.parametrize("kind", ["call", "put", "digital"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_k3_plain_version_matches_jax_simulate(kind, antithetic):
    jp, tp = _pair()
    n = 2 * 4096
    js = JAntithetic() if antithetic else None
    terminal = np.array(jsimulate(jp, n, 17, seed=4, sampler=js,
                                  path_offset=4096))
    pay = VanillaPayoff(kind, 100.0)
    want = moments_from_array(
        pay(torch.from_numpy(terminal)).reshape(-1, 4096), axis=-1)
    got = fused_block_moments_reference(tp, pay, n, 17, seed=4,
                                        path_offset=4096,
                                        antithetic=antithetic)
    via_engine = payoff_block_moments(
        tp, pay, n, 17, seed=4, path_offset=4096,
        sampler=AntitheticSampler() if antithetic else None)
    for field in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   getattr(want, field).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=field)
        assert torch.equal(getattr(via_engine, field), getattr(got, field))
