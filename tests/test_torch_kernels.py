"""Kernels K1-K3 of the port: plain versions against the JAX package's
Pallas kernels (interpret mode, as tests/test_gbm_kernel.py and
tests/test_fused_engine.py run them), the wrappers' CPU behaviour and the
dispatch rule.  The kernels themselves are held against these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: K1 starts from the platform log(s0) and ends with the platform
exp on both sides, so the two differ by those plus the Box-Muller normals:
rtol 3e-6, as the JAX package holds its own K1 to its engine.  K2 differs
from JAX through the normals only: rtol 2e-6.  K3's block moments sum rows
in each framework's own order: rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops import (fused_block_moments_pallas,
                                fused_terminal_pallas, gbm_terminal_pallas)
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (VanillaPayoff, payoff_block_moments,
                                         simulate, terminal_prices)
from montecarlo_tpu_torch.ops import (fused_block_moments,
                                      fused_block_moments_reference,
                                      fused_terminal, fused_terminal_reference,
                                      gbm_terminal, gbm_terminal_reference,
                                      launch_counts)
from montecarlo_tpu_torch.samplers import AntitheticSampler
from montecarlo_tpu_torch.stats import moments_from_array

torch.set_num_threads(1)

N = 16 * 128
JAX_PAYOFFS = {
    "call": lambda s: jnp.maximum(s - 100.0, 0.0),
    "put": lambda s: jnp.maximum(100.0 - s, 0.0),
    "digital": lambda s: (s > 100.0).astype(jnp.float32),
}


def _pair(dt=1 / 252):
    jp = JGBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=dt)
    return jp, process_from_numpy(
        "gbm", {k: np.asarray(v) for k, v in jp._asdict().items()})


@pytest.mark.parametrize("n_steps", [1, 16, 17])
def test_k1_reference_matches_pallas(n_steps):
    jp, tp = _pair()
    want = np.asarray(gbm_terminal_pallas(jp, N, n_steps, seed=5,
                                          path_offset=256, block_rows=16,
                                          interpret=True))
    got = gbm_terminal_reference(tp, N, n_steps, seed=5, path_offset=256)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-6)


@pytest.mark.parametrize("n_steps", [1, 16, 17])
@pytest.mark.parametrize("antithetic", [False, True])
def test_k2_reference_matches_pallas(n_steps, antithetic):
    jp, tp = _pair()
    want = np.asarray(fused_terminal_pallas(
        jp, N, n_steps, seed=5, path_offset=128, block_rows=16,
        interpret=True, antithetic=antithetic))
    got = fused_terminal_reference(tp, N, n_steps, seed=5, path_offset=128,
                                   antithetic=antithetic)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)


@pytest.mark.parametrize("n_steps,kind,antithetic", [
    (16, "call", False), (17, "call", False), (17, "call", True),
    (16, "put", False), (17, "digital", False)])
def test_k3_reference_matches_pallas(n_steps, kind, antithetic):
    jp, tp = _pair(dt=1 / 16)
    want = fused_block_moments_pallas(
        jp, JAX_PAYOFFS[kind], 4096, n_steps, seed=3, path_offset=4096,
        block_rows=32, interpret=True, antithetic=antithetic)
    got = fused_block_moments_reference(
        tp, VanillaPayoff(kind, 100.0), 4096, n_steps, seed=3,
        path_offset=4096, antithetic=antithetic)
    for j, t in zip(want, got):
        assert t.shape == (1,)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)


def test_k2_reference_bitwise_equals_engine():
    """Two steps per cipher call and the dropped odd step give exactly the
    engine's per-step arithmetic."""
    _, tp = _pair()
    for sampler, anti in ((None, False), (AntitheticSampler(), True)):
        for n_steps in (1, 16, 17):
            assert torch.equal(
                fused_terminal_reference(tp, N, n_steps, seed=9,
                                         path_offset=3, antithetic=anti),
                simulate(tp, N, n_steps, seed=9, path_offset=3,
                         sampler=sampler))


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    _, tp = _pair()
    before = launch_counts()
    pay = VanillaPayoff("call", 100.0)
    assert torch.equal(gbm_terminal(tp, 1000, 7, seed=2),
                       gbm_terminal_reference(tp, 1000, 7, seed=2))
    assert torch.equal(fused_terminal(tp, 1000, 7, seed=2, antithetic=True),
                       fused_terminal_reference(tp, 1000, 7, seed=2,
                                                antithetic=True))
    got = fused_block_moments(tp, pay, 8192, 7, seed=2)
    want = fused_block_moments_reference(tp, pay, 8192, 7, seed=2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got.count.tolist() == [4096.0, 4096.0]
    assert launch_counts() == before


def test_kernel_argument_checks():
    _, tp = _pair()
    with pytest.raises(ValueError, match="multiple of 4096"):
        fused_block_moments(tp, VanillaPayoff("call", 100.0), 4000, 4,
                            seed=0)
    with pytest.raises(TypeError, match="VanillaPayoff"):
        fused_block_moments(tp, lambda s: s, 4096, 4, seed=0)
    with pytest.raises(TypeError, match="GBM"):
        fused_terminal(object(), 128, 4, seed=0)
    with pytest.raises(ValueError):
        VanillaPayoff("asian", 100.0)


def test_dispatch_rule():
    _, tp = _pair()
    pay = VanillaPayoff("put", 100.0)
    # Vanilla payoff at a multiple of 4096: the K3 route.
    got = payoff_block_moments(tp, pay, 8192, 5, seed=4, path_offset=64)
    want = fused_block_moments_reference(tp, pay, 8192, 5, seed=4,
                                         path_offset=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # Any other callable: K2, then the payoff and moments in torch.
    got = payoff_block_moments(tp, lambda s: s * 2.0, 8192, 5, seed=4)
    terminal = fused_terminal_reference(tp, 8192, 5, seed=4)
    want = moments_from_array((terminal * 2.0).reshape(-1, 4096))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # A ragged path count: one state over the whole run.
    got = payoff_block_moments(tp, pay, 1000, 5, seed=4,
                               sampler=AntitheticSampler())
    assert got.count.tolist() == [1000.0]
    assert torch.equal(terminal_prices(tp, 1000, 5, seed=4),
                       simulate(tp, 1000, 5, seed=4))
    with pytest.raises(TypeError, match="sampler"):
        terminal_prices(tp, 128, 5, seed=4, sampler=object())
