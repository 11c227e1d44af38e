"""The dispatch gate's size limit (``engine/dispatch.py::kernel_route``): a
``BasketGBM`` of more than ``MAX_ASSETS`` assets goes to the torch time
loop, where JAX's dispatch prices it too, while the kernels' wrappers keep
refusing it.

Inputs are made once with numpy and carried to both sides through
``convert.process_from_numpy(..., device="cpu")``.  JAX runs eagerly
(``jax.disable_jit``): its basket step unrolls the 129-asset Cholesky into
~8400 operations, which XLA takes ~5 minutes to compile on the CPU, and
evaluated one by one they take ~20 s a call.  Tolerance: rtol 2e-6,
the basket parity tests' (``tests/test_torch_basket.py``): the same
float32 operations in the same order on both sides, the normals differing
by each platform's log/sqrt/sin/cos.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.engine.dispatch import payoff_block_moments as jblock
from montecarlo_tpu.engine.dispatch import terminal_prices as jterminal
from montecarlo_tpu.processes import BasketGBM as JBasket
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                         kernel_route, payoff_block_moments,
                                         simulate_functionals,
                                         terminal_prices)
from montecarlo_tpu_torch.ops import (fused_block_moments,
                                      fused_functionals, fused_terminal)
from montecarlo_tpu_torch.processes.basket import MAX_ASSETS

torch.set_num_threads(1)

PRICE_RTOL = 2e-6
N_PATHS, N_STEPS, SEED = 8, 4, 0


def _basket(a_n, correlated):
    """A basket of ``a_n`` assets, JAX and port from one numpy source:
    identity correlation, or a random correlation matrix."""
    rng = np.random.default_rng(a_n)
    if correlated:
        q = rng.normal(size=(a_n, a_n))
        corr = q @ q.T
        d = np.sqrt(np.diag(corr))
        corr = corr / np.outer(d, d)
    else:
        corr = np.eye(a_n)
    jb = JBasket.create(
        s0=rng.uniform(90, 110, a_n), mu=rng.uniform(0.0, 0.06, a_n),
        sigma=rng.uniform(0.1, 0.4, a_n), corr=corr,
        weights=np.full(a_n, 1.0 / a_n), dt=1.0 / 64.0)
    fields = {k: np.asarray(v) for k, v in jb._asdict().items()}
    return jb, process_from_numpy("basket", fields, device="cpu")


@pytest.mark.parametrize("a_n,routed", [(MAX_ASSETS, True),
                                        (MAX_ASSETS + 1, False)])
def test_kernel_route_decides_from_the_asset_count(a_n, routed):
    _, tb = _basket(a_n, correlated=False)
    assert kernel_route(tb, None, N_STEPS) is routed


@pytest.mark.parametrize("wrapper", [fused_terminal, fused_block_moments,
                                     fused_functionals])
def test_the_kernel_wrappers_still_refuse_129_assets(wrapper):
    _, tb = _basket(MAX_ASSETS + 1, correlated=False)
    args = {fused_terminal: (), fused_block_moments: (
        VanillaPayoff("call", 100.0),), fused_functionals: ()}[wrapper]
    kw = ({"functionals": {"avg": ARITH_MEAN}}
          if wrapper is fused_functionals else {})
    n = 128 if wrapper is fused_block_moments else N_PATHS
    with pytest.raises(ValueError, match="at most 128"):
        wrapper(tb, *args, n, N_STEPS, seed=SEED, **kw)


@pytest.mark.parametrize("correlated", [False, True])
def test_terminal_prices_of_129_assets_match_jax(correlated):
    jb, tb = _basket(MAX_ASSETS + 1, correlated)
    got = terminal_prices(tb, N_PATHS, N_STEPS, seed=SEED)
    with jax.disable_jit():
        want = np.asarray(jterminal(jb, N_PATHS, N_STEPS, seed=SEED))
    assert tuple(got.shape) == want.shape == (N_PATHS,)
    np.testing.assert_allclose(got.numpy(), want, rtol=PRICE_RTOL)


@pytest.mark.parametrize("correlated", [False, True])
def test_payoff_block_moments_of_129_assets_match_jax(correlated):
    jb, tb = _basket(MAX_ASSETS + 1, correlated)
    got = payoff_block_moments(tb, VanillaPayoff("call", 99.0), N_PATHS,
                               N_STEPS, seed=SEED)
    with jax.disable_jit():
        want = jblock(jb, lambda s: jnp.maximum(s - 99.0, 0.0), N_PATHS,
                      N_STEPS, seed=SEED)
    for f in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=PRICE_RTOL, err_msg=f)


@pytest.mark.parametrize("correlated", [False, True])
def test_simulate_functionals_of_129_assets_match_jax(correlated):
    jb, tb = _basket(MAX_ASSETS + 1, correlated)
    got = simulate_functionals(tb, N_PATHS, N_STEPS, seed=SEED,
                               functionals={"avg": ARITH_MEAN})
    with jax.disable_jit():
        want = jf.simulate_functionals(jb, N_PATHS, N_STEPS, seed=SEED,
                                       functionals={"avg": jf.ARITH_MEAN},
                                       dtype=jnp.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=PRICE_RTOL, err_msg=k)
