"""TermBasketGBM in the port against the JAX package: paths from the torch
loop against JAX's scan on a 3- and a 5-asset book with seeded curves
(tests/torch_state_pairs.py: per-path rtol 2e-6), K2-K4's plain versions
against the port's torch loop (bitwise, Threefry plain and antithetic and
Sobol draws), the refusal of a run longer than the curves on every route,
JAX's padded curves carried across, ``create``'s errors, ``convert``'s
round trip, the gate at 8 and 9 assets and under the bridge, and
tests/test_term_basket.py's oracle on the port: flat curves are the
BasketGBM of the same parameters (bitwise here: the same float32
operations in the same order on the same draws; JAX's test allows rtol
2e-6).  The header's step (``csrc/mgarch_steps.cuh``) is walked on the
host in tests/test_torch_mgarch.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.processes import TermBasketGBM as JTermBasket
from montecarlo_tpu_torch.convert import process_from_numpy, process_to_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, VanillaPayoff,
                                         kernel_route, payoff_block_moments,
                                         simulate, simulate_functionals,
                                         terminal_prices)
from montecarlo_tpu_torch.ops import (fused_block_moments, fused_functionals,
                                      fused_terminal)
from montecarlo_tpu_torch.ops import fused_engine
from montecarlo_tpu_torch.ops.fused_engine import kernel_refusal
from montecarlo_tpu_torch.processes import BasketGBM, TermBasketGBM
from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler
from tests.torch_state_pairs import (book, hold_plain_versions, hold_scan,
                                     numpy_fields, pair)

torch.set_num_threads(1)


@pytest.mark.parametrize("a_n", [3, 5])
def test_paths_match_jax_scan(a_n):
    hold_scan("term-basket", a_n)


@pytest.mark.parametrize("source,a_n", [("plain", 3), ("antithetic", 3),
                                        ("sobol", 3), ("plain", 5)])
def test_plain_versions_are_the_torch_loop(source, a_n):
    _, tp = pair("term-basket", a_n)
    hold_plain_versions(tp, 17, source)


def _basket(a_n, n_curve, device="cpu"):
    corr, s0, _, w = book(a_n)
    rng = np.random.default_rng(3)
    return TermBasketGBM.create(s0, rng.uniform(0.0, 0.05, (a_n, n_curve)),
                                rng.uniform(0.1, 0.3, (a_n, n_curve)), corr,
                                w, 1 / 252, device=device)


@pytest.mark.parametrize("route", ["K2", "K3", "K4", "loop", "functionals",
                                   "step"])
def test_steps_past_the_curves_are_refused(route):
    """A run of more steps than the curves hold raises ValueError on every
    route, before its first step; the curves' own length runs."""
    proc = _basket(3, 8)
    call = VanillaPayoff("call", 100.0)
    run = {
        "K2": lambda n: fused_terminal(proc, 256, n, seed=0),
        "K3": lambda n: fused_block_moments(proc, call, 4096, n, seed=0),
        "K4": lambda n: fused_functionals(proc, 256, n, seed=0,
                                          functionals={"avg": ARITH_MEAN}),
        "loop": lambda n: terminal_prices(proc, 256, n, seed=0,
                                          prefer_fused=False),
        "functionals": lambda n: simulate_functionals(
            proc, 256, n, seed=0, functionals={"avg": ARITH_MEAN},
            prefer_fused=False),
        "step": lambda n: proc.step(proc.init_state(torch.arange(4)),
                                    (torch.zeros(4),) * 3, n - 1),
    }[route]
    with pytest.raises(ValueError, match="8"):
        run(9)
    run(8)


def test_jax_padded_curves_carry_across():
    """JAX pads 17 steps of curves to 128 entries: they come across as they
    are, and a run past the 17 given steps reads the same zeros (drift and
    vol 0: the prices hold still) on both sides, up to the padded length."""
    jp = JTermBasket.create(*_jax_args(17), dtype=jnp.float32)
    tp = process_from_numpy("term-basket", numpy_fields(jp), device="cpu")
    assert tp.max_steps == 128 and tp.mu_t.shape == (3, 128)
    assert torch.equal(simulate(tp, 512, 40, seed=1),
                       simulate(tp, 512, 17, seed=1))
    with pytest.raises(ValueError):
        simulate(tp, 512, 129, seed=1)


def _jax_args(n_curve):
    corr, s0, _, w = book(3)
    rng = np.random.default_rng(4)
    return (s0, rng.uniform(0.0, 0.05, (3, n_curve)),
            rng.uniform(0.1, 0.3, (3, n_curve)), corr, w, 1 / 64)


def test_create_errors_and_round_trip():
    s0, mu, sig, corr, w, dt = _jax_args(9)
    with pytest.raises(ValueError, match="share a shape"):
        TermBasketGBM.create(s0, mu, sig[:, :8], corr, w, dt, device="cpu")
    with pytest.raises(ValueError, match="s0 must be"):
        TermBasketGBM.create(s0[:2], mu, sig, corr, w, dt, device="cpu")
    tp = TermBasketGBM.create(s0, mu, sig, corr, w, dt, device="cpu")
    assert tp.max_steps == 9 and tp.mu_t.shape == (3, 9)
    fields = process_to_numpy(tp)
    assert list(fields) == list(JTermBasket._fields)
    back = process_from_numpy("term-basket", fields, device="cpu")
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), v, k)
    assert torch.equal(simulate(back, 256, 9, seed=1),
                       simulate(tp, 256, 9, seed=1))


def test_route_by_asset_count_and_sampler():
    """Eight assets on the kernels, nine on the torch loop (bitwise the
    loop it runs, K3's route too), the bridge refused at every asset
    count."""
    eight, nine = _basket(8, 16), _basket(9, 16)
    assert kernel_route(eight, None, 16) and not kernel_route(nine, None, 16)
    assert "at most 8" in str(kernel_refusal(nine))
    assert torch.equal(terminal_prices(nine, 4096, 16, seed=2),
                       simulate(nine, 4096, 16, seed=2))
    st = payoff_block_moments(nine, VanillaPayoff("call", 100.0), 4096, 16,
                              seed=2)
    assert torch.isfinite(st.mean).all()
    bridge = SobolBridgeKernelSampler.create(16, scramble_seed=1,
                                             device="cpu")
    for proc in (_basket(1, 16), eight):
        assert "bridge" in str(kernel_refusal(proc, bridge))
        assert not kernel_route(proc, bridge, 16)


def test_dims_packing_is_the_headers():
    """The term basket's ``dims`` packs A under the curve length as
    ``csrc/mgarch_steps.cuh`` unpacks it: the shift and the asset bound
    are the header's, and every A in 1..8 fits below the shift."""
    text = (Path(fused_engine.__file__).resolve().parent.parent / "csrc"
            / "mgarch_steps.cuh").read_text()
    const = {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
             for k in ("kCurveShift", "kMaxStateAssets")}
    assert const["kCurveShift"] == fused_engine.CURVE_SHIFT
    assert const["kMaxStateAssets"] == fused_engine.MAX_STATE_ASSETS
    assert fused_engine.MAX_STATE_ASSETS < 1 << fused_engine.CURVE_SHIFT
    for a_n in (1, 8):
        _, dims, _ = fused_engine._leaves(_basket(a_n, 252))
        assert dims & ((1 << const["kCurveShift"]) - 1) == a_n
        assert dims >> const["kCurveShift"] == 252


def test_flat_curves_are_the_basket():
    """tests/test_term_basket.py's degeneracy on the port: flat curves give
    BasketGBM's paths, here bit for bit."""
    corr, s0, _, w = book(3)
    mu, sig, steps = [0.03, 0.02, 0.04], [0.2, 0.3, 0.25], 64
    flat = TermBasketGBM.create(
        s0, np.tile(np.asarray(mu)[:, None], (1, steps)),
        np.tile(np.asarray(sig)[:, None], (1, steps)), corr, w, 1 / 64,
        device="cpu")
    base = BasketGBM.create(s0, mu, sig, corr, w, 1 / 64, device="cpu")
    assert torch.equal(simulate(flat, 8192, steps, seed=3),
                       simulate(base, 8192, steps, seed=3))
