"""Euler GBM and term-structure GBM in the port against the JAX package:
paths from the torch loop against JAX's scan and one
``fused_terminal_pallas(..., interpret=True)`` run, K2-K4's plain versions
against the port's torch loop under every draw source, the refusal of a
run longer than the curves, JAX's padded curves carried across, and the
oracles of tests/test_term_gbm.py on the port's CPU route.

Tolerances are tests/torch_rate_pairs.py's (per-path rtol 2e-6 against
JAX's scan; inside the port bitwise), and:

- the interpret-mode kernel runs JAX's own step (one-hot curve reads, its
  own FMA choices): the same rtol 2e-6;
- the oracles keep tests/test_term_gbm.py's tolerances (rtol 1e-6 between
  flat curves and GBM, whose steps group the same float32 operations; 5e-3
  on the forwards; 0.01 and 0.02 on the realized vols), and Euler's mean
  E[S_T] = s0 (1 + mu dt)^T, exact for the scheme, within 4 std-err.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops.fused_engine import fused_terminal_pallas
from montecarlo_tpu.processes import TermStructureGBM as JTerm
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, kernel_route, simulate,
                                         simulate_functionals,
                                         terminal_prices)
from montecarlo_tpu_torch.ops import (fused_functionals, fused_terminal,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.processes import (GBM, EulerGBM,
                                            TermStructureGBM)
from tests.torch_rate_pairs import (GBM_RTOL, hold_plain_versions,
                                    hold_scan, pair, samplers)

torch.set_num_threads(1)

KINDS = ("euler-gbm", "term-gbm")


@pytest.mark.parametrize("n_steps", [16, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_paths_match_jax_scan(kind, n_steps):
    hold_scan(kind, n_steps)


def test_term_gbm_matches_an_interpret_mode_kernel():
    """JAX's K2 itself on the curves (tests/test_term_gbm.py:48's kernel
    run, at 8 x 128 paths x 17 steps) against K2's plain version."""
    jp, tp = pair("term-gbm", 17, T=17 / 252)
    want = fused_terminal_pallas(jp, 8 * 128, 17, seed=5, block_rows=8,
                                 interpret=True)
    got = fused_terminal(tp, 8 * 128, 17, seed=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GBM_RTOL)


@pytest.mark.parametrize("source", ["plain", "antithetic", "sobol",
                                    "bridge"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_are_the_torch_loop(kind, source):
    _, tp = pair(kind, 17)
    hold_plain_versions(tp, 17, source)


def test_route_takes_both_under_every_source():
    for kind in KINDS:
        _, tp = pair(kind, 16)
        for sampler, _ in samplers(tp, 16).values():
            assert kernel_route(tp, sampler, 16), kind


def _term(n_curve):
    rng = np.random.default_rng(1)
    return TermStructureGBM.from_curves(
        100.0, rng.uniform(0.0, 0.05, n_curve), rng.uniform(0.1, 0.3,
                                                            n_curve),
        1 / 252, device="cpu")


@pytest.mark.parametrize("route", ["K2", "K4", "loop", "functionals",
                                   "step"])
def test_steps_past_the_curve_are_refused(route):
    """A run of more steps than the curves hold raises ValueError on every
    route, before its first step; the curve's own length runs."""
    proc = _term(8)
    run = {
        "K2": lambda n: fused_terminal(proc, 256, n, seed=0),
        "K4": lambda n: fused_functionals(proc, 256, n, seed=0,
                                          functionals={"avg": ARITH_MEAN}),
        "loop": lambda n: terminal_prices(proc, 256, n, seed=0,
                                          prefer_fused=False),
        "functionals": lambda n: simulate_functionals(
            proc, 256, n, seed=0, functionals={"avg": ARITH_MEAN},
            prefer_fused=False),
        "step": lambda n: proc.step(proc.init_state(torch.arange(4)),
                                    (torch.zeros(4),), n - 1),
    }[route]
    with pytest.raises(ValueError, match="8"):
        run(9)
    run(8)


def test_jax_padded_curves_carry_across():
    """JAX pads 17 steps of curves to 32 entries: they come across as they
    are, and a run past the 17 given steps reads the same zeros (drift and
    vol 0: the price holds still) on both sides, up to the padded length."""
    rng = np.random.default_rng(2)
    jp = JTerm.from_curves(100.0, rng.uniform(0, 0.05, 17),
                           rng.uniform(0.1, 0.3, 17), 1 / 252,
                           dtype=jnp.float32)
    tp = process_from_numpy("term-gbm", {k: np.asarray(v) for k, v in
                                         jp._asdict().items()}, device="cpu")
    assert tp.max_steps == 32
    assert torch.equal(fused_terminal_reference(tp, 512, 32, seed=1),
                       fused_terminal_reference(tp, 512, 17, seed=1))
    with pytest.raises(ValueError):
        simulate(tp, 512, 33, seed=1)


# --- tests/test_term_gbm.py's oracles on the port -----------------------------

def test_flat_curves_reduce_to_gbm():
    steps = 32
    flat = TermStructureGBM.from_curves(100.0, np.full(steps, 0.03),
                                        np.full(steps, 0.2), 1 / 252,
                                        device="cpu")
    plain = GBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252,
                       device="cpu")
    np.testing.assert_allclose(simulate(flat, 4096, steps, seed=5).numpy(),
                               simulate(plain, 4096, steps, seed=5).numpy(),
                               rtol=1e-6)


def test_dividend_yield_lowers_forward():
    steps, n = 252, 1 << 15
    no_div = TermStructureGBM.with_dividend(100.0, 0.05, 0.0, 0.2, 1 / 252,
                                            steps, device="cpu")
    with_div = TermStructureGBM.with_dividend(100.0, 0.05, 0.02, 0.2,
                                              1 / 252, steps, device="cpu")
    f0 = terminal_prices(no_div, n, steps, seed=3).double().mean().item()
    f1 = terminal_prices(with_div, n, steps, seed=3).double().mean().item()
    np.testing.assert_allclose(f0, 100 * np.exp(0.05), rtol=5e-3)
    np.testing.assert_allclose(f1, 100 * np.exp(0.03), rtol=5e-3)


def test_time_varying_vol_realized():
    """First half sigma 0.1, second half 0.4: each half's realized vol
    matches its curve."""
    steps = 64
    sig = np.concatenate([np.full(32, 0.1), np.full(32, 0.4)])
    proc = TermStructureGBM.from_curves(100.0, np.zeros(steps), sig,
                                        1 / 252, device="cpu")
    paths = simulate(proc, 1 << 14, steps, seed=7, mode="paths").numpy()
    rets = np.diff(np.log(paths), axis=0)
    assert abs(rets[:32].std() * np.sqrt(252) - 0.1) < 0.01
    assert abs(rets[32:].std() * np.sqrt(252) - 0.4) < 0.02


def test_euler_mean_is_exact():
    """E[S_T] = s0 (1 + mu dt)^T under the Euler scheme, at any dt."""
    steps, n = 64, 1 << 15
    proc = EulerGBM.create(100.0, 0.05, 0.3, 1 / 16, device="cpu")
    s = terminal_prices(proc, n, steps, seed=9).double().numpy()
    exact = 100.0 * (1 + np.float64(np.float32(0.05)) / 16) ** steps
    assert abs(s.mean() - exact) < 4 * s.std() / np.sqrt(n)
