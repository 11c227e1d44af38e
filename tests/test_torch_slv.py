"""Stochastic-local volatility in the port (processes/slv.py: SLV with exact
per-step rows, SLVKnots, ``slv_to_kernel``, ``calibrate_slv``; ``price
--process slv``) against the JAX package.

Tolerances, and why:

- ``slv_to_kernel`` is float64 NumPy then one float32 rounding on both
  sides: bitwise.
- Paths from K2's plain version against JAX's scan and an interpret-mode
  ``fused_terminal_pallas`` run, 4096 x {9, 17}: SLV within rtol 5e-6 (the
  JAX package's own kernel-vs-scan tolerance for it; measured 3.8e-6),
  SLVKnots within 3e-6 on the port's own draws (measured 2.35e-6: the
  Box-Muller normals differ by each platform's log/sin/cos, <= 4.8e-7,
  and the leverage's slope in log-moneyness carries a path's difference
  into its next step) and within JAX's 2e-6 on JAX's draws (measured
  1.46e-6).  K3's moments within 1e-5.
- ``calibrate_slv`` against JAX's at 2^14 particles x 64 steps: JAX's
  ``segment_sum`` adds the deposits one particle at a time in float32 and
  the port sums them in a tree (``torch.sum``), so the rows differ in
  their last bits from step 0 (all particles in two knots), and each
  step's rows move the particles of the next: every entry within rtol
  5e-4 (measured 1.9e-4), the mean relative difference below 1e-5
  (measured 2.6e-6).  The degenerate calibration (xi = 0, v = 1) equals
  sigma_LV within 1e-6, JAX's gate; two calibrations at one seed are the
  same bits.
- The CLI: the estimate within rtol 1e-5 (the calibrated rows differ as
  above; measured 1e-6 to 3e-6).
- Repricing a Heston-generated surface under other mixing dynamics: 4
  std-err + 0.0075 x price + 0.03, the JAX test's gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cli import main as jax_main
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.engine.heston_analytic import HestonParams, heston_call_cf
from montecarlo_tpu.engine.implied_vol import implied_vol_call
from montecarlo_tpu.engine.simulate import path_ids_for as jpath_ids
from montecarlo_tpu.processes import LocalVolGBM as JLocalVol
from montecarlo_tpu.processes.slv import calibrate_slv as jcalibrate
from montecarlo_tpu.processes.slv import slv_to_kernel as jslv_to_kernel
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import kernel_route, simulate
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.processes import (SLV, LocalVolGBM, SLVKnots,
                                            calibrate_slv, slv_to_kernel)
from montecarlo_tpu_torch.processes.dupire import local_vol_fn_from_ivs
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            SobolDeviceSampler)
from tests.torch_process_pairs import hold_cli, hold_kernel_paths, run_cli

torch.set_num_threads(1)

S0, RATE = 100.0, 0.03
SLV_RTOL, KNOTS_RTOL, JAX_DRAWS_RTOL = 5e-6, 3e-6, 2e-6
CALIB_RTOL, CALIB_MEAN_RTOL = 5e-4, 1e-5
MIXING = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.8, rho=-0.6)


def _demo_fn(t, s):
    return 0.2 - 0.1 * np.log(np.maximum(s, 1e-9) / S0)


def _targets(n_steps=64):
    """JAX's and the port's local-vol targets of test_slv.py::_demo_slv."""
    kw = dict(x_min=-0.9, x_max=0.9)
    return (JLocalVol.create(S0, RATE, 1.0 / n_steps, n_steps, _demo_fn,
                             **kw),
            LocalVolGBM.create(S0, RATE, 1.0 / n_steps, n_steps, _demo_fn,
                               device="cpu", **kw))


@pytest.fixture(scope="module")
def calibrated():
    """JAX's calibrated SLV at 2^14 particles x 64 steps, the port's from
    the same target, and the port's SLV on JAX's rows."""
    jlv, tlv = _targets()
    kw = dict(n_steps=64, n_particles=1 << 14, seed=3, **MIXING)
    js = jcalibrate(jlv, **kw)
    ts = calibrate_slv(tlv, **kw)
    on_jax_rows = process_from_numpy(
        "slv", {k: np.asarray(v) for k, v in js._asdict().items()},
        device="cpu")
    return js, ts, on_jax_rows


# --- calibration ------------------------------------------------------------------

def test_calibration_matches_jax(calibrated):
    js, ts, _ = calibrated
    assert isinstance(ts, SLV) and ts.lev_rows.shape == (64, 128)
    for k, v in js._asdict().items():
        if k != "lev_rows":
            np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                          np.asarray(v), err_msg=k)
    want = np.asarray(js.lev_rows)
    got = ts.lev_rows.numpy()
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() < CALIB_RTOL, rel.max()
    assert rel.mean() < CALIB_MEAN_RTOL, rel.mean()


def test_calibration_is_reproducible(calibrated):
    _, ts, _ = calibrated
    _, tlv = _targets()
    again = calibrate_slv(tlv, n_steps=64, n_particles=1 << 14, seed=3,
                          **MIXING)
    assert torch.equal(again.lev_rows, ts.lev_rows)


def test_degenerate_leverage_equals_local_vol():
    """xi = kappa = 0, v0 = 1: every particle keeps v = 1, so E[v | S] = 1
    and the leverage is sigma_LV on every knot of every step."""
    n_steps = 64
    lv = LocalVolGBM.create(
        S0, RATE, 1.0 / n_steps, n_steps,
        lambda t, s: np.full_like(s, 0.2) * (1.0 + 0.1 * t),
        x_min=-0.8, x_max=0.8, device="cpu")
    slv = calibrate_slv(lv, v0=1.0, kappa=0.0, theta=1.0, xi=0.0, rho=0.0,
                        n_steps=n_steps, n_particles=1 << 13, seed=3)
    want = torch.stack([lv._row(t) for t in range(n_steps)])
    np.testing.assert_allclose(slv.lev_rows.numpy(), want.numpy(), atol=1e-6)


def test_calibration_guards():
    _, tlv = _targets(8)
    with pytest.raises(ValueError, match="odd"):
        calibrate_slv(tlv, n_steps=8, smooth_bins=4, **MIXING)


# --- the processes and their paths ------------------------------------------------

def test_rows_and_knots_are_jaxs(calibrated):
    js, _, tp = calibrated
    for t in range(70):  # past the last row: the clamp
        np.testing.assert_array_equal(
            tp._row(t).numpy(), np.asarray(js.lev_rows)[min(t, 63)])
    for n_knots in (2, 8, 16):
        jk, tk = jslv_to_kernel(js, n_knots), slv_to_kernel(tp, n_knots)
        assert isinstance(tk, SLVKnots) and tk.n_time_knots == n_knots
        for k, v in jk._asdict().items():
            np.testing.assert_array_equal(
                getattr(tk, k).numpy().ravel(), np.asarray(v).ravel(),
                err_msg=k)
        for t in range(66):
            np.testing.assert_array_equal(
                tk._row(t).numpy(), np.asarray(jk._row(t, jnp.float32)))


@pytest.mark.parametrize("n_steps", [9, 17])
def test_slv_kernel_paths_match_jax(calibrated, n_steps):
    js, _, tp = calibrated
    hold_kernel_paths(js, tp, n_steps, rtol=SLV_RTOL)


@pytest.mark.parametrize("n_steps", [9, 17])
def test_slv_knots_kernel_paths_match_jax(calibrated, n_steps):
    js, _, tp = calibrated
    hold_kernel_paths(jslv_to_kernel(js, 8), slv_to_kernel(tp, 8), n_steps,
                      rtol=KNOTS_RTOL)


@pytest.mark.parametrize("kind", ["slv", "slv-knots"])
def test_step_on_jax_draws_matches_jax(calibrated, kind):
    """The step algebra alone: the port's steps fed JAX's draws, against
    JAX's scan, 4096 x 17."""
    js, _, tp = calibrated
    jp = js if kind == "slv" else jslv_to_kernel(js, 8)
    tp = tp if kind == "slv" else slv_to_kernel(tp, 8)
    jids = jpath_ids(4096, 0)
    state = tp.init_state(path_ids_for(4096))
    for t in range(17):
        eps = tuple(torch.from_numpy(np.array(e))
                    for e in jp.draws(5, 0, jids, t))
        state = tp.step(state, eps, t)
    want = np.asarray(jsimulate(jp, 4096, 17, seed=5, dtype=jnp.float32))
    np.testing.assert_allclose(tp.prices(state).numpy(), want,
                               rtol=SLV_RTOL if kind == "slv"
                               else JAX_DRAWS_RTOL)


def test_slv_reprices_a_heston_surface():
    """test_slv.py's Gyongy check on the port's CPU path: calibrated to the
    Dupire local vol of a Heston surface under other mixing dynamics (xi
    0.8 vs 0.4, rho -0.6 vs -0.5), the SLV reprices the vanillas."""
    strikes = np.linspace(70.0, 140.0, 15)
    mats = np.array([0.25, 0.5, 1.0, 1.5, 2.0])
    hp = HestonParams(v0=jnp.float32(0.04), kappa=jnp.float32(1.5),
                      theta=jnp.float32(0.05), xi=jnp.float32(0.4),
                      rho=jnp.float32(-0.5))
    ivs = np.stack([np.asarray(implied_vol_call(
        heston_call_cf(S0, jnp.asarray(strikes), float(T), RATE, hp), S0,
        jnp.asarray(strikes), RATE, float(T))) for T in mats])
    vol_fn = local_vol_fn_from_ivs(strikes, mats, ivs, s0=S0, rate=RATE)
    n_steps = 128
    lv = LocalVolGBM.create(S0, RATE, 1.0 / n_steps, n_steps, vol_fn,
                            x_min=-0.8, x_max=0.8, device="cpu")
    slv = calibrate_slv(lv, v0=0.04, kappa=1.5, theta=0.05, xi=0.8,
                        rho=-0.6, n_steps=n_steps, n_particles=1 << 17,
                        seed=5)
    term = simulate(slv, 1 << 17, n_steps, seed=5).double().numpy()
    disc = np.exp(-RATE)
    for k in (85.0, 100.0, 115.0):
        pay = np.maximum(term - k, 0.0)
        price = disc * pay.mean()
        se = disc * pay.std(ddof=1) / np.sqrt(pay.size)
        cf = float(heston_call_cf(S0, k, 1.0, RATE, hp))
        assert abs(price - cf) < 4 * se + 0.0075 * cf + 0.03, (k, price, cf)


# --- the CLI and the route ---------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--paths", "16384", "--steps", "32", "--strike", "100", "--maturity",
     "0.5"],
    ["--paths", "8192", "--steps", "16", "--payoff", "asian"],
    ["--paths", "8192", "--steps", "16", "--sampler", "sobol-device"],
    ["--paths", "8192", "--steps", "16", "--sampler", "antithetic",
     "--skew", "-0.2", "--xi", "0.6"],
    ["--paths", "4096", "--steps", "16", "--target-se", "0.05"],
])
def test_price_slv_matches_jax_cli(flags, capsys):
    """test_slv.py:104's run and its variants: the port's JSON against the
    JAX CLI's; the 6-month ATM call near Black-Scholes at iv 0.2."""
    argv = ["price", "--process", "slv", "--seed", "4", *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    hold_cli(got, want, rqmc="sobol-device" in flags)
    if "--maturity" in flags:
        assert 5.5 < got["price"] < 7.5, got


def test_route_and_cli_refuse_the_bridge_for_slv(calibrated, capsys):
    _, ts, _ = calibrated
    assert kernel_route(ts, None, 64)
    assert kernel_route(ts, SobolDeviceSampler.create(64, 2, device="cpu"),
                        64)
    assert not kernel_route(ts, SobolBridgeKernelSampler.create(
        64, device="cpu"), 64)
    assert kernel_route(slv_to_kernel(ts), None, 64)
    with pytest.raises(SystemExit, match="single-draw"):
        port_main(["price", "--process", "slv", "--sampler", "sobol-bridge",
                   "--paths", "1024", "--steps", "8", "--device", "cpu"])
    assert capsys.readouterr().out == ""
