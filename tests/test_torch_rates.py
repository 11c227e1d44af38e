"""Vasicek, CIR, Hull-White and G2++ in the port, ``engine/rates.py`` and
the ``bond`` command, against the JAX package: paths from the torch loop
against JAX's scan and one interpret-mode kernel run each of K2 (G2++) and
K4 (Vasicek {trap}), K2-K4's plain versions against the port's torch loop
under every draw source, the refusal of a run longer than Hull-White's
curve, the closed forms, the Monte Carlo pricers, the oracles of
tests/test_rates.py and tests/test_g2pp.py on the port's CPU route,
``grad_safe_sqrt``, and ``bond`` JSON against the JAX CLI's.

Tolerances are tests/torch_rate_pairs.py's (rates held absolutely, within
``rate_atol``: NORMAL_ATOL times the noise scale plus two ULPs a step;
inside the port bitwise), and:

- the interpret-mode kernels run JAX's own step: K2 on G2++ within
  ``rate_atol``; K4's Vasicek {trap} within rtol 2e-6, atol 2e-8, JAX's
  own tolerance between its kernel and its scan
  (tests/test_fused_functionals.py:59);
- closed forms (float64 on both sides, the same operations): rtol 1e-12;
  the G2++ forms from the port's float32 leaves against JAX's on a float64
  model of the same (float32-rounded) parameters;
- ``zcb_price_mc`` and ``bond_option_mc`` against JAX's at the same seed:
  rtol 1e-5 (PRICE_RTOL, tests/torch_process_pairs.py's: the paths within
  their tolerance, summed in each framework's order);
- the oracles keep their files' gates (a few std-err plus the scheme's
  bias), the port running them in float32 where JAX's tests use float64;
  the bitwise contract across path offsets is the port's own (JAX's is
  rtol 1e-14 across its differently compiled scans);
- ``bond`` JSON: the Monte Carlo values within PRICE_RTOL; the closed
  forms within 1e-12, except G2++'s (JAX's ``g2pp_zcb`` computes in its
  float32 model's dtype, the port's in float64: rtol 1e-6, and 1e-5 for
  the swaption's par strike and price, which take P(0, t0) so) and the
  cap's, which both CLIs round to 8 decimals (atol 1.5e-8); the cap's
  Monte Carlo cross-check in float32 where JAX's test run reads each
  caplet's rate in float64 (x64 on): rtol 1e-4.
"""

import argparse
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cli import main as jax_main
from montecarlo_tpu.engine import rates as jrates
from montecarlo_tpu.engine.bermudan import vasicek_swaption_jamshidian
from montecarlo_tpu.engine.functionals import _simulate_functionals as jsf
from montecarlo_tpu.engine.functionals import trapezoid_integral as jtrap
from montecarlo_tpu.ops.fused_engine import (fused_functionals_pallas,
                                             fused_terminal_pallas)
from montecarlo_tpu.processes import base as jbase
from montecarlo_tpu.processes import g2pp as jg2pp
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.engine import (kernel_route, simulate,
                                         terminal_prices,
                                         trapezoid_integral)
from montecarlo_tpu_torch.engine import rates
from montecarlo_tpu_torch.ops import fused_functionals, fused_terminal
from montecarlo_tpu_torch.processes import (CIR, G2PP, HullWhite, Vasicek,
                                            g2pp_bond, g2pp_swaption, g2pp_v,
                                            g2pp_zcb, grad_safe_sqrt)
from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler
from montecarlo_tpu_torch.samplers import PlainSampler
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from tests.torch_process_pairs import PRICE_RTOL, run_cli
from tests.torch_rate_pairs import (RATES, hold_plain_versions, hold_scan,
                                    pair, rate_atol, samplers)

torch.set_num_threads(1)

R0, KAPPA, THETA, SIGMA = 0.03, 0.8, 0.05, 0.015
T = 2.0
N_STEPS = 128
DT = T / N_STEPS


def _f32(x):
    return float(np.float32(x))


# --- paths and kernels' plain versions ---------------------------------------

@pytest.mark.parametrize("n_steps", [16, 32])
@pytest.mark.parametrize("kind", RATES)
def test_paths_match_jax_scan(kind, n_steps):
    hold_scan(kind, n_steps)


def test_g2pp_matches_an_interpret_mode_kernel():
    """JAX's K2 on G2++ (tests/test_g2pp.py:257's run, at 8 x 128 paths x
    16 steps) against K2's plain version."""
    jp, tp = pair("g2pp", 16, T=0.25)
    want = fused_terminal_pallas(jp, 8 * 128, 16, seed=5, block_rows=8,
                                 interpret=True)
    got = fused_terminal(tp, 8 * 128, 16, seed=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=rate_atol(jp, 16))


def test_vasicek_trapezoid_matches_jaxs_kernel():
    """tests/test_fused_functionals.py:59 on the port: the discount
    integral's (sum, previous) accumulator through K4's plain version
    against JAX's K4 in interpret mode (8 x 128 paths x 17 steps)."""
    jp, tp = pair("vasicek", 17, T=17 / 64)
    want = fused_functionals_pallas(jp, 8 * 128, 17, seed=9,
                                    functional_items=(("I", jtrap(1 / 64)),),
                                    block_rows=8, interpret=True)
    got = fused_functionals(tp, 8 * 128, 17, seed=9,
                            functionals={"I": trapezoid_integral(1 / 64)})
    np.testing.assert_allclose(got["I"].numpy(), np.asarray(want["I"]),
                               rtol=2e-6, atol=2e-8)
    ref = jsf(jp, 8 * 128, 17, 9, 0, None, jnp.float32, 0,
              (("I", jtrap(1 / 64)),))
    np.testing.assert_allclose(got["I"].numpy(), np.asarray(ref["I"]),
                               rtol=2e-6, atol=2e-8)


@pytest.mark.parametrize("source", ["plain", "antithetic", "sobol",
                                    "bridge"])
@pytest.mark.parametrize("kind", RATES)
def test_plain_versions_are_the_torch_loop(kind, source):
    _, tp = pair(kind, 17)
    if source == "bridge" and kind == "g2pp":
        # Two draws a step: the gate sends G2++ under the bridge to the
        # torch loop, as JAX sends it to its scan, and the sampler refuses
        # it there as JAX's does.
        bridge = SobolBridgeKernelSampler.create(17, device="cpu")
        assert not kernel_route(tp, bridge, 17)
        with pytest.raises(ValueError, match="n_draws == 1"):
            terminal_prices(tp, 256, 17, seed=0, sampler=bridge)
        return
    hold_plain_versions(tp, 17, source)


def test_route_takes_the_rates_under_their_sources():
    for kind in RATES:
        _, tp = pair(kind, 16)
        for sampler, _ in samplers(tp, 16).values():
            assert kernel_route(tp, sampler, 16), kind


@pytest.mark.parametrize("route", ["K2", "loop", "zcb"])
def test_steps_past_the_theta_curve_are_refused(route):
    hw = HullWhite.create(0.03, 0.8, 0.015, np.full(8, 0.04), 1 / 8,
                          device="cpu")
    run = {"K2": lambda n: fused_terminal(hw, 256, n, seed=0),
           "loop": lambda n: simulate(hw, 256, n, seed=0),
           "zcb": lambda n: rates.zcb_price_mc(hw, n / 8, n, 256, seed=0)}
    with pytest.raises(ValueError, match="8 steps, 9"):
        run[route](9)
    run[route](8)


# --- closed forms ------------------------------------------------------------

def test_closed_forms_match_jax():
    args = (R0, KAPPA, THETA, SIGMA)
    for t in (0.25, 1.0, 2.0, 7.5):
        np.testing.assert_allclose(rates.vasicek_zcb(*args, t),
                                   jrates.vasicek_zcb(*args, t), rtol=1e-12)
        np.testing.assert_allclose(rates.cir_zcb(*args, t),
                                   jrates.cir_zcb(*args, t), rtol=1e-12)
    for call in (True, False):
        for k in (0.9, 0.95, 1.0):
            np.testing.assert_allclose(
                rates.vasicek_bond_option(*args, 1.0, 3.0, k, call),
                jrates.vasicek_bond_option(*args, 1.0, 3.0, k, call),
                rtol=1e-12)
    r = np.linspace(-0.05, 0.15, 41)
    np.testing.assert_allclose(
        rates.vasicek_bond_from_rate(torch.from_numpy(r), KAPPA, THETA,
                                     SIGMA, 1.5).numpy(),
        np.asarray(jrates.vasicek_bond_from_rate(jnp.asarray(r), KAPPA,
                                                 THETA, SIGMA, 1.5)),
        rtol=1e-12)
    tau1 = np.array([0.0, 0.25, 0.5, 1.0])
    for call in (True, False):
        np.testing.assert_allclose(
            rates.vasicek_bond_option_from_rate(
                torch.from_numpy(r[:, None]), KAPPA, THETA, SIGMA,
                torch.from_numpy(tau1), torch.from_numpy(tau1 + 0.25), 0.99,
                call).numpy(),
            np.asarray(jrates.vasicek_bond_option_from_rate(
                jnp.asarray(r[:, None]), KAPPA, THETA, SIGMA,
                jnp.asarray(tau1), jnp.asarray(tau1 + 0.25), 0.99, call)),
            rtol=1e-12, atol=1e-15)
        resets = 0.25 * np.arange(1, 9)
        np.testing.assert_allclose(
            float(rates.vasicek_cap_price(*args, 0.035, resets, 0.25,
                                          floor=not call)),
            float(jrates.vasicek_cap_price(*args, 0.035, resets, 0.25,
                                           floor=not call)), rtol=1e-12)


G2 = (0.03, 0.8, 0.01, 0.08, 0.012, -0.7)  # phi, a, sigma, b, eta, rho


def _g2(params=G2, dt=0.05):
    """The port's G2++ and JAX's on float64 leaves of the same float32
    values."""
    tp = G2PP.create(*params, dt, device="cpu")
    jp = jg2pp.G2PP.create(*[_f32(v) for v in params], _f32(dt),
                           dtype=jnp.float64)
    return tp, jp


def test_g2pp_closed_forms_match_jax():
    tp, jp = _g2()
    tau = np.array([0.1, 0.5, 1.0, 5.0, 30.0])
    v_args = [_f32(v) for v in G2[1:]]
    np.testing.assert_allclose(
        g2pp_v(*[torch.tensor(v, dtype=torch.float64) for v in v_args],
               torch.from_numpy(tau)).numpy(),
        np.asarray(jg2pp.g2pp_v(*[jnp.float64(v) for v in v_args],
                                jnp.asarray(tau))), rtol=1e-12)
    x = np.linspace(-0.02, 0.02, 5)
    np.testing.assert_allclose(
        g2pp_bond(tp, torch.from_numpy(x), torch.from_numpy(-x), 2.5).numpy(),
        np.asarray(jg2pp.g2pp_bond(jp, jnp.asarray(x), jnp.asarray(-x),
                                   2.5)), rtol=1e-12)
    for t in (0.25, 1.0, 10.0):
        np.testing.assert_allclose(float(g2pp_zcb(tp, t)),
                                   float(jg2pp.g2pp_zcb(jp, t)), rtol=1e-12)
    pays = [1.0 + 0.25 * (i + 1) for i in range(8)]
    for payer in (True, False):
        np.testing.assert_allclose(
            g2pp_swaption(tp, 0.031, 1.0, pays, 0.25, payer=payer),
            float(jg2pp.g2pp_swaption(jp, 0.031, 1.0, pays, 0.25,
                                      payer=payer)), rtol=1e-12)


def test_grad_safe_sqrt_matches_jax():
    q = torch.tensor([-1.0, 0.0, 0.25], dtype=torch.float64,
                     requires_grad=True)
    val = grad_safe_sqrt(q)
    (grad,) = torch.autograd.grad(val.sum(), q)
    jq = jnp.asarray([-1.0, 0.0, 0.25])
    np.testing.assert_array_equal(val.detach().numpy(),
                                  np.asarray(jbase.grad_safe_sqrt(jq)))
    np.testing.assert_array_equal(
        grad.numpy(),
        np.asarray(jax.grad(lambda x: jbase.grad_safe_sqrt(x).sum())(jq)))
    assert torch.isfinite(grad).all()


# --- the Monte Carlo pricers against JAX's -----------------------------------

@pytest.mark.parametrize("kind", RATES)
def test_zcb_price_mc_matches_jax(kind):
    jp, tp = pair(kind, 32)
    got = rates.zcb_price_mc(tp, 2.0, 32, 4096, seed=3)
    want = jrates.zcb_price_mc(jp, 2.0, 32, 4096, seed=3)
    for k in ("price", "std_err"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=PRICE_RTOL, err_msg=k)


def test_bond_option_mc_matches_jax():
    jp, tp = pair("vasicek", 32, T=1.0)
    strike = 0.957
    for call in (True, False):
        got = rates.bond_option_mc(tp, 1.0, 3.0, strike, 32, 4096, seed=11,
                                   call=call)
        want = jrates.bond_option_mc(jp, 1.0, 3.0, strike, 32, 4096,
                                     seed=11, call=call)
        for k in ("price", "std_err"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=PRICE_RTOL, err_msg=k)
    with pytest.raises(TypeError, match="Vasicek"):
        rates.bond_option_mc(pair("cir", 8)[1], 1.0, 3.0, strike, 8, 256,
                             seed=0)


# --- tests/test_rates.py's oracles on the port -------------------------------

def _vasicek(dt=DT):
    return Vasicek.create(R0, KAPPA, THETA, SIGMA, dt, device="cpu")


def _np(t):
    return t.double().numpy()


def test_vasicek_exact_transition_moments():
    n = 1 << 16
    for steps, dt in ((4, T / 4), (N_STEPS, DT)):
        r_t = _np(terminal_prices(_vasicek(dt), n, steps, seed=2))
        mean_cf = THETA + (R0 - THETA) * math.exp(-KAPPA * T)
        var_cf = SIGMA**2 / (2 * KAPPA) * (1 - math.exp(-2 * KAPPA * T))
        assert abs(r_t.mean() - mean_cf) < 4 * r_t.std() / math.sqrt(n)
        assert abs(r_t.var() - var_cf) < 0.05 * var_cf


def test_vasicek_zcb_mc_vs_closed_form():
    est = rates.zcb_price_mc(_vasicek(), T, N_STEPS, 1 << 16, seed=3)
    cf = rates.vasicek_zcb(R0, KAPPA, THETA, SIGMA, T)
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]) + 5e-5


def test_cir_zcb_mc_vs_closed_form():
    proc = CIR.create(R0, KAPPA, THETA, SIGMA, DT, device="cpu")
    est = rates.zcb_price_mc(proc, T, N_STEPS, 1 << 16, seed=5)
    cf = rates.cir_zcb(R0, KAPPA, THETA, SIGMA, T)
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]) + 3e-4


def test_cir_stays_finite_and_positive_mean():
    """Full truncation: no NaNs with a vol that violates Feller."""
    proc = CIR.create(0.02, 0.5, 0.03, 0.25, DT, device="cpu")
    r_t = _np(terminal_prices(proc, 1 << 14, N_STEPS, seed=7))
    assert np.isfinite(r_t).all()
    assert r_t.mean() > 0


def test_vasicek_bond_option_mc_vs_jamshidian():
    t1, t2 = 1.0, 3.0
    strike = (rates.vasicek_zcb(R0, KAPPA, THETA, SIGMA, t2)
              / rates.vasicek_zcb(R0, KAPPA, THETA, SIGMA, t1))
    est = rates.bond_option_mc(_vasicek(), t1, t2, strike, 64, 1 << 16,
                               seed=11)
    cf = rates.vasicek_bond_option(R0, KAPPA, THETA, SIGMA, t1, t2, strike)
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]) + 5e-5


def test_hull_white_reprices_input_curve():
    t_grid = np.arange(N_STEPS + 1) * DT
    fwd = 0.02 + 0.015 * (1.0 - np.exp(-t_grid)) + 0.005 * t_grid
    hw = HullWhite.from_forward_curve(fwd, a=0.6, sigma=0.012, dt=DT,
                                      device="cpu")
    est = rates.zcb_price_mc(hw, T, N_STEPS, 1 << 16, seed=13)
    p_mkt = math.exp(-np.trapezoid(fwd, t_grid))
    assert abs(float(est["price"]) - p_mkt) < 4 * float(est["std_err"]) + 2e-4


def test_hull_white_flat_curve_reduces_to_vasicek():
    n_steps, a, sig = 64, 0.6, 0.012
    hw = HullWhite.from_forward_curve(np.full(n_steps + 1, 0.03), a=a,
                                      sigma=sig, dt=T / n_steps,
                                      device="cpu")
    r_hw = _np(terminal_prices(hw, 1 << 15, n_steps, seed=17))
    want = sig * math.sqrt((1 - math.exp(-2 * a * T)) / (2 * a))
    assert abs(r_hw.std() - want) < 0.03 * r_hw.std()


def test_rate_paths_deterministic_and_shardable():
    """The same paths at any path offset, bitwise (the port's contract;
    JAX's scans of different shapes agree to rtol 1e-14)."""
    a = simulate(_vasicek(), 4096, 32, seed=23)
    b = simulate(_vasicek(), 4096, 32, seed=23)
    off = simulate(_vasicek(), 2048, 32, seed=23, path_offset=2048)
    assert torch.equal(a, b)
    assert torch.equal(a[2048:], off)
    assert torch.equal(off, fused_terminal(_vasicek(), 2048, 32, seed=23,
                                           path_offset=2048))


def _cap_mc(resets, k_cap, n, n_mc, seed, floor=False):
    """tests/test_rates.py's pathwise-discounted caplet strip."""
    mc_dt = float(resets[-1]) / n_mc
    paths = simulate(_vasicek(mc_dt), n, n_mc, seed=seed,
                     mode="paths").double()
    mid = 0.5 * (paths[:-1] + paths[1:]) * mc_dt
    cum = torch.cat([torch.zeros((1, n), dtype=torch.float64),
                     torch.cumsum(mid, dim=0)])
    total = 0.0
    for t_i in resets:
        k_i = int(round(float(t_i) / mc_dt))
        p_i = rates.vasicek_bond_from_rate(paths[k_i], KAPPA, THETA, SIGMA,
                                           0.25)
        lib = (1.0 / p_i - 1.0) / 0.25
        pay = (torch.clamp(k_cap - lib, min=0.0) if floor
               else torch.clamp(lib - k_cap, min=0.0))
        total = total + torch.exp(-cum[k_i]) * p_i * 0.25 * pay
    return total


def test_vasicek_cap_floor_parity_and_mc():
    k_cap, delta = 0.035, 0.25
    resets = delta * np.arange(1, 5)
    args = (R0, KAPPA, THETA, SIGMA, k_cap, resets, delta)
    cap = float(rates.vasicek_cap_price(*args))
    floor = float(rates.vasicek_cap_price(*args, floor=True))
    parity = sum(rates.vasicek_zcb(R0, KAPPA, THETA, SIGMA, t)
                 - (1.0 + k_cap * delta)
                 * rates.vasicek_zcb(R0, KAPPA, THETA, SIGMA, t + delta)
                 for t in resets)
    np.testing.assert_allclose(cap - floor, parity, rtol=1e-9)
    total = _cap_mc(resets, k_cap, 1 << 15, 128, seed=11).numpy()
    se = total.std(ddof=1) / math.sqrt(total.size)
    assert abs(total.mean() - cap) < 4 * se


# --- tests/test_g2pp.py's oracles on the port --------------------------------

PHI, A, SG, B, ET, RHO = 0.03, 0.8, 0.01, 0.08, 0.012, -0.7
DELTA, N_PER, T0, K = 0.25, 8, 1.0, 0.031
PAYS = tuple(T0 + (i + 1) * DELTA for i in range(N_PER))


def _model(dt, rho=RHO):
    return G2PP.create(PHI, A, SG, B, ET, rho, dt, device="cpu")


def _g2_run(m, n, n_steps, seed=3):
    """The torch loop's factor state (x, y) at the last step and the
    pathwise discount exp(-trapezoid int r dt), in float64 from the float32
    paths, as tests/test_g2pp.py reads its observed paths."""
    k0, k1 = key_from_seed(seed)
    ids = torch.arange(n, dtype=torch.int64)
    state = m.init_state(ids)
    r_prev = m.prices(state).double()
    integral = torch.zeros(n, dtype=torch.float64)
    dt = float(m.dt)
    for t in range(n_steps):
        state = m.step(state, PlainSampler().draws(m, k0, k1, ids, t), t)
        r = m.prices(state).double()
        integral = integral + 0.5 * (r_prev + r) * dt
        r_prev = r
    return state.x.double(), state.y.double(), torch.exp(-integral)


def test_g2pp_exact_transition_moments():
    T_, n = 2.0, 1 << 16
    x, y, _ = _g2_run(_model(T_ / 4), n, 4)
    obs = np.stack([x.numpy(), y.numpy()])
    vx = SG**2 * (1 - np.exp(-2 * A * T_)) / (2 * A)
    vy = ET**2 * (1 - np.exp(-2 * B * T_)) / (2 * B)
    cxy = RHO * SG * ET * (1 - np.exp(-(A + B) * T_)) / (A + B)
    se = 3.0 / np.sqrt(n)
    assert abs(obs[0].mean()) < 4 * np.sqrt(vx / n)
    assert abs(obs[1].mean()) < 4 * np.sqrt(vy / n)
    np.testing.assert_allclose(obs[0].var(), vx, rtol=5 * se)
    np.testing.assert_allclose(obs[1].var(), vy, rtol=5 * se)
    np.testing.assert_allclose(np.cov(obs)[0, 1], cxy, rtol=8 * se)


def test_g2pp_mc_bond_matches_closed_form():
    T_ = 2.0
    m = _model(T_ / 64)
    est = rates.zcb_price_mc(m, T_, 64, 1 << 15, seed=3)
    cf = float(g2pp_zcb(m, T_))
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"]) \
        + 1e-5 * cf


def test_g2pp_bond_reconstitution_identity():
    T1, T2, n = 1.0, 2.0, 1 << 15
    m = _model(T1 / 32)
    x, y, disc = _g2_run(m, n, 32)
    v = disc * g2pp_bond(m, x, y, T2 - T1)
    mc, se = float(v.mean()), float(v.std(unbiased=False) / np.sqrt(n))
    cf = float(g2pp_zcb(m, T2))
    assert abs(mc - cf) < 4 * se + 1e-5 * cf


def test_g2pp_swaption_vasicek_limit_exact():
    """sigma -> 0: the quadrature reproduces Jamshidian's Vasicek form (of
    the same float32-rounded parameters) to round-off."""
    m = G2PP.create(0.03, 0.3, 1e-12, 0.8, 0.015, 0.0, 0.05, device="cpu")
    px = g2pp_swaption(m, K, T0, PAYS, DELTA, payer=True)
    jam = float(vasicek_swaption_jamshidian(
        (_f32(0.8), _f32(0.03), _f32(0.015)), K, T0, DELTA, N_PER,
        _f32(0.03)))
    np.testing.assert_allclose(px, jam, rtol=1e-12)


def test_g2pp_swaption_matches_exact_transition_mc():
    n, n_steps = 1 << 16, 200
    m = _model(T0 / n_steps)
    x, y, disc = _g2_run(m, n, n_steps)
    cs = np.full(N_PER, K * DELTA)
    cs[-1] += 1.0
    cb = sum(float(c) * g2pp_bond(m, x, y, t - T0) for c, t in zip(cs, PAYS))
    v = disc * torch.clamp(1.0 - cb, min=0.0)
    mc, se = float(v.mean()), float(v.std(unbiased=False) / np.sqrt(n))
    quad = g2pp_swaption(m, K, T0, PAYS, DELTA, payer=True)
    assert abs(mc - quad) < 4 * se, (mc, quad, se)
    q256 = g2pp_swaption(m, K, T0, PAYS, DELTA, n_quad=256)
    np.testing.assert_allclose(quad, q256, rtol=1e-12)


def test_g2pp_swaption_receiver_parity():
    m = _model(0.05)
    pay = g2pp_swaption(m, K, T0, PAYS, DELTA, payer=True)
    rec = g2pp_swaption(m, K, T0, PAYS, DELTA, payer=False)
    cs = np.full(N_PER, K * DELTA)
    cs[-1] += 1.0
    fwd = float(g2pp_zcb(m, T0)) - sum(
        float(c) * float(g2pp_zcb(m, t)) for c, t in zip(cs, PAYS))
    np.testing.assert_allclose(pay - rec, fwd, rtol=1e-12, atol=1e-15)


def test_g2pp_create_guards():
    with pytest.raises(ValueError, match="positive"):
        G2PP.create(0.03, 0.0, 0.01, 0.1, 0.01, 0.0, 0.1, device="cpu")
    with pytest.raises(ValueError, match="rho"):
        G2PP.create(0.03, 0.8, 0.01, 0.1, 0.01, 1.5, 0.1, device="cpu")


# --- the bond command --------------------------------------------------------

def _hold_json(got, want, exact=(), loose=(), mc_rtol=PRICE_RTOL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str) or isinstance(w, int) and k != "zcb_price":
            assert g == w, k
        elif k in exact:
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        elif k in loose:
            np.testing.assert_allclose(g, w, **loose[k], err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=mc_rtol, err_msg=k)


@pytest.mark.parametrize("model", ["vasicek", "cir", "hullwhite", "g2pp"])
def test_bond_zcb_matches_jax_cli(model, capsys):
    argv = ["bond", "--model", model, "--paths", "4096", "--steps", "32",
            "--seed", "3"]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    g2 = {"closed_form": dict(rtol=1e-6)} if model == "g2pp" else {}
    _hold_json(got, want, exact=() if g2 else ("closed_form",), loose=g2)


def test_cli_bond_g2pp(capsys):
    """tests/test_g2pp.py::test_cli_bond_g2pp on the port."""
    out = run_cli(port_main, ["bond", "--model", "g2pp", "--paths", "8192",
                              "--steps", "32", "--maturity", "1.0",
                              "--device", "cpu"], capsys)
    assert abs(out["zcb_price"] - out["closed_form"]) \
        < 5 * out["std_err"] + 1e-4


@pytest.mark.parametrize("flags", [
    ["--option"],
    ["--option", "--option-strike", "0.95", "--t1", "0.5"],
])
def test_bond_option_matches_jax_cli(flags, capsys):
    argv = ["bond", "--paths", "4096", "--steps", "32", *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    _hold_json(got, want, exact=("strike", "jamshidian"))


@pytest.mark.parametrize("flags", [["--cap"], ["--cap", "--floor"],
                                   ["--cap", "--cap-strike", "0.04",
                                    "--cap-resets", "6"]])
def test_bond_cap_matches_jax_cli(flags, capsys):
    argv = ["bond", "--paths", "8192", *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    _hold_json(got, want, exact=("strike",),
               loose={"closed_form": dict(rtol=0, atol=1.5e-8)},
               mc_rtol=1e-4)
    # tests/test_rates.py::test_cli_bond_cap's gate.
    assert abs(got["mc_price"] - got["closed_form"]) \
        < 5 * got["mc_std_err"] + 1e-6


@pytest.mark.parametrize("flags", [[], ["--periods", "6"],
                                   ["--swap-strike", "0.035"]])
def test_bond_g2pp_swaption_matches_jax_cli(flags, capsys):
    argv = ["bond", "--model", "g2pp", "--swaption", *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    _hold_json(got, want, loose={
        "g2pp_european_swaption": dict(rtol=1e-5),
        "strike": dict(rtol=1e-5 if "--swap-strike" not in flags else 0)})
    assert got["g2pp_european_swaption"] > 0


#: The LMM command's Monte Carlo keys, rounded to 8 decimals in its JSON.
LMM_MC_KEYS = ("zcb_price", "std_err", "mc_price", "mc_std_err",
               "bermudan_price")


@pytest.mark.parametrize("flags", [
    [],
    ["--caplet"],
    ["--caplet", "--t1", "1.5", "--option-strike", "0.034", "--lmm-shift",
     "0.01"],
    ["--swaption", "--maturity", "3.0", "--n-exercise", "1"],
    ["--swaption", "--maturity", "3.0", "--n-exercise", "4", "--seed", "2"],
])
def test_bond_lmm_matches_jax_cli(flags, capsys):
    """``bond --model lmm`` (the zero-coupon bond, ``--caplet``,
    ``--swaption``, and with ``--n-exercise 4`` the Bermudan): JAX's keys;
    the Monte Carlo values within PRICE_RTOL plus the JSON's 1e-8 rounding
    (the paths: tests/test_torch_lmm.py), the host closed forms exact."""
    argv = ["bond", "--model", "lmm", "--paths", "4096", *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    _hold_json(got, want, exact=("closed_form", "black_exact", "rebonato",
                                 "strike", "reset", "expiry", "tenor"),
               loose={k: dict(rtol=PRICE_RTOL, atol=1e-8)
                      for k in LMM_MC_KEYS})
    if "--n-exercise" in flags and "4" in flags:
        assert got["instrument"] == "lmm_bermudan_swaption"
        assert got["bermudan_price"] >= got["mc_price"] \
            - 3 * got["mc_std_err"]


@pytest.mark.parametrize("flags", [
    ["--paths", "4096"],
    ["--paths", "4096", "--n-exercise", "1", "--seed", "2"],
    ["--paths", "2048", "--n-exercise", "2", "--periods", "6",
     "--swap-strike", "0.045"],
])
def test_bond_vasicek_swaption_matches_jax_cli(flags, capsys):
    """``bond --swaption`` on Vasicek (the default model): the Bermudan LSM
    in float64 on both sides, at rtol 1e-12 (tests/test_torch_bermudan.py's
    float64 tolerance); the par strike and Jamshidian's European exact."""
    argv = ["bond", "--swaption", *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    _hold_json(got, want, exact=("strike", "jamshidian_european"),
               mc_rtol=1e-12)
    assert got["bermudan_swaption"] > 0


def test_bond_swaption_exercise_bounds_raise_as_in_jax():
    """``--n-exercise`` outside [1, periods - 1]: the engine's ValueError
    on both sides, before any simulation."""
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="n_exercise=8 must be in"):
            main(["bond", "--swaption", "--n-exercise", "8", *extra])


def test_bond_flags_are_jaxs():
    """The port's parser takes the JAX CLI's flags with its defaults."""
    from montecarlo_tpu.cli import bond as jbond
    from montecarlo_tpu_torch.cli import bond as tbond

    def defaults(module):
        parser = argparse.ArgumentParser()
        module.add_parsers(parser.add_subparsers())
        return vars(parser.parse_args(["bond"]))

    want, got = defaults(jbond), defaults(tbond)
    assert got.pop("device") == "cuda"
    assert got == want
