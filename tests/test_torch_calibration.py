"""The port's calibration slice (``engine/{heston_analytic, cf_pricing,
levy_calibration, rates_calibration, adam}.py``, ``processes/sabr.py``'s
Hagan expansion and smile fit, the ``calibrate`` command) against the JAX
package's.

conftest.py turns on JAX's x64, so the parity tests run both sides in
float64 (the JAX package's arrays and raw starts pinned to float64 here,
the port's ``dtype=torch.float64`` on the CPU).  Tolerances, and why:

- Pricers (Heston's trap-form CF, the four Lévy CFs through
  ``cf_call_price_impl``, the Vasicek swaption's Newton critical rate,
  Hagan's expansion): the same float64 operations in the same order on
  two libraries' complex exp, log and sqrt: Heston and the Lévy prices
  within 1e-9 absolute, the swaptions rtol 1e-10 (JAX's own tolerance
  against Jamshidian), Hagan's vols rtol 1e-12.
- Loss and gradient with respect to the raw coordinates at each
  calibrator's start, against ``jax.value_and_grad`` of the JAX
  package's loss (built from its own functions, as its ``_calibrate*``
  builds it): rtol 1e-7 (reverse mode through 32 Newton steps and a
  complex quadrature in two libraries).
- 25 Adam steps of the Heston-to-IVs, VG and Vasicek fits against JAX's
  ``_calibrate_iv``/``_calibrate`` at ``n_iters=25``: raw within rtol 1e-6
  (Adam divides by sqrt(nu): a gradient's relative error carries into the
  step, and 25 steps compound it).
- The full-length SABR fit (float32, the JAX test's smile) to
  tests/test_sabr_calibration.py's own tolerances; the ``calibrate``
  command's SABR demo to the same, and to JAX's command within 1e-3.
  Full-length Heston and Lévy fits take 10-50 s each here, eagerly: they
  run on the card (tests/test_torch_cuda.py, chip_smoke.py phase 16).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu import cli as jcli
from montecarlo_tpu.engine import cf_pricing as jcf
from montecarlo_tpu.engine import heston_analytic as jha
from montecarlo_tpu.engine import levy_calibration as jlevy
from montecarlo_tpu.engine import rates_calibration as jrates
from montecarlo_tpu.engine.implied_vol import implied_vol_call as jiv
from montecarlo_tpu.processes import sabr as jsabr
from montecarlo_tpu_torch import cli
from montecarlo_tpu_torch.convert import (heston_params_from_numpy,
                                          heston_params_to_numpy)
from montecarlo_tpu_torch.engine import cf_pricing as tcf
from montecarlo_tpu_torch.engine import heston_analytic as tha
from montecarlo_tpu_torch.engine import levy_calibration as tlevy
from montecarlo_tpu_torch.engine import rates_calibration as trates
from montecarlo_tpu_torch.engine.adam import adam_minimize
from montecarlo_tpu_torch.engine.implied_vol import implied_vol_call
from montecarlo_tpu_torch.processes import sabr as tsabr

F64 = torch.float64
S0, R = 100.0, 0.03
KS = np.array([80.0, 90.0, 100.0, 110.0, 120.0] * 3)
TS = np.repeat([0.25, 0.5, 1.0], 5)
HESTON_TRUE = dict(v0=0.04, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7)
#: The CLI's Lévy demos, in each CF's argument order.
LEVY_TRUE = {
    "vg": dict(sigma=0.18, theta=-0.12, nu=0.25),
    "nig": dict(alpha=12.0, beta=-4.0, delta=0.4),
    "merton": dict(sigma=0.15, lam=0.8, jump_mean=-0.08, jump_std=0.12),
    "kou": dict(sigma=0.15, lam=1.0, p_up=0.35, eta1=9.0, eta2=4.0),
}
KAP, TH, SG, R0 = 0.8, 0.05, 0.015, 0.03
F0, T_SABR, BETA = 100.0, 1.0, 0.7
SABR_TRUE = {"alpha": 0.2 * F0 ** (1 - BETA), "nu": 0.35, "rho": -0.4}


def _t(x):
    return torch.as_tensor(np.array(x, np.float64), dtype=F64)


def _quotes():
    grid = [(t0, m, k) for t0 in (1.0, 2.0, 3.0) for m in (4, 8)
            for k in (0.036, 0.045, 0.054)]
    return (np.array([g[0] for g in grid]), np.full(len(grid), 0.5),
            np.array([g[2] for g in grid]), np.array([g[1] for g in grid]))


def _heston_surface():
    """(prices, ivs) of HESTON_TRUE on the 3 x 5 grid, JAX float64."""
    jp = jha.HestonParams(**{k: jnp.float64(v)
                             for k, v in HESTON_TRUE.items()})
    px = jha.heston_call_cf(S0, jnp.asarray(KS), jnp.asarray(TS), R, jp)
    return (np.asarray(px), np.asarray(jiv(px, S0, jnp.asarray(KS), R,
                                           jnp.asarray(TS))))


def _levy_ivs(family):
    phi = getattr(jcf, f"{family}_log_cf")(S0, R, *LEVY_TRUE[family].values(),
                                           jnp.asarray(TS))
    px = jcf.cf_call_price(phi, S0, jnp.asarray(KS), jnp.asarray(TS), R)
    return np.asarray(jiv(px, S0, jnp.asarray(KS), R, jnp.asarray(TS)))


# --- pricers ------------------------------------------------------------------

def test_heston_call_cf_matches_jax():
    jp = jha.HestonParams(**{k: jnp.float64(v)
                             for k, v in HESTON_TRUE.items()})
    want = np.asarray(jha.heston_call_cf(S0, jnp.asarray(KS),
                                         jnp.asarray(TS), R, jp))
    tp = heston_params_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu", F64)
    got = tha.heston_call_cf(S0, _t(KS), _t(TS), R, tp)
    assert got.dtype == F64 and got.shape == (15,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    back = heston_params_to_numpy(tp)
    assert list(back) == list(tha.HestonParams._fields)
    assert all(float(back[k]) == v for k, v in HESTON_TRUE.items())


@pytest.mark.parametrize("family", ["vg", "nig", "merton", "kou"])
def test_levy_cf_prices_match_jax(family):
    """Each family's calibration CF (VG's with its floored martingale
    argument) at the demo's parameters through ``cf_call_price_impl`` at
    the calibrators' 96 nodes, and the exact CF at the oracle's 256."""
    jp = {k: jnp.float64(v) for k, v in LEVY_TRUE[family].items()}
    tp = {k: torch.tensor(v, dtype=F64) for k, v in LEVY_TRUE[family].items()}
    jphi = jlevy._FAMILIES[family][1](jp, S0, R, jnp.asarray(TS))
    tphi = tlevy.FAMILIES[family][1](tp, S0, R, _t(TS))
    want = np.asarray(jcf.cf_call_price_impl(
        jphi, S0, jnp.asarray(KS), jnp.asarray(TS), R, n_quad=96))
    got = tcf.cf_call_price_impl(tphi, S0, _t(KS), _t(TS), R, n_quad=96)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    jphi = getattr(jcf, f"{family}_log_cf")(S0, R, *jp.values(),
                                            jnp.asarray(TS))
    tphi = getattr(tcf, f"{family}_log_cf_tensor")(
        torch.tensor(S0, dtype=F64), R, *tp.values(), _t(TS))
    want = np.asarray(jcf.cf_call_price(jphi, S0, jnp.asarray(KS),
                                        jnp.asarray(TS), R))
    got = tcf.cf_call_price_impl(tphi, S0, _t(KS), _t(TS), R)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_vasicek_swaption_prices_match_jax():
    e, d, k, m = _quotes()
    want = np.asarray(jrates.vasicek_swaption_prices(R0, KAP, TH, SG, e, d,
                                                     k, m))
    got = trates.vasicek_swaption_prices(R0, KAP, TH, SG, e, d, k, m,
                                         dtype=F64, device="cpu")
    assert got.dtype == F64 and np.all(got.numpy() > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


def test_sabr_hagan_iv_matches_jax_through_the_money():
    ks = np.concatenate([np.linspace(70.0, 140.0, 29),
                         [99.999, 100.0, 100.001]])
    args = (T_SABR, SABR_TRUE["alpha"], BETA, SABR_TRUE["nu"],
            SABR_TRUE["rho"])
    want = np.asarray(jsabr.sabr_hagan_iv(F0, jnp.asarray(ks), *args))
    got = tsabr.sabr_hagan_iv(F0, _t(ks), *args)
    assert got.dtype == F64 and np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    # The ATM guard keeps the gradient finite (the unselected branch).
    a = torch.tensor(SABR_TRUE["alpha"], dtype=F64, requires_grad=True)
    iv = tsabr.sabr_hagan_iv(F0, torch.tensor(100.0, dtype=F64), T_SABR, a,
                             BETA, SABR_TRUE["nu"], SABR_TRUE["rho"])
    (g,) = torch.autograd.grad(iv, a)
    assert torch.isfinite(g)


def test_implied_vol_keeps_dtype_device_and_graph():
    """A float32 price stays float32; a price that requires grad gives
    d(iv)/d(price) = 1/vega (the inverse function's derivative) through
    the 32 clipped Newton steps."""
    from montecarlo_tpu_torch.engine import black_scholes_call_tensor
    from montecarlo_tpu_torch.engine.greeks import black_scholes_vega

    px32 = torch.tensor([8.0, 10.0], dtype=torch.float32)
    assert implied_vol_call(px32, S0, 100.0, R, 1.0).dtype == torch.float32
    px = black_scholes_call_tensor(S0, 105.0, R, 0.25, 1.0).clone()
    px.requires_grad_(True)
    iv = implied_vol_call(px, S0, 105.0, R, 1.0)
    (g,) = torch.autograd.grad(iv, px)
    vega = float(black_scholes_vega(S0, 105.0, R, 0.25, 1.0))
    np.testing.assert_allclose(float(g), 1.0 / vega, rtol=1e-8)


# --- losses and gradients at the raw starts ------------------------------------

def _jax_heston_losses():
    px, ivs = _heston_surface()
    ks, ts = jnp.asarray(KS), jnp.asarray(TS)
    lower = jnp.maximum(S0 - ks * jnp.exp(-R * ts), 0.0)

    def price_loss(raw):
        model = jha.heston_call_cf(S0, ks, ts, R, jha._constrain(raw),
                                   n_quad=96)
        return jnp.mean(jnp.square(model - px))

    def iv_loss(raw):
        model = jha.heston_call_cf(S0, ks, ts, R, jha._constrain(raw),
                                   n_quad=96)
        model = jnp.clip(model, lower + 1e-6, S0 * (1.0 - 1e-6))
        return jnp.mean(jnp.square(jiv(model, S0, ks, R, ts) - ivs))

    return px, ivs, price_loss, iv_loss


def _jax_levy_loss(family, ivs):
    constrain, make_phi, _ = jlevy._FAMILIES[family]
    ks, ts = jnp.asarray(KS), jnp.asarray(TS)
    lower = jnp.maximum(S0 - ks * jnp.exp(-R * ts), 0.0)

    def loss(raw):
        model = jcf.cf_call_price_impl(make_phi(constrain(raw), S0, R, ts),
                                       S0, ks, ts, R, n_quad=96)
        model = jnp.clip(model, lower + 1e-6, S0 * (1.0 - 1e-6))
        return jnp.mean(jnp.square(jiv(model, S0, ks, R, ts) - ivs))

    return loss


def _jax_vasicek_loss(prices):
    e, d, k, m = _quotes()

    def loss(raw):
        p = jrates._constrain(raw)
        model = jrates.vasicek_swaption_prices(
            R0, p["kappa"], p["theta"], p["sigma"], e, d, k, m,
            max_periods=8)
        return jnp.mean(jnp.square(model / prices - 1.0))

    return loss


def _jax_sabr_loss(strikes, ivs):
    def loss(raw):
        alpha, nu, rho = jsabr._constrain_sabr(raw)
        model = jsabr.sabr_hagan_iv(F0, strikes, T_SABR, alpha, BETA, nu,
                                    rho)
        return jnp.mean(jnp.square(model - ivs))

    return loss


def _raw_start(name):
    return {"heston_price": tha.RAW0, "heston_iv": tha.RAW0,
            "vasicek": trates.RAW0, "sabr": tsabr.SABR_RAW0,
            **{f: tlevy.FAMILIES[f][2] for f in tlevy.FAMILIES}}[name]


def _losses(name):
    """(JAX's loss, the port's loss) of calibrator ``name``, float64."""
    ops = lambda *xs: tuple(_t(x) for x in xs)
    if name.startswith("heston"):
        px, ivs, jprice, jivl = _jax_heston_losses()
        if name == "heston_price":
            return jprice, tha._price_loss(*ops(KS, TS, px, S0, R), 96)
        return jivl, tha._iv_loss(*ops(KS, TS, ivs, S0, R), 96)
    if name == "vasicek":
        e, d, k, m = _quotes()
        prices = np.asarray(jrates.vasicek_swaption_prices(R0, KAP, TH, SG,
                                                           e, d, k, m))
        return _jax_vasicek_loss(prices), trates._swaption_loss(
            *ops(R0, e, d, k), torch.as_tensor(m), _t(prices), 8)
    if name == "sabr":
        ks = np.linspace(80.0, 125.0, 10)
        ivs = np.asarray(jsabr.sabr_hagan_iv(
            F0, jnp.asarray(ks), T_SABR, SABR_TRUE["alpha"], BETA,
            SABR_TRUE["nu"], SABR_TRUE["rho"]))
        return (_jax_sabr_loss(jnp.asarray(ks), ivs),
                tsabr._smile_loss(_t(ks), _t(ivs), F0, T_SABR, BETA))
    ivs = _levy_ivs(name)
    return _jax_levy_loss(name, ivs), tlevy._iv_loss(
        name, *ops(KS, TS, ivs, S0, R))


@pytest.mark.parametrize("name", ["heston_price", "heston_iv", "vg", "nig",
                                  "merton", "kou", "vasicek", "sabr"])
def test_loss_and_gradient_at_the_start_match_jax(name):
    jloss, tloss = _losses(name)
    raw0 = np.asarray(_raw_start(name), np.float64)
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(raw0))
    leaf = _t(raw0).requires_grad_(True)
    got = tloss(leaf)
    (got_g,) = torch.autograd.grad(got, leaf)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-7)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-7)
    assert np.all(np.asarray(want_g) != 0.0)


# --- Adam trajectories ----------------------------------------------------------

N_SHORT = 25


def test_heston_iv_adam_trajectory_matches_jax():
    _, ivs = _heston_surface()
    raw0 = np.asarray(tha.RAW0, np.float64)
    want, wl = jha._calibrate_iv(jnp.asarray(KS), jnp.asarray(TS),
                                 jnp.asarray(ivs), S0, R, jnp.asarray(raw0),
                                 N_SHORT, 96, 0.05)
    got, gl = tha._calibrate_iv(KS, TS, ivs, S0, R, _t(raw0), N_SHORT, 96,
                                0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)


def test_vg_adam_trajectory_matches_jax():
    ivs = _levy_ivs("vg")
    raw0 = np.asarray(tlevy.FAMILIES["vg"][2], np.float64)
    want, wl = jlevy._calibrate_iv("vg", jnp.asarray(KS), jnp.asarray(TS),
                                   jnp.asarray(ivs), jnp.float64(S0),
                                   jnp.float64(R), jnp.asarray(raw0),
                                   N_SHORT, 0.03)
    got, gl = tlevy._calibrate_iv("vg", KS, TS, ivs, S0, R, _t(raw0),
                                  N_SHORT, 0.03)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)


def test_vasicek_adam_trajectory_matches_jax():
    e, d, k, m = _quotes()
    prices = np.asarray(jrates.vasicek_swaption_prices(R0, KAP, TH, SG, e, d,
                                                       k, m))
    raw0 = np.asarray(trates.RAW0, np.float64)
    want, wl = jrates._calibrate(jnp.float64(R0), jnp.asarray(e),
                                 jnp.asarray(d), jnp.asarray(k),
                                 jnp.asarray(m, jnp.int32),
                                 jnp.asarray(prices), jnp.asarray(raw0),
                                 N_SHORT, 0.05, 8)
    got, gl = trates._calibrate(R0, e, d, k, m, prices, _t(raw0), N_SHORT,
                                0.05, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)


def test_adam_is_optax_adam():
    """The update itself, on a quadratic, against optax.adam's parameters
    step by step (float64)."""
    import optax

    target = np.array([1.0, -2.0, 0.5])
    raw0 = np.array([0.3, 0.1, -0.7])
    jloss = lambda p: jnp.sum(jnp.square(p - target) * jnp.arange(1.0, 4.0))
    opt = optax.adam(0.05)
    p, st = jnp.asarray(raw0), opt.init(jnp.asarray(raw0))
    for _ in range(40):
        g = jax.grad(jloss)(p)
        u, st = opt.update(g, st)
        p = optax.apply_updates(p, u)
    w = torch.arange(1.0, 4.0, dtype=F64)
    got, losses = adam_minimize(lambda q: torch.sum(
        torch.square(q - _t(target)) * w), _t(raw0), 40, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(p), rtol=1e-13)
    assert losses.shape == (40,) and float(losses[-1]) < float(losses[0])


# --- full fits and the command ---------------------------------------------------

def test_calibrate_sabr_recovers_the_jax_tests_smile():
    """tests/test_sabr_calibration.py's smile and tolerances, float32, at
    the full 3000 steps."""
    strikes = np.linspace(80.0, 125.0, 10)
    ivs = np.asarray(jsabr.sabr_hagan_iv(
        F0, jnp.asarray(strikes), T_SABR, SABR_TRUE["alpha"], BETA,
        SABR_TRUE["nu"], SABR_TRUE["rho"]))
    fit = tsabr.calibrate_sabr(strikes, ivs, f0=F0, T=T_SABR, beta=BETA,
                               device="cpu")
    assert fit["rmse_vol"] < 5e-4, fit
    assert abs(fit["alpha"] - SABR_TRUE["alpha"]) / SABR_TRUE["alpha"] < 0.05
    assert abs(fit["nu"] - SABR_TRUE["nu"]) < 0.05, fit
    assert abs(fit["rho"] - SABR_TRUE["rho"]) < 0.08, fit


def _run(main, argv, capsys):
    rc = main(argv)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_calibrate_sabr_demo_matches_jax(capsys):
    got = _run(cli.main, ["calibrate", "--model", "sabr", "--device", "cpu"],
               capsys)
    want = _run(jcli.main, ["calibrate", "--model", "sabr"], capsys)
    assert set(got) == set(want)
    truth = got["demo_truth"]
    assert got["rmse_vol"] < 5e-4
    assert abs(got["alpha"] - truth["alpha"]) / truth["alpha"] < 0.05
    assert abs(got["nu"] - truth["nu"]) < 0.05
    assert abs(got["rho"] - truth["rho"]) < 0.08
    for k in ("alpha", "nu", "rho", "rmse_vol"):
        assert abs(got[k] - want[k]) < 1e-3, (k, got, want)


def test_cli_calibrate_lmm_matches_jax(capsys):
    """``calibrate --model lmm``: the same JSON as the JAX command (host
    float64 over the same float32 leaves) and tests/test_lmm.py::
    test_cli_calibrate_lmm's recovery; ``--surface`` exits as in JAX."""
    got = _run(cli.main, ["calibrate", "--model", "lmm", "--device", "cpu"],
               capsys)
    want = _run(jcli.main, ["calibrate", "--model", "lmm"], capsys)
    assert got == want
    assert abs(got["corr_beta"] - 0.35) < 1e-3
    assert got["vol_max_abs_err"] < 1e-9
    with pytest.raises(SystemExit, match="demo-only"):
        cli.main(["calibrate", "--model", "lmm", "--surface", "x.csv",
                  "--device", "cpu"])


def test_cli_calibrate_needs_a_card_for_cuda(monkeypatch):
    """The default ``--device cuda`` without a card exits; it never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["calibrate", "--model", "sabr"])


def test_unknown_family_is_refused():
    with pytest.raises(ValueError, match="unknown Levy family"):
        tlevy.calibrate_levy_to_ivs("cgmy", KS, TS, np.full(KS.shape, 0.2),
                                    s0=S0, r=R, device="cpu")
