"""The port's greeks (``montecarlo_tpu_torch/engine/greeks.py``, the
``greeks`` command) against the JAX package's, and the refusal of a
process whose leaf requires grad on every kernel route.

Both sides run in float32 (conftest.py turns on JAX's x64, so JAX's
processes and calls are pinned to float32).  Tolerances, and why:

- The normals of the two packages agree within 4.8e-7 (each takes its
  platform's log, sin and cos), not bitwise, so a path's terminal price
  agrees within ~2e-6 relative, and a mean over the paths is summed in
  another order.  Prices and pathwise gradients: rtol 1e-4 (a path whose
  terminal lies within 2e-4 of the strike could cross it; none does at
  these seeds, and the measured gap is below 2e-5).
- The likelihood-ratio greeks multiply the payoff by a score of size 1/
  (sigma sqrt(T)) and cancel in the mean: rtol 1e-3 on price, delta and
  their errors, vega within 1e-3 of its own standard error.
- Second order: the price, gradient and gamma within rtol 1e-3, vanna and
  volga within 5e-3 of their own magnitude plus 0.05 (double reverse mode
  in float32: each path's volga term cancels a payoff curvature against a
  drift term, and at the command's 16 steps the two packages' volgas of
  -1.25e4 differ by 1.6e-3 of it).  The port's Hessian
  is symmetric within 1e-4 relative (its two off-diagonals come from two
  reverse passes in float32; JAX's test holds 1e-8 in float64).
- ``greeks --american`` (policy-frozen American greeks, float32 on both
  sides): rtol 1e-4 on price and every gradient, the pathwise tolerance
  above; here a path could also flip its exercise decision where the two
  packages' fitted continuations (float32 sums in two orders, ~1e-6
  apart) straddle its payoff, and none does at these seeds (measured
  agreement ~1e-6).
- ``remat=True`` against ``remat=False``: bitwise (the checkpointed steps
  recompute the same float32 operations).
- The JAX test file's Black-Scholes gates (tests/test_greeks.py) run on
  the port at their own sizes and bounds.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

from montecarlo_tpu import cli as jcli
from montecarlo_tpu.engine import greeks as jg
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu_torch import cli
from montecarlo_tpu_torch.engine import (black_scholes_call,
                                         payoff_block_moments, simulate,
                                         terminal_prices)
from montecarlo_tpu_torch.engine.dispatch import functional_run
from montecarlo_tpu_torch.engine.functionals import ARITH_MEAN
from montecarlo_tpu_torch.engine.greeks import (black_scholes_delta,
                                                black_scholes_vega,
                                                lr_greeks_gbm,
                                                price_and_greeks,
                                                second_order_greeks,
                                                smoothed_call,
                                                smoothed_digital)
from montecarlo_tpu_torch.engine.payoffs import VanillaPayoff
from montecarlo_tpu_torch.ops import (fused_block_moments,
                                      fused_functionals, fused_terminal,
                                      gbm_terminal)
from montecarlo_tpu_torch.ops.basket_kernel import packed_basket_terminal
from montecarlo_tpu_torch.processes import (GBM, BasketGBM, GARCHBootstrap,
                                            Heston)

S0, R, SIGMA, STRIKE = 100.0, 0.03, 0.2, 105.0
N_STEPS = 64
T = N_STEPS / 252.0
HESTON = dict(s0=S0, v0=0.04, mu=R, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7,
              dt=1 / 252)
F32 = jnp.float32


def _gbm(s0=S0, dt=1 / 252):
    return GBM.create(s0=s0, mu=R, sigma=SIGMA, dt=dt, device="cpu")


def _call(s):
    return torch.clamp(s - STRIKE, min=0.0)


def _jcall(s):
    return jnp.maximum(s - STRIKE, 0.0)


def _fields(obj) -> dict:
    return {f.name: float(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


# --- pathwise greeks against JAX -------------------------------------------

@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_price_and_greeks_match_jax(kind):
    n, steps = 1 << 12, 16
    if kind == "gbm":
        proc, jproc = _gbm(), JGBM.create(S0, R, SIGMA, 1 / 252, dtype=F32)
    else:
        proc = Heston.create(**HESTON, device="cpu")
        jproc = JHeston.create(**HESTON, dtype=F32)
    price, grads = price_and_greeks(proc, _call, n, steps, seed=3,
                                    discount=0.97)
    jprice, jgrads = jg.price_and_greeks(jproc, _jcall, n, steps, seed=3,
                                         discount=0.97, dtype=F32)
    np.testing.assert_allclose(float(price), float(jprice), rtol=1e-4)
    got, want = _fields(grads), dict(jgrads._asdict())
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_remat_is_bitwise_the_plain_backward():
    """Checkpointed steps recompute their draws from the counters and give
    the same bits, price and every gradient (GBM and Heston)."""
    for proc in (_gbm(), Heston.create(**HESTON, device="cpu")):
        p0, g0 = price_and_greeks(proc, _call, 1 << 12, 32, seed=3)
        p1, g1 = price_and_greeks(proc, _call, 1 << 12, 32, seed=3,
                                  remat=True)
        assert torch.equal(p0, p1)
        for f in dataclasses.fields(proc):
            assert torch.equal(getattr(g0, f.name), getattr(g1, f.name)), \
                f.name


def test_gbm_delta_vega_match_black_scholes():
    """tests/test_greeks.py's gate on the port."""
    n = 1 << 17
    price, grads = price_and_greeks(_gbm(), _call, n, N_STEPS, seed=3,
                                    discount=float(np.exp(-R * T)))
    assert abs(float(price) - black_scholes_call(S0, STRIKE, R, SIGMA,
                                                 T)) < 0.05
    bs_delta = float(black_scholes_delta(S0, STRIKE, R, SIGMA, T))
    bs_vega = float(black_scholes_vega(S0, STRIKE, R, SIGMA, T))
    assert abs(float(grads.s0) - bs_delta) < 0.01
    assert abs(float(grads.sigma) - bs_vega) / bs_vega < 0.03


def test_greeks_use_common_random_numbers():
    n, eps = 1 << 15, 1e-2
    p0, grads = price_and_greeks(_gbm(), _call, n, N_STEPS, seed=7)
    p_up, _ = price_and_greeks(_gbm(S0 + eps), _call, n, N_STEPS, seed=7)
    fd_delta = (float(p_up) - float(p0)) / eps
    assert abs(fd_delta - float(grads.s0)) < 2e-3


def test_heston_greeks_finite():
    price, grads = price_and_greeks(Heston.create(**HESTON, device="cpu"),
                                    _call, 1 << 14, N_STEPS, seed=5)
    assert float(price) > 0
    assert 0.0 < float(grads.s0) < 1.0
    for k in ("v0", "kappa", "theta", "xi", "rho"):
        assert np.isfinite(float(getattr(grads, k)))


def test_smoothed_digital_delta_close_to_closed_form():
    disc = float(np.exp(-R * T))
    _, grads = price_and_greeks(_gbm(), smoothed_digital(STRIKE, 0.8),
                                1 << 17, N_STEPS, seed=9, discount=disc)
    d2 = (np.log(S0 / STRIKE) + (R - 0.5 * SIGMA ** 2) * T) / (SIGMA
                                                               * np.sqrt(T))
    delta_cf = disc * norm.pdf(d2) / (S0 * SIGMA * np.sqrt(T))
    assert abs(float(grads.s0) - delta_cf) < 0.2 * delta_cf + 5e-4


def test_smoothed_payoffs_match_jax():
    """Within 4e-6 absolute: left of the strike the smoothed call is
    w (x Phi(x) + phi(x)) with x Phi(x) and phi(x) cancelling, each side's
    float32 erf leaving a few ULPs of w |x| (JAX's gives -2.2e-6 there,
    torch's 0)."""
    s = np.linspace(80.0, 130.0, 101).astype(np.float32)
    for port, jax_ in ((smoothed_call(STRIKE, 1.5), jg.smoothed_call(STRIKE,
                                                                     1.5)),
                       (smoothed_digital(STRIKE, 0.8),
                        jg.smoothed_digital(STRIKE, 0.8))):
        np.testing.assert_allclose(port(torch.from_numpy(s)).numpy(),
                                   np.asarray(jax_(jnp.asarray(s))),
                                   rtol=1e-6, atol=4e-6)


def test_black_scholes_oracles_match_jax():
    t = np.array([0.25, 1.0, 2.0])
    for port, jax_ in ((black_scholes_delta, jg.black_scholes_delta),
                       (black_scholes_vega, jg.black_scholes_vega)):
        got = port(S0, STRIKE, R, SIGMA, torch.tensor(t))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_(
            S0, STRIKE, R, SIGMA, jnp.asarray(t))), rtol=1e-12)


def test_pathwise_greeks_work_for_garch_bootstrap():
    """The integer leaf (n_table) gets a zero gradient; the float leaves
    theirs."""
    rets = np.random.default_rng(0).normal(0, 0.02, 300)
    proc = GARCHBootstrap.create(rets, s0=100.0, var0=4e-4, device="cpu")
    price, grads = price_and_greeks(
        proc, lambda s: torch.clamp(s - 100.0, min=0.0), 1 << 12, 16, seed=1)
    assert np.isfinite(float(price))
    assert 0.3 < float(grads.s0) < 1.0
    assert float(grads.n_table) == 0.0
    assert grads.table.shape == proc.table.shape
    assert torch.isfinite(grads.table).all()


# --- likelihood ratio and second order -------------------------------------

def test_lr_greeks_match_jax_and_the_torch_loop():
    """LR greeks of a digital against JAX's; their terminal prices come
    from K2's plain version, bitwise the torch loop's."""
    proc = _gbm()
    digital = lambda s: (s > STRIKE).to(torch.float32)
    disc = float(np.exp(-R * T))
    out = lr_greeks_gbm(proc, digital, 1 << 14, N_STEPS, seed=9,
                        discount=disc)
    jout = jg.lr_greeks_gbm(JGBM.create(S0, R, SIGMA, 1 / 252, dtype=F32),
                            lambda s: (s > STRIKE).astype(F32), 1 << 14,
                            N_STEPS, seed=9, discount=disc, dtype=F32)
    assert set(out) == set(jout)
    for k in ("price", "delta", "delta_std_err", "vega_std_err"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-3,
                                   err_msg=k)
    assert abs(float(out["vega"]) - float(jout["vega"])) < \
        1e-3 * float(out["vega_std_err"])
    assert torch.equal(terminal_prices(proc, 4096, 16, seed=9),
                       simulate(proc, 4096, 16, seed=9))


def test_lr_greeks_digital_call_closed_form():
    """tests/test_greeks.py's gate on the port."""
    n = 1 << 18
    disc = float(np.exp(-R * T))
    out = lr_greeks_gbm(_gbm(), lambda s: (s > STRIKE).to(torch.float32), n,
                        N_STEPS, seed=9, discount=disc)
    sqt = np.sqrt(T)
    d2 = (np.log(S0 / STRIKE) + (R - 0.5 * SIGMA ** 2) * T) / (SIGMA * sqt)
    assert abs(float(out["price"]) - disc * norm.cdf(d2)) < 0.01
    delta_cf = disc * norm.pdf(d2) / (S0 * SIGMA * sqt)
    assert abs(float(out["delta"]) - delta_cf) < \
        4 * float(out["delta_std_err"]) + 1e-4

    def digital(sig):
        d = (np.log(S0 / STRIKE) + (R - 0.5 * sig ** 2) * T) / (sig * sqt)
        return disc * norm.cdf(d)

    vega_cf = (digital(SIGMA + 1e-4) - digital(SIGMA - 1e-4)) / 2e-4
    assert abs(float(out["vega"]) - vega_cf) < \
        4 * float(out["vega_std_err"]) + 1e-3


def test_second_order_greeks_match_jax_and_black_scholes():
    dt = T / N_STEPS
    proc = GBM.create(S0, R, SIGMA, dt, device="cpu")
    disc = float(np.exp(-R * T))
    price, grad, hess = second_order_greeks(
        proc, smoothed_call(STRIKE, 1.5), 1 << 15, N_STEPS, seed=11,
        discount=disc)
    jprice, jgrad, jhess = jg.second_order_greeks(
        JGBM.create(S0, R, SIGMA, dt, dtype=F32),
        jg.smoothed_call(STRIKE, 1.5), 1 << 15, N_STEPS, seed=11,
        discount=disc, dtype=F32)
    np.testing.assert_allclose(float(price), float(jprice), rtol=1e-3)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-3)
    np.testing.assert_allclose(float(hess[0, 0]), float(jhess[0, 0]),
                               rtol=1e-3)
    for i, j in ((0, 1), (1, 0), (1, 1)):
        assert abs(float(hess[i, j]) - float(jhess[i, j])) < (
            5e-3 * abs(float(jhess[i, j])) + 0.05), (i, j)
    assert abs(float(hess[0, 1]) - float(hess[1, 0])) <= \
        1e-4 * abs(float(hess[0, 1]))
    # tests/test_greeks.py's bounds (gamma within 15% of Black-Scholes).
    sqt = np.sqrt(T)
    d1 = (np.log(S0 / STRIKE) + (R + SIGMA ** 2 / 2) * T) / (SIGMA * sqt)
    assert abs(float(hess[0, 0]) - norm.pdf(d1) / (S0 * SIGMA * sqt)) < \
        0.15 * norm.pdf(d1) / (S0 * SIGMA * sqt)
    assert abs(float(grad[0]) - float(black_scholes_delta(
        S0, STRIKE, R, SIGMA, T))) < 0.02


def test_second_order_bumps_leave_the_process_untouched():
    """The bumps make a new process (``dataclasses.replace``): the given
    process's tensors keep their values and versions and get no graph."""
    proc = Heston.create(**HESTON, device="cpu")
    before = {f.name: (getattr(proc, f.name).clone(),
                       getattr(proc, f.name)._version)
              for f in dataclasses.fields(proc)}
    second_order_greeks(proc, smoothed_call(STRIKE, 2.0), 1 << 10, 8,
                        seed=1, fields=("s0", "v0"))
    price_and_greeks(proc, _call, 1 << 10, 8, seed=1)
    for f in dataclasses.fields(proc):
        v = getattr(proc, f.name)
        assert torch.equal(v, before[f.name][0]), f.name
        assert v._version == before[f.name][1], f.name
        assert not v.requires_grad and v.grad is None, f.name


# --- the command -------------------------------------------------------------

def _run(capsys, mod, argv):
    rc = mod.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    [],
    ["--process", "heston"],
    ["--method", "lr", "--payoff", "digital"],
    ["--method", "second-order", "--process", "heston"],
])
def test_cli_greeks_matches_jax(capsys, argv):
    """The same keys as the JAX command; values within the tolerances
    above (JAX's command runs its float32 processes)."""
    base = ["greeks", "--paths", "4096", "--steps", "16"] + argv
    rc, got = _run(capsys, cli, base + ["--device", "cpu"])
    jrc, want = _run(capsys, jcli, base)
    assert rc == jrc == 0
    assert set(got) == set(want)
    for k, v in got.items():
        tol = (5e-3 * abs(want[k]) + 0.05 if k in ("vanna", "volga")
               else 1e-3 * float(got.get("vega_std_err", 0)) if k == "vega"
               else None)
        if tol is None:
            np.testing.assert_allclose(v, want[k], rtol=1e-3, atol=1e-6,
                                       err_msg=k)
        else:
            assert abs(v - want[k]) <= tol, (k, v, want[k])


@pytest.mark.parametrize("argv", [
    ["--payoff", "put", "--s0", "36", "--strike", "40", "--rate", "0.06"],
    [],
    ["--process", "heston", "--payoff", "put", "--strike", "100"],
])
def test_cli_greeks_american_matches_jax(capsys, argv):
    """``greeks --american``: the JAX command's keys (price, delta and vega
    and drift_sens on GBM, vega_v0 and xi_sens on Heston) within rtol
    1e-4."""
    base = ["greeks", "--american", "--paths", "4096", "--steps", "16"] + argv
    rc, got = _run(capsys, cli, base + ["--device", "cpu"])
    jrc, want = _run(capsys, jcli, base)
    assert rc == jrc == 0
    assert list(got) == list(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, err_msg=k)
    put = "put" in argv
    assert (got["delta"] < 0) == put and got["price"] > 0


def test_cli_greeks_mesh_and_refusals(capsys):
    """``--mesh 1`` on the one-rank mesh (paths rounded up to the block),
    and JAX's refusals: --mesh with another method or --american, LR on
    Heston, second order on a put; --american with another method or a
    digital."""
    rc, out = _run(capsys, cli, ["greeks", "--mesh", "1", "--paths", "5000",
                                 "--steps", "16", "--device", "cpu"])
    assert rc == 0 and out["mesh"] == 1 and out["n_paths"] == 8192
    assert 0.0 < out["d_s0"] < 1.0 and out["d_s0_std_err"] > 0.0
    assert out["d_sigma"] > 0.0
    for argv in (["--mesh", "2", "--method", "lr"],
                 ["--mesh", "2", "--american"]):
        with pytest.raises(SystemExit, match="pathwise"):
            cli.main(["greeks", *argv, "--device", "cpu"])
    with pytest.raises(SystemExit, match="only 1 rank"):
        cli.main(["greeks", "--mesh", "2", "--device", "cpu"])
    for argv in (["--method", "lr"], ["--payoff", "digital"]):
        with pytest.raises(SystemExit, match="pathwise method on call/put"):
            cli.main(["greeks", "--american", *argv, "--device", "cpu"])
    assert cli.main(["greeks", "--method", "lr", "--process", "heston",
                     "--device", "cpu"]) == 2
    assert cli.main(["greeks", "--method", "second-order", "--payoff", "put",
                     "--device", "cpu"]) == 2
    assert "GBM only" in capsys.readouterr().err


# --- the kernel routes refuse a leaf that requires grad ---------------------

def _grad_gbm():
    proc = _gbm()
    return dataclasses.replace(proc, sigma=proc.sigma.clone()
                               .requires_grad_(True))


@pytest.mark.parametrize("route", [
    "terminal_prices", "functional_run", "payoff_block_moments",
    "fused_terminal", "fused_block_moments", "fused_functionals",
    "gbm_terminal", "packed_basket_terminal"])
def test_kernel_routes_refuse_a_leaf_that_requires_grad(route):
    """Every kernel route raises TypeError on the CPU as on the card,
    before anything runs, naming the torch loop and price_and_greeks; the
    same calls run under torch.no_grad(), and the torch loop carries the
    gradient."""
    proc = _grad_gbm()
    call = VanillaPayoff("call", STRIKE)
    runs = {
        "terminal_prices": lambda p: terminal_prices(p, 4096, 4, seed=1),
        "functional_run": lambda p: functional_run(
            p, 4096, 4, seed=1, functionals={"avg": ARITH_MEAN}),
        "payoff_block_moments": lambda p: payoff_block_moments(
            p, call, 4096, 4, seed=1),
        "fused_terminal": lambda p: fused_terminal(p, 4096, 4, seed=1),
        "fused_block_moments": lambda p: fused_block_moments(
            p, call, 4096, 4, seed=1),
        "fused_functionals": lambda p: fused_functionals(
            p, 4096, 4, seed=1, functionals={"avg": ARITH_MEAN}),
        "gbm_terminal": lambda p: gbm_terminal(p, 4096, 4, seed=1),
        "packed_basket_terminal": lambda p: packed_basket_terminal(
            p, 4096, 4, seed=1),
    }
    if route == "packed_basket_terminal":
        basket = BasketGBM.create(s0=[100.0, 90.0], mu=[R, R],
                                  sigma=[0.2, 0.3],
                                  corr=[[1.0, 0.3], [0.3, 1.0]],
                                  weights=[0.5, 0.5], dt=1 / 252,
                                  device="cpu")
        proc = dataclasses.replace(
            basket, sigma=basket.sigma.clone().requires_grad_(True))
    with pytest.raises(TypeError, match="price_and_greeks"):
        runs[route](proc)
    with torch.no_grad():
        runs[route](proc)
    if route == "terminal_prices":
        t = simulate(proc, 64, 4, seed=1)
        (g,) = torch.autograd.grad(t.sum(), proc.sigma)
        assert float(g) != 0.0


def test_garch_fit_still_runs():
    """processes/garch_fit.py sets requires_grad on its own parameters,
    never on a process: it fits as before."""
    from montecarlo_tpu_torch.processes.garch_fit import fit_garch

    rets = np.random.default_rng(1).normal(0, 0.01, 400)
    params = fit_garch(rets, n_iters=20, device="cpu")
    assert all(np.isfinite(float(v)) for v in params)
