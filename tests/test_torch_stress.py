"""Stress and scenario grids in the port (``montecarlo_tpu_torch/api/
stress.py`` and the ``stress`` command) against the JAX package's on the
CPU, and tests/test_stress.py's contracts on the port.

Tolerances, and why: a scenario is a bumped process (the same float
operations on the leaves as JAX's ``leaf * (1 + bump)``) priced on the
same draws.  In float64 (float64 leaves and draws, the torch loop on both
sides) the prices agree within RTOL64 = 1e-9: each platform's float64 log,
sin and cos in Box-Muller, the mean summed in each library's order.  In
float32 the port's scenarios run K2's plain version, whose terminal prices
agree with JAX's scan within 2e-6 per path (tests/test_torch_heston.py),
and the float32 means sum in each library's order: RTOL32 = 2e-6
(measured below 2e-7).  The command's JSON rounds prices and P&L to 6
decimals, so it is held at RTOL32 plus 2e-6 absolute.  Inside the port,
the kernel route (K2's plain version here) is bitwise the torch loop, and
the base scenario's P&L is exactly 0 on every route.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.api import stress as js
from montecarlo_tpu.cli import main as jax_main
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu_torch.api import stress as ts
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.engine import black_scholes_call, kernel_route
from montecarlo_tpu_torch.processes import GBM, Heston

torch.set_num_threads(1)

S0, R, SIGMA, STRIKE, T, N_STEPS = 100.0, 0.03, 0.2, 105.0, 1.0, 16
N = 4096
DISC = float(np.exp(-R * T))
RTOL64, RTOL32 = 1e-9, 2e-6
HESTON = dict(s0=S0, v0=0.04, mu=R, kappa=2.0, theta=0.04, xi=0.5,
              rho=-0.7, dt=T / N_STEPS)
BA, BB = js.ladder(-0.2, 0.2, 5), js.ladder(-0.5, 0.5, 5)


def _gbm(dtype):
    vals = dict(s0=S0, mu=R, sigma=SIGMA, dt=T / N_STEPS)
    if dtype == jnp.float64:
        return (JGBM.create(**vals, dtype=jnp.float64),
                GBM(**{k: torch.tensor(v, dtype=torch.float64)
                       for k, v in vals.items()}))
    return JGBM.create(**vals), GBM.create(**vals, device="cpu")


def _heston():
    return JHeston.create(**HESTON), Heston.create(**HESTON, device="cpu")


def _calls():
    return (lambda s: jnp.maximum(s - STRIKE, 0.0),
            lambda s: torch.clamp(s - STRIKE, min=0.0))


@pytest.mark.parametrize("case", ["gbm64", "gbm32", "heston32"])
def test_grid_and_report_match_jax(case):
    if case == "heston32":
        (jp, tp), fields = _heston(), ("s0", "v0")
    else:
        (jp, tp), fields = _gbm(jnp.float64 if case == "gbm64"
                                else jnp.float32), ("s0", "sigma")
    dtype = jnp.float64 if case == "gbm64" else jnp.float32
    tdtype = torch.float64 if case == "gbm64" else torch.float32
    rtol = RTOL64 if case == "gbm64" else RTOL32
    jpay, tpay = _calls()
    kw = dict(seed=3, fields=fields, discount=DISC)
    want = js.stress_grid(jp, jpay, N, N_STEPS, bumps_a=BA, bumps_b=BB,
                          dtype=dtype, **kw)
    got = ts.stress_grid(tp, tpay, N, N_STEPS, bumps_a=BA, bumps_b=BB,
                         dtype=tdtype, **kw)
    assert got["prices"].shape == (5, 5)
    assert got["prices"].dtype == np.asarray(want["prices"]).dtype
    np.testing.assert_allclose(got["prices"], want["prices"], rtol=rtol)
    np.testing.assert_array_equal(got["bumps_a"], want["bumps_a"])
    assert got["pnl"][2, 2] == 0.0 and got["base_price"] == \
        got["prices"][2, 2]
    want = js.stress_report(jp, jpay, N, N_STEPS, dtype=dtype, **kw)
    got = ts.stress_report(tp, tpay, N, N_STEPS, dtype=tdtype, **kw)
    assert list(got["scenarios"]) == list(want["scenarios"])
    assert got["scenarios"]["base"]["pnl"] == 0.0
    for name, row in want["scenarios"].items():
        assert got["scenarios"][name]["price"] == pytest.approx(
            row["price"], rel=rtol), name
    assert ts.stress_report(tp, tpay, N, N_STEPS, scenarios={},
                            **kw)["scenarios"] == {}


@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_kernel_route_is_bitwise_the_torch_loop(kind):
    """A float32 GBM or Heston grid takes K2 (its plain version on the
    CPU), bitwise the grid through the torch loop; the bumps leave the
    process untouched and build new ones."""
    if kind == "gbm":
        (_, tp), fields = _gbm(jnp.float32), ("s0", "sigma")
    else:
        (_, tp), fields = _heston(), ("s0", "v0")
    before = {f.name: getattr(tp, f.name).clone()
              for f in dataclasses.fields(tp)}
    _, tpay = _calls()
    assert kernel_route(tp, None, N_STEPS)
    kw = dict(bumps_a=BA, bumps_b=BB, seed=4, fields=fields, discount=DISC)
    fused = ts.stress_grid(tp, tpay, N, N_STEPS, **kw)
    loop = ts.stress_grid(tp, tpay, N, N_STEPS, prefer_fused=False, **kw)
    np.testing.assert_array_equal(fused["prices"], loop["prices"])
    for name, v in before.items():
        assert torch.equal(getattr(tp, name), v), name
    bumped = ts._bumped(tp, fields, 0.1, -0.3, torch.float32)
    assert bumped is not tp
    assert torch.equal(getattr(bumped, fields[0]), getattr(tp, fields[0])
                       * (1.0 + torch.tensor(0.1)))


def test_contracts_on_the_port():
    """tests/test_stress.py in float64: each GBM scenario within 0.25 of
    Black-Scholes at its bumped (s0, sigma) (2^15 paths), the grid
    increasing in spot and vol, and the named scenarios' signs."""
    tp = GBM(**{k: torch.tensor(v, dtype=torch.float64) for k, v in
                dict(s0=S0, mu=R, sigma=SIGMA, dt=T / 32).items()})
    _, tpay = _calls()
    kw = dict(seed=3, discount=DISC, dtype=torch.float64)
    g = ts.stress_grid(tp, tpay, 1 << 15, 32, bumps_a=BA, bumps_b=BB, **kw)
    p = g["prices"]
    for i, a in enumerate(BA):
        for j, b in enumerate(BB):
            bs = float(black_scholes_call(S0 * (1 + a), STRIKE, R,
                                          SIGMA * (1 + b), T))
            assert abs(p[i, j] - bs) < 0.25, (a, b, p[i, j], bs)
    assert (np.diff(p, axis=0) > 0).all() and (np.diff(p, axis=1) > 0).all()
    rep = ts.stress_report(tp, tpay, 1 << 12, 32, **kw)["scenarios"]
    assert set(rep) == set(ts.standard_scenarios())
    assert rep["spot_down_20"]["pnl"] < 0 < rep["spot_up_20"]["pnl"]
    assert rep["vol_up_50"]["pnl"] > 0 > rep["vol_down_30"]["pnl"]
    assert rep["melt_up"]["pnl"] > 0
    g = ts.ladder(-0.15, 0.15, 4)
    np.testing.assert_array_equal(g, js.ladder(-0.15, 0.15, 4))
    assert (g == 0.0).any()


def _cli(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--process", "gbm"],
    ["--process", "heston", "--payoff", "put", "--grid", "3"],
    ["--process", "gbm", "--grid", "0", "--seed", "5"],
])
def test_stress_command_matches_jax_cli(flags, capsys):
    argv = ["stress", "--paths", "4096", "--steps", "16", *flags]
    want = _cli(jax_main, argv, capsys)
    got = _cli(port_main, [*argv, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    assert list(got["scenarios"]) == list(want["scenarios"])
    for name, row in want["scenarios"].items():
        for k in ("price", "pnl"):
            assert got["scenarios"][name][k] == pytest.approx(
                row[k], rel=RTOL32, abs=2e-6), (name, k)
    assert got["scenarios"]["base"]["pnl"] == 0.0
    if "grid" in want:
        for k in ("spot_bumps", "vol_bumps"):
            assert got["grid"][k] == want["grid"][k]
        for k in ("prices", "pnl"):
            np.testing.assert_allclose(got["grid"][k], want["grid"][k],
                                       rtol=RTOL32, atol=2e-6)
    else:
        assert "grid" not in got


def test_stress_command_needs_a_card_unless_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["stress", "--paths", "128"])
    assert capsys.readouterr().out == ""
