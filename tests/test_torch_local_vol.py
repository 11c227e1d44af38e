"""Local volatility in the port (processes/dupire.py, processes/local_vol.py,
``LocalVolProc``'s knot-grid reads in csrc/surface.cuh, ``price --process
cev``) against the JAX package.

Tolerances, and why:

- The Dupire grid and ``vol_fn`` are the same float64 NumPy operations on
  both sides: bitwise.  ``LocalVolGBM.create`` samples them in float64 and
  rounds each leaf to float32 once, as JAX does: bitwise, and so is every
  surface row ``_row(t)`` (the same float32 hat-weight sum, from 0 in knot
  order; XLA:CPU contracts none of it here).
- ``csrc/surface.cuh`` built for the host with g++ (-ffp-contract=off, as
  the card's -fmad=false) against the torch plain versions: bitwise, the
  two-knot blend included against the full sum over every knot.
- Paths: the Box-Muller normals differ by each platform's log/sin/cos
  (<= 4.8e-7) and XLA:CPU may contract a step's a*b + c into an FMA:
  terminal prices and K4's functionals within rtol 2e-6 (measured 1.0e-6
  at 4096 x 17), K3's moments within 1e-5 (each framework's summation
  order).
- The CLI: the same estimate to float32 round-off: tests/
  torch_process_pairs.py's rtol 1e-5 (measured bitwise for the CEV call),
  a Sobol run's std-err with an absolute floor of 1e-5 of the price (the
  spread of nearly equal replicate means; tests/test_torch_qmc.py's rule).
- CEV against the noncentral chi-square closed form: 5 std-err + 0.05, the
  JAX test's gate (Euler bias on top of the Monte Carlo error).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cli import main as jax_main
from montecarlo_tpu.processes import LocalVolGBM as JLocalVol
from montecarlo_tpu.processes import dupire as jdupire
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import kernel_route, simulate
from montecarlo_tpu_torch.processes import LocalVolGBM, dupire
from montecarlo_tpu_torch.processes.local_vol import (blend_rows,
                                                      interp_row, knot_index)
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            SobolDeviceSampler)
from tests.torch_process_pairs import hold_cli, hold_kernel_paths, run_cli

torch.set_num_threads(1)

S0, R = 100.0, 0.03
CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"
STRIKES = np.linspace(70.0, 140.0, 15)
MATS = np.array([0.25, 0.5, 1.0, 1.5, 2.0])


def _ivs():
    """A skewed, term-dependent implied-vol surface (T, K)."""
    y = np.log(STRIKES / S0)
    return np.stack([0.2 - 0.12 * y + 0.02 * T + 0.3 * y * y / (1 + T)
                     for T in MATS])


#: Surfaces as vol_fn(t, spots), with their (n_steps, dt, x range).
SURFACES = {
    "cev": (lambda t, s: np.clip(0.2 * (s / S0) ** (0.7 - 1.0), 1e-4, 4.0),
            (252, 1.0 / 252, (-1.5, 1.5))),
    "tdep": (lambda t, s: 0.2 + 0.1 * np.tanh(np.log(s / S0)) + 0.05 * t,
             (17, 1.0 / 32, (-1.5, 1.5))),
    "dupire": (jdupire.local_vol_fn_from_ivs(STRIKES, MATS, _ivs(), s0=S0,
                                             rate=R),
               (64, 2.0 / 64, (-0.9, 0.9))),
}


def _pair(kind, n_steps=None):
    """JAX's LocalVolGBM on surface ``kind`` and the port's, built from the
    same leaves."""
    fn, (steps, dt, (lo, hi)) = SURFACES[kind]
    jp = JLocalVol.create(S0, R, dt, n_steps or steps, fn, x_min=lo,
                          x_max=hi)
    return jp, process_from_numpy(
        "local-vol", {k: np.asarray(v) for k, v in jp._asdict().items()},
        device="cpu")


# --- the Dupire surface ---------------------------------------------------------

def test_dupire_grid_and_vol_fn_are_jaxs():
    want = jdupire.dupire_local_vol_grid(STRIKES, MATS, _ivs(), s0=S0,
                                         rate=R)
    got = dupire.dupire_local_vol_grid(STRIKES, MATS, _ivs(), s0=S0, rate=R)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    spots = S0 * np.exp(np.linspace(-1.5, 1.5, 301))
    jfn = jdupire.local_vol_fn_from_ivs(STRIKES, MATS, _ivs(), s0=S0, rate=R)
    tfn = dupire.local_vol_fn_from_ivs(STRIKES, MATS, _ivs(), s0=S0, rate=R)
    for t in (0.0, 0.1, 0.25, 0.7, 1.5, 2.0, 3.0):
        np.testing.assert_array_equal(tfn(t, spots), jfn(t, spots))
    with pytest.raises(ValueError, match="2 maturity"):
        dupire.dupire_local_vol_grid(STRIKES, MATS[:1], _ivs()[:1], s0=S0,
                                     rate=R)


# --- the surface and its rows ---------------------------------------------------

@pytest.mark.parametrize("kind", list(SURFACES))
def test_create_and_rows_are_bitwise_jaxs(kind):
    fn, (steps, dt, (lo, hi)) = SURFACES[kind]
    jp = JLocalVol.create(S0, R, dt, steps, fn, x_min=lo, x_max=hi)
    tp = LocalVolGBM.create(S0, R, dt, steps, fn, x_min=lo, x_max=hi,
                            device="cpu")
    for k, v in jp._asdict().items():
        got = getattr(tp, k)
        assert got.dtype == torch.float32, k
        np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)
    assert tp.n_time_knots == jp.n_time_knots
    for t in range(steps + 3):
        np.testing.assert_array_equal(tp._row(t).numpy(),
                                      np.asarray(jp._row(t, jnp.float32)),
                                      err_msg=f"row {t}")
    rows = blend_rows(tp.vol_flat.reshape(-1, 128), list(range(steps)),
                      tp.dt, tp.dt_knot)
    assert all(torch.equal(rows[t], tp._row(t)) for t in range(steps))


def test_local_vol_is_jaxs_at_every_knot_and_beyond():
    jp, tp = _pair("dupire")
    x = torch.linspace(-1.2, 1.2, 4097) + 0.01
    log_s = (torch.log(torch.tensor(S0)) + x).to(torch.float32)
    for t in (0, 5, 31, 64, 90):
        want = np.asarray(jp.local_vol(jnp.asarray(log_s.numpy()), t))
        np.testing.assert_array_equal(tp.local_vol(log_s, t).numpy(), want)


def test_create_guards():
    with pytest.raises(ValueError, match="positive and finite"):
        LocalVolGBM.create(S0, R, 0.01, 8, lambda t, s: np.zeros_like(s),
                           device="cpu")
    with pytest.raises(ValueError, match="128 vols"):
        LocalVolGBM.create(S0, R, 0.01, 8, lambda t, s: np.ones(3),
                           device="cpu")
    with pytest.raises(ValueError, match="2 time knots"):
        LocalVolGBM.create(S0, R, 0.01, 8, lambda t, s: np.ones_like(s),
                           n_time_knots=1, device="cpu")


# --- csrc/surface.cuh on the host -------------------------------------------------

_SHIM = r"""
#include "surface.cuh"
extern "C" {
void host_knot_index(const float* u, int* i, float* frac, long n) {
  for (long k = 0; k < n; ++k) i[k] = mc::knot_index(u[k], &frac[k]);
}
void host_interp_row(const float* row, const float* x, float x0, float dx,
                     float* y, long n) {
  for (long k = 0; k < n; ++k) y[k] = mc::interp_row(row, x[k], x0, dx);
}
void host_blend_row(const float* table, int n_tk, int t, float dt,
                    float dt_knot, float* row) {
  const float u = mc::knot_time(t, dt, dt_knot, n_tk);
  for (int k = 0; k < mc::kKnots; ++k)
    row[k] = mc::blend_lane(table, n_tk, u, k);
}
void host_interp_blend(const float* table, int n_tk, int t, float dt,
                       float dt_knot, const float* x, float x0, float dx,
                       float* y, long n) {
  const float u = mc::knot_time(t, dt, dt_knot, n_tk);
  for (long k = 0; k < n; ++k)
    y[k] = mc::interp_blend(table, n_tk, u, x[k], x0, dx);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build surface.cuh for the host")
    d = tmp_path_factory.mktemp("surface_header")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f(v):
    return ctypes.c_float(float(v))


def test_header_knot_index_matches_torch(lib):
    rng = np.random.default_rng(3)
    u = np.concatenate([rng.uniform(-20, 150, 1 << 14),
                        [-1e30, -1.0, -0.0, 0.0, 0.5, 125.99999, 126.0,
                         126.5, 127.0, 128.0, 1e30, np.inf, -np.inf,
                         np.nan]]).astype(np.float32)
    i = np.empty(u.size, np.int32)
    frac = np.empty_like(u)
    lib.host_knot_index(_ptr(u), _ptr(i), _ptr(frac), ctypes.c_long(u.size))
    ti, tfrac = knot_index(torch.from_numpy(u))
    np.testing.assert_array_equal(i, ti.numpy())
    finite = np.isfinite(u)
    np.testing.assert_array_equal(frac[finite], tfrac.numpy()[finite])
    assert ((i >= 0) & (i <= 126)).all()


@pytest.mark.parametrize("kind", list(SURFACES))
def test_header_reads_match_torch(lib, kind):
    """interp_row on every row, the two-knot blend against the full sum at
    every step and a few past the horizon, and the blended read at 2^14
    log-moneyness points inside and outside the grid: bitwise."""
    _, tp = _pair(kind)
    table = tp.vol_flat.numpy()
    n_tk = tp.n_time_knots
    dt, dt_knot = tp.dt.item(), tp.dt_knot.item()
    x0, dx = tp.x0.item(), tp.dx.item()
    rng = np.random.default_rng(4)
    x = rng.uniform(-2.5, 2.5, 1 << 14).astype(np.float32)
    y = np.empty_like(x)
    n = ctypes.c_long(x.size)
    tx = torch.from_numpy(x)
    for j in range(n_tk):
        row = np.ascontiguousarray(table[j * 128:(j + 1) * 128])
        lib.host_interp_row(_ptr(row), _ptr(x), _f(x0), _f(dx), _ptr(y), n)
        want = interp_row(torch.from_numpy(row), tx, tp.x0, tp.dx)
        np.testing.assert_array_equal(y, want.numpy())
    steps = SURFACES[kind][1][0]
    blended = np.empty(128, np.float32)
    for t in list(range(0, steps + 1, max(steps // 40, 1))) + [steps + 7]:
        lib.host_blend_row(_ptr(table), n_tk, t, _f(dt), _f(dt_knot),
                           _ptr(blended))
        np.testing.assert_array_equal(blended, tp._row(t).numpy())
        lib.host_interp_blend(_ptr(table), n_tk, t, _f(dt), _f(dt_knot),
                              _ptr(x), _f(x0), _f(dx), _ptr(y), n)
        want = interp_row(tp._row(t), tx, tp.x0, tp.dx)
        np.testing.assert_array_equal(y, want.numpy())


# --- paths, kernels' plain versions, the oracle -----------------------------------

@pytest.mark.parametrize("n_steps", [9, 17])
@pytest.mark.parametrize("kind", ["cev", "tdep", "dupire"])
def test_kernel_paths_match_jax(kind, n_steps):
    jp, tp = _pair(kind, n_steps)
    hold_kernel_paths(jp, tp, n_steps, rtol=2e-6)


def test_flat_surface_is_gbm():
    """sigma = 0.2 everywhere gives GBM's paths (the same draws; the step
    algebra equal to GBM's up to the order of sigma^2 dt / 2)."""
    from montecarlo_tpu_torch.processes import GBM

    lv = LocalVolGBM.create(S0, R, 1 / 64, 32,
                            lambda t, s: np.full_like(s, 0.2), device="cpu")
    gbm = GBM.create(s0=S0, mu=R, sigma=0.2, dt=1 / 64, device="cpu")
    np.testing.assert_allclose(simulate(lv, 8192, 32, seed=3).numpy(),
                               simulate(gbm, 8192, 32, seed=3).numpy(),
                               rtol=3e-6)


def test_cev_matches_the_noncentral_chi2_closed_form():
    """tests/test_local_vol.py's CEV oracle on the port's CPU path."""
    from scipy.stats import ncx2

    beta, sigma0, T, steps = 0.6, 0.25, 0.5, 64
    lv = LocalVolGBM.create(S0, R, T / steps, steps,
                            lambda t, s: sigma0 * (s / S0) ** (beta - 1.0),
                            x_min=-2.0, x_max=2.0, device="cpu")
    n = 1 << 17
    term = simulate(lv, n, steps, seed=11).double().numpy()
    delta = sigma0 * S0 ** (1 - beta)
    v = (delta ** 2 / (2 * R * (beta - 1))
         * (np.exp(2 * R * (beta - 1) * T) - 1))
    disc = np.exp(-R * T)
    for strike in (90.0, 100.0, 110.0):
        a = ((strike * disc) ** (2 * (1 - beta)) / ((1 - beta) ** 2 * v))
        b = 1 / (1 - beta)
        c = S0 ** (2 * (1 - beta)) / ((1 - beta) ** 2 * v)
        exact = (S0 * (1 - ncx2.cdf(a, b + 2, c))
                 - strike * disc * ncx2.cdf(c, b, a))
        pay = np.maximum(term - strike, 0.0)
        price, se = disc * pay.mean(), disc * pay.std(ddof=1) / np.sqrt(n)
        assert abs(price - exact) < 5 * se + 0.05, (strike, price, exact)


# --- the CLI and the route ---------------------------------------------------------

@pytest.mark.parametrize("flags", [
    [],
    ["--sampler", "antithetic", "--payoff", "put"],
    ["--payoff", "asian"],
    ["--payoff", "up-and-out", "--barrier", "130"],
    ["--sampler", "sobol-bridge"],
    ["--sampler", "sobol-device", "--payoff", "lookback"],
    ["--target-se", "0.1"],
])
def test_price_cev_matches_jax_cli(flags, capsys):
    argv = ["price", "--process", "cev", "--paths", "16384", "--steps", "16",
            "--seed", "4", "--beta", "0.6", *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    hold_cli(got, want, rqmc="--sampler" in flags and "sobol" in flags[1])


def test_route_takes_local_vol_under_every_sampler():
    _, tp = _pair("cev", 16)
    assert kernel_route(tp, None, 16)
    assert kernel_route(tp, SobolDeviceSampler.create(16, 1, device="cpu"),
                        16)
    assert kernel_route(tp, SobolBridgeKernelSampler.create(16, device="cpu"),
                        16)
