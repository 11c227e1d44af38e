"""HestonQE, BatesQE, variance gamma (with the gamma-table inversion) and
SABR in the port against the JAX package: draws, paths from the torch loop
and from K2/K3/K4's plain versions against JAX's scan and one
``fused_terminal_pallas(..., interpret=True)`` run (16384 paths x 17
steps), the residual quantile table, ``expneg_wide32`` and
``gamma_from_uniforms_table32`` in torch and in ``csrc/rng.cuh`` (built for
the host with g++), the CF oracles, ``price --process
heston-qe|bates-qe|vg|sabr`` against the JAX CLI, and the samplers each
process takes.

Tolerances are tests/torch_process_pairs.py's (uniforms bitwise, normals
within 4.8e-7, terminal prices within rtol 1e-5 per path with at most 0.1%
of the paths off by a discrete flip, means within rtol 1e-5, inside the
port bitwise), and:

- the float64 quantile table is numpy on both sides: bitwise;
- ``expneg_wide32`` is exact float32 mul/add: bitwise, in torch and through
  g++ (-ffp-contract=off, as the card's -fmad=false), down to the smallest
  normal float32 2^-126; below it XLA:CPU flushes results to zero where
  torch, g++ and the card keep subnormals;
- a gamma variate takes ``ndtri32`` and ``log32``, which call each
  platform's log, and its boost factor ``exp(log32(u) / a)`` turns a
  one-ULP difference of the exponent (|x| up to 88, an ULP up to 7.6e-6)
  into that relative difference: within GAMMA_RTOL = 2e-5 of JAX's and
  between torch and g++, an absolute 1e-37 where XLA:CPU flushes a
  subnormal result;
- SABR's ``F^beta`` is ``exp32(beta log32(F))`` in the port and
  ``jnp.power`` in JAX: within rtol 1e-6 for F in [1e-3, 1e4], and the
  same at F = 0;
- the CF oracles (float64 on both sides): rtol 1e-10.
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
from montecarlo_tpu.engine import cf_pricing as jcf
from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.ops.fused_engine import fused_terminal_pallas
from montecarlo_tpu.processes import bates_log_cf as jbates_cf
from montecarlo_tpu.rng import gamma as jgamma
from montecarlo_tpu.samplers import AntitheticSampler as JAntithetic
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN, RUNNING_MAX,
                                         cf_pricing, kernel_route, simulate,
                                         terminal_prices)
from montecarlo_tpu_torch.ops import (fused_functionals_reference,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.processes import (SABR, HestonQE, VarianceGamma,
                                            bates_log_cf)
from montecarlo_tpu_torch.processes.sabr import cev_power
from montecarlo_tpu_torch.rng import gamma as tgamma
from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from montecarlo_tpu_torch.samplers import AntitheticSampler
from tests.torch_process_pairs import (N_PATHS, N_STEPS, hold_cli,
                                       hold_draws, hold_paths, pair,
                                       run_cli)

torch.set_num_threads(1)

KINDS = ["heston-qe", "bates-qe", "vg", "sabr"]
WRAP = 2**32 - 5000
GAMMA_RTOL = 2e-5
CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"


def _kinds(tp):
    return getattr(tp, "draw_kinds", ("normal",) * tp.n_draws)


@pytest.mark.parametrize("kind", KINDS)
def test_draws_match_jax(kind):
    jp, tp = pair(kind)
    k0, k1 = key_from_seed(11, 2)
    ids = (torch.arange(2000, dtype=torch.int64) + 2**32 - 900) & 0xFFFFFFFF
    jids = jnp.asarray(ids.numpy().astype(np.uint32))
    for j in (0, 7):
        got = tp.draws_pair(k0, k1, ids, j)
        want = jp.draws_pair(11, 2, jids, j)
        for t in (0, 1):
            hold_draws(got[t], want[t], _kinds(tp))
            single = tp.draws(k0, k1, ids, 2 * j + t)
            assert all(torch.equal(a, b) for a, b in zip(single, got[t]))
        hold_draws(tp.antithetic(got[1]), jp.antithetic(want[1]),
                   _kinds(tp))


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_paths_match_jax(kind, antithetic):
    jp, tp = pair(kind)
    kw = dict(seed=3, path_offset=WRAP)
    got = fused_terminal_reference(tp, N_PATHS, N_STEPS,
                                   antithetic=antithetic, **kw)
    loop = simulate(tp, N_PATHS, N_STEPS,
                    sampler=AntitheticSampler() if antithetic else None,
                    **kw)
    assert torch.equal(got, loop)
    want = jsimulate(jp, N_PATHS, N_STEPS, dtype=jnp.float32,
                     sampler=JAntithetic() if antithetic else None, **kw)
    hold_paths(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_an_interpret_mode_kernel(kind):
    """K2's plain version against one interpret-mode fused_terminal_pallas
    run, K4's {avg, geo, mx} (log-space observations: SABR's log32 of the
    forward) against JAX's functional scan."""
    jp, tp = pair(kind)
    got = fused_terminal_reference(tp, N_PATHS, N_STEPS, seed=5)
    want = fused_terminal_pallas(jp, N_PATHS, N_STEPS, seed=5,
                                 block_rows=128, interpret=True)
    hold_paths(got, want, kind)
    fns = {"avg": ARITH_MEAN, "geo": GEO_MEAN, "mx": RUNNING_MAX}
    got_f = fused_functionals_reference(tp, N_PATHS, N_STEPS, seed=5,
                                        functionals=fns)
    want_f = jf._simulate_functionals(
        jp, N_PATHS, N_STEPS, 5, 0, None, jnp.float32, 0,
        (("avg", jf.ARITH_MEAN), ("geo", jf.GEO_MEAN),
         ("mx", jf.RUNNING_MAX)))
    for k in want_f:
        hold_paths(got_f[k], want_f[k], f"{kind} {k}")


# --- the gamma-table inversion (K0) ------------------------------------------

@pytest.mark.parametrize("b", [1.0 + 1.0 / 50.4, 1.3, 2.0])
def test_residual_table_is_jaxs(b):
    got = tgamma.gamma_icdf_resid_table64(b)
    want = jgamma.gamma_icdf_resid_table64(b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="multiple of 128"):
        tgamma.gamma_icdf_resid_table64(b, n=500)


def _gamma_inputs(n=1 << 15, seed=8):
    rng = np.random.default_rng(seed)
    u_w = np.concatenate([rng.uniform(0, 1, n), [1e-9, 6e-8, 0.5,
                                                  1 - 6e-8, 1 - 2**-24]])
    u_b = np.concatenate([rng.uniform(0, 1, n), [1e-9, 2**-24, 0.5,
                                                  0.999, 1 - 2**-24]])
    x = np.concatenate([rng.uniform(-95, 2, n), [-88, -87.3, -20, 0, 1]])
    return (u_w.astype(np.float32), u_b.astype(np.float32),
            x.astype(np.float32))


TINY = np.float32(2.0**-126)  # the smallest normal float32


def _equal_to_subnormals(got, want):
    """Bitwise where JAX's result is normal; below, both are subnormal."""
    normal = want >= TINY
    np.testing.assert_array_equal(got[normal], want[normal])
    assert (np.abs(got[~normal]) < TINY).all()


def test_gamma_functions_match_jax():
    """expneg_wide32 bitwise; the table-inverted Gamma(a) variate of the
    VG process's shape within GAMMA_RTOL of JAX's."""
    jp, tp = pair("vg", 252)
    u_w, u_b, x = _gamma_inputs()
    _equal_to_subnormals(
        tgamma.expneg_wide32(torch.from_numpy(x)).numpy(),
        np.asarray(jgamma.expneg_wide32(jnp.asarray(x))))
    a = tp.dt / tp.nu
    got = tgamma.gamma_from_uniforms_table32(
        a, torch.from_numpy(u_w), torch.from_numpy(u_b), tp.gq_z0,
        tp.gq_dz, tp.gq_resid, tp.gq_dresid).numpy()
    want = np.asarray(jgamma.gamma_from_uniforms_table32(
        (jp.dt / jp.nu).astype(jnp.float32), jnp.asarray(u_w),
        jnp.asarray(u_b), jp.gq_z0, jp.gq_dz, jp.gq_resid, jp.gq_dresid))
    assert np.isfinite(got).all() and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=GAMMA_RTOL, atol=1e-37)


_SHIM = r"""
#include "rng.cuh"
extern "C" {
void host_expneg(const float* x, float* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = mc::expneg_wide32(x[i]);
}
void host_gamma(float a, const float* uw, const float* ub, float z0,
                float dz, const float* r, const float* d, int nt, float* y,
                long n) {
  for (long i = 0; i < n; ++i)
    y[i] = mc::gamma_from_uniforms_table32(a, uw[i], ub[i], z0, dz, r, d,
                                           nt);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build rng.cuh for the host")
    d = tmp_path_factory.mktemp("gamma_header")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_header_gamma_functions_match_jax(lib):
    """The device text of expneg_wide32 (bitwise) and
    gamma_from_uniforms_table32 (within GAMMA_RTOL of JAX's and of the
    port's torch version) built for the host."""
    jp, tp = pair("vg", 252)
    u_w, u_b, x = _gamma_inputs(seed=9)
    n = ctypes.c_long(x.size)
    y = np.empty_like(x)
    lib.host_expneg(_ptr(x), _ptr(y), n)
    _equal_to_subnormals(
        y, np.asarray(jgamma.expneg_wide32(jnp.asarray(x))))
    a = np.float32(float(tp.dt / tp.nu))
    resid = tp.gq_resid.numpy()
    dresid = tp.gq_dresid.numpy()
    g = np.empty_like(u_w)
    lib.host_gamma(ctypes.c_float(a), _ptr(u_w), _ptr(u_b),
                   ctypes.c_float(float(tp.gq_z0)),
                   ctypes.c_float(float(tp.gq_dz)), _ptr(resid),
                   _ptr(dresid), ctypes.c_int(resid.size), _ptr(g), n)
    want = np.asarray(jgamma.gamma_from_uniforms_table32(
        jnp.float32(a), jnp.asarray(u_w), jnp.asarray(u_b), jp.gq_z0,
        jp.gq_dz, jp.gq_resid, jp.gq_dresid))
    np.testing.assert_allclose(g, want, rtol=GAMMA_RTOL, atol=1e-37)
    port = tgamma.gamma_from_uniforms_table32(
        torch.tensor(a), torch.from_numpy(u_w), torch.from_numpy(u_b),
        tp.gq_z0, tp.gq_dz, tp.gq_resid, tp.gq_dresid).numpy()
    np.testing.assert_allclose(g, port, rtol=GAMMA_RTOL, atol=1e-37)


# --- SABR's power, the oracles, the CLI --------------------------------------

def test_sabr_power_matches_jnp_power():
    f = np.concatenate([[0.0], np.geomspace(1e-3, 1e4, 4001)]).astype(
        np.float32)
    for beta in (0.0, 0.5, 0.7, 1.0):
        got = cev_power(torch.from_numpy(f), torch.tensor(np.float32(beta)))
        want = np.asarray(jnp.power(jnp.asarray(f), jnp.float32(beta)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_cf_oracles_match_jax():
    """VG's CF and Heston's (Bates's with lam = 0, the HestonQE oracle)
    against JAX's, float64, at several strikes."""
    vg = (100.0, 0.03, 0.2, -0.14, 0.2, 1.0)
    heston = (100.0, 0.03, 0.04, 2.0, 0.04, 0.5, -0.7, 0.0, -0.05, 0.1, 1.0)
    for strike in (80.0, 105.0, 130.0):
        for port_cf, jax_cf, args in (
                (cf_pricing.vg_log_cf, jcf.vg_log_cf, vg),
                (bates_log_cf, jbates_cf, heston)):
            got = cf_pricing.cf_call_price(port_cf(*args), 100.0, strike,
                                           1.0, 0.03)
            want = float(jcf.cf_call_price(jax_cf(*args), 100.0, strike,
                                           1.0, 0.03))
            assert got == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize("flags", [
    ["--process", "heston-qe"],
    ["--process", "bates-qe"],
    ["--process", "vg"],
    ["--process", "sabr"],
    ["--process", "vg", "--sampler", "antithetic", "--payoff", "digital"],
    ["--process", "sabr", "--sampler", "sobol-device"],
    ["--process", "heston-qe", "--payoff", "lookback"],
])
def test_price_cli_matches_jax(flags, capsys):
    argv = ["price", "--paths", "16384", "--steps", "16", "--seed", "4",
            *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    hold_cli(got, want)


def test_samplers_each_process_takes(capsys):
    """SABR (all normals) takes the device Sobol table on the kernels; the
    QE processes and VG are refused it by the CLI and by the engine."""
    _, sabr = pair("sabr", 16)
    smp = SobolDeviceSampler.create(16, 2, device="cpu")
    assert kernel_route(sabr, smp, 16)
    assert torch.isfinite(terminal_prices(sabr, 512, 16, seed=0,
                                          sampler=smp)).all()
    for kind in ("heston-qe", "bates-qe", "vg"):
        argv = ["price", "--process", kind, "--sampler", "sobol-device",
                "--steps", "16", "--device", "cpu"]
        with pytest.raises(SystemExit, match="non-normal uniforms"):
            port_main(argv)
        _, tp = pair(kind, 16)
        with pytest.raises(ValueError, match="non-normal"):
            terminal_prices(tp, 256, 16, seed=0,
                            sampler=SobolDeviceSampler.create(
                                16, tp.n_draws, device="cpu"))
    assert capsys.readouterr().out == ""


def test_create_guards():
    with pytest.raises(ValueError, match="xi"):
        HestonQE.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.0, -0.7, 0.01,
                        device="cpu")
    with pytest.raises(ValueError, match="dt <= nu"):
        VarianceGamma.create(100.0, 0.03, 0.2, -0.14, 0.2, 0.5,
                             device="cpu")
    for beta, want in ((0.0, 0.05), (0.7, 0.0)):  # 0^0 = 1, 0^0.7 = 0
        sabr = SABR.create(100.0, 0.5, beta, 0.3, 0.0, 0.01, device="cpu")
        state = sabr.init_state(torch.arange(4))
        stepped = sabr.step(state._replace(f=torch.zeros(4)),
                            (torch.ones(4), torch.zeros(4)), 0)
        assert torch.allclose(stepped.f, torch.full((4,), want))
