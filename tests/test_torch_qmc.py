"""Randomized QMC in the port against the JAX package: the dispatch's gate,
K2/K3/K4's plain versions under the device and bridge Sobol samplers, the
RQMC estimators, the ``price --sampler sobol*`` CLI and the mixed-slot host
table through ``portfolio_var_on_device``.

Inputs are made once with numpy and carried to both sides (processes
through ``convert.process_from_numpy(..., device="cpu")``).  JAX runs its
scan engine here (conftest turns on x64, which keeps it off the kernel) and
one ``fused_terminal_pallas(..., interpret=True)`` run per sampler; both
sides pin float32.  Tolerances and why:

- The Sobol words and uniforms are the same bits (tests/test_torch_sobol.
  py); the normals differ by each platform's log inside ``ndtri32``
  (<= 7.2e-7) and XLA may contract a step's a*b+c into an FMA: prices and
  path functionals within rtol 2e-6, the slices' price tolerance.
- Means and block moments sum in each framework's own order: rtol 1e-5;
  the replicate spread is a difference of nearly equal means, so std-errs
  get an absolute floor of 1e-5 of the price.
- Inside the port (kernel plain versions against the torch loop):
  bitwise.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.cli import main as jax_main
from montecarlo_tpu.engine import price_to_tolerance_rqmc as jptt_rqmc
from montecarlo_tpu.engine import rqmc_estimate as jrqmc
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.ops.fused_engine import fused_terminal_pallas
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import BasketGBM as JBasket
from montecarlo_tpu.processes import GARCHBootstrap as JGarch
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu.processes import MultiGBM as JMulti
from montecarlo_tpu.rng import sobol as jsobol
from montecarlo_tpu.samplers import SobolSampler as JSobolSampler
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MAX,
                                         VanillaPayoff, kernel_route,
                                         payoff_block_moments,
                                         price_to_tolerance_rqmc,
                                         rqmc_estimate, simulate,
                                         simulate_functionals,
                                         terminal_prices)
from montecarlo_tpu_torch.ops import (fused_block_moments_reference,
                                      fused_functionals,
                                      fused_functionals_reference,
                                      fused_terminal,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.rng import sobol as tsobol
from montecarlo_tpu_torch.samplers import (AntitheticSampler,
                                           MixedSobolSampler, PlainSampler,
                                           SobolSampler)

torch.set_num_threads(1)

PRICE_RTOL = 2e-6
SUM_RTOL = 1e-5
N = 1024
OFFSET = 2**30 - 300  # ids cross 2^30, where the Gray code stops being read


def _port(kind, jp):
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return process_from_numpy(kind, fields, device="cpu")


def _pair(kind, n_steps=16):
    dt = 1 / n_steps
    if kind == "heston":
        jp = JHeston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0,
                            theta=0.04, xi=0.5, rho=-0.7, dt=dt)
    elif kind == "basket":
        r = np.random.default_rng(5)
        a = r.normal(size=(5, 5))
        cov = a @ a.T + 5 * np.eye(5)
        d = np.sqrt(np.diag(cov))
        jp = JBasket.create(s0=r.uniform(80, 120, 5), mu=np.full(5, 0.03),
                            sigma=r.uniform(0.15, 0.3, 5),
                            corr=cov / np.outer(d, d),
                            weights=np.full(5, 0.2), dt=dt)
    else:
        jp = JGBM.create(100.0, 0.03, 0.2, dt)
    return jp, _port(kind, jp)


def _samplers(kind, n_steps, n_draws, built_for=None, seed=3):
    """(JAX sampler, port sampler) from the same tables."""
    t = built_for or n_steps
    if kind == "device":
        return (jsobol.SobolDeviceSampler.create(t, n_draws,
                                                 scramble_seed=seed),
                tsobol.SobolDeviceSampler.create(t, n_draws,
                                                 scramble_seed=seed,
                                                 device="cpu"))
    return (jsobol.SobolBridgeKernelSampler.create(t, scramble_seed=seed),
            tsobol.SobolBridgeKernelSampler.create(t, scramble_seed=seed,
                                                   device="cpu"))


def _close(got, want, rtol=PRICE_RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               err_msg=msg)


# --- the gate ----------------------------------------------------------------

def test_kernel_route_gate():
    """The counterpart of JAX's ``_fusable_sampler`` cases: the kernels take
    no sampler, plain, antithetic, a Sobol table covering n_steps *
    n_draws dims and a single-draw bridge built for at least n_steps;
    everything else (short tables, host tables, multi-draw bridges,
    MultiGBM) takes the torch loop."""
    _, gbm = _pair("gbm")
    _, heston = _pair("heston")
    _, multi = _pair_multi()
    dev = tsobol.SobolDeviceSampler.create(16, 1, device="cpu")
    bridge = tsobol.SobolBridgeKernelSampler.create(16, device="cpu")
    host = SobolSampler.create(64, 16, 1, device="cpu")
    for smp in (None, PlainSampler(), AntitheticSampler(), dev, bridge):
        assert kernel_route(gbm, smp, 16)
    assert kernel_route(gbm, None, 1000)
    assert not kernel_route(gbm, dev, 17)                 # table too small
    assert not kernel_route(heston, dev, 16)              # needs 32 dims
    assert kernel_route(heston, tsobol.SobolDeviceSampler.create(
        16, 2, device="cpu"), 16)
    assert kernel_route(gbm, bridge, 9)
    assert not kernel_route(gbm, bridge, 17)
    assert not kernel_route(heston, bridge, 8)            # two draws
    assert not kernel_route(gbm, host, 16)
    assert not kernel_route(gbm, bridge.as_device_sampler(), 16)
    assert not kernel_route(multi, None, 16)


def _pair_multi():
    corr = np.array([[1.0, 0.4], [0.4, 1.0]])
    jp = JMulti.create(s0=[100.0, 90.0], mu=[0.03, 0.03], sigma=[0.2, 0.3],
                       corr=corr, dt=1 / 16)
    return jp, _port("multigbm", jp)


def test_sampler_with_antithetic_raises():
    _, gbm = _pair("gbm")
    _, smp = _samplers("device", 8, 1)
    for fn in (fused_terminal, fused_terminal_reference):
        with pytest.raises(ValueError, match="antithetic"):
            fn(gbm, 256, 8, seed=0, antithetic=True, sampler=smp)
    with pytest.raises(ValueError, match="antithetic"):
        fused_functionals(gbm, 256, 8, seed=0, antithetic=True, sampler=smp,
                          functionals={"avg": ARITH_MEAN})
    with pytest.raises(TypeError, match="SobolDeviceSampler"):
        fused_terminal(gbm, 256, 8, seed=0,
                       sampler=SobolSampler.create(256, 8, 1, device="cpu"))


# --- K2-K4's plain versions under the Sobol samplers --------------------------

@pytest.mark.parametrize("kind,n_steps", [("gbm", 8), ("gbm", 9),
                                          ("gbm", 17), ("heston", 9),
                                          ("basket", 8)])
def test_sobol_device_kernels_match_jax(kind, n_steps):
    """K2, K3 and K4's plain versions under SobolDevice on a table built
    for exactly n_steps, ids crossing 2^30, against JAX's scan with the
    same table; the torch loop equals the plain versions bitwise."""
    jp, tp = _pair(kind, n_steps)
    js, ts = _samplers("device", n_steps, tp.n_draws)
    kw = dict(seed=5, path_offset=OFFSET)
    got = fused_terminal_reference(tp, N, n_steps, sampler=ts, **kw)
    want = jsimulate(jp, N, n_steps, sampler=js, dtype=jnp.float32, **kw)
    _close(got, want)
    assert torch.equal(got, simulate(tp, N, n_steps, sampler=ts, **kw))
    assert torch.equal(got, terminal_prices(tp, N, n_steps, sampler=ts,
                                            **kw))
    if kind == "gbm":
        pay = VanillaPayoff("call", 100.0)
        blocks = fused_block_moments_reference(tp, pay, 4096, n_steps,
                                               sampler=ts, seed=5)
        jterm = np.asarray(jsimulate(jp, 4096, n_steps, seed=5, sampler=js,
                                     dtype=jnp.float32))
        _close(blocks.mean, np.maximum(jterm - 100.0, 0.0).mean(), SUM_RTOL)
    items = (("avg", jf.ARITH_MEAN), ("mx", jf.RUNNING_MAX))
    got = fused_functionals_reference(
        tp, N, n_steps, functionals={"avg": ARITH_MEAN, "mx": RUNNING_MAX},
        sampler=ts, **kw)
    want = jf._simulate_functionals(jp, N, n_steps, 5, 0, js, jnp.float32,
                                    OFFSET, items)
    for k in want:
        _close(got[k], want[k], msg=k)


@pytest.mark.parametrize("n_steps,built_for", [(9, 9), (17, 17), (8, 12)])
def test_sobol_bridge_kernels_match_jax(n_steps, built_for):
    """K2, K3 and K4's plain versions under SobolBridgeKernel (the scratch
    of T bridge normals, then each step's padded plan row) against JAX's
    scan through the sampler's Device delegate; the torch loop (the
    per-step sums) equals them bitwise."""
    jp, tp = _pair("gbm", n_steps)
    js, ts = _samplers("bridge", n_steps, 1, built_for)
    kw = dict(seed=2, path_offset=OFFSET)
    got = fused_terminal_reference(tp, N, n_steps, sampler=ts, **kw)
    want = jsimulate(jp, N, n_steps, sampler=js, dtype=jnp.float32, **kw)
    _close(got, want)
    assert torch.equal(got, simulate(tp, N, n_steps, sampler=ts, **kw))
    items = (("avg", jf.ARITH_MEAN),)
    got = fused_functionals_reference(tp, N, n_steps,
                                      functionals={"avg": ARITH_MEAN},
                                      sampler=ts, **kw)
    want = jf._simulate_functionals(jp, N, n_steps, 2, 0, js, jnp.float32,
                                    OFFSET, items)
    for k in want:
        _close(got[k], want[k], msg=k)
    loop = simulate_functionals(tp, N, n_steps, seed=2, path_offset=OFFSET,
                                functionals={"avg": ARITH_MEAN}, sampler=ts,
                                prefer_fused=False)
    for k in loop:
        assert torch.equal(loop[k], got[k]), k


@pytest.mark.parametrize("kind", ["device", "bridge"])
def test_sobol_kernels_match_an_interpret_mode_kernel(kind):
    """One run of JAX's K2 itself (``fused_terminal_pallas`` in interpret
    mode, 8 x 128 paths) under each sampler."""
    n_steps = 8
    jp, tp = _pair("gbm", n_steps)
    js, ts = _samplers(kind, n_steps, 1)
    want = fused_terminal_pallas(jp, 8 * 128, n_steps, seed=4, block_rows=8,
                                 interpret=True, sampler=js, path_offset=64)
    got = fused_terminal_reference(tp, 8 * 128, n_steps, seed=4,
                                   path_offset=64, sampler=ts)
    _close(got, want)


# --- RQMC ----------------------------------------------------------------------

def _check_est(got, want, keys=("price", "std_err", "n_paths")):
    scale = abs(float(want["price"]))
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=SUM_RTOL, atol=1e-5 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("factory", ["default", "bridge", "host"])
def test_rqmc_estimate_matches_jax(factory):
    jp, tp = _pair("gbm", 16)
    n_paths, n_per = 8 * 512, 512
    if factory == "bridge":
        jfac = lambda r: jsobol.SobolBridgeKernelSampler.create(
            16, scramble_seed=3 + r)
        tfac = lambda r: tsobol.SobolBridgeKernelSampler.create(
            16, scramble_seed=3 + r, device="cpu")
    elif factory == "host":
        jfac = lambda r: JSobolSampler.create(n_per, 16, 1, seed=3 + r,
                                              dtype=jnp.float32)
        tfac = lambda r: SobolSampler.create(n_per, 16, 1, seed=3 + r,
                                             device="cpu")
    else:
        jfac = tfac = None
    want = jrqmc(jp, lambda s: jnp.maximum(s - 100.0, 0.0), n_paths, 16,
                 seed=3, sampler_factory=jfac, discount=0.97)
    got = rqmc_estimate(tp, VanillaPayoff("call", 100.0), n_paths, 16,
                        seed=3, sampler_factory=tfac, discount=0.97)
    assert got["n_replicates"] == 8
    _check_est(got, want)


def test_rqmc_estimate_functionals_match_jax():
    jp, tp = _pair("gbm", 16)
    want = jrqmc(jp, lambda o: jnp.maximum(o["avg"] - 100.0, 0.0), 8 * 256,
                 16, seed=1, functionals={"avg": jf.ARITH_MEAN})
    got = rqmc_estimate(tp, lambda o: torch.clamp(o["avg"] - 100.0, min=0.0),
                        8 * 256, 16, seed=1, functionals={"avg": ARITH_MEAN})
    _check_est(got, want)
    with pytest.raises(ValueError, match=">= 2"):
        rqmc_estimate(tp, lambda s: s, 64, 16, seed=0, n_replicates=1)
    with pytest.raises(ValueError, match="equal non-empty"):
        rqmc_estimate(tp, lambda s: s, 100, 16, seed=0)


def test_price_to_tolerance_rqmc_matches_jax():
    """The same chunks, running means and stopping test as JAX's
    while_loop: the same chunk count, price and spread std-err."""
    jp, tp = _pair("gbm", 16)
    kw = dict(target_std_err=8e-3, seed=4, chunk_paths=1 << 9, n_steps=16,
              discount=0.97, min_chunks=2)
    want = jptt_rqmc(jp, lambda s: jnp.maximum(s - 100.0, 0.0), **kw)
    got = price_to_tolerance_rqmc(tp, VanillaPayoff("call", 100.0), **kw)
    assert got["n_chunks"] == int(want["n_chunks"]) >= 2
    _check_est(got, want, keys=("price", "std_err", "n_paths"))
    assert float(got["std_err"]) <= 8e-3
    with pytest.raises(ValueError, match="2\\^30"):
        price_to_tolerance_rqmc(tp, VanillaPayoff("call", 100.0),
                                target_std_err=1e-3, seed=0,
                                chunk_paths=1 << 23, max_chunks=256)


# --- the CLI -------------------------------------------------------------------

def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--sampler", "sobol"],
    ["--sampler", "sobol-device"],
    ["--sampler", "sobol-bridge", "--payoff", "put"],
    ["--sampler", "sobol-device", "--process", "heston"],
    ["--sampler", "sobol-bridge", "--payoff", "asian"],
    ["--sampler", "sobol", "--payoff", "up-and-out", "--bridge"],
    ["--sampler", "sobol-device", "--target-se", "0.02"],
])
def test_price_sobol_cli_matches_jax(flags, capsys):
    argv = ["price", "--paths", "2048", "--steps", "16", "--seed", "2",
            *flags]
    want = _run(jax_main, argv, capsys)
    got = _run(port_main, [*argv, "--device", "cpu"], capsys)
    assert sorted(got) == sorted(want)
    assert got["n_paths"] == want["n_paths"]
    _check_est(got, want, keys=[k for k in want if k != "n_paths"])


@pytest.mark.parametrize("argv,match", [
    (["--sampler", "sobol-bridge", "--process", "heston"], "single-draw"),
    (["--sampler", "sobol", "--target-se", "0.1"], "sobol-device"),
    (["--sampler", "sobol-device", "--paths", "40"], "paths >= 64"),
    (["--sampler", "sobol", "--payoff", "max-call"], "plain Threefry"),
])
def test_price_sobol_cli_refusals(argv, match, capsys):
    with pytest.raises(SystemExit, match=match):
        port_main(["price", "--steps", "8", *argv, "--device", "cpu"])
    assert capsys.readouterr().out == ""


# --- GARCH under a mixed-slot table ---------------------------------------------

def _garch_pair():
    r = np.random.default_rng(9).standard_t(5, 400) * 0.01
    jp = JGarch.create(r, s0=100.0, var0=1.2e-4)
    return jp, _port("garch", jp)


def test_garch_mixed_sobol_takes_the_torch_loop():
    """GARCH's MixedSobolSampler table goes through the torch loop (the
    kernels refuse it), matches JAX's scan; device Sobol normals are
    refused for its uniform draw."""
    jp, tp = _garch_pair()
    jsmp = JSobolSampler.for_process(jp, 2048, 20, seed=5, dtype=jnp.float32)
    tsmp = SobolSampler.for_process(tp, 2048, 20, seed=5)
    assert isinstance(tsmp, MixedSobolSampler)
    assert not kernel_route(tp, tsmp, 20)
    got = terminal_prices(tp, 2048, 20, seed=1, sampler=tsmp)
    want = jsimulate(jp, 2048, 20, seed=1, sampler=jsmp, dtype=jnp.float32)
    _close(got, want)
    blocks = payoff_block_moments(tp, VanillaPayoff("put", 100.0), 2048, 20,
                                  seed=1, sampler=tsmp)
    assert blocks.count.tolist() == [2048.0]
    with pytest.raises(ValueError, match="non-normal"):
        terminal_prices(tp, 256, 8, seed=0,
                        sampler=tsobol.SobolDeviceSampler.create(
                            8, 1, device="cpu"))


def test_portfolio_var_on_device_with_a_mixed_sobol_table():
    """``portfolio_var_on_device`` on GARCH with a ``for_process`` table
    (tests/test_qmc_risk.py's seam): the port's torch loop against JAX's,
    the same keys, counts and percentiles within rtol 1e-5."""
    from montecarlo_tpu.api import portfolio_var_on_device as jvar
    from montecarlo_tpu_torch.api import portfolio_var_on_device

    jp, tp = _garch_pair()
    n = 1 << 13
    jsmp = JSobolSampler.for_process(jp, n, 20, seed=2, dtype=jnp.float32)
    tsmp = SobolSampler.for_process(tp, n, 20, seed=2)
    kw = dict(seed=3, bins=512, chunk_paths=1 << 12)
    got = portfolio_var_on_device(tp, n, 20, 100.0, sampler=tsmp, **kw)
    want = jvar(jp, n, 20, 100.0, sampler=jsmp, **kw)
    assert sorted(got) == sorted(want)
    assert got["n_paths"] == want["n_paths"] == n
    for q, v in want["percentiles"].items():
        np.testing.assert_allclose(got["percentiles"][q], v, rtol=SUM_RTOL)
    for k in ("var_95", "cvar_95", "expected_vol", "prob_profit"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
