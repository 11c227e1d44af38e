"""The jump processes of the port (Merton, Kou, Bates) and NIG against the
JAX package: draws, paths from the torch loop and from K2/K3/K4's plain
versions against JAX's scan and one ``fused_terminal_pallas(...,
interpret=True)`` run (16384 paths x 17 steps, as tests/test_merton.py
runs it), the truncated Poisson count, Kou's jump sizes, the CF oracles,
``price --process merton|kou|bates|nig`` against the JAX CLI and the
refusal of the in-kernel Sobol samplers.

Processes are built by the JAX package and carried across with
``convert.process_from_numpy``; JAX runs its scan (conftest turns on x64;
both sides pin float32).  Tolerances are tests/torch_process_pairs.py's:
uniforms bitwise, normals within 4.8e-7, terminal prices within rtol 1e-5
per path with at most 0.1% of the paths off by a discrete flip (a Poisson
count, NIG's root), mean prices within rtol 1e-5; the CF oracles (float64
on both sides) within rtol 1e-10; inside the port, bitwise.
"""

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
from montecarlo_tpu.processes import merton_call_series as jmerton_series
from montecarlo_tpu.processes.merton import poisson_count as jpoisson
from montecarlo_tpu.samplers import AntitheticSampler as JAntithetic
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MAX,
                                         VanillaPayoff, cf_pricing,
                                         kernel_route, simulate,
                                         terminal_prices)
from montecarlo_tpu_torch.ops import (fused_block_moments_reference,
                                      fused_functionals_reference,
                                      fused_terminal,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.processes import (Kou, Merton, bates_log_cf,
                                            merton_call_series)
from montecarlo_tpu_torch.processes.merton import poisson_count
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            SobolDeviceSampler)
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from montecarlo_tpu_torch.samplers import AntitheticSampler
from tests.torch_process_pairs import (N_PATHS, N_STEPS, PATH_RTOL,
                                       hold_cli, hold_draws, hold_paths,
                                       pair, run_cli)

torch.set_num_threads(1)

KINDS = ["merton", "kou", "bates", "nig"]
WRAP = 2**32 - 5000  # path ids wrap past 2^32 inside a run


@pytest.mark.parametrize("kind", KINDS)
def test_draws_match_jax(kind):
    """draws_pair against JAX's (ids wrapping past 2^32), draws(t) equal to
    the pair's slots bitwise, and the antithetic mirror."""
    jp, tp = pair(kind)
    k0, k1 = key_from_seed(7, 3)
    ids = (torch.arange(2000, dtype=torch.int64) + 2**32 - 900) & 0xFFFFFFFF
    jids = jnp.asarray(ids.numpy().astype(np.uint32))
    kinds = tp.draw_kinds
    for j in (0, 5):
        got = tp.draws_pair(k0, k1, ids, j)
        want = jp.draws_pair(7, 3, jids, j)
        for t in (0, 1):
            hold_draws(got[t], want[t], kinds)
            single = tp.draws(k0, k1, ids, 2 * j + t)
            assert all(torch.equal(a, b) for a, b in zip(single, got[t]))
            hold_draws(single, jp.draws(7, 3, jids, 2 * j + t), kinds)
        hold_draws(tp.antithetic(got[0]), jp.antithetic(want[0]), kinds)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_paths_match_jax(kind, antithetic):
    """The torch loop equals K2's plain version bitwise; both hold JAX's
    scan within the stated tolerance, ids wrapping past 2^32."""
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
    run; K3's against the moments of JAX's terminal payoffs; K4's {avg, mx}
    against JAX's functional scan."""
    jp, tp = pair(kind)
    got = fused_terminal_reference(tp, N_PATHS, N_STEPS, seed=5)
    want = fused_terminal_pallas(jp, N_PATHS, N_STEPS, seed=5,
                                 block_rows=128, interpret=True)
    hold_paths(got, want, kind)
    blocks = fused_block_moments_reference(tp, VanillaPayoff("call", 100.0),
                                           N_PATHS, N_STEPS, seed=5)
    pay = np.maximum(np.asarray(want, np.float64) - 100.0, 0.0)
    np.testing.assert_allclose(blocks.mean.numpy(),
                               pay.reshape(-1, 4096).mean(axis=1),
                               rtol=PATH_RTOL * 10)
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
    got_f = fused_functionals_reference(tp, N_PATHS, N_STEPS, seed=5,
                                        functionals=fns)
    want_f = jf._simulate_functionals(
        jp, N_PATHS, N_STEPS, 5, 0, None, jnp.float32, 0,
        (("avg", jf.ARITH_MEAN), ("mx", jf.RUNNING_MAX)))
    for k in want_f:
        hold_paths(got_f[k], want_f[k], f"{kind} {k}")
    assert torch.equal(got_f["terminal"], got)


def test_poisson_count_matches_jax():
    """The count of every uniform, cdf levels and their neighbours
    included, is JAX's (exact float32 selects over the same levels)."""
    rng = np.random.default_rng(4)
    for rate in (1.0 / 252, 0.05, 0.4):
        r32 = np.float32(rate)
        pmf = np.exp(-np.float64(r32)) * np.float64(r32) ** np.arange(5) \
            / np.array([1, 1, 2, 6, 24])
        levels = np.cumsum(pmf)[:4].astype(np.float32)
        u = np.concatenate([
            rng.uniform(0, 1, 50000), levels,
            np.nextafter(levels, np.float32(0)),
            np.nextafter(levels, np.float32(1))]).astype(np.float32)
        got = poisson_count(torch.from_numpy(u), torch.tensor(r32))
        want = jpoisson(jnp.asarray(u), jnp.float32(r32), jnp.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kou_jump_sizes_and_factor_match_jax():
    jp, tp = pair("kou")
    u = np.random.default_rng(2).uniform(0, 1, 1 << 16).astype(np.float32)
    got = tp._jump_size(torch.from_numpy(u)).numpy()
    want = np.asarray(jp._jump_size(jnp.asarray(u), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    assert float(tp.mean_jump_factor()) == pytest.approx(
        float(jp.mean_jump_factor()), rel=1e-7)


def test_jump_grid_and_parameter_guards():
    for make in (lambda dt: Merton.create(100.0, 0.03, 0.2, 50.0, 0.0, 0.1,
                                          dt, device="cpu"),
                 lambda dt: Kou.create(100.0, 0.03, 0.2, 50.0, 0.4, 10.0,
                                       5.0, dt, device="cpu")):
        make(1.0 / 252)
        with pytest.raises(ValueError, match="too coarse"):
            make(0.01)
    with pytest.raises(ValueError, match="eta1"):
        Kou.create(100.0, 0.03, 0.2, 1.0, 0.4, 1.0, 5.0, 0.01, device="cpu")


def test_cf_oracles_match_jax():
    """The port's float64 CF prices against JAX's (x64) at several
    strikes; Merton's CF price against its series, both sides."""
    cases = [
        (cf_pricing.merton_log_cf, jcf.merton_log_cf,
         (100.0, 0.03, 0.2, 1.0, -0.05, 0.1, 1.0)),
        (cf_pricing.kou_log_cf, jcf.kou_log_cf,
         (100.0, 0.03, 0.2, 1.0, 0.4, 10.0, 5.0, 1.0)),
        (cf_pricing.nig_log_cf, jcf.nig_log_cf,
         (100.0, 0.03, 15.0, -5.0, 0.5, 1.0)),
        (bates_log_cf, jbates_cf,
         (100.0, 0.03, 0.04, 2.0, 0.04, 0.5, -0.7, 1.0, -0.05, 0.1, 1.0)),
    ]
    for strike in (80.0, 105.0, 130.0):
        for port_cf, jax_cf, args in cases:
            got = cf_pricing.cf_call_price(port_cf(*args), 100.0, strike,
                                           1.0, 0.03)
            want = float(jcf.cf_call_price(jax_cf(*args), 100.0, strike,
                                           1.0, 0.03))
            assert got == pytest.approx(want, rel=1e-10), port_cf.__name__
        series = merton_call_series(100.0, strike, 0.03, 0.2, 1.0, -0.05,
                                    0.1, 1.0)
        assert series == pytest.approx(jmerton_series(
            100.0, strike, 0.03, 0.2, 1.0, -0.05, 0.1, 1.0), rel=1e-12)
        cf = cf_pricing.cf_call_price(cf_pricing.merton_log_cf(
            100.0, 0.03, 0.2, 1.0, -0.05, 0.1, 1.0), 100.0, strike, 1.0,
            0.03)
        assert cf == pytest.approx(series, rel=1e-6)


@pytest.mark.parametrize("flags", [
    ["--process", "merton"],
    ["--process", "kou"],
    ["--process", "bates"],
    ["--process", "nig"],
    ["--process", "merton", "--sampler", "antithetic", "--payoff", "put"],
    ["--process", "kou", "--payoff", "asian"],
    ["--process", "merton", "--sampler", "sobol"],
    ["--process", "nig", "--target-se", "0.2"],
])
def test_price_cli_matches_jax(flags, capsys):
    argv = ["price", "--paths", "16384", "--steps", "16", "--seed", "2",
            *flags]
    want = run_cli(jax_main, argv, capsys)
    got = run_cli(port_main, [*argv, "--device", "cpu"], capsys)
    hold_cli(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_in_kernel_sobol_refused(kind, capsys):
    """The CLI refuses sobol-device and sobol-bridge for a process with
    uniform draws, as the JAX CLI does; so does the engine, whichever
    route the gate picks."""
    for smp in ("sobol-device", "sobol-bridge"):
        argv = ["price", "--process", kind, "--sampler", smp, "--steps",
                "16"]
        with pytest.raises(SystemExit, match="non-normal uniforms"):
            jax_main(argv)
        with pytest.raises(SystemExit, match="non-normal uniforms"):
            port_main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out == ""
    _, tp = pair(kind, 16)
    dev = SobolDeviceSampler.create(16, tp.n_draws, device="cpu")
    bridge = SobolBridgeKernelSampler.create(16, device="cpu")
    assert kernel_route(tp, dev, 16) and not kernel_route(tp, bridge, 16)
    for smp in (dev, bridge):
        with pytest.raises(ValueError, match="non-normal"):
            terminal_prices(tp, 256, 16, seed=0, sampler=smp)
    with pytest.raises(ValueError, match="non-normal"):
        fused_terminal(tp, 256, 16, seed=0, sampler=dev)
