"""The GARCH slice against the JAX package: the bootstrap GARCH process,
K2/K3/K4's plain versions on it, the quantile and risk statistics, the
per-step path histograms, ``fit_garch``, ``garch_monte_carlo``,
``portfolio_var_on_device`` and ``var --on-device``.

Inputs are made once with numpy (a synthetic history from
``data/synthetic.py`` through JAX's feature layer, as
tests/test_reference_parity.py does) and carried to both sides.
Tolerances and why:

- Threefry words, uniforms, table indices, the table itself and the
  mirror 1 - u are integer or exact float32 work: bitwise.
- The step: XLA:CPU contracts ``omega + alpha r^2 + beta var`` into
  fma(beta, var, fma(alpha, r^2, omega)) and ``log_s + shock * vol`` into
  fma(shock, vol, log_s), and takes the IEEE square root; the port (and
  its kernel, built with -fmad=false) rounds each operation as written,
  and torch's vectorized CPU sqrt is off by one ULP on ~0.7% of large
  inputs (IEEE on the card).  Emulating each side's operations in numpy
  reproduces both bitwise, within 2 ULP of each other per step.  The
  prices agree within rtol 2e-6 over 20 steps (measured <= 1e-6), the
  package's own price tolerance.
- Sums and means (block moments, the risk moments, the chunk Chan merge)
  run in each framework's own order: rtol 1e-5.  The percentile positions
  are the same integers; the lerp of the two neighbours is numpy's on the
  port and a weighted sum on JAX: rtol 1e-6 on percentiles of identical
  samples.
- Histogram counts are exact integers: equal, given the same prices.
- ``fit_garch``: the port sums the variance recurrence as block products
  where JAX scans; after 500 Adam steps the parameters agree within rtol
  1e-4 (measured <= 5e-6).
- Inside the port (kernel plain versions against the torch loop):
  bitwise.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.api import garch_monte_carlo as jgarch_mc
from montecarlo_tpu.api import portfolio_var_on_device as jvar
from montecarlo_tpu.cli import main as jax_main
from montecarlo_tpu.data.synthetic import generate_ohlcv as jgenerate
from montecarlo_tpu.engine import path_sketch as jsketch
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.ops.fused_engine import (fused_block_moments_pallas,
                                             fused_functionals_pallas,
                                             fused_terminal_pallas)
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import GARCHBootstrap as JGARCH
from montecarlo_tpu.processes.garch_fit import fit_garch as jfit
from montecarlo_tpu.quant import features_to_numpy
from montecarlo_tpu.samplers import AntitheticSampler as JAntithetic
from montecarlo_tpu.stats import quantiles as jq
from montecarlo_tpu.stats import risk as jrisk
from montecarlo_tpu_torch.api import (garch_monte_carlo,
                                      portfolio_var_on_device)
from montecarlo_tpu_torch.cli import main as port_main
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.data import generate_ohlcv
from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MAX,
                                         RUNNING_MIN, VanillaPayoff,
                                         simulate, simulate_functionals)
from montecarlo_tpu_torch.engine.path_sketch import (
    path_histograms, percentiles_from_histograms)
from montecarlo_tpu_torch.ops import (fused_block_moments_reference,
                                      fused_functionals_reference,
                                      fused_terminal,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.processes import GBM, GARCHBootstrap
from montecarlo_tpu_torch.processes.garch_fit import fit_garch
from montecarlo_tpu_torch.rng.normal import index_from_uniform
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from montecarlo_tpu_torch.samplers import AntitheticSampler
from montecarlo_tpu_torch.stats import quantiles as tq
from montecarlo_tpu_torch.stats.risk import (path_percentiles,
                                             terminal_statistics)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PRICE_RTOL = 2e-6   # the variance update's FMA contraction on XLA:CPU
SUM_RTOL = 1e-5     # reductions in each framework's own order
PCT_RTOL = 1e-6     # numpy's lerp against JAX's weighted sum
FIT_RTOL = 1e-4     # block products against the scan, 500 Adam steps
WRAP = 2**32 - 700  # ids wrap past 2^32 inside the run


@pytest.fixture(scope="module")
def data():
    """A 2-year synthetic history through JAX's feature layer (log_ret,
    rvol_20 and the rest), as tests/test_reference_parity.py builds it."""
    o = generate_ohlcv(n_days=504, seed=21)
    return features_to_numpy(o["Open"], o["High"], o["Low"], o["Close"],
                             o["Volume"])


def _returns(data):
    r = np.asarray(data["log_ret"], np.float64)
    return r[~np.isnan(r)]


def _pair(data, **kw):
    """JAX's process and the port's, from one numpy history."""
    r = _returns(data)
    var0 = float(data["rvol_20"][-1]) ** 2 / 252.0
    jp = JGARCH.create(r, s0=float(data["Close"][-1]), var0=var0, **kw)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return jp, process_from_numpy("garch", fields, device="cpu")


# --- the process -------------------------------------------------------------

def test_synthetic_history_is_the_jax_packages():
    a, b = generate_ohlcv(n_days=300, seed=4), jgenerate(n_days=300, seed=4)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("pad_to", [None, 2048])
def test_create_and_convert_match_jax(data, pad_to):
    """The table is JAX's ``table[:n_table]`` bitwise at any JAX padding,
    from ``create`` and from ``process_from_numpy``; the scalars are the
    same float32s."""
    r = _returns(data)
    jp, conv = _pair(data, pad_to=pad_to)
    n = int(jp.n_table)
    tp = GARCHBootstrap.create(r, s0=float(data["Close"][-1]),
                               var0=float(data["rvol_20"][-1]) ** 2 / 252.0,
                               device="cpu")
    want = np.asarray(jp.table)[:n]
    assert n == r.size and tp.table.shape == (n,)
    assert int(tp.n_table) == int(conv.n_table) == n
    np.testing.assert_array_equal(tp.table.numpy(), want)
    np.testing.assert_array_equal(conv.table.numpy(), want)
    for k in ("s0", "var0", "omega", "alpha", "beta"):
        assert getattr(tp, k).item() == np.float32(getattr(jp, k))
        assert getattr(conv, k).dtype == torch.float32
    assert np.all(np.diff(want) >= 0)


def test_create_guards(data):
    with pytest.raises(ValueError, match=">= 100"):
        GARCHBootstrap.create(np.full(99, 0.01), 100.0, 1e-4, device="cpu")
    tp = GARCHBootstrap.create(_returns(data), 100.0, 1e-4, device="cpu")
    with pytest.raises(ValueError, match="n_table"):
        GARCHBootstrap(**{**tp.__dict__, "n_table": torch.tensor(7)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GARCHBootstrap.create(_returns(data), 100.0, 1e-4)


def test_draws_pair_and_mirror_match_jax(data):
    """Uniforms (draw m = t in component m & 1 of call m >> 1), their
    table indices and the mirror 1 - u: bitwise, ids wrapping past 2^32;
    a negated uniform never reaches the table."""
    jp, tp = _pair(data)
    ids_np = (np.arange(4096, dtype=np.uint64) + WRAP) % 2**32
    ids = torch.from_numpy(ids_np.astype(np.int64))
    jids = jnp.asarray(ids_np.astype(np.uint32))
    k0, k1 = key_from_seed(3, 1)
    for t in (0, 1, 6, 7):
        (u,) = tp.draws(k0, k1, ids, t)
        (ju,) = jp.draws(3, 1, jids, t)
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        assert bool(((u > 0) & (u < 1)).all())
    (u0,), (u1,) = tp.draws_pair(k0, k1, ids, 3)
    (j0,), (j1,) = jp.draws_pair(3, 1, jids, 3)
    np.testing.assert_array_equal(u0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(u1.numpy(), np.asarray(j1))
    assert torch.equal(u0, tp.draws(k0, k1, ids, 6)[0])
    (m,) = tp.antithetic((u0,))
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(jp.antithetic((j0,))[0]))
    assert torch.equal(1.0 - m, u0)  # exact: an involution
    idx = index_from_uniform(m, tp.table.numel())
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jp._index_of(jnp.asarray(m))))
    assert int(idx.min()) >= 0 and int(idx.max()) < tp.table.numel()
    state = tp.init_state(ids)
    with pytest.raises(ValueError, match="uniforms in"):
        tp.step(state, (-u0,), 0)


def test_step_is_jax_with_the_fma_contraction(data):
    """One step from random states: the port rounds each operation as
    written, with torch's sqrt; JAX's jitted step on the CPU equals the
    FMA-contracted form with the IEEE sqrt, var' = fma(beta, var,
    fma(alpha, r*r, omega)) and log_s' = fma(shock, vol, log_s), bitwise;
    the two differ by at most two ULP."""
    jp, tp = _pair(data)
    rng = np.random.default_rng(5)
    n = 1 << 14
    var = rng.uniform(1e-5, 1e-3, n).astype(np.float32)
    log_s = rng.uniform(4.0, 5.5, n).astype(np.float32)
    u = ((rng.integers(0, 2**23, n) + 0.5) * 2.0**-23).astype(np.float32)
    state = tp.init_state(torch.zeros(n))._replace(
        log_s=torch.from_numpy(log_s), var=torch.from_numpy(var))
    got = tp.step(state, (torch.from_numpy(u),), 0)
    jstate = jp.init_state(jnp.zeros(n, jnp.uint32))._replace(
        log_s=jnp.asarray(log_s), var=jnp.asarray(var))
    want = jax.jit(lambda s, u: jp.step(s, (u,), 0))(jstate, jnp.asarray(u))
    d, f32 = np.float64, np.float32
    idx = index_from_uniform(torch.from_numpy(u), tp.table.numel()).numpy()
    shock, vol = tp.table.numpy()[idx], np.sqrt(var)
    vol_t = torch.sqrt(torch.from_numpy(var)).numpy()
    r, r_t = shock * vol, shock * vol_t
    om, al, be = (f32(getattr(jp, k)) for k in ("omega", "alpha", "beta"))
    # A float32 product is exact in float64, so one float64 add and one
    # rounding to float32 is the FMA (checked against JAX below).
    fma = lambda a, b, c: (d(a) * d(b) + d(c)).astype(f32)
    plain = {"var": (om + al * (r_t * r_t)) + be * var, "log_s": log_s + r_t}
    fused = {"var": fma(be, var, fma(al, r * r, om)),
             "log_s": fma(shock, vol, log_s)}
    for k in ("var", "log_s"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), plain[k])
        np.testing.assert_array_equal(np.asarray(getattr(want, k)), fused[k])
        ulp = np.abs(plain[k].view(np.int32) - fused[k].view(np.int32))
        assert ulp.max() <= 2, k


@pytest.mark.parametrize("mode", ["terminal", "paths"])
@pytest.mark.parametrize("antithetic", [False, True])
def test_simulate_matches_jax(data, mode, antithetic):
    jp, tp = _pair(data)
    n, steps = 4096, 20
    want = np.asarray(jsimulate(
        jp, n, steps, seed=7, mode=mode, path_offset=WRAP,
        sampler=JAntithetic() if antithetic else None))
    got = simulate(tp, n, steps, seed=7, mode=mode, path_offset=WRAP,
                   sampler=AntitheticSampler() if antithetic else None)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=PRICE_RTOL, atol=0)
    if mode == "paths":
        assert torch.equal(got[-1], simulate(
            tp, n, steps, seed=7, path_offset=WRAP,
            sampler=AntitheticSampler() if antithetic else None))


# --- K2, K3, K4 plain versions -------------------------------------------------

@pytest.mark.parametrize("n_steps", [1, 16, 17])
@pytest.mark.parametrize("antithetic", [False, True])
def test_k2_k3_k4_plain_match_jax_kernels(data, n_steps, antithetic):
    """K2/K3/K4's plain versions on GARCH against the JAX kernels in
    interpret mode at 128 x 128 paths, and against the port's torch loop
    bitwise."""
    jp, tp = _pair(data)
    n, off = 128 * 128, 4096
    kw = dict(seed=5, path_offset=off, antithetic=antithetic)
    sampler = AntitheticSampler() if antithetic else None
    want = np.asarray(fused_terminal_pallas(jp, n, n_steps, block_rows=16,
                                            interpret=True, **kw))
    got = fused_terminal_reference(tp, n, n_steps, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=PRICE_RTOL, atol=0)
    assert torch.equal(got, simulate(tp, n, n_steps, seed=5, sampler=sampler,
                                     path_offset=off))
    assert torch.equal(got, fused_terminal(tp, n, n_steps, **kw))

    strike = float(np.median(want))
    jwant = fused_block_moments_pallas(
        jp, lambda s: jnp.maximum(s - strike, 0.0), n, n_steps,
        block_rows=32, interpret=True, **kw)
    mom = fused_block_moments_reference(tp, VanillaPayoff("call", strike), n,
                                        n_steps, **kw)
    for j, t in zip(jwant, mom):
        assert t.shape == (n // 4096,)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=SUM_RTOL)

    names = ("avg", "mx", "mn")
    jfns = dict(zip(names, (jf.ARITH_MEAN, jf.RUNNING_MAX, jf.RUNNING_MIN)))
    tfns = dict(zip(names, (ARITH_MEAN, RUNNING_MAX, RUNNING_MIN)))
    jout = fused_functionals_pallas(jp, n, n_steps, block_rows=16,
                                    functional_items=tuple(jfns.items()),
                                    interpret=True, **kw)
    tout = fused_functionals_reference(tp, n, n_steps, functionals=tfns,
                                       **kw)
    loop = simulate_functionals(tp, n, n_steps, seed=5, path_offset=off,
                                sampler=sampler, functionals=tfns,
                                prefer_fused=False)
    assert set(tout) == set(jout) == {"terminal", *names}
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   rtol=PRICE_RTOL, atol=0, err_msg=k)
        assert torch.equal(tout[k], loop[k]), k


# --- statistics ----------------------------------------------------------------

@pytest.mark.parametrize("shape,dim", [((1001,), None), ((7, 333), 1),
                                       ((4, 2), 0), ((1,), None)])
def test_percentile_linear_matches_numpy_and_jax(shape, dim):
    x = np.random.default_rng(1).lognormal(0, 0.3, shape).astype(np.float32)
    q = (1, 5, 10, 25, 50, 75, 90, 95, 99, 0, 100)
    got = tq.percentile_linear(torch.from_numpy(x), q, dim=dim).numpy()
    want_np = np.percentile(x.astype(np.float64), q, axis=dim)
    want_jax = np.asarray(jq.percentile_linear(jnp.asarray(x),
                                               jnp.asarray(q, jnp.float32),
                                               axis=dim))
    assert got.shape == want_np.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_np, rtol=PCT_RTOL)
    np.testing.assert_allclose(got, want_jax, rtol=PCT_RTOL)
    # q = 0 and q = 100 are the sample's min and max exactly.
    np.testing.assert_array_equal(got[-2], x.min(axis=dim))
    np.testing.assert_array_equal(got[-1], x.max(axis=dim))


def test_histogram_counts_and_sketch_match_jax():
    """Counts exact, out-of-range values counted and never clipped into
    the edge bins, merges exact; every sketch query within rtol 1e-5."""
    rng = np.random.default_rng(2)
    a = rng.normal(100, 12, 50_000).astype(np.float32)
    b = rng.normal(95, 20, 30_000).astype(np.float32)
    lo, hi, bins = 70.0, 130.0, 1024
    idx = rng.integers(0, bins, 10_000)
    np.testing.assert_array_equal(
        tq.histogram_counts(torch.from_numpy(idx), bins).numpy(),
        np.asarray(jq.histogram_counts(jnp.asarray(idx, jnp.int32), bins)))
    ts = tq.sketch_merge(tq.sketch_from_array(torch.from_numpy(a), lo, hi,
                                              bins),
                         tq.sketch_from_array(torch.from_numpy(b), lo, hi,
                                              bins))
    js = jq.sketch_merge(jq.sketch_from_array(jnp.asarray(a), lo, hi, bins),
                         jq.sketch_from_array(jnp.asarray(b), lo, hi, bins))
    assert ts.counts.dtype == torch.int32
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    for k in ("total", "underflow", "overflow", "vmin", "vmax"):
        assert float(getattr(ts, k)) == float(getattr(js, k)), k
    assert int(ts.counts.sum()) + float(ts.underflow) + float(
        ts.overflow) == a.size + b.size
    assert float(ts.underflow) > 0 and float(ts.overflow) > 0
    for q in (1.0, 5.0, 50.0, 95.0):
        np.testing.assert_allclose(float(tq.sketch_quantile(ts, q)),
                                   float(jq.sketch_quantile(js, q)),
                                   rtol=SUM_RTOL)
        np.testing.assert_allclose(
            float(tq.sketch_quantile_std_err(ts, q)),
            float(jq.sketch_quantile_std_err(js, q)), rtol=SUM_RTOL)
    for x in (60.0, 99.0, 101.5, 140.0):
        np.testing.assert_allclose(float(tq.sketch_cdf(ts, x)),
                                   float(jq.sketch_cdf(js, x)), rtol=SUM_RTOL)
        np.testing.assert_allclose(float(tq.sketch_tail_mean_below(ts, x)),
                                   float(jq.sketch_tail_mean_below(js, x)),
                                   rtol=SUM_RTOL)


def test_terminal_statistics_and_path_percentiles_match_jax(data):
    jp, tp = _pair(data)
    paths = simulate(tp, 8192, 20, seed=2, mode="paths")
    s0 = float(data["Close"][-1])
    got = terminal_statistics(paths[-1], s0)
    want = jrisk.terminal_statistics(jnp.asarray(paths[-1].numpy()),
                                     jnp.asarray(s0, jnp.float32))
    assert sorted(got) == sorted(want)
    for k, v in want["percentiles"].items():
        np.testing.assert_allclose(float(got["percentiles"][k]), float(v),
                                   rtol=PCT_RTOL)
    for k in ("expected_return", "expected_vol", "prob_profit", "var_95",
              "cvar_95"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=SUM_RTOL, err_msg=k)
    curves = path_percentiles(paths)
    jcurves = jrisk.path_percentiles(jnp.asarray(paths.numpy()))
    assert sorted(curves) == sorted(jcurves)
    for k in jcurves:
        assert curves[k].shape == (21,)
        np.testing.assert_allclose(curves[k].numpy(), np.asarray(jcurves[k]),
                                   rtol=PCT_RTOL)


@pytest.mark.parametrize("proc_kind", ["garch", "gbm"])
def test_path_histograms_match_jax(data, proc_kind):
    """Per-step counts: equal to JAX's binning (its floor, clip and
    ``histogram_counts``) of the port's own paths; against JAX's run of
    the same seed they differ only where a path's price, within the price
    tolerance, sits across a bin edge.  The curves from the same counts
    are equal."""
    if proc_kind == "garch":
        jp, tp = _pair(data)
    else:
        jp = JGBM.create(100.0, 0.05, 0.25, 1 / 252)
        tp = GBM.create(100.0, 0.05, 0.25, 1 / 252, device="cpu")
    n, steps, bins = 8192, 20, 1024
    lo, hi = 0.8 * float(tp.s0), 1.2 * float(tp.s0)
    got = path_histograms(tp, n, steps, seed=3, lo=lo, hi=hi, bins=bins)
    assert got.shape == (steps + 1, bins) and got.dtype == torch.int32
    assert (got.sum(dim=1) == n).all()
    paths = jnp.asarray(simulate(tp, n, steps, seed=3, mode="paths").numpy())
    lo_j, hi_j = jnp.float32(lo), jnp.float32(hi)
    width = (hi_j - lo_j) / bins
    idx = jnp.clip(jnp.floor((paths - lo_j) / width).astype(jnp.int32), 0,
                   bins - 1)
    same = np.stack([np.asarray(jq.histogram_counts(row, bins))
                     for row in idx])
    np.testing.assert_array_equal(got.numpy(), same)
    want = np.asarray(jsketch.path_histograms(
        jp, n, steps, seed=3, lo=lo_j, hi=hi_j, bins=bins))
    moved = np.abs(got.numpy().astype(np.int64) - want).sum(axis=1)
    assert moved.max() <= 2 * 4, moved  # at most 4 paths cross an edge
    curves = percentiles_from_histograms(got.numpy(), lo, hi)
    jcurves = jsketch.percentiles_from_histograms(same, lo, hi)
    for k in jcurves:
        np.testing.assert_array_equal(curves[k], jcurves[k])


# --- the API ---------------------------------------------------------------------

def _check_return(got, want):
    """``expected_return`` is 100 (mean / s0 - 1): the mean's relative
    error, on the scale of mean / s0."""
    np.testing.assert_allclose(1 + got / 100, 1 + want / 100, rtol=SUM_RTOL)


def _check_mc(got, want, keep_paths):
    assert sorted(got) == sorted(want)
    _check_return(got["expected_return"], want["expected_return"])
    for k in ("expected_vol", "prob_profit", "var_95", "cvar_95"):
        np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL, err_msg=k)
    for k, v in want["percentiles"].items():
        np.testing.assert_allclose(got["percentiles"][k], v, rtol=PCT_RTOL)
    np.testing.assert_allclose(got["final_prices"], want["final_prices"],
                               rtol=PRICE_RTOL, atol=0)
    # Histogram curves sit at bin-grid positions that move with the range's
    # float32 rounding; exact curves at the percentiles' rtol.
    rtol = PCT_RTOL if keep_paths else SUM_RTOL
    for k, v in want["path_percentiles"].items():
        np.testing.assert_allclose(got["path_percentiles"][k], np.asarray(v),
                                   rtol=rtol, err_msg=k)
    if keep_paths:
        np.testing.assert_allclose(got["paths"], want["paths"],
                                   rtol=PRICE_RTOL, atol=0)


@pytest.mark.parametrize("keep_paths", [True, False])
@pytest.mark.parametrize("antithetic", [False, True])
def test_garch_monte_carlo_matches_jax(data, keep_paths, antithetic):
    s0 = float(data["Close"][-1])
    kw = dict(seed=4, keep_paths=keep_paths, antithetic=antithetic)
    want = jgarch_mc(data, 4096, 20, s0, **kw)
    got = garch_monte_carlo(data, 4096, 20, s0, device="cpu", **kw)
    _check_mc(got, want, keep_paths)
    assert got["final_prices"].shape == (4096,)
    if keep_paths:
        assert got["paths"].shape == (21, 4096)
        np.testing.assert_array_equal(got["paths"][-1], got["final_prices"])


def test_garch_monte_carlo_terminals_agree_across_modes(data):
    """K2's terminals (keep_paths=False) are the torch loop's last row
    bitwise; the histogram bands lie within a bin width of the exact
    ones."""
    s0 = float(data["Close"][-1])
    a = garch_monte_carlo(data, 4096, 20, s0, seed=1, device="cpu")
    b = garch_monte_carlo(data, 4096, 20, s0, seed=1, keep_paths=False,
                          device="cpu")
    np.testing.assert_array_equal(a["final_prices"], b["final_prices"])
    fp = b["final_prices"]
    span = float(fp.max() - fp.min()) + 1e-6
    width = 1.5 * span / 2048
    for k in a["path_percentiles"]:
        assert np.max(np.abs(a["path_percentiles"][k]
                             - b["path_percentiles"][k])) <= width + 1e-4


def test_garch_monte_carlo_none_cases_and_guards(data):
    short = {"log_ret": np.full(99, 0.01), "rvol_20": np.full(99, 0.2)}
    assert garch_monte_carlo(short, 100, 10, 100.0, device="cpu") is None
    assert jgarch_mc(short, 100, 10, 100.0) is None
    bad = dict(data, rvol_20=np.full_like(data["rvol_20"], np.nan))
    assert garch_monte_carlo(bad, 100, 10, 100.0, device="cpu") is None
    with pytest.raises(ValueError, match="even"):
        garch_monte_carlo(data, 101, 5, 100.0, antithetic=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            garch_monte_carlo(data, 100, 5, 100.0)


def test_garch_monte_carlo_fit_params_matches_jax(data):
    s0 = float(data["Close"][-1])
    want = jgarch_mc(data, 2048, 10, s0, seed=2, fit_params=True)
    got = garch_monte_carlo(data, 2048, 10, s0, seed=2, fit_params=True,
                            device="cpu")
    # The fitted parameters differ within FIT_RTOL, so prices too.
    np.testing.assert_allclose(got["final_prices"], want["final_prices"],
                               rtol=FIT_RTOL)
    np.testing.assert_allclose(got["var_95"], want["var_95"], rtol=1e-3)


# --- fit_garch ---------------------------------------------------------------

def _simulate_garch(omega, alpha, beta, n, seed):
    """tests/test_garch_fit.py's simulated history."""
    rng = np.random.default_rng(seed)
    var = omega / (1 - alpha - beta)
    out = np.empty(n)
    for t in range(n):
        r = np.sqrt(var) * rng.normal()
        out[t] = r
        var = omega + alpha * r * r + beta * var
    return out


def test_fit_garch_matches_jax_and_recovers_parameters():
    """tests/test_garch_fit.py's recovery and stationarity gates, and
    JAX's fit within FIT_RTOL."""
    r = _simulate_garch(2e-5, 0.12, 0.80, 8000, 0)
    est = fit_garch(r, n_iters=800, device="cpu")
    want = jfit(r, n_iters=800)
    np.testing.assert_allclose(est, want, rtol=FIT_RTOL)
    assert abs(est.alpha - 0.12) < 0.05 and abs(est.beta - 0.80) < 0.08
    assert 0.3 * 2e-5 < est.omega < 3 * 2e-5
    assert abs((est.alpha + est.beta) - 0.92) < 0.05
    noise = np.random.default_rng(1).normal(0, 0.01, 2000)
    est = fit_garch(noise, n_iters=300, device="cpu")
    np.testing.assert_allclose(est, jfit(noise, n_iters=300), rtol=FIT_RTOL)
    assert est.omega > 0 and est.alpha > 0 and est.beta > 0
    assert est.alpha + est.beta < 1.0


# --- VaR ---------------------------------------------------------------------

def _warned(fn, *args, **kw):
    """(fn's result, the messages of the warnings it raised)."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(m.message) for m in w]


def _check_var(got, want):
    assert sorted(got) == sorted(want)
    assert got["n_paths"] == want["n_paths"]
    for k, v in want["percentiles"].items():
        np.testing.assert_allclose(got["percentiles"][k], v, rtol=SUM_RTOL)
    _check_return(got["expected_return"], want["expected_return"])
    for k, v in want.items():
        if k not in ("percentiles", "n_paths", "expected_return"):
            np.testing.assert_allclose(got[k], v, rtol=SUM_RTOL, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("kind", ["gbm", "garch"])
def test_portfolio_var_on_device_matches_jax(data, kind):
    """2^16 paths in chunks of 2^14 against JAX's fori_loop: the pilot
    range, the bins and the counts are the same; the moments reduce in
    each framework's order."""
    if kind == "garch":
        jp, tp = _pair(data)
    else:
        jp = JGBM.create(100.0, 0.05, 0.25, 1 / 252)
        tp = GBM.create(100.0, 0.05, 0.25, 1 / 252, device="cpu")
    s0 = float(tp.s0)
    kw = dict(seed=3, bins=1024, chunk_paths=1 << 14)
    got, w_port = _warned(portfolio_var_on_device, tp, 1 << 16, 20, s0, **kw)
    want, w_jax = _warned(jvar, jp, 1 << 16, 20, s0, **kw)
    assert len(w_port) == len(w_jax)
    _check_var(got, want)
    assert got["sketch_oob_fraction"] == 0.0


def test_portfolio_var_rerange_and_explicit_range():
    """A range that misses the tail: explicit, the values are counted out
    of range and a warning says so; auto-ranged re-runs cover them.  The
    same on both sides."""
    jp = JGBM.create(100.0, 0.05, 0.25, 1 / 252)
    tp = GBM.create(100.0, 0.05, 0.25, 1 / 252, device="cpu")
    kw = dict(seed=1, bins=512, chunk_paths=1 << 13, lo=95.0, hi=105.0)
    got, w_port = _warned(portfolio_var_on_device, tp, 1 << 14, 20, 100.0,
                          **kw)
    want, w_jax = _warned(jvar, jp, 1 << 14, 20, 100.0, **kw)
    assert any("outside the explicit" in m for m in w_port)
    assert len(w_port) == len(w_jax)
    assert got["sketch_oob_fraction"] > 0.1
    _check_var(got, want)
    with pytest.raises(ValueError, match="multiple of chunk_paths"):
        portfolio_var_on_device(tp, 1000, 5, 100.0, chunk_paths=300)


def test_var_cli_matches_jax(capsys):
    flags = ["--on-device", "--paths", "65536", "--chunk", "16384",
             "--bins", "2048", "--seed", "2"]
    assert jax_main(["var", *flags]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert port_main(["var", *flags, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _check_var(got, want)


@pytest.mark.parametrize("argv,match", [
    (["var", "--ticker", "AAPL", "--device", "cpu"], "item 12"),
    (["var", "--on-device", "--ticker", "AAPL", "--device", "cpu"],
     "item 12"),
])
def test_var_unported_routes_exit_with_a_message(argv, match, capsys):
    with pytest.raises(SystemExit, match=match):
        port_main(argv)
    assert capsys.readouterr().out == ""


def test_var_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main(["var", "--on-device", "--paths", "4096"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        portfolio_var_on_device(GBM.create(100.0, 0.05, 0.25, 1 / 252), 4096,
                                5, 100.0)
    assert capsys.readouterr().out == ""


def test_python_dash_m_var_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "montecarlo_tpu_torch", "var", "--on-device",
         "--device", "cpu", "--paths", "16384", "--chunk", "8192",
         "--bins", "1024"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n_paths"] == 16384 and 0 < res["var_95"] < 100
    assert res["cvar_95"] > res["var_95"]
