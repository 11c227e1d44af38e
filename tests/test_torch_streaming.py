"""The port's streaming estimator (``engine/streaming.py``), its
checkpoints, ``risk_from_state`` and ``api.var.portfolio_var`` against
themselves and against the JAX package, mirroring tests/test_streaming.py
and tests/test_fault_injection.py.

Which side the float64 reduce is compared to: the port's
``StreamingState.moments()`` reduces the host float64 block arrays in
float64; JAX's reduces them in its default float width, which is float64
here (the root conftest turns x64 on) and float32 in its CLI.  So the
tests hold the port's reduce to JAX's x64 reduce.

Tolerances, and why:

- Inside the port (one shot, chunked, resumed, replayed, over the
  ``.npz`` and the ``torch.save`` checkpoint): bitwise.
- A checkpoint written by JAX loads with every field equal.
- The same state through both frameworks' ``risk_from_state`` (float64
  on both sides; XLA:CPU may contract a merge into an FMA): rtol 1e-12.
- JAX's runs against the port's: a path's price is within rtol 2e-6 (the
  package's PRICE_RTOL), block sums run in each framework's order: means
  and std-errs within rtol 1e-5 (SUM_RTOL); a price moved by 2e-6 may
  change bins, so quantiles within one bin width.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pytest
import torch

from montecarlo_tpu.api import portfolio_var as jportfolio_var
from montecarlo_tpu.engine.streaming import risk_from_state as jrisk
from montecarlo_tpu.engine.streaming import streaming_estimate as jstreaming
from montecarlo_tpu.parallel import make_mesh as jmake_mesh
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import Merton as JMerton
from montecarlo_tpu_torch.api import portfolio_var
from montecarlo_tpu_torch.api.var import _pilot_range
from montecarlo_tpu_torch.engine import simulate, terminal_prices
from montecarlo_tpu_torch.engine.streaming import (StreamingState,
                                                   risk_from_state,
                                                   streaming_estimate)
from montecarlo_tpu_torch.parallel import block_moments, make_mesh
from montecarlo_tpu_torch.processes import GBM, Merton
from montecarlo_tpu_torch.stats.welford import (MomentState, moments_reduce,
                                                tree_sum)

N_STEPS = 16
CHUNK = 4096
TOTAL = 4 * CHUNK
BLOCK = 1024
GRID = dict(lo=40.0, hi=260.0, bins=512)
SUM_RTOL = 1e-5
RISK_RTOL = 1e-12
GBM_ARGS = (100.0, 0.03, 0.2, 1 / 252)
MERTON_ARGS = (100.0, 0.03, 0.15, 0.002, -2.5, 0.3, 1 / 252)


def _gbm():
    return GBM.create(*GBM_ARGS, device="cpu")


def _run(**kw):
    kw = {"chunk_paths": CHUNK, **kw}
    return streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=5,
                              block_size=BLOCK, **GRID, **kw)


def _jrun(**kw):
    return jstreaming(JGBM.create(*GBM_ARGS), TOTAL, N_STEPS, seed=5,
                      chunk_paths=CHUNK, block_size=BLOCK, **GRID, **kw)


def _same_state(a, b) -> None:
    for k in ("seed", "n_steps", "block_size", "paths_done"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("block_count", "block_mean", "block_m2"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    for k in a.sketch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a.sketch, k)),
                                      np.asarray(getattr(b.sketch, k)), k)


@pytest.fixture(scope="module")
def oneshot():
    return _run(chunk_paths=TOTAL)


def test_oneshot_equals_chunked_bitwise(oneshot):
    _same_state(_run(), oneshot)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_resume_equals_uninterrupted(tmp_path, oneshot, suffix):
    """Half a run, checkpointed (``.npz`` with JAX's keys, or
    ``torch.save``), then resumed to the end: bitwise the one-shot run."""
    ckpt = str(tmp_path / f"est{suffix}")
    half = streaming_estimate(_gbm(), TOTAL // 2, N_STEPS, seed=5,
                              chunk_paths=CHUNK, block_size=BLOCK, **GRID,
                              checkpoint_path=ckpt)
    assert half.paths_done == TOTAL // 2 and os.path.exists(ckpt)
    _same_state(StreamingState.load(ckpt), half)
    resumed = _run(checkpoint_path=ckpt, resume=True)
    assert resumed.paths_done == TOTAL
    _same_state(resumed, oneshot)
    assert [f for f in os.listdir(tmp_path)] == [f"est{suffix}"]


def test_stopped_by_the_callback_and_resumed(tmp_path, oneshot):
    """A run stopped by an exception from ``progress_callback`` after
    chunk 2 (its checkpoint written) resumes to the one-shot bits; with
    ``checkpoint_every=2`` a stop after chunk 3 re-runs chunk 3 from its
    path ids."""
    for every, stop in ((1, 2), (2, 3)):
        ckpt = str(tmp_path / f"stop{every}.npz")
        seen = []

        def stop_after(done, total, se):
            seen.append((done, total, se))
            if len(seen) == stop:
                raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            _run(checkpoint_path=ckpt, checkpoint_every=every,
                 progress_callback=stop_after)
        assert [s[0] for s in seen] == [CHUNK * (i + 1) for i in range(stop)]
        assert StreamingState.load(ckpt).paths_done == 2 * CHUNK
        _same_state(_run(checkpoint_path=ckpt, checkpoint_every=every),
                    oneshot)


def test_lost_chunk_replayed_from_counters(oneshot):
    """tests/test_fault_injection.py's repair: chunk 1's block states are
    lost, re-run from its path-id range alone, bitwise the rows they
    replace, and the repaired reduce is bitwise whole."""
    ref = _run()
    bpc = CHUNK // BLOCK
    lost = slice(bpc, 2 * bpc)
    mean, m2 = ref.block_mean.copy(), ref.block_m2.copy()
    mean[lost] = m2[lost] = 0.0
    terminal = terminal_prices(_gbm(), CHUNK, N_STEPS, seed=5,
                               path_offset=CHUNK)
    blocks = block_moments(terminal, BLOCK)
    np.testing.assert_array_equal(blocks.mean.numpy().astype(np.float64),
                                  ref.block_mean[lost])
    np.testing.assert_array_equal(blocks.m2.numpy().astype(np.float64),
                                  ref.block_m2[lost])
    mean[lost] = blocks.mean.numpy()
    m2[lost] = blocks.m2.numpy()
    repaired = StreamingState(
        seed=ref.seed, n_steps=ref.n_steps, block_size=ref.block_size,
        paths_done=ref.paths_done, block_count=ref.block_count,
        block_mean=mean, block_m2=m2, sketch=ref.sketch)
    for a, b in zip(repaired.moments(), oneshot.moments()):
        assert torch.equal(a, b)


def test_jax_checkpoint_loads_and_resumes(tmp_path, oneshot):
    """A ``.npz`` written by JAX's ``StreamingState.save`` loads with every
    field equal and resumes: its chunks stay JAX's, the rest are the
    port's own, bitwise; the merged mean within SUM_RTOL of JAX's whole
    run."""
    ckpt = str(tmp_path / "jax.npz")
    half = jstreaming(JGBM.create(*GBM_ARGS), TOTAL // 2, N_STEPS, seed=5,
                      chunk_paths=CHUNK, block_size=BLOCK, **GRID,
                      checkpoint_path=ckpt)
    loaded = StreamingState.load(ckpt)
    _same_state(loaded, half)
    resumed = _run(checkpoint_path=ckpt)
    n = len(half.block_mean)
    np.testing.assert_array_equal(resumed.block_mean[:n], half.block_mean)
    np.testing.assert_array_equal(resumed.block_mean[n:],
                                  oneshot.block_mean[n:])
    whole = _jrun()
    np.testing.assert_allclose(float(resumed.moments().mean),
                               float(whole.moments().mean), rtol=SUM_RTOL)


def test_mismatched_checkpoints_raise(tmp_path):
    """Another seed, another grid, a chunk that does not divide the
    checkpoint's paths: each raises, as in the JAX package."""
    ckpt = str(tmp_path / "s.npz")
    streaming_estimate(_gbm(), CHUNK, N_STEPS, seed=5, chunk_paths=CHUNK,
                       block_size=BLOCK, **GRID, checkpoint_path=ckpt)
    base = dict(chunk_paths=CHUNK, block_size=BLOCK, checkpoint_path=ckpt)
    with pytest.raises(ValueError, match="config"):
        streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=6, **GRID, **base)
    with pytest.raises(ValueError, match="grid"):
        streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=5, lo=40.0,
                           hi=300.0, bins=512, **base)
    with pytest.raises(ValueError, match="not a multiple of chunk_paths"):
        streaming_estimate(_gbm(), 3 * CHUNK, N_STEPS, seed=5, **GRID,
                           **{**base, "chunk_paths": 3 * BLOCK})
    with pytest.raises(ValueError, match="chunk_paths"):
        streaming_estimate(_gbm(), TOTAL, N_STEPS, seed=5, **GRID,
                           chunk_paths=CHUNK + 1, block_size=BLOCK)


def test_early_stop_at_target_std_err():
    assert _run(target_std_err=1.0).paths_done == CHUNK


def test_stream_matches_jax(oneshot):
    """JAX's stream against the port's: the same grid and path count,
    means and std-errs within SUM_RTOL; the float64 reduces of one state
    agree within RISK_RTOL."""
    want = _jrun()
    got = oneshot.moments()
    for k in ("count", "mean", "m2"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(want.moments(), k)),
                                   rtol=SUM_RTOL, err_msg=k)
    assert abs(np.asarray(oneshot.sketch.counts)
               - np.asarray(want.sketch.counts)).sum() <= 4
    same = StreamingState(**{k: getattr(want, k) for k in (
        "seed", "n_steps", "block_size", "paths_done", "block_count",
        "block_mean", "block_m2", "sketch")})
    for k in ("count", "mean", "m2"):
        np.testing.assert_allclose(float(getattr(same.moments(), k)),
                                   float(getattr(want.moments(), k)),
                                   rtol=RISK_RTOL, err_msg=k)


@pytest.mark.parametrize("prices", [True, False])
def test_risk_from_state_matches_jax(prices):
    """The same state (JAX's run) through both ``risk_from_state``s; the
    port's own run against exact percentiles of its terminals."""
    jstate = _jrun(payoff_fn=None if prices else (lambda s: s * 0.5))
    state = StreamingState(**{k: getattr(jstate, k) for k in (
        "seed", "n_steps", "block_size", "paths_done", "block_count",
        "block_mean", "block_m2", "sketch")})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = risk_from_state(state, 100.0, moments_are_prices=prices)
        want = jrisk(jstate, 100.0, moments_are_prices=prices)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "percentiles":
            for q, x in v.items():
                np.testing.assert_allclose(got[k][q], x, rtol=RISK_RTOL)
        else:
            np.testing.assert_allclose(got[k], float(v), rtol=RISK_RTOL,
                                       atol=1e-12, err_msg=k)
    terminal = simulate(_gbm(), TOTAL, N_STEPS, seed=5).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        own = risk_from_state(_run(), 100.0)
    assert own["n_paths"] == TOTAL
    for q in (5, 50, 95):
        assert abs(own["percentiles"][f"p{q}"] - np.percentile(terminal, q)) \
            < 3 * (GRID["hi"] - GRID["lo"]) / GRID["bins"]


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, [str(m.message) for m in w]


def _check_var(got, want, width):
    assert got.keys() == want.keys() and got["n_paths"] == want["n_paths"]
    for k, v in want["percentiles"].items():
        assert abs(got["percentiles"][k] - v) <= width, k
    for k in ("expected_return", "expected_vol", "std_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=SUM_RTOL, atol=1e-6,
                                   err_msg=k)
    assert got["sketch_oob_fraction"] == want["sketch_oob_fraction"]


@pytest.mark.parametrize("route", ["sketch", "stream"])
def test_portfolio_var_matches_jax(route):
    """Both routes on GBM: the sketch pass on a one-rank mesh (JAX's on
    its 8 devices) and the stream in chunks; the routes agree with each
    other as in tests/test_streaming.py."""
    kw = dict(seed=5, bins=512, block_size=BLOCK)
    if route == "sketch":
        got, _ = _quiet(portfolio_var, _gbm(), TOTAL, N_STEPS, 100.0,
                        mesh=make_mesh(device="cpu"), **kw)
        want, _ = _quiet(jportfolio_var, JGBM.create(*GBM_ARGS), TOTAL,
                         N_STEPS, 100.0, mesh=jmake_mesh(8), **kw)
    else:
        got, _ = _quiet(portfolio_var, _gbm(), TOTAL, N_STEPS, 100.0,
                        chunk_paths=CHUNK, **kw)
        want, _ = _quiet(jportfolio_var, JGBM.create(*GBM_ARGS), TOTAL,
                         N_STEPS, 100.0, chunk_paths=CHUNK, **kw)
    lo, hi = _pilot_range(_gbm(), N_STEPS, 5)
    _check_var(got, want, (hi - lo) / 512)


def test_portfolio_var_reranges_a_fat_jump_tail(tmp_path):
    """Merton with rare deep down-jumps: the 4096-path pilot misses the
    tail, both routes re-run once on the observed range and leave nothing
    off the grid, as JAX's; a checkpointed run keeps its grid and warns;
    CVaR within the widened grid's resolution of the exact tail mean."""
    proc = Merton.create(*MERTON_ARGS, device="cpu")
    n, days, seed, bins = 1 << 15, 8, 5, 2048
    terminal = simulate(proc, n, days, seed=seed).numpy()
    lo_pilot, _ = _pilot_range(proc, days, seed)
    assert (terminal < lo_pilot).mean() > 1e-6
    p5 = np.percentile(terminal, 5.0)
    exact_cvar = 100.0 - terminal[terminal <= p5].mean()
    tol = 5 * 1.5 * (terminal.max() - terminal.min()) / bins
    kw = dict(seed=seed, bins=bins, block_size=BLOCK)
    for extra in ({"mesh": make_mesh(device="cpu")},
                  {"chunk_paths": 1 << 13}):
        got, _ = _quiet(portfolio_var, proc, n, days, 100.0, **kw, **extra)
        assert got["sketch_oob_fraction"] == 0.0
        assert abs(got["cvar_95"] - exact_cvar) < tol
    want, _ = _quiet(jportfolio_var, JMerton.create(*MERTON_ARGS), n, days,
                     100.0, chunk_paths=1 << 13, **kw)
    assert want["sketch_oob_fraction"] == 0.0
    np.testing.assert_allclose(got["cvar_95"], want["cvar_95"], rtol=1e-4)
    got, msgs = _quiet(portfolio_var, proc, n, days, 100.0, **kw,
                       chunk_paths=1 << 13,
                       checkpoint_path=str(tmp_path / "merton.npz"))
    assert got["sketch_oob_fraction"] > 1e-6
    assert any("outside the explicit sketch range" in m for m in msgs)


def test_empty_reductions_give_the_zero_state():
    """``moments_reduce`` and ``tree_sum`` over an empty leading axis give
    the zero state and zero (the JAX package raises IndexError there), so
    a stream that has done no chunk reduces to zero."""
    for dt in (torch.float32, torch.float64):
        z = torch.zeros((0, 3), dtype=dt)
        st = moments_reduce(MomentState(z, z, z))
        for v in st:
            assert v.shape == (3,) and v.dtype == dt and not v.any()
        assert torch.equal(tree_sum(torch.ones(2, 0), axis=1),
                           torch.zeros(2))
        assert tree_sum(torch.zeros(0, dtype=dt)).item() == 0.0
    empty = streaming_estimate(_gbm(), 0, N_STEPS, seed=5, chunk_paths=CHUNK,
                               block_size=BLOCK, **GRID)
    assert empty.paths_done == 0
    assert [float(v) for v in empty.moments()] == [0.0, 0.0, 0.0]
