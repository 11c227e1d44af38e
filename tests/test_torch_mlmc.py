"""The port's multilevel Monte Carlo (``engine/mlmc.py``, ``price
--mlmc``) against the JAX package's ``engine/mlmc.py``.

Tolerances, and why:

- Per-path (Y_l, P_l) of ``_coupled_values`` on 4096 paths, Euler GBM and
  Heston, levels 1-3.  float64 (both sides' processes on float64 leaves,
  the JAX package's float64 draws: a uniform from all 32 bits and
  Box-Muller in float64): within 1e-12 absolute (payoffs of size 1-40;
  the two libraries' float64 log, sin and cos).  float32: within 5e-4
  absolute, 2e-6 of the price scale 250: the two packages' float32
  normals differ by up to ~5e-7 (each takes its platform's log, sin and
  cos), and a path of 8-32 fine steps carries that into its prices, whose
  ULP is 7.6e-6 at 100.  The largest difference over the eight float32
  cases is 3.8e-4 (Heston, level 2, Y; 1.5e-4 or less elsewhere), so the
  bound is 1.3 times it.
- The exact scheme's coupling (log-Euler GBM, float64): fine and coarse
  reach the same terminal, |mean Y| < 1e-9 and Var Y < 1e-18 (JAX's
  test's bounds).
- A level's moment states are 4096-path block states merged by the fixed
  tree, so a level is bitwise the same over 1, 2 and 4 gloo ranks and
  without a mesh (one spawn, ``tests/torch_mlmc_ranks.py``).
- ``mlmc_estimate`` in float64: the ladder (levels and every N_l) equal
  to JAX's, the price within 1e-12 relative; in float32 through the
  ``price --mlmc`` command (level 0 on K2's plain version) the ladder equal
  to the JAX command's, the price and std-err within rtol 1e-5 and the
  bias estimate (read off the finest levels' mean Y, ~1e-2, summed in
  float32 in another order) and the RMSE estimate it enters within 1e-5
  absolute.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu import cli as jcli
from montecarlo_tpu.engine import mlmc as jm
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import EulerGBM as JEuler
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu_torch import cli
from montecarlo_tpu_torch.engine import black_scholes_call
from montecarlo_tpu_torch.engine import mlmc as tm
from montecarlo_tpu_torch.processes import GBM, GARCHBootstrap

from tests import torch_mlmc_ranks as R

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
F64 = torch.float64
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _jmake(kind, dtype):
    def f(n):
        if kind == "euler":
            return JEuler.create(R.S0, R.R, R.SIGMA, R.T / n, dtype=dtype)
        if kind == "gbm":
            return JGBM.create(R.S0, R.R, R.SIGMA, R.T / n, dtype=dtype)
        return JHeston.create(s0=R.S0, v0=0.04, mu=R.R, kappa=1.5,
                              theta=0.04, xi=0.4, rho=-0.6, dt=R.T / n,
                              dtype=dtype)
    return f


def _exact(n):
    """Log-Euler GBM (exact) on float64 leaves."""
    import dataclasses

    vals = dict(s0=R.S0, mu=R.R, sigma=R.SIGMA, dt=R.T / n)
    return dataclasses.replace(GBM.create(**vals, device="cpu"), **{
        k: torch.tensor(v, dtype=F64) for k, v in vals.items()})


def _jcall(s):
    return jnp.maximum(s - R.STRIKE, 0.0)


# --- per-path values against JAX ------------------------------------------------

CASES = [(kind, dtype, level, on)
         for kind in ("euler", "heston")
         for dtype in (torch.float32, torch.float64)
         for level, on in ((1, "terminal"), (2, "terminal"), (2, "mean"),
                           (3, "terminal"))]


@pytest.mark.parametrize("kind,dtype,level,on", CASES)
def test_coupled_values_match_jax(kind, dtype, level, on):
    nf = R.N0 * 2 ** level
    jf, tf = _jmake(kind, JDT[dtype]), R.make(kind, dtype)
    jy, jp = jm._coupled_values(jf(nf), jf(nf // 2), _jcall, 4096, nf // 2,
                                2, 7, 3, JDT[dtype], 12345, on)
    ty, tp = tm._coupled_values(tf(nf), tf(nf // 2), R.call, 4096, nf // 2,
                                2, 7, 3, dtype, 12345, on)
    assert ty.dtype == dtype and ty.shape == (4096,)
    atol = 1e-12 if dtype == F64 else 5e-4
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=atol)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=atol)
    assert float(torch.abs(ty).max()) > 0


@pytest.mark.parametrize("on", ["terminal", "mean"])
def test_level0_moments_match_jax(on):
    """Level 0 (float32 through K2's or K4's plain version; float64 on the
    torch loop) against JAX's ``_level0_moments``."""
    for dtype, rtol in ((torch.float32, 2e-6), (F64, 1e-13)):
        st, _ = tm.mlmc_level_moments(R.make("euler", dtype), R.call, 0,
                                      8192, seed=5, n0_steps=R.N0,
                                      dtype=dtype, payoff_on=on)
        jst, _ = jm.mlmc_level_moments(_jmake("euler", JDT[dtype]), _jcall,
                                       0, 8192, seed=5, n0_steps=R.N0,
                                       dtype=JDT[dtype], payoff_on=on)
        assert st.mean.dtype == dtype
        np.testing.assert_allclose(float(st.mean), float(jst.mean),
                                   rtol=rtol)
        np.testing.assert_allclose(float(st.m2), float(jst.m2),
                                   rtol=10 * rtol)


def test_coupling_exact_for_exact_scheme():
    st_y, st_p = tm.mlmc_level_moments(_exact, R.call, level=3,
                                       n_paths=4096, seed=11, n0_steps=4,
                                       dtype=F64)
    assert abs(float(st_y.mean)) < 1e-9
    assert float(st_y.m2 / st_y.count) < 1e-18
    assert float(st_p.mean) > 0


def test_variance_decay_euler():
    vs = []
    for level in range(1, 5):
        st_y, _ = tm.mlmc_level_moments(R.make("euler", F64), R.call, level,
                                        n_paths=1 << 15, seed=5,
                                        n0_steps=4, dtype=F64)
        vs.append(float(st_y.m2 / (st_y.count - 1)))
    for v_prev, v_next in zip(vs, vs[1:]):
        assert v_next < 0.7 * v_prev, vs


def test_asian_variance_decay_exact_scheme():
    vs = []
    for level in (1, 2, 3):
        st_y, _ = tm.mlmc_level_moments(_exact, R.call, level,
                                        n_paths=1 << 14, seed=21,
                                        n0_steps=4, dtype=F64,
                                        payoff_on="mean")
        vs.append(float(st_y.m2 / (st_y.count - 1)))
    assert vs[1] < 0.5 * vs[0] and vs[2] < 0.5 * vs[1], vs


# --- the estimate ------------------------------------------------------------------

def test_estimate_ladder_matches_jax_and_black_scholes():
    """The CLI's seed 0, float64: every level's path count as JAX's and
    the price within 4 eps of Black-Scholes (JAX's test's gate)."""
    eps, disc = 0.05, math.exp(-R.R * R.T)
    want = jm.mlmc_estimate(_jmake("euler", jnp.float64), _jcall,
                            target_rmse=eps, seed=0, n0_steps=4,
                            discount=disc, dtype=jnp.float64)
    got = tm.mlmc_estimate(R.make("euler", F64), R.call, target_rmse=eps,
                           seed=0, n0_steps=4, discount=disc, dtype=F64)
    assert got["n_levels"] == want["n_levels"] >= 3
    assert ([l.n_paths for l in got["levels"]]
            == [l.n_paths for l in want["levels"]])
    for k in ("price", "std_err", "bias_est", "rmse_est", "alpha",
              "cost_path_steps", "single_level_cost_est"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-12,
                                   err_msg=k)
    bs = black_scholes_call(R.S0, R.STRIKE, R.R, R.SIGMA, R.T)
    assert abs(got["price"] - bs) < 4 * eps
    assert got["std_err"] <= eps
    assert got["levels"][0].n_paths > got["levels"][-1].n_paths
    assert got["cost_path_steps"] < got["single_level_cost_est"]


def test_estimate_is_bitwise_reproducible():
    """float32, level 0 through K2's plain version: one seed, one run."""
    runs = [tm.mlmc_estimate(R.make("euler"), R.call, target_rmse=0.1,
                             seed=42, n0_steps=4) for _ in range(2)]
    assert runs[0]["price"] == runs[1]["price"]
    assert runs[0]["std_err"] == runs[1]["std_err"]
    assert runs[0]["levels"] == runs[1]["levels"]


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("on", ["terminal", "mean"])
def test_estimate_runs_chunks_together_bitwise(dtype, on, monkeypatch):
    """The chunks a target needs, simulated in one run, give the bits of
    one run a chunk (the JAX package's loop): 4096-path chunks at level 0
    (block states), 2048-path chunks (``moments_from_array``) above it."""
    kw = dict(target_rmse=0.1, seed=3, n0_steps=4, chunk_paths=4096,
              dtype=dtype, payoff_on=on)
    together = tm.mlmc_estimate(R.make("euler", dtype), R.call, **kw)
    monkeypatch.setattr(tm, "RUN_PATHS", 1)
    alone = tm.mlmc_estimate(R.make("euler", dtype), R.call, **kw)
    assert together == alone
    assert together["levels"][0].n_paths >= 4 * 4096
    assert together["levels"][1].n_paths >= 2 * 2048


def test_refusals():
    rets = np.random.default_rng(0).normal(0, 0.01, size=300)
    with pytest.raises(TypeError, match="NormalDrawsMixin"):
        tm.mlmc_level_moments(lambda n: GARCHBootstrap.create(
            rets, s0=R.S0, var0=1e-4, device="cpu"), R.call, 1, 128, seed=1)
    with pytest.raises(ValueError, match="payoff_on"):
        tm.mlmc_level_moments(R.make("euler"), R.call, 1, 128,
                              payoff_on="max")
    with pytest.raises(ValueError, match="target_rmse"):
        tm.mlmc_estimate(R.make("euler"), R.call, target_rmse=0.0)


# --- the sharded level over gloo ranks ---------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of one 4-rank gloo spawn."""
    out = tmp_path_factory.mktemp("mlmc_ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    logs = [open(out / f"log{r}.txt", "wb") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mlmc_ranks.py"),
         str(r), str(WORLD), str(out / "init"), str(out)], cwd=ROOT, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + 240
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        log = (out / f"log{r}.txt").read_text()[-4000:]
        assert p.returncode == 0, (r, log)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _same(a, b) -> bool:
    return all(torch.equal(x, y) and x.dtype == y.dtype
               for sa, sb in zip(a, b) for x, y in zip(sa, sb))


@pytest.mark.parametrize("case", R.CASES, ids=[c[0] for c in R.CASES])
def test_sharded_level_bitwise_across_meshes_and_unsharded(ranks, case):
    want = R.level(*case)
    for r, res in enumerate(ranks):
        for size in R.SIZES:
            assert _same(res[size][case[0]], want), (r, size)


def test_sharded_estimate_rounds_chunks_to_the_shard_quantum(ranks):
    est = ranks[0]["estimate"]
    assert all(r["estimate"] == est for r in ranks)
    bs = black_scholes_call(R.S0, R.STRIKE, R.R, R.SIGMA, R.T)
    assert abs(est["price"] * math.exp(-R.R * R.T) - bs) < 4 * 0.08
    for lvl in est["levels"]:
        assert lvl[0] % (WORLD * 4096) == 0


def test_sharded_estimate_runs_chunks_together_bitwise(ranks):
    """Over the 4-rank mesh, 16384-path chunks simulated together give the
    bits of one chunk a run."""
    est = ranks[0]["estimate_16k"]
    assert est == ranks[0]["estimate_16k_chunk_a_run"]
    assert est["levels"][0][0] >= 4 * 16384


# --- the command ---------------------------------------------------------------------

def _run(main, argv, capsys):
    rc = main(argv)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("process", ["gbm", "heston"])
def test_cli_price_mlmc_matches_jax(process, capsys):
    argv = ["price", "--mlmc", "--mlmc-rmse", "0.05", "--process", process]
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    want = _run(jcli.main, argv, capsys)
    assert set(got) == set(want)
    assert got["level_paths"] == want["level_paths"]
    assert got["n_levels"] == want["n_levels"]
    for k in ("price", "std_err", "vs_single_level_cost"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    # The bias is read off the finest levels' mean Y (~1e-2): its float32
    # error is absolute, in price units, and enters the RMSE estimate.
    for k in ("bias_est", "rmse_est"):
        assert abs(got[k] - want[k]) < 1e-5, (k, got[k], want[k])
    if process == "gbm":
        assert abs(got["price"] - got["black_scholes"]) < 4 * 0.05


def test_cli_mlmc_refusals():
    with pytest.raises(SystemExit, match="mlmc-rmse"):
        cli.main(["price", "--mlmc", "--target-se", "1e-3", "--device",
                  "cpu"])
    with pytest.raises(SystemExit, match="gbm"):
        cli.main(["price", "--mlmc", "--process", "merton", "--device",
                  "cpu"])
    with pytest.raises(SystemExit, match="call/put"):
        cli.main(["price", "--mlmc", "--payoff", "asian", "--device",
                  "cpu"])
