"""``parallel/sharded.py::sharded_price_and_greeks`` across meshes of 1, 2
and 4 gloo ranks and against the JAX package's.

One spawn of 4 gloo ranks (``tests/torch_sharded_greeks_ranks.py``, which
imports neither JAX nor the root conftest) builds a mesh of each size over
consecutive ranks and differentiates GBM and Heston (a leaf a path, one
backward pass a shard) and the bootstrap GARCH (its table leaf: one
backward pass a block) in each.  JAX's side runs here, on 4 of its
virtual CPU devices, while the ranks run.

Tolerances, and why:

- Across meshes and ranks: bitwise (price, std-err, every gradient and its
  error), the contract.
- Against the unsharded ``price_and_greeks`` (one ``torch.mean`` and one
  backward over every path, summed in the library's order): price and
  gradients within rtol 1e-5.
- Against JAX's: the paths' terminal prices agree within ~2e-6 relative
  (the normals within 4.8e-7) and the block means are summed in another
  order: price and std-err within rtol 1e-5 (tests/test_torch_sharded.py's
  EST_RTOL), gradients within rtol 1e-4 and 1e-6 absolute, their
  blockwise errors (square roots of sums of squared differences of close
  block means) within rtol 1e-3.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo_tpu.parallel import make_mesh as jmake_mesh
from montecarlo_tpu.parallel import sharded as jsh
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu_torch.engine.greeks import price_and_greeks

from tests import torch_sharded_greeks_ranks as R

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
F32 = jnp.float32


def _jax_refs() -> dict:
    mesh = jmake_mesh(n_path_shards=WORLD)
    call = lambda s: jnp.maximum(s - R.STRIKE, 0.0)
    procs = {"gbm": JGBM.create(*R.GBM_ARGS, dtype=F32),
             "heston": JHeston.create(**R.HESTON_KW, dtype=F32)}
    return {k: jsh.sharded_price_and_greeks(
        p, call, R.N_PATHS, R.N_STEPS, seed=11, mesh=mesh,
        discount=R.DISCOUNT, block_size=R.BLOCK, dtype=F32)
        for k, p in procs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results of one 4-rank gloo spawn, JAX's references),
    JAX's computed here while the ranks run."""
    out = tmp_path_factory.mktemp("greek_ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    logs = [open(out / f"log{r}.txt", "wb") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_greeks_ranks.py"),
         str(r), str(WORLD), str(out / "init"), str(out)], cwd=ROOT, env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    deadline = time.monotonic() + 240
    try:
        refs = _jax_refs()
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
    import torch

    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)], refs


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["gbm", "heston", "garch"])
def test_bitwise_across_meshes_and_ranks(runs, kind):
    ranks, _ = runs
    want = ranks[0][1][kind]
    assert float(want["n_paths"]) == (R.GARCH_PATHS if kind == "garch"
                                      else R.N_PATHS)
    for r, res in enumerate(ranks):
        for size in R.SIZES:
            assert _same(res[size][kind], want), (r, size)
    assert want["grads"]["s0"] > 0 and want["grad_std_err"]["s0"] > 0


@pytest.mark.parametrize("kind", ["gbm", "heston", "garch"])
def test_close_to_the_unsharded_greeks(runs, kind):
    ranks, _ = runs
    got = ranks[0][4][kind]
    proc = R.processes()[kind]
    n = R.GARCH_PATHS if kind == "garch" else R.N_PATHS
    price, grads = price_and_greeks(proc, R.call, n, R.N_STEPS, seed=11,
                                    discount=R.DISCOUNT)
    np.testing.assert_allclose(got["price"], float(price), rtol=1e-5)
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g, getattr(grads, k).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_matches_jax(runs, kind):
    ranks, refs = runs
    got, want = ranks[0][4][kind], refs[kind]
    for k in ("price", "std_err", "n_paths"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   err_msg=k)
    jg, je = want["grads"]._asdict(), want["grad_std_err"]._asdict()
    assert set(got["grads"]) == set(jg)
    for k in jg:
        np.testing.assert_allclose(got["grads"][k], float(jg[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["grad_std_err"][k], float(je[k]),
                                   rtol=1e-3, err_msg=k)
