"""The port's meshes and sharded estimators (``montecarlo_tpu_torch/
parallel/``) against themselves across meshes and against the JAX package.

One spawn of 8 gloo ranks (``tests/torch_sharded_ranks.py``, which imports
neither JAX nor the root conftest) builds, side by side, flat meshes of 1,
2, 4 and 8 ranks, (slices 2 x paths 2) and (slices 2 x paths 4), and
(paths 2 x assets 2) and (paths 4 x assets 2), and runs every estimator in
each.  JAX's side runs here, on its 8 virtual CPU devices.

Tolerances, and why:

- Inside the port, across every flat and sliced mesh and every rank:
  bitwise (``sharded_mc_estimate`` on GBM, Heston, MultiGBM through the
  torch loop and under a ``SobolDeviceSampler``, the functional and
  rough-Bergomi estimates, the Vasicek zero-coupon bond (bitwise the
  unsharded run's block states too), the sketch, the percentile curves, the
  gathered terminals, the streaming route); the basket across path
  shardings at a fixed asset sharding.
- Against JAX: a path's terminal price is within rtol 2e-6 (the port's
  single-device parity tests' PRICE_RTOL: XLA:CPU contracts FMAs, the
  normals take each platform's log, sin and cos), and the block means are
  summed in another order (the port's ``tree_sum`` against ``jnp.mean``):
  prices and std-errs within rtol 1e-5, the tolerance of
  tests/test_torch_pricing.py's estimates.  Rough Bergomi's paths are
  within SIM_RTOL = 1e-5 (tests/test_torch_rbergomi.py): its estimates
  within rtol 1e-4, the JAX package's own sharded-against-unsharded bound
  (tests/test_sharded_rbergomi.py).  Sketch quantiles and percentile
  curves within one bin width (a price that moves by 2e-6 may change
  bins); their moments within rtol 1e-5.
- The sharded LSM and Andersen-Broadie dual (``sharded_lsm_price``,
  ``sharded_andersen_broadie_bound``), float32 and float64: bitwise across
  every mesh and rank like the rest, the dual bitwise the unsharded
  per-path maxima's block states; in float64 (float64 leaves and draws on
  both sides) within rtol 1e-9 of JAX's sharded versions on its 8 virtual
  devices (tests/test_torch_american.py's float64 tolerance: ULPs of the
  platforms' log, sin and cos, sums in each library's order, no exercise
  decision flipped); the sharded LSM within 4 std-err of the unsharded
  ``lsm_price`` (the one-pass ITM std and block-ordered sums make it
  another estimator of the same policy family, as in JAX).
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
import torch

from montecarlo_tpu.engine import american as jamerican
from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.engine.path_sketch import (
    sharded_path_percentiles as jpercentiles)
from montecarlo_tpu.parallel import make_mesh as jmake_mesh
from montecarlo_tpu.parallel import sharded as jsh
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import BasketGBM as JBasket
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu.processes import Vasicek as JVasicek
from montecarlo_tpu.processes import MultiGBM as JMulti
from montecarlo_tpu.processes.rough_bergomi import RoughBergomi as JRB
from montecarlo_tpu.rng import sobol as jsobol
from montecarlo_tpu.stats.quantiles import sketch_quantile as jquantile
from montecarlo_tpu.stats.welford import MomentState as JMoments
from montecarlo_tpu.stats.welford import moments_merge as jmerge
from montecarlo_tpu.stats.welford import std_error as jstd_error
from montecarlo_tpu_torch.parallel import (Mesh, make_mesh,
                                           sharded_mc_estimate, sharded_terminal)
from montecarlo_tpu_torch.parallel.mesh import _check_backend
from montecarlo_tpu_torch.processes import GBM
from montecarlo_tpu_torch.stats.quantiles import (HistogramSketch,
                                                  sketch_quantile)

from tests import torch_sharded_ranks as R

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
EST_RTOL = 1e-5
RB_RTOL = 1e-4
PATH_LAYOUTS = ("flat1", "flat2", "flat4", "flat8", "s2p2", "s2p4")
#: Each port layout's JAX mesh.
JAX_MESH = {"flat8": dict(n_path_shards=8),
            "s2p4": dict(n_path_shards=4, n_slices=2),
            "p4a2": dict(n_path_shards=4, n_asset_shards=2)}


def _jprocs():
    return {"gbm": JGBM.create(*R.GBM_ARGS),
            "heston": JHeston.create(**R.HESTON_KW),
            "multigbm": JMulti.create(**{**R.MULTI_KW,
                                         "corr": np.array(R.MULTI_KW["corr"])})}


def _jax_refs() -> dict:
    """Every JAX-side estimate the tests hold the port to."""
    procs = _jprocs()
    refs = {}
    sobol = jsobol.SobolDeviceSampler.create(R.N_STEPS, 1,
                                             scramble_seed=R.SOBOL_SEED)
    max_call = lambda s: jnp.maximum(jnp.max(s, axis=-1) - R.STRIKE, 0.0)
    for layout in ("flat8", "s2p4"):
        kw = dict(seed=11, mesh=_jmesh(layout), block_size=R.BLOCK)
        for kind, proc, payoff, extra in (
                ("gbm", procs["gbm"], _jcall, {}),
                ("heston", procs["heston"], _jcall, {}),
                ("multigbm", procs["multigbm"], max_call, {}),
                ("sobol", procs["gbm"], _jcall, {"sampler": sobol})):
            refs[layout, kind] = jsh.sharded_mc_estimate(
                proc, payoff, R.N_PATHS, R.N_STEPS, **kw, **extra)
    refs["asian"] = jsh.sharded_functional_estimate(
        procs["gbm"], {"avg": jf.ARITH_MEAN},
        lambda o: jf.asian_call(o["avg"], R.STRIKE), R.N_PATHS, R.N_STEPS,
        seed=11, mesh=_jmesh("flat8"), block_size=R.BLOCK)
    refs["vasicek_zcb"] = jsh.sharded_functional_estimate(
        JVasicek.create(*R.VASICEK_ARGS, dtype=jnp.float32),
        {"I": jf.trapezoid_integral(R.VASICEK_ARGS[-1])},
        lambda o: jnp.exp(-o["I"]), R.N_PATHS, R.N_STEPS, seed=13,
        mesh=_jmesh("flat8"), block_size=R.BLOCK)
    refs["rbergomi"] = jsh.sharded_rbergomi_estimate(
        JRB.create(*R.RB_ARGS, n_steps=R.RB_STEPS, T=1.0),
        lambda s: jnp.maximum(s - 100.0, 0.0), R.RB_PATHS, seed=5,
        mesh=_jmesh("s2p4"), block_size=R.RB_BLOCK)
    refs["sketch"] = jsh.sharded_terminal_sketch(
        procs["gbm"], R.N_PATHS, R.N_STEPS, seed=7, mesh=_jmesh("s2p4"),
        lo=R.SK_LO, hi=R.SK_HI, bins=R.SK_BINS, block_size=R.BLOCK)
    refs["percentiles"] = jpercentiles(
        procs["gbm"], R.N_PATHS, R.PCT_STEPS, seed=2, mesh=_jmesh("flat8"),
        lo=60.0, hi=140.0, bins=R.PCT_BINS)
    jgbm = JGBM.create(**R.AM_GBM, dtype=jnp.float64)
    jput = lambda v: jnp.maximum(R.AM_STRIKE - v, 0.0)
    akw = dict(rate=R.AM_GBM["mu"], dt=R.AM_GBM["dt"], degree=3,
               dtype=jnp.float64)
    refs["lsm64"] = jsh.sharded_lsm_price(
        jgbm, jput, R.LSM_PATHS, R.LSM_STEPS, seed=1, mesh=_jmesh("flat8"),
        block_size=R.LSM_BLOCK, **akw)
    _, policy = jamerican.lsm_policy(jgbm, jput, R.POLICY_PATHS,
                                     R.LSM_STEPS, seed=1, **akw)
    refs["ab64"] = jsh.sharded_andersen_broadie_bound(
        jgbm, jput, policy, R.AB_OUTER, R.AB_INNER, R.LSM_STEPS, seed=2,
        mesh=_jmesh("s2p4"), block_size=R.AB_BLOCK, **akw)
    refs["basket"] = jsh.sharded_basket_estimate(
        JBasket.create(**{**R.BASKET_KW,
                          "corr": np.array(R.BASKET_KW["corr"])}),
        lambda v: jnp.maximum(v - R.BASKET_STRIKE, 0.0), R.BASKET_PATHS,
        R.BASKET_STEPS, seed=9, mesh=_jmesh("p4a2"),
        block_size=R.BASKET_BLOCK)
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the results of every rank of one 8-rank gloo spawn, JAX's
    references), JAX's computed here while the ranks run."""
    out = tmp_path_factory.mktemp("ranks")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    logs = [open(out / f"log{r}.txt", "wb") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_ranks.py"),
         str(r), str(WORLD), str(out / "init"), str(out)], cwd=ROOT,
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
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
        assert p.returncode == 0, (r, (out / f"log{r}.txt").read_text()[-4000:])
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)], refs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_refs(runs):
    return runs[1]


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _close(got, want, rtol, keys=("price", "std_err")):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   err_msg=k)
    assert float(got["n_paths"]) == float(want["n_paths"])


def _jmesh(layout):
    return jmake_mesh(**JAX_MESH[layout])


def _jcall(s):
    return jnp.maximum(s - R.STRIKE, 0.0)


# --- the meshes ------------------------------------------------------------

def test_meshes_lay_out_ranks_as_jax(ranks):
    """Shapes and coordinates: slice-major and row-major, as JAX's."""
    for r, res in enumerate(ranks):
        assert res["flat8"]["coords"] == {"paths": r}
        assert res["flat2"]["coords"] == {"paths": r % 2}
        assert res["s2p4"]["shape"] == {"slices": 2, "paths": 4}
        assert res["s2p4"]["coords"] == {"slices": r // 4, "paths": r % 4}
        assert res["s2p2"]["coords"] == {"slices": (r % 4) // 2,
                                         "paths": r % 2}
        assert res["p4a2"]["shape"] == {"paths": 4, "assets": 2}
        assert res["p4a2"]["coords"] == {"paths": r // 2, "assets": r % 2}
    for layout in ("flat8", "s2p4", "p4a2"):
        assert dict(_jmesh(layout).shape) == ranks[0][layout]["shape"]


@pytest.mark.parametrize("case", ["gbm", "heston", "multigbm", "sobol",
                                  "asian", "vasicek_zcb", "rbergomi",
                                  "sketch",
                                  "percentiles", "terminal", "half_b",
                                  "streaming", "var", "lsm32", "lsm64",
                                  "ab32", "ab64"])
def test_bitwise_across_every_mesh_and_rank(ranks, case):
    """Every flat mesh (1, 2, 4, 8 ranks) and sliced mesh gives every one
    of its ranks the same bits as the one-rank mesh."""
    want = ranks[0]["flat1"][case]
    for layout in PATH_LAYOUTS:
        for r in range(WORLD):
            assert _same(ranks[r][layout][case], want), (layout, r)


def test_two_axis_mesh_paths_sharding_matches_flat(ranks):
    for r in range(WORLD):
        for layout in ("p2a2", "p4a2"):
            assert _same(ranks[r][layout]["gbm"], ranks[0]["flat1"]["gbm"])


def test_basket_bitwise_across_path_shardings(ranks):
    """At two asset shards, 2 and 4 path shards give the same bits on every
    rank."""
    want = ranks[0]["p2a2"]["basket"]
    for r in range(WORLD):
        assert _same(ranks[r]["p2a2"]["basket"], want)
        assert _same(ranks[r]["p4a2"]["basket"], want)


def test_terminal_is_global_path_order(ranks):
    """The gathered terminals (slice-major on a sliced mesh) are the
    unsharded run's, bitwise."""
    gbm = GBM.create(*R.GBM_ARGS, device="cpu")
    from montecarlo_tpu_torch.engine import terminal_prices

    want = terminal_prices(gbm, R.N_PATHS, R.N_STEPS, seed=3).numpy()
    np.testing.assert_array_equal(ranks[0]["flat1"]["terminal"], want)


def test_mesh_errors_match_jax(ranks):
    """The refused meshes raise JAX's ValueErrors (ranks for devices)."""
    got = ranks[0]["errors"]
    for name, kw, phrase in (
            ("slices_range", dict(n_slices=9), "n_slices=9 must be in "
             "[1, 8]"),
            ("slices_assets", dict(n_path_shards=2, n_asset_shards=2,
                                   n_slices=2), "slices x assets meshes "
             "are not supported"),
            ("assets_range", dict(n_asset_shards=9), "n_asset_shards=9 "
             "must be in [1, 8]"),
            ("uneven", dict(n_asset_shards=3), "do not split evenly into "
             "n_asset_shards=3 x n_slices=1"),
            ("zero_paths", dict(n_path_shards=0), "n_path_shards=0 must be"
             " >= 1"),
            ("too_many", dict(n_path_shards=5, n_asset_shards=2),
             "mesh needs 10")):
        with pytest.raises(ValueError, match=phrase.replace("[", r"\[")
                           .replace("]", r"\]")):
            jmake_mesh(**kw)
        assert got[name].startswith("ValueError") and phrase in got[name], \
            (name, got[name])
    with pytest.raises(ValueError, match="power-of-two"):
        jsh.sharded_mc_estimate(
            JGBM.create(*R.GBM_ARGS), _jcall, 24 * R.BLOCK, R.N_STEPS,
            seed=1, mesh=jmake_mesh(n_path_shards=2, n_slices=2),
            block_size=R.BLOCK)
    assert "power-of-two number of stat blocks per slice" in got["two_level"]
    assert "got 12" in got["two_level"]


def test_one_rank_mesh_without_a_process_group():
    """No process group: one rank, no collective, the JAX guards."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"paths": 1} and mesh.backend is None
    assert mesh.groups == {"paths": None}
    with pytest.raises(ValueError, match="mesh needs 2 ranks, only 1"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="initialised process group"):
        make_mesh(group=object(), device="cpu")
    gbm = GBM.create(*R.GBM_ARGS, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        sharded_mc_estimate(gbm, R.call, 1000, 4, seed=0, mesh=mesh,
                            block_size=512)


def test_backend_device_mismatch_and_float_sums_raise():
    """NCCL takes CUDA tensors and gloo CPU tensors: a mismatch raises and
    nothing moves; a float sum is refused; so is a tensor or a process on
    another device than the mesh's."""
    with pytest.raises(ValueError, match="cannot run collectives on cpu"):
        _check_backend("nccl", torch.device("cpu"))
    with pytest.raises(ValueError, match="cannot run collectives on cuda"):
        _check_backend("gloo", torch.device("cuda", 0))
    _check_backend("cuda:nccl,cpu:gloo", torch.device("cpu"))
    mesh = make_mesh(device="cpu")
    with pytest.raises(TypeError, match="float sum"):
        mesh.all_reduce(torch.ones(3), "sum", "paths")
    assert torch.equal(mesh.all_reduce(torch.arange(3), "sum", "paths"),
                       torch.arange(3))
    with pytest.raises(ValueError, match="never move"):
        mesh.all_gather(torch.ones(3, device="meta"), "paths")
    meta = Mesh(shape={"paths": 1}, coords={"paths": 0},
                device=torch.device("meta"), groups={"paths": None},
                backend=None)
    gbm = GBM.create(*R.GBM_ARGS, device="cpu")
    with pytest.raises(ValueError, match="the process lies on cpu"):
        sharded_terminal(gbm, 1024, 4, seed=0, mesh=meta)


def test_no_float_all_reduce_in_parallel():
    """``torch.distributed.all_reduce`` is called in one place only, the
    mesh's, which refuses a float sum."""
    src = "".join(p.read_text() for p in
                  (ROOT / "montecarlo_tpu_torch" / "parallel").glob("*.py"))
    assert src.count("dist.all_reduce(") == 1
    assert "all_gather_into_tensor" not in src


# --- against the JAX package ---------------------------------------------

@pytest.mark.parametrize("kind", ["gbm", "heston", "multigbm", "sobol"])
@pytest.mark.parametrize("layout", ["flat8", "s2p4"])
def test_mc_estimate_matches_jax(ranks, jax_refs, kind, layout):
    _close(ranks[0][layout][kind], jax_refs[layout, kind], EST_RTOL)


def test_functional_estimate_matches_jax(ranks, jax_refs):
    _close(ranks[0]["flat8"]["asian"], jax_refs["asian"], EST_RTOL)


def test_vasicek_zcb_bitwise_unsharded_and_matches_jax(ranks, jax_refs):
    """The sharded Vasicek zero-coupon bond (every mesh gives the one-rank
    mesh's bits, above) is the unsharded run's: K4's discount integral on
    all the paths, 1024-path block states merged by the fixed tree,
    bitwise; and JAX's sharded estimate within EST_RTOL."""
    from montecarlo_tpu_torch.engine import (simulate_functionals,
                                             trapezoid_integral)
    from montecarlo_tpu_torch.parallel import block_moments
    from montecarlo_tpu_torch.processes import Vasicek
    from montecarlo_tpu_torch.stats.welford import moments_reduce, std_error

    model = Vasicek.create(*R.VASICEK_ARGS, device="cpu")
    out = simulate_functionals(
        model, R.N_PATHS, R.N_STEPS, seed=13,
        functionals={"I": trapezoid_integral(R.VASICEK_ARGS[-1])})
    want = moments_reduce(block_moments(torch.exp(-out["I"]), R.BLOCK))
    got = ranks[0]["flat8"]["vasicek_zcb"]
    np.testing.assert_array_equal(got["price"], want.mean.numpy())
    np.testing.assert_array_equal(got["std_err"], std_error(want).numpy())
    _close(got, jax_refs["vasicek_zcb"], EST_RTOL)


def test_rbergomi_estimate_matches_jax(ranks, jax_refs):
    _close(ranks[0]["s2p4"]["rbergomi"], jax_refs["rbergomi"], RB_RTOL)


def test_sketch_matches_jax(ranks, jax_refs):
    sk_j, mo_j = jax_refs["sketch"]
    got = ranks[0]["s2p4"]["sketch"]
    assert got["counts"].dtype == np.int64
    assert int(got["counts"].sum()) == int(np.asarray(sk_j.counts).sum())
    assert float(got["total"]) == float(sk_j.total) == R.N_PATHS
    assert float(got["underflow"]) == float(sk_j.underflow)
    assert float(got["overflow"]) == float(sk_j.overflow)
    sk = HistogramSketch(**{k: torch.as_tensor(got[k])
                            for k in HistogramSketch._fields})
    width = (R.SK_HI - R.SK_LO) / R.SK_BINS
    for q in (1.0, 5.0, 50.0, 95.0, 99.0):
        assert abs(float(sketch_quantile(sk, q))
                   - float(jquantile(sk_j, q))) <= width, q
    for k in ("vmin", "vmax"):
        np.testing.assert_allclose(got[k], float(getattr(sk_j, k)),
                                   rtol=2e-6)
    for k in ("count", "mean", "m2"):
        np.testing.assert_allclose(got[f"m_{k}"], float(getattr(mo_j, k)),
                                   rtol=EST_RTOL)


def test_path_percentiles_match_jax(ranks, jax_refs):
    want = jax_refs["percentiles"]
    got = ranks[0]["flat8"]["percentiles"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=80.0 / R.PCT_BINS, err_msg=k)


def test_basket_matches_jax_and_the_unsharded_loop(ranks, jax_refs):
    """Against JAX's (paths 4 x assets 2) basket within EST_RTOL; the
    port's own unsharded torch loop of the same basket within float
    round-off (the partial sums group by asset shard)."""
    from montecarlo_tpu_torch.engine import simulate
    from montecarlo_tpu_torch.processes import BasketGBM

    got = ranks[0]["p4a2"]["basket"]
    _close(got, jax_refs["basket"], EST_RTOL)
    tb = BasketGBM.create(**R.BASKET_KW, device="cpu")
    vals = torch.clamp(simulate(tb, R.BASKET_PATHS, R.BASKET_STEPS, seed=9)
                       - R.BASKET_STRIKE, min=0.0).double()
    np.testing.assert_allclose(float(got["price"]), float(vals.mean()),
                               rtol=EST_RTOL)


def test_basket_one_asset_shard_is_the_unsharded_loop_bitwise():
    """With one asset shard the basket's step is the unsharded step
    (zeros above the factor's diagonal add nothing): the block states of
    the torch loop's basket values, bitwise."""
    from montecarlo_tpu_torch.engine import simulate
    from montecarlo_tpu_torch.parallel import (block_moments,
                                               sharded_basket_estimate)
    from montecarlo_tpu_torch.processes import BasketGBM
    from montecarlo_tpu_torch.stats.welford import moments_reduce

    tb = BasketGBM.create(**R.BASKET_KW, device="cpu")
    payoff = lambda v: torch.clamp(v - R.BASKET_STRIKE, min=0.0)
    got = sharded_basket_estimate(tb, payoff, 4096, 8, seed=9,
                                  mesh=make_mesh(device="cpu"),
                                  block_size=R.BASKET_BLOCK)
    want = moments_reduce(block_moments(
        payoff(simulate(tb, 4096, 8, seed=9)), R.BASKET_BLOCK))
    assert torch.equal(got["price"], want.mean)


def test_path_offset_chunks_compose(ranks):
    """Two half runs merge to the full run, as in JAX's chunking test; the
    offset half is bitwise the one-rank run at that offset."""
    gbm = GBM.create(*R.GBM_ARGS, device="cpu")
    mesh = make_mesh(device="cpu")
    kw = dict(seed=17, mesh=mesh, block_size=R.BLOCK)
    full = sharded_mc_estimate(gbm, R.call, R.N_PATHS, R.N_STEPS, **kw)
    a = sharded_mc_estimate(gbm, R.call, R.N_PATHS // 2, R.N_STEPS, **kw)
    b = ranks[0]["flat8"]["half_b"]
    assert _same(b, {k: v.numpy() for k, v in sharded_mc_estimate(
        gbm, R.call, R.N_PATHS // 2, R.N_STEPS,
        path_offset=R.N_PATHS // 2, **kw).items()})
    n = R.N_PATHS // 2
    sa, sb = (JMoments(count=jnp.float32(n), mean=jnp.float32(x["price"]),
                       m2=jnp.square(jnp.float32(x["std_err"]))
                       * n * (n - 1)) for x in (a, b))
    merged = jmerge(sa, sb)
    assert abs(float(merged.mean) - float(full["price"])) < 1e-5
    assert abs(float(jstd_error(merged)) - float(full["std_err"])) \
        < 2e-3 * float(full["std_err"])


def test_streaming_over_a_mesh_matches_local(ranks):
    """The streaming route over a mesh gathers each chunk's terminals:
    the same block states and counts as a one-process stream, bitwise
    (tests/test_torch_streaming.py holds that stream against JAX's)."""
    from montecarlo_tpu_torch.engine.streaming import streaming_estimate

    gbm = GBM.create(*R.GBM_ARGS, device="cpu")
    local = streaming_estimate(gbm, R.ST_TOTAL, R.ST_STEPS, seed=5,
                               chunk_paths=R.ST_CHUNK,
                               block_size=R.ST_BLOCK, lo=R.ST_LO,
                               hi=R.ST_HI, bins=R.ST_BINS)
    got = ranks[0]["s2p4"]["streaming"]
    np.testing.assert_array_equal(got["block_mean"], local.block_mean)
    np.testing.assert_array_equal(got["block_m2"], local.block_m2)
    np.testing.assert_array_equal(got["counts"], local.sketch.counts)


@pytest.mark.parametrize("case,layout,keys", [
    ("lsm64", "flat8", ("price", "std_err")),
    ("ab64", "s2p4", ("upper", "std_err"))])
def test_sharded_american_matches_jax(ranks, jax_refs, case, layout, keys):
    _close(ranks[0][layout][case], jax_refs[case], 1e-9, keys=keys)


@pytest.mark.parametrize("tag,dtype", [("32", torch.float32),
                                       ("64", torch.float64)])
def test_sharded_dual_is_the_unsharded_maxima(ranks, tag, dtype):
    """The sharded dual's bound is the block states of the unsharded
    per-path maxima (``_ab_best`` over every outer id), bitwise."""
    from montecarlo_tpu_torch.engine.american import _ab_best, lsm_policy
    from montecarlo_tpu_torch.engine.simulate import path_ids_for
    from montecarlo_tpu_torch.parallel import block_moments
    from montecarlo_tpu_torch.stats.welford import moments_reduce, std_error

    gbm = R.american_gbm(dtype)
    kw = dict(rate=R.AM_GBM["mu"], dt=R.AM_GBM["dt"], degree=3, dtype=dtype)
    # The ranks' policy: their library sums run on one thread.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, policy = lsm_policy(gbm, R.put, R.POLICY_PATHS, R.LSM_STEPS,
                               seed=1, **kw)
    finally:
        torch.set_num_threads(threads)
    best = _ab_best(gbm, R.put, policy, path_ids_for(R.AB_OUTER),
                    R.AB_INNER, R.LSM_STEPS, seed=2, value_degree=None, **kw)
    want = moments_reduce(block_moments(best, R.AB_BLOCK))
    got = ranks[0]["s2p4"][f"ab{tag}"]
    np.testing.assert_array_equal(got["upper"], want.mean.numpy())
    np.testing.assert_array_equal(got["std_err"], std_error(want).numpy())


@pytest.mark.parametrize("tag,dtype", [("32", torch.float32),
                                       ("64", torch.float64)])
def test_sharded_lsm_within_4_std_err_of_lsm_price(ranks, tag, dtype):
    from montecarlo_tpu_torch.engine.american import lsm_price

    got = ranks[0]["flat4"][f"lsm{tag}"]
    want = lsm_price(R.american_gbm(dtype), R.put, R.LSM_PATHS, R.LSM_STEPS,
                     seed=1, rate=R.AM_GBM["mu"], dt=R.AM_GBM["dt"],
                     degree=3, dtype=dtype)
    assert abs(float(got["price"]) - float(want["price"])) < \
        4 * float(want["std_err"])
    assert float(got["n_paths"]) == R.LSM_PATHS
