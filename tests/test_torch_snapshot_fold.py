"""The snapshot kernel's fold (``csrc/functionals.cuh::SnapshotFold``)
walked on the host with g++, its plain version
(``ops.fused_engine.fused_snapshots_reference``), the launches of a
functional set (``k4_launches``) and the surface's one launch.

The shim runs SnapshotFold over each path's prices as
``fused_snapshot_kernel`` does: ``init``, a latch of the initial price
when step 0 is due, after every step ``due_at(t)`` and, when due, a latch
of that step's price, then the terminal price and ``finalize``.  The
prices come from torch: a GBM's prices after every step of K4's plain
version's own loop (the kernels' draws, plain or antithetic).  The fold
must equal K4's generic fold (SpecFold over kSnapshot, four snapshots at
a time), the plain snapshot kernel, K4's plain version and the torch loop
bitwise: all of them store the same prices of the same states.  The
shim also counts the prices the fold asks for: one a latched step below
the last, and the terminal.  Built with -ffp-contract=off, as the device
build uses -fmad=false; skips when no C++ compiler is present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine import mc_implied_vol_surface
from montecarlo_tpu_torch.engine.functionals import simulate_functionals
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.engine.surface import price_snapshot
from montecarlo_tpu_torch.ops import fused_engine as fe
from montecarlo_tpu_torch.processes import GBM, BasketGBM, Heston, LocalVolGBM
from montecarlo_tpu_torch.rng.sobol import SobolDeviceSampler
from montecarlo_tpu_torch.rng.threefry import key_from_seed

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

_SHIM = r"""
#include "functionals.cuh"

namespace {

mcf::SnapshotPlan make_plan(int n_snap, const int* steps, const int* rows,
                            long n) {
  mcf::SnapshotPlan plan = {};
  plan.out_stride = n;
  plan.n = n_snap;
  for (int k = 0; k < n_snap; ++k) {
    plan.step[k] = steps[k];
    plan.row[k] = rows[k];
  }
  return plan;
}

}  // namespace

extern "C" {
// fused_snapshot_kernel's per-path loop over prices (T + 1, n); a path
// with active[i] == 0 runs the loop and stores nothing (a thread past the
// paths under the whole-block sources).  reads[i]: the prices it asked.
int snapshot_run(int n_snap, const int* steps, const int* rows, long n,
                 int T, const float* price, const int* active, float* out,
                 int* reads) {
  const mcf::SnapshotPlan plan = make_plan(n_snap, steps, rows, n);
  for (long i = 0; i < n; ++i) {
    mcf::SnapshotFold fold;
    fold.init(plan, T);
    reads[i] = 0;
    auto latch = [&](int t) {
      ++reads[i];
      fold.latch(plan, T, t, price[t * n + i], out, i, active[i] != 0);
    };
    if (fold.due_at(0)) latch(0);
    for (int t = 1; t <= T; ++t) {
      if (fold.due_at(t)) latch(t);
    }
    if (!active[i]) continue;
    ++reads[i];
    out[i] = price[T * n + i];
    fold.finalize(plan, T, price[T * n + i], out, i);
  }
  return 0;
}

// K4's generic fold over kSnapshot slots (at most four), as K4 runs it.
int spec_run(int n_snap, const int* steps, long n, int T, const float* price,
             float* out) {
  mcf::FunctionalSpec spec = {};
  spec.out_stride = n;
  spec.n = n_snap;
  for (int k = 0; k < n_snap; ++k) {
    spec.code[k] = mcf::kSnapshot;
    spec.period[k] = steps[k];
  }
  for (long i = 0; i < n; ++i) {
    mcf::SpecFold fold;
    fold.init(spec, price[i], 0.0f);
    for (int t = 1; t <= T; ++t) fold.update(spec, price[t * n + i], 0.0f, t);
    fold.finalize(spec, out, i, T);
  }
  return 0;
}
}
"""

N = 40
DT = 1 / 64
SEED, OFFSET = 4, 2**32 - 20


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build functionals.cuh for the host")
    d = tmp_path_factory.mktemp("snapshot_fold")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _gbm():
    return GBM.create(100.0, 0.03, 0.3, DT, device="cpu")


def _prices(proc, n_steps, antithetic):
    """(T + 1, N) float32: the GBM's prices after every step of K4's plain
    version's loop."""
    k0, k1 = key_from_seed(SEED, 0)
    ids = path_ids_for(N, OFFSET, proc.device)
    state = proc.init_state(ids)
    prices = [proc.prices(state)]
    for t, eps in fe._step_draws(proc, n_steps, k0, k1, ids, antithetic):
        state = proc.step(state, eps, t)
        prices.append(proc.prices(state))
    return np.ascontiguousarray(torch.stack(prices).numpy(), np.float32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _walk(lib, steps, n_steps, price, active):
    """The shim's SnapshotFold walk, the plan sorted as fused_snapshots
    sorts it: (out (1 + len(steps), N), reads (N,))."""
    order = sorted(range(len(steps)), key=lambda k: steps[k])
    plan_steps = np.array([min(steps[k], n_steps + 1) for k in order],
                          np.int32)
    plan_rows = np.array(order, np.int32)
    out = np.full((1 + len(steps), N), np.nan, np.float32)
    reads = np.zeros(N, np.int32)
    lib.snapshot_run(ctypes.c_int(len(steps)), _ptr(plan_steps),
                     _ptr(plan_rows), ctypes.c_long(N), ctypes.c_int(n_steps),
                     _ptr(price), _ptr(active), _ptr(out), _ptr(reads))
    return out, reads


def _generic(lib, steps, n_steps, price):
    """K4's generic fold over the same snapshots, four at a time."""
    rows = []
    for k in range(0, len(steps), 4):
        chunk = np.array(steps[k:k + 4], np.int32)
        out = np.full((1 + len(chunk), N), np.nan, np.float32)
        lib.spec_run(ctypes.c_int(len(chunk)), _ptr(chunk), ctypes.c_long(N),
                     ctypes.c_int(n_steps), _ptr(price), _ptr(out))
        rows += list(out[1:])
    return np.stack(rows)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [17, 252])
def test_snapshot_fold_walk_is_the_generic_fold_and_plain_k4(
        lib, n_steps, antithetic):
    """SnapshotFold at step 0, step 1, an odd middle step twice, the last
    step and one past it, given out of order: bitwise K4's generic fold,
    the snapshot kernel's plain version, K4's plain version and the price
    at each step (0 past the last); it asks for the price once a latched
    step below the last and once for the terminal; a path that stores
    nothing leaves its columns alone."""
    proc = _gbm()
    price = _prices(proc, n_steps, antithetic)
    mid = n_steps // 2 | 1
    steps = [n_steps, mid, 0, n_steps + 1, 1, mid]
    active = np.ones(N, np.int32)
    active[3::7] = 0
    walk, reads = _walk(lib, steps, n_steps, price, active)
    on = active == 1
    assert np.isnan(walk[:, ~on]).all()
    # Steps 0, 1 and mid, then the terminal (a path past the run's: none).
    assert np.array_equal(reads, np.where(on, 4, 3))
    walk = walk[:, on]
    generic = _generic(lib, steps, n_steps, price)[:, on]
    kw = dict(seed=SEED, path_offset=OFFSET, antithetic=antithetic)
    plain = fe.fused_snapshots_reference(proc, N, n_steps, steps, **kw)
    fns = {f"s{k}": price_snapshot(s) for k, s in enumerate(steps)}
    k4 = fe.fused_functionals_reference(proc, N, n_steps, functionals=fns,
                                        **kw)
    assert np.array_equal(walk, plain.numpy()[:, on])
    assert np.array_equal(walk[0], k4["terminal"].numpy()[on])
    assert np.array_equal(walk[0], price[n_steps][on])
    for k, s in enumerate(steps):
        latched = price[s][on] if s <= n_steps else np.zeros(on.sum())
        assert np.array_equal(walk[k + 1], generic[k]), s
        assert np.array_equal(walk[k + 1], k4[f"s{k}"].numpy()[on]), s
        assert np.array_equal(walk[k + 1], latched), s


def test_snapshot_fold_edges(lib):
    """A run of 0 steps (every snapshot at step 0 is the terminal, the
    others 0), no snapshot at all, and the 64 snapshots a launch takes,
    one a step: the walk is the plain version's."""
    proc = _gbm()
    active = np.ones(N, np.int32)
    for n_steps, steps in ((0, [0, 3, 0]), (5, []),
                           (70, list(range(70, 6, -1)))):
        price = _prices(proc, n_steps, False)
        walk, reads = _walk(lib, steps, n_steps, price, active)
        plain = fe.fused_snapshots_reference(proc, N, n_steps, steps,
                                             seed=SEED, path_offset=OFFSET)
        assert np.array_equal(walk, plain.numpy()), n_steps
        below = {s for s in steps if s < n_steps}
        assert (reads == len(below) + 1).all()
    assert len(steps) == fe.MAX_SNAPSHOTS


@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_snapshot_plain_version_is_the_torch_loop(kind):
    """fused_snapshots on a CPU process (its plain version), steps out of
    order with repeats, step 0 and a step past the run, plain and
    antithetic: bitwise K4's plain version and the torch loop."""
    proc = (_gbm() if kind == "gbm" else
            Heston.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.6, -0.8, DT,
                          device="cpu"))
    steps, n_steps = [9, 0, 23, 9, 1, 30], 23
    fns = {f"s{k}": price_snapshot(s) for k, s in enumerate(steps)}
    for anti in (False, True):
        kw = dict(seed=3, path_offset=OFFSET, antithetic=anti)
        got = fe.fused_snapshots(proc, 512, n_steps, steps, **kw)
        want = fe.fused_functionals_reference(proc, 512, n_steps,
                                              functionals=fns, **kw)
        assert got.shape == (7, 512) and got.dtype == torch.float32
        assert torch.equal(got[0], want["terminal"])
        for k in range(len(steps)):
            assert torch.equal(got[k + 1], want[f"s{k}"]), k
        assert not got[-1].any()  # step 30, past the run
    loop = simulate_functionals(proc, 512, n_steps, seed=3,
                                path_offset=OFFSET, functionals=fns,
                                prefer_fused=False)
    got = fe.fused_snapshots(proc, 512, n_steps, steps, seed=3,
                             path_offset=OFFSET)
    for k in range(len(steps)):
        assert torch.equal(got[k + 1], loop[f"s{k}"]), k


def test_snapshot_kernel_refusals():
    """The snapshot kernel's wrapper refuses more than 64 snapshots, a
    negative step and a functor or draw source it is not built for (which
    ``k4_launches`` sends to K4's generic fold instead)."""
    gbm = _gbm()
    with pytest.raises(ValueError, match="at most 64"):
        fe.fused_snapshots(gbm, 64, 70, list(range(65)), seed=0)
    with pytest.raises(ValueError, match=">= 0"):
        fe.fused_snapshots(gbm, 64, 8, [3, -1], seed=0)
    basket = BasketGBM.create([100.0], [0.03], [0.2], [[1.0]], [1.0], DT,
                              device="cpu")
    with pytest.raises(ValueError, match="not built for BasketGBM"):
        fe.fused_snapshots(basket, 64, 8, [3], seed=0)
    lv = LocalVolGBM.create(100.0, 0.03, DT, 8,
                            lambda t, s: np.full_like(s, 0.2), device="cpu")
    sobol = SobolDeviceSampler.create(8, device="cpu")
    with pytest.raises(ValueError, match="not built for LocalVolGBM"):
        fe.fused_snapshots(lv, 64, 8, [3], seed=0, sampler=sobol)
    # The launches route both to the generic fold, four snapshots a launch.
    forms = [price_snapshot(s).device(8) for s in (1, 2, 3, 4, 5)]
    for proc, source in ((basket, fe.THREEFRY), (lv, fe.SOBOL)):
        assert [(l.snapshot, l.n_steps) for l in fe.k4_launches(
            proc, source, forms, 8)] == [(False, 4), (False, 8)]


def _grouped_runs(proc, n, grid, seed):
    """The surface's runs on K4's generic fold: the maturities before the
    last grouped four a K4 launch, each launch to its group's last step,
    the last to the last maturity (its terminal), on K4's plain
    version."""
    snaps = list(grid[:-1])
    groups = [snaps[i:i + 4] for i in range(0, len(snaps), 4)] or [[]]
    runs = [(g[-1], g) for g in groups[:-1]] + [(grid[-1], groups[-1])]
    rows = []
    for n_steps, group in runs:
        out = fe.fused_functionals_reference(
            proc, n, n_steps, seed=seed,
            functionals={f"m{j}": price_snapshot(s)
                         for j, s in enumerate(group)})
        rows += [out[f"m{j}"] for j in range(len(group))]
    return torch.stack(rows + [out["terminal"]])


@pytest.mark.parametrize("n_mats", [6, 12])
@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_surface_takes_one_snapshot_launch(monkeypatch, kind, n_mats):
    """``mc_implied_vol_surface`` on a 6- and a 12-maturity grid calls the
    snapshot kernel's wrapper once and K4's fold never; its prices and ivs
    are bitwise those of grouped K4 runs (four snapshots a launch) and of
    one torch-loop run."""
    dt = 1 / 64
    proc = (GBM.create(100.0, 0.03, 0.2, dt, device="cpu") if kind == "gbm"
            else Heston.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.6, -0.8, dt,
                               device="cpu"))
    grid = [4 * (k + 1) for k in range(n_mats)]
    strikes = [85.0, 100.0, 115.0]
    calls = {"snapshots": 0, "fold": 0}
    snaps, fold = fe.fused_snapshots, fe.fused_functionals_reference

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fe, "fused_snapshots", count("snapshots", snaps))
    monkeypatch.setattr(fe, "fused_functionals_reference",
                        count("fold", fold))
    n = 1 << 12
    got = mc_implied_vol_surface(proc, strikes, grid, dt, rate=0.03,
                                 n_paths=n, seed=5)
    assert calls == {"snapshots": 1, "fold": 0}
    monkeypatch.undo()

    def surface_of(terms):
        mats = torch.tensor(grid, dtype=torch.float32) * dt
        discs = torch.exp(-0.03 * mats)
        ks = torch.tensor(strikes)
        pay = torch.clamp(terms[:, :, None] - ks[None, None, :], min=0.0)
        return (discs[:, None] * torch.mean(pay, dim=1)).double().numpy()

    grouped = _grouped_runs(proc, n, grid, 5)
    loop = simulate_functionals(
        proc, n, grid[-1], seed=5, prefer_fused=False,
        functionals={f"m{j}": price_snapshot(s)
                     for j, s in enumerate(grid[:-1])})
    loop = torch.stack([loop[f"m{j}"] for j in range(n_mats - 1)]
                       + [loop["terminal"]])
    assert torch.equal(grouped, loop)
    assert np.array_equal(got["prices"], surface_of(grouped))
    want = mc_implied_vol_surface(proc, strikes, grid, dt, rate=0.03,
                                  n_paths=n, seed=5, prefer_fused=False)
    for k in ("prices", "ivs"):
        assert np.array_equal(got[k], want[k], equal_nan=True), k
