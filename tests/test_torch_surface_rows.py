"""The row builder of the surfaces on time knots (local vol, SLV on knots)
and the row reads K2-K4 make of its rows, on the host, against the torch
plain versions and the JAX package.

K2-K4 blend a surface's row of each step once per launch
(``csrc/fused_engine.cu::blend_rows_kernel``, whose body is
``csrc/surface.cuh::row_lane``) and read row t at every path's
log-moneyness with ``interp_row``, where they blended it per path and step
with ``interp_blend`` before.  Here the same header text is built with g++
(-ffp-contract=off, as the card's -fmad=false) and held:

- the rows against ``processes/local_vol.py::blend_rows`` over steps 0 ..
  n_rows - 1 and against JAX's ``LocalVolGBM._row``: bitwise, at 2, 3 and
  16 time knots, past the horizon (where the knot coordinate's clamp
  binds), on the CLI's CEV surface, a 16-knot time-dependent surface and
  an ``slv_to_kernel`` table;
- ``interp_row`` over the built rows against ``interp_blend`` at random
  log-moneyness inside and outside the grid: bitwise (the same arithmetic
  over the same floats);
- the launch leaves the kernel wrappers build from them (the functors'
  head leaves, then the rows), built once per (process, n_steps).
"""

import ctypes
import dataclasses
import gc
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.processes import LocalVolGBM as JLocalVol
from montecarlo_tpu_torch.cli.pricing import cli_process
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.ops import fused_engine
from montecarlo_tpu_torch.ops.fused_engine import (PROCESS_CODES, ROW_HEADS,
                                                   _launch_leaves, _leaves,
                                                   surface_rows)
from montecarlo_tpu_torch.processes import SLV, LocalVolGBM, slv_to_kernel
from montecarlo_tpu_torch.processes.local_vol import (KNOTS, blend_rows,
                                                      interp_row)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"
S0, R = 100.0, 0.03

_SHIM = r"""
#include "surface.cuh"
extern "C" {
// The rows blend_rows_kernel writes: block t, thread k.
void host_surface_rows(const float* table, int n_tk, float dt, float dt_knot,
                       int n_rows, float* rows) {
  for (int t = 0; t < n_rows; ++t)
    for (int k = 0; k < mc::kKnots; ++k)
      rows[t * mc::kKnots + k] = mc::row_lane(table, n_tk, t, dt, dt_knot, k);
}
// Row t read at each x, as the functors read it now, and the per-path
// blend they took before.
void host_read_rows(const float* rows, int t, const float* x, float x0,
                    float dx, float* y, long n) {
  for (long i = 0; i < n; ++i)
    y[i] = mc::interp_row(rows + t * mc::kKnots, x[i], x0, dx);
}
void host_read_blend(const float* table, int n_tk, int t, float dt,
                     float dt_knot, const float* x, float x0, float dx,
                     float* y, long n) {
  const float u = mc::knot_time(t, dt, dt_knot, n_tk);
  for (long i = 0; i < n; ++i)
    y[i] = mc::interp_blend(table, n_tk, u, x[i], x0, dx);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build surface.cuh for the host")
    d = tmp_path_factory.mktemp("surface_rows")
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


def _tdep(t, s):
    return 0.2 + 0.1 * np.tanh(np.log(s / S0)) + 0.05 * t


def _slv_knots(n_steps=40, n_time_knots=16):
    """slv_to_kernel of an SLV with smooth, positive leverage rows."""
    rng = np.random.default_rng(8)
    x = np.linspace(-1.0, 1.0, KNOTS)
    rows = (1.0 + 0.2 * np.tanh(x)[None, :]
            + 0.05 * rng.standard_normal((n_steps, KNOTS))
            * np.linspace(0.0, 1.0, n_steps)[:, None])
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    slv = SLV(s0=f32(S0), rate=f32(R), v0=f32(0.04), kappa=f32(2.0),
              theta=f32(0.04), xi=f32(0.5), rho=f32(-0.7),
              dt=f32(1.0 / n_steps), x0=f32(x[0]), dx=f32(x[1] - x[0]),
              lev_rows=torch.from_numpy(rows.astype(np.float32)))
    return slv_to_kernel(slv, n_time_knots)


def _surface(kind):
    """(process, steps of its horizon): the surfaces the kernels read."""
    if kind == "cev":  # the CLI's: price --process cev --steps 252
        return cli_process(["--process", "cev", "--steps", "252"],
                           "cpu")[0], 252
    if kind == "slv-knots":
        return _slv_knots(), 40
    n_tk = {"2 knots": 2, "3 knots": 3, "16 knots": 16}[kind]
    return LocalVolGBM.create(S0, R, 1.0 / 32, 17, _tdep,
                              n_time_knots=n_tk, device="cpu"), 17


def _table(proc):
    return proc.vol_flat if isinstance(proc, LocalVolGBM) else proc.lev_flat


KINDS = ["2 knots", "3 knots", "16 knots", "cev", "slv-knots"]


def _host_rows(lib, proc, n_rows):
    table = _table(proc).numpy()
    rows = np.empty(n_rows * KNOTS, np.float32)
    lib.host_surface_rows(_ptr(table), proc.n_time_knots, _f(proc.dt),
                          _f(proc.dt_knot), n_rows, _ptr(rows))
    return rows.reshape(n_rows, KNOTS)


@pytest.mark.parametrize("kind", KINDS)
def test_row_builder_matches_blend_rows(lib, kind):
    """Every row the builder writes, the horizon and 9 steps past it (the
    clamp of the knot coordinate), bitwise blend_rows' full hat sum and
    the wrapper's plain route."""
    proc, steps = _surface(kind)
    n_rows = steps + 10
    got = _host_rows(lib, proc, n_rows)
    table = _table(proc).reshape(-1, KNOTS)
    want = blend_rows(table, list(range(n_rows)), proc.dt, proc.dt_knot)
    np.testing.assert_array_equal(got, want.numpy())
    plain = surface_rows(_table(proc), n_rows, proc.dt, proc.dt_knot)
    np.testing.assert_array_equal(got, plain.numpy())
    # Past the last knot every row is the last knot's.
    np.testing.assert_array_equal(got[-1], table[-1].numpy())


@pytest.mark.parametrize("n_tk", [2, 3, 16])
def test_row_builder_matches_jax_rows(lib, n_tk):
    """The builder's rows against JAX's LocalVolGBM._row on the same
    leaves, every step and past the horizon: bitwise."""
    jp = JLocalVol.create(S0, R, 1.0 / 32, 17, _tdep, n_time_knots=n_tk)
    tp = process_from_numpy(
        "local-vol", {k: np.asarray(v) for k, v in jp._asdict().items()},
        device="cpu")
    got = _host_rows(lib, tp, 24)
    want = jax.vmap(lambda t: jp._row(t, jnp.float32))(jnp.arange(24))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_row_reads_match_the_per_path_blend(lib, kind):
    """interp_row over the built rows against interp_blend at 2^13
    log-moneyness points inside and outside the grid, at every step and
    past the horizon: bitwise."""
    proc, steps = _surface(kind)
    n_rows = steps + 3
    rows = _host_rows(lib, proc, n_rows)
    table = _table(proc).numpy()
    x0, dx = proc.x0.item(), proc.dx.item()
    rng = np.random.default_rng(5)
    x = rng.uniform(x0 - 1.0, -x0 + 1.0, 1 << 13).astype(np.float32)
    x[:4] = [x0, -x0, x0 - 5.0, -x0 + 5.0]
    n = ctypes.c_long(x.size)
    got, want = np.empty_like(x), np.empty_like(x)
    for t in range(n_rows):
        lib.host_read_rows(_ptr(rows), t, _ptr(x), _f(x0), _f(dx),
                           _ptr(got), n)
        lib.host_read_blend(_ptr(table), proc.n_time_knots, t, _f(proc.dt),
                            _f(proc.dt_knot), _ptr(x), _f(x0), _f(dx),
                            _ptr(want), n)
        np.testing.assert_array_equal(got, want)
    # ... and both are the torch plain version's read of the last row.
    np.testing.assert_array_equal(
        got, interp_row(torch.from_numpy(rows[-1]), torch.from_numpy(x),
                        proc.x0, proc.dx).numpy())


@pytest.mark.parametrize("kind", ["16 knots", "slv-knots"])
@pytest.mark.parametrize("n_steps", [0, 1, 17])
def test_launch_leaves_are_head_then_rows(kind, n_steps):
    """The leaves a launch takes: the functor's head fields (LocalVolProc's;
    SlvProc's for SLV on knots, which runs as SLV), then the rows of steps
    0 .. max(n_steps, 1) - 1, with dims their count."""
    proc, _ = _surface(kind)
    code, dims, leaves = _leaves(proc)
    n_rows, got = _launch_leaves(proc, n_steps, dims, leaves)
    head = ROW_HEADS[type(proc)]
    assert n_rows == max(n_steps, 1)
    assert got.shape == (len(head) + n_rows * KNOTS,)
    want_head = torch.stack([getattr(proc, f) for f in head])
    assert torch.equal(got[:len(head)], want_head)
    assert torch.equal(got[len(head):].reshape(n_rows, KNOTS),
                       blend_rows(_table(proc).reshape(-1, KNOTS),
                                  list(range(n_rows)), proc.dt,
                                  proc.dt_knot))
    assert code == PROCESS_CODES[type(proc)]
    if kind == "slv-knots":  # SLV's functor and its leaves' layout
        assert code == PROCESS_CODES[SLV]
        assert head == tuple(f.name for f in dataclasses.fields(SLV))[:-1]


def test_launch_leaves_are_built_once_per_process_and_steps():
    """A second launch of one (process, n_steps) reuses the first's rows
    (a price_to_tolerance run's chunks); another step count or another
    process builds its own; an entry goes with its process."""
    proc, _ = _surface("16 knots")
    _, dims, leaves = _leaves(proc)
    first = _launch_leaves(proc, 17, dims, leaves)[1]
    assert _launch_leaves(proc, 17, dims, leaves)[1] is first
    other = _launch_leaves(proc, 9, dims, leaves)[1]
    assert other is not first and other.numel() == 5 + 9 * KNOTS
    copy = dataclasses.replace(proc)
    assert _launch_leaves(copy, 9, dims, leaves)[1] is not other
    assert torch.equal(_launch_leaves(copy, 9, dims, leaves)[1], other)
    key = id(copy)
    assert key in fused_engine._ROW_LEAVES
    del copy
    gc.collect()
    assert key not in fused_engine._ROW_LEAVES


def test_launch_leaves_keep_other_processes_as_they_are():
    """Every process but the surfaces on knots launches on its own leaves
    (the exact-rows SLV included)."""
    for flags in (["--process", "sabr"], ["--process", "slv", "--paths",
                                          "4096"]):
        proc = cli_process(flags + ["--steps", "17"], "cpu")[0]
        _, dims, leaves = _leaves(proc)
        got = _launch_leaves(proc, 17, dims, leaves)
        assert got[0] == dims and got[1] is leaves
