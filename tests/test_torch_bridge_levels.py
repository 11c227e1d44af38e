"""The bridge-Sobol draw source's step draws with the bridge normals held
per tree level (``csrc/bridge_levels.cuh``), built for the host with g++
and walked warp by warp, lane by lane, against K2's plain version's plan
sum (``ops/fused_engine.py::_step_draws``); the refusal of a plan wider
than the kernels hold and its route to the torch loop.

The shim walks every lane of each warp through the header's
``BridgeLevels::step``, the text the kernels run, over the plan's weights
and load schedule (``rng/sobol.py::bridge_schedule``).  Its normal source
stands in for the card's: the warp's Sobol integers of the asked dim come from
``sobol_warp.cuh``'s walk through ``HostWarp`` (held against the port's
``sobol_bits``), the normal itself is torch's (the plain version's
``bridge_normals``, so the host's libm never enters), and every load is
counted.  Tolerances: the step draws are the same float32 products and
sums in the same order on the same normals (a padded slot's zero weight
times whatever finite normal its level holds adds a zero), so bitwise;
each dim must be loaded exactly once per path.  A refused plan's prices
on the torch loop are held to JAX's scan within
``tests/test_torch_qmc.py``'s rtol 2e-6 (the platforms' log inside
``ndtri32``).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.rng import sobol as jsobol
from montecarlo_tpu_torch.engine import (ARITH_MEAN, simulate,
                                         simulate_functionals,
                                         terminal_prices)
from montecarlo_tpu_torch.engine import dispatch
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops import fused_engine
from montecarlo_tpu_torch.ops.fused_engine import (_step_draws,
                                                   fused_terminal,
                                                   kernel_refusal)
from montecarlo_tpu_torch.processes import BasketGBM, GBM
from montecarlo_tpu_torch.rng.sobol import (SobolBridgeKernelSampler,
                                            bridge_schedule, sobol_bits)
from montecarlo_tpu_torch.rng.threefry import MASK32, key_from_seed

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"
WARP = 32
PRICE_RTOL = 2e-6

_SHIM = r"""
#include "bridge_levels.cuh"
#include "sobol_warp.cuh"

extern "C" {
// The step draws of n_pad paths from path_offset (whole warps), as the
// kernels' BridgeDraws takes them: eps (n_steps, n_pad).  z (T, n_pad)
// holds the bridge normals; x (T, n_pad) gets the warp walk's Sobol
// integer of each load, loads (n_pad, T) counts them.
int bridge_walk(const uint32_t* sv, const float* coeffs,
                const uint32_t* sched, int T, int L, int n_steps,
                uint32_t path_offset, long n_pad, const float* z, float* eps,
                uint32_t* x, int* loads) {
  const uint32_t* first = sched;
  for (long w = 0; w * mc::kWarp < n_pad; ++w) {
    const mc::HostWarp warp(path_offset + (uint32_t)(w * mc::kWarp));
    mc::BridgeLevels lanes[mc::kWarp];
    for (int t = 0; t < n_steps; ++t) {
      const uint32_t* step_loads = sched + T + 1 + first[t];
      const int n = (int)(first[t + 1] - first[t]);
      for (int l = 0; l < mc::kWarp; ++l) {
        const long i = w * mc::kWarp + l;
        auto normal = [&](uint32_t dim) {
          const mc::HostWarp::Val v = mc::warp_sobol_bits(
              warp, sv + (size_t)dim * mc::kSobolBits);
          x[(long)dim * n_pad + i] = v.v[l];
          loads[i * T + dim] += 1;
          return z[(long)dim * n_pad + i];
        };
        eps[(long)t * n_pad + i] =
            lanes[l].step(coeffs + (long)t * L, step_loads, n, L, normal);
      }
    }
  }
  return 0;
}
}
"""

STEPS = [1, 2, 3, 7, 17, 64, 252, 256, 300]
N = 45  # a ragged last warp of 13 paths


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build bridge_levels.cuh for the host")
    d = tmp_path_factory.mktemp("bridge_levels")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _np(t, dtype):
    return np.ascontiguousarray(t.numpy().astype(dtype))


@pytest.mark.parametrize("n_steps", STEPS)
def test_register_levels_equal_the_plan_sum(lib, n_steps):
    """Every lane's step draws equal ``_step_draws``' padded plan sums
    bitwise, each of the T dims loaded once per path (the active lanes'
    and those past N alike), the warp walk's integers the port's
    ``sobol_bits``."""
    offset = 2**32 - 40 if n_steps % 2 else 2**30 - 7
    smp = SobolBridgeKernelSampler.create(n_steps, scramble_seed=n_steps,
                                          device="cpu")
    gbm = GBM.create(100.0, 0.03, 0.2, 1 / n_steps, device="cpu")
    k0, k1 = key_from_seed(11, 0)
    n_pad = -(-N // WARP) * WARP
    ids = path_ids_for(n_pad, offset, "cpu")
    z = _np(smp.bridge_normals(k0, k1, ids), np.float32)
    T, L = smp.n_steps, smp.width
    sv = _np(smp.sv, np.int32).view(np.uint32)
    coeffs = _np(smp.coeffs, np.float32)
    sched = _np(smp.schedule, np.int32).view(np.uint32)
    eps = np.full((n_steps, n_pad), np.nan, np.float32)
    x = np.zeros((T, n_pad), np.uint32)
    loads = np.zeros((n_pad, T), np.int32)
    lib.bridge_walk(_ptr(sv), _ptr(coeffs), _ptr(sched),
                    ctypes.c_int(T), ctypes.c_int(L), ctypes.c_int(n_steps),
                    ctypes.c_uint32(offset & MASK32), ctypes.c_long(n_pad),
                    _ptr(z), _ptr(eps), _ptr(x), _ptr(loads))
    want = [e[0] for _, e in _step_draws(gbm, n_steps, k0, k1, ids[:N],
                                         False, smp)]
    assert np.array_equal(eps[:, :N], torch.stack(want).numpy())
    assert (loads == 1).all()
    for d in range(T):
        bits = sobol_bits(smp.sv[d], ids).numpy()
        assert np.array_equal(x[d].astype(np.int64), bits), d


def test_schedule_follows_the_tree_levels():
    """The load schedule: every slot at t = 0, then a slot when it takes
    a new dim that is not the padding (dim 0 past slot 0); slot 0 is the
    endpoint dim 0 throughout, and the loads number T, one per dim."""
    for n_steps in STEPS + [1000, 4096]:
        smp = SobolBridgeKernelSampler.create(n_steps, device="cpu")
        dims = smp.dims.numpy()
        sched = bridge_schedule(dims)
        assert np.array_equal(sched, smp.schedule.numpy())
        T, L = dims.shape
        first, loads = sched[:T + 1], sched[T + 1:]
        assert (dims[:, 0] == 0).all()
        assert first[0] == 0 and first[-1] == len(loads) == T
        assert sorted(loads & 0xFFFF) == list(range(T))
        for t in range(T):
            want = [j for j in range(L)
                    if (t == 0 or dims[t, j] != dims[t - 1, j])
                    and (j == 0 or dims[t, j] != 0)]
            got = loads[first[t]:first[t + 1]]
            assert list(got >> 16) == want, t
            assert list(got & 0xFFFF) == [dims[t, j] for j in want], t


def _wide_sampler(width):
    dims = np.zeros((4, width), np.int32)
    return SobolBridgeKernelSampler(
        sv=torch.zeros((4, 30), dtype=torch.int32),
        dims=torch.from_numpy(dims),
        coeffs=torch.zeros((4, width), dtype=torch.float32),
        schedule=torch.from_numpy(bridge_schedule(dims)))


def test_plan_wider_than_the_levels_is_refused():
    """kernel_refusal takes a plan of kMaxLevels slots and refuses a wider
    one; the gate then routes it to the torch loop and the kernel wrappers
    raise.  The Python bound is the header's."""
    text = (CSRC / "bridge_levels.cuh").read_text()
    levels = int(re.search(r"constexpr int kMaxLevels = (\d+);",
                           text).group(1))
    assert levels == fused_engine.MAX_BRIDGE_LEVELS
    gbm = GBM.create(100.0, 0.03, 0.2, 1 / 4, device="cpu")
    assert kernel_refusal(gbm, _wide_sampler(levels)) is None
    wide = _wide_sampler(levels + 1)
    assert isinstance(kernel_refusal(gbm, wide), ValueError)
    assert not dispatch.kernel_route(gbm, wide, 4)
    with pytest.raises(ValueError, match="tree levels"):
        fused_terminal(gbm, 64, 4, seed=0, sampler=wide)


def test_refused_plan_prices_on_the_torch_loop_like_jax(monkeypatch):
    """A plan refused for its width (the bound lowered to 4 levels, so
    that 17 steps' 6 are too many) is priced on the torch loop, never
    through the kernels, within JAX's parity tolerance: terminal prices
    and the Asian's average."""
    monkeypatch.setattr(fused_engine, "MAX_BRIDGE_LEVELS", 4)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the refused plan reached a kernel wrapper")
    monkeypatch.setattr(dispatch, "fused_terminal", no_kernel)
    monkeypatch.setattr(dispatch, "fused_functionals", no_kernel)
    n, n_steps, offset = 1024, 17, 2**30 - 300
    jp = JGBM.create(100.0, 0.03, 0.2, 1 / n_steps)
    gbm = GBM.create(100.0, 0.03, 0.2, 1 / n_steps, device="cpu")
    js = jsobol.SobolBridgeKernelSampler.create(n_steps, scramble_seed=3)
    ts = SobolBridgeKernelSampler.create(n_steps, scramble_seed=3,
                                         device="cpu")
    assert ts.width > 4 and not dispatch.kernel_route(gbm, ts, n_steps)
    got = terminal_prices(gbm, n, n_steps, seed=2, sampler=ts,
                          path_offset=offset)
    assert torch.equal(got, simulate(gbm, n, n_steps, seed=2, sampler=ts,
                                     path_offset=offset))
    want = jsimulate(jp, n, n_steps, seed=2, sampler=js, dtype=jnp.float32,
                     path_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=PRICE_RTOL)
    got = simulate_functionals(gbm, n, n_steps, seed=2, sampler=ts,
                               path_offset=offset,
                               functionals={"avg": ARITH_MEAN})
    want = jf._simulate_functionals(jp, n, n_steps, 2, 0, js, jnp.float32,
                                    offset, (("avg", jf.ARITH_MEAN),))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=PRICE_RTOL, err_msg=k)


def test_one_asset_basket_under_a_wide_plan_is_refused_before_any_launch(
        monkeypatch):
    """A one-asset basket runs under the bridge; a plan wider than the
    kernels hold (the bound lowered to 4 levels, so that 17 steps' 6 are
    too many) is refused for it by the gate and by the wrappers and plain
    versions before any launch, as for GBM, and routed to the torch
    loop."""
    basket = BasketGBM.create([100.0], [0.03], [0.2], [[1.0]], [1.0],
                              1 / 17, device="cpu")
    ts = SobolBridgeKernelSampler.create(17, scramble_seed=3, device="cpu")
    assert kernel_refusal(basket, ts) is None
    assert dispatch.kernel_route(basket, ts, 17)
    monkeypatch.setattr(fused_engine, "MAX_BRIDGE_LEVELS", 4)
    assert isinstance(kernel_refusal(basket, ts), ValueError)
    assert not dispatch.kernel_route(basket, ts, 17)
    for run in (fused_terminal, fused_engine.fused_terminal_reference):
        with pytest.raises(ValueError, match="tree levels"):
            run(basket, 64, 17, seed=0, sampler=ts)
