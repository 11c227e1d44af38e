"""The basket's streamed step pair (montecarlo_tpu_torch/csrc/basket_step.cuh),
built for the host with g++, against K2's and K4's plain versions.

The shim below walks BasketFixed<A>'s per-path loop as K2 and K4 run it:
the constants staged by the header's ``stage``, then per step pair the A
Threefry calls' normals fed in counter order through ``run_pairs`` (each
normal adds its column of the Cholesky factor to the partial sums, each
asset updated once its sum is whole; as each call makes them, or staged
first for the pair, as the card does past 8 assets), and K4's observation
after every
step: the basket value once, its log as ``log32`` of it, the fold of
``csrc/functionals.cuh``.  The normals are handed in from torch:
``boxmuller_pair(threefry2x32(...))`` of the port at K2's counters (id,
j * A + c), so the host libm's sin, cos and log never enter; and so are
the seeds of ``log32`` (its ``logf``, for log32(s0) and the log-space
observations), each the value torch's ``log`` gave the plain version for
the same argument.  The results
must equal ``fused_terminal_reference`` and ``fused_functionals_reference``
bitwise: this is where the kernels' order of operations is held without a
card.  Built with -ffp-contract=off, as the device build uses -fmad=false.
Skips when no C++ compiler is present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from montecarlo_tpu_torch.bench import bench_basket
from montecarlo_tpu_torch.engine import (ARITH_MEAN, RUNNING_MAX,
                                         RUNNING_MIN)
from montecarlo_tpu_torch.engine.functionals import MAX_PARAMS
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops.fused_engine import (
    MAX_FUNCTIONALS, _device_forms, _leaves, fused_functionals_reference,
    fused_terminal_reference)
from montecarlo_tpu_torch.rng.normal import boxmuller_pair
from montecarlo_tpu_torch.rng.threefry import (MASK32, key_from_seed,
                                               threefry2x32)

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

_SHIM = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <utility>
#include <vector>

// log32's seed: torch's log of the same argument, looked up by its bits
// (NaN for an argument the plain version never took).
static std::vector<std::pair<uint32_t, float>> g_logs;
static float given_logf(float x) {
  uint32_t k;
  memcpy(&k, &x, sizeof k);
  auto it = std::lower_bound(g_logs.begin(), g_logs.end(),
                             std::make_pair(k, -INFINITY));
  return it != g_logs.end() && it->first == k ? it->second : NAN;
}
#define logf given_logf

#include "basket_step.cuh"
#include "functionals.cuh"

namespace {

// The normals of the n paths, (n_pairs, n, 2A) from torch: z[.., 2c] and
// z[.., 2c + 1] are call c's.
struct Given {
  const float* z;
  int64_t n, i;
  int A;
  template <int U>
  void calls(uint32_t j, int c, float* out) const {
    for (int u = 0; u < U; ++u) {
      const int64_t k = (((int64_t)j * n + i) * A + c + u) * 2;
      out[2 * u] = z[k];
      out[2 * u + 1] = z[k + 1];
    }
  }
};

// K2 (functionals == nullptr) or K4 on every path, as the kernels'
// per-path loop runs it; out (1 + spec.n, n).
template <int A, int U>
void run(float* out, const float* leaves, int64_t n, int n_steps,
         const float* z, const uint8_t* mirror, const mcf::FunctionalSpec* fs,
         bool staged) {
  std::vector<float> s(bstep::Layout<A>::kFloats, 0.0f);
  std::vector<float> pair_z(2 * A);  // a staged pair's normals
  float* zs = staged ? pair_z.data() : nullptr;
  bstep::stage<A>(s.data(), leaves, 0, 1);
  const float* sp = s.data();
  for (int64_t i = 0; i < n; ++i) {
    float log_s[A];
    bstep::init<A>(sp, log_s);
    const Given src{z, n, i, A};
    if (fs == nullptr) {
      auto none = [](int) {};
      bstep::run_pairs<A, U>(sp, log_s, src, mirror[i] != 0, n_steps, none,
                             zs, 1);
      out[i] = bstep::value<A>(sp, log_s);
      continue;
    }
    const mcf::FunctionalSpec& spec = *fs;
    const mcf::Needs need = mcf::needs(spec);
    float acc[mcf::kMaxFunctionals][4], obs[mcf::kMaxFunctionals];
    auto observe = [&]() {
      float price = 0.0f, logp = 0.0f;
      if (need.price || need.log) price = bstep::value<A>(sp, log_s);
      if (need.log) logp = mc::log32(price);
      mcf::observations(spec, price, logp, obs);
    };
    observe();
    for (int k = 0; k < spec.n; ++k) {
      mcf::fn_init(spec.code[k], spec.period[k], spec.p[k], obs[k],
                   acc[k]);
    }
    auto after = [&](int t) {
      observe();
      for (int k = 0; k < spec.n; ++k) {
        mcf::fn_update(spec.code[k], spec.period[k], spec.p[k], obs[k], t + 1,
                       acc[k]);
      }
    };
    bstep::run_pairs<A, U>(sp, log_s, src, mirror[i] != 0, n_steps, after,
                           zs, 1);
    out[i] = bstep::value<A>(sp, log_s);
    for (int k = 0; k < spec.n; ++k) {
      out[(k + 1) * n + i] =
          mcf::fn_finalize(spec.code[k], spec.p[k], acc[k], n_steps);
    }
  }
}

// u = 0: the card's lanes for A; staged < 0: the card's choice for A.
template <int A>
int run_lanes(int u, int staged, float* out, const float* leaves, int64_t n,
              int n_steps, const float* z, const uint8_t* mirror,
              const mcf::FunctionalSpec* fs) {
  const bool st = staged < 0 ? bstep::staged_for(A) : staged != 0;
  switch (u == 0 ? bstep::lanes_for(A) : u) {
    case 1: run<A, 1>(out, leaves, n, n_steps, z, mirror, fs, st); return 0;
    case 2: run<A, 2>(out, leaves, n, n_steps, z, mirror, fs, st); return 0;
    case 4: run<A, 4>(out, leaves, n, n_steps, z, mirror, fs, st); return 0;
    default: return 1;
  }
}

template <int... As>
int by_assets(std::integer_sequence<int, As...>, int a_n, int u, int staged,
              float* out, const float* leaves, int64_t n, int n_steps,
              const float* z, const uint8_t* mirror,
              const mcf::FunctionalSpec* fs) {
  int rc = 1;
  (void)((a_n == As + 1 &&
          (rc = run_lanes<As + 1>(u, staged, out, leaves, n, n_steps, z,
                                  mirror, fs),
           true)) ||
         ...);
  return rc;
}

}  // namespace

extern "C" {
void host_set_logs(const uint32_t* keys, const float* vals, long n) {
  g_logs.clear();
  for (long i = 0; i < n; ++i) g_logs.emplace_back(keys[i], vals[i]);
  std::sort(g_logs.begin(), g_logs.end());
}
// n_functionals < 0: K2.  codes, periods (n_functionals,), params
// (n_functionals, kMaxParams).
int host_basket(int a_n, int lanes, int staged, float* out, const float* leaves,
                int64_t n, int n_steps, const float* z, const uint8_t* mirror,
                int n_functionals, const int* codes, const int* periods,
                const float* params) {
  mcf::FunctionalSpec spec = {};
  spec.out_stride = n;
  spec.n = n_functionals;
  for (int k = 0; k < n_functionals; ++k) {
    spec.code[k] = codes[k];
    spec.period[k] = periods[k] < 1 ? 1 : periods[k];
    for (int q = 0; q < mcf::kMaxParams; ++q) {
      spec.p[k][q] = params[k * mcf::kMaxParams + q];
    }
  }
  return by_assets(std::make_integer_sequence<int, bstep::kMaxAssets>{}, a_n,
                   lanes, staged, out, leaves, n, n_steps, z, mirror,
                   n_functionals < 0 ? nullptr : &spec);
}
}
"""

ASSETS = [1, 2, 3, 4, 5, 7, 8, 9, 15, 16]
# One path offset per step count; at 7 steps the ids wrap past 2^32.
OFFSETS = {1: 0, 7: 2**32 - 150, 8: 12345}
N_PATHS = 301  # odd: the last antithetic pair is cut
FNS = {"avg": {"avg": ARITH_MEAN},
       "avg,mx,mn": {"avg": ARITH_MEAN, "mx": RUNNING_MAX,
                     "mn": RUNNING_MIN}}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build basket_step.cuh for the host")
    d = tmp_path_factory.mktemp("basket_step")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    so_lib = ctypes.CDLL(str(so))
    so_lib.host_set_logs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_long]
    so_lib.host_basket.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return so_lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _normals(a_n, n, n_steps, seed, path_offset, antithetic):
    """(n_pairs, n, 2A) Box-Muller halves at K2's counters (draw id, j * A
    + c), call c's pair at [.., 2c:2c+2], from the port's torch functions;
    and the per-path mirror flags (odd ids of an antithetic run)."""
    k0, k1 = key_from_seed(seed)
    ids = path_ids_for(n, path_offset, torch.device("cpu"))
    draw_ids = (ids >> 1 if antithetic else ids)[:, None]
    calls = torch.arange(a_n, dtype=torch.int64)[None, :]
    pairs = []
    for j in range((n_steps + 1) // 2):
        z0, z1 = boxmuller_pair(*threefry2x32(k0, k1, draw_ids,
                                              (j * a_n + calls) & MASK32))
        pairs.append(torch.stack([z0, z1], dim=2).reshape(n, 2 * a_n))
    mirror = ((ids & 1) == 1) & antithetic
    return (torch.stack(pairs).contiguous(),
            mirror.to(torch.uint8).contiguous())


def _plain(fn, *args, **kw):
    """``fn(*args, **kw)`` (a plain version) and the (argument, value)
    pairs of every torch.log it took, as uint32 bits and float32."""
    seen = []
    log = torch.log

    def recording(x, *a, **k):
        y = log(x, *a, **k)
        seen.append((x.detach().reshape(-1), y.detach().reshape(-1)))
        return y

    torch.log = recording
    try:
        out = fn(*args, **kw)
    finally:
        torch.log = log
    xs = torch.cat([x for x, _ in seen]).contiguous()
    ys = torch.cat([y for _, y in seen]).contiguous()
    return out, xs.view(torch.int32), ys


def _host(lib, basket, n_steps, seed, offset, antithetic, logs, fns=None,
          lanes=0, staged=-1):
    """The shim's K2 prices (n,), or K4's {"terminal": ..., name: ...},
    with log32's seeds ``logs`` = (argument bits, value); ``lanes`` 0 and
    ``staged`` -1 are the card's choices for A."""
    a_n, n = basket.n_assets, N_PATHS
    lib.host_set_logs(_ptr(logs[0]), _ptr(logs[1]), logs[0].numel())
    z, mirror = _normals(a_n, n, n_steps, seed, offset, antithetic)
    leaves = _leaves(basket)[2].contiguous()
    codes = (ctypes.c_int * MAX_FUNCTIONALS)()
    periods = (ctypes.c_int * MAX_FUNCTIONALS)()
    params = (ctypes.c_float * (MAX_FUNCTIONALS * MAX_PARAMS))()
    forms = _device_forms(tuple(fns.items()), n_steps) if fns else []
    for k, f in enumerate(forms):
        codes[k], periods[k] = f.code, f.period
        for q, v in enumerate(f.params):
            params[k * MAX_PARAMS + q] = v
    out = torch.full((1 + len(forms), n), float("nan"), dtype=torch.float32)
    rc = lib.host_basket(a_n, lanes, staged, _ptr(out), _ptr(leaves), n,
                         n_steps, _ptr(z), _ptr(mirror),
                         len(forms) if fns else -1, codes, periods, params)
    assert rc == 0
    if not fns:
        return out[0]
    return {"terminal": out[0], **{k: out[i + 1]
                                   for i, k in enumerate(fns)}}


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [1, 7, 8])
@pytest.mark.parametrize("a_n", ASSETS)
def test_k2_streamed_pair_bitwise_equal_plain(lib, a_n, n_steps, antithetic):
    basket = bench_basket(a_n, device="cpu")
    seed, offset = 29, OFFSETS[n_steps]
    want, *logs = _plain(fused_terminal_reference, basket, N_PATHS, n_steps,
                         seed=seed, path_offset=offset, antithetic=antithetic)
    got = _host(lib, basket, n_steps, seed, offset, antithetic, logs)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("fns", list(FNS))
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", [1, 7, 8])
@pytest.mark.parametrize("a_n", ASSETS)
def test_k4_streamed_pair_bitwise_equal_plain(lib, a_n, n_steps, antithetic,
                                              fns):
    """K4's loop: one observation after every step, made once step 2j is
    whole and before step 2j+1's draws are used."""
    basket = bench_basket(a_n, device="cpu")
    seed, offset = 31, OFFSETS[n_steps]
    want, *logs = _plain(fused_functionals_reference, basket, N_PATHS,
                         n_steps, seed=seed, path_offset=offset,
                         antithetic=antithetic, functionals=FNS[fns])
    got = _host(lib, basket, n_steps, seed, offset, antithetic, logs,
                FNS[fns])
    assert set(got) == set(want)
    for k in want:
        assert torch.isfinite(want[k]).all(), k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("staged", [0, 1])
@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("a_n", [3, 5, 9, 16])
def test_lock_step_lanes_change_no_bit(lib, a_n, lanes, staged):
    """The calls made U at a time in lock step (a ragged last batch, a
    batch across the steps' boundary) feed the same normals in the same
    order as one at a time, streamed or staged."""
    basket = bench_basket(a_n, device="cpu")
    want, *logs = _plain(fused_functionals_reference, basket, N_PATHS, 7,
                         seed=5, antithetic=True,
                         functionals=FNS["avg,mx,mn"])
    got = _host(lib, basket, 7, 5, 0, True, logs, FNS["avg,mx,mn"],
                lanes=lanes, staged=staged)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _terminal_in_other_order(basket, n_steps, seed, order):
    """K2 on the plain version's draws with one change of order: the
    Cholesky columns summed last to first ("reversed columns"), or the
    increment grouped as (log_s + drift) + scale zc ("regrouped
    increment")."""
    k0, k1 = key_from_seed(seed)
    ids = path_ids_for(N_PATHS, 0, torch.device("cpu"))
    a_n = basket.n_assets
    chol = basket.chol_flat.reshape(a_n, a_n)
    drift, scale = basket.drift_scale()
    state = basket.init_state(ids)
    for j in range(n_steps // 2):  # an even count: both steps of each pair
        for eps in basket.draws_pair(k0, k1, ids, j):
            new = []
            for a in range(a_n):
                cols = list(range(a + 1))
                if order == "reversed columns":
                    cols = cols[::-1]
                zc = chol[a, cols[0]] * eps[cols[0]]
                for b in cols[1:]:
                    zc = zc + chol[a, b] * eps[b]
                if order == "regrouped increment":
                    new.append((state[a] + drift[a]) + scale[a] * zc)
                else:
                    new.append(state[a] + (drift[a] + scale[a] * zc))
            state = tuple(new)
    return basket.prices(state)


@pytest.mark.parametrize("order", ["reversed columns",
                                   "regrouped increment"])
def test_the_data_tell_the_orders_apart(lib, order):
    """A column taken out of order or a regrouped sum changes bits on these
    inputs, so the bitwise tests above would catch either in the header;
    the shim keeps the plain version's order."""
    basket = bench_basket(9, device="cpu")
    want, *logs = _plain(fused_terminal_reference, basket, N_PATHS, 8,
                         seed=3)
    other = _terminal_in_other_order(basket, 8, 3, order)
    same = _terminal_in_other_order(basket, 8, 3, "plain")
    assert torch.equal(same, want)
    assert not torch.equal(other, want)
    assert torch.equal(_host(lib, basket, 8, 3, 0, False, logs), want)

