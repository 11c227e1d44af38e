"""K4's folds fixed at compile time (``csrc/functionals.cuh``'s FixedFold),
built for the host with g++, against its generic fold (SpecFold, the codes
read at run time) and K4's plain version.

The shim below runs a fold over each path's observations as K4's per-path
loop does: ``init`` on the initial state's price and log price, then
``update`` after every step with the 1-based step index, then
``finalize``.  The observations come from torch: the price and log price
of a GBM after each step of ``fused_functionals_reference``'s own loop
(the kernels' draws, plain or antithetic).  Each fixed fold must equal the
generic fold and ``fused_functionals_reference`` bitwise: they run the same
float32 operations (the autocall's and cliquet's integer countdown in
place of ``t % period``, true at the same steps), so this is where the
compile-time folds are held without a card.  Built with -ffp-contract=off,
as the device build uses -fmad=false.  Skips when no C++ compiler is
present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN, RUNNING_MAX,
                                         RUNNING_MIN, autocallable,
                                         barrier_survival_up, cliquet_sum,
                                         realized_variance,
                                         trapezoid_integral)
from montecarlo_tpu_torch.engine.functionals import MAX_PARAMS
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.engine.surface import price_snapshot
from montecarlo_tpu_torch.ops.fused_engine import (
    _device_forms, _step_draws, fused_functionals_reference)
from montecarlo_tpu_torch.processes import GBM
from montecarlo_tpu_torch.rng.threefry import key_from_seed

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

_SHIM = r"""
#include <type_traits>

#include "functionals.cuh"

namespace {

// Every single-code fold and the kernels' sets: what the test may ask
// the fixed fold of.
using Candidates = mcf::FoldList<
    mcf::FixedFold<0>, mcf::FixedFold<1>, mcf::FixedFold<2>,
    mcf::FixedFold<3>, mcf::FixedFold<4>, mcf::FixedFold<5>,
    mcf::FixedFold<6>, mcf::FixedFold<7>, mcf::FixedFold<8>,
    mcf::FixedFold<0, 2, 3>>;

mcf::FunctionalSpec make_spec(int n_fn, const int* codes, const int* periods,
                              const float* params, long n) {
  mcf::FunctionalSpec spec = {};
  spec.out_stride = n;
  spec.n = n_fn;
  for (int k = 0; k < n_fn; ++k) {
    spec.code[k] = codes[k];
    // As csrc/fused_k4.cu builds the spec: a snapshot keeps step 0.
    spec.period[k] =
        periods[k] < 1 && codes[k] != mcf::kSnapshot ? 1 : periods[k];
    for (int q = 0; q < mcf::kMaxParams; ++q) {
      spec.p[k][q] = params[k * mcf::kMaxParams + q];
    }
  }
  return spec;
}

// K4's per-path fold over observations price, logp (T + 1, n); out
// (1 + n_fn, n), row 0 left alone.
template <class Fold>
int run(const mcf::FunctionalSpec& spec, long n, int T, const float* price,
        const float* logp, float* out) {
  for (long i = 0; i < n; ++i) {
    Fold fold;
    fold.init(spec, price[i], logp[i]);
    for (int t = 1; t <= T; ++t) {
      fold.update(spec, price[t * n + i], logp[t * n + i], t);
    }
    fold.finalize(spec, out, i, T);
  }
  return 0;
}

}  // namespace

extern "C" {
// fixed = 0: SpecFold; 1: the FixedFold of these codes (-1 if the shim
// has none).
int fold_run(int fixed, int n_fn, const int* codes, const int* periods,
             const float* params, long n, int T, const float* price,
             const float* logp, float* out) {
  const mcf::FunctionalSpec spec = make_spec(n_fn, codes, periods, params, n);
  if (!fixed) return run<mcf::SpecFold>(spec, n, T, price, logp, out);
  int rc = -1;
  (void)mcf::with_fold(Candidates{}, spec, [&](auto fold) {
    if constexpr (!std::is_same_v<decltype(fold), mcf::SpecFold>) {
      rc = run<decltype(fold)>(spec, n, T, price, logp, out);
    }
    return 0;
  });
  return rc;
}
// The index in the kernels' FixedFolds of the set the codes name, or -1:
// the generic fold.
int fold_choice(int n_fn, const int* codes) {
  mcf::FunctionalSpec spec = {};
  spec.n = n_fn;
  for (int k = 0; k < n_fn; ++k) spec.code[k] = codes[k];
  return mcf::fixed_fold_index(spec);
}
// Whether FixedFold<codes...> needs the price and the log price.
int fold_needs(int n_fn, const int* codes) {
  mcf::FunctionalSpec spec = {};
  spec.n = n_fn;
  for (int k = 0; k < n_fn; ++k) spec.code[k] = codes[k];
  int r = -1;
  (void)mcf::with_fold(Candidates{}, spec, [&](auto fold) {
    if constexpr (!std::is_same_v<decltype(fold), mcf::SpecFold>) {
      const mcf::Needs need = decltype(fold)::needs(spec);
      r = (need.price ? 1 : 0) + (need.log ? 2 : 0);
    }
    return 0;
  });
  return r;
}
}
"""

STEPS = [1, 7, 8, 63, 64, 65]
PERIODS = [1, 3, 63]
N = 40
DT = 1 / 64


def _sets(period):
    """The functional sets the test folds: each code alone (the cliquet
    and the autocall with ``period``), and the app's {avg, mx, mn}."""
    return {
        "avg": {"avg": ARITH_MEAN},
        "geo": {"geo": GEO_MEAN},
        "mx": {"mx": RUNNING_MAX},
        "mn": {"mn": RUNNING_MIN},
        "surv": {"surv": barrier_survival_up(103.0, 0.2, DT)},
        "cliquet": {"cl": cliquet_sum(period, -0.02, 0.03)},
        "autocall": {"ac": autocallable(period, 100.5, 0.02, 0.03 * DT,
                                        98.0, 100.0)},
        "rv": {"rv": realized_variance()},
        "tr": {"tr": trapezoid_integral(DT)},
        "avg_mx_mn": {"avg": ARITH_MEAN, "mx": RUNNING_MAX,
                      "mn": RUNNING_MIN},
    }


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build functionals.cuh for the host")
    d = tmp_path_factory.mktemp("fold")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _gbm():
    return GBM.create(100.0, 0.03, 0.3, DT, device="cpu")


def _observations(proc, n_steps, antithetic, seed=4, offset=2**32 - 20):
    """(price, logp), each (T + 1, N) float32: the GBM's observations
    after every step of K4's plain version's loop."""
    k0, k1 = key_from_seed(seed, 0)
    ids = path_ids_for(N, offset, proc.device)
    state = proc.init_state(ids)
    prices, logs = [proc.prices(state)], [proc.log_prices(state)]
    for t, eps in _step_draws(proc, n_steps, k0, k1, ids, antithetic):
        state = proc.step(state, eps, t)
        prices.append(proc.prices(state))
        logs.append(proc.log_prices(state))
    return (np.ascontiguousarray(torch.stack(prices).numpy(), np.float32),
            np.ascontiguousarray(torch.stack(logs).numpy(), np.float32))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _form_steps(fns, n_steps, period):
    """The step count the device forms are built for: n_steps, or for an
    autocall whose period does not divide it (its form refuses such a
    run) the next multiple of the period, which only sets the discount to
    maturity that its finalize reads."""
    return n_steps if "ac" not in fns else -(-n_steps // period) * period


def _fold(lib, fixed, fns, n_steps, price, logp, form_steps):
    forms = _device_forms(tuple(fns.items()), form_steps)
    codes = np.array([f.code for f in forms], np.int32)
    periods = np.array([f.period for f in forms], np.int32)
    params = np.zeros((len(forms), MAX_PARAMS), np.float32)
    for k, f in enumerate(forms):
        params[k, :len(f.params)] = f.params
    out = np.full((1 + len(forms), N), np.nan, np.float32)
    rc = lib.fold_run(ctypes.c_int(fixed), ctypes.c_int(len(forms)),
                      _ptr(codes), _ptr(periods), _ptr(params),
                      ctypes.c_long(N), ctypes.c_int(n_steps), _ptr(price),
                      _ptr(logp), _ptr(out))
    assert rc == 0, "the shim has no fixed fold of these codes"
    return {name: out[k + 1] for k, name in enumerate(fns)}


def _plain(fns, n_steps, price, logp, form_steps):
    """The functionals' own torch folds over the same observations, as
    K4's plain version runs them: init, update(acc, obs, t) for t = 1 ..
    T, finalize(acc, form_steps)."""
    out = {}
    for name, f in fns.items():
        obs = torch.from_numpy(logp if f.space == "log" else price)
        acc = f.init(obs[0])
        for t in range(1, n_steps + 1):
            acc = f.update(acc, obs[t], t)
        out[name] = f.finalize(acc, float(form_steps)).numpy()
    return out


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", STEPS)
@pytest.mark.parametrize("name", list(_sets(1)))
def test_fixed_fold_equals_generic_and_plain(lib, name, n_steps,
                                             antithetic):
    """Each code alone and the app's set: the fixed fold, the generic fold
    and the plain fold give the same bits on the same observations, and
    equal K4's plain version where the functionals take the run; the
    cliquet and the autocall at periods 1, 3 and 63, so that the countdown
    meets ``t % period`` before, at and past T."""
    proc = _gbm()
    price, logp = _observations(proc, n_steps, antithetic)
    periods = PERIODS if name in ("cliquet", "autocall") else [1]
    for period in periods:
        fns = _sets(period)[name]
        steps = _form_steps(fns, n_steps, period)
        fixed = _fold(lib, 1, fns, n_steps, price, logp, steps)
        generic = _fold(lib, 0, fns, n_steps, price, logp, steps)
        plain = _plain(fns, n_steps, price, logp, steps)
        want = plain
        if steps == n_steps:
            want = fused_functionals_reference(
                proc, N, n_steps, seed=4, path_offset=2**32 - 20,
                antithetic=antithetic, functionals=fns)
            want = {k: v.numpy() for k, v in want.items()}
        for k in fns:
            assert np.isfinite(fixed[k]).all(), (k, period)
            assert np.array_equal(fixed[k], generic[k]), (k, period)
            assert np.array_equal(fixed[k], plain[k]), (k, period)
            assert np.array_equal(fixed[k], want[k]), (k, period)


def test_the_countdown_fires_where_the_modulus_does(lib):
    """The cliquet's resets, seen in its leg: on a path that rises every
    step, with a floor below and a cap above every return, the leg sums
    one return per reset, floor(T / period) of them."""
    n_steps = 65
    price = np.tile(np.float32(100.0) * np.float32(1.01) ** np.arange(
        n_steps + 1, dtype=np.float32), (N, 1)).T.astype(np.float32)
    price = np.ascontiguousarray(price)
    logp = np.ascontiguousarray(np.log(price))
    for period in PERIODS:
        fns = {"cl": cliquet_sum(period, -1.0, 1.0)}
        got = _fold(lib, 1, fns, n_steps, price, logp, n_steps)["cl"]
        assert np.array_equal(got, _fold(lib, 0, fns, n_steps, price, logp,
                                         n_steps)["cl"])
        ret = np.float32(1.01) ** period - 1
        np.testing.assert_allclose(got, (n_steps // period) * ret,
                                   rtol=1e-4)


def _codes(fns, n_steps=63):
    return np.array([f.code for f in _device_forms(tuple(fns.items()),
                                                   n_steps)], np.int32)


def test_kernels_fixed_sets_and_the_generic_fold(lib):
    """The kernels' FixedFolds: {avg}, {avg, mx, mn}, {surv}, the autocall,
    the cliquet and the bond models' {trap}, in that order (a set added
    goes last, so the indices before it keep their sets); a set outside
    them ({avg, geo}; the app's set in another order; {mx} alone) reaches
    the generic fold."""
    sets = _sets(3)
    fixed = [sets["avg"], sets["avg_mx_mn"], sets["surv"], sets["autocall"],
             sets["cliquet"], sets["tr"]]
    for k, fns in enumerate(fixed):
        codes = _codes(fns)
        assert lib.fold_choice(ctypes.c_int(len(codes)), _ptr(codes)) == k
    outside = [{"avg": ARITH_MEAN, "geo": GEO_MEAN},
               {"mx": RUNNING_MAX, "avg": ARITH_MEAN, "mn": RUNNING_MIN},
               {"mx": RUNNING_MAX}, {"m": price_snapshot(3)}, {}]
    for fns in outside:
        codes = _codes(fns) if fns else np.zeros(1, np.int32)
        assert lib.fold_choice(ctypes.c_int(len(fns)), _ptr(codes)) == -1


def test_fixed_fold_needs_only_what_its_codes_read(lib):
    """A fixed fold's observations are chosen at compile time: the price
    for the means, the cliquet and the autocall, the log price for the
    log-space codes, both for the app's set."""
    sets = _sets(3)
    expect = {"avg": 1, "geo": 2, "mx": 2, "mn": 2, "surv": 2, "cliquet": 1,
              "autocall": 1, "rv": 2, "tr": 1, "avg_mx_mn": 3}
    for name, need in expect.items():
        codes = _codes(sets[name])
        assert lib.fold_needs(ctypes.c_int(len(codes)), _ptr(codes)) == need


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_steps", STEPS)
def test_snapshot_on_the_generic_fold(lib, n_steps, antithetic):
    """K4's snapshot (kSnapshot, the generic fold) at step 0 (the spot),
    step 1, a middle step, the last step and one past it (never latched:
    0), alone and four at a time: bitwise its plain fold, K4's plain
    version, and the price observed at its step."""
    proc = _gbm()
    price, logp = _observations(proc, n_steps, antithetic)
    picks = sorted({0, 1, max(n_steps // 2, 1), n_steps, n_steps + 1})
    sets = [{f"s{s}": price_snapshot(s)} for s in picks]
    sets.append({f"s{s}": price_snapshot(s) for s in picks[-4:]})
    for fns in sets:
        generic = _fold(lib, 0, fns, n_steps, price, logp, n_steps)
        plain = _plain(fns, n_steps, price, logp, n_steps)
        want = fused_functionals_reference(
            proc, N, n_steps, seed=4, path_offset=2**32 - 20,
            antithetic=antithetic, functionals=fns)
        for k, f in fns.items():
            step = f.device(n_steps).period
            latched = (price[step] if step <= n_steps
                       else np.zeros(N, np.float32))
            assert np.array_equal(generic[k], plain[k]), k
            assert np.array_equal(generic[k], want[k].numpy()), k
            assert np.array_equal(generic[k], latched), k
