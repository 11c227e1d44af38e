"""K4's per-path loop on the bond models and the term basket, built for the
host with g++ and walked with both of K4's folds against the port's plain
version.

The shim below is K4's loop as ``csrc/fused_engine.cuh::
fused_functional_kernel`` runs it on these functors: the step of
``csrc/rate_steps.cuh`` (Vasicek, CIR, Hull-White, G2++) or
``csrc/mgarch_steps.cuh`` (``TermBasketStep<A>``), the observation (the
price, and log32 of it only when the fold reads a log), and the fold of
``csrc/functionals.cuh``: ``init`` on the initial state, ``update`` after
every step with the 1-based step index, ``finalize``.  The fold is the one
the kernels' ``FixedFolds`` names for the spec (``with_fold``): the fixed
{trap} on the rate steps, the fixed {avg} on the term basket, which the
card's K4 runs on the ``bond`` path and the term basket's Asian; or the
generic fold (``SpecFold``).  Both must equal each other and
``fused_functionals_reference`` bitwise, terminal and functional, at A in
{1, 2, 5, 8} for the term basket and T in {1, 7, 64}, plain and antithetic
(tests/test_torch_rates.py and tests/test_torch_term_basket.py hold that
reference to the JAX package).  The draws are the plain version's
(``_step_draws``); each root and log is taken from a table of the plain
version's own (tests/torch_host_shim.py: torch's CPU float32 ``sqrt`` is not
the IEEE root for ~0.6% of arguments).  Built with -ffp-contract=off, as
the device build uses -fmad=false.  A trapezoid update regrouped as
``(sum + prev h) + obs h`` changes bits: the walk catches it.
"""

import ctypes

import numpy as np
import pytest

from montecarlo_tpu_torch.engine import ARITH_MEAN, trapezoid_integral
from montecarlo_tpu_torch.engine.functionals import MAX_PARAMS
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops.fused_engine import (_device_forms, _leaves,
                                                   _step_draws,
                                                   fused_functionals_reference)
from montecarlo_tpu_torch.processes import (CIR, G2PP, HullWhite,
                                            TermBasketGBM, Vasicek)
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from tests.torch_host_shim import (TABLE_PRELUDE, build, ptr, recorded,
                                   set_tables)

N, SEED, CURVE = 1024, 29, 64

_SHIM = TABLE_PRELUDE + r"""
#include <type_traits>

#include "functionals.cuh"
#include "mgarch_steps.cuh"
#include "rate_steps.cuh"

namespace {

// The trapezoid slot regrouped as (sum + prev h) + obs h: the form the
// walk must tell apart from Slot<kTrapezoid>.
struct TrapRegrouped {
  float sum, prev;
  static mcf::Needs needs(const mcf::FunctionalSpec&) {
    return mcf::Needs{true, false};
  }
  void init(const mcf::FunctionalSpec&, float price, float) {
    sum = 0.0f;
    prev = price;
  }
  void update(const mcf::FunctionalSpec& s, float price, float, int) {
    sum = (sum + prev * s.p[0][0]) + price * s.p[0][0];
    prev = price;
  }
  void finalize(const mcf::FunctionalSpec& s, float* out, long i,
                int) const {
    out[s.out_stride + i] = sum;
  }
};

mcf::FunctionalSpec make_spec(int n_fn, const int* codes, const int* periods,
                              const float* params, long n) {
  mcf::FunctionalSpec spec = {};
  spec.out_stride = n;
  spec.n = n_fn;
  for (int k = 0; k < n_fn; ++k) {
    spec.code[k] = codes[k];
    spec.period[k] = periods[k] < 1 ? 1 : periods[k];
    for (int q = 0; q < mcf::kMaxParams; ++q) {
      spec.p[k][q] = params[k * mcf::kMaxParams + q];
    }
  }
  return spec;
}

// K4's loop over n paths of T steps on draws eps (T, D, n); out (1 + n_fn,
// n): the terminal price, then each functional.
template <class Step, class Fold>
void walk(const mcf::FunctionalSpec& spec, const float* leaves, int dims,
          long n, int T, const float* eps, int D, float* out) {
  const Step step(leaves, dims);
  const mcf::Needs need = Fold::needs(spec);
  for (long i = 0; i < n; ++i) {
    float price, logp;
    auto observe = [&](const typename Step::State& s) {
      price = need.price || need.log ? step.prices(s) : 0.0f;
      logp = need.log ? mc::log32(price) : 0.0f;
    };
    typename Step::State s = step.init();
    Fold fold;
    observe(s);
    fold.init(spec, price, logp);
    float e[mc::kMaxStateAssets];
    for (int t = 0; t < T; ++t) {
      for (int d = 0; d < D; ++d) e[d] = eps[((long)t * D + d) * n + i];
      s = step.step(s, e, t);
      observe(s);
      fold.update(spec, price, logp, t + 1);
    }
    out[i] = step.prices(s);
    fold.finalize(spec, out, i, T);
  }
}

// fold = 0: SpecFold; 1: the fold the kernels' FixedFolds names for the
// spec (-1 when it names none); 2: TrapRegrouped.
template <class Step>
int run(int fold, int n_fn, const int* codes, const int* periods,
        const float* params, const float* leaves, int dims, long n, int T,
        const float* eps, int D, float* out) {
  const mcf::FunctionalSpec spec = make_spec(n_fn, codes, periods, params, n);
  if (fold == 0) {
    walk<Step, mcf::SpecFold>(spec, leaves, dims, n, T, eps, D, out);
    return 0;
  }
  if (fold == 2) {
    walk<Step, TrapRegrouped>(spec, leaves, dims, n, T, eps, D, out);
    return 0;
  }
  return mcf::with_fold(spec, [&](auto f) {
    using F = decltype(f);
    if constexpr (std::is_same_v<F, mcf::SpecFold>) {
      return -1;
    } else {
      walk<Step, F>(spec, leaves, dims, n, T, eps, D, out);
      return mcf::fixed_fold_index(spec);
    }
  });
}

}  // namespace

#define WALK(name, type)                                                  \
  extern "C" int name(int fold, int n_fn, const int* codes,               \
                      const int* periods, const float* params,            \
                      const float* leaves, int dims, long n, int T,       \
                      const float* eps, int D, float* out) {              \
    return run<type>(fold, n_fn, codes, periods, params, leaves, dims, n, \
                     T, eps, D, out);                                     \
  }
WALK(walk_vasicek, mc::VasicekStep)
WALK(walk_cir, mc::CirStep)
WALK(walk_hullwhite, mc::HullWhiteStep)
WALK(walk_g2pp, mc::G2ppStep)
WALK(walk_term_basket_1, mc::TermBasketStep<1>)
WALK(walk_term_basket_2, mc::TermBasketStep<2>)
WALK(walk_term_basket_5, mc::TermBasketStep<5>)
WALK(walk_term_basket_8, mc::TermBasketStep<8>)
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory, "fold_state", _SHIM, opt="-O1")


def _rates():
    """The bond command's four models (its defaults: r0 3%, kappa 0.8,
    theta 5%, sigma 1.5%; Hull-White on a sloped forward curve; G2++ at b
    0.1, eta 1%, rho -0.7) on a 2-year grid of CURVE steps."""
    dt = 2.0 / CURVE
    fwd = 0.03 + 0.005 * np.arange(CURVE + 1) * dt
    return {
        "vasicek": Vasicek.create(0.03, 0.8, 0.05, 0.015, dt, device="cpu"),
        "cir": CIR.create(0.03, 0.8, 0.05, 0.015, dt, device="cpu"),
        "hullwhite": HullWhite.from_forward_curve(fwd, 0.8, 0.015, dt,
                                                  device="cpu"),
        "g2pp": G2PP.create(0.03, 0.8, 0.015, 0.1, 0.01, -0.7, dt,
                            device="cpu"),
    }


def _term_basket(a_n):
    """An A-asset term basket on seeded daily curves of CURVE steps: half a
    sample correlation and half the identity, spots in [50, 150], rates in
    [0, 5%], vols in [0.1, 0.3], equal weights."""
    rng = np.random.default_rng(a_n)
    c = np.atleast_2d(np.corrcoef(rng.normal(size=(a_n, 4 * a_n))))
    return TermBasketGBM.create(
        rng.uniform(50.0, 150.0, a_n), rng.uniform(0.0, 0.05, (a_n, CURVE)),
        rng.uniform(0.1, 0.3, (a_n, CURVE)), 0.5 * c + 0.5 * np.eye(a_n),
        np.full(a_n, 1.0 / a_n), 1 / 252, device="cpu")


RATES = _rates()
ASSETS = (1, 2, 5, 8)
#: (shim walk, process, functionals, the FixedFolds index of the set).
CASES = {
    **{k: (f"walk_{k}", p, {"trap": trapezoid_integral(float(p.dt))}, 5)
       for k, p in RATES.items()},
    **{f"term-basket A={a}": (f"walk_term_basket_{a}", _term_basket(a),
                              {"avg": ARITH_MEAN}, 0) for a in ASSETS},
}


def _walk(lib, name, proc, fns, T, antithetic, fold):
    """The shim's walk with ``fold`` (0 generic, 1 fixed, 2 the regrouped
    trapezoid) on the plain version's draws, roots and logs: (its return
    code, its outputs by name, the plain version's)."""
    forms = _device_forms(tuple(fns.items()), T)
    codes = np.array([f.code for f in forms], np.int32)
    periods = np.array([f.period for f in forms], np.int32)
    params = np.zeros((len(forms), MAX_PARAMS), np.float32)
    for k, f in enumerate(forms):
        params[k, :len(f.params)] = f.params
    _, dims, leaves = _leaves(proc)
    leaves = np.ascontiguousarray(leaves.numpy(), np.float32)
    k0, k1 = key_from_seed(SEED, 0)
    ids = path_ids_for(N, 0, proc.device)
    eps = np.stack([np.stack([e.numpy() for e in eps]) for _, eps in
                    _step_draws(proc, T, k0, k1, ids, antithetic)])
    eps = np.ascontiguousarray(eps, np.float32)  # (T, D, N)
    want, tables = recorded(fused_functionals_reference, proc, N, T,
                            seed=SEED, antithetic=antithetic, functionals=fns)
    set_tables(lib, tables)
    out = np.full((1 + len(forms), N), np.nan, np.float32)
    rc = getattr(lib, name)(
        fold, len(forms), ptr(codes), ptr(periods), ptr(params), ptr(leaves),
        dims, ctypes.c_long(N), T, ptr(eps), proc.n_draws, ptr(out))
    got = {"terminal": out[0]}
    got.update({k: out[j + 1] for j, k in enumerate(fns)})
    return rc, got, {k: v.numpy() for k, v in want.items()}


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("T", [1, 7, CURVE])
@pytest.mark.parametrize("case", list(CASES))
def test_fixed_and_generic_fold_are_the_plain_version(lib, case, T,
                                                      antithetic):
    """K4's loop with the fixed fold the kernels' FixedFolds names ({trap}
    at index 5 on the rate steps, {avg} at 0 on the term basket) and with
    the generic fold: the same bits as each other and as K4's plain
    version, terminal and functional."""
    name, proc, fns, index = CASES[case]
    rc, fixed, want = _walk(lib, name, proc, fns, T, antithetic, 1)
    assert rc == index, "the kernels' FixedFolds does not name this set"
    rc, generic, _ = _walk(lib, name, proc, fns, T, antithetic, 0)
    assert rc == 0
    for k in want:
        assert np.isfinite(fixed[k]).all(), k
        np.testing.assert_array_equal(fixed[k], generic[k], err_msg=k)
        np.testing.assert_array_equal(fixed[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", list(RATES))
def test_a_regrouped_trapezoid_changes_bits(lib, kind):
    """(sum + prev h) + obs h in place of sum + (prev + obs) h: the walk
    tells the forms apart, and they stay within float32 rounding."""
    name, proc, fns, _ = CASES[kind]
    _, got, want = _walk(lib, name, proc, fns, CURVE, False, 2)
    np.testing.assert_array_equal(got["terminal"], want["terminal"])
    assert (got["trap"] != want["trap"]).any(), \
        "the walk cannot tell the forms apart"
    np.testing.assert_allclose(got["trap"], want["trap"], rtol=1e-5,
                               atol=1e-8)
