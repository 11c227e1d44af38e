"""The steps of Euler GBM, term-structure GBM, Vasicek, CIR, Hull-White
and G2++ as K2-K4 run them (``csrc/rate_steps.cuh``), built for the host
with g++ (-ffp-contract=off, as the card's -fmad=false) and walked path
by path, step by step, on the draws of K2's plain version
(``ops.fused_engine._step_draws``: Threefry, plain and antithetic): each
step's constructor and every step bitwise the torch plain version
(``fused_terminal_reference``) at T in {1, 7, 64}.

Bitwise here rests on the same float32 operations in the same order: the
header's constants are computed once per launch where the plain version
computes them every step, from the same leaves, so they hold the same
bits.  The host's ``sqrtf`` and ``logf`` (log32's seed) are not torch's
on the CPU (torch's float32 ``sqrt`` there is not the IEEE root for about
0.6% of arguments, where the card's is), so the shim takes each root and
log from a table of the plain version's own: every argument torch's
``sqrt`` and ``log`` took in the run, looked up by its bits (NaN for an
argument the plain version never took).  A regrouped Hull-White mean
(theta ((1 - decay) / a) for (theta / a)(1 - decay)) or Vasicek's step in
the textbook's grouping (r decay + theta (1 - decay) for theta + (r -
theta) decay) changes bits: the walk catches either.  (Reordering
((-2) kappa) dt as (-2)(kappa dt) changes none: a product by -2 is
exact.)
"""

import ctypes

import numpy as np
import pytest

from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops.fused_engine import (_leaves, _step_draws,
                                                   fused_terminal_reference)
from montecarlo_tpu_torch.processes import (CIR, G2PP, EulerGBM, HullWhite,
                                            TermStructureGBM, Vasicek)
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from tests.torch_host_shim import (TABLE_PRELUDE, build, ptr, recorded,
                                   set_tables)

N_PATHS = 4096
SEED = 19

_SHIM = TABLE_PRELUDE + r"""
#include "rate_steps.cuh"

// A Hull-White step with its mean regrouped, and Vasicek's step in the
// textbook's grouping: the forms the walk must tell apart.
struct HullWhiteRegrouped : mc::HullWhiteStep {
  using mc::HullWhiteStep::HullWhiteStep;
  State step(State s, const float* eps, int t) const {
    const float mean = theta[t] * (one_decay / a);
    return State{(s.r * decay + mean) + scale * eps[0]};
  }
};
struct VasicekTextbook : mc::VasicekStep {
  using mc::VasicekStep::VasicekStep;
  State step(State s, const float* eps, int) const {
    return State{(s.r * decay + theta * (1.0f - decay)) + scale * eps[0]};
  }
};

template <class Step>
static void walk(const float* leaves, int dims, long n, int T,
                 const float* eps, int D, float* out) {
  const Step step(leaves, dims);
  for (long i = 0; i < n; ++i) {
    typename Step::State s = step.init();
    float e[2];
    for (int t = 0; t < T; ++t) {
      for (int d = 0; d < D; ++d) e[d] = eps[((long)t * D + d) * n + i];
      s = step.step(s, e, t);
    }
    out[i] = step.prices(s);
  }
}

#define WALK(name, type)                                                  \
  extern "C" void name(const float* leaves, int dims, long n, int T,      \
                       const float* eps, int D, float* out) {             \
    walk<type>(leaves, dims, n, T, eps, D, out);                          \
  }
WALK(walk_euler_gbm, mc::EulerGbmStep)
WALK(walk_term_gbm, mc::TermGbmStep)
WALK(walk_vasicek, mc::VasicekStep)
WALK(walk_cir, mc::CirStep)
WALK(walk_hull_white, mc::HullWhiteStep)
WALK(walk_g2pp, mc::G2ppStep)
WALK(walk_hull_white_regrouped, HullWhiteRegrouped)
WALK(walk_vasicek_textbook, VasicekTextbook)
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory, "rate_steps", _SHIM)


def _processes():
    """Each process at the bond CLI's defaults (Euler GBM at the price
    CLI's), the curves of 64 steps."""
    dt = 2.0 / 64
    rng = np.random.default_rng(5)
    fwd = 0.03 + 0.005 * np.arange(65) * dt
    return {
        "euler_gbm": EulerGBM.create(100.0, 0.03, 0.2, 1 / 64, device="cpu"),
        "term_gbm": TermStructureGBM.from_curves(
            100.0, rng.uniform(0.0, 0.05, 64), rng.uniform(0.1, 0.3, 64),
            1 / 64, device="cpu"),
        "vasicek": Vasicek.create(0.03, 0.8, 0.05, 0.015, dt, device="cpu"),
        "cir": CIR.create(0.03, 0.8, 0.05, 0.015, dt, device="cpu"),
        "hull_white": HullWhite.from_forward_curve(fwd, 0.8, 0.015, dt,
                                                   device="cpu"),
        "g2pp": G2PP.create(0.03, 0.8, 0.015, 0.1, 0.01, -0.7, dt,
                            device="cpu"),
    }


PROCS = _processes()


def _walk(lib, name, proc, T, antithetic):
    """The header's walk on the plain version's draws, roots and logs,
    beside the plain version's terminal prices."""
    _, dims, leaves = _leaves(proc)
    k0, k1 = key_from_seed(SEED, 0)
    ids = path_ids_for(N_PATHS, 0, proc.device)
    eps = np.stack([np.stack([e.numpy() for e in eps]) for _, eps in
                    _step_draws(proc, T, k0, k1, ids, antithetic)])
    eps = np.ascontiguousarray(eps, np.float32)      # (T, D, n)
    leaves = np.ascontiguousarray(leaves.numpy(), np.float32)
    want, tables = recorded(fused_terminal_reference, proc, N_PATHS, T,
                            seed=SEED, antithetic=antithetic)
    set_tables(lib, tables)
    out = np.empty(N_PATHS, np.float32)
    getattr(lib, name)(ptr(leaves), dims, ctypes.c_long(N_PATHS), T,
                       ptr(eps), proc.n_draws, ptr(out))
    return out, want.numpy()


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("T", [1, 7, 64])
@pytest.mark.parametrize("kind", list(PROCS))
def test_header_step_is_the_plain_version(lib, kind, T, antithetic):
    got, want = _walk(lib, f"walk_{kind}", PROCS[kind], T, antithetic)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,variant", [
    ("hull_white", "walk_hull_white_regrouped"),
    ("vasicek", "walk_vasicek_textbook"),
])
def test_a_regrouped_step_changes_bits(lib, kind, variant):
    got, want = _walk(lib, variant, PROCS[kind], 64, False)
    assert (got != want).any(), "the walk cannot tell the forms apart"
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
