"""CCC-GARCH and DCC-GARCH in the port against the JAX package, and the
multi-asset state steps of K2-K4 (``csrc/mgarch_steps.cuh``) on the host:

- paths from the torch loop against JAX's scan on the JAX tests' 3-asset
  book and a 5-asset one (tests/torch_state_pairs.py: per-path rtol 2e-6;
  XLA takes 7.5 s to compile DCC's unrolled 8-asset step, which the host
  walk below and the card hold bitwise instead);
- K2-K4's plain versions against the port's torch loop, bitwise, under
  Threefry (plain and antithetic) and Sobol draws;
- the gate: an 8-asset book on the kernels, a 9-asset one on the torch
  loop (bitwise the loop it runs), the bridge refused at every asset count
  by ``kernel_refusal`` before any launch;
- ``DCCGarch.create``'s errors and its snapped ``np.corrcoef`` diagonal,
  ``convert``'s round trip;
- tests/test_dcc_garch.py's oracles on the port: DCC frozen at Qbar is CCC
  (rtol 2e-5, its tolerance), and an independent NumPy port of the Engle
  recursion fed the same normals (rtol 5e-4, its tolerance);
- ``api.portfolio_var`` on the 3-asset CCC book against JAX's (the
  stream): percentiles, VaR and CVaR within a bin width, the return and
  vol (percent of the start value) within 100 SCAN_RTOL;
- the steps of ``csrc/mgarch_steps.cuh`` (term basket, CCC, DCC) built for
  the host with g++ (-ffp-contract=off, as the card's -fmad=false) and
  walked path by path on the draws of K2's plain version, bitwise the
  plain version at A in {1, 3, 8} x T in {1, 17}, plain and
  antithetic.  Torch's float32 ``sqrt`` on the CPU is not the IEEE root
  for about 0.6% of arguments, so the walk takes each root and log
  (log32's seed) from a table of the plain version's own
  (tests/torch_host_shim.py).  A DCC recursion regrouped as
  c qbar + a (eta_i eta_j) changes bits: the walk catches it.
"""

import ctypes

import numpy as np
import pytest
import torch

from montecarlo_tpu.api import portfolio_var as jportfolio_var
from montecarlo_tpu_torch.api import portfolio_var
from montecarlo_tpu_torch.api.var import _pilot_range
from montecarlo_tpu_torch.convert import process_from_numpy, process_to_numpy
from montecarlo_tpu_torch.engine import kernel_route, simulate, terminal_prices
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops import fused_functionals, fused_terminal
from montecarlo_tpu_torch.ops.fused_engine import (MAX_STATE_ASSETS, _leaves,
                                                   _step_draws,
                                                   fused_terminal_reference,
                                                   kernel_refusal,
                                                   state_launch_leaves)
from montecarlo_tpu_torch.processes import CCCGarch, DCCGarch
from montecarlo_tpu_torch.rng.sobol import SobolBridgeKernelSampler
from montecarlo_tpu_torch.rng.threefry import key_from_seed
from tests.torch_host_shim import (TABLE_PRELUDE, build, ptr, recorded,
                                   set_tables)
from tests.torch_state_pairs import (CORR3, S0_3, SCAN_RTOL, VAR0_3, W_3,
                                     book, hold_plain_versions, hold_scan,
                                     pair)

torch.set_num_threads(1)

KINDS = ("ccc-garch", "dcc-garch")
GARCH = dict(omega=[1e-5] * 3, alpha=[0.1] * 3, beta=[0.85] * 3)


def _dcc(a=0.05, b=0.9, **kw):
    return DCCGarch.create(s0=S0_3, var0=VAR0_3, qbar=CORR3, weights=W_3,
                           a_dcc=a, b_dcc=b, device="cpu", **GARCH, **kw)


@pytest.mark.parametrize("a_n", [3, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_paths_match_jax_scan(kind, a_n):
    hold_scan(kind, a_n)


@pytest.mark.parametrize("source,a_n", [("plain", 3), ("antithetic", 3),
                                        ("sobol", 3), ("plain", 8)])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_are_the_torch_loop(kind, source, a_n):
    """17 steps at 3 assets, 9 (still an odd final step) at 8, where a
    step costs the most."""
    _, tp = pair(kind, a_n)
    hold_plain_versions(tp, 17 if a_n < 8 else 9, source)


def _book(kind, a_n):
    corr, s0, var0, w = book(a_n)
    g = dict(omega=[1e-5] * a_n, alpha=[0.1] * a_n, beta=[0.85] * a_n)
    if kind == "ccc-garch":
        return CCCGarch.create(s0, var0, corr=corr, weights=w, device="cpu",
                               **g)
    return DCCGarch.create(s0, var0, qbar=corr, weights=w, device="cpu", **g)


@pytest.mark.parametrize("kind", KINDS)
def test_route_takes_eight_assets_and_sends_nine_to_the_loop(kind):
    """The gate routes by asset count before any launch: 8 assets on the
    kernels, 9 on the torch loop (the kernels' refusal names the limit and
    the wrappers raise it); the bridge is refused at every asset count."""
    eight, nine = _book(kind, MAX_STATE_ASSETS), _book(kind, 9)
    assert kernel_refusal(eight) is None and kernel_route(eight, None, 10)
    err = kernel_refusal(nine)
    assert isinstance(err, ValueError) and "at most 8" in str(err)
    assert not kernel_route(nine, None, 10)
    with pytest.raises(ValueError, match="at most 8"):
        fused_terminal(nine, 256, 10, seed=0)
    assert torch.equal(terminal_prices(nine, 256, 10, seed=4),
                       simulate(nine, 256, 10, seed=4))
    one = _book(kind, 1)
    bridge = SobolBridgeKernelSampler.create(10, scramble_seed=1,
                                             device="cpu")
    for proc in (one, eight):
        assert "bridge" in str(kernel_refusal(proc, bridge))
        assert not kernel_route(proc, bridge, 10)
    with pytest.raises(ValueError, match="bridge"):
        fused_functionals(one, 256, 10, seed=0, sampler=bridge,
                          functionals={})


@pytest.mark.parametrize("kind", KINDS)
def test_convert_round_trip(kind):
    jp, tp = pair(kind, 3)
    fields = process_to_numpy(tp)
    assert list(fields) == list(jp._fields)
    for k, v in fields.items():
        np.testing.assert_array_equal(v, np.asarray(jp._asdict()[k]), k)
    back = process_from_numpy(kind, fields, device="cpu")
    for k in fields:
        assert torch.equal(getattr(back, k), getattr(tp, k)), k
    assert torch.equal(simulate(back, 256, 9, seed=1),
                       simulate(tp, 256, 9, seed=1))


def test_dcc_create_validation():
    with pytest.raises(ValueError, match="stationarity"):
        _dcc(a=0.5, b=0.6)
    with pytest.raises(ValueError, match="correlation matrix"):
        DCCGarch.create(s0=S0_3, var0=VAR0_3, qbar=CORR3 * 2.0, weights=W_3,
                        device="cpu", **GARCH)
    asym = CORR3.copy()
    asym[0, 1] = 0.3
    with pytest.raises(ValueError, match="correlation matrix"):
        DCCGarch.create(s0=S0_3, var0=VAR0_3, qbar=asym, weights=W_3,
                        device="cpu", **GARCH)


def test_dcc_create_snaps_a_corrcoef_diagonal():
    rng = np.random.default_rng(7)
    q = np.corrcoef(rng.normal(size=(3, 500)))
    q[0, 0] = np.nextafter(1.0, 0.0)  # the 1-ulp case
    proc = DCCGarch.create(s0=[100.0] * 3, var0=[2e-4] * 3, qbar=q,
                           weights=[1 / 3] * 3, device="cpu", **GARCH)
    np.testing.assert_array_equal(np.diag(proc.qbar_flat.reshape(3, 3)),
                                  1.0)


def test_dcc_frozen_at_qbar_is_ccc():
    ccc = CCCGarch.create(s0=S0_3, var0=VAR0_3, corr=CORR3, weights=W_3,
                          device="cpu", **GARCH)
    np.testing.assert_allclose(
        simulate(_dcc(a=0.0, b=0.0), 4096, 24, seed=7).numpy(),
        simulate(ccc, 4096, 24, seed=7).numpy(), rtol=2e-5)


def test_dcc_numpy_oracle():
    """tests/test_dcc_garch.py's oracle: the Engle recursion in float64
    NumPy (np.linalg.cholesky of the normalized R per path) fed the port's
    own normals, against the port's paths."""
    proc = _dcc()
    n, steps = 512, 12
    ids = torch.arange(n)
    log_s = np.log(np.asarray(S0_3))[:, None] * np.ones((3, n))
    var = np.asarray(VAR0_3, np.float64)[:, None] * np.ones((3, n))
    q = np.broadcast_to(CORR3[:, :, None], (3, 3, n)).copy()
    for t in range(steps):
        eps = np.stack([e.double().numpy() for e in proc.draws(0, 0, ids, t)])
        d = 1.0 / np.sqrt(np.einsum("iik->ik", q))
        r = q * d[:, None, :] * d[None, :, :]
        eta = np.stack([np.linalg.cholesky(r[:, :, p]) @ eps[:, p]
                        for p in range(n)], axis=1)
        ret = np.sqrt(var) * eta
        log_s = log_s + ret
        var = 1e-5 + 0.1 * ret**2 + 0.85 * var
        q = (0.05 * CORR3[:, :, None] + 0.05 * eta[:, None, :] * eta[None]
             + 0.9 * q)
    want = (np.asarray(W_3)[:, None] * np.exp(log_s)).sum(axis=0)
    got = simulate(proc, n, steps, seed=0).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4)


def test_portfolio_var_matches_jax():
    """The stream route on the 3-asset CCC book, 2^14 paths x 10 days in
    4096-path chunks, 512 bins, against JAX's."""
    jp, tp = pair("ccc-garch", 3)
    kw = dict(seed=5, bins=512, block_size=1024, chunk_paths=4096)
    v0 = float(np.dot(W_3, S0_3))
    got = portfolio_var(tp, 1 << 14, 10, v0, **kw)
    want = jportfolio_var(jp, 1 << 14, 10, v0, **kw)
    lo, hi = _pilot_range(tp, 10, 5)
    width = (hi - lo) / 512
    assert got.keys() == want.keys() and got["n_paths"] == want["n_paths"]
    for k, v in want["percentiles"].items():
        assert abs(got["percentiles"][k] - v) <= width, k
    # Percent of the start value: a path within SCAN_RTOL of JAX's moves
    # the mean return and its spread by at most 100 SCAN_RTOL (the return,
    # 0.12%, is a mean less the start value).
    for k in ("expected_return", "expected_vol", "std_err"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=100 * SCAN_RTOL, err_msg=k)
    for k in ("var_95", "cvar_95"):
        assert abs(got[k] - want[k]) <= 100 * width / v0, k


# --- csrc/mgarch_steps.cuh on the host ----------------------------------------

N_WALK, SEED = 1024, 19

_SHIM = TABLE_PRELUDE + r"""
#include <type_traits>

#include "mgarch_steps.cuh"

// DCC with its recursion regrouped: c qbar + a (eta_i eta_j) (Regroup 1)
// or (c qbar + b q_ij) + (a eta_i) eta_j (Regroup 2), the forms the walk
// must tell apart (the header's row-at-a-time step, carried here with
// that one change).
template <int A, int Regroup>
struct DccRegrouped : mc::DccStep<A> {
  using Base = mc::DccStep<A>;
  using typename Base::State;
  using Base::Base;
  using Base::tri;
  State step(const State& s, const float* eps, int) const {
    const auto& c = this->c;
    float l[Base::kPairs];
    float eta[A];
    State out;
    for (int i = 0; i < A; ++i) {
      for (int j = 0; j <= i; ++j) {
        float sum = s.q[tri(i, j)];
        for (int k = 0; k < j; ++k) sum = sum - l[tri(i, k)] * l[tri(j, k)];
        l[tri(i, j)] = j == i ? sqrtf(mc::max_nan(sum, mc::kDccEps))
                              : sum / l[tri(j, j)];
      }
      const float dinv = 1.0f / sqrtf(mc::max_nan(s.q[tri(i, i)],
                                                  mc::kDccEps));
      float z = (l[tri(i, 0)] * dinv) * eps[0];
      for (int b = 1; b <= i; ++b) z = z + (l[tri(i, b)] * dinv) * eps[b];
      eta[i] = z;
      out.log_s[i] = s.log_s[i];
      out.var[i] = s.var[i];
      c.g.update(i, z, out.log_s, out.var);
      for (int j = 0; j <= i; ++j) {
        const float cq = c.cqbar[i * A + j], bq = c.b * s.q[tri(i, j)];
        out.q[tri(i, j)] = Regroup == 1
                               ? (cq + c.a * (eta[i] * eta[j])) + bq
                               : (cq + bq) + (c.a * eta[i]) * eta[j];
      }
    }
    return out;
  }
};

// A step on the launch leaves: the term basket on the leaves pointer, CCC
// and DCC on a copy of them in their Leaves struct, as the kernels' launch
// makes it.
template <class Step, class = void>
struct Built {
  static constexpr long kFloats = -1;
  Step step;
  Built(const float* leaves, int dims) : step(leaves, dims) {}
};
template <class Step>
struct Built<Step, std::void_t<typename Step::Leaves>> {
  static constexpr long kFloats = sizeof(typename Step::Leaves) / 4;
  typename Step::Leaves lv;
  Step step;
  Built(const float* leaves, int) : lv(), step(lv) {
    memcpy(&lv, leaves, sizeof lv);
  }
};

template <class Step>
static void walk(const float* leaves, int dims, long n, int T,
                 const float* eps, int D, float* out) {
  const Built<Step> built(leaves, dims);
  const Step& step = built.step;
  for (long i = 0; i < n; ++i) {
    typename Step::State s = step.init();
    float e[8];
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
  }                                                                       \
  extern "C" long name##_floats() { return Built<type>::kFloats; }
#define WALKS(A)                                                          \
  WALK(walk_term_basket_##A, mc::TermBasketStep<A>)                       \
  WALK(walk_ccc_garch_##A, mc::CccStep<A>)                                \
  WALK(walk_dcc_garch_##A, mc::DccStep<A>)
WALKS(1)
WALKS(2)
WALKS(3)
WALKS(4)
WALKS(5)
WALKS(6)
WALKS(7)
WALKS(8)
using Regrouped3 = DccRegrouped<3, 1>;
using Regrouped8 = DccRegrouped<8, 1>;
using RegroupedTwo3 = DccRegrouped<3, 2>;
using RegroupedTwo8 = DccRegrouped<8, 2>;
WALK(walk_dcc_regrouped_3, Regrouped3)
WALK(walk_dcc_regrouped_8, Regrouped8)
WALK(walk_dcc_regrouped2_3, RegroupedTwo3)
WALK(walk_dcc_regrouped2_8, RegroupedTwo8)
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory, "mgarch_steps", _SHIM, opt="-O1")


def walk(lib, name, proc, T, antithetic):
    """The header's walk on the plain version's draws, roots and logs,
    beside the plain version's terminal values: the term basket on its
    leaves, CCC and DCC on their launch leaves (``state_launch_leaves``,
    the floats their Leaves struct holds)."""
    _, dims, leaves = _leaves(proc)
    if isinstance(proc, (CCCGarch, DCCGarch)):
        leaves = state_launch_leaves(proc)
        assert getattr(lib, name + "_floats")() == leaves.numel()
    k0, k1 = key_from_seed(SEED, 0)
    ids = path_ids_for(N_WALK, 0, proc.device)
    eps = np.stack([np.stack([e.numpy() for e in eps]) for _, eps in
                    _step_draws(proc, T, k0, k1, ids, antithetic)])
    eps = np.ascontiguousarray(eps, np.float32)      # (T, D, n)
    leaves = np.ascontiguousarray(leaves.numpy(), np.float32)
    want, tables = recorded(fused_terminal_reference, proc, N_WALK, T,
                            seed=SEED, antithetic=antithetic)
    set_tables(lib, tables)
    out = np.empty(N_WALK, np.float32)
    getattr(lib, name)(ptr(leaves), dims, ctypes.c_long(N_WALK), T,
                       ptr(eps), proc.n_draws, ptr(out))
    return out, want.numpy()


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("T", [1, 17])
@pytest.mark.parametrize("a_n", range(1, MAX_STATE_ASSETS + 1))
@pytest.mark.parametrize("kind", ["term-basket", "ccc-garch", "dcc-garch"])
def test_header_step_is_the_plain_version(lib, kind, a_n, T, antithetic):
    """Every asset count of the functors; CCC and DCC on their by-value
    leaves, DCC a row at a time."""
    _, proc = pair(kind, a_n)
    name = f"walk_{kind.replace('-', '_')}_{a_n}"
    got, want = walk(lib, name, proc, T, antithetic)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def _regrouped(lib, name, a_n):
    _, proc = pair("dcc-garch", a_n)
    lib.host_set_fallback(1)
    try:
        got, want = walk(lib, name, proc, 17, False)
    finally:
        lib.host_set_fallback(0)
    assert (got != want).any(), "the walk cannot tell the forms apart"
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_a_regrouped_dcc_recursion_changes_bits(lib):
    _regrouped(lib, "walk_dcc_regrouped_3", 3)


@pytest.mark.parametrize("name,a_n", [("walk_dcc_regrouped_8", 8),
                                      ("walk_dcc_regrouped2_3", 3),
                                      ("walk_dcc_regrouped2_8", 8)])
def test_a_regrouped_row_at_a_time_recursion_changes_bits(lib, name, a_n):
    """The row-at-a-time step with c qbar + a (eta_i eta_j) at 8 assets,
    and with (c qbar + b q_ij) + (a eta_i) eta_j at 3 and 8."""
    _regrouped(lib, name, a_n)


@pytest.mark.parametrize("a_n", range(1, MAX_STATE_ASSETS + 1))
def test_launch_leaves_are_the_plain_versions_bits(a_n):
    """The wrapper's per-launch constants, bitwise what the plain versions
    compute: log32(s0) as CCC's and DCC's init_state starts every path,
    and DCC's ((1 - a) - b) qbar_ij as its step's first term (seen alone
    in a step with b = 0 on zero draws: cq + (a 0) 0 + 0 q is cq)."""
    ids = torch.arange(4)
    for kind in KINDS:
        proc = _book(kind, a_n)
        lv = state_launch_leaves(proc)
        log_s, _ = proc.init_state(ids)[:2]
        for a in range(a_n):
            assert torch.equal(lv[a].expand(4), log_s[a]), (kind, a)
        _, _, leaves = _leaves(proc)
        assert torch.equal(lv[a_n:leaves.numel()], leaves[a_n:]), kind
    for a_dcc, b_dcc in ((0.05, 0.9), (0.03, 0.95), (0.1, 0.0)):
        corr, s0, var0, w = book(a_n)
        proc = DCCGarch.create(s0, var0, qbar=corr, weights=w, a_dcc=a_dcc,
                               b_dcc=b_dcc, device="cpu",
                               omega=[1e-5] * a_n, alpha=[0.1] * a_n,
                               beta=[0.85] * a_n)
        cq = state_launch_leaves(proc)[-a_n * a_n:]
        c_d = (1.0 - proc.a_dcc) - proc.b_dcc
        assert torch.equal(cq, torch.stack([c_d * proc.qbar_flat[k]
                                            for k in range(a_n * a_n)]))
        if b_dcc == 0.0:
            zero = tuple(torch.zeros(4) for _ in range(a_n))
            q = proc.step(proc.init_state(ids), zero, 0)[2]
            want = [cq[i * a_n + j].expand(4) for i in range(a_n)
                    for j in range(i + 1)]
            assert all(torch.equal(g, w) for g, w in zip(q, want))
