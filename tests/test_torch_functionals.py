"""The port's path functionals (engine/functionals.py) and K4's plain
version against the JAX package: its scan engine ``_simulate_functionals``
(through ``simulate_functionals(..., prefer_fused=False)``) and its K4,
``fused_functionals_pallas(..., interpret=True)``, as
tests/test_fused_functionals.py runs it.  Inside the port, the torch time
loop and K4's plain version agree bitwise.

Tolerances against JAX.  The two frameworks draw the same Threefry words
and differ only through the Box-Muller normals (each platform's own
log/sqrt/sin/cos, <= 4.8e-7 absolute) and where XLA contracts a*b+c into
an FMA; so:
- prices and price-like values (terminal, mean, geometric mean, max, min,
  trapezoid integral, the autocall's continuous part): rtol 2e-6, a few
  float32 ULPs, as the K2 parity tests;
- the cliquet leg sums collared ratios s/prev - 1, whose absolute error is
  the ratio's (2 x 1e-6 per reset, four resets): atol 1e-5;
- realized variance sums squared log increments d^2 with d ~ 0.013 whose
  ends carry a few ULP of log S (4.8e-7): 2|d| x 2e-6 per step, 17 steps,
  atol 1e-6;
- the bridge survival multiplies 1 - exp(-2ab/(sigma^2 dt)), whose slope
  in log S reaches 2a/(sigma^2 dt) ~ 400 near the barrier: atol 1e-3 per
  path, and the mean within 1e-5;
- the autocall is discontinuous (trigger, barrier): a path at the trigger
  within the normals' difference can flip.  Allowance: FLIP_ALLOWANCE
  disagreeing paths of N, the rest within rtol 2e-6, the means within
  FLIP_ALLOWANCE x the largest jump / N.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.ops.fused_engine import fused_functionals_pallas
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu.samplers import AntitheticSampler as JAntithetic
from montecarlo_tpu_torch.convert import process_from_numpy
from montecarlo_tpu_torch.engine import functionals as tf
from montecarlo_tpu_torch.engine import mc_estimate, simulate_functionals
from montecarlo_tpu_torch.ops import (fused_functionals,
                                      fused_functionals_reference,
                                      fused_snapshots, launch_counts)
from montecarlo_tpu_torch.ops.fused_engine import THREEFRY, k4_launches
from montecarlo_tpu_torch.processes import GBM
from montecarlo_tpu_torch.processes.gbm import GBMState
from montecarlo_tpu_torch.samplers import AntitheticSampler

torch.set_num_threads(1)

N = 8 * 128        # paths (block_rows=8 for the Pallas kernel)
OFFSET = 384       # a path offset that is a multiple of the Pallas block
PRICE_RTOL = 2e-6
FLIP_ALLOWANCE = 3
ATOL = {"cl": 1e-5, "rv": 1e-6, "surv": 1e-3}


def _pair(kind):
    """A JAX process and its port, from the same numpy leaves."""
    if kind == "gbm":
        jp = JGBM.create(s0=100.0, mu=0.03, sigma=0.2, dt=1 / 252)
    else:
        jp = JHeston.create(s0=100.0, v0=0.04, mu=0.03, kappa=2.0,
                            theta=0.04, xi=0.5, rho=-0.7, dt=1 / 252)
    return jp, process_from_numpy(
        kind, {k: np.asarray(v) for k, v in jp._asdict().items()},
        device="cpu")


def _groups(n_steps):
    """Every device functional, JAX and port built from the same
    arguments, in K4's groups of at most four."""
    dt = 1 / 252
    period = 4 if n_steps % 4 == 0 else n_steps
    spec = [
        {"avg": ("ARITH_MEAN",), "geo": ("GEO_MEAN",),
         "mx": ("RUNNING_MAX",), "mn": ("RUNNING_MIN",)},
        {"surv": ("barrier_survival_up", 103.0, 0.2, dt),
         "cl": ("cliquet_sum", 4, -0.02, 0.03),
         "rv": ("realized_variance",),
         "tr": ("trapezoid_integral", dt)},
        {"ac": ("autocallable", period, 100.5, 0.02, 0.03 * dt, 97.0,
                100.0)},
    ]

    def build(mod, name, *args):
        obj = getattr(mod, name)
        return obj(*args) if args or name == "realized_variance" else obj

    return [({k: build(jf, *v) for k, v in g.items()},
             {k: build(tf, *v) for k, v in g.items()}) for g in spec]


def _assert_close_to_jax(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (N,) and g.dtype == np.float32, k
        if k == "ac":
            bad = ~np.isclose(g, w, rtol=PRICE_RTOL, atol=0)
            assert bad.sum() <= FLIP_ALLOWANCE, (k, bad.sum())
            jump = 1.2  # an autocall flip moves one path by <= 1.2
            assert abs(g.mean() - w.mean()) <= FLIP_ALLOWANCE * jump / N
        elif k in ATOL:
            np.testing.assert_allclose(g, w, rtol=PRICE_RTOL, atol=ATOL[k],
                                       err_msg=k)
            assert abs(g.mean() - w.mean()) <= 1e-5, k
        else:
            np.testing.assert_allclose(g, w, rtol=PRICE_RTOL, err_msg=k)


@pytest.mark.parametrize("kind", ["gbm", "heston"])
@pytest.mark.parametrize("n_steps", [16, 17])
@pytest.mark.parametrize("antithetic", [False, True])
def test_scan_matches_jax_scan(kind, n_steps, antithetic):
    """The torch time loop against JAX's scan, every functional, and the
    torch time loop against K4's plain version: bitwise."""
    jp, tp = _pair(kind)
    js = JAntithetic() if antithetic else None
    ts = AntitheticSampler() if antithetic else None
    for jfns, tfns in _groups(n_steps):
        want = jf.simulate_functionals(jp, N, n_steps, seed=5,
                                       functionals=jfns, sampler=js,
                                       path_offset=OFFSET,
                                       prefer_fused=False)
        got = simulate_functionals(tp, N, n_steps, seed=5, functionals=tfns,
                                   sampler=ts, path_offset=OFFSET,
                                   prefer_fused=False)
        _assert_close_to_jax(got, want)
        plain = fused_functionals_reference(
            tp, N, n_steps, seed=5, functionals=tfns, path_offset=OFFSET,
            antithetic=antithetic)
        for k in got:
            assert torch.equal(plain[k], got[k]), k


@pytest.mark.parametrize("kind", ["gbm", "heston"])
@pytest.mark.parametrize("n_steps", [16, 17])
@pytest.mark.parametrize("group", [0, 1, 2])
def test_k4_plain_matches_pallas_interpret(kind, n_steps, group):
    """K4's plain version against the JAX K4 in interpret mode, plain and
    antithetic, at a path offset."""
    jp, tp = _pair(kind)
    jfns, tfns = _groups(n_steps)[group]
    for antithetic in (False, True):
        want = fused_functionals_pallas(
            jp, N, n_steps, seed=9, functional_items=tuple(jfns.items()),
            path_offset=OFFSET, block_rows=8, interpret=True,
            antithetic=antithetic)
        got = fused_functionals(tp, N, n_steps, seed=9, functionals=tfns,
                                path_offset=OFFSET, antithetic=antithetic)
        _assert_close_to_jax(got, want)


def _many(count):
    """Five or six functionals, JAX and port: the app's four, realized
    variance and the trapezoid integral."""
    names = [("avg", "ARITH_MEAN"), ("geo", "GEO_MEAN"),
             ("mx", "RUNNING_MAX"), ("mn", "RUNNING_MIN"),
             ("rv", "realized_variance"), ("tr", "trapezoid_integral")]

    def build(mod, name):
        if name == "realized_variance":
            return mod.realized_variance()
        if name == "trapezoid_integral":
            return mod.trapezoid_integral(1 / 252)
        return getattr(mod, name)

    return ({k: build(jf, n) for k, n in names[:count]},
            {k: build(tf, n) for k, n in names[:count]})


@pytest.mark.parametrize("count", [5, 6])
@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_more_than_four_functionals_as_jax_k4(kind, count):
    """K4 over five and six functionals, as JAX's K4 takes any number:
    ``simulate_functionals`` on the kernel route (two launches of K4's
    plain version here) bitwise K4's plain version in one pass and the
    torch loop, and within PRICE_RTOL (realized variance its atol) of
    JAX's ``fused_functionals_pallas`` in interpret mode with the same
    functionals, at a path offset, plain and antithetic."""
    jp, tp = _pair(kind)
    jfns, tfns = _many(count)
    forms = [f.device(17) for f in tfns.values()]
    assert [launch.items for launch in k4_launches(
        tp, THREEFRY, forms, 17)] == [(0, 1, 2, 3), tuple(range(4, count))]
    for antithetic in (False, True):
        ts = AntitheticSampler() if antithetic else None
        got = simulate_functionals(tp, N, 17, seed=9, functionals=tfns,
                                   path_offset=OFFSET, sampler=ts)
        assert list(got) == ["terminal", *tfns]
        one = fused_functionals_reference(tp, N, 17, seed=9,
                                          functionals=tfns,
                                          path_offset=OFFSET,
                                          antithetic=antithetic)
        loop = simulate_functionals(tp, N, 17, seed=9, functionals=tfns,
                                    path_offset=OFFSET, sampler=ts,
                                    prefer_fused=False)
        for k in got:
            assert torch.equal(got[k], one[k]), k
            assert torch.equal(got[k], loop[k]), k
        want = fused_functionals_pallas(
            jp, N, 17, seed=9, functional_items=tuple(jfns.items()),
            path_offset=OFFSET, block_rows=8, interpret=True,
            antithetic=antithetic)
        _assert_close_to_jax(got, want)


def test_dispatch_runs_k4_plain_version_on_the_cpu():
    _, tp = _pair("heston")
    fns = _groups(16)[1][1]
    before = launch_counts()["fused_functionals"]
    got = simulate_functionals(tp, N, 16, seed=2, functionals=fns,
                               sampler=AntitheticSampler())
    want = fused_functionals_reference(tp, N, 16, seed=2, functionals=fns,
                                       antithetic=True)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert launch_counts()["fused_functionals"] == before  # no card here


def test_path_offset_invariance():
    _, tp = _pair("gbm")
    fns = _groups(17)[0][1]
    full = fused_functionals(tp, 2 * N, 17, seed=13, functionals=fns)
    back = fused_functionals(tp, N, 17, seed=13, functionals=fns,
                             path_offset=N)
    for k in full:
        assert torch.equal(full[k][N:], back[k]), k


def test_gbm_log_prices_repair():
    """Log-space functionals fold GBM's log state itself, as JAX does.
    Without ``log_prices`` they would fold log32(exp32(log_s)): exact for
    a spot near 100 (|log S| ~ 4.6, whose ULP exceeds exp32's error), but
    a few 1e-8 off on most paths of a spot near 1, such as a note's
    performance-normalized underlying."""
    rng = np.random.default_rng(0)
    log_s = torch.from_numpy(rng.uniform(-0.3, 0.3, 4096).astype(np.float32))
    tp = GBM.create(1.0, 0.03, 0.2, 1 / 252, device="cpu")
    state = GBMState(log_s=log_s)
    obs_log, obs_price = tf.functional_observables(
        tp, state, [tf.RUNNING_MAX, tf.ARITH_MEAN])
    assert torch.equal(obs_log, log_s)
    assert torch.equal(obs_price, tp.prices(state))

    class WithoutLogPrices:  # GBM as it was before the repair
        def __init__(self, proc):
            self.proc = proc

        def __getattr__(self, name):
            if name == "log_prices":
                raise AttributeError(name)
            return getattr(self.proc, name)

    old = WithoutLogPrices(tp)
    (fallback,) = tf.functional_observables(old, state, [tf.RUNNING_MAX])
    assert (fallback != log_s).float().mean() > 0.5
    torch.testing.assert_close(fallback, log_s, rtol=0, atol=2e-7)
    # Over a whole run the fold changes the running max and the geometric
    # mean; the repaired port is the one that follows JAX's log-state fold.
    fns = {"mx": tf.RUNNING_MAX, "geo": tf.GEO_MEAN}
    got = simulate_functionals(tp, N, 16, seed=1, functionals=fns,
                               prefer_fused=False)
    before = simulate_functionals(old, N, 16, seed=1, functionals=fns,
                                  prefer_fused=False)
    assert not torch.equal(got["geo"], before["geo"])
    assert not torch.equal(got["mx"], before["mx"])
    jp = JGBM.create(s0=1.0, mu=0.03, sigma=0.2, dt=1 / 252)
    want = jf.simulate_functionals(
        jp, N, 16, seed=1, prefer_fused=False,
        functionals={"mx": jf.RUNNING_MAX, "geo": jf.GEO_MEAN})
    for k in fns:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=PRICE_RTOL, err_msg=k)


def test_device_forms_are_host_folded_float32():
    dt, sigma, barrier = 1 / 252, 0.2, 120.0
    surv = tf.barrier_survival_up(barrier, sigma, dt).device(16)
    assert surv.code == tf.BARRIER_UP_CODE
    assert surv.params == (float(np.float32(np.log(barrier))),
                           float(np.float32(1.0 / (sigma**2 * dt))))
    r_dt = 0.03 / 252
    ac = tf.autocallable(63, 100.0, 0.02, r_dt, 70.0, 100.0).device(252)
    assert (ac.code, ac.period) == (tf.AUTOCALL_CODE, 63)
    assert ac.params[0] == float(np.float32(-r_dt))
    assert ac.params[5] == float(np.float32(-r_dt * 252))
    for form in (surv, ac, tf.cliquet_sum(4, -0.02, 0.03).device(16),
                 tf.trapezoid_integral(dt).device(16)):
        assert all(float(np.float32(p)) == p for p in form.params)
        assert len(form.params) <= tf.MAX_PARAMS
    with pytest.raises(ValueError, match="multiple"):
        tf.autocallable(4, 1.0, 0.02, r_dt, 0.7, 1.0).device(17)


def test_k4_refusals_name_the_cause():
    _, tp = _pair("gbm")
    worst = tf.worst_of_autocallable(4, 1.0, 0.02, 0.001, 0.7, [100.0])
    with pytest.raises(TypeError, match="'worst'.*prefer_fused=False"):
        simulate_functionals(tp, 64, 16, seed=0,
                             functionals={"worst": worst})
    with pytest.raises(TypeError, match="GBM and Heston"):
        fused_functionals(object(), 64, 16, seed=0,
                          functionals={"avg": tf.ARITH_MEAN})
    with pytest.raises(ValueError, match="at most 64"):
        fused_snapshots(tp, 64, 80, list(range(65)), seed=0)


def test_worst_of_single_asset_equals_autocallable():
    """With one asset the worst-of note is the autocallable (torch time
    loop; the JAX package tests the same degenerate case)."""
    _, tp = _pair("gbm")

    class OneAsset:  # GBM seen as a (n_paths, 1) multi-asset state
        n_draws = 1
        device = tp.device

        def __getattr__(self, name):
            return getattr(tp, name)

        def prices(self, state):
            return tp.prices(state)[:, None]

    period, r_dt = 4, 0.03 / 252
    single = simulate_functionals(
        tp, N, 16, seed=4, prefer_fused=False,
        functionals={"ac": tf.autocallable(period, 100.0, 0.02, r_dt, 97.0,
                                           100.0)})
    worst = simulate_functionals(
        OneAsset(), N, 16, seed=4, prefer_fused=False,
        functionals={"ac": tf.worst_of_autocallable(period, 1.0, 0.02, r_dt,
                                                    0.97, [100.0])})
    np.testing.assert_allclose(worst["ac"].numpy(), single["ac"].numpy(),
                               atol=1e-6)


def test_geometric_asian_within_5se_of_closed_form():
    s0, k, r, sigma, T, steps = 100.0, 100.0, 0.03, 0.2, 1.0, 64
    tp = GBM.create(s0, r, sigma, T / steps, device="cpu")
    out = fused_functionals(tp, 1 << 15, steps, seed=21,
                            functionals={"geo": tf.GEO_MEAN})
    est = mc_estimate(tf.asian_call(out["geo"], k), np.exp(-r * T))
    cf = tf.geometric_asian_call_closed_form(s0, k, r, sigma, T, steps)
    assert cf == pytest.approx(
        jf.geometric_asian_call_closed_form(s0, k, r, sigma, T, steps),
        rel=1e-12)
    assert abs(float(est["price"]) - cf) < 5 * float(est["std_err"])


@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_variance_swap_strike_matches_jax(kind):
    jp, tp = _pair(kind)
    want = jf.variance_swap_strike_mc(jp, N, 16, T=16 / 252, seed=3)
    got = tf.variance_swap_strike_mc(tp, N, 16, T=16 / 252, seed=3)
    assert int(got["n_paths"]) == int(want["n_paths"])
    for key in ("strike", "std_err"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)


@pytest.mark.parametrize("name", ["asian_call", "up_and_out_call",
                                  "down_and_out_call",
                                  "lookback_call_floating"])
def test_payoffs_match_jax(name):
    rng = np.random.default_rng(1)
    a, b = (rng.uniform(80, 130, 512).astype(np.float32) for _ in range(2))
    args = {"asian_call": (a, 100.0), "up_and_out_call": (a, b, 100.0, 115.0),
            "down_and_out_call": (a, b, 100.0, 95.0),
            "lookback_call_floating": (a, b)}[name]
    want = getattr(jf, name)(*[jnp.asarray(x) if isinstance(x, np.ndarray)
                               else x for x in args])
    got = getattr(tf, name)(*[torch.from_numpy(x) if isinstance(
        x, np.ndarray) else x for x in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
