"""The multi-asset slice against the JAX package: K7 (the packed basket
kernel), BasketGBM on the fused kernels' plain versions (K2, K3, K4), and
MultiGBM on the torch time loop.

Inputs are made once with numpy and carried to both sides through
``convert.process_from_numpy(..., device="cpu")``.  Tolerances and why:

- The two frameworks draw the same Threefry words; the normals differ by
  each platform's log/sqrt/sin/cos (<= 4.8e-7 absolute).  K7 also takes
  ``log32``/``exp32`` where JAX takes ``jnp.log``/``jnp.exp`` and sums the
  correlation and the basket in a fixed order where XLA takes its dot and
  reduction: per-path basket values within rtol 2e-6, the JAX package's own
  tolerance between its kernel and its oracle.
- BasketGBM runs the same float32 operations in the same order on both
  sides: terminal values and path functionals within rtol 2e-6; K3's block
  moments sum in each framework's own order: rtol 1e-5.
- MultiGBM correlates with a matrix product whose summation order is each
  library's own: rtol 2e-6.  BasketGBM against MultiGBM ``@ w`` (unrolled
  Cholesky against a product, a sum of exp against exp then a dot): rtol
  2e-5, the JAX package's own (tests/test_fused_engine.py).
- Inside the port (kernel orders, offsets, inert assets): bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import max_call as jmax_call
from montecarlo_tpu.engine import simulate as jsimulate
from montecarlo_tpu.engine import functionals as jf
from montecarlo_tpu.ops.basket_kernel import (
    packed_basket_terminal_pallas, packed_basket_terminal_reference as
    jax_packed_reference)
from montecarlo_tpu.ops.fused_engine import (fused_block_moments_pallas,
                                             fused_functionals_pallas,
                                             fused_terminal_pallas)
from montecarlo_tpu.processes import BasketGBM as JBasket
from montecarlo_tpu.processes import MultiGBM as JMulti
from montecarlo_tpu.samplers import AntitheticSampler as JAntithetic
from montecarlo_tpu_torch.convert import process_from_numpy, process_to_numpy
from montecarlo_tpu_torch.engine import (ARITH_MEAN, GEO_MEAN, RUNNING_MAX,
                                         RUNNING_MIN, VanillaPayoff,
                                         basket_call, max_call, simulate,
                                         simulate_functionals)
from montecarlo_tpu_torch.ops import (fused_block_moments_reference,
                                      fused_functionals_reference,
                                      fused_terminal,
                                      fused_terminal_reference,
                                      packed_basket_terminal,
                                      packed_basket_terminal_reference)
from montecarlo_tpu_torch.processes import BasketGBM, MultiGBM
from montecarlo_tpu_torch.samplers import AntitheticSampler

torch.set_num_threads(1)

PRICE_RTOL = 2e-6
WRAP = 2**32 - 700  # ids wrap past 2^32 inside the run


def _corr(a_n, rng):
    q = rng.normal(size=(a_n, a_n))
    corr = q @ q.T
    d = np.sqrt(np.diag(corr))
    return corr / np.outer(d, d)


def _basket(a_n, seed=0, dt=1.0 / 64.0):
    """tests/test_basket_kernel.py's basket, JAX and port from one numpy
    source."""
    rng = np.random.default_rng(seed)
    corr = _corr(a_n, rng)
    jb = JBasket.create(
        s0=rng.uniform(50, 150, a_n), mu=rng.uniform(0.0, 0.06, a_n),
        sigma=rng.uniform(0.1, 0.4, a_n), corr=corr,
        weights=np.full(a_n, 1.0 / a_n), dt=dt)
    fields = {k: np.asarray(v) for k, v in jb._asdict().items()}
    return jb, process_from_numpy("basket", fields, device="cpu")


def _three(kind="basket"):
    """tests/test_fused_engine.py's three-asset basket (or its MultiGBM)."""
    corr = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])
    kw = dict(s0=[100.0, 50.0, 75.0], mu=[0.03, 0.02, 0.04],
              sigma=[0.2, 0.3, 0.25], corr=corr, dt=1 / 252)
    if kind == "basket":
        jp = JBasket.create(weights=np.array([0.5, 0.3, 0.2]), **kw)
    else:
        jp = JMulti.create(**kw)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    return jp, process_from_numpy(kind, fields, device="cpu")


# --- K7 ---------------------------------------------------------------------

@pytest.mark.parametrize("a_n", [4, 16, 20, 64])
@pytest.mark.parametrize("n_steps", [7, 8])
def test_k7_plain_matches_jax_kernel_and_oracle(a_n, n_steps):
    jb, tb = _basket(a_n)
    n = 2048
    got = packed_basket_terminal(tb, n, n_steps, seed=3).numpy()
    want_kernel = np.asarray(packed_basket_terminal_pallas(
        jb, n, n_steps, seed=3, sub_rows=64, interpret=True))
    want_oracle = np.asarray(jax_packed_reference(jb, n, n_steps, seed=3))
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_kernel, rtol=PRICE_RTOL, atol=0)
    np.testing.assert_allclose(got, want_oracle, rtol=PRICE_RTOL, atol=0)


def test_k7_path_offset_invariance_bitwise():
    """Any slice of paths recomputed alone through ``path_offset`` gives
    the same bits, ids wrapping past 2^32 included; so does the wrapper
    (the plain version on a CPU basket)."""
    _, tb = _basket(16)
    n, steps = 1000, 8
    full = packed_basket_terminal_reference(tb, n, steps, seed=5,
                                            path_offset=WRAP)
    head = packed_basket_terminal_reference(tb, 300, steps, seed=5,
                                            path_offset=WRAP)
    tail = packed_basket_terminal_reference(tb, n - 300, steps, seed=5,
                                            path_offset=WRAP + 300)
    assert torch.equal(full, torch.cat([head, tail]))
    assert torch.equal(full, packed_basket_terminal(tb, n, steps, seed=5,
                                                    path_offset=WRAP))


def test_k7_padded_assets_are_inert():
    """The draws are asset-major, so assets appended with zero vol, zero
    weight and no correlation leave the first A assets' draws, Cholesky rows
    and basket sum unchanged: the TPU kernel pads 20 assets to 32 this way,
    and the port, which pads nothing, gives the same bits either way."""
    a_n, a_pad = 20, 32
    rng = np.random.default_rng(2)
    corr = np.eye(a_pad)
    corr[:a_n, :a_n] = _corr(a_n, rng)
    s0, mu = rng.uniform(50, 150, a_n), rng.uniform(0.0, 0.06, a_n)
    sigma = rng.uniform(0.1, 0.4, a_n)
    pad = lambda v, x: np.concatenate([v, np.full(a_pad - a_n, x)])
    b20 = BasketGBM.create(s0, mu, sigma, corr[:a_n, :a_n],
                           np.full(a_n, 1.0 / a_n), 1 / 64, device="cpu")
    b32 = BasketGBM.create(pad(s0, 100.0), pad(mu, 0.0), pad(sigma, 0.0),
                           corr, pad(np.full(a_n, 1.0 / a_n), 0.0), 1 / 64,
                           device="cpu")
    v20 = packed_basket_terminal(b20, 4096, 8, seed=7)
    assert torch.isfinite(v20).all() and (v20 > 0).all()
    assert torch.equal(v20, packed_basket_terminal(b32, 4096, 8, seed=7))


@pytest.mark.parametrize("a_n", [16, 32])
def test_k7_moments_match_lognormal_closed_form(a_n):
    """E[basket_T] and Var[basket_T] of correlated GBM in closed form
    (tests/test_basket_kernel.py's gate): mean within 4 se, variance within
    6 sqrt(2/n) var."""
    _, tb = _basket(a_n, seed=1)
    steps, n = 16, 1 << 16
    t = 1.0 / 64.0 * steps
    vals = packed_basket_terminal(tb, n, steps, seed=11).double().numpy()
    leaves = {k: v.astype(np.float64) for k, v in process_to_numpy(tb).items()}
    chol = leaves["chol_flat"].reshape(a_n, a_n)
    mean_s = leaves["s0"] * np.exp(leaves["mu"] * t)
    sig, w = leaves["sigma"], leaves["weights"]
    exact_mean = float(w @ mean_s)
    cov = np.outer(mean_s, mean_s) * (
        np.exp(np.outer(sig, sig) * (chol @ chol.T) * t) - 1.0)
    exact_var = float(w @ cov @ w)
    se = vals.std(ddof=1) / np.sqrt(n)
    assert abs(vals.mean() - exact_mean) < 4 * se + 1e-6
    assert abs(vals.var(ddof=1) - exact_var) < 6 * exact_var * np.sqrt(2 / n)


def test_k7_and_the_fused_kernels_refuse_more_than_128_assets():
    _, tb = _basket(129)
    with pytest.raises(ValueError, match="at most 128"):
        packed_basket_terminal(tb, 16, 2, seed=0)
    with pytest.raises(ValueError, match="at most 128"):
        fused_terminal(tb, 16, 2, seed=0)


# --- BasketGBM on K2/K3/K4 ----------------------------------------------------

@pytest.mark.parametrize("n_steps", [16, 17])
@pytest.mark.parametrize("antithetic", [False, True])
def test_basket_loop_and_k2_plain_match_jax(n_steps, antithetic):
    """The torch loop and K2's plain version against JAX's scan and
    ``fused_terminal_pallas(interpret=True)``; the loop equals K2's plain
    version bitwise."""
    jb, tb = _three()
    n, off = 128 * 16, 512
    js = JAntithetic() if antithetic else None
    ts = AntitheticSampler() if antithetic else None
    want_scan = np.asarray(jsimulate(jb, n, n_steps, seed=5, sampler=js,
                                     path_offset=off))
    want_kernel = np.asarray(fused_terminal_pallas(
        jb, n, n_steps, seed=5, path_offset=off, block_rows=16,
        interpret=True, antithetic=antithetic))
    loop = simulate(tb, n, n_steps, seed=5, sampler=ts, path_offset=off)
    plain = fused_terminal_reference(tb, n, n_steps, seed=5, path_offset=off,
                                     antithetic=antithetic)
    assert torch.equal(loop, plain)
    np.testing.assert_allclose(plain.numpy(), want_scan, rtol=PRICE_RTOL)
    np.testing.assert_allclose(plain.numpy(), want_kernel, rtol=PRICE_RTOL)


@pytest.mark.parametrize("a_n", [5, 17])
def test_basket_odd_and_wide_draws_match_jax(a_n):
    """An odd asset count splits one cipher call across the two steps of a
    pair; 17 assets take the kernel's wide (local-memory) functor."""
    jb, tb = _basket(a_n, seed=4)
    n, steps = 1024, 9
    want = np.asarray(jsimulate(jb, n, steps, seed=8, path_offset=WRAP))
    got = fused_terminal(tb, n, steps, seed=8, path_offset=WRAP)
    np.testing.assert_allclose(got.numpy(), want, rtol=PRICE_RTOL)
    assert torch.equal(got, simulate(tb, n, steps, seed=8, path_offset=WRAP))


def test_basket_matches_multigbm_times_weights():
    jb, tb = _three("basket")
    _, tm = _three("multigbm")
    n, steps = 128 * 32, 16
    b = simulate(tb, n, steps, seed=5)
    m = simulate(tm, n, steps, seed=5)
    assert m.shape == (n, 3)
    np.testing.assert_allclose(b.numpy(), (m @ tb.weights).numpy(),
                               rtol=2e-5)
    np.testing.assert_allclose(
        basket_call(m, tb.weights, 80.0).numpy(),
        np.maximum((m @ tb.weights).numpy() - 80.0, 0.0), rtol=1e-6)


@pytest.mark.parametrize("n_steps,kind,antithetic", [
    (16, "call", False), (17, "put", True)])
def test_basket_k3_plain_matches_jax(n_steps, kind, antithetic):
    jb, tb = _three()
    strike = 78.0
    jpay = ((lambda s: jnp.maximum(s - strike, 0.0)) if kind == "call"
            else (lambda s: jnp.maximum(strike - s, 0.0)))
    want = fused_block_moments_pallas(
        jb, jpay, 8192, n_steps, seed=3, path_offset=4096, block_rows=32,
        interpret=True, antithetic=antithetic)
    got = fused_block_moments_reference(
        tb, VanillaPayoff(kind, strike), 8192, n_steps, seed=3,
        path_offset=4096, antithetic=antithetic)
    for j, t in zip(want, got):
        assert t.shape == (2,)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)


@pytest.mark.parametrize("n_steps", [16, 17])
def test_basket_k4_plain_matches_jax(n_steps):
    """K4's plain version on a basket (log-space functionals observe
    log32 of the basket value on both sides) against JAX's K4 in interpret
    mode, and the torch time loop against it bitwise."""
    jb, tb = _three()
    n = 128 * 8
    names = ("avg", "geo", "mx", "mn")
    jfns = dict(zip(names, (jf.ARITH_MEAN, jf.GEO_MEAN, jf.RUNNING_MAX,
                            jf.RUNNING_MIN)))
    tfns = dict(zip(names, (ARITH_MEAN, GEO_MEAN, RUNNING_MAX,
                            RUNNING_MIN)))
    want = fused_functionals_pallas(jb, n, n_steps, seed=9,
                                    functional_items=tuple(jfns.items()),
                                    path_offset=WRAP, block_rows=8,
                                    interpret=True)
    got = fused_functionals_reference(tb, n, n_steps, seed=9,
                                      functionals=tfns, path_offset=WRAP)
    loop = simulate_functionals(tb, n, n_steps, seed=9, functionals=tfns,
                                path_offset=WRAP, prefer_fused=False)
    assert set(got) == set(want) == {"terminal", *names}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=PRICE_RTOL, err_msg=k)
        assert torch.equal(loop[k], got[k]), k


# --- MultiGBM -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["terminal", "paths"])
def test_multigbm_matches_jax_simulate(mode):
    jm, tm = _three("multigbm")
    n, steps = 1024, 17
    want = np.asarray(jsimulate(jm, n, steps, seed=4, mode=mode,
                                path_offset=WRAP))
    got = simulate(tm, n, steps, seed=4, mode=mode, path_offset=WRAP)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=PRICE_RTOL)
    np.testing.assert_allclose(max_call(got, 100.0).numpy(),
                               np.asarray(jmax_call(want, 100.0)),
                               rtol=PRICE_RTOL, atol=1e-4)


def test_multigbm_product_ignores_a_tf32_setting():
    """MultiGBM's correlation runs in true float32 under a process-wide
    "high" precision setting and leaves the setting as it found it."""
    _, tm = _three("multigbm")
    before = torch.get_float32_matmul_precision()
    try:
        want = simulate(tm, 256, 4, seed=1)
        torch.set_float32_matmul_precision("high")
        got = simulate(tm, 256, 4, seed=1)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(got, want)


def test_multi_asset_functionals_refuse_the_kernel():
    """No kernel runs a multi-asset state: the dispatch's gate sends
    MultiGBM's ``simulate_functionals`` to the functionals' torch loop (K4
    and its plain version refuse it by name), as JAX's dispatch sends it
    to its scan, and the result matches JAX's: rtol 2e-6."""
    jm, tm = _three("multigbm")
    fns = {"avg": ARITH_MEAN, "mx": RUNNING_MAX}
    with pytest.raises(TypeError, match="got MultiGBM"):
        fused_functionals_reference(tm, 64, 4, seed=0, functionals=fns)
    n, steps = 512, 9
    got = simulate_functionals(tm, n, steps, seed=6, functionals=fns,
                               path_offset=WRAP)
    want = jf.simulate_functionals(
        jm, n, steps, seed=6, functionals={"avg": jf.ARITH_MEAN,
                                           "mx": jf.RUNNING_MAX},
        dtype=jnp.float32, path_offset=WRAP)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=PRICE_RTOL, err_msg=k)


@pytest.mark.parametrize("entry", ["terminal_prices", "block_moments",
                                   "block_moments_ragged"])
def test_multi_asset_dispatch_takes_the_torch_loop(entry):
    """``terminal_prices`` and ``payoff_block_moments`` on MultiGBM (a
    process outside PROCESS_CODES) run the torch loop and match JAX's scan
    route: terminals within rtol 2e-6; block moments within rtol 1e-5
    (each framework sums in its own order)."""
    from montecarlo_tpu.engine.dispatch import (
        payoff_block_moments as jblock, terminal_prices as jterminal)
    from montecarlo_tpu_torch.engine import (payoff_block_moments,
                                             terminal_prices)

    jm, tm = _three("multigbm")
    steps = 8
    if entry == "terminal_prices":
        got = terminal_prices(tm, 1000, steps, seed=2, path_offset=WRAP)
        want = jterminal(jm, 1000, steps, seed=2, path_offset=WRAP)
        assert tuple(got.shape) == want.shape == (1000, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=PRICE_RTOL)
        return
    n = 8192 if entry == "block_moments" else 1000
    got = payoff_block_moments(tm, lambda s: max_call(s, 90.0), n, steps,
                               seed=2)
    want = jblock(jm, lambda s: jmax_call(s, 90.0), n, steps, seed=2)
    for f in ("count", "mean", "m2"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)


def test_multi_asset_price_to_tolerance_matches_jax():
    """``price_to_tolerance`` on MultiGBM's max-call runs chunk by chunk
    through the torch loop and stops after JAX's number of chunks, at
    JAX's price and std-err within rtol 1e-5."""
    from montecarlo_tpu.engine import price_to_tolerance as jptt
    from montecarlo_tpu_torch.engine import price_to_tolerance

    jm, tm = _three("multigbm")
    kw = dict(target_std_err=0.02, seed=8, chunk_paths=1 << 12, n_steps=4,
              discount=0.97)
    want = jptt(jm, lambda s: jmax_call(s, 90.0), **kw)
    got = price_to_tolerance(tm, lambda s: max_call(s, 90.0), **kw)
    assert got["n_chunks"] == int(want["n_chunks"]) > 1
    for k in ("price", "std_err", "n_paths"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


# --- construction -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["basket", "multigbm"])
def test_convert_round_trip_and_field_order(kind):
    jp, tp = _three(kind)
    fields = {k: np.asarray(v) for k, v in jp._asdict().items()}
    back = process_to_numpy(tp)
    assert list(back) == list(fields)
    for k in fields:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], fields[k].astype(np.float32))


def test_create_matches_jax_create_and_defaults_to_the_card():
    jb, tb = _three("basket")
    corr = np.array([[1.0, 0.5, 0.2], [0.5, 1.0, 0.4], [0.2, 0.4, 1.0]])
    kw = dict(s0=[100.0, 50.0, 75.0], mu=[0.03, 0.02, 0.04],
              sigma=[0.2, 0.3, 0.25], corr=corr, dt=1 / 252)
    direct = BasketGBM.create(weights=[0.5, 0.3, 0.2], device="cpu", **kw)
    for k, v in process_to_numpy(direct).items():
        np.testing.assert_array_equal(v, process_to_numpy(tb)[k])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BasketGBM.create(weights=[0.5, 0.3, 0.2], **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiGBM.create(**kw)
