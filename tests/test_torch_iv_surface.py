"""The port's implied vol (``engine/implied_vol.py``), price snapshots and
implied-vol surface (``engine/surface.py``, K4's snapshot fold through its
plain version) against themselves and the JAX package.

Tolerances, and why:

- ``implied_vol_call`` runs in float64 on the host on both sides (JAX
  under the tests' x64): ivs within 1e-10 absolute (the same Newton
  iteration; the normal CDFs are two float64 implementations).
- Inside the port: bitwise.  A snapshot folded by K4's plain version
  equals the torch loop's and the terminal of a run stopped at its step
  (the draws are keyed by path and step); a grid split into launches (K4's
  generic fold, four snapshots a launch, where the snapshot kernel is not
  built; the snapshot kernel past 64 snapshots) equals one torch-loop run
  with every snapshot.
- Against JAX's K4 in interpret mode and JAX's surface in float32: a
  path's price within PRICE_RTOL = 2e-6 (the normals differ by up to
  4.8e-7); the surface's prices, means over the paths summed in another
  order, within rtol 1e-5, and its ivs within 1e-4 where both are finite
  (an iv moves by the price's error over vega).
- The JAX tests' gates (tests/test_surface.py) on the port at their sizes
  and bounds, in float32.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.engine import implied_vol as jiv
from montecarlo_tpu.engine import surface as jsurf
from montecarlo_tpu.ops.fused_engine import fused_functionals_pallas
from montecarlo_tpu.processes import GBM as JGBM
from montecarlo_tpu.processes import Heston as JHeston
from montecarlo_tpu_torch.engine import (black_scholes_call_tensor,
                                         implied_vol_call, mc_estimate,
                                         mc_implied_vol_surface,
                                         price_snapshot,
                                         simulate_functionals)
from montecarlo_tpu_torch.engine.functionals import SNAPSHOT_CODE, DeviceForm
from montecarlo_tpu_torch.engine.surface import snapshot_terminals
from montecarlo_tpu_torch.ops import (fused_functionals_reference,
                                      fused_terminal_reference)
from montecarlo_tpu_torch.ops.fused_engine import (THREEFRY, K4Launch,
                                                   k4_launches)
from montecarlo_tpu_torch.processes import GBM, BasketGBM, Heston

S0, R, SIGMA = 100.0, 0.03, 0.2
PRICE_RTOL = 2e-6
HESTON = dict(s0=S0, v0=0.04, mu=R, kappa=2.0, theta=0.04, xi=0.6, rho=-0.8)
F32 = jnp.float32


def _proc(kind, dt):
    if kind == "gbm":
        return GBM.create(S0, R, SIGMA, dt, device="cpu")
    return Heston.create(**HESTON, dt=dt, device="cpu")


# --- implied vol -------------------------------------------------------------

def test_implied_vol_round_trip_and_broadcast():
    """Prices at known vols invert back; strike and maturity carry the
    batch (the start is broadcast to the common shape); JAX's solver gives
    the same ivs."""
    strikes = torch.tensor([80.0, 90.0, 100.0, 110.0, 125.0])
    mats = torch.tensor([[0.5], [1.0], [2.0]])
    vols = torch.tensor([[0.15], [0.35], [0.8]], dtype=torch.float64)
    prices = black_scholes_call_tensor(S0, strikes, R, vols, mats)
    iv = implied_vol_call(prices, S0, strikes, R, mats)
    assert iv.shape == (3, 5) and iv.dtype == torch.float64
    np.testing.assert_allclose(iv.numpy(), vols.expand(3, 5).numpy(),
                               atol=1e-6)
    jiv_ = np.asarray(jiv.implied_vol_call(
        jnp.asarray(prices.numpy()), S0, jnp.asarray(strikes.numpy()), R,
        jnp.asarray(mats.numpy().astype(np.float64))))
    np.testing.assert_allclose(iv.numpy(), jiv_, rtol=0, atol=1e-10)
    # A scalar price against a batch of strikes.
    one = implied_vol_call(prices[1, 2], S0, strikes, R, 1.0)
    assert one.shape == (5,) and abs(float(one[2]) - 0.35) < 1e-6


def test_implied_vol_is_nan_outside_the_no_arbitrage_band():
    lower = S0 - 90.0 * np.exp(-R * 1.0)
    iv = implied_vol_call(torch.tensor([lower - 0.1, lower + 0.5, S0 + 1.0,
                                        float("nan")]), S0, 90.0, R, 1.0)
    assert iv[0].isnan() and iv[1].isfinite()
    assert iv[2].isnan() and iv[3].isnan()


# --- the snapshot fold -------------------------------------------------------

@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_snapshot_plain_k4_is_the_torch_loop_and_the_shorter_run(kind):
    """K4's plain version folds snapshots at steps 0, 1, 16 and the last
    bitwise as the torch loop, each the terminal of a run stopped there
    (step 0 the spot), at a wrapping path offset, plain and antithetic."""
    n, steps, off = 2048, 24, 2**32 - 700
    proc = _proc(kind, 1 / 64)
    fns = {"s0": price_snapshot(0), "s1": price_snapshot(1),
           "s16": price_snapshot(16), "sT": price_snapshot(steps)}
    for anti in (False, True):
        got = fused_functionals_reference(proc, n, steps, seed=5,
                                          functionals=fns, path_offset=off,
                                          antithetic=anti)
        if not anti:
            loop = simulate_functionals(proc, n, steps, seed=5,
                                        functionals=fns, path_offset=off,
                                        prefer_fused=False)
            assert all(torch.equal(got[k], loop[k]) for k in loop)
        for k, s in (("s1", 1), ("s16", 16), ("sT", steps)):
            short = fused_terminal_reference(proc, n, s, seed=5,
                                             path_offset=off,
                                             antithetic=anti)
            assert torch.equal(got[k], short), (k, anti)
        assert torch.equal(got["sT"], got["terminal"])
        spot = fused_terminal_reference(proc, n, 0, seed=5, path_offset=off)
        assert torch.equal(got["s0"], spot)  # exp32(log32(S0)) at step 0


def test_snapshot_plain_k4_matches_pallas_interpret():
    """The snapshot fold against JAX's K4 in interpret mode, as
    tests/test_torch_functionals.py runs it."""
    n, steps = 1024, 16
    jp = JGBM.create(S0, R, SIGMA, 1 / 64, dtype=F32)
    items = tuple((f"m{s}", jsurf.price_snapshot(s)) for s in (0, 5, 16))
    want = fused_functionals_pallas(jp, n, steps, seed=9,
                                    functional_items=items, block_rows=8,
                                    interpret=True)
    got = fused_functionals_reference(
        _proc("gbm", 1 / 64), n, steps, seed=9,
        functionals={f"m{s}": price_snapshot(s) for s in (0, 5, 16)})
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=PRICE_RTOL, err_msg=k)


def _snapshot_forms(steps):
    return [DeviceForm(SNAPSHOT_CODE, s) for s in steps]


def test_grouped_launches_are_one_long_run():
    """What still groups.  A 6-maturity grid on a functor the snapshot
    kernel is not built for (the basket) takes two launches of K4's
    generic fold (four snapshots sorted by step, then one and the
    terminal), each to its own last step; on Heston one launch of the
    snapshot kernel; a grid of 66 maturities on GBM two snapshot launches
    (64 snapshots, then one).  Their rows are bitwise one torch-loop run
    holding every snapshot."""
    steps = [3, 8, 13, 21, 30, 47]
    basket = BasketGBM.create([100.0, 90.0], [0.03, 0.03], [0.2, 0.3],
                              [[1.0, 0.4], [0.4, 1.0]], [0.6, 0.4], 1 / 64,
                              device="cpu")
    heston = _proc("heston", 1 / 64)
    shuffled = _snapshot_forms([21, 3, 30, 13, 8])
    assert k4_launches(basket, THREEFRY, shuffled, 47) == [
        K4Launch(False, 21, (1, 4, 3, 0)), K4Launch(False, 47, (2,))]
    assert k4_launches(heston, THREEFRY, shuffled, 47) == [
        K4Launch(True, 47, (1, 4, 3, 0, 2))]
    assert k4_launches(heston, THREEFRY, [], 5) == [K4Launch(False, 5, ())]
    long_grid = list(range(1, 67))
    assert k4_launches(_proc("gbm", 1 / 64), THREEFRY,
                       _snapshot_forms(long_grid[:-1]), 66) == [
        K4Launch(True, 64, tuple(range(64))), K4Launch(True, 66, (64,))]
    for proc, grid, n in ((basket, steps, 1024), (heston, steps, 1024),
                          (_proc("gbm", 1 / 64), long_grid, 256)):
        rows = snapshot_terminals(proc, n, grid, seed=2)
        one = simulate_functionals(
            proc, n, grid[-1], seed=2, prefer_fused=False,
            functionals={f"m{j}": price_snapshot(s)
                         for j, s in enumerate(grid)})
        assert rows.shape == (len(grid), n)
        for j in range(len(grid)):
            assert torch.equal(rows[j], one[f"m{j}"]), (type(proc), j)
        assert torch.equal(rows[-1], one["terminal"])


def test_price_snapshot_device_form():
    from montecarlo_tpu_torch.engine.functionals import SNAPSHOT_CODE

    assert price_snapshot(0).device(9) == (SNAPSHOT_CODE, 0, ())
    assert price_snapshot(7).device(9) == (SNAPSHOT_CODE, 7, ())
    with pytest.raises(ValueError):
        price_snapshot(-1)


# --- the surface -------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gbm", "heston"])
def test_surface_matches_jax(kind):
    """The port's surface against JAX's ``mc_implied_vol_surface`` in
    float32 on the CPU, over a 6-maturity grid (one snapshot launch)."""
    dt = 1 / 64
    if kind == "gbm":
        jp = JGBM.create(S0, R, SIGMA, dt, dtype=F32)
    else:
        jp = JHeston.create(**HESTON, dt=dt, dtype=F32)
    strikes = [85.0, 95.0, 100.0, 105.0, 115.0]
    grid = [4, 8, 16, 24, 32, 48]
    got = mc_implied_vol_surface(_proc(kind, dt), strikes, grid, dt, rate=R,
                                 n_paths=1 << 13, seed=3)
    want = jsurf.mc_implied_vol_surface(jp, strikes, grid, dt, rate=R,
                                        n_paths=1 << 13, seed=3, dtype=F32)
    for k in ("maturities", "strikes"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["prices"], want["prices"], rtol=1e-5,
                               atol=1e-7)
    both = np.isfinite(got["ivs"]) & np.isfinite(want["ivs"])
    assert np.array_equal(np.isfinite(got["ivs"]), np.isfinite(want["ivs"]))
    assert both.sum() >= 25
    np.testing.assert_allclose(got["ivs"][both], want["ivs"][both], atol=1e-4)


def test_gbm_surface_is_flat_at_sigma():
    """tests/test_surface.py's gate on the port (float32)."""
    dt = 1 / 64
    surf = mc_implied_vol_surface(_proc("gbm", dt), [90.0, 100.0, 110.0],
                                  [16, 32, 64], dt, rate=R, n_paths=1 << 16,
                                  seed=3)
    assert surf["ivs"].shape == (3, 3)
    np.testing.assert_allclose(surf["ivs"], SIGMA, atol=0.01)
    np.testing.assert_allclose(surf["maturities"], [0.25, 0.5, 1.0])


def test_heston_surface_smiles():
    dt = 1 / 64
    surf = mc_implied_vol_surface(_proc("heston", dt), [80.0, 100.0, 120.0],
                                  [64], dt, rate=R, n_paths=1 << 16, seed=7)
    ivs = surf["ivs"][0]
    assert np.isfinite(ivs).all() and ivs[0] > ivs[1] > ivs[2]


def test_forward_start_option_via_snapshot():
    """tests/test_surface.py's forward start on the port: max(S_T - k
    S_t1, 0) from one run with a snapshot at t1, against Rubinstein's
    S0 C_BS(1, k, r, sigma, T - t1)."""
    n_steps, t1, k = 64, 32, 1.05
    dt = 1.0 / n_steps
    out = simulate_functionals(_proc("gbm", dt), 1 << 16, n_steps, seed=21,
                               functionals={"s1": price_snapshot(t1)})
    pay = torch.clamp(out["terminal"] - k * out["s1"], min=0.0)
    est = mc_estimate(pay, float(np.exp(-R)))
    cf = S0 * float(black_scholes_call_tensor(1.0, k, R, SIGMA,
                                              (n_steps - t1) * dt))
    assert abs(float(est["price"]) - cf) < 4 * float(est["std_err"])
