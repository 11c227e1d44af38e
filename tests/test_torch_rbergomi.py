"""The port's rough Bergomi (processes/rough_bergomi.py) and the plain
versions of K5 (ops/rng_kernel.py) and K6 (ops/rbergomi_kernel.py) against
the JAX package, on the CPU.

Tolerances:

- ``volterra_joint_chol`` is the same float64 numpy code: bitwise.  The
  model's leaves are float64 rounded to float32 once on each side: bitwise.
- K5: Threefry words and uniforms bitwise; normals within 4.8e-7 absolute
  (the two platforms' log/sqrt/sin/cos, as for every Box-Muller draw).
- K6's plain version against ``rbergomi_terminal_pallas(interpret=True)``
  on the same joint matrix, tpow and params: only the perpendicular normals
  differ (4.8e-7 absolute), so rtol 2e-6 on the prices.
- ``rbergomi_simulate`` against JAX's CPU path: the factor product sums in
  each library's own order and JAX's XLA tail groups c_perp and sums log S
  by a reduction, where the port follows K6.  JAX holds its own two tails
  to rtol 3e-5; measured here at most 3.8e-6 (terminal) and 1e-6 (paths),
  so rtol 1e-5.
- ``path_offset``: a product's blocking may change with N, so a shifted
  block of paths agrees within rtol 2e-5, as the JAX test states it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.ops.rbergomi_kernel import rbergomi_terminal_pallas
from montecarlo_tpu.ops.rng_kernel import normal_matrix_pallas
from montecarlo_tpu.processes.rough_bergomi import RoughBergomi as JRB
from montecarlo_tpu.processes.rough_bergomi import (
    rbergomi_simulate as jrbergomi_simulate)
from montecarlo_tpu.processes.rough_bergomi import (
    volterra_joint_chol as jvolterra_joint_chol)
from montecarlo_tpu.rng.normal import normal_draw as jnormal_draw
from montecarlo_tpu.rng.normal import uniform_from_bits as juniform
from montecarlo_tpu.rng.threefry import threefry2x32 as jthreefry
from montecarlo_tpu_torch.convert import process_from_numpy, process_to_numpy
from montecarlo_tpu_torch.engine import black_scholes_call
from montecarlo_tpu_torch.ops import (normal_matrix,
                                      normal_matrix_reference,
                                      rbergomi_terminal,
                                      rbergomi_terminal_reference)
from montecarlo_tpu_torch.processes import (RoughBergomi, rbergomi_simulate,
                                            volterra_joint_chol)
from montecarlo_tpu_torch.precision import factor_product
from montecarlo_tpu_torch.ops.rbergomi_kernel import (
    N_ANGLES, boxmuller_angles, boxmuller_angles_reference)
from montecarlo_tpu_torch.rng.normal import boxmuller_pair, uniform_from_bits
from montecarlo_tpu_torch.rng.threefry import key_from_seed, threefry2x32

torch.set_num_threads(1)

S0, XI0, ETA, RHO, H, T = 100.0, 0.04, 1.5, -0.7, 0.1, 0.5
NORMAL_ATOL = 4.8e-7
SIM_RTOL = 1e-5
WRAP = 2**32 - 500


def _models(n_steps, **kw):
    args = dict(s0=S0, xi0=XI0, eta=ETA, rho=RHO, h=H, n_steps=n_steps, T=T)
    args.update(kw)
    return JRB.create(**args), RoughBergomi.create(**args, device="cpu")


@pytest.mark.parametrize("n,T_,h", [(16, 0.5, 0.1), (17, 1.0, 0.3),
                                    (64, 0.1, 0.07)])
def test_volterra_joint_chol_bitwise(n, T_, h):
    want = jvolterra_joint_chol(n, T_, h)
    got = volterra_joint_chol(n, T_, h)
    assert got.dtype == np.float64 and got.shape == (2 * n, 2 * n)
    np.testing.assert_array_equal(got, want)


def test_create_and_convert_round_trip_bitwise():
    jm, tm = _models(17)
    fields = {k: np.asarray(v) for k, v in jm._asdict().items()}
    carried = process_from_numpy("rbergomi", fields, device="cpu")
    assert list(process_to_numpy(tm)) == list(fields) == [
        "s0", "xi0", "eta", "rho", "h", "chol", "t_grid", "dt"]
    for model in (tm, carried):
        for k, v in process_to_numpy(model).items():
            assert v.dtype == np.float32, k
            np.testing.assert_array_equal(v, fields[k], err_msg=k)
    assert tm.n_steps == carried.n_steps == 17
    assert tm.chol.shape == (34, 34) and tm.device.type == "cpu"


@pytest.mark.parametrize("n_paths,n_cols,offset", [(1024, 32, 7000),
                                                   (1024, 37, 123)])
def test_normal_matrix_matches_pallas_interpret(n_paths, n_cols, offset):
    """Aligned, and odd n_cols (the half-pair guard and a ragged chunk);
    8-column chunks keep the interpreted kernel's unrolled body small."""
    want = np.asarray(normal_matrix_pallas(5, 2, n_paths, n_cols,
                                           path_offset=offset, block_rows=8,
                                           col_chunk=8, interpret=True))
    got = normal_matrix(5, 2, n_paths, n_cols, path_offset=offset,
                        device="cpu")
    assert got.shape == (n_cols, n_paths) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_ATOL)


def test_normal_matrix_wraps_like_normal_draw():
    """Path ids past 2^32 wrap: held against JAX's uint32 ``normal_draw``,
    with the words and uniforms of every pair bitwise."""
    n, cols, seed, stream = 1000, 37, 11, 3
    ids = (np.arange(n, dtype=np.uint64) + WRAP).astype(np.uint32)
    want = np.asarray(jnormal_draw(seed, stream, jnp.asarray(ids)[None, :],
                                   jnp.arange(cols, dtype=jnp.uint32)[:, None],
                                   jnp.float32))
    got = normal_matrix_reference(seed, stream, n, cols, path_offset=WRAP)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORMAL_ATOL)
    k0, k1 = key_from_seed(seed, stream)
    pairs = np.arange((cols + 1) // 2, dtype=np.uint32)[:, None]
    jw = jthreefry(jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(ids)[None, :],
                   jnp.asarray(pairs))
    tw = threefry2x32(k0, k1, torch.from_numpy(ids.astype(np.int64))[None, :],
                      torch.from_numpy(pairs.astype(np.int64)))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.int64))
        np.testing.assert_array_equal(uniform_from_bits(a).numpy(),
                                      np.asarray(juniform(b)))


def _params(jm):
    from montecarlo_tpu.rng.normal import log32 as jlog32

    return np.array(jnp.stack([
        jm.xi0, jm.eta, jm.rho,
        jnp.sqrt(1.0 - jnp.square(jm.rho)) * jnp.sqrt(jm.dt),
        0.5 * jm.dt, jlog32(jm.s0), 0.5 * jnp.square(jm.eta),
    ]).astype(jnp.float32))


def test_rbergomi_terminal_plain_matches_pallas_interpret():
    """The same numpy joint matrix, tpow and params into both: only the
    in-kernel perpendicular normals differ."""
    n_steps, n = 16, 1024
    jm, tm = _models(n_steps)
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2 * n_steps, n)).astype(np.float32)
    joint = (np.asarray(jm.chol, np.float64) @ z).astype(np.float32)
    tpow = np.array(jm.t_grid ** (2.0 * jm.h), np.float32)
    params = _params(jm)
    np.testing.assert_array_equal(tm.kernel_params().numpy(), params)
    want = np.asarray(rbergomi_terminal_pallas(
        jnp.asarray(joint), jnp.asarray(tpow), jnp.asarray(params), 7, 1,
        n_steps=n_steps, path_offset=4096, block_rows=8, interpret=True))
    got = rbergomi_terminal(torch.from_numpy(joint), torch.from_numpy(tpow),
                            torch.from_numpy(params), 7, 1, n_steps=n_steps,
                            path_offset=4096)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)


def test_boxmuller_angles_reference_is_boxmuller_pair():
    """The plain version of K6's angle check takes Box-Muller's sine and
    cosine exactly as ``boxmuller_pair`` does: its normals are r times
    them, bitwise, at words of every angle index's extremes and between;
    the check's wrapper runs it for a CPU device."""
    ref = boxmuller_angles_reference("cpu")
    assert ref.shape == (2, N_ANGLES)
    assert torch.equal(boxmuller_angles("cpu"), ref)
    rng = np.random.default_rng(13)
    m = np.concatenate([[0, 1, N_ANGLES - 1],
                        rng.integers(0, N_ANGLES, 4096)])
    b1 = torch.from_numpy((m << 9) + rng.integers(0, 512, m.size))
    b0 = torch.from_numpy(rng.integers(0, 2**32, m.size))
    z0, z1 = boxmuller_pair(b0, b1)
    r = torch.sqrt(-2.0 * torch.log(uniform_from_bits(b0)))
    idx = torch.from_numpy(m)
    assert torch.equal(z0, r * ref[1, idx])
    assert torch.equal(z1, r * ref[0, idx])


def test_rbergomi_terminal_rejects_bad_shapes():
    joint = torch.zeros(10, 8)
    with pytest.raises(ValueError, match="2T"):
        rbergomi_terminal_reference(joint, torch.zeros(4), torch.zeros(7), 0,
                                    0, n_steps=4)
    with pytest.raises(ValueError, match="tpow"):
        rbergomi_terminal_reference(joint, torch.zeros(4), torch.zeros(7), 0,
                                    0, n_steps=5)
    with pytest.raises(ValueError, match="n_cols"):
        normal_matrix_reference(0, 0, 8, 0)


@pytest.mark.parametrize("n_steps", [16, 17, 64])
@pytest.mark.parametrize("mode", ["terminal", "paths"])
def test_rbergomi_simulate_matches_jax(n_steps, mode):
    """Odd T runs here only: JAX's K6 rejects it, its CPU tail does not."""
    jm, tm = _models(n_steps)
    want = jrbergomi_simulate(jm, 2048, seed=5, path_offset=77, mode=mode)
    got = rbergomi_simulate(tm, 2048, seed=5, path_offset=77, mode=mode)
    if mode == "terminal":
        want, got = (want,), (got,)
    else:
        assert got[0].shape == (2048, n_steps)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SIM_RTOL)


def test_terminal_mode_runs_the_kernels_plain_versions():
    """On the CPU the sampler is K5's plain version, the true-float32
    product and K6's plain version, bitwise; paths mode draws the same
    first 2T rows."""
    _, tm = _models(17)
    n = 1000
    got = rbergomi_simulate(tm, n, seed=2, path_offset=WRAP)
    z = normal_matrix_reference(2, 0, n, 34, path_offset=WRAP)
    joint = factor_product(tm.chol, z)
    want = rbergomi_terminal_reference(joint, tm.tpow(), tm.kernel_params(),
                                       2, 0, n_steps=17, path_offset=WRAP)
    assert torch.equal(got, want)
    z3 = normal_matrix_reference(2, 0, n, 51, path_offset=WRAP)
    assert torch.equal(z3[:34], z)


@pytest.mark.parametrize("setting", ["high", "medium"])
def test_factor_product_restores_the_precision_setting(setting):
    _, tm = _models(4)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 64)).astype(np.float32))
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(setting)
        got = factor_product(tm.chol, z)
        assert torch.get_float32_matmul_precision() == setting
        torch.set_float32_matmul_precision("highest")
        assert torch.equal(got, torch.matmul(tm.chol, z))
    finally:
        torch.set_float32_matmul_precision(before)


def test_martingale_and_offset_consistency():
    _, tm = _models(16)
    s_t = rbergomi_simulate(tm, 1 << 15, seed=5).double()
    se = float(s_t.std() / np.sqrt(s_t.numel()))
    assert abs(float(s_t.mean()) - S0) < 5 * se
    a = rbergomi_simulate(tm, 4096, seed=13)
    assert torch.equal(a, rbergomi_simulate(tm, 4096, seed=13))
    off = rbergomi_simulate(tm, 2048, seed=13, path_offset=2048)
    np.testing.assert_allclose(off.numpy(), a[2048:].numpy(), rtol=2e-5)


def test_zero_vol_of_vol_is_black_scholes():
    """eta = 0: v == xi0, so the call is Black-Scholes with sigma =
    sqrt(xi0), within 5 std-err + 1e-3."""
    _, tm = _models(16, eta=0.0, rho=0.0)
    pay = torch.clamp(rbergomi_simulate(tm, 1 << 15, seed=7) - 100.0,
                      min=0.0).double()
    se = float(pay.std() / np.sqrt(pay.numel()))
    bs = black_scholes_call(S0, 100.0, 0.0, np.sqrt(XI0), T)
    assert abs(float(pay.mean()) - bs) < 5 * se + 1e-3
