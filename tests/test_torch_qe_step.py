"""The QE step, VG's gamma inversion and their inverse normal in the
port's kernels, built for the host with g++ (-ffp-contract=off, as the
card's -fmad=false) from ``csrc/rng.cuh`` and ``csrc/qe_step.cuh``.

- ``mc::ndtri32_unit``, the one-rational inverse normal that the QE step
  and VG's gamma inversion call, equals ``mc::ndtri32`` bit for bit on
  every value ``uniform_from_bits`` gives (which are their own mirrors 1 -
  u), on VG's clamp bounds and on 2^20 random float32 in [2^-24, 1 -
  2^-24]; and it is within the 1e-6 of JAX's ``ndtri32`` that
  ``test_torch_rng.py`` holds the port's to.
- ``mc::QECore::step``, whose divisions are paired by operand selection,
  equals the form it replaced (carried here as C++ source: both branches'
  eight divisions and ``ndtri32``) bit for bit on 2^20 (v, u) pairs at
  the CLI's HestonQE and BatesQE constants and at a set where Feller's
  condition holds, with v = 0, v = theta and very small v among them; so
  does each path's own branch computed alone (``quadratic``,
  ``exponential``: what ``step_warp_uniform`` runs where a warp's lanes
  agree).
- ``mc::gamma_from_uniforms_quad32``, VG's gamma inversion over its table
  interleaved by interval, equals the two tables' form bit for bit, and
  VG's launch leaves end with that table on 16 bytes.

Both sides call the same ``logf`` (glibc's here, libdevice's on the card),
so equal bits here rest on the algebra alone: padding a polynomial with a
leading 0, -(a / b) = (-a) / b, and a division's result depending on its
operands only.  The card's check (``chip_smoke.py``'s phase 2 and
``tests/test_torch_cuda.py``) runs every float32 of the range.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.rng import normal as jnormal

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

# The QE step as it stood before its divisions were paired: both branches'
# eight divisions, ndtri32's three rationals.
_PARENT_QE = r"""
struct ParentQE {
  float theta, e_kdt, c1, c2, k0, k1, k2, k3, k4, A, two_A, head_c;
  ParentQE(float theta_, const float* q)
      : theta(theta_), e_kdt(q[0]), c1(q[1]), c2(q[2]), k0(q[3]), k1(q[4]),
        k2(q[5]), k3(q[6]), k4(q[7]), A(q[8]) {
    two_A = 2.0f * A;
    head_c = -(k1 + 0.5f * k3);
  }
  float step(float v, float u, float* k0s, float* sq) const {
    const float m = theta + (v - theta) * e_kdt;
    const float s2 = v * c1 + c2;
    const float m2 = m * m;
    const bool quad = s2 <= 1.5f * m2;
    const float inv2 = (2.0f * m2) / s2;
    const float tw1 = fmaxf(inv2 - 1.0f, 0.0f);
    const float b2 = fmaxf((inv2 - 1.0f) + sqrtf(inv2 * tw1), 0.0f);
    const float a = m / (1.0f + b2);
    const float zq = sqrtf(b2) + mc::ndtri32(u);
    const float v_quad = a * (zq * zq);
    const float p = (s2 - m2) / (s2 + m2);
    const float beta = (1.0f - p) / m;
    const float tail = mc::log32((1.0f - p) / (1.0f - u)) / beta;
    const float v_exp = u <= p ? 0.0f : fmaxf(tail, 0.0f);
    const float v_new = quad ? v_quad : v_exp;
    const float den = 1.0f - two_A * a;
    const bool ok_q = den > 0.0f;
    const float den_s = ok_q ? den : 1.0f;
    const float gap = beta - A;
    const bool ok_e = gap > 0.0f;
    const float mgf_e =
        fmaxf(p + (beta * (1.0f - p)) / (ok_e ? gap : 1.0f), 1e-30f);
    const float lg = mc::log32(quad ? den_s : mgf_e);
    const float lm = quad ? ((A * b2) * a) / den_s - 0.5f * lg : lg;
    const bool ok = quad ? ok_q : ok_e;
    *k0s = ok ? head_c * v - lm : k0;
    const float var_s = k3 * v + k4 * v_new;
    *sq = var_s > 0.0f ? sqrtf(var_s) : 0.0f;
    return v_new;
  }
};
"""

_SHIM = r"""
#include "rng.cuh"
#include "qe_step.cuh"
""" + _PARENT_QE + r"""
extern "C" {
void host_ndtri(const float* u, float* unit, float* full, long n) {
  for (long i = 0; i < n; ++i) {
    unit[i] = mc::ndtri32_unit(u[i]);
    full[i] = mc::ndtri32(u[i]);
  }
}
// out (9, n): the step's v', K0*, sqrt; the parent form's; those of the
// path's own branch computed alone (the warp-uniform step's branches).
void host_qe(float theta, const float* q, const float* v, const float* u,
             float* out, long n) {
  const mc::QECore qe(theta, q);
  const ParentQE parent(theta, q);
  for (long i = 0; i < n; ++i) {
    out[i] = qe.step(v[i], u[i], &out[n + i], &out[2 * n + i]);
    out[3 * n + i] = parent.step(v[i], u[i], &out[4 * n + i],
                                 &out[5 * n + i]);
    float m, m2, s2;
    const bool quad = qe.moments(v[i], &m, &m2, &s2);
    const mc::QECore::Branch b = quad ? qe.quadratic(m, m2, s2, u[i])
                                      : qe.exponential(m, m2, s2, u[i]);
    out[6 * n + i] = qe.finish(v[i], b, &out[7 * n + i], &out[8 * n + i]);
  }
}
// out (2, n): the gamma variate over the two tables, then over the table
// interleaved by interval.
void host_gamma(float a, const float* uw, const float* ub, float z0,
                float dz, const float* r, const float* d, const float* quad,
                int nt, float* out, long n) {
  for (long i = 0; i < n; ++i) {
    out[i] = mc::gamma_from_uniforms_table32(a, uw[i], ub[i], z0, dz, r, d,
                                             nt);
    out[n + i] = mc::gamma_from_uniforms_quad32(a, uw[i], ub[i], z0, dz,
                                                quad, nt);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build rng.cuh for the host")
    d = tmp_path_factory.mktemp("qe_step")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _ndtri(lib, u):
    u = np.ascontiguousarray(u, np.float32)
    unit, full = np.empty_like(u), np.empty_like(u)
    lib.host_ndtri(_ptr(u), _ptr(unit), _ptr(full), ctypes.c_long(u.size))
    return unit, full


def _bits_equal(a, b):
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


#: Every value uniform_from_bits gives: (k + 1/2) 2^-23, k < 2^23.
UNIFORMS = ((np.arange(1 << 23, dtype=np.float64) + 0.5)
            * 2.0 ** -23).astype(np.float32)
LO, HI = np.float32(2.0 ** -24), np.float32(1 - 2.0 ** -24)


def test_uniform_set_is_its_own_mirror():
    np.testing.assert_array_equal(np.sort(np.float32(1) - UNIFORMS),
                                  UNIFORMS)
    assert UNIFORMS[0] == LO and UNIFORMS[-1] == HI


def test_unit_inverse_equals_ndtri32_on_every_uniform(lib):
    unit, full = _ndtri(lib, UNIFORMS)
    _bits_equal(unit, full)
    # Both tails and the centre are reached: the middle rational below
    # 0.075 and above 0.925, the central between.
    assert unit[0] < -5.0 and unit[-1] > 5.0 and unit[1 << 22] > 0


def test_unit_inverse_equals_ndtri32_at_the_bounds(lib):
    # VG's clamp bounds (rng.cuh: 6e-8 and (float)(1 - 6e-8)), the range's
    # ends, the central/middle switch at |u - 1/2| = 0.425 and u = 1/2.
    edges = [np.float32(6e-8), np.float32(1.0 - 6e-8), LO, HI,
             np.float32(0.5), np.float32(0.075), np.float32(0.925)]
    edges += [np.nextafter(e, np.float32(d)) for e in edges[4:]
              for d in (0, 1)]
    u = np.array(edges, np.float32)
    assert u.min() >= LO and u.max() <= HI
    unit, full = _ndtri(lib, u)
    _bits_equal(unit, full)


def test_unit_inverse_equals_ndtri32_on_random_floats(lib):
    """2^20 float32 in [2^-24, 1 - 2^-24]: half uniform in value, half
    uniform over the bit patterns (most of them near 0)."""
    rng = np.random.default_rng(17)
    half = 1 << 19
    by_value = rng.uniform(float(LO), float(HI), half).astype(np.float32)
    lo, hi = (np.array([LO, HI], np.float32).view(np.uint32)
              .astype(np.int64))
    by_bits = rng.integers(lo, hi + 1, half).astype(np.uint32).view(
        np.float32)
    u = np.clip(np.concatenate([by_value, by_bits]), LO, HI)
    unit, full = _ndtri(lib, u)
    _bits_equal(unit, full)


def test_unit_inverse_within_1e6_of_jax(lib):
    rng = np.random.default_rng(5)
    u = np.concatenate([UNIFORMS[::8], rng.uniform(
        float(LO), float(HI), 1 << 16).astype(np.float32), [LO, HI]]
    ).astype(np.float32)
    unit, _ = _ndtri(lib, u)
    want = np.asarray(jnormal.ndtri32(jnp.asarray(u), jnp.float32))
    np.testing.assert_allclose(unit, want, rtol=0, atol=1e-6)


def _qe_leaves(flags):
    """(theta, the nine QE leaves) of ``price <flags>``'s process."""
    from montecarlo_tpu_torch.cli.pricing import cli_process
    from montecarlo_tpu_torch.ops.fused_engine import _leaves

    proc = cli_process(flags, "cpu")[0]
    leaves = _leaves(proc)[2].numpy()
    return np.float32(proc.theta), np.ascontiguousarray(leaves[-9:])


QE_SETS = {
    "heston-qe": ["--process", "heston-qe", "--steps", "252"],
    "bates-qe": ["--process", "bates-qe", "--steps", "252"],
    "heston-qe feller": ["--process", "heston-qe", "--steps", "252",
                         "--kappa", "2", "--theta", "0.04", "--xi", "0.3"],
}


@pytest.mark.parametrize("name", sorted(QE_SETS))
def test_qe_step_equals_the_unpaired_form(lib, name):
    theta, q = _qe_leaves(QE_SETS[name])
    assert q.dtype == np.float32 and q.size == 9
    rng = np.random.default_rng(len(name))
    n = 1 << 20
    special = np.array([0.0, theta, 1e-30, 1e-38, 1e-45, 1e-12, 1e-6,
                        4 * theta], np.float32)
    v = np.concatenate([
        special.repeat(1024),
        (theta * rng.lognormal(0.0, 1.5, n // 2)).astype(np.float32),
        (theta * rng.uniform(0.0, 3.0, n)).astype(np.float32)])[:n]
    u = UNIFORMS[rng.integers(0, 1 << 23, n)]
    v, u = np.ascontiguousarray(v), np.ascontiguousarray(u)
    out = np.empty((9, n), np.float32)
    lib.host_qe(ctypes.c_float(float(theta)), _ptr(q), _ptr(v), _ptr(u),
                _ptr(out), ctypes.c_long(n))
    assert np.isfinite(out).all()
    _bits_equal(out[:3], out[3:6])
    _bits_equal(out[6:], out[3:6])
    # The CLI's sets take both branches (the exponential one at small v:
    # psi(0) = xi^2 / (2 kappa theta) = 1.5625 > 1.5); where Feller's
    # condition holds (psi(0) = 0.5625) every step is quadratic.
    m = theta + (v - theta) * q[0]
    quad = v * q[1] + q[2] <= np.float32(1.5) * (m * m)
    assert quad.any() and (~quad).any() == ("feller" not in name), name


def _vg():
    from montecarlo_tpu_torch.cli.pricing import cli_process

    return cli_process(["--process", "vg", "--steps", "252"], "cpu")[0]


def test_gamma_over_the_interleaved_table_equals_the_two_tables(lib):
    """VgProc's gamma variate over the table interleaved by interval
    (ops.fused_engine.vg_quad_table) equals the two tables' bit for bit,
    on 2^20 uniform pairs, VG's clamp bounds and both ends of the table."""
    from montecarlo_tpu_torch.ops.fused_engine import vg_quad_table

    vg = _vg()
    rng = np.random.default_rng(9)
    n = 1 << 20
    u_w = UNIFORMS[rng.integers(0, 1 << 23, n)]
    u_w[:6] = [0.0, 1.0, 6e-8, 1 - 6e-8, LO, HI]
    u_b = UNIFORMS[rng.integers(0, 1 << 23, n)]
    resid = vg.gq_resid.numpy()
    dresid = vg.gq_dresid.numpy()
    quad = vg_quad_table(vg).numpy()
    assert quad.size == 4 * (resid.size - 1)
    out = np.empty((2, n), np.float32)
    lib.host_gamma(ctypes.c_float(float(vg.dt / vg.nu)), _ptr(u_w),
                   _ptr(u_b), ctypes.c_float(float(vg.gq_z0)),
                   ctypes.c_float(float(vg.gq_dz)), _ptr(resid),
                   _ptr(dresid), _ptr(quad), ctypes.c_int(resid.size),
                   _ptr(out), ctypes.c_long(n))
    assert np.isfinite(out).all()
    _bits_equal(out[1], out[0])


def test_vg_launch_leaves_end_with_the_interleaved_table():
    """VG's launch leaves: its own, zeros to 16 bytes (where VgProc looks
    for the table: (8 + 2 n + 3) & ~3 floats in), the interleaved table;
    built once per process."""
    from montecarlo_tpu_torch.ops import fused_engine
    from montecarlo_tpu_torch.ops.fused_engine import (_launch_leaves,
                                                       _leaves,
                                                       vg_quad_table)

    vg = _vg()
    code, dims, leaves = _leaves(vg)
    assert dims == vg.gq_resid.numel() and leaves.numel() == 8 + 2 * dims
    got_dims, got = _launch_leaves(vg, 252, dims, leaves)
    at = (8 + 2 * dims + 3) & ~3
    assert got_dims == dims and got.numel() == at + 4 * (dims - 1)
    assert torch.equal(got[:leaves.numel()], leaves)
    assert not got[leaves.numel():at].any()
    assert torch.equal(got[at:], vg_quad_table(vg))
    assert torch.equal(got[at:].reshape(-1, 4)[:, 0], vg.gq_resid[:-1])
    assert torch.equal(got[at:].reshape(-1, 4)[:, 3], vg.gq_dresid[1:])
    assert _launch_leaves(vg, 17, dims, leaves)[1] is got
    assert id(vg) in fused_engine._ROW_LEAVES
