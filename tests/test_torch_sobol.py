"""The port's randomized Sobol points (rng/sobol.py), its host Sobol samplers
(samplers/__init__.py) and the Sobol functions of the K0 device header
(csrc/rng.cuh, built for the host with g++) against the JAX package.

Tolerances and why:

- Direction numbers, LMS scrambles, Sobol integers, bit reversals,
  Owen-hashed words, uniforms, the bridge plan and the host samplers'
  tables are integer or exact float32 arithmetic (the host tables: scipy in
  float64, cast once): bitwise.
- Normals go through ``ndtri32``, which calls the platform's log (torch's
  CPU log, glibc's logf, XLA's log): within 1e-6 absolute (measured
  7.2e-7, 2 ULP near |z| = 5); ``ndtri32`` itself within 1e-6 of
  ``scipy.special.ndtri`` in float32 (the JAX package's AS241 budget).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_tpu.processes import GARCHBootstrap as JGarch
from montecarlo_tpu.rng import sobol as jsobol
from montecarlo_tpu.samplers import SobolSampler as JSobolSampler
from montecarlo_tpu_torch.processes import GARCHBootstrap, GBM, Heston
from montecarlo_tpu_torch.rng import sobol as tsobol
from montecarlo_tpu_torch.rng.normal import ndtri32
from montecarlo_tpu_torch.samplers import MixedSobolSampler, SobolSampler

torch.set_num_threads(1)

NORMAL_ATOL = 1e-6
CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"
# Point ids near 0, around 2^30 (where sobol_bits stops reading Gray-code
# bits) and wrapping past 2^32.
IDS = np.concatenate([np.arange(512), 2**30 - 256 + np.arange(512),
                      2**32 - 256 + np.arange(256)]).astype(np.uint32)


def _words(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


# --- tables and integers -----------------------------------------------------

@pytest.mark.parametrize("n_dims", [1, 17, 504])
def test_direction_numbers_and_lms_match_jax(n_dims):
    sv = tsobol.direction_numbers(n_dims)
    np.testing.assert_array_equal(sv, jsobol.direction_numbers(n_dims))
    assert sv.shape == (n_dims, 30) and sv.max() < 2**30
    np.testing.assert_array_equal(tsobol.lms_scramble(sv, 5),
                                  jsobol.lms_scramble(sv, 5))


def test_direction_numbers_need_scipys_table(monkeypatch):
    """scipy's direction numbers are its private ``_sv``: a scipy without
    it raises instead of falling back to another table."""
    from scipy.stats import qmc

    class NoTable:
        def __init__(self, *a, **kw):
            pass

    monkeypatch.setattr(qmc, "Sobol", NoTable)
    with pytest.raises(RuntimeError, match="_sv"):
        tsobol.direction_numbers(4)


def test_sobol_bits_match_jax_and_scipy():
    """Gray-code Sobol integers equal JAX's bitwise at every id (30 bits of
    the Gray code are read, so ids past 2^30 wrap as in JAX) and equal
    scipy's unscrambled points."""
    from scipy.stats import qmc

    sv = tsobol.direction_numbers(6)
    for d in range(6):
        got = tsobol.sobol_bits(torch.from_numpy(sv[d].astype(np.int32)),
                                _words(IDS)).numpy()
        want = np.asarray(jsobol.sobol_bits(jnp.asarray(sv[d]),
                                            jnp.asarray(IDS)))
        np.testing.assert_array_equal(got, want)
    ref = qmc.Sobol(d=6, scramble=False, bits=30).random(64)
    for d in range(6):
        x = tsobol.sobol_bits(torch.from_numpy(sv[d].astype(np.int32)),
                              _words(np.arange(64))).numpy()
        np.testing.assert_array_equal(x / 2.0**30, ref[:, d])


def test_reverse_owen_bits_and_uniforms_match_jax():
    r = np.random.default_rng(3)
    w = r.integers(0, 2**32, 1 << 14, dtype=np.uint32)
    np.testing.assert_array_equal(tsobol._reverse32(_words(w)).numpy(),
                                  np.asarray(jsobol._reverse32(jnp.asarray(w))))
    x = r.integers(0, 2**30, 1 << 14, dtype=np.uint32)
    x[:4] = [0, 1, 2**30 - 2, 2**30 - 1]
    keys = _keys(x.size, 4)
    got = tsobol._scrambled_uniform(_words(x), _words(keys)).numpy()
    want = np.asarray(jsobol._scrambled_uniform(jnp.asarray(x),
                                                jnp.asarray(keys)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    z = tsobol._shifted_normal(_words(x), _words(keys)).numpy()
    jz = np.asarray(jsobol._shifted_normal(jnp.asarray(x), jnp.asarray(keys),
                                           jnp.float32))
    np.testing.assert_allclose(z, jz, rtol=0, atol=NORMAL_ATOL)


def test_ndtri32_accuracy():
    """AS241 PPND7 in float32 against scipy's float64 ndtri of the same
    float32 inputs, tails included, and against JAX's float32 form."""
    from scipy.special import ndtri as sp_ndtri

    from montecarlo_tpu.rng.normal import ndtri32 as jndtri32

    u = np.concatenate([np.linspace(2.0**-24, 1 - 2.0**-24, 30001),
                        2.0 ** -np.arange(2, 24.0),
                        1 - 2.0 ** -np.arange(2, 24.0)]).astype(np.float32)
    got = ndtri32(torch.from_numpy(u)).numpy()
    assert got.dtype == np.float32
    assert np.max(np.abs(got - sp_ndtri(u.astype(np.float64)))) < 1e-6
    want = np.asarray(jndtri32(jnp.asarray(u), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)


def test_shifted_normal_edge_bits_finite():
    """Any Sobol integer under any Owen key maps to a finite normal, and
    the scramble reaches the deep tails."""
    x = _words([0, 1, (1 << 30) - 2, (1 << 30) - 1])
    for key in (0, 1, 0xDEADBEEF, 0x7FFFFFFF):
        assert torch.isfinite(tsobol._shifted_normal(x, key)).all(), key
    xs = torch.arange(1 << 16, dtype=torch.int64) << 14
    z = tsobol._shifted_normal(xs, 123)
    assert torch.isfinite(z).all()
    assert float(z.min()) < -4.0 and float(z.max()) > 4.0


def test_owen_scramble_preserves_dyadic_strata():
    """On each dyadic level m <= k the first 2^k points of a dimension hit
    every stratum of width 2^-m exactly 2^(k-m) times, for raw and
    LMS-scrambled direction numbers, several dims and keys."""
    k = 12
    ids = torch.arange(1 << k, dtype=torch.int64)
    sv_raw = tsobol.direction_numbers(8)
    for sv in (sv_raw, tsobol.lms_scramble(sv_raw, seed=42)):
        for dim in (0, 1, 7):
            x = tsobol.sobol_bits(torch.from_numpy(sv[dim].astype(np.int32)),
                                  ids)
            for key in (0, 1, 0x9E3779B9):
                u = tsobol._scrambled_uniform(x, key).numpy()
                assert ((u > 0) & (u < 1)).all()
                for m in (2, 6, 10):
                    counts = np.bincount((u * (1 << m)).astype(np.int64),
                                         minlength=1 << m)
                    np.testing.assert_array_equal(
                        counts, np.full(1 << m, 1 << (k - m)),
                        err_msg=f"dim={dim} key={key:#x} m={m}")


# --- samplers ----------------------------------------------------------------

@pytest.mark.parametrize("n_steps", [8, 9, 17, 252])
def test_sampler_tables_match_jax(n_steps):
    """SobolDeviceSampler's table and both bridge samplers' (sv, dims,
    coeffs) in JAX's layout (the kernel sampler's transposed tables
    transposed back), and the bridge matrix."""
    got = tsobol.SobolDeviceSampler.create(n_steps, 2, scramble_seed=7,
                                           device="cpu")
    want = jsobol.SobolDeviceSampler.create(n_steps, 2, scramble_seed=7)
    assert got.sv.dtype == torch.int32 and got.n_dims == 2 * n_steps
    np.testing.assert_array_equal(got.sv.numpy(), np.asarray(want.sv))
    np.testing.assert_array_equal(tsobol.brownian_bridge_matrix(n_steps),
                                  jsobol.brownian_bridge_matrix(n_steps))
    kern = tsobol.SobolBridgeKernelSampler.create(n_steps, scramble_seed=3,
                                                  device="cpu")
    dev = tsobol.SobolBridgeDeviceSampler.create(n_steps, scramble_seed=3,
                                                 device="cpu")
    jk = jsobol.SobolBridgeKernelSampler.create(n_steps, scramble_seed=3)
    jd = jsobol.SobolBridgeDeviceSampler.create(n_steps, scramble_seed=3)
    assert (kern.n_steps, kern.width) == (jk.n_steps, jk.width)
    for t in (kern, dev):
        np.testing.assert_array_equal(t.sv.numpy(), np.asarray(jd.sv))
        np.testing.assert_array_equal(t.dims.numpy(), np.asarray(jd.dims))
        np.testing.assert_array_equal(t.coeffs.numpy(),
                                      np.asarray(jd.coeffs))
    np.testing.assert_array_equal(kern.sv.numpy().T, np.asarray(jk.sv_t))
    np.testing.assert_array_equal(kern.dims.numpy().T, np.asarray(jk.dims_t))


def _gbm_pair():
    from montecarlo_tpu.processes import GBM as JGBM

    return JGBM.create(100.0, 0.03, 0.2, 1 / 16), GBM.create(
        100.0, 0.03, 0.2, 1 / 16, device="cpu")


@pytest.mark.parametrize("kind", ["device", "bridge"])
def test_device_sampler_draws_match_jax(kind):
    """One step's draws from the torch form of each device sampler against
    JAX's, same key words, ids across 2^30 and 2^32: within 4e-6 (the
    bridge's draw is a weighted sum of up to L = 6 normals, each within
    1e-6)."""
    jp, tp = _gbm_pair()
    n_steps = 17
    if kind == "device":
        t = tsobol.SobolDeviceSampler.create(n_steps, 1, device="cpu")
        j = jsobol.SobolDeviceSampler.create(n_steps, 1)
    else:
        t = tsobol.SobolBridgeKernelSampler.create(n_steps, device="cpu")
        j = jsobol.SobolBridgeKernelSampler.create(n_steps)
    for step in (0, 5, 16):
        got = t.draws(tp, 11, 3, _words(IDS), step)
        want = j.draws(jp, 11, 3, jnp.asarray(IDS), step, jnp.float32)
        assert len(got) == len(want) == 1
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=4 * NORMAL_ATOL)


@pytest.mark.parametrize("bridge", [False, True])
def test_host_sobol_table_matches_jax(bridge):
    got = SobolSampler.create(1000, 16, 1, seed=4, bridge=bridge,
                              device="cpu")
    want = JSobolSampler.create(1000, 16, 1, seed=4, dtype=jnp.float32,
                                bridge=bridge)
    assert got.z.dtype == torch.float32 and got.z.shape == (1000, 16, 1)
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    heston = Heston.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.5, -0.7, 1 / 8,
                           device="cpu")
    two = SobolSampler.for_process(heston, 300, 8, seed=2)
    assert isinstance(two, SobolSampler) and two.z.shape == (300, 8, 2)


def _garch_pair():
    r = np.random.default_rng(9).standard_t(5, 300) * 0.01
    jp = JGarch.create(r, s0=100.0, var0=1e-4)
    return jp, GARCHBootstrap.create(r, s0=100.0, var0=1e-4, device="cpu")


def test_mixed_sobol_table_matches_jax():
    """GARCH's uniform slot: ``for_process`` gives a MixedSobolSampler whose
    table (clipped raw points) equals JAX's; the layout is checked against
    the process, a bridge is refused."""
    jp, tp = _garch_pair()
    assert tp.draw_kinds == ("uniform",)
    got = SobolSampler.for_process(tp, 2000, 20, seed=6)
    want = JSobolSampler.for_process(jp, 2000, 20, seed=6, dtype=jnp.float32)
    assert isinstance(got, MixedSobolSampler) and got.kinds == want.kinds
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(want.z))
    assert float(got.z.min()) > 0 and float(got.z.max()) < 1
    got.validate(tp, 20)
    with pytest.raises(ValueError, match="covers 20 steps"):
        got.validate(tp, 21)
    with pytest.raises(ValueError, match="slot layout"):
        got.validate(GBM.create(100.0, 0.0, 0.2, 0.01, device="cpu"), 5)
    with pytest.raises(ValueError, match="uniform"):
        SobolSampler.for_process(tp, 100, 5, bridge=True)


def test_sampler_validation():
    """Short tables and multi-draw bridges raise before any draw; the
    normals-only samplers refuse GARCH's uniform draws."""
    from montecarlo_tpu_torch.engine import check_sampler

    _, gbm = _gbm_pair()
    heston = Heston.create(100.0, 0.04, 0.03, 2.0, 0.04, 0.5, -0.7, 1 / 8,
                           device="cpu")
    small = tsobol.SobolDeviceSampler.create(8, 1, device="cpu")
    small.validate(gbm, 8)
    with pytest.raises(ValueError, match="Sobol table"):
        small.validate(gbm, 9)
    with pytest.raises(ValueError, match="Sobol table"):
        small.validate(heston, 8)
    for cls in (tsobol.SobolBridgeKernelSampler,
                tsobol.SobolBridgeDeviceSampler):
        bridge = cls.create(8, device="cpu")
        bridge.validate(gbm, 5)
        with pytest.raises(ValueError, match="built for 8 steps"):
            bridge.validate(gbm, 9)
        with pytest.raises(ValueError, match="n_draws == 1"):
            bridge.validate(heston, 8)
    _, garch = _garch_pair()
    with pytest.raises(ValueError, match="non-normal"):
        check_sampler(small, garch, 4)
    with pytest.raises(TypeError, match="not a sampler"):
        check_sampler(object(), gbm, 4)


# --- the K0 header's Sobol functions on the host ------------------------------

_SHIM = r"""
#include "rng.cuh"
extern "C" {
void host_sobol_bits(const uint32_t* row, const uint32_t* ids, uint32_t* x,
                     long n) {
  for (long i = 0; i < n; ++i) x[i] = mc::sobol_bits(row, ids[i]);
}
void host_reverse(const uint32_t* w, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = mc::reverse32(w[i]);
}
void host_scrambled(const uint32_t* x, const uint32_t* key, float* u,
                    float* z, long n) {
  for (long i = 0; i < n; ++i) {
    u[i] = mc::scrambled_uniform(x[i], key[i]);
    z[i] = mc::shifted_normal(x[i], key[i]);
  }
}
void host_ndtri(const float* u, float* z, long n) {
  for (long i = 0; i < n; ++i) z[i] = mc::ndtri32(u[i]);
}
void host_sobol_normal(const uint32_t* sv, uint32_t k0, uint32_t k1,
                       const uint32_t* ids, const uint32_t* dims,
                       uint32_t* key, float* z, long n) {
  for (long i = 0; i < n; ++i) {
    key[i] = mc::sobol_key(k0, k1, dims[i]);
    z[i] = mc::sobol_normal(sv, k0, k1, ids[i], dims[i]);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build rng.cuh for the host")
    d = tmp_path_factory.mktemp("sobol_header")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_header_sobol_words_match_jax(lib):
    """sobol_bits (over the set Gray-code bits), reverse32 and the Owen
    hash's uniform of the device header equal JAX's bitwise; its normals
    (glibc's logf) within 1e-6."""
    n = IDS.size
    sv = jsobol.lms_scramble(jsobol.direction_numbers(3), 1)
    for d in range(3):
        row = np.ascontiguousarray(sv[d])
        x = np.empty(n, np.uint32)
        lib.host_sobol_bits(_ptr(row), _ptr(IDS), _ptr(x), ctypes.c_long(n))
        np.testing.assert_array_equal(
            x, np.asarray(jsobol.sobol_bits(jnp.asarray(row),
                                            jnp.asarray(IDS))))
    w = _keys(1 << 12, 8)
    out = np.empty_like(w)
    lib.host_reverse(_ptr(w), _ptr(out), ctypes.c_long(w.size))
    np.testing.assert_array_equal(out, np.asarray(
        jsobol._reverse32(jnp.asarray(w))))
    x = np.random.default_rng(2).integers(0, 2**30, 1 << 12, dtype=np.uint32)
    keys = _keys(x.size, 5)
    u, z = np.empty(x.size, np.float32), np.empty(x.size, np.float32)
    lib.host_scrambled(_ptr(x), _ptr(keys), _ptr(u), _ptr(z),
                       ctypes.c_long(x.size))
    np.testing.assert_array_equal(u, np.asarray(jsobol._scrambled_uniform(
        jnp.asarray(x), jnp.asarray(keys))))
    np.testing.assert_allclose(z, np.asarray(jsobol._shifted_normal(
        jnp.asarray(x), jnp.asarray(keys), jnp.float32)), rtol=0,
        atol=NORMAL_ATOL)


def test_header_ndtri_and_sobol_normal_match_the_port(lib):
    """The header's ndtri32 against the torch form (both within 1e-6 of
    JAX's), and its Sobol normal of (id, dim) against the port's draw,
    Owen keys bitwise."""
    u = np.concatenate([np.linspace(2.0**-24, 1 - 2.0**-24, 4001),
                        2.0 ** -np.arange(1, 33.0),
                        1 - 2.0 ** -np.arange(1, 25.0)]).astype(np.float32)
    z = np.empty_like(u)
    lib.host_ndtri(_ptr(u), _ptr(z), ctypes.c_long(u.size))
    np.testing.assert_allclose(z, ndtri32(torch.from_numpy(u)).numpy(),
                               rtol=0, atol=NORMAL_ATOL)
    smp = tsobol.SobolDeviceSampler.create(8, 2, scramble_seed=4,
                                           device="cpu")
    sv = np.ascontiguousarray(smp.sv.numpy().astype(np.uint32))
    dims = (np.arange(IDS.size) % 16).astype(np.uint32)
    key, zz = np.empty(IDS.size, np.uint32), np.empty(IDS.size, np.float32)
    lib.host_sobol_normal(_ptr(sv), ctypes.c_uint32(7), ctypes.c_uint32(9),
                          _ptr(IDS), _ptr(dims), _ptr(key), _ptr(zz),
                          ctypes.c_long(IDS.size))
    for d in range(16):
        m = dims == d
        assert (key[m] == tsobol._owen_key(7, 9, d)).all()
        want = tsobol._sobol_normal(smp.sv, 7, 9, _words(IDS[m]), d)
        np.testing.assert_allclose(zz[m], want.numpy(), rtol=0,
                                   atol=NORMAL_ATOL)
