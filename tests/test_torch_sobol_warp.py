"""The warp-shared Gray-code walk of the kernels' Sobol normals
(``csrc/sobol_warp.cuh``), built for the host with g++ and walked lane by
lane through the same template the card runs, against the per-path
``sobol_bits`` of ``csrc/rng.cuh`` and the JAX package's
``rng/sobol.py::sobol_bits`` and ``_shifted_normal``.

Tolerances and why: the Sobol integers are XORs of the same words, in
another order: bitwise.  The normals take the same integers through
``rng.cuh``'s hash and ``ndtri32``: bitwise against the header's own
per-path normal, and within 1e-6 of JAX's, whose ``ndtri32`` calls XLA's
log where the header calls glibc's ``logf`` (``tests/test_torch_sobol.py``'s
budget).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo_tpu.rng import sobol as jsobol
from montecarlo_tpu.rng.threefry import threefry2x32

NORMAL_ATOL = 1e-6
WARP = 32
CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"
#: The bases of the walked warps: the first ids, an odd and a past-a-warp
#: start, a deep id, three below 2^30 (where the Gray code stops being
#: read), 40 below 2^32 (the wrap inside the warp that starts 8 below 2^32).
BASES = [0, 1, 31, 33, (2**18) * 7 + 5, 2**30 - 3, 2**32 - 40, 2**32 - 8]
K0, K1 = 0x1234ABCD, 0x9E3779B9

_SHIM = r"""
#include "sobol_warp.cuh"

namespace {
// A walk whose gather drops lane `skip`'s delta: a scan that misses one.
struct SkipOne : mc::HostWarp {
  int skip;
  SkipOne(uint32_t base, int s) : mc::HostWarp(base), skip(s) {}
  Val gather(const Val& x) const {
    Val r = mc::HostWarp::gather(x);
    r.v[skip] = 0u;
    return r;
  }
};
}  // namespace

extern "C" {
// The kernels' walk: the Sobol integers of the warp at `base` in the
// dimension `row`, lane by lane; skip >= 0 drops that lane's delta.
void warp_bits(const uint32_t* row, uint32_t base, int skip, uint32_t* out) {
  if (skip < 0) {
    const mc::HostWarp::Val x = mc::warp_sobol_bits(mc::HostWarp(base), row);
    for (int l = 0; l < mc::kWarp; ++l) out[l] = x.v[l];
  } else {
    const mc::HostWarp::Val x = mc::warp_sobol_bits(SkipOne(base, skip), row);
    for (int l = 0; l < mc::kWarp; ++l) out[l] = x.v[l];
  }
}
// A run of n paths from path_offset as the kernels' warps walk it (every
// lane of the last warp runs; the first n are kept), dimension `dim` of
// the (n_dims, 30) table: integers and normals.
void warp_run(const uint32_t* sv, uint32_t k0, uint32_t k1, uint32_t dim,
              uint32_t path_offset, long n, uint32_t* x, float* z) {
  const uint32_t* row = sv + (size_t)dim * mc::kSobolBits;
  const uint32_t key = mc::sobol_key(k0, k1, dim);
  for (long w = 0; w * mc::kWarp < n; ++w) {
    const uint32_t base = path_offset + (uint32_t)(w * mc::kWarp);
    const mc::HostWarp::Val v = mc::warp_sobol_bits(mc::HostWarp(base), row);
    for (int l = 0; l < mc::kWarp && w * mc::kWarp + l < n; ++l) {
      x[w * mc::kWarp + l] = v.v[l];
      z[w * mc::kWarp + l] = mc::shifted_normal(v.v[l], key);
    }
  }
}
// rng.cuh's per-path forms at the same ids.
void path_run(const uint32_t* sv, uint32_t k0, uint32_t k1, uint32_t dim,
              uint32_t path_offset, long n, uint32_t* x, float* z) {
  for (long i = 0; i < n; ++i) {
    const uint32_t id = path_offset + (uint32_t)i;
    x[i] = mc::sobol_bits(sv + (size_t)dim * mc::kSobolBits, id);
    z[i] = mc::sobol_normal(sv, k0, k1, id, dim);
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build sobol_warp.cuh for the host")
    d = tmp_path_factory.mktemp("sobol_warp")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def table():
    """Three LMS-scrambled dimensions, as the device samplers build them."""
    return np.ascontiguousarray(
        jsobol.lms_scramble(jsobol.direction_numbers(3), 7), np.uint32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _warp(lib, row, base, skip=-1):
    out = np.empty(WARP, np.uint32)
    lib.warp_bits(_ptr(row), ctypes.c_uint32(base), ctypes.c_int(skip),
                  _ptr(out))
    return out


def _run(lib, fn, sv, dim, off, n):
    x, z = np.empty(n, np.uint32), np.empty(n, np.float32)
    getattr(lib, fn)(_ptr(sv), ctypes.c_uint32(K0), ctypes.c_uint32(K1),
                     ctypes.c_uint32(dim), ctypes.c_uint32(off),
                     ctypes.c_long(n), _ptr(x), _ptr(z))
    return x, z


@pytest.mark.parametrize("base", BASES)
def test_warp_walk_equals_the_per_path_walk_and_jax(lib, table, base):
    """Every lane's integer equals rng.cuh's ``sobol_bits`` and JAX's at its
    id (mod 2^32), in each dimension."""
    ids = ((base + np.arange(WARP, dtype=np.uint64)) % 2**32).astype(
        np.uint32)
    for d in range(table.shape[0]):
        row = np.ascontiguousarray(table[d])
        got = _warp(lib, row, base)
        want_jax = np.asarray(jsobol.sobol_bits(jnp.asarray(row),
                                                jnp.asarray(ids)))
        np.testing.assert_array_equal(got, want_jax)
        per_path, _ = _run(lib, "path_run", table, d, base, WARP)
        np.testing.assert_array_equal(got, per_path)


@pytest.mark.parametrize("off,n", [(0, 1000), (2**32 - 40, 1000),
                                   ((2**18) * 5, 2**12 - 37),
                                   (2**30 - 1000, 2**11 + 5)])
def test_warp_run_normals_equal_the_per_path_normals_and_jax(lib, table, off,
                                                             n):
    """A run of n paths (not a multiple of 32: a partial last warp) as the
    kernels' warps walk it: integers and normals bitwise the per-path
    header's, integers bitwise and normals within 1e-6 of JAX's; the run
    at 2^32 - 40 wraps inside a warp."""
    ids = ((off + np.arange(n, dtype=np.uint64)) % 2**32).astype(np.uint32)
    for d in range(table.shape[0]):
        x, z = _run(lib, "warp_run", table, d, off, n)
        px, pz = _run(lib, "path_run", table, d, off, n)
        np.testing.assert_array_equal(x, px)
        np.testing.assert_array_equal(z, pz)
        np.testing.assert_array_equal(x, np.asarray(jsobol.sobol_bits(
            jnp.asarray(table[d]), jnp.asarray(ids))))
        key = threefry2x32(jnp.uint32(K0), jnp.uint32(K1), jnp.uint32(d),
                           jnp.uint32(0x50B0))[0]
        want = np.asarray(jsobol._shifted_normal(
            jnp.asarray(x), jnp.full(n, key, jnp.uint32), jnp.float32))
        np.testing.assert_allclose(z, want, rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("skip", [1, 8, 31])
def test_a_scan_that_misses_a_delta_changes_bits(lib, table, skip):
    """Dropping one lane's delta from the scan changes that lane's integer
    and every later lane's: the comparisons above would catch it."""
    row = np.ascontiguousarray(table[1])
    base = (2**18) * 7 + 5
    good, bad = _warp(lib, row, base), _warp(lib, row, base, skip)
    np.testing.assert_array_equal(good[:skip], bad[:skip])
    assert (good[skip:] != bad[skip:]).all()
