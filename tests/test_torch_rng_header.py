"""The K0 device header (montecarlo_tpu_torch/csrc/rng.cuh), built for the
host with g++, against the JAX package.

The header's functions are ``__host__ __device__``, so the same text the
CUDA kernels inline compiles here as plain C++ and a cipher or constant
typo shows up without a card.  Threefry words, uniforms and exp32 must
match bitwise (integer and IEEE-exact float32 arithmetic; built with
-ffp-contract=off, as the device build uses -fmad=false).  Skips when no
C++ compiler is present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo_tpu.rng import normal as jnormal
from montecarlo_tpu.rng import threefry as jthreefry

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

_SHIM = r"""
#include "rng.cuh"
extern "C" {
void host_threefry(uint32_t k0, uint32_t k1, const uint32_t* c0,
                   const uint32_t* c1, uint32_t* o0, uint32_t* o1, long n) {
  for (long i = 0; i < n; ++i) mc::threefry2x32(k0, k1, c0[i], c1[i],
                                                &o0[i], &o1[i]);
}
void host_uniform(const uint32_t* b, float* u, long n) {
  for (long i = 0; i < n; ++i) u[i] = mc::uniform_from_bits(b[i]);
}
void host_exp32(const float* x, float* y, long n) {
  for (long i = 0; i < n; ++i) y[i] = mc::exp32(x[i]);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build rng.cuh for the host")
    d = tmp_path_factory.mktemp("rng_header")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_header_threefry_matches_jax(lib):
    r = np.random.default_rng(0)
    n = 1 << 14
    k = r.integers(0, 2**32, 2, dtype=np.uint32)
    c0 = r.integers(0, 2**32, n, dtype=np.uint32)
    c1 = r.integers(0, 2**32, n, dtype=np.uint32)
    o0, o1 = np.empty_like(c0), np.empty_like(c1)
    lib.host_threefry(ctypes.c_uint32(int(k[0])), ctypes.c_uint32(int(k[1])),
                      _ptr(c0), _ptr(c1), _ptr(o0), _ptr(o1),
                      ctypes.c_long(n))
    j0, j1 = jthreefry.threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                    c0, c1)
    np.testing.assert_array_equal(o0, np.asarray(j0))
    np.testing.assert_array_equal(o1, np.asarray(j1))
    # Random123 known answer: key (0, 0), counter (0, 0).
    z = np.zeros(1, np.uint32)
    a, b = np.empty_like(z), np.empty_like(z)
    lib.host_threefry(ctypes.c_uint32(0), ctypes.c_uint32(0), _ptr(z),
                      _ptr(z), _ptr(a), _ptr(b), ctypes.c_long(1))
    assert (int(a[0]), int(b[0])) == (0x6B200159, 0x99BA4EFE)


def test_header_uniform_and_exp32_match_jax(lib):
    r = np.random.default_rng(1)
    n = 1 << 14
    bits = r.integers(0, 2**32, n, dtype=np.uint32)
    u = np.empty(n, np.float32)
    lib.host_uniform(_ptr(bits), _ptr(u), ctypes.c_long(n))
    np.testing.assert_array_equal(
        u, np.asarray(jnormal.uniform_from_bits(jnp.asarray(bits))))
    x = r.uniform(-25, 25, n).astype(np.float32)
    y = np.empty(n, np.float32)
    lib.host_exp32(_ptr(x), _ptr(y), ctypes.c_long(n))
    np.testing.assert_array_equal(y, np.asarray(jnormal.exp32(
        jnp.asarray(x))))
