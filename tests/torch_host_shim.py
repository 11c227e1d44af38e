"""Shared parts of the tests that build a ``csrc`` header for the host with
g++ (-ffp-contract=off, as the card's -fmad=false) and walk it against a
plain PyTorch version: the C++ prelude that takes each ``sqrtf`` and
``logf`` from a table of torch's own values, the recorder that makes the
tables, and the build.

Torch's float32 ``sqrt`` on the CPU is not the IEEE root for about 0.6% of
arguments (and the host's ``logf`` is not torch's ``log``), so a walk that
must be bitwise the plain version reads every root and log the plain
version took, looked up by the argument's bits: NaN for an argument the
plain version never took, or the host's own value once
``host_set_fallback(1)`` (a deliberately changed form takes arguments the
plain version never did).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

#: Put before the header's #include: sqrtf and logf become table reads.
TABLE_PRELUDE = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <utility>
#include <vector>

static std::vector<std::pair<uint32_t, float>> g_roots, g_logs;
static bool g_fallback = false;
static float given(const std::vector<std::pair<uint32_t, float>>& table,
                   float x, float (*host)(float)) {
  uint32_t k;
  memcpy(&k, &x, sizeof k);
  auto it = std::lower_bound(table.begin(), table.end(),
                             std::make_pair(k, -INFINITY));
  if (it != table.end() && it->first == k) return it->second;
  return g_fallback ? host(x) : NAN;
}
static float given_sqrtf(float x) { return given(g_roots, x, ::sqrtf); }
static float given_logf(float x) { return given(g_logs, x, ::logf); }
static void set_table(std::vector<std::pair<uint32_t, float>>* table,
                      const uint32_t* keys, const float* values, long n) {
  table->clear();
  for (long i = 0; i < n; ++i) table->emplace_back(keys[i], values[i]);
  std::sort(table->begin(), table->end());
}
extern "C" void host_set_tables(const uint32_t* rk, const float* rv, long nr,
                                const uint32_t* lk, const float* lv,
                                long nl) {
  set_table(&g_roots, rk, rv, nr);
  set_table(&g_logs, lk, lv, nl);
}
extern "C" void host_set_fallback(int on) { g_fallback = on != 0; }
#define sqrtf given_sqrtf
#define logf given_logf
"""


def build(tmp_path_factory, name: str, source: str, opt: str = "-O2"):
    """``source`` compiled into a shared library and loaded; skips the
    test when the host has no C++ compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip(f"no C++ compiler to build {name} for the host")
    d = tmp_path_factory.mktemp(name)
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(source)
    subprocess.run([cxx, opt, "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", f"-I{CSRC}", "-o", str(so), str(src)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def recorded(fn, *args, **kw):
    """``fn(*args, **kw)`` and, for torch.sqrt and torch.log, the
    (argument bits, value) pairs of every call it made, as the four arrays
    ``host_set_tables`` takes."""
    seen = {"sqrt": [], "log": []}
    saved = {k: getattr(torch, k) for k in seen}

    def recording(name):
        def call(x, *a, **k):
            y = saved[name](x, *a, **k)
            seen[name].append((x.detach().reshape(-1),
                               y.detach().reshape(-1)))
            return y
        return call

    for k in seen:
        setattr(torch, k, recording(k))
    try:
        out = fn(*args, **kw)
    finally:
        for k, f in saved.items():
            setattr(torch, k, f)
    tables = []
    for k in ("sqrt", "log"):
        xs = torch.cat([x for x, _ in seen[k]] or [torch.zeros(0)])
        ys = torch.cat([y for _, y in seen[k]] or [torch.zeros(0)])
        tables += [np.ascontiguousarray(xs.numpy().view(np.uint32)),
                   np.ascontiguousarray(ys.numpy(), np.float32)]
    return out, tables


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def set_tables(lib, tables) -> None:
    """Hand ``recorded``'s tables to a library built on TABLE_PRELUDE."""
    rk, rv, lk, lv = tables
    lib.host_set_tables(ptr(rk), ptr(rv), ctypes.c_long(rk.size), ptr(lk),
                        ptr(lv), ctypes.c_long(lk.size))
