"""K6's shared-memory ring (``csrc/rbergomi_ring.cuh``), built for the host
with g++ and walked warp by warp, lane by lane, in the kernel's loop order;
the wrapper's choice between the ring form and the plain-load form.

The shim runs every lane of each warp through the header's
``LaneCopies``, ``issue_stage`` and ``consume_stage``, the text the ring
kernel runs, in the order ``csrc/rbergomi_kernel.cu`` gives them: stages 0
.. S-2 issued and committed; then per stage, every lane's
``cp.async.wait_group S-2``, the warp barrier, and every lane's issue of
stage j + S - 1 and its steps of stage j, untested in a full stage; then
the tail stage's wait, barrier and tested steps.  The joint matrix holds each
entry's own index, so a read shows which (row, path) it got.  A copy lands
at the wait that retires its group (the latest it can: a read before its
wait sees an empty or stale slot) or at its issue (the earliest: a copy
into a slot still to be read overwrites it).  Each check is exact:
every (row, path) of the matrix is copied once, as a 16-byte chunk inside
the matrix, and read exactly once, by its own path's lane, in step order.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from montecarlo_tpu_torch.ops.rbergomi_kernel import ring_aligned

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

_SHIM = r"""
#include <deque>
#include <utility>
#include <vector>

#include "rbergomi_ring.cuh"

namespace ring = mc::ring;
using Copy = std::pair<int, int64_t>;

extern "C" {
void ring_shape(int* stage_steps, int* stages) {
  *stage_steps = ring::kStageSteps;
  *stages = ring::kStages;
}

// Walks the n_paths (a multiple of 4) paths' warps over T steps; pending
// is the wait's count (the kernel's S - 2).  reads (n_paths, 2T) counts
// each step's reads of (row, path); copies counts (row, path) copies.
// Returns 0, or 1 a read saw another entry than its own, 2 a copy outside
// the matrix or the ring, 3 a step out of order, 4 a lane short of T.
int ring_walk(int T, int64_t n_paths, int late, int pending, int* reads,
              int* copies) {
  int err = 0;
  for (int64_t base = 0; base < n_paths; base += ring::kWarp) {
    std::vector<int64_t> rg(ring::kWarpFloats, -1);
    std::vector<ring::LaneCopies> lanes;
    std::vector<std::deque<std::vector<Copy>>> groups(ring::kWarp);
    std::vector<int> next(ring::kWarp, 0);
    for (int l = 0; l < ring::kWarp; ++l)
      lanes.emplace_back(T, n_paths, base, l);
    auto land = [&](const Copy& c) {
      for (int e = 0; e < ring::kChunk; ++e) rg[c.first + e] = c.second + e;
    };
    auto issue = [&](int l, int j) {
      std::vector<Copy> group;
      ring::issue_stage(lanes[l], T, j, [&](int dst, int64_t src) {
        const int64_t row = src / n_paths, path = src % n_paths;
        if (row >= 2 * T || path % ring::kChunk || path + ring::kChunk > n_paths
            || dst % ring::kChunk || dst < 0
            || dst + ring::kChunk > ring::kWarpFloats) {
          err = err ? err : 2;
          return;
        }
        for (int e = 0; e < ring::kChunk; ++e) copies[src + e] += 1;
        if (late) group.push_back({dst, src}); else land({dst, src});
      });
      groups[l].push_back(group);  // cp.async.commit_group
    };
    auto wait = [&](int l) {
      while ((int)groups[l].size() > pending) {
        for (const Copy& c : groups[l].front()) land(c);
        groups[l].pop_front();
      }
    };
    for (int j = 0; j < ring::kStages - 1; ++j)
      for (int l = 0; l < ring::kWarp; ++l) issue(l, j);
    auto pair_of = [&](int l) {
      return [&, l](int t, int w, int dw, bool second) {
        const int64_t i = base + l;
        for (int h = 0; h < (second ? 2 : 1); ++h) {
          const int s = t + h;
          if (i >= n_paths) continue;  // a lane past N: its result is dropped
          if (s != next[l]) err = err ? err : 3;
          next[l] = s + 1;
          const int64_t wi = (int64_t)s * n_paths + i;
          const int64_t di = (int64_t)(T + s) * n_paths + i;
          if (rg[w + h * ring::kWarp] != wi || rg[dw + h * ring::kWarp] != di)
            err = err ? err : 1;
          reads[wi] += 1;
          reads[di] += 1;
        }
      };
    };
    const int n_full = ring::full_stages(T);
    for (int j = 0; j < n_full; ++j) {
      for (int l = 0; l < ring::kWarp; ++l) wait(l);
      // __syncwarp()
      for (int l = 0; l < ring::kWarp; ++l) {
        issue(l, j + ring::kStages - 1);
        ring::consume_stage<true>(T, j, l, pair_of(l));
      }
    }
    if (n_full * ring::kStageSteps < T) {
      for (int l = 0; l < ring::kWarp; ++l) wait(l);
      // __syncwarp()
      for (int l = 0; l < ring::kWarp; ++l)
        ring::consume_stage<false>(T, n_full, l, pair_of(l));
    }
    for (int l = 0; l < ring::kWarp; ++l)
      if (base + l < n_paths && next[l] != T) err = err ? err : 4;
  }
  return err;
}
}
"""

STEPS = list(range(1, 66)) + [252, 300]
PATHS = [4, 44, 96]  # one partial warp; a ragged last warp of 12; three whole


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build rbergomi_ring.cuh for the host")
    d = tmp_path_factory.mktemp("rbergomi_ring")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(so), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.ring_walk.restype = ctypes.c_int
    lib.ring_walk.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _shape(lib):
    """(K, S): the steps of a stage and the slots of a ring."""
    k, s = ctypes.c_int(), ctypes.c_int()
    lib.ring_shape(ctypes.byref(k), ctypes.byref(s))
    return k.value, s.value


def _walk(lib, n_steps, n_paths, late, pending=None):
    """(error code, reads, copies) of one walk; ``pending`` defaults to
    the kernel's S - 2."""
    reads = np.zeros((2 * n_steps, n_paths), np.int32)
    copies = np.zeros_like(reads)
    if pending is None:
        pending = _shape(lib)[1] - 2
    err = lib.ring_walk(n_steps, n_paths, int(late), pending,
                        reads.ctypes.data, copies.ctypes.data)
    return err, reads, copies


@pytest.mark.parametrize("n_steps", STEPS)
def test_ring_reads_every_entry_once_in_step_order(lib, n_steps):
    """Every (row, path) copied once and read once, by its path, in step
    order, whether a copy lands at its wait or at its issue; the tail
    stage (T not a multiple of K) and an odd T's last half pair
    included."""
    for n_paths in PATHS:
        for late in (True, False):
            err, reads, copies = _walk(lib, n_steps, n_paths, late)
            assert err == 0, (n_paths, late, err)
            np.testing.assert_array_equal(copies, 1)
            np.testing.assert_array_equal(reads, 1)


def test_ring_walk_catches_a_wait_that_retires_too_little(lib):
    """Waiting with one group too many pending reads a stage before it
    lands (when the copies land at their wait), which the walk reports:
    the check can fail."""
    k, s = _shape(lib)
    n_steps = 4 * k * s
    err, *_ = _walk(lib, n_steps, 44, True, pending=s - 1)
    assert err == 1
    err, *_ = _walk(lib, n_steps, 44, False, pending=s - 1)
    assert err == 0  # copies that land at once hide it: the late walk is needed


@pytest.mark.parametrize("n_paths,ptr,ring", [
    (1 << 20, 0x7F0000000000, True), (100000, 0x7F0000000100, True),
    (4, 16, True), ((1 << 20) - 3, 0x7F0000000000, False),
    (1001, 0, False), (4096, 0x7F0000000004, False),
    (4096, 0x7F0000000008, False)])
def test_ring_form_needs_16_byte_rows(n_paths, ptr, ring):
    assert ring_aligned(n_paths, ptr) is ring
