"""K7's block schedule (montecarlo_tpu_torch/csrc/basket_tile.cuh), built
for the host with g++, against K7's plain version.

The shim below walks a K7 launch in order: block by block, it stages the
constants, then per step pair fills the block's draws through the header's
``fill_pair``, runs every thread's ``step_pair`` (the register-tiled
triangular correlation and the update), and at the end every thread's
``stage_weighted`` and one ``path_sum`` per path.  The normals are handed
in from torch: ``boxmuller_pair(threefry2x32(...))`` of the port at the
kernel's counters (id, a * n_pairs + j), so the host libm's sin, cos and
log never enter.  The result must equal
``packed_basket_terminal_reference`` bitwise: this is where the kernel's
order of operations is held without a card.  Built with -ffp-contract=off,
as the device build uses -fmad=false.  Skips when no C++ compiler is
present.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlo_tpu_torch.bench import bench_basket
from montecarlo_tpu_torch.engine.simulate import path_ids_for
from montecarlo_tpu_torch.ops.basket_kernel import (
    _constants, packed_basket_terminal_reference)
from montecarlo_tpu_torch.rng.normal import boxmuller_pair
from montecarlo_tpu_torch.rng.threefry import (MASK32, key_from_seed,
                                               threefry2x32)

CSRC = Path(__file__).resolve().parent.parent / "montecarlo_tpu_torch" / "csrc"

_SHIM = r"""
#include <stdint.h>
#include <vector>
#include "basket_tile.cuh"

namespace {

// Normals (n_pairs, n_paths, A) from torch; zeros for the masked paths of
// the last block, as any value would do there.
struct GivenPair {
  const float* z0;
  const float* z1;
  int64_t base, n_paths;
  int A, j;
  template <int U>
  void batch(int p, int a, int da, float* o0, float* o1, int dz) const {
    const int64_t i = base + p;
    for (int u = 0; u < U; ++u) {
      const int64_t k = ((int64_t)j * n_paths + i) * A + a + u * da;
      o0[u * dz] = i < n_paths ? z0[k] : 0.0f;
      o1[u * dz] = i < n_paths ? z1[k] : 0.0f;
    }
  }
};

template <class Tr>
struct ThreadState {
  float log_s[2][Tr::M][k7::kTile];
};

template <class Tr>
void run(float* out, const float* params, const float* chol, int A,
         int64_t n_paths, int n_steps, const float* z0, const float* z1) {
  std::vector<float> smem(k7::smem_floats(A, Tr::P));
  std::vector<ThreadState<Tr>> th(k7::kThreads);
  std::vector<k7::Owned> own(k7::kThreads);
  const int n_pairs = (n_steps + 1) / 2;
  for (int64_t base = 0; base < n_paths; base += Tr::P) {
    const k7::Smem s = k7::carve(smem.data(), A, Tr::P);
    k7::stage_constants(s, A, Tr::P, params, chol, 0, 1);
    for (int t = 0; t < k7::kThreads; ++t) {
      own[t] = k7::owned<Tr>(t, A);
      k7::init_log_s<Tr>(own[t], A, params, th[t].log_s);
    }
    for (int j = 0; j < n_pairs; ++j) {
      for (int t = 0; t < k7::kThreads; ++t) {
        k7::fill_pair<Tr::U>(s, A, Tr::P, t, k7::kThreads,
                             GivenPair{z0, z1, base, n_paths, A, j});
      }
      for (int t = 0; t < k7::kThreads; ++t) {
        k7::step_pair<Tr>(s, own[t], 2 * j + 1 < n_steps, th[t].log_s);
      }
    }
    for (int t = 0; t < k7::kThreads; ++t) {
      k7::stage_weighted<Tr>(s, own[t], A, th[t].log_s);
    }
    for (int p = 0; p < Tr::P && base + p < n_paths; ++p) {
      out[base + p] = k7::path_sum(s, Tr::P, p, A);
    }
  }
}

template <int U>
void lanes(uint32_t k0, uint32_t k1, const uint32_t* c0, const uint32_t* c1,
           uint32_t* o0, uint32_t* o1, long n) {
  for (long i = 0; i + U <= n; i += U) {
    mc::threefry2x32_lanes<U>(k0, k1, c0 + i, c1 + i, o0 + i, o1 + i);
  }
}

template <class Tr>
void owned_all(int A, int* out) {
  for (int t = 0; t < k7::kThreads; ++t) {
    const k7::Owned o = k7::owned<Tr>(t, A);
    out[3 * t] = o.p0;
    out[3 * t + 1] = o.tile[0];
    out[3 * t + 2] = o.tile[1];
  }
}

}  // namespace

extern "C" {
void host_threefry_lanes(int u, uint32_t k0, uint32_t k1, const uint32_t* c0,
                         const uint32_t* c1, uint32_t* o0, uint32_t* o1,
                         long n) {
  switch (u) {
    case 1: lanes<1>(k0, k1, c0, c1, o0, o1, n); break;
    case 2: lanes<2>(k0, k1, c0, c1, o0, o1, n); break;
    case 4: lanes<4>(k0, k1, c0, c1, o0, o1, n); break;
    default: lanes<8>(k0, k1, c0, c1, o0, o1, n); break;
  }
}
int host_k7_paths_per_block(int A) {
  switch (k7::tier_of(A)) {
    case 0: return k7::Tier16::P;
    case 1: return k7::Tier32::P;
    case 2: return k7::Tier64::P;
    default: return k7::Tier128::P;
  }
}
int host_k7_paths_per_thread(int A) {
  switch (k7::tier_of(A)) {
    case 0: return k7::Tier16::M;
    case 1: return k7::Tier32::M;
    case 2: return k7::Tier64::M;
    default: return k7::Tier128::M;
  }
}
void host_k7_owned(int A, int* out) {
  switch (k7::tier_of(A)) {
    case 0: owned_all<k7::Tier16>(A, out); break;
    case 1: owned_all<k7::Tier32>(A, out); break;
    case 2: owned_all<k7::Tier64>(A, out); break;
    default: owned_all<k7::Tier128>(A, out); break;
  }
}
void host_k7(float* out, const float* params, const float* chol, int A,
             int64_t n_paths, int n_steps, const float* z0, const float* z1) {
  switch (k7::tier_of(A)) {
    case 0: run<k7::Tier16>(out, params, chol, A, n_paths, n_steps, z0, z1);
            break;
    case 1: run<k7::Tier32>(out, params, chol, A, n_paths, n_steps, z0, z1);
            break;
    case 2: run<k7::Tier64>(out, params, chol, A, n_paths, n_steps, z0, z1);
            break;
    default: run<k7::Tier128>(out, params, chol, A, n_paths, n_steps, z0,
                              z1);
  }
}
}
"""

ASSETS = [1, 2, 5, 8, 16, 20, 33, 64, 127, 128]
# One path offset per step count; at 7 steps the ids wrap past 2^32.
OFFSETS = {1: 0, 7: 2**32 - 150, 8: 12345}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build basket_tile.cuh for the host")
    d = tmp_path_factory.mktemp("basket_tile")
    src, so = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17",
                    "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True)
    so_lib = ctypes.CDLL(str(so))
    so_lib.host_k7.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    so_lib.host_k7_owned.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return so_lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _normals(basket, n, n_steps, seed, path_offset):
    """(n_pairs, n, A) Box-Muller halves at K7's counters (id, a*n_pairs+j),
    from the port's torch functions."""
    k0, k1 = key_from_seed(seed)
    ids = path_ids_for(n, path_offset, torch.device("cpu"))[:, None]
    asset = torch.arange(basket.n_assets, dtype=torch.int64)[None, :]
    n_pairs = (n_steps + 1) // 2
    pairs = [boxmuller_pair(*threefry2x32(
        k0, k1, ids, (asset * n_pairs + j) & MASK32)) for j in range(n_pairs)]
    return (torch.stack([z0 for z0, _ in pairs]).contiguous(),
            torch.stack([z1 for _, z1 in pairs]).contiguous())


@pytest.mark.parametrize("n_steps", [1, 7, 8])
@pytest.mark.parametrize("a_n", ASSETS)
def test_tile_schedule_bitwise_equal_plain(lib, a_n, n_steps):
    basket = bench_basket(a_n, device="cpu")
    per_block = lib.host_k7_paths_per_block(a_n)
    n = 2 * per_block + 17  # a ragged last block
    seed, offset = 29, OFFSETS[n_steps]
    z0, z1 = _normals(basket, n, n_steps, seed, offset)
    params = _constants(basket).contiguous()
    chol = basket.chol_flat.contiguous()
    got = torch.full((n,), float("nan"), dtype=torch.float32)
    lib.host_k7(_ptr(got), _ptr(params), _ptr(chol), a_n, n, n_steps,
                _ptr(z0), _ptr(z1))
    want = packed_basket_terminal_reference(basket, n, n_steps, seed=seed,
                                            path_offset=offset)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_threefry_lanes_match_the_port(lib, lanes):
    """The lock-step cipher the kernel's fill uses gives the words of
    ``rng.threefry.threefry2x32`` on every counter."""
    r = np.random.default_rng(lanes)
    n = 1 << 12
    k0, k1 = (int(v) for v in r.integers(0, 2**32, 2, dtype=np.uint64))
    c0 = r.integers(0, 2**32, n, dtype=np.uint32)
    c1 = r.integers(0, 2**32, n, dtype=np.uint32)
    o0, o1 = np.empty_like(c0), np.empty_like(c1)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    lib.host_threefry_lanes(lanes, ctypes.c_uint32(k0), ctypes.c_uint32(k1),
                            p(c0), p(c1), p(o0), p(o1), ctypes.c_long(n))
    w0, w1 = threefry2x32(k0, k1, torch.from_numpy(c0.astype(np.int64)),
                          torch.from_numpy(c1.astype(np.int64)))
    np.testing.assert_array_equal(o0.astype(np.int64), w0.numpy())
    np.testing.assert_array_equal(o1.astype(np.int64), w1.numpy())


@pytest.mark.parametrize("tier_assets", [(1, 16), (17, 32), (33, 64),
                                         (65, 128)])
def test_tile_dealing_covers_every_path_and_asset_once(lib, tier_assets):
    """Each (path, tile) of a block has exactly one owner, the 32 lanes of a
    warp share their tiles, and a warp's two tiles t and T-1-t sum 8(T+1)
    columns of L, the whole pair's triangle (the middle tile of an odd T,
    alone, half of it)."""
    for a_n in range(tier_assets[0], tier_assets[1] + 1):
        own = np.zeros(3 * 256, np.int32)
        lib.host_k7_owned(a_n, own.ctypes.data_as(ctypes.c_void_p))
        own = own.reshape(256, 3)
        per_block = lib.host_k7_paths_per_block(a_n)
        m = lib.host_k7_paths_per_thread(a_n)
        n_t = (a_n + 7) // 8
        count = np.zeros((per_block, n_t), np.int32)
        work = {}
        for tid, (p0, t0, t1) in enumerate(own):
            tiles = [t for t in (t0, t1) if t >= 0]
            for t in tiles:
                count[p0:p0 + m, t] += 1
            if tiles:
                work[tid // 32] = sum(8 * (t + 1) for t in tiles)
            # the 32 lanes of a warp share their tiles
            assert tuple(own[tid // 32 * 32, 1:]) == (t0, t1)
        assert (count == 1).all(), a_n
        pair = 8 * (n_t + 1)
        assert sorted(set(work.values())) in ([pair], [pair // 2, pair],
                                              [pair // 2]), a_n


@pytest.mark.parametrize("cut", ["full", "no cipher", "no correlation",
                                 "neither"])
def test_k7_split_cuts_find_their_text(cut):
    """tools/k7_split.py cuts a copy of basket_kernel.cu's text: each cut
    finds what it replaces exactly once, and the copy loses just that."""
    import importlib.util

    path = CSRC.parent.parent / "tools" / "k7_split.py"
    spec = importlib.util.spec_from_file_location("k7_split", path)
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    src = (CSRC / "basket_kernel.cu").read_text()
    out = split.cut_source(src, split.CUTS[cut])
    cuts = split.CUTS[cut]
    assert (split.CIPHER in out) == ("cipher" not in cuts)
    assert (split.CORRELATION in out) == ("correlation" not in cuts)
    assert (split.NO_CIPHER in out) == ("cipher" in cuts)
    with pytest.raises(RuntimeError):
        split.cut_source(src.replace(split.CORRELATION, ""), ("correlation",))
