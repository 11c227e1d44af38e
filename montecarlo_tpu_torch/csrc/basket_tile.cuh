// K7's block schedule: where a block keeps its draws and its Cholesky
// factor, which thread owns which paths and assets, the register-tiled
// triangular correlation, the update and the in-order basket sum.
//
// Written as __host__ __device__ functions so that the same text runs in
// csrc/basket_kernel.cu (nvcc, sm_90a) and in a host shim built with g++,
// where tests/test_torch_basket_tile.py walks a kernel's blocks, threads
// and step pairs in order and holds the result bitwise against
// ops/basket_kernel.py::packed_basket_terminal_reference.
//
// A block holds P paths x all A assets.  Assets come in tiles of kTile = 8;
// a thread owns M paths x the assets of at most two tiles, t and T-1-t,
// whose triangles sum to the same work (tile t sums 8(t+1) columns of L).
// The 8 warps of a block split into G = 8 / S groups of 32 M paths; the S
// warps of a group take the tile pairs 0..S-1, so the 32 lanes of a warp
// walk one tile pair with one loop bound.  Per step pair the block's P*A
// normals sit in shared memory as z0[b][p] and z1[b][p], and L is packed by
// tile, row b of tile t holding L[8t..8t+8)[b] (its triangle only).  Per
// column b a thread loads its M paths' z0 and z1 and the tile's 8 entries
// of L, and adds the 2 x M x 8 products: 2M + 8 shared words for 32M float
// operations.
//
// The sums keep the plain version's terms and order exactly: zc_a starts at
// L[a,0] z_0 and adds L[a,b] z_b for b = 1..a in ascending order; on a
// tile's diagonal block the term b = 8t + k goes to its assets j >= k only,
// a compile-time choice after unrolling.  Every multiply and add rounds on
// its own (nvcc -fmad=false, g++ -ffp-contract=off).
#pragma once

#include <stddef.h>
#include <stdint.h>

#include "rng.cuh"

namespace k7 {

constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;        // assets per tile
constexpr int kMaxAssets = 128;  // processes/basket.py MAX_ASSETS

// M paths per thread; S tile slots (warps w and w' share their paths iff
// w / S == w' / S).  A slot holds one tile pair, so a tier takes up to 2S
// tiles.  U ciphers per thread in flight during the fill; B blocks per SM
// asked of the register allocator.  U and B were chosen by timing on an
// H100 (PERF.md); they change no result.
template <int M_, int S_, int U_, int B_>
struct Tier {
  static constexpr int M = M_;
  static constexpr int S = S_;
  static constexpr int U = U_;
  static constexpr int kBlocksPerSM = B_;
  static constexpr int G = kWarps / S;
  static constexpr int P = 32 * M * G;  // paths per block
  static constexpr int kMaxAssetsOfTier = 2 * S * kTile;
};
using Tier16 = Tier<1, 1, 4, 3>;   // A <= 16: P = 256
using Tier32 = Tier<2, 2, 4, 2>;   // A <= 32: P = 256
using Tier64 = Tier<2, 4, 8, 2>;   // A <= 64: P = 128
using Tier128 = Tier<2, 8, 8, 2>;  // A <= 128: P = 64

MC_HD int tier_of(int n_assets) {
  return n_assets <= 16 ? 0 : n_assets <= 32 ? 1 : n_assets <= 64 ? 2 : 3;
}

MC_HD int n_tiles(int n_assets) { return (n_assets + kTile - 1) / kTile; }

// Where tile t's rows start in the packed factor: 64 (0 + 1 + ... + t).
MC_HD int packed_offset(int t) { return 32 * t * (t + 1); }

// The block's shared memory, in floats from one base.
struct Smem {
  float* z0;     // [Apad][P]; after the loop, the weighted terminal values
  float* z1;     // [Apad][P]
  float* lt;     // packed_offset(T) floats
  float* drift;  // [Apad]
  float* scale;  // [Apad]
  float* w;      // [Apad]
};

MC_HD size_t smem_floats(int n_assets, int paths) {
  const int t = n_tiles(n_assets), apad = t * kTile;
  return (size_t)2 * apad * paths + packed_offset(t) + 3 * (size_t)apad;
}

MC_HD Smem carve(float* base, int n_assets, int paths) {
  const int t = n_tiles(n_assets), apad = t * kTile;
  Smem s;
  s.z0 = base;
  s.z1 = s.z0 + apad * paths;
  s.lt = s.z1 + apad * paths;
  s.drift = s.lt + packed_offset(t);
  s.scale = s.drift + apad;
  s.w = s.scale + apad;
  return s;
}

// Shared constants, by threads tid = 0..n-1 of the block: the packed factor
// (0 for assets and columns past A), drift, scale and weights (0 past A),
// and zero draws in the padding rows A..Apad-1, which only assets past A
// read.  params (4, A): drift, scale, log32(s0), weights; chol (A, A)
// row-major lower-triangular.
MC_HD void stage_constants(const Smem& s, int n_assets, int paths,
                           const float* params, const float* chol, int tid,
                           int n) {
  const int n_t = n_tiles(n_assets), apad = n_t * kTile;
  for (int t = 0; t < n_t; ++t) {
    float* lt = s.lt + packed_offset(t);
    for (int k = tid; k < kTile * kTile * (t + 1); k += n) {
      const int b = k / kTile, a = t * kTile + k % kTile;
      lt[k] = (a < n_assets && b < n_assets) ? chol[a * n_assets + b] : 0.0f;
    }
  }
  for (int a = tid; a < apad; a += n) {
    const bool real = a < n_assets;
    s.drift[a] = real ? params[a] : 0.0f;
    s.scale[a] = real ? params[n_assets + a] : 0.0f;
    s.w[a] = real ? params[3 * n_assets + a] : 0.0f;
  }
  for (int k = n_assets * paths + tid; k < apad * paths; k += n) {
    s.z0[k] = 0.0f;
    s.z1[k] = 0.0f;
  }
}

// One step pair's draws, by threads tid = 0..n-1, n a multiple of P:
// normal c = a * P + p (asset a of the block's path p) goes to z0[c],
// z1[c], so neighbouring threads write neighbouring words.  Thread tid
// keeps path p = tid % P and takes assets a = tid / P, + n / P, ..., U at a
// time: draw.batch<U>(p, a, da, z0, z1, dz) gives assets a, a + da, ...,
// a + (U-1) da into z0[u * dz], z1[u * dz], dz = da * P.
template <int U, class Draw>
MC_HD void fill_pair(const Smem& s, int n_assets, int paths, int tid, int n,
                     const Draw& draw) {
  const int p = tid % paths, da = n / paths;
  int a = tid / paths;
  for (; a + (U - 1) * da < n_assets; a += U * da) {
    draw.template batch<U>(p, a, da, s.z0 + a * paths + p,
                           s.z1 + a * paths + p, da * paths);
  }
  for (; a < n_assets; a += da) {
    draw.template batch<1>(p, a, da, s.z0 + a * paths + p,
                           s.z1 + a * paths + p, da * paths);
  }
}

// The paths and tiles of thread tid: paths p0..p0+M-1 of the block, tiles
// tile[0] and tile[1] (-1 where the slot has none).
struct Owned {
  int p0;
  int tile[2];
};

template <class Tr>
MC_HD Owned owned(int tid, int n_assets) {
  const int warp = tid / 32, lane = tid % 32;
  const int slot = warp % Tr::S, group = warp / Tr::S;
  const int last = n_tiles(n_assets) - 1;
  Owned o;
  o.p0 = (group * 32 + lane) * Tr::M;
  o.tile[0] = slot <= last - slot ? slot : -1;
  o.tile[1] = slot < last - slot ? last - slot : -1;
  return o;
}

template <int M>
MC_HD void load_paths(const float* row, float v[M]) {
#ifdef __CUDA_ARCH__
  if constexpr (M == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row);
    v[0] = x.x;
    v[1] = x.y;
    return;
  }
#endif
#pragma unroll
  for (int i = 0; i < M; ++i) v[i] = row[i];
}

MC_HD void load_tile(const float* row, float v[kTile]) {
#ifdef __CUDA_ARCH__
  const float4 x = reinterpret_cast<const float4*>(row)[0];
  const float4 y = reinterpret_cast<const float4*>(row)[1];
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
#else
  for (int j = 0; j < kTile; ++j) v[j] = row[j];
#endif
}

// zc0, zc1 of tile t's 8 assets on paths p0..p0+M-1: L[a,0] z_0, then
// + L[a,b] z_b for b = 1..a in ascending order.
template <int M>
MC_HD void correlate_tile(const Smem& s, int paths, int p0, int t,
                          float zc0[M][kTile], float zc1[M][kTile]) {
  const float* lt = s.lt + packed_offset(t);
  float l[kTile], x0[M], x1[M];
  load_tile(lt, l);
  load_paths<M>(s.z0 + p0, x0);
  load_paths<M>(s.z1 + p0, x1);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      zc0[i][j] = l[j] * x0[i];
      zc1[i][j] = l[j] * x1[i];
    }
  }
  const int a0 = t * kTile;
#pragma unroll 4
  for (int b = 1; b < a0; ++b) {  // columns left of the diagonal block
    load_tile(lt + b * kTile, l);
    load_paths<M>(s.z0 + b * paths + p0, x0);
    load_paths<M>(s.z1 + b * paths + p0, x1);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        zc0[i][j] = zc0[i][j] + l[j] * x0[i];
        zc1[i][j] = zc1[i][j] + l[j] * x1[i];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kTile; ++k) {  // the diagonal block: b = a0 + k
    if (k == 0 && t == 0) continue;  // column 0 began the sums
    const int b = a0 + k;
    load_tile(lt + b * kTile, l);
    load_paths<M>(s.z0 + b * paths + p0, x0);
    load_paths<M>(s.z1 + b * paths + p0, x1);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = k; j < kTile; ++j) {
        zc0[i][j] = zc0[i][j] + l[j] * x0[i];
        zc1[i][j] = zc1[i][j] + l[j] * x1[i];
      }
    }
  }
}

// The two steps of a pair on tile t's log prices:
//   log_s = (log_s + drift) + scale*zc0
//   log_s = (log_s + (live ? drift : 0)) + (live ? scale*zc1 : 0)
// live = 2j+1 < T: the odd final step adds an exact +0.0.
template <int M>
MC_HD void update_tile(const Smem& s, int t, bool live,
                       const float zc0[M][kTile], const float zc1[M][kTile],
                       float log_s[M][kTile]) {
  float d[kTile], c[kTile];
  load_tile(s.drift + t * kTile, d);
  load_tile(s.scale + t * kTile, c);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float x = (log_s[i][j] + d[j]) + c[j] * zc0[i][j];
      log_s[i][j] = (x + (live ? d[j] : 0.0f)) +
                    (live ? c[j] * zc1[i][j] : 0.0f);
    }
  }
}

// One step pair of thread `o`, after the block's draws are in place.
template <class Tr>
MC_HD void step_pair(const Smem& s, const Owned& o, bool live,
                     float log_s[2][Tr::M][kTile]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (o.tile[u] < 0) continue;
    float zc0[Tr::M][kTile], zc1[Tr::M][kTile];
    correlate_tile<Tr::M>(s, Tr::P, o.p0, o.tile[u], zc0, zc1);
    update_tile<Tr::M>(s, o.tile[u], live, zc0, zc1, log_s[u]);
  }
}

// log32(s0) of the thread's assets (0 past A) from params row 2.
template <class Tr>
MC_HD void init_log_s(const Owned& o, int n_assets, const float* params,
                      float log_s[2][Tr::M][kTile]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int a = o.tile[u] * kTile + j;
      const float v =
          (o.tile[u] >= 0 && a < n_assets) ? params[2 * n_assets + a] : 0.0f;
#pragma unroll
      for (int i = 0; i < Tr::M; ++i) log_s[u][i][j] = v;
    }
  }
}

// w_a exp32(log_s_a) of the thread's real assets into z0[a][p].
template <class Tr>
MC_HD void stage_weighted(const Smem& s, const Owned& o, int n_assets,
                          const float log_s[2][Tr::M][kTile]) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (o.tile[u] < 0) continue;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int a = o.tile[u] * kTile + j;
      if (a >= n_assets) continue;
#pragma unroll
      for (int i = 0; i < Tr::M; ++i) {
        s.z0[a * Tr::P + o.p0 + i] = s.w[a] * mc::exp32(log_s[u][i][j]);
      }
    }
  }
}

// The basket value of block path p: the weighted values summed over the
// assets in order, by one thread.
MC_HD float path_sum(const Smem& s, int paths, int p, int n_assets) {
  float v = s.z0[p];
  for (int a = 1; a < n_assets; ++a) v = v + s.z0[a * paths + p];
  return v;
}

}  // namespace k7
