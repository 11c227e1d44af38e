// The randomized Sobol normals of a warp's 32 consecutive points: the Sobol
// integer of every lane from one Gray-code walk the warp shares, and the
// Owen keys of the dimensions staged once per block.
//
// Replaces, inside the kernels' Sobol and bridge-Sobol draw sources
// (fused_engine.cuh: SobolDraws, BridgeDraws; the basket's Sobol stream),
// the per-path mc::sobol_normal of rng.cuh, which walks gray(id)'s
// set bits in a loop whose trip count differs from lane to lane and runs a
// whole Threefry call per normal for the Owen key.  Same bits: the integer
// is the XOR of the same words (XOR is order-free), the key the same
// Threefry word, and the uniform and ndtri32 are rng.cuh's.
//
// The walk.  A warp holds the ids base, base + 1, ..., base + 31 (mod
// 2^32).  Write x(id) for the XOR of row[k] over the set bits k < 30 of
// gray(id).  For m != 0, gray(m) ^ gray(m - 1) = 1 << ctz(m); at the wrap,
// gray(0) = 0 and gray(2^32 - 1) = 1 << 31, both 0 below bit 30.  So
//   x(base + l) = x(base) ^ d(base + 1) ^ ... ^ d(base + l),
//   d(m) = row[ctz(m)] if m != 0 and ctz(m) < 30, else 0.
// Lane k < 30 loads row[k] (one coalesced load per dimension; lanes 30
// and 31 hold 0); lane l >= 1 takes d(base + l) from lane ctz(base + l),
// or from lane 31 when that delta is 0; an inclusive XOR scan over the
// lanes (5 shuffles) sums the deltas, and an XOR butterfly (5 shuffles) of
// the words row[k] for the set bits k of gray(base) gives every lane
// x(base).
//
// The schedule (which word each lane takes, the scan's and the
// butterfly's order) is the template warp_sobol_bits over a warp W: on the
// card W is one lane and its shuffles (WarpLane), on the host all 32 lanes
// at once (HostWarp), so the tests walk the kernels' own text lane by
// lane with g++.
//
// The keys: sobol_key(k0, k1, dim) depends on the run's key and the
// dimension only.  The block stages the keys of the chunk of dimensions
// [c kKeyChunk, (c + 1) kKeyChunk) that holds dim in shared memory,
// between two barriers, whenever dim lies outside the chunk it staged
// last: any number of dimensions fits, in any order.  The barriers need
// every thread of the block to ask for the same dimensions in the same
// order (every draw source visits 0, 1, 2, ... in every thread).
#pragma once

#include "rng.cuh"

namespace mc {

constexpr int kWarp = 32;
constexpr int kScanSteps = 5;    // log2(kWarp)
constexpr int kKeyChunk = 256;   // Owen keys staged per block at a time

// Lane l's constants for a warp whose lane 0 holds point `base`: whether
// bit l of gray(base) (below bit 30) is set, and the lane whose word is
// l's delta d(base + l): ctz(base + l) when that delta is a word, else 31
// (a lane that holds 0), lane 0 included.
MC_HD void warp_lane_consts(uint32_t base, int lane, uint32_t* base_bit,
                            int* src) {
  const uint32_t g = (base ^ (base >> 1)) & ((1u << kSobolBits) - 1u);
  *base_bit = lane < kSobolBits ? (g >> lane) & 1u : 0u;
  const uint32_t id = base + (uint32_t)lane;
  int c = kWarp - 1;
  if (lane > 0 && id != 0u) {
#ifdef __CUDA_ARCH__
    c = __ffs(id) - 1;
#else
    c = __builtin_ctz(id);
#endif
    c = c < kSobolBits ? c : kWarp - 1;
  }
  *src = c;
}

// The Sobol integers of the warp's points in the dimension whose 30
// direction numbers are row[0..29], each lane's x(base + lane): a device
// function on the card (its warp shuffles), a host one for the tests.
#ifdef __CUDACC__
#define MC_WARP_FN __device__ __forceinline__
#else
#define MC_WARP_FN inline
#endif
template <class W>
MC_WARP_FN typename W::Val warp_sobol_bits(const W& w, const uint32_t* row) {
  using V = typename W::Val;
  const V word = w.word(row);         // row[l] on lanes l < 30, else 0
  V delta = w.gather(word);           // d(base + l); 0 on lane 0
#pragma unroll
  for (int s = 0; s < kScanSteps; ++s) {
    delta = w.scan_step(delta, 1 << s);  // XOR of d(base + 1 .. base + l)
  }
  V x = w.base_word(word);            // row[l] where bit l of gray(base)
#pragma unroll
  for (int s = 0; s < kScanSteps; ++s) {
    x = w.butterfly_step(x, (kWarp / 2) >> s);  // x(base) on every lane
  }
  return w.combine(x, delta);
}

#ifdef __CUDACC__
constexpr unsigned kFullMask = 0xffffffffu;

// One lane of a warp on the card; every lane of the warp calls
// warp_sobol_bits together.
struct WarpLane {
  using Val = uint32_t;
  int lane;
  uint32_t base_bit;
  int src;
  __device__ WarpLane(uint32_t base, int l) : lane(l) {
    warp_lane_consts(base, l, &base_bit, &src);
  }
  __device__ Val word(const uint32_t* row) const {
    return lane < kSobolBits ? __ldg(row + lane) : 0u;
  }
  __device__ Val gather(Val v) const { return __shfl_sync(kFullMask, v, src); }
  __device__ Val scan_step(Val v, int off) const {
    const Val up = __shfl_up_sync(kFullMask, v, off);
    return lane >= off ? v ^ up : v;
  }
  __device__ Val base_word(Val v) const { return base_bit ? v : 0u; }
  __device__ Val butterfly_step(Val v, int mask) const {
    return v ^ __shfl_xor_sync(kFullMask, v, mask);
  }
  __device__ Val combine(Val a, Val b) const { return a ^ b; }
};

// The randomized Sobol normals of one path of a block whose threads all
// call normal(dim) for the same dims in the same order.
struct SobolWarpNormals {
  const uint32_t* sv;  // (n_dims, 30) direction numbers
  uint32_t k0, k1;
  WarpLane lane;
  uint32_t staged = 0xffffffffu;  // the chunk of keys staged; none yet
  __device__ SobolWarpNormals(const uint32_t* table, uint32_t key0,
                              uint32_t key1, uint32_t id)
      : sv(table), k0(key0), k1(key1),
        lane(id - (threadIdx.x & (kWarp - 1)), threadIdx.x & (kWarp - 1)) {}
  __device__ float normal(uint32_t dim) {
    __shared__ uint32_t keys[kKeyChunk];  // the block's, one per kernel
    const uint32_t chunk = dim / kKeyChunk;
    if (chunk != staged) {
      __syncthreads();  // the last chunk's keys are read by every warp
      for (int j = threadIdx.x; j < kKeyChunk; j += blockDim.x) {
        keys[j] = sobol_key(k0, k1, chunk * kKeyChunk + (uint32_t)j);
      }
      __syncthreads();
      staged = chunk;
    }
    const uint32_t x = warp_sobol_bits(lane, sv + (size_t)dim * kSobolBits);
    return shifted_normal(x, keys[dim % kKeyChunk]);
  }
};

// The bridge's normals (fused_engine.cuh's BridgeDraws), which ask for the
// dims in tree order, jumping between chunks of kKeyChunk once n_dims >
// kKeyChunk: the Owen keys of dims [0, min(n_dims, kBridgeKeys)) staged
// once per block, by every thread of the block before any normal; a dim
// past them takes its key per normal (a Threefry call).  No barrier after
// the constructor, so the dims may come in any order.
constexpr int kBridgeKeys = 2048;  // 8 KB of shared memory a block
struct SobolStagedNormals {
  const uint32_t* sv;  // (n_dims, 30) direction numbers
  uint32_t k0, k1;
  WarpLane lane;
  uint32_t n_keys;  // the keys staged
  const uint32_t* keys;
  __device__ SobolStagedNormals(const uint32_t* table, uint32_t key0,
                                uint32_t key1, uint32_t id, int n_dims)
      : sv(table), k0(key0), k1(key1),
        lane(id - (threadIdx.x & (kWarp - 1)), threadIdx.x & (kWarp - 1)),
        n_keys((uint32_t)(n_dims < kBridgeKeys ? n_dims : kBridgeKeys)) {
    __shared__ uint32_t staged[kBridgeKeys];  // the block's, one per kernel
    for (uint32_t j = threadIdx.x; j < n_keys; j += blockDim.x) {
      staged[j] = sobol_key(k0, k1, j);
    }
    __syncthreads();
    keys = staged;
  }
  __device__ float normal(uint32_t dim) const {
    const uint32_t x = warp_sobol_bits(lane, sv + (size_t)dim * kSobolBits);
    // A branch, not a select: the unstaged key's Threefry call stays off
    // the path of a staged dim.
    const uint32_t key =
        dim < n_keys ? keys[dim] : unstaged_key(k0, k1, dim);
    return shifted_normal(x, key);
  }
  __device__ __noinline__ static uint32_t unstaged_key(uint32_t k0,
                                                       uint32_t k1,
                                                       uint32_t dim) {
    return sobol_key(k0, k1, dim);
  }
};

#else
// All 32 lanes of a warp on the host, each step done lane by lane in the
// order the card's shuffles give.
struct HostWarp {
  struct Val {
    uint32_t v[kWarp];
  };
  uint32_t base_bit[kWarp];
  int src[kWarp];
  explicit HostWarp(uint32_t base) {
    for (int l = 0; l < kWarp; ++l) {
      warp_lane_consts(base, l, &base_bit[l], &src[l]);
    }
  }
  Val word(const uint32_t* row) const {
    Val r;
    for (int l = 0; l < kWarp; ++l) r.v[l] = l < kSobolBits ? row[l] : 0u;
    return r;
  }
  Val gather(const Val& x) const {
    Val r;
    for (int l = 0; l < kWarp; ++l) r.v[l] = x.v[src[l]];
    return r;
  }
  Val scan_step(const Val& x, int off) const {
    Val r;
    for (int l = 0; l < kWarp; ++l) {
      r.v[l] = l >= off ? x.v[l] ^ x.v[l - off] : x.v[l];
    }
    return r;
  }
  Val base_word(const Val& x) const {
    Val r;
    for (int l = 0; l < kWarp; ++l) r.v[l] = base_bit[l] ? x.v[l] : 0u;
    return r;
  }
  Val butterfly_step(const Val& x, int mask) const {
    Val r;
    for (int l = 0; l < kWarp; ++l) r.v[l] = x.v[l] ^ x.v[l ^ mask];
    return r;
  }
  Val combine(const Val& a, const Val& b) const {
    Val r;
    for (int l = 0; l < kWarp; ++l) r.v[l] = a.v[l] ^ b.v[l];
    return r;
  }
};
#endif

}  // namespace mc
