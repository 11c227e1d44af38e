// K6's shared-memory ring: which rows of the joint matrix each stage holds,
// which lane copies what, and where each step reads its two values.
//
// The joint matrix is (2T, N) float32: row t is W~ at t_{t+1}, row T + t
// the Brownian increment dW of step t.  Each warp keeps a ring of kStages
// slots of its own.  A slot holds one stage, the kStageSteps (K) steps
// t0 .. t0 + K - 1 of stage j (t0 = jK): first K rows of W~, then K rows
// of dW, each row the warp's 32 paths (128 contiguous bytes of the
// matrix).  A row segment is 8 copies of 16 bytes (4 paths each), so a
// stage is 2K x 8 copies, K/2 for each lane: lane l copies chunk l % 8 of
// the slot rows l / 8 + 4q, q < K/2.  Stage j goes to slot j % kStages,
// and copies run kStages - 1 stages ahead of the steps:
//
//   issue stages 0 .. S-2, one commit group each
//   for each full stage j (t0 + K <= T):
//     wait until at most S - 2 of the lane's groups are pending (its
//       copies of stage j have landed);
//     warp barrier (every lane's copies of stage j are visible, and every
//       lane has read stage j - 1);
//     issue stage j + S - 1 into stage j - 1's slot, one commit group;
//     run stage j's K steps from slot j % S, none of them tested;
//   then the tail stage, where T % K != 0: the same wait and barrier, and
//     its T - t0 < K steps, each pair tested.
//
// The stages past the tail issue nothing: no copy names a row past
// 2T - 1, and none a path past N - 1 (N % 4 == 0, so a 16-byte chunk lies
// wholly inside N or wholly outside).  K is even, so a step pair (t,
// t + 1), t even, never straddles two stages.
//
// __host__ __device__, so tests/test_torch_rbergomi_ring.py walks the same
// schedule with g++, lane by lane, and checks that every (row, path) is
// read exactly once, in step order, after its copy has landed and before
// a later copy overwrites it.
#pragma once

#include <stdint.h>

#include "rng.cuh"

namespace mc {
namespace ring {

constexpr int kStageSteps = 4;  // K: steps a stage holds
constexpr int kStages = 3;      // S: slots of a warp's ring
constexpr int kWarp = 32;
constexpr int kChunk = 4;                   // floats of one 16-byte copy
constexpr int kRowChunks = kWarp / kChunk;  // copies of one row segment
constexpr int kSlotRows = 2 * kStageSteps;
constexpr int kSlotFloats = kSlotRows * kWarp;
constexpr int kWarpFloats = kStages * kSlotFloats;
constexpr int kCopies = kSlotRows * kRowChunks / kWarp;  // a lane's, a stage
static_assert(kStageSteps >= 2 && kStageSteps % 2 == 0,
              "a step pair must not straddle two stages");
static_assert(kStages >= 2, "the ring needs a slot to fill while one is read");

MC_HD int full_stages(int T) { return T / kStageSteps; }

// One lane's copies: the joint-matrix offsets of the next stage it issues
// (stepped one stage, K rows, at every issue), where each lands in a slot,
// and the step within the stage that each copies.
struct LaneCopies {
  int64_t src[kCopies];
  int64_t stride;  // K * N
  int dst[kCopies];
  int step[kCopies];
  bool live;  // the lane's chunk lies inside N

  // The lane of the warp whose first path is `base` (a multiple of 32).
  MC_HD LaneCopies(int T, int64_t n_paths, int64_t base, int lane)
      : stride(kStageSteps * n_paths) {
    const int c = lane % kRowChunks;
    live = base + c * kChunk < n_paths;
#pragma unroll
    for (int q = 0; q < kCopies; ++q) {
      const int r = lane / kRowChunks + q * (kWarp / kRowChunks);
      const int k = r % kStageSteps;
      const int64_t row = r < kStageSteps ? k : (int64_t)T + k;
      src[q] = row * n_paths + base + c * kChunk;
      dst[q] = r * kWarp + c * kChunk;
      step[q] = k;
    }
  }
};

// The lane's copies of stage j (the stage after the last one issued):
// copy(ring float offset, joint offset) for each row it holds, none for a
// stage past the last.
template <class Copy>
MC_HD void issue_stage(LaneCopies& lc, int T, int j, Copy&& copy) {
  const int t0 = j * kStageSteps;
  const int slot = (j % kStages) * kSlotFloats;
#pragma unroll
  for (int q = 0; q < kCopies; ++q) {
    if (lc.live && t0 + lc.step[q] < T) copy(slot + lc.dst[q], lc.src[q]);
    lc.src[q] += lc.stride;
  }
}

// Stage j's step pairs for the lane: pair(t, w, dw, second) for t = t0,
// t0 + 2, ... < T, where w and dw are the ring offsets of W~_t and dW_t
// (those of step t + 1 one row, kWarp floats, on) and second = t + 1 < T.
// A full stage (kFull) tests neither.
template <bool kFull, class Pair>
MC_HD void consume_stage(int T, int j, int lane, Pair&& pair) {
  const int t0 = j * kStageSteps;
  const int slot = (j % kStages) * kSlotFloats + lane;
#pragma unroll
  for (int k = 0; k < kStageSteps; k += 2) {
    if (kFull || t0 + k < T) {
      pair(t0 + k, slot + k * kWarp, slot + (kStageSteps + k) * kWarp,
           kFull || t0 + k + 1 < T);
    }
  }
}

}  // namespace ring
}  // namespace mc
