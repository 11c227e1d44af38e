// The bridge-Sobol draw source's step draws with the bridge normals held
// per tree level in registers: the port of ops/fused_engine.py::
// _bridge_step_draws without its scratch.
//
// The plan (rng/sobol.py::_bridge_tables): row t of (dims, coeffs) lists
// the bridge dims that step t's increment combines, padded to a width L
// with (dim 0, coeff 0); slot j holds the dim at tree level j, the active
// levels contiguous from the root (slot 0 is always dim 0, the endpoint).
// Along t each slot's dim stays the same over a run of steps, and over all
// slots the runs number T: each of the T bridge normals is needed over
// one interval of steps at one level.  So a path keeps one normal per
// level, z[j], and at step t computes only the normals of the slots whose
// dim changed, in slot order: the plan's load schedule
// (rng/sobol.py::bridge_schedule), step t's loads at first[t] ..
// first[t + 1] - 1, each `level << 16 | dim`.  Then
//   eps = 0 + c_0 z[0] + ... + c_{L-1} z[L-1]
// over every slot in order, the plain version's sum of coeffs[t, j] *
// z[dims[t, j]] on the same operands: each normal is a pure function of
// (id, dim), computed once per path.  A padded slot (dim 0 past slot 0,
// coefficient 0) is not loaded: its level holds some earlier finite
// normal (or 0), its product is a zero, and the sum, which starts at +0
// and so is never -0, keeps its bits when a zero is added, as the plain
// version's z[0] times 0 does.
//
// The levels are statically indexed (a switch on the level to store and on
// the width to sum, each case's indices fixed), so they stay in
// registers and the sum takes exactly L products; a plan wider than
// kMaxLevels (T > 2^15) is refused by ops/fused_engine.py::kernel_refusal
// and runs on the torch loop.  The loads follow the plan, the same for
// every path, so on the card the branch is uniform across the warp and the
// block, as the normal source's shuffles and barriers need.  The normal
// source is a template parameter: on the card sobol_warp.cuh's
// SobolStagedNormals, in tests/test_torch_bridge_levels.py (g++) a source
// that hands in torch's normals and counts the loads.
#pragma once

#include <stdint.h>

#include "rng.cuh"

namespace mc {

constexpr int kMaxLevels = 16;  // ops/fused_engine.py::MAX_BRIDGE_LEVELS

// 0 + c[0] z[0] + ... + c[N-1] z[N-1], in order.
template <int N>
MC_HD float level_sum(const float* c, const float* z) {
  float e = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) e = e + c[j] * z[j];
  return e;
}

struct BridgeLevels {
  static_assert(kMaxLevels == 16, "the switches below name 16 levels");
  float z[kMaxLevels] = {};  // the normal of the node held at each level
  // Step t's innovation: `coeffs` the plan's row t (L slots), `loads`
  // step t's loads (n of them), normal(dim) the bridge normal of a dim.
  // The loads and the width are the same for every path, so each switch
  // takes one branch for the whole warp and every z index is static.
  template <class Normal>
  MC_HD float step(const float* coeffs, const uint32_t* loads, int n, int L,
                   Normal& normal) {
    for (int k = 0; k < n; ++k) {
      const uint32_t load = loads[k];
      const float v = normal(load & 0xffffu);
      switch (load >> 16) {
#define MC_LEVEL(j) \
  case j:           \
    z[j] = v;       \
    break;
        MC_LEVEL(0) MC_LEVEL(1) MC_LEVEL(2) MC_LEVEL(3)
        MC_LEVEL(4) MC_LEVEL(5) MC_LEVEL(6) MC_LEVEL(7)
        MC_LEVEL(8) MC_LEVEL(9) MC_LEVEL(10) MC_LEVEL(11)
        MC_LEVEL(12) MC_LEVEL(13) MC_LEVEL(14) MC_LEVEL(15)
#undef MC_LEVEL
      }
    }
    switch (L) {
#define MC_WIDTH(w) \
  case w:           \
    return level_sum<w>(coeffs, z);
      MC_WIDTH(1) MC_WIDTH(2) MC_WIDTH(3) MC_WIDTH(4)
      MC_WIDTH(5) MC_WIDTH(6) MC_WIDTH(7) MC_WIDTH(8)
      MC_WIDTH(9) MC_WIDTH(10) MC_WIDTH(11) MC_WIDTH(12)
      MC_WIDTH(13) MC_WIDTH(14) MC_WIDTH(15) MC_WIDTH(16)
#undef MC_WIDTH
    }
    return 0.0f;  // a width the kernels refuse
  }
};

}  // namespace mc
