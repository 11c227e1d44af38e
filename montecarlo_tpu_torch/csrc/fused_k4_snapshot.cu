// K4 on a set of price snapshots: the implied-vol surface's maturities
// (engine/surface.py), every one before the last in one launch, the last
// the run's terminal.  The library's entry and its instantiations over
// csrc/processes.cuh's functors: GBM under Threefry (plain and
// antithetic), Sobol and bridge-Sobol draws, Heston under Threefry and
// Sobol, the other functors under Threefry.  Any other functor or draw
// source runs kSnapshot on K4's generic fold (csrc/fused_k4.cu), which
// ops/fused_engine.py::k4_launches picks before any launch.
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_functionals_pallas on
// a set of engine/surface.py::price_snapshot functionals, which JAX
// compiles into a kernel of its own for the set.  Bound on the H100:
// compute, K2's loop to the last maturity, an exp32 (GBM's price) a
// snapshot and the terminal a path; 4 bytes a path per row.  Design:
// fused_snapshot_kernel below over functionals.cuh::SnapshotFold: the
// snapshots sorted on the host, one warp-uniform cursor on the next step,
// the price computed only where a snapshot latches and stored straight to
// its row, coalesced; no accumulator.  Numerics: as
// csrc/processes.cuh; the latched prices are the prices() of the same
// states as K2's terminal of a run stopped at that step.

#include "processes.cuh"

namespace mcf {
namespace {

// K4 on a set of price snapshots: K2's time loop (run_path) and, after
// each step, SnapshotFold's one compare; the price is taken only at a step
// that some snapshot latches and at the end.
template <class Proc, class Draws>
__global__ void fused_snapshot_kernel(const float* __restrict__ leaves,
                                      int dims, int64_t n_paths, int n_steps,
                                      uint32_t path_offset, uint32_t k0,
                                      uint32_t k1, Draws draws,
                                      SnapshotPlan plan,
                                      float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_paths;
  const float* consts = constants<Proc>(leaves, dims);  // the whole block
  if (!active && !Draws::kWholeBlock) return;
  const Proc proc(consts, dims);
  typename Proc::State state = proc.init();
  SnapshotFold fold;
  fold.init(plan, n_steps);
  auto latch = [&](int t) {
    const float price = active ? proc.prices(state) : 0.0f;
    fold.latch(plan, n_steps, t, price, out, i, active);
  };
  if (fold.due_at(0)) latch(0);
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  auto after = [&](int t) {
    if (fold.due_at(t + 1)) latch(t + 1);
  };
  run_path(proc, draws, k0, k1, id, i, n_steps, state, after);
  if (!active) return;
  const float terminal = proc.prices(state);
  out[i] = terminal;
  fold.finalize(plan, n_steps, terminal, out, i);
}

template <class Draws>
constexpr bool kIsThreefry =
    std::is_same<Draws, ThreefryDraws<false>>::value ||
    std::is_same<Draws, ThreefryDraws<true>>::value;

// Whether the snapshot kernel is built for functor Proc under Draws
// (ops/fused_engine.py::SNAPSHOT_SOURCES).
template <class Proc, class Draws>
constexpr bool kSnapshotBuilt =
    kIsThreefry<Draws> || std::is_same<Proc, GbmProc>::value ||
    (std::is_same<Proc, HestonProc>::value &&
     std::is_same<Draws, SobolDraws>::value);

template <class Proc, class Draws>
struct SnapshotLauncher {
  static cudaError_t run(unsigned blocks, cudaStream_t s, int dims,
                         Draws draws, int64_t n_paths, const float* leaves,
                         int n_steps, uint32_t path_offset, uint32_t k0,
                         uint32_t k1, SnapshotPlan plan, float* out) {
    if constexpr (kSnapshotBuilt<Proc, Draws>) {
      fused_snapshot_kernel<Proc, Draws><<<blocks, kRow, 0, s>>>(
          leaves, dims, n_paths, n_steps, path_offset, k0, k1, draws, plan,
          out);
      return cudaSuccess;
    } else {
      return cudaErrorInvalidValue;
    }
  }
};

}  // namespace
}  // namespace mcf

using namespace mcf;

// out (1 + n_snapshots, out_stride), out_stride >= n_paths: the terminal
// prices, then in row k + 1 the price after steps[k] steps (0: the spot;
// 0 for a step past n_steps), in columns 0 .. n_paths - 1 of each row.
// steps (non-decreasing) and rows (a permutation of 0 .. n_snapshots - 1:
// the output row less one of each step) are host arrays.
extern "C" int mc_fused_snapshots(float* out, const float* leaves,
                                  int process, int dims, int64_t n_paths,
                                  int64_t n_steps, uint32_t path_offset,
                                  uint32_t k0, uint32_t k1, MC_DRAW_PARAMS,
                                  int n_snapshots, const int* steps,
                                  const int* rows, int64_t out_stride,
                                  void* stream) {
  if (n_snapshots < 0 || n_snapshots > kMaxSnapshots ||
      out_stride < n_paths || n_paths < 1 || n_steps < 0 ||
      n_steps > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  SnapshotPlan plan = {};
  plan.out_stride = out_stride;
  plan.n = n_snapshots;
  for (int k = 0; k < n_snapshots; ++k) {
    if (steps[k] < 0 || (k > 0 && steps[k] < steps[k - 1]) || rows[k] < 0 ||
        rows[k] >= n_snapshots) {
      return (int)cudaErrorInvalidValue;
    }
    plan.step[k] = steps[k];
    plan.row[k] = rows[k];
  }
  const unsigned blocks = (unsigned)((n_paths + kRow - 1) / kRow);
  const cudaError_t err = launch_functor<SnapshotLauncher>(
      process, dims, MC_DRAW_ARGS, blocks, (cudaStream_t)stream, n_paths,
      leaves, (int)n_steps, path_offset, k0, k1, plan, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
