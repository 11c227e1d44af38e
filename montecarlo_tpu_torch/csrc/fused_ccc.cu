// K2, K3 and K4 on CCC-GARCH (processes/ccc_garch.py), A = 1..8 assets:
// StateProc<mc::CccStep<A>, A> (csrc/fused_mgarch.cuh) under Threefry,
// plain and antithetic, and Sobol draws, K4 on the generic fold, in a unit
// of its own.  Replaces the part of montecarlo_tpu/ops/fused_engine.py::
// fused_terminal_pallas, ::fused_block_moments_pallas and
// ::fused_functionals_pallas that traces its step.  Also the check entry
// of the by-value functors' per-step draws (step_normals), which is not
// on the pricing path.

#include "fused_mgarch.cuh"

namespace mcf {

MC_STATE_DEFINE_LAUNCHES(launch_ccc_garch, kCccGarch, mc::CccStep)

namespace {

// out[(t A + d) n + i]: normal d of step t of path i, as step_normals
// gives it to CCC's and DCC's kernels.
template <int A, bool Anti>
__global__ void state_draws_kernel(float* __restrict__ out, int64_t n,
                                   int n_steps, uint32_t path_offset,
                                   uint32_t k0, uint32_t k1) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t id = path_offset + (uint32_t)i;
  for (int t = 0; t < n_steps; ++t) {
    float eps[A];
    step_normals<A>(k0, k1, ThreefryDraws<Anti>::draw_id(id),
                    ThreefryDraws<Anti>::mirrored(id), t, eps);
#pragma unroll
    for (int d = 0; d < A; ++d) out[((int64_t)t * A + d) * n + i] = eps[d];
  }
}

template <int A>
cudaError_t state_draws(float* out, int64_t n, int n_steps,
                        uint32_t path_offset, uint32_t k0, uint32_t k1,
                        int antithetic, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kRow - 1) / kRow);
  if (antithetic) {
    state_draws_kernel<A, true><<<blocks, kRow, 0, s>>>(
        out, n, n_steps, path_offset, k0, k1);
  } else {
    state_draws_kernel<A, false><<<blocks, kRow, 0, s>>>(
        out, n, n_steps, path_offset, k0, k1);
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace mcf

// out (n_steps, n_assets, n_paths) float32: the normals CCC's and DCC's
// kernels draw a step at a time at an even asset count (2, 4, 6 or 8),
// Threefry plain or antithetic.
extern "C" int mc_state_draws_check(float* out, int n_assets, int64_t n_paths,
                                    int n_steps, uint32_t path_offset,
                                    uint32_t k0, uint32_t k1, int antithetic,
                                    void* stream) {
  if (n_paths < 1 || n_steps < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (n_assets) {
    case 2:
      err = mcf::state_draws<2>(out, n_paths, n_steps, path_offset, k0, k1,
                                antithetic, s);
      break;
    case 4:
      err = mcf::state_draws<4>(out, n_paths, n_steps, path_offset, k0, k1,
                                antithetic, s);
      break;
    case 6:
      err = mcf::state_draws<6>(out, n_paths, n_steps, path_offset, k0, k1,
                                antithetic, s);
      break;
    case 8:
      err = mcf::state_draws<8>(out, n_paths, n_steps, path_offset, k0, k1,
                                antithetic, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
