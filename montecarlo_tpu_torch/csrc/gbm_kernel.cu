// K1 — terminal GBM prices, the benchmark kernel.
//
// Replaces montecarlo_tpu/ops/gbm_kernel.py::gbm_terminal_pallas
// (_gbm_kernel, rng="threefry" mode).  Per pair of steps: one Threefry call
// (c0 = global path id, c1 = pair index), one Box-Muller pair, two grouped
// log-Euler updates log_s + (drift + scale*z), the second masked to an exact
// +0.0 when the step count is odd; expf at the end.  The wrapper computes
// [drift, scale, log(s0)] in float32 with the platform log, as the TPU
// wrapper does, and this kernel ends with IEEE expf: K1 keeps the TPU
// kernel's own numerics (not log32/exp32), so it differs from the engine by
// float32 round-off only.
//
// Bounds on the H100: compute, not memory — 4 bytes written per path after
// n_steps steps.  Per step pair the work is the integer cipher (ALU) and
// log/sqrt/sin/cos (SFU plus range reduction).  Design: one thread per path,
// the whole time loop in registers, one store per path; the ragged edge is
// masked, so any path count is accepted.  No shared memory, no tuning yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

__global__ void gbm_terminal_kernel(float* __restrict__ out,
                                    const float* __restrict__ params,
                                    int64_t n_paths, int n_steps,
                                    uint32_t path_offset, uint32_t k0,
                                    uint32_t k1) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  const float drift = params[0];
  const float scale = params[1];
  float log_s = params[2];
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  const int n_pairs = (n_steps + 1) / 2;
  for (int j = 0; j < n_pairs; ++j) {
    uint32_t b0, b1;
    mc::threefry2x32(k0, k1, id, (uint32_t)j, &b0, &b1);
    float z0, z1;
    mc::boxmuller_pair(b0, b1, &z0, &z1);
    log_s = log_s + (drift + scale * z0);
    const bool live = 2 * j + 1 < n_steps;
    log_s = log_s + (live ? drift + scale * z1 : 0.0f);
  }
  out[i] = expf(log_s);
}

}  // namespace

extern "C" int mc_gbm_terminal(float* out, const float* params,
                               int64_t n_paths, int64_t n_steps,
                               uint32_t path_offset, uint32_t k0, uint32_t k1,
                               void* stream) {
  const int threads = 256;
  const int64_t blocks = (n_paths + threads - 1) / threads;
  gbm_terminal_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(out, params, n_paths,
                                                (int)n_steps, path_offset, k0,
                                                k1);
  return (int)cudaGetLastError();
}
