// K6 — the rough-Bergomi price integral from the joint matrix.
//
// Replaces montecarlo_tpu/ops/rbergomi_kernel.py::rbergomi_terminal_pallas
// (_rbergomi_kernel).  Reads the (2T, n_paths) joint matrix chol @ Z (rows
// 0..T-1: W~ at the grid times; rows T..2T-1: the Brownian increments) and
// writes terminal prices.  The perpendicular normals are draw-matrix
// columns 2T..3T-1, made here from counter (path id, T + t/2), so they
// never touch device memory.  Per step, in the TPU kernel's order:
//   dws   = rho*dw + c_perp*z_perp
//   log_s = log_s + (sqrt(v_left)*dws - v_left*half_dt)
//   v_t   = xi0 * exp32(eta*w_t - half_eta2*tpow[t])
// and exp32(log_s) at the end.  An odd T ends with the first half of its
// last pair, which is draw column 3T-1: the stream is unchanged.
//
// Bounds on the H100: at 2^20 paths x 252 steps it reads 2.1 GB (about
// 0.6 ms at 3.35 TB/s) and makes 1.3e8 cipher calls and 2.6e8 exp32; the
// cipher, the SFU work and the reads are of one order.  Design: one thread
// per path with the whole time loop in registers; each step reads
// joint[T+t, i] and joint[t, i], neighbouring threads on neighbouring
// addresses (coalesced); tpow is staged once per block in shared memory
// and read as a broadcast.  Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;

struct Params {
  float xi0, eta, rho, c_perp, half_dt, log_s0, half_eta2;
};

__device__ __forceinline__ void substep(const Params& p, float dw, float w_t,
                                        float tpow_t, float z_perp,
                                        float* log_s, float* v_left) {
  const float dws = p.rho * dw + p.c_perp * z_perp;
  *log_s = *log_s + (sqrtf(*v_left) * dws - *v_left * p.half_dt);
  *v_left = p.xi0 * mc::exp32(p.eta * w_t - p.half_eta2 * tpow_t);
}

__global__ void rbergomi_terminal_kernel(float* __restrict__ out,
                                         const float* __restrict__ joint,
                                         const float* __restrict__ tpow,
                                         const float* __restrict__ params,
                                         int64_t n_paths, int n_steps,
                                         uint32_t path_offset, uint32_t k0,
                                         uint32_t k1) {
  extern __shared__ float s_tpow[];
  for (int t = threadIdx.x; t < n_steps; t += blockDim.x) s_tpow[t] = tpow[t];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  const Params p{params[0], params[1], params[2], params[3],
                 params[4], params[5], params[6]};
  const int T = n_steps;
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  const float* w = joint + i;                     // row t: W~ at t_{t+1}
  const float* dw = joint + (int64_t)T * n_paths + i;  // row T+t: dW
  float log_s = p.log_s0;
  float v_left = p.xi0;
  for (int t = 0; t < T; t += 2) {
    uint32_t b0, b1;
    mc::threefry2x32(k0, k1, id, (uint32_t)(T + t / 2), &b0, &b1);
    float zp0, zp1;
    mc::boxmuller_pair(b0, b1, &zp0, &zp1);
    const int64_t r0 = (int64_t)t * n_paths;
    substep(p, dw[r0], w[r0], s_tpow[t], zp0, &log_s, &v_left);
    if (t + 1 < T) {
      const int64_t r1 = r0 + n_paths;
      substep(p, dw[r1], w[r1], s_tpow[t + 1], zp1, &log_s, &v_left);
    }
  }
  out[i] = mc::exp32(log_s);
}

}  // namespace

// tpow is staged in dynamic shared memory: n_steps * 4 bytes, at most the
// 48 KB a launch takes without an opt-in (the wrapper checks n_steps).
extern "C" int mc_rbergomi_terminal(float* out, const float* joint,
                                    const float* tpow, const float* params,
                                    int64_t n_paths, int64_t n_steps,
                                    uint32_t path_offset, uint32_t k0,
                                    uint32_t k1, void* stream) {
  const int64_t blocks = (n_paths + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_steps * sizeof(float);
  rbergomi_terminal_kernel<<<(unsigned)blocks, kThreads, smem,
                             (cudaStream_t)stream>>>(
      out, joint, tpow, params, n_paths, (int)n_steps, path_offset, k0, k1);
  return (int)cudaGetLastError();
}
