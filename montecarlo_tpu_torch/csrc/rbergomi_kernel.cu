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
//   v_t   = xi0 * exp32(eta*w_t - c_t),   c_t = half_eta2*tpow[t]
// and exp32(log_s) at the end.  An odd T ends with the first half of its
// last pair, which is draw column 3T-1: the stream is unchanged.
//
// c_t is staged once per block in shared memory, rounded once as the
// plain version's half_eta2 * tpow[t] is; built with -fmad=false, the
// step's eta*w_t - c_t is then a rounded product and a rounded
// difference of the same two floats as before, so the bits are the plain
// version's (no multiply fuses into the subtraction either way).
//
// Bounds on the H100: at 2^20 paths x 252 steps it reads 2.1 GB (about
// 0.63 ms at 3.35 TB/s) and makes 1.3e8 cipher calls and 2.6e8 exp32; the
// cipher, Box-Muller, two exp32 and two IEEE sqrt take ~270 of the ~290
// SASS instructions of a step pair, an issue floor (~1.14 ms) nearly
// twice the reads'.  Design: one
// thread per path with the time loop in registers, the reads overlapped
// with the arithmetic.  Where every row segment starts on 16 bytes
// (n_paths % 4 == 0 and an aligned matrix) each warp streams its 32
// paths' rows through a ring in shared memory (rbergomi_ring.cuh):
// 16-byte cp.async copies issued kStages - 1 stages of kStageSteps steps
// ahead, completed with cp.async.wait_group and one warp barrier a stage,
// the steps reading their two values a step from shared memory; no block
// barrier in the loop.  Any other n_paths takes the plain-load form: each
// thread loads the next pair's four values into registers before it runs
// the current pair, its row pointers stepped by 2 * n_paths a pair.
// Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rbergomi_ring.cuh"
#include "rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / mc::ring::kWarp;

struct Params {
  float xi0, eta, rho, c_perp, half_dt, log_s0, half_eta2;
};

// The parameters, and c_t = half_eta2 * tpow[t] for every step staged in
// shared memory for the whole block.
__device__ __forceinline__ Params stage_params(const float* params,
                                               const float* tpow, int T,
                                               float* s_c) {
  const Params p{params[0], params[1], params[2], params[3],
                 params[4], params[5], params[6]};
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    s_c[t] = p.half_eta2 * tpow[t];
  }
  __syncthreads();
  return p;
}

__device__ __forceinline__ void substep(const Params& p, float dw, float w_t,
                                        float c_t, float z_perp,
                                        float* log_s, float* v_left) {
  const float dws = p.rho * dw + p.c_perp * z_perp;
  *log_s = *log_s + (sqrtf(*v_left) * dws - *v_left * p.half_dt);
  *v_left = p.xi0 * mc::exp32(p.eta * w_t - c_t);
}

// The normals of the pair starting at step t (even): counter (id, T + t/2).
__device__ __forceinline__ void pair_normals(uint32_t k0, uint32_t k1,
                                             uint32_t id, int T, int t,
                                             float* z0, float* z1) {
  uint32_t b0, b1;
  mc::threefry2x32(k0, k1, id, (uint32_t)(T + t / 2), &b0, &b1);
  mc::boxmuller_sincos(b0, b1, z0, z1);
}

// The plain-load form: any n_paths.
__global__ void __launch_bounds__(kThreads) rbergomi_terminal_kernel(
    float* __restrict__ out, const float* __restrict__ joint,
    const float* __restrict__ tpow, const float* __restrict__ params,
    int64_t n_paths, int n_steps, uint32_t path_offset, uint32_t k0,
    uint32_t k1) {
  extern __shared__ float s_c[];
  const int T = n_steps;
  const Params p = stage_params(params, tpow, T, s_c);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  const int64_t n = n_paths;
  // Rows t (W~) and T + t (dW) of the pair ahead, stepped two rows a pair;
  // its four values are loaded while the current pair runs.
  const float* w = joint + i;
  const float* dw = w + (int64_t)T * n;
  float w0 = w[0], dw0 = dw[0], w1 = 0.0f, dw1 = 0.0f;
  if (T > 1) {
    w1 = w[n];
    dw1 = dw[n];
  }
  float log_s = p.log_s0;
  float v_left = p.xi0;
  for (int t = 0; t < T; t += 2) {
    const float cw0 = w0, cdw0 = dw0, cw1 = w1, cdw1 = dw1;
    w += 2 * n;
    dw += 2 * n;
    if (t + 2 < T) {
      w0 = w[0];
      dw0 = dw[0];
    }
    if (t + 3 < T) {
      w1 = w[n];
      dw1 = dw[n];
    }
    float zp0, zp1;
    pair_normals(k0, k1, id, T, t, &zp0, &zp1);
    substep(p, cdw0, cw0, s_c[t], zp0, &log_s, &v_left);
    if (t + 1 < T) substep(p, cdw1, cw1, s_c[t + 1], zp1, &log_s, &v_left);
  }
  out[i] = mc::exp32(log_s);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring form: n_paths % 4 == 0 and a 16-byte-aligned matrix.  K and S
// are the ring's shape (rbergomi_ring.cuh), named in the kernel's symbol
// so that tools/rows.py counts its SASS per step pair.
template <int K, int S>
__global__ void __launch_bounds__(kThreads) rbergomi_ring_kernel(
    float* __restrict__ out, const float* __restrict__ joint,
    const float* __restrict__ tpow, const float* __restrict__ params,
    int64_t n_paths, int n_steps, uint32_t path_offset, uint32_t k0,
    uint32_t k1, int c_floats) {
  namespace ring = mc::ring;
  static_assert(K == ring::kStageSteps && S == ring::kStages,
                "the symbol names the header's ring");
  extern __shared__ __align__(16) float smem[];
  const int T = n_steps;
  float* s_c = smem;
  const Params p = stage_params(params, tpow, T, s_c);
  const int warp = threadIdx.x / ring::kWarp;
  const int lane = threadIdx.x % ring::kWarp;
  const int64_t base = (int64_t)blockIdx.x * kThreads + warp * ring::kWarp;
  if (base >= n_paths) return;  // the whole warp: no barrier follows
  const float* rg = smem + c_floats + warp * ring::kWarpFloats;
  const uint32_t rg_s = (uint32_t)__cvta_generic_to_shared(rg);
  ring::LaneCopies lc(T, n_paths, base, lane);
  auto copy = [&](int dst, int64_t src) {
    cp_async16(rg_s + 4u * (uint32_t)dst, joint + src);
  };
  for (int j = 0; j < S - 1; ++j) {
    ring::issue_stage(lc, T, j, copy);
    cp_async_commit();
  }
  const uint32_t id = path_offset + (uint32_t)(base + lane);  // wraps
  float log_s = p.log_s0;
  float v_left = p.xi0;
  auto step_pair = [&](int t, int w, int dw, bool second) {
    float zp0, zp1;
    pair_normals(k0, k1, id, T, t, &zp0, &zp1);
    substep(p, rg[dw], rg[w], s_c[t], zp0, &log_s, &v_left);
    if (second) {
      substep(p, rg[dw + ring::kWarp], rg[w + ring::kWarp], s_c[t + 1], zp1,
              &log_s, &v_left);
    }
  };
  const int n_full = ring::full_stages(T);
  for (int j = 0; j < n_full; ++j) {
    cp_async_wait<S - 2>();
    __syncwarp();
    ring::issue_stage(lc, T, j + S - 1, copy);
    cp_async_commit();
    ring::consume_stage<true>(T, j, lane, step_pair);
  }
  if (n_full * K < T) {  // the tail stage; nothing is left to issue
    cp_async_wait<S - 2>();
    __syncwarp();
    ring::consume_stage<false>(T, n_full, lane, step_pair);
  }
  if (base + lane < n_paths) out[base + lane] = mc::exp32(log_s);
}

constexpr uint32_t kAngles = 1u << 23;  // the words' distinct angles

// out (2, 2^23): the sine and cosine K6 takes of angle m, the angle of
// word m << 9, for every m.
__global__ void angle_check_kernel(float* out) {
  const uint32_t m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= kAngles) return;
  float s, c;
  mc::boxmuller_angle_sincos(m << 9, &s, &c);
  out[m] = s;
  out[kAngles + m] = c;
}

// Shared memory of a launch: c_t for every step (rounded up to 16 bytes),
// then, in the ring form, each warp's ring.
size_t c_floats_of(int64_t n_steps) { return (size_t)(n_steps + 3) / 4 * 4; }

int launch_blocks(int64_t n_paths, unsigned* blocks) {
  const int64_t b = (n_paths + kThreads - 1) / kThreads;
  if (b > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return 0;
}

// Lets a launch take `smem` bytes of dynamic shared memory (above 48 KB
// only after an opt-in).
template <class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// The ring form.  Refuses (cudaErrorInvalidValue) a matrix whose row
// segments do not start on 16 bytes: the wrapper sends those to
// mc_rbergomi_terminal_unaligned.
extern "C" int mc_rbergomi_terminal(float* out, const float* joint,
                                    const float* tpow, const float* params,
                                    int64_t n_paths, int64_t n_steps,
                                    uint32_t path_offset, uint32_t k0,
                                    uint32_t k1, void* stream) {
  namespace ring = mc::ring;
  if (n_paths % 4 != 0 || (uintptr_t)joint % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned blocks;
  if (int err = launch_blocks(n_paths, &blocks)) return err;
  const size_t c_floats = c_floats_of(n_steps);
  const size_t smem =
      (c_floats + (size_t)kWarps * ring::kWarpFloats) * sizeof(float);
  auto kernel = rbergomi_ring_kernel<ring::kStageSteps, ring::kStages>;
  if (int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      out, joint, tpow, params, n_paths, (int)n_steps, path_offset, k0, k1,
      (int)c_floats);
  return (int)cudaGetLastError();
}

// The plain-load form, for any n_paths; c_t takes n_steps * 4 bytes of
// shared memory, at most the 48 KB a launch takes without an opt-in (the
// wrapper checks n_steps).
extern "C" int mc_rbergomi_terminal_unaligned(
    float* out, const float* joint, const float* tpow, const float* params,
    int64_t n_paths, int64_t n_steps, uint32_t path_offset, uint32_t k0,
    uint32_t k1, void* stream) {
  unsigned blocks;
  if (int err = launch_blocks(n_paths, &blocks)) return err;
  const size_t smem = (size_t)n_steps * sizeof(float);
  rbergomi_terminal_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      out, joint, tpow, params, n_paths, (int)n_steps, path_offset, k0, k1);
  return (int)cudaGetLastError();
}

// out (2, 2^23) float32: Box-Muller's sine and cosine, as K6 takes them,
// of every angle a 32-bit word can give.
extern "C" int mc_rbergomi_angle_check(float* out, void* stream) {
  angle_check_kernel<<<kAngles / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}
