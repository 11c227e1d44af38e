// K7 — terminal values of a correlated GBM basket of up to 128 assets.
//
// Replaces montecarlo_tpu/ops/basket_kernel.py::packed_basket_terminal_pallas
// (_basket_kernel).  Per path p (global id offset + p, uint32) and asset a:
// log_s = log32(s0_a); for each step pair j < n_pairs = (T+1)/2 one Threefry
// call at counter (id, a*n_pairs + j) — the asset-major convention, unlike
// BasketGBM's t*A + d — whose Box-Muller halves z0, z1 drive steps 2j and
// 2j+1; zc = L z for each half, summed over b in ascending order;
//   log_s = (log_s + drift) + scale*zc0
//   log_s = (log_s + live?drift:0) + (live?scale*zc1:0),  live = 2j+1 < T
// (ungrouped, as the TPU kernel's update is); the output is
// sum_a w_a exp32(log_s_a), summed over the assets in order.  exp32/log32
// replace the TPU kernel's jnp.exp/jnp.log, from which they differ by an
// ULP or so; the plain version uses the same functions, so kernel and plain
// version agree bitwise.
//
// Bounds on the H100: compute.  Per path and step pair, A cipher calls
// (integer ALU) and 2A^2 float32 multiplies and adds for the correlation,
// which dominates from A ~ 16 on; the output is 4 bytes per path.  Design:
// the TPU's lane packing, power-of-two padding and kron(I, L^T) MXU matrix
// are left out.  One block holds P = 256/A paths and one thread per (path,
// asset); each thread makes its own asset's cipher call per pair and writes
// z0/z1 to shared memory; after a barrier it sums its row of L against its
// path's z (a broadcast read).  L lives in shared memory as the packed lower
// triangle, column-major, so the 32 threads of a warp read 32 consecutive
// words (33 KB at A = 128).  The correlation is plain float32 (no tensor
// cores, no TF32: the rBergomi factor product misses its float32 error
// bound 24-fold in TF32).  Built with -fmad=false: every multiply and add
// rounds on its own, as in the plain version.  Any n_paths >= 1: the
// ragged last block is masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

constexpr int kMaxAssets = 128;  // processes/basket.py MAX_ASSETS
constexpr int kThreads = 256;  // a block holds kThreads / A paths
constexpr int kTri = kMaxAssets * (kMaxAssets + 1) / 2;

__global__ void packed_basket_kernel(float* __restrict__ out,
                                     const float* __restrict__ params,
                                     const float* __restrict__ chol, int A,
                                     int paths_per_block, int64_t n_paths,
                                     int n_steps, uint32_t path_offset,
                                     uint32_t k0, uint32_t k1) {
  __shared__ float s_l[kTri];  // column b holds L[b..A-1, b]
  __shared__ float s_z0[kThreads];
  __shared__ float s_z1[kThreads];
  const int tid = threadIdx.x;
  for (int k = tid; k < A * A; k += blockDim.x) {
    const int r = k / A, c = k - r * A;
    if (c <= r) s_l[c * A - c * (c - 1) / 2 + (r - c)] = chol[k];
  }
  const int p = tid / A;
  const int a = tid - p * A;
  const int64_t i = (int64_t)blockIdx.x * paths_per_block + p;
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  const float drift = params[a];
  const float scale = params[A + a];
  const float w = params[3 * A + a];
  float log_s = params[2 * A + a];
  const float* z0 = s_z0 + p * A;  // this path's draws
  const float* z1 = s_z1 + p * A;
  const int n_pairs = (n_steps + 1) / 2;
  const uint32_t c_base = (uint32_t)a * (uint32_t)n_pairs;  // wraps
  __syncthreads();
  for (int j = 0; j < n_pairs; ++j) {
    uint32_t b0, b1;
    mc::threefry2x32(k0, k1, id, c_base + (uint32_t)j, &b0, &b1);
    mc::boxmuller_pair(b0, b1, &s_z0[tid], &s_z1[tid]);
    __syncthreads();
    float zc0 = s_l[a] * z0[0];
    float zc1 = s_l[a] * z1[0];
    int idx = a;  // s_l index of L[a, b]
    for (int b = 1; b <= a; ++b) {
      idx += A - b;
      const float l = s_l[idx];
      zc0 = zc0 + l * z0[b];
      zc1 = zc1 + l * z1[b];
    }
    log_s = (log_s + drift) + scale * zc0;
    const bool live = 2 * j + 1 < n_steps;
    log_s = (log_s + (live ? drift : 0.0f)) + (live ? scale * zc1 : 0.0f);
    __syncthreads();  // s_z0/s_z1 are rewritten by the next pair
  }
  s_z0[tid] = w * mc::exp32(log_s);
  __syncthreads();
  if (a == 0 && i < n_paths) {
    float v = z0[0];
    for (int b = 1; b < A; ++b) v = v + z0[b];
    out[i] = v;
  }
}

}  // namespace

// out (n_paths,); params (4, A): drift, scale, log32(s0), weights; chol
// (A, A) row-major lower-triangular.
extern "C" int mc_packed_basket_terminal(float* out, const float* params,
                                         const float* chol, int n_assets,
                                         int64_t n_paths, int64_t n_steps,
                                         uint32_t path_offset, uint32_t k0,
                                         uint32_t k1, void* stream) {
  if (n_assets < 1 || n_assets > kMaxAssets || n_paths < 1 || n_steps < 0 ||
      n_steps > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  const int per_block = kThreads / n_assets;
  const int64_t blocks = (n_paths + per_block - 1) / per_block;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  packed_basket_kernel<<<(unsigned)blocks, per_block * n_assets, 0,
                         (cudaStream_t)stream>>>(
      out, params, chol, n_assets, per_block, n_paths, (int)n_steps,
      path_offset, k0, k1);
  return (int)cudaGetLastError();
}
