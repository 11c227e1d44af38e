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
// Bounds on the H100: issue slots.  Per path and step pair, A cipher calls
// with their Box-Muller transforms (integer ALU at half the issue rate, and
// libm's polynomials) and the triangular correlation of both halves, A(A+1)
// multiplies and A(A-1) adds; built with -fmad=false, every one issues
// alone, so from A ~ 32 on the correlation's float32 instructions set the
// time.  The output is 4 bytes per path.
//
// Design (csrc/basket_tile.cuh): a block holds P paths x all A assets, P =
// 256 / 256 / 128 / 64 for A up to 16 / 32 / 64 / 128 (four instantiations).
// Per step pair the block's threads share out its P*A cipher calls, U of
// them in lock step per thread so the dependent rounds of U calls
// interleave, and write the normals to shared memory as z[b][p]; after a
// barrier each thread sums a register tile of M paths x 8 assets against
// them, column by column, from L packed by tile in shared memory (float4
// and float2 loads: 2M + 8 shared words for 32M float operations, where the
// one-thread-per-(path, asset) kernel before it loaded 3 words for 4).  A
// thread owns tiles t and T-1-t, so every warp does the same triangular
// work, and the 32 lanes of a warp share one tile pair and one loop bound.
// The log prices stay in registers for the whole time loop.  The TPU's lane
// packing, power-of-two padding and kron(I, L^T) MXU product are left out,
// and so are tensor cores: neither TF32 nor 3xTF32 is bitwise.  Shared
// memory goes past 48 KB (~100 KB at A = 128, two blocks per SM), so it is
// dynamic.  Producer warps ciphering pair j + 1 beside consumers of pair j
// would need the draws twice over, one block per SM at A = 128; they are
// not built (PERF.md).  Any n_paths >= 1: the ragged last block is masked
// at the store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "basket_tile.cuh"
#include "rng.cuh"

namespace {

// The draws of step pair j for block path p and assets a, a + da, ...: the
// U ciphers in lock step, then the U Box-Muller transforms.
struct ThreefryPair {
  uint32_t k0, k1, id0, n_pairs, j;

  template <int U>
  MC_HD void batch(int p, int a, int da, float* z0, float* z1,
                   int dz) const {
    uint32_t c0[U], c1[U], b0[U], b1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c0[u] = id0 + (uint32_t)p;                     // wraps
      c1[u] = (uint32_t)(a + u * da) * n_pairs + j;  // wraps
    }
    mc::threefry2x32_lanes<U>(k0, k1, c0, c1, b0, b1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      mc::boxmuller_pair(b0[u], b1[u], z0 + u * dz, z1 + u * dz);
    }
  }
};

template <class Tr>
__global__ void __launch_bounds__(k7::kThreads, Tr::kBlocksPerSM)
packed_basket_kernel(float* __restrict__ out, const float* __restrict__ params,
                     const float* __restrict__ chol, int A, int64_t n_paths,
                     int n_steps, uint32_t path_offset, uint32_t k0,
                     uint32_t k1) {
  extern __shared__ float4 smem4[];
  const k7::Smem s = k7::carve(reinterpret_cast<float*>(smem4), A, Tr::P);
  const int tid = threadIdx.x;
  k7::stage_constants(s, A, Tr::P, params, chol, tid, k7::kThreads);
  const k7::Owned o = k7::owned<Tr>(tid, A);
  float log_s[2][Tr::M][k7::kTile];
  k7::init_log_s<Tr>(o, A, params, log_s);
  const int64_t base = (int64_t)blockIdx.x * Tr::P;
  const int n_pairs = (n_steps + 1) / 2;
  ThreefryPair draw{k0, k1, path_offset + (uint32_t)base, (uint32_t)n_pairs,
                    0u};
  __syncthreads();
  for (int j = 0; j < n_pairs; ++j) {
    draw.j = (uint32_t)j;
    k7::fill_pair<Tr::U>(s, A, Tr::P, tid, k7::kThreads, draw);
    __syncthreads();
    k7::step_pair<Tr>(s, o, 2 * j + 1 < n_steps, log_s);
    __syncthreads();  // the draws are rewritten by the next pair
  }
  k7::stage_weighted<Tr>(s, o, A, log_s);
  __syncthreads();
  if (tid < Tr::P && base + tid < n_paths) {
    out[base + tid] = k7::path_sum(s, Tr::P, tid, A);
  }
}

template <class Tr>
size_t smem_bytes(int A) {
  return k7::smem_floats(A, Tr::P) * sizeof(float);
}

template <class Tr>
int launch(float* out, const float* params, const float* chol, int A,
           int64_t n_paths, int n_steps, uint32_t path_offset, uint32_t k0,
           uint32_t k1, cudaStream_t stream) {
  const int64_t blocks = (n_paths + Tr::P - 1) / Tr::P;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<Tr>(A);
  // Room for the tier's widest basket, on the current device.
  const cudaError_t attr = cudaFuncSetAttribute(
      packed_basket_kernel<Tr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<Tr>(Tr::kMaxAssetsOfTier));
  if (attr != cudaSuccess) return (int)attr;
  packed_basket_kernel<Tr><<<(unsigned)blocks, k7::kThreads, bytes, stream>>>(
      out, params, chol, A, n_paths, n_steps, path_offset, k0, k1);
  return (int)cudaGetLastError();
}

template <class Tr>
int attributes(int A, int* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, packed_basket_kernel<Tr>);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem_bytes<Tr>(A);
  out[3] = Tr::P;
  return 0;
}

bool valid_assets(int n_assets) {
  return n_assets >= 1 && n_assets <= k7::kMaxAssets;
}

}  // namespace

// out (n_paths,); params (4, A): drift, scale, log32(s0), weights; chol
// (A, A) row-major lower-triangular.
extern "C" int mc_packed_basket_terminal(float* out, const float* params,
                                         const float* chol, int n_assets,
                                         int64_t n_paths, int64_t n_steps,
                                         uint32_t path_offset, uint32_t k0,
                                         uint32_t k1, void* stream) {
  if (!valid_assets(n_assets) || n_paths < 1 || n_steps < 0 ||
      n_steps > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int t = (int)n_steps;
  switch (k7::tier_of(n_assets)) {
    case 0:
      return launch<k7::Tier16>(out, params, chol, n_assets, n_paths, t,
                                path_offset, k0, k1, st);
    case 1:
      return launch<k7::Tier32>(out, params, chol, n_assets, n_paths, t,
                                path_offset, k0, k1, st);
    case 2:
      return launch<k7::Tier64>(out, params, chol, n_assets, n_paths, t,
                                path_offset, k0, k1, st);
    default:
      return launch<k7::Tier128>(out, params, chol, n_assets, n_paths, t,
                                 path_offset, k0, k1, st);
  }
}

// The launch K7 makes for an A-asset basket: out[0] registers per thread,
// out[1] local memory per thread (bytes), out[2] dynamic shared memory per
// block (bytes), out[3] paths per block.
extern "C" int mc_packed_basket_attributes(int n_assets, int* out) {
  if (!valid_assets(n_assets)) return (int)cudaErrorInvalidValue;
  switch (k7::tier_of(n_assets)) {
    case 0: return attributes<k7::Tier16>(n_assets, out);
    case 1: return attributes<k7::Tier32>(n_assets, out);
    case 2: return attributes<k7::Tier64>(n_assets, out);
    default: return attributes<k7::Tier128>(n_assets, out);
  }
}
