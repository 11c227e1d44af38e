// K5 — the bulk normal matrix of the rough-Bergomi sampler.
//
// Replaces montecarlo_tpu/ops/rng_kernel.py::normal_matrix_pallas
// (_normal_matrix_kernel).  Fills an (n_cols, n_paths) float32 matrix with
// out[m, i] == normal_draw(seed, stream, path_offset + i, m): component
// m & 1 of the Box-Muller pair for counter (path id, m >> 1).  The path id
// wraps mod 2^32.  Column-major in the draw index, so the factor product
// that consumes it runs as chol @ Z with no transpose.
//
// Bounds on the H100: at 2^20 paths x 504 columns it writes 2.1 GB (about
// 0.6 ms at 3.35 TB/s) and makes 2.6e8 cipher calls plus as many log, sqrt,
// sin and cos; the cipher and the SFU work are the larger share.  Design:
// one thread per path over a chunk of kPairsPerBlock Box-Muller pairs
// (blockIdx.y picks the chunk), so there are enough blocks to fill the card
// at any column count; each pair writes rows 2j and 2j+1, neighbouring
// threads on neighbouring addresses (coalesced), the second row guarded for
// odd n_cols.  Offsets are 64-bit: 3T x 2^22 exceeds 2^31 elements.  No
// shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairsPerBlock = 16;

__global__ void normal_matrix_kernel(float* __restrict__ out,
                                     int64_t n_paths, int64_t n_cols,
                                     uint32_t path_offset, uint32_t k0,
                                     uint32_t k1) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_paths) return;
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  const int64_t n_pairs = (n_cols + 1) / 2;
  const int64_t j0 = (int64_t)blockIdx.y * kPairsPerBlock;
  const int64_t j1 = j0 + kPairsPerBlock < n_pairs ? j0 + kPairsPerBlock
                                                   : n_pairs;
  for (int64_t j = j0; j < j1; ++j) {
    uint32_t b0, b1;
    mc::threefry2x32(k0, k1, id, (uint32_t)j, &b0, &b1);
    float z0, z1;
    mc::boxmuller_pair(b0, b1, &z0, &z1);
    const int64_t row = 2 * j;
    out[row * n_paths + i] = z0;
    if (row + 1 < n_cols) out[(row + 1) * n_paths + i] = z1;
  }
}

}  // namespace

// Returns cudaErrorInvalidValue beyond 65535 pair chunks (gridDim.y), that
// is n_cols > 65535 * 2 * kPairsPerBlock; the wrapper checks it first.
extern "C" int mc_normal_matrix(float* out, int64_t n_paths, int64_t n_cols,
                                uint32_t path_offset, uint32_t k0, uint32_t k1,
                                void* stream) {
  const int64_t blocks = (n_paths + kThreads - 1) / kThreads;
  const int64_t chunks = ((n_cols + 1) / 2 + kPairsPerBlock - 1) /
                         kPairsPerBlock;
  if (blocks > 0x7FFFFFFF || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  normal_matrix_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      out, n_paths, n_cols, path_offset, k0, k1);
  return (int)cudaGetLastError();
}
