// K2 and K3 — the process-generic fused time loop.
//
// Replaces montecarlo_tpu/ops/fused_engine.py::fused_terminal_pallas (K2,
// _make_kernel with payoff_fn=None) and ::fused_block_moments_pallas (K3,
// _make_kernel with a payoff epilogue).  One template,
//   fused_kernel<Proc, Antithetic, Epilogue>,
// runs any scalar-state process given as a device functor: init from the
// process leaves, then per pair of steps one draws_pair (the two steps share
// their cipher calls), the antithetic mirror on odd path ids, step x2 with
// the odd final step dropped by a select, and prices at the end.  The
// epilogue either stores the terminal price (K2) or applies a vanilla payoff
// and writes (mean, M2) per 128-path row (K3).
//
// Bounds on the H100: compute — integer ALU for Threefry, the SFU for
// log/sqrt/sin/cos; K2 writes 4 bytes per path, K3 8 bytes per 128 paths.
// Design: one thread per path with the state in registers for the whole time
// loop; K3 uses one 128-thread block per row and sums it in the fixed
// adjacent-pair tree of stats/welford.py::tree_sum (warp butterfly at
// offsets 1..16, then (w0+w1)+(w2+w3)), which the plain version reproduces
// bitwise.  The row -> 4096-path merge stays in torch, as in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

constexpr int kRow = 128;  // paths per stats row = K3's block size

// Default innovations of NormalDrawsMixin: D normals per step, the 2D draws
// of steps (2j, 2j+1) from D cipher calls at counters j*D + c.
template <int D>
struct NormalDraws {
  static constexpr int kDraws = D;
  __device__ static void draws_pair(uint32_t k0, uint32_t k1, uint32_t id,
                                    uint32_t j, float* eps0, float* eps1) {
    float flat[2 * D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      uint32_t b0, b1;
      mc::threefry2x32(k0, k1, id, j * (uint32_t)D + (uint32_t)c, &b0, &b1);
      mc::boxmuller_pair(b0, b1, &flat[2 * c], &flat[2 * c + 1]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      eps0[d] = flat[d];
      eps1[d] = flat[D + d];
    }
  }
};

// GBM (processes/gbm.py): leaves = [s0, mu, sigma, dt].
struct GbmProc : NormalDraws<1> {
  struct State {
    float log_s;
  };
  float drift, scale, log_s0;
  __device__ explicit GbmProc(const float* leaves) {
    const float s0 = leaves[0], mu = leaves[1], sigma = leaves[2];
    const float dt = leaves[3];
    drift = (mu - 0.5f * (sigma * sigma)) * dt;
    scale = sigma * sqrtf(dt);
    log_s0 = mc::log32(s0);
  }
  __device__ State init() const { return State{log_s0}; }
  __device__ State step(State s, const float* eps) const {
    return State{s.log_s + (drift + scale * eps[0])};
  }
  __device__ float prices(State s) const { return mc::exp32(s.log_s); }
};

struct StoreTerminal {  // K2
  float* out;
  __device__ void operator()(int64_t i, bool active, float price) const {
    if (active) out[i] = price;
  }
};

// Sum over the 128 threads of a block in tree_sum's adjacent-pair order.
// Every thread gets the total.
__device__ float row_tree_sum(float v, float* partial) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) partial[warp] = v;
  __syncthreads();
  const float total = (partial[0] + partial[1]) + (partial[2] + partial[3]);
  __syncthreads();  // partial[] is reused by the next call
  return total;
}

struct RowMoments {  // K3
  float* rows;       // (n_paths / 128, 2): mean, M2
  int payoff;        // 0 call, 1 put, 2 digital (engine/payoffs.py)
  float strike;
  __device__ void operator()(int64_t, bool, float price) const {
    __shared__ float partial[kRow / 32];
    float pay;
    if (payoff == 0) {
      pay = fmaxf(price - strike, 0.0f);
    } else if (payoff == 1) {
      pay = fmaxf(strike - price, 0.0f);
    } else {
      pay = price > strike ? 1.0f : 0.0f;
    }
    const float mean = row_tree_sum(pay, partial) / (float)kRow;
    const float d = pay - mean;
    const float m2 = row_tree_sum(d * d, partial);
    if (threadIdx.x == 0) {
      rows[2 * blockIdx.x] = mean;
      rows[2 * blockIdx.x + 1] = m2;
    }
  }
};

template <class Proc, bool Antithetic, class Epilogue>
__global__ void fused_kernel(const float* __restrict__ leaves,
                             int64_t n_paths, int n_steps,
                             uint32_t path_offset, uint32_t k0, uint32_t k1,
                             Epilogue epilogue) {
  constexpr int D = Proc::kDraws;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n_paths;
  const Proc proc(leaves);
  const uint32_t id = path_offset + (uint32_t)i;  // wraps mod 2^32
  // Antithetic: path 2k+1 mirrors path 2k (draws keyed by the pair id).
  const uint32_t draw_id = Antithetic ? id >> 1 : id;
  const bool mirror = Antithetic && (id & 1u);
  typename Proc::State state = proc.init();
  if (active) {
    const int n_pairs = (n_steps + 1) / 2;
    for (int j = 0; j < n_pairs; ++j) {
      float eps0[D], eps1[D];
      Proc::draws_pair(k0, k1, draw_id, (uint32_t)j, eps0, eps1);
      if (mirror) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          eps0[d] = -eps0[d];
          eps1[d] = -eps1[d];
        }
      }
      state = proc.step(state, eps0);
      const typename Proc::State stepped = proc.step(state, eps1);
      if (2 * j + 1 < n_steps) state = stepped;  // odd final step: dropped
    }
  }
  epilogue(i, active, proc.prices(state));
}

template <class Epilogue>
int launch(const float* leaves, int64_t n_paths, int64_t n_steps,
           uint32_t path_offset, uint32_t k0, uint32_t k1, int antithetic,
           Epilogue epilogue, void* stream) {
  const int64_t blocks = (n_paths + kRow - 1) / kRow;
  const cudaStream_t s = (cudaStream_t)stream;
  if (antithetic) {
    fused_kernel<GbmProc, true, Epilogue><<<(unsigned)blocks, kRow, 0, s>>>(
        leaves, n_paths, (int)n_steps, path_offset, k0, k1, epilogue);
  } else {
    fused_kernel<GbmProc, false, Epilogue><<<(unsigned)blocks, kRow, 0, s>>>(
        leaves, n_paths, (int)n_steps, path_offset, k0, k1, epilogue);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2: terminal prices, out (n_paths,).
extern "C" int mc_fused_terminal_gbm(float* out, const float* leaves,
                                     int64_t n_paths, int64_t n_steps,
                                     uint32_t path_offset, uint32_t k0,
                                     uint32_t k1, int antithetic,
                                     void* stream) {
  return launch(leaves, n_paths, n_steps, path_offset, k0, k1, antithetic,
                StoreTerminal{out}, stream);
}

// K3: per-128-path-row payoff (mean, M2), rows (n_paths / 128, 2).
// n_paths must be a multiple of 128 (the wrapper checks).
extern "C" int mc_fused_block_moments_gbm(float* rows, const float* leaves,
                                          int64_t n_paths, int64_t n_steps,
                                          uint32_t path_offset, uint32_t k0,
                                          uint32_t k1, int antithetic,
                                          int payoff, float strike,
                                          void* stream) {
  return launch(leaves, n_paths, n_steps, path_offset, k0, k1, antithetic,
                RowMoments{rows, payoff, strike}, stream);
}
