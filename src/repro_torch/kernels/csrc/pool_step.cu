// Fused evict-and-place step for the KiSS warm pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pool_step.py
// (_evict_place_kernel).  For each pool row of the stacked [P, S] state:
//
//   sz_j     = idle_j ? size_j : 0                  (evictable bytes)
//   before_i = sum_j [(pri_j, seq_j) <lex (pri_i, seq_i)] * sz_j
//   evict_i  = idle_i && before_i < deficit - 1e-9f
//   freed    = sum of size over evicted slots,  avail = sum_j sz_j
//   ins      = first slot empty after eviction (0 when none)
//   empty    = whether such a slot exists
//
// Ranking by counting replaces the reference's two stable sorts: among
// idle slots (pri, seq) is a strict total order (seq grows with every
// insert), and slots that are not idle add zero bytes.  The sums are
// exact in any order because sizes are whole MB, so the result is
// bitwise equal to the sort + prefix-sum composite.  No contraction:
// built with -fmad=false and without fast math.
//
// Design.  Two kernels on the caller's stream.  rank_kernel: a grid of
// (ceil(S / 128), P) blocks of 128 threads; each block stages its row's
// pri, seq and evictable bytes in shared memory (12 B per slot) and
// each thread counts before_i for one slot i over all j, with four
// independent accumulators (exact: the partial sums are whole MB), and
// writes evict_i.  reduce_kernel: one block per row reduces freed,
// avail, ins and empty with warp shuffles.  Counting costs 4 * P * S^2
// f32 operations (read from shared memory as broadcasts), far more than
// the sort the function needs, but it is branch-free and simple; tiling
// the slots over blocks keeps 16 SMs busy at [2, 1024] where one block
// per row kept two.
//
// C interface (no PyTorch headers), bound with ctypes by
// repro_torch/kernels/_build.py.  Bool masks arrive as their 1-byte
// storage.  Returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;      // slots ranked per block
constexpr int kThreads = 256;   // threads of a row's reduction block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kTile)
rank_kernel(const float* __restrict__ pri, const float* __restrict__ seq,
            const float* __restrict__ size,
            const uint8_t* __restrict__ idle,
            const float* __restrict__ deficit, uint8_t* __restrict__ evict,
            int S) {
  extern __shared__ float smem[];
  float* s_pri = smem;
  float* s_seq = smem + S;
  float* s_sz = smem + 2 * S;
  const int row = blockIdx.y;
  const size_t base = static_cast<size_t>(row) * S;
  for (int j = threadIdx.x; j < S; j += kTile) {
    s_pri[j] = pri[base + j];
    s_seq[j] = seq[base + j];
    s_sz[j] = idle[base + j] ? size[base + j] : 0.0f;
  }
  __syncthreads();
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= S) return;

  const float pi = s_pri[i], si = s_seq[i];
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int j = 0;
  for (; j + 4 <= S; j += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float pj = s_pri[j + k];
      const bool less = (pj < pi) | ((pj == pi) & (s_seq[j + k] < si));
      acc[k] = __fadd_rn(acc[k], less ? s_sz[j + k] : 0.0f);
    }
  }
  for (; j < S; ++j) {
    const float pj = s_pri[j];
    const bool less = (pj < pi) | ((pj == pi) & (s_seq[j] < si));
    acc[0] = __fadd_rn(acc[0], less ? s_sz[j] : 0.0f);
  }
  const float before = __fadd_rn(__fadd_rn(acc[0], acc[1]),
                                 __fadd_rn(acc[2], acc[3]));
  evict[base + i] =
      idle[base + i] && before < __fsub_rn(deficit[row], 1e-9f);
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ size,
              const uint8_t* __restrict__ idle,
              const uint8_t* __restrict__ valid,
              const uint8_t* __restrict__ evict, float* __restrict__ freed,
              int32_t* __restrict__ ins, float* __restrict__ avail,
              uint8_t* __restrict__ empty, int S) {
  __shared__ float r_freed[kWarps];
  __shared__ float r_avail[kWarps];
  __shared__ int r_ins[kWarps];
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * S;
  float freed_p = 0.0f, avail_p = 0.0f;
  int ins_p = S;   // S = no empty slot seen
  for (int i = threadIdx.x; i < S; i += kThreads) {
    const bool ev = evict[base + i];
    if (ev) freed_p = __fadd_rn(freed_p, size[base + i]);
    if (idle[base + i]) avail_p = __fadd_rn(avail_p, size[base + i]);
    if (!(valid[base + i] && !ev)) ins_p = min(ins_p, i);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  freed_p = warp_sum(freed_p);
  avail_p = warp_sum(avail_p);
  ins_p = warp_min(ins_p);
  if (lane == 0) {
    r_freed[warp] = freed_p;
    r_avail[warp] = avail_p;
    r_ins[warp] = ins_p;
  }
  __syncthreads();
  if (warp == 0) {
    freed_p = lane < kWarps ? r_freed[lane] : 0.0f;
    avail_p = lane < kWarps ? r_avail[lane] : 0.0f;
    ins_p = lane < kWarps ? r_ins[lane] : S;
    freed_p = warp_sum(freed_p);
    avail_p = warp_sum(avail_p);
    ins_p = warp_min(ins_p);
    if (lane == 0) {
      freed[row] = freed_p;
      avail[row] = avail_p;
      ins[row] = ins_p < S ? ins_p : 0;
      empty[row] = ins_p < S;
    }
  }
}

}  // namespace

extern "C" int evict_place_launch(const float* pri, const float* seq,
                                  const float* size, const uint8_t* idle,
                                  const uint8_t* valid, const float* deficit,
                                  uint8_t* evict, float* freed, int32_t* ins,
                                  float* avail, uint8_t* empty, int P, int S,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(S);
  const dim3 grid((S + kTile - 1) / kTile, P);
  rank_kernel<<<grid, kTile, smem, st>>>(pri, seq, size, idle, deficit,
                                         evict, S);
  reduce_kernel<<<P, kThreads, 0, st>>>(size, idle, valid, evict, freed, ins,
                                        avail, empty, S);
  return static_cast<int>(cudaGetLastError());
}
