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
// What bounds it on this card: the function moves ~15 B a slot, so its
// bound is a few nanoseconds; the counting does 2 n^2 pair tests a row
// (n the idle slots), each two integer compares on the half-rate ALU
// pipe, and what a launch costs is each thread's chain of pair tests,
// the latency of the row's loads, the cluster barrier and the launch
// itself.  Design: ONE launch of one kernel.
//
// * Each pool row is one thread-block cluster of C = min(16,
//   ceil(S / 64)) blocks: 32 SMs at [2, 1024], 128 at [32, 256].  16 is
//   the most an H100 takes, beyond the portable 8, so the launch allows
//   a non-portable cluster size (16 blocks of 64 slots measured faster
//   than 8 of 128 at [2, 1024]; PERF.md section 6).
// * Every block loads the whole row, four consecutive slots a thread (as
//   16-byte vectors when the row is aligned), and compacts its idle
//   slots in slot order into shared memory by a block-wide scan of their
//   counts (14 B a slot: the packed key, the size, the slot number with
//   its valid bit; 56 KB at MAX_SLOTS = 4096): slots that are not idle
//   add nothing to any sum and are never evicted, so only the n idle
//   ones are ranked, against each other.
//   The key is one order-preserving uint64: the f32 bits of pri made
//   monotone in the high word, seq's in the low word, so the lex test is
//   one 64-bit compare.  pri and seq are first canonicalised with
//   x + 0.0f, since -0.0 == +0.0 under the float compare but not under
//   the bits; +-inf order as floats do.  NaN has no place in a total
//   order and is outside the contract (the priorities never are NaN).
// * Block rank b ranks the compacted slots [b * ceil(n / C), ...).  Eight
//   threads rank each slot, each over every eighth pair of j, and each
//   thread ranks two slots against every j it loads, so a thread walks
//   n / 8 keys with two shared loads (a 16-byte pair of keys and 8 bytes
//   of sizes) for four pair tests.  The eight partial sums meet by
//   __shfl_xor_sync.  All sums are __fadd_rn, exact on whole MB in any
//   order.  Block b also clears evict on the slots [b * ceil(S / C), ...)
//   that are not idle.
// * The row's reductions (freed, avail, the least empty slot) are taken
//   per block, and each block writes its partial into block rank 0's
//   shared memory (distributed shared memory, after a cluster barrier
//   that was arrived at on entry and so costs no wait); one
//   cluster.sync() later rank 0 sums them and writes the row's outputs.
//   No second kernel and no global atomics.
//
// Launched with cudaLaunchKernelEx and the cluster-dimension attribute
// (runtime API, no -lcuda).  C interface (no PyTorch headers), bound with
// ctypes by repro_torch/kernels/_build.py.  Bool masks arrive as their
// 1-byte storage.  The launch goes to `device` (the tensors'), whichever
// device is current, and the kernel's attributes are set once on each
// device (per_device.cuh).  Returns the launch's CUDA error (0 on
// success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                     // threads ranking one slot
constexpr int kPerThread = 2;                 // slots a thread ranks
constexpr int kGroups = kThreads / kLanes;    // slot groups a block
constexpr int kPass = kGroups * kPerThread;   // slots a block ranks a pass
constexpr int kJStep = 2 * kLanes;            // keys a slot's lanes load a step
constexpr int kSlotsPerBlock = 64;            // sets C
constexpr int kMaxCluster = 16;               // an H100's most
constexpr int kMaxSlots = 4096;               // MAX_SLOTS in pool_step.py

__device__ __forceinline__ uint32_t monotone(float x) {
  const uint32_t u = __float_as_uint(__fadd_rn(x, 0.0f));   // -0 -> +0
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ uint64_t pack_key(float pri, float seq) {
  return (static_cast<uint64_t>(monotone(pri)) << 32) | monotone(seq);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Partial {      // one block's share of a row's reductions
  float freed, avail;
  int ins;            // S = no empty slot seen
};

constexpr int kValidBit = 1 << 15;   // in a compacted slot number

// Shared memory: the idle slots compacted, keys uint64[Sp], sizes f32[Sp]
// and slot numbers uint16[Sp] (kValidBit set when the slot is valid),
// padded to Sp = padded(S) by keys that are never less and no bytes.
__host__ __device__ constexpr int padded(int S) {
  return (S + kJStep - 1) / kJStep * kJStep;
}
__host__ __device__ constexpr size_t smem_bytes(int S) {
  return 14 * static_cast<size_t>(padded(S));
}

__global__ void __launch_bounds__(kThreads)
evict_place_kernel(const float* __restrict__ pri,
                   const float* __restrict__ seq,
                   const float* __restrict__ size,
                   const uint8_t* __restrict__ idle,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ deficit,
                   uint8_t* __restrict__ evict, float* __restrict__ freed,
                   int32_t* __restrict__ ins, float* __restrict__ avail,
                   uint8_t* __restrict__ empty, int S, int span, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int w_total[2][kWarps];
  __shared__ float r_freed[kWarps], r_avail[kWarps];
  __shared__ int r_ins[kWarps];
  __shared__ Partial parts[kMaxCluster];   // rank 0's gather every rank's
  const int Sp = padded(S);
  uint64_t* c_key = reinterpret_cast<uint64_t*>(smem);
  float* c_sz = reinterpret_cast<float*>(c_key + Sp);
  uint16_t* c_slot = reinterpret_cast<uint16_t*>(c_sz + Sp);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  const int tid = threadIdx.x, wl = tid & 31, warp = tid >> 5;
  // arrive now, wait before touching rank 0's shared memory: by then
  // every block of the cluster has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const size_t base = static_cast<size_t>(row) * S;
  const float limit = __fsub_rn(deficit[row], 1e-9f);
  const int lo = rank * span, hi = min(S, lo + span);   // slots to clear
  float freed_p = 0.0f, avail_p = 0.0f;
  int ins_p = S;

  // 1. load the row, 4 consecutive slots a thread a round (16-byte loads
  // when the row is aligned), and compact its idle slots in slot order
  // by a block-wide scan of their counts.  Slots that are not idle in
  // this block's range [lo, hi) are never evicted.
  int n = 0;
  for (int r0 = 0, buf = 0; r0 < S; r0 += 4 * kThreads, buf ^= 1) {
    const int j0 = r0 + 4 * tid;
    float p[4], q[4], z[4];
    bool id[4], va[4];
    if (vec && j0 < S) {
      const float4 p4 = *reinterpret_cast<const float4*>(pri + base + j0);
      const float4 q4 = *reinterpret_cast<const float4*>(seq + base + j0);
      const float4 z4 = *reinterpret_cast<const float4*>(size + base + j0);
      const uchar4 i4 = *reinterpret_cast<const uchar4*>(idle + base + j0);
      const uchar4 v4 = *reinterpret_cast<const uchar4*>(valid + base + j0);
      p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
      q[0] = q4.x; q[1] = q4.y; q[2] = q4.z; q[3] = q4.w;
      z[0] = z4.x; z[1] = z4.y; z[2] = z4.z; z[3] = z4.w;
      id[0] = i4.x; id[1] = i4.y; id[2] = i4.z; id[3] = i4.w;
      va[0] = v4.x; va[1] = v4.y; va[2] = v4.z; va[3] = v4.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        const bool in = j < S;
        p[u] = in ? pri[base + j] : 0.0f;
        q[u] = in ? seq[base + j] : 0.0f;
        z[u] = in ? size[base + j] : 0.0f;
        id[u] = in && idle[base + j];
        va[u] = in && valid[base + j];
      }
    }
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      cnt += id[u];
      if (!id[u] && j >= lo && j < hi) {
        evict[base + j] = 0;
        if (!va[u]) ins_p = min(ins_p, j);
      }
    }
    int incl = cnt;                       // inclusive scan in the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, off);
      if (wl >= off) incl += x;
    }
    if (wl == 31) w_total[buf][warp] = incl;
    __syncthreads();
    int at = n + incl - cnt;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = w_total[buf][w];
      at += w < warp ? c : 0;
      n += c;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (id[u]) {
        c_key[at] = pack_key(p[u], q[u]);
        c_sz[at] = z[u];
        c_slot[at] = static_cast<uint16_t>((j0 + u) | (va[u] ? kValidBit : 0));
        ++at;
      }
    }
  }
  const int Np = padded(n);
  for (int j = n + tid; j < Np; j += kThreads) {
    c_key[j] = ~0ull;
    c_sz[j] = 0.0f;
  }
  __syncthreads();

  // 2. rank this block's share of the idle slots against all of them
  const int cspan = (n + C - 1) / C;
  const int i_lo = rank * cspan, i_hi = min(n, i_lo + cspan);
  const int lane = tid & (kLanes - 1), grp = tid / kLanes;
  for (int i0 = i_lo; i0 < i_hi; i0 += kPass) {   // uniform over the block
    int ii[kPerThread];
    uint64_t ki[kPerThread];
    float acc[kPerThread][2];
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      ii[p] = i0 + grp + p * kGroups;
      ki[p] = c_key[min(ii[p], Np - 1)];
      acc[p][0] = acc[p][1] = 0.0f;
    }
#pragma unroll 4
    for (int j = 2 * lane; j < Np; j += kJStep) {
      const ulonglong2 kj = *reinterpret_cast<const ulonglong2*>(c_key + j);
      const float2 zj = *reinterpret_cast<const float2*>(c_sz + j);
#pragma unroll
      for (int p = 0; p < kPerThread; ++p) {
        if (kj.x < ki[p]) acc[p][0] = __fadd_rn(acc[p][0], zj.x);
        if (kj.y < ki[p]) acc[p][1] = __fadd_rn(acc[p][1], zj.y);
      }
    }
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      float before = __fadd_rn(acc[p][0], acc[p][1]);
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        before = __fadd_rn(before, __shfl_xor_sync(0xffffffffu, before, off));
      const int i = ii[p];
      if (lane == 0 && i < i_hi) {
        const int slot = c_slot[i], j = slot & (kValidBit - 1);
        const float sz = c_sz[i];
        const bool ev = before < limit;
        evict[base + j] = ev;
        if (ev) freed_p = __fadd_rn(freed_p, sz);
        avail_p = __fadd_rn(avail_p, sz);
        if (ev || !(slot & kValidBit)) ins_p = min(ins_p, j);
      }
    }
  }

  // 3. the row's reductions: the block's, then the cluster's at rank 0
  freed_p = warp_sum(freed_p);
  avail_p = warp_sum(avail_p);
  ins_p = warp_min(ins_p);
  if (wl == 0) {
    r_freed[warp] = freed_p;
    r_avail[warp] = avail_p;
    r_ins[warp] = ins_p;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid == 0) {
    Partial q{0.0f, 0.0f, S};
    for (int w = 0; w < kWarps; ++w) {
      q.freed = __fadd_rn(q.freed, r_freed[w]);
      q.avail = __fadd_rn(q.avail, r_avail[w]);
      q.ins = min(q.ins, r_ins[w]);
    }
    *cluster.map_shared_rank(parts + rank, 0) = q;
  }
  cluster.sync();              // every partial has reached rank 0
  if (rank == 0 && tid == 0) {
    Partial q{0.0f, 0.0f, S};
    for (int b = 0; b < C; ++b) {
      q.freed = __fadd_rn(q.freed, parts[b].freed);
      q.avail = __fadd_rn(q.avail, parts[b].avail);
      q.ins = min(q.ins, parts[b].ins);
    }
    freed[row] = q.freed;
    avail[row] = q.avail;
    ins[row] = q.ins < S ? q.ins : 0;
    empty[row] = q.ins < S;
  }
}

// The launch on the current device, its attributes set once there.
int launch_on_current(const float* pri, const float* seq, const float* size,
                      const uint8_t* idle, const uint8_t* valid,
                      const float* deficit, uint8_t* evict, float* freed,
                      int32_t* ins, float* avail, uint8_t* empty, int P,
                      int S, cudaStream_t stream) {
  static PerDeviceAttr attrs;
  int rc = attrs.ensure(1, [] {
    const cudaError_t err = cudaFuncSetAttribute(
        evict_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxSlots)));
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(                   // 16 > the portable 8
        evict_place_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
  });
  if (rc != 0) return rc;
  const int C =
      std::min(kMaxCluster, (S + kSlotsPerBlock - 1) / kSlotsPerBlock);
  const int span = (S + C - 1) / C;
  const auto aligned = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const int vec = S % 4 == 0 && aligned(pri, 16) && aligned(seq, 16) &&
                  aligned(size, 16) && aligned(idle, 4) && aligned(valid, 4);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, P, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(S);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, evict_place_kernel, pri, seq, size, idle, valid, deficit, evict,
      freed, ins, avail, empty, S, span, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int evict_place_launch(const float* pri, const float* seq,
                                  const float* size, const uint8_t* idle,
                                  const uint8_t* valid, const float* deficit,
                                  uint8_t* evict, float* freed, int32_t* ins,
                                  float* avail, uint8_t* empty, int P, int S,
                                  int device, void* stream) {
  // launch on the tensors' device, whichever is current, and put the
  // current device back after
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rc = launch_on_current(pri, seq, size, idle, valid, deficit,
                                   evict, freed, ins, avail, empty, P, S,
                                   static_cast<cudaStream_t>(stream));
  if (current != device) {
    err = cudaSetDevice(current);
    if (rc == 0 && err != cudaSuccess) return static_cast<int>(err);
  }
  return rc;
}
