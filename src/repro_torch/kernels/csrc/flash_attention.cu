// Flash attention (prefill) for Hopper, hand-written in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (pallas_call at :88, wrapper flash_attention_pallas :70).  Same
// function: causal and sliding-window attention with a query offset and
// GQA (query head h reads kv head h / G), an f32 online softmax, a finite
// NEG_INF mask and a max(l, 1e-30) denominator.  Not carried over block by
// block: the Pallas grid walks kv tiles sequentially on one core with the
// accumulators in VMEM; here one block owns a 64-row query tile of one
// (batch, head) and loops over 32-row kv tiles staged in shared memory.
//
// What bounds it on this card: at the long prefill shapes, operations
// (4·D multiply-adds per visible (query, key) pair; 275 GFLOP at
// Sq = Skv = 4096, H = 32, B = 2, causal), against bytes of a few hundred
// MB.  This first version does them as f32 FMAs on the CUDA cores from
// shared memory, so it sits far below the bf16 tensor-core peak the bound
// uses; mma.sync / wgmma tiles are the later step.  What the design does
// about it: register micro-tiles (4 x 2 scores, 4 x D/16 outputs a
// thread) so each shared-memory read feeds several FMAs, padded rows so
// the reads of a warp hit distinct banks, tiles loaded as 16-byte vectors
// with all of a thread's loads in flight at once (the first version
// loaded an element at a time and waited on each), and kv tiles that lie
// wholly outside the causal or window band of the query tile are never
// loaded.  At the serving path's prefill (Sq = Skv = 32) it is bound by
// launch latency.
//
// Inputs are contiguous, 16-byte aligned q [B, Sq, H, D], k/v
// [B, Skv, KV, D] in bf16 or f32; output [B, Sq, H, D] in q's dtype.  D is
// 64 or 128.  Any Sq and Skv: ragged tiles are masked.  The wrapper
// guarantees every query row sees at least one key (so skipping masked
// tiles is exact).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;        // query rows a block
constexpr int BKV = 32;       // kv rows a tile
constexpr int NT = 256;       // threads a block: a 16 x 16 grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// the 16 bytes at p (16-byte aligned) as floats: 4 f32 or 8 bf16
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  // Qs [BQ][D+1], Ks [BKV][D+1], Vs [BKV][D], Ps [BQ][BKV+1], m, l, alpha
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq,
                 int Skv, int H, int KV, float scale, int causal,
                 int window, int q_offset) {
  constexpr int DP = D + 1;         // padded row: a warp's reads differ in bank
  constexpr int PP = BKV + 1;
  constexpr int DC = D / 16;        // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BKV * DP;
  float* Ps = Vs + BKV * D;
  float* row_m = Ps + BQ * PP;
  float* row_l = row_m + BQ;
  float* row_a = row_l + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const size_t q_row = (size_t)H * D;      // stride of one position
  const size_t kv_row = (size_t)KV * D;
  const T* qb = q + ((size_t)b * Sq) * q_row + (size_t)h * D;
  const T* kb = k + ((size_t)b * Skv) * kv_row + (size_t)kvh * D;
  const T* vb = v + ((size_t)b * Skv) * kv_row + (size_t)kvh * D;

  // tiles arrive as 16-byte vectors, every load of a thread issued before
  // its first store, so their latencies overlap
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NVR = D / VEC;                 // vectors a row
  constexpr int QIT = BQ * NVR / NT;           // Q vectors a thread
  constexpr int KIT = BKV * NVR / NT;          // K (and V) vectors a thread
  static_assert(QIT * NT == BQ * NVR && KIT * NT == BKV * NVR, "tiling");
  {
    float x[QIT][VEC];
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int i = tid + it * NT, r = i / NVR, c = (i % NVR) * VEC;
      if (q0 + r < Sq)
        load16(qb + (size_t)(q0 + r) * q_row + c, x[it]);
      else
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[it][e] = 0.f;
    }
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int i = tid + it * NT, r = i / NVR, c = (i % NVR) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) Qs[r * DP + c + e] = x[it][e] * scale;
    }
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  // the kv range any row of this tile can see
  const int rows = min(BQ, Sq - q0);
  const int pos_lo = q0 + q_offset, pos_hi = q0 + rows - 1 + q_offset;
  const int kv_end = causal ? min(Skv, pos_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;

  for (int k0 = (kv_begin / BKV) * BKV; k0 < kv_end; k0 += BKV) {
    {
      float xk[KIT][VEC], xv[KIT][VEC];
#pragma unroll
      for (int it = 0; it < KIT; ++it) {
        const int i = tid + it * NT, r = i / NVR, c = (i % NVR) * VEC;
        if (k0 + r < Skv) {
          load16(kb + (size_t)(k0 + r) * kv_row + c, xk[it]);
          load16(vb + (size_t)(k0 + r) * kv_row + c, xv[it]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xk[it][e] = xv[it][e] = 0.f;
        }
      }
      __syncthreads();   // the previous tile's Ks, Vs and Ps are consumed
#pragma unroll
      for (int it = 0; it < KIT; ++it) {
        const int i = tid + it * NT, r = i / NVR, c = (i % NVR) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          Ks[r * DP + c + e] = xk[it][e];
          Vs[r * D + c + e] = xv[it][e];
        }
      }
    }
    __syncthreads();

    // scores: rows ty*4+i, kv columns tx + 16*j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r + q_offset;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        Ps[r * PP + c] = ok ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: four threads a row, eight columns each
    {
      const int r = tid >> 2, part = tid & 3;
      float* prow = Ps + r * PP + part * 8;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(prow[j] - m_new);
        prow[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V: rows ty*4+i, columns tx + 16*c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float denom = fmaxf(row_l[r], 1e-30f);
    T* orow = o + ((size_t)b * Sq + q0 + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(orow + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  static bool smem_set = false;      // once: the call costs host time
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, scale,
      causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means none.  Returns the
// CUDA error of the launch (0 on success); -1 for an unsupported D/dtype.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      int dtype, float scale, int causal,
                                      int window, int q_offset,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                             window, q_offset, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                              window, q_offset, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, Sq, Skv, H, KV, scale,
                                     causal, window, q_offset, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Skv, H, KV, scale,
                                      causal, window, q_offset, st);
  return -1;
}
