// Decode attention for Hopper, hand-written in CUDA C++ (split-KV).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (:30; pallas_call at :86, wrapper decode_attention_pallas :69).  Same
// function: one query token per sequence against a (ring) KV cache with
// GQA; a slot is visible when 0 <= slot_pos <= cur and, with a window,
// slot_pos > cur - window; f32 online softmax with a finite NEG_INF and a
// max(l, 1e-30) denominator.  Not carried over block by block: the Pallas
// grid walks the cache sequentially per (b, kv head), which on this card
// would light B * KV SMs (4 on the serving path).  Here the cache is cut
// into chunks of 128 slots, one block per (chunk, kv head, b) holding the
// G query heads of the group, and a second kernel (decode_combine_kernel)
// combines the chunks' partial (max, sum, weighted values).  A chunk with
// no visible slot exits after reading its slot_pos.
//
// What bounds it on this card: bytes.  Each visible slot's K and V rows
// must be read once (2 * D * KV * itemsize a slot), against 4 * D
// operations a slot and query head.  A slot that is not visible is never
// read: only slot_pos is, so a cache that is mostly empty (the serving
// path decodes at positions ~32-40 of 4,096 slots) costs the bytes of its
// filled slots, not of its size.  At those sizes the launches' latency
// and each block's chain of dependent steps bound it, not the bytes.  A
// query row that sees no slot at all gets, as in the reference, the mean
// of all V rows: the combine kernel computes it in that case only.
//
// bf16 (every call the serving path makes): decode_mma_kernel, on the
// tensor cores, all four warps busy.  The group's G query heads are the M
// rows of mma.sync.m16n8k16 (bf16 in, f32 accumulate), padded with zero
// rows to 16 * MT (MT = 1 for G <= 16, 3 for G = 48) that are never
// stored; q is staged in shared memory as bf16, pre-scaled in its own
// dtype as the reference oracle scales it.  The visible K and V rows
// arrive by asynchronous 16-byte copies (cp.async) into rows padded to
// D + 8 so that ldmatrix spreads over the banks; invisible V rows inside a
// 16-slot step that has a visible one are zero-filled, and steps with no
// visible slot are skipped.  Scores: each warp takes 32 of the chunk's
// slots, S [16 MT x 32] = Q K^T over D / 16 steps (K by ldmatrix).
// Softmax: invisible slots at NEG_INF, each row's max and sum reduced
// over a quad by shuffles and across the four warps in shared memory;
// P is rounded to bf16 (as the oracle's p.astype(v.dtype)) into shared
// memory.  Values: each warp takes up to ceil(D / 64) 16-column groups
// (D = 112, kimi-k2's, has 7 groups: the last warp takes one), acc
// [16 MT x 32] = P V over the chunk's 16-slot steps (P by ldmatrix, V by
// ldmatrix.trans), so no warp's accumulator grows with G and none is
// summed across warps.
//
// f32 (the tests' dtype, held at 2e-5, which TF32 tensor cores cannot
// meet): decode_fma_kernel, the same staging, then scores a thread a slot
// and weighted values a thread a column, as f32 FMAs.
//
// Inputs are contiguous q [B, H, D], k/v [B, S, KV, D] in bf16 or f32,
// slot_pos i32 [B, S], cur i32 [B]; output [B, H, D] in q's dtype; q, k
// and v 16-byte aligned.  Scratch: m, l f32 [B, KV, n_chunks, G] and acc
// f32 [B, KV, n_chunks, G, D].  D is 64, 112 or 128; S up to 6,144 chunks;
// G = H / KV up to 64.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 128;    // cache slots a block
constexpr int NT = 128;       // threads a block: four warps
constexpr int HG = 16;        // query heads a thread accumulates at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// eight consecutive floats from a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync over the GQA group
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, int MT>
constexpr size_t mma_smem_bytes() {
  // K and V [CHUNK][D + 8], q [16 MT][D + 8] and P [16 MT][CHUNK + 8], bf16
  return 2 * (2 * CHUNK * (D + 8) + 16 * MT * (D + 8) + 16 * MT * (CHUNK + 8));
}

template <int D, int MT>
__global__ void __launch_bounds__(NT)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ kc,
                  const __nv_bfloat16* __restrict__ vc,
                  const int* __restrict__ slot_pos,
                  const int* __restrict__ cur, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int S, int H, int KV, float scale, int window) {
  constexpr int M = 16 * MT;                // padded group rows
  constexpr int DP = D + 8;                 // row pitches (bf16), padded so
  constexpr int PP = CHUNK + 8;             // ldmatrix rows hit all banks
  constexpr int NW = NT / 32;
  constexpr int NG = D / 16;                // 16-column groups of values
  constexpr int GPW = (NG + NW - 1) / NW;   // groups a warp (the last
  constexpr int NJ = 2 * GPW;               //   warp's may run out); n8
  static_assert(CHUNK == NW * 32 && D % 16 == 0, "tiling");   // tiles
  const int G = H / KV;
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int s0 = chunk * CHUNK;
  const int n = min(CHUNK, S - s0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;

  extern __shared__ float4 smem4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* vs = ks + CHUNK * DP;
  __nv_bfloat16* qs = vs + CHUNK * DP;
  __nv_bfloat16* ps = qs + M * DP;
  __shared__ int vis[CHUNK];
  __shared__ unsigned step_mask;            // bit i: slots 16i.. visible
  __shared__ float red_m[NW][M], red_l[NW][M];

  // visibility: a thread a slot (CHUNK == NT)
  const int c = cur[b];
  int ok = 0;
  if (tid < n) {
    const int sp = slot_pos[(size_t)b * S + s0 + tid];
    ok = sp >= 0 && sp <= c && (window <= 0 || sp > c - window);
  }
  vis[tid] = ok;
  const unsigned wmask = __ballot_sync(0xffffffffu, ok);
  if (tid == 0) step_mask = 0;
  __syncthreads();
  if (lane == 0 && wmask)
    atomicOr(&step_mask, ((wmask & 0xffffu) ? 1u : 0u) << (2 * warp) |
                             ((wmask >> 16) ? 1u : 0u) << (2 * warp + 1));
  __syncthreads();
  const unsigned steps = step_mask;

  const size_t part = ((size_t)b * KV + kvh) * n_chunks + chunk;
  if (steps == 0) {              // nothing to read: an empty partial
    for (int i = tid; i < G; i += NT) {
      part_m[part * G + i] = NEG_INF;
      part_l[part * G + i] = 0.f;
    }
    return;
  }

  // stage the visible K and V rows; zero V's invisible rows inside a
  // 16-slot step that is read (P is 0 there, and 0 * NaN would not be)
  const size_t row = (size_t)KV * D;
  const __nv_bfloat16* kb = kc + ((size_t)b * S + s0) * row + (size_t)kvh * D;
  const __nv_bfloat16* vb = vc + ((size_t)b * S + s0) * row + (size_t)kvh * D;
  constexpr int VPR = D / 8;                // 16-byte vectors a row
  for (int i = tid; i < CHUNK * VPR; i += NT) {
    const int j = i / VPR, e = i % VPR * 8;
    if (vis[j]) {
      __pipeline_memcpy_async(ks + j * DP + e, kb + (size_t)j * row + e, 16);
      __pipeline_memcpy_async(vs + j * DP + e, vb + (size_t)j * row + e, 16);
    } else if (steps >> (j / 16) & 1u) {
      *reinterpret_cast<uint4*>(vs + j * DP + e) = make_uint4(0, 0, 0, 0);
    }
  }
  __pipeline_commit();
  // meanwhile the group's queries, scaled in bf16; padded rows are zero
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < M * VPR; i += NT) {
    const int r = i / VPR, e = i % VPR * 8;
    uint4 out = make_uint4(0, 0, 0, 0);
    if (r < G) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qb + r * D + e);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
      __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(x[u]);
        y[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
    *reinterpret_cast<uint4*>(qs + r * DP + e) = out;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // scores: this warp's slots 32 warp .. + 31, as four n8 tiles;
  // s[mi][j] = rows 16 mi + g (+ 8), slots 32 warp + 8 j + 2 t (+ 1)
  float s[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
  const uint32_t qs_a = smem_u32(qs), ks_a = smem_u32(ks);
  const uint32_t vs_a = smem_u32(vs), ps_a = smem_u32(ps);
  if (wmask) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb4[2][4];   // b0, b1 of tiles (0, 1) and (2, 3)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int r = 32 * warp + 8 * (2 * jp + lane / 16) + lane % 8;
        ldsm_x4(ks_a + 2 * (r * DP + 16 * kk + (lane / 8 % 2) * 8), kb4[jp]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        uint32_t a[4];
        ldsm_x4(qs_a + 2 * ((16 * mi + lane % 16) * DP + 16 * kk +
                            (lane / 16) * 8), a);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(s[mi][j], a, kb4[j / 2][2 * (j % 2)],
                   kb4[j / 2][2 * (j % 2) + 1]);
      }
    }
  }
  // mask, and each row's max over this warp's slots
  bool v2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) v2[j][e] = vis[32 * warp + 8 * j + 2 * t + e];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mi][j][e] = v2[j][e % 2] ? s[mi][j][e] : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[mi][j][e]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      if (t == 0) red_m[warp][16 * mi + g + 8 * hh] = mx[hh];
    }
  }
  __syncthreads();
  // the chunk's max; weights (0 where not visible) to P in bf16, and sums
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * mi + g + 8 * hh;
      float m = red_m[0][r];
#pragma unroll
      for (int w = 1; w < NW; ++w) m = fmaxf(m, red_m[w][r]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = v2[j][0] ? expf(s[mi][j][2 * hh] - m) : 0.f;
        const float p1 = v2[j][1] ? expf(s[mi][j][2 * hh + 1] - m) : 0.f;
        sum += p0 + p1;
        *reinterpret_cast<__nv_bfloat162*>(
            ps + r * PP + 32 * warp + 8 * j + 2 * t) =
            __floats2bfloat162_rn(p0, p1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t == 0) red_l[warp][r] = sum;
      if (warp == 0 && t == 0 && r < G) part_m[part * G + r] = m;
    }
  }
  __syncthreads();
  for (int r = tid; r < G; r += NT) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) l += red_l[w][r];
    part_l[part * G + r] = l;
  }

  // weighted values: this warp's groups warp GPW .. + GPW - 1 (those
  // below NG: columns n0 .. n0 + 16 GPW - 1, fewer in the last warp at
  // D = 112), over the chunk's 16-slot steps that hold a visible slot
  const int n0 = warp * GPW * 16;
  const int my_groups = min(GPW, NG - warp * GPW);   // warp-uniform
  float acc[MT][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    if (!(steps >> kk & 1u)) continue;
    uint32_t vb4[NJ / 2][4];   // b0, b1 of tiles (2 jp, 2 jp + 1)
#pragma unroll
    for (int jp = 0; jp < NJ / 2; ++jp) {
      if (jp >= my_groups) break;
      const int r = 16 * kk + (lane / 8 % 2) * 8 + lane % 8;
      ldsm_x4_trans(vs_a + 2 * (r * DP + n0 + 8 * (2 * jp + lane / 16)),
                    vb4[jp]);
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      uint32_t a[4];
      ldsm_x4(ps_a + 2 * ((16 * mi + lane % 16) * PP + 16 * kk +
                          (lane / 16) * 8), a);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j / 2 >= my_groups) break;
        mma_bf16(acc[mi][j], a, vb4[j / 2][2 * (j % 2)],
                 vb4[j / 2][2 * (j % 2) + 1]);
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * mi + g + 8 * hh;
      if (r >= G) continue;
      float* out = part_acc + (part * G + r) * D + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j / 2 >= my_groups) break;
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[mi][j][2 * hh], acc[mi][j][2 * hh + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT)
decode_fma_kernel(const float* __restrict__ q, const float* __restrict__ kc,
                  const float* __restrict__ vc,
                  const int* __restrict__ slot_pos,
                  const int* __restrict__ cur, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int S, int H, int KV, float scale, int window) {
  using T = float;
  static_assert(CHUNK == NT, "a thread a slot in the score pass");
  constexpr int TPD = NT / D;               // threads sharing a column
  const int G = H / KV;
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int s0 = chunk * CHUNK;
  const int n = min(CHUNK, S - s0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte vector
  constexpr int DP = D + VEC;               // padded row: lanes spread banks
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [G][D], scaled
  float* ps = qs + G * D;            // [G][CHUNK] scores, then weights
  T* ks = reinterpret_cast<T*>(ps + G * CHUNK);  // [CHUNK][DP] visible rows
  T* vs = ks + CHUNK * DP;
  int* vis = reinterpret_cast<int*>(vs + CHUNK * DP);   // [CHUNK]
  __shared__ int any_visible;

  const int c = cur[b];
  if (tid == 0) any_visible = 0;
  __syncthreads();
  for (int j = tid; j < CHUNK; j += NT) {
    int ok = 0;
    if (j < n) {
      const int sp = slot_pos[(size_t)b * S + s0 + j];
      ok = sp >= 0 && sp <= c && (window <= 0 || sp > c - window);
    }
    vis[j] = ok;
    if (ok) any_visible = 1;
  }
  __syncthreads();

  const size_t part = ((size_t)b * KV + kvh) * n_chunks + chunk;
  if (!any_visible) {            // nothing to read: an empty partial
    for (int g = tid; g < G; g += NT) {
      part_m[part * G + g] = NEG_INF;
      part_l[part * G + g] = 0.f;
    }
    return;
  }

  const size_t row = (size_t)KV * D;
  const T* kb = kc + ((size_t)b * S + s0) * row + (size_t)kvh * D;
  const T* vb = vc + ((size_t)b * S + s0) * row + (size_t)kvh * D;

  // stage the visible K and V rows in shared memory: asynchronous 16-byte
  // copies, all in flight at once (a copy through registers waits on
  // each load before its store, which serialised them)
  for (int i = tid; i < n * (D / VEC); i += NT) {
    const int j = i / (D / VEC), c = i % (D / VEC) * VEC;
    if (!vis[j]) continue;
    __pipeline_memcpy_async(ks + j * DP + c, kb + (size_t)j * row + c, 16);
    __pipeline_memcpy_async(vs + j * DP + c, vb + (size_t)j * row + c, 16);
  }
  __pipeline_commit();
  // meanwhile the group's queries, scaled, as f32
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D / 8; i += NT) {
    float x[8];
    load8(qb + i * 8, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) qs[i * 8 + e] = x[e] * scale;
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  // scores: a thread a slot (CHUNK == NT), HG heads at a time; q is a
  // broadcast read, the K row 16-byte vector reads
  for (int j = tid; j < n; j += NT) {
    if (!vis[j]) continue;
    const T* krow = ks + j * DP;
    for (int g0 = 0; g0 < G; g0 += HG) {
      float acc[HG];
#pragma unroll
      for (int i = 0; i < HG; ++i) acc[i] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 8) {
        float kv[8];
        load8(krow + d0, kv);
#pragma unroll
        for (int i = 0; i < HG; ++i) {
          if (g0 + i < G) {
            const float4* q4 =
                reinterpret_cast<const float4*>(qs + (g0 + i) * D + d0);
            const float4 a = q4[0], c4 = q4[1];
            acc[i] = fmaf(a.x, kv[0], acc[i]);
            acc[i] = fmaf(a.y, kv[1], acc[i]);
            acc[i] = fmaf(a.z, kv[2], acc[i]);
            acc[i] = fmaf(a.w, kv[3], acc[i]);
            acc[i] = fmaf(c4.x, kv[4], acc[i]);
            acc[i] = fmaf(c4.y, kv[5], acc[i]);
            acc[i] = fmaf(c4.z, kv[6], acc[i]);
            acc[i] = fmaf(c4.w, kv[7], acc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < HG; ++i)
        if (g0 + i < G) ps[(g0 + i) * CHUNK + j] = acc[i];
    }
  }
  __syncthreads();

  // per head: the chunk's max and sum; weights in place (0 if not visible)
  for (int g = warp; g < G; g += NT / 32) {
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32)
      if (vis[j]) mx = fmaxf(mx, ps[g * CHUNK + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = vis[j] ? expf(ps[g * CHUNK + j] - mx) : 0.f;
      ps[g * CHUNK + j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      part_m[part * G + g] = mx;
      part_l[part * G + g] = sum;
    }
  }
  __syncthreads();

  // weighted values: thread column d, heads tid / D + TPD * i; at D = 112
  // the threads from TPD D on have no column
  const int d = tid % D, h0 = tid / D;
  if (tid >= TPD * D) return;
  for (int gb = 0; gb < G; gb += HG * TPD) {
    float acc[HG];
#pragma unroll
    for (int i = 0; i < HG; ++i) acc[i] = 0.f;
    for (int j = 0; j < n; ++j) {
      if (!vis[j]) continue;
      const float vv = to_f32(vs[j * DP + d]);
#pragma unroll
      for (int i = 0; i < HG; ++i) {
        const int g = gb + h0 + TPD * i;
        if (g < G) acc[i] = fmaf(ps[g * CHUNK + j], vv, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < HG; ++i) {
      const int g = gb + h0 + TPD * i;
      if (g < G) part_acc[(part * G + g) * D + d] = acc[i];
    }
  }
}

// threads of a combine block: a column each, in whole warps (D = 112
// leaves the last 16 without a column; they join the reductions)
template <int D>
__host__ __device__ constexpr int combine_threads() {
  return (D + 31) / 32 * 32;
}

template <typename T, int D>
__global__ void __launch_bounds__(combine_threads<D>())
decode_combine_kernel(const T* __restrict__ vc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ o,
                      int S, int H, int KV, int n_chunks) {
  // a block a (head, sequence), a thread a column; the chunks' maxima are
  // loaded all at once into shared memory, and only the chunks that saw a
  // slot are read for their sums
  constexpr int NTH = combine_threads<D>();
  constexpr int NW = NTH / 32;
  extern __shared__ float wts[];                     // [n_chunks]
  int* list = reinterpret_cast<int*>(wts + n_chunks);  // [n_chunks]
  __shared__ float red[NW];
  __shared__ int count;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = d % 32, warp = d / 32;
  const bool col = d < D;            // this thread owns column d
  const int G = H / KV, kvh = h / G, g = h % G;
  const size_t base = ((size_t)b * KV + kvh) * n_chunks;
  float m = NEG_INF;
  for (int i = d; i < n_chunks; i += NTH) {
    const float mi = part_m[(base + i) * G + g];
    wts[i] = mi;
    m = fmaxf(m, mi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) m = fmaxf(m, red[w]);

  float out;
  if (m <= NEG_INF) {
    // no visible slot: the reference's softmax over all-NEG_INF scores is
    // uniform, so the output is the mean of every V row
    if (!col) return;
    const size_t row = (size_t)KV * D;
    const T* vb = vc + (size_t)b * S * row + (size_t)kvh * D + d;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += to_f32(vb[(size_t)s * row]);
    out = sum / (float)S;
  } else {
    for (int i = d; i < n_chunks; i += NTH) {
      const float mi = wts[i];
      wts[i] = mi <= NEG_INF ? 0.f : expf(mi - m);   // empty chunk: 0
    }
    __syncthreads();
    if (warp == 0) {               // compact the chunks with a weight
      int n = 0;
      for (int i0 = 0; i0 < n_chunks; i0 += 32) {
        const int i = i0 + lane;
        const bool keep = i < n_chunks && wts[i] != 0.f;
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        if (keep) list[n + __popc(mask & ((1u << lane) - 1u))] = i;
        n += __popc(mask);
      }
      if (lane == 0) count = n;
    }
    __syncthreads();
    if (!col) return;
    // eight chunks' loads in flight before their sums: a load a chunk in
    // turn left the loop waiting on each (~6 us over 32 chunks)
    float l = 0.f, acc = 0.f;
    int k = 0;
    for (; k + 8 <= count; k += 8) {
      float w[8], pl[8], pa[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = list[k + u];
        w[u] = wts[i];
        pl[u] = part_l[(base + i) * G + g];
        pa[u] = part_acc[((base + i) * G + g) * D + d];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        l = fmaf(w[u], pl[u], l);
        acc = fmaf(w[u], pa[u], acc);
      }
    }
    for (; k < count; ++k) {
      const int i = list[k];
      const float w = wts[i];
      l = fmaf(w, part_l[(base + i) * G + g], l);
      acc = fmaf(w, part_acc[((base + i) * G + g) * D + d], acc);
    }
    out = acc / fmaxf(l, 1e-30f);
  }
  store(o + ((size_t)b * H + h) * D + d, out);
}

template <int D, int MT>
int launch_mma(const void* q, const void* k, const void* v, const int* sp,
               const int* cur, float* pm, float* pl, float* pa, int B, int S,
               int H, int KV, float scale, int window, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D, MT>();
  auto split = decode_mma_kernel<D, MT>;
  static PerDeviceAttr smem_set;      // once a device: costs host time
  const int attr_rc = smem_set.ensure(smem, [&] {
    return cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (attr_rc != 0) return attr_rc;
  split<<<dim3((S + CHUNK - 1) / CHUNK, KV, B), NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), sp, cur, pm, pl, pa, S, H, KV,
      scale, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const int* sp,
               const int* cur, float* pm, float* pl, float* pa, int B, int S,
               int H, int KV, float scale, int window, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = (size_t)G * (D + CHUNK) * sizeof(float)
                      + 2 * CHUNK * (D * sizeof(float) + 16)
                      + CHUNK * sizeof(int);
  auto split = decode_fma_kernel<D>;
  // raise the kernel's shared-memory limit on this device only when a
  // launch needs more than an earlier one did: the call costs host time
  static PerDeviceAttr smem_set;
  const int attr_rc = smem_set.ensure(smem, [&] {
    return cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (attr_rc != 0) return attr_rc;
  split<<<dim3((S + CHUNK - 1) / CHUNK, KV, B), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), sp, cur, pm, pl, pa, S, H, KV, scale,
      window);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* sp,
           const int* cur, float* pm, float* pl, float* pa, void* o, int B,
           int S, int H, int KV, float scale, int window,
           cudaStream_t stream) {
  const int G = H / KV;
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  int rc;
  if constexpr (sizeof(T) == 4) {
    rc = launch_fma<D>(q, k, v, sp, cur, pm, pl, pa, B, S, H, KV, scale,
                       window, stream);
  } else {
    switch ((G + 15) / 16) {   // the group's rows in tiles of 16
      case 1: rc = launch_mma<D, 1>(q, k, v, sp, cur, pm, pl, pa, B, S, H,
                                    KV, scale, window, stream); break;
      case 2: rc = launch_mma<D, 2>(q, k, v, sp, cur, pm, pl, pa, B, S, H,
                                    KV, scale, window, stream); break;
      case 3: rc = launch_mma<D, 3>(q, k, v, sp, cur, pm, pl, pa, B, S, H,
                                    KV, scale, window, stream); break;
      case 4: rc = launch_mma<D, 4>(q, k, v, sp, cur, pm, pl, pa, B, S, H,
                                    KV, scale, window, stream); break;
      default: return -1;
    }
  }
  if (rc != 0) return rc;
  decode_combine_kernel<T, D><<<dim3(H, B), combine_threads<D>(),
                                 2 * n_chunks * sizeof(float), stream>>>(
      static_cast<const T*>(v), pm, pl, pa, static_cast<T*>(o), S, H, KV,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_chunk() { return CHUNK; }

// dtype: 0 = float32 (decode_fma_kernel), 1 = bfloat16 (decode_mma_kernel);
// then decode_combine_kernel.  window <= 0 means none.  Returns the CUDA
// error of the launches (0 on success); -1 for an unsupported D/dtype/G.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* slot_pos,
                                       const int* cur, float* part_m,
                                       float* part_l, float* part_acc,
                                       void* o, int B, int S, int H, int KV,
                                       int D, int dtype, float scale,
                                       int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, slot_pos, cur, part_m, part_l,
                             part_acc, o, B, S, H, KV, scale, window, st);
  if (dtype == 0 && D == 112)
    return launch<float, 112>(q, k, v, slot_pos, cur, part_m, part_l,
                              part_acc, o, B, S, H, KV, scale, window, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, slot_pos, cur, part_m, part_l,
                              part_acc, o, B, S, H, KV, scale, window, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, slot_pos, cur, part_m, part_l,
                                     part_acc, o, B, S, H, KV, scale, window,
                                     st);
  if (dtype == 1 && D == 112)
    return launch<__nv_bfloat16, 112>(q, k, v, slot_pos, cur, part_m,
                                      part_l, part_acc, o, B, S, H, KV,
                                      scale, window, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, slot_pos, cur, part_m,
                                      part_l, part_acc, o, B, S, H, KV,
                                      scale, window, st);
  return -1;
}
