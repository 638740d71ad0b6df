// Decode attention for Hopper, hand-written in CUDA C++ (split-KV).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_kernel
// (pallas_call at :86, wrapper decode_attention_pallas :69).  Same
// function: one query token per sequence against a (ring) KV cache with
// GQA; a slot is visible when 0 <= slot_pos <= cur and, with a window,
// slot_pos > cur - window; f32 online softmax with a finite NEG_INF and a
// max(l, 1e-30) denominator.  Not carried over block by block: the Pallas
// grid walks the cache sequentially per (b, kv head), which on this card
// would light B * KV SMs (4 on the serving path).  Here the cache is cut
// into chunks of 128 slots, one block per (chunk, kv head, b) holding the
// G query heads of the group, and a second kernel combines the chunks'
// partial (max, sum, weighted values).  A block first stages its visible
// K and V rows in shared memory with asynchronous 16-byte copies (a first
// version read them inside its loops and waited on each load in turn),
// then computes the scores a thread a slot and the weighted values a
// thread a column.
//
// What bounds it on this card: bytes.  Each visible slot's K and V rows
// must be read once (2 * D * KV * itemsize a slot), against 4 * D
// operations a slot and query head.  A slot that is not visible is never
// read: only slot_pos is, so a cache that is mostly empty (the serving
// path decodes at positions ~32-40 of 4,096 slots) costs the bytes of its
// filled slots, not of its size.  A query row that sees no slot at all
// gets, as in the reference, the mean of all V rows: the combine kernel
// computes it in that case only.
//
// Inputs are contiguous q [B, H, D], k/v [B, S, KV, D] in bf16 or f32,
// slot_pos i32 [B, S], cur i32 [B]; output [B, H, D] in q's dtype; q, k
// and v 16-byte aligned.  Scratch: m, l f32 [B, KV, n_chunks, G] and acc
// f32 [B, KV, n_chunks, G, D].  D is 64 or 128; S up to 6,144 chunks;
// G = H / KV up to 64.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int CHUNK = 128;    // cache slots a block
constexpr int NT = 128;       // threads a block: four warps
constexpr int HG = 16;        // query heads a thread accumulates at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// eight consecutive elements from a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int* __restrict__ slot_pos,
                    const int* __restrict__ cur, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int S, int H, int KV, float scale, int window) {
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

  // weighted values: thread column d, heads tid / D + TPD * i
  const int d = tid % D, h0 = tid / D;
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

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const T* __restrict__ vc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ o,
                      int S, int H, int KV, int n_chunks) {
  // a block a (head, sequence), a thread a column; the chunks' maxima are
  // loaded all at once into shared memory, and only the chunks that saw a
  // slot are read for their sums
  constexpr int NW = D / 32;
  extern __shared__ float wts[];                     // [n_chunks]
  int* list = reinterpret_cast<int*>(wts + n_chunks);  // [n_chunks]
  __shared__ float red[NW];
  __shared__ int count;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int lane = d % 32, warp = d / 32;
  const int G = H / KV, kvh = h / G, g = h % G;
  const size_t base = ((size_t)b * KV + kvh) * n_chunks;
  float m = NEG_INF;
  for (int i = d; i < n_chunks; i += D) {
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
    const size_t row = (size_t)KV * D;
    const T* vb = vc + (size_t)b * S * row + (size_t)kvh * D + d;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += to_f32(vb[(size_t)s * row]);
    out = sum / (float)S;
  } else {
    for (int i = d; i < n_chunks; i += D) {
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
    float l = 0.f, acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const int i = list[k];
      const float w = wts[i];
      l = fmaf(w, part_l[(base + i) * G + g], l);
      acc = fmaf(w, part_acc[((base + i) * G + g) * D + d], acc);
    }
    out = acc / fmaxf(l, 1e-30f);
  }
  store(o + ((size_t)b * H + h) * D + d, out);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* sp,
           const int* cur, float* pm, float* pl, float* pa, void* o, int B,
           int S, int H, int KV, float scale, int window,
           cudaStream_t stream) {
  const int G = H / KV;
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  const size_t smem = (size_t)G * (D + CHUNK) * sizeof(float)
                      + 2 * CHUNK * (D * sizeof(T) + 16)
                      + CHUNK * sizeof(int);
  auto split = decode_split_kernel<T, D>;
  // raise the kernel's shared-memory limit only when a launch needs more
  // than an earlier one did: the call costs host time on every launch
  static size_t smem_set = 0;
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  split<<<dim3(n_chunks, KV, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sp, cur, pm, pl, pa, S, H, KV, scale,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, D><<<dim3(H, B), D,
                                 2 * n_chunks * sizeof(float), stream>>>(
      static_cast<const T*>(v), pm, pl, pa, static_cast<T*>(o), S, H, KV,
      n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_chunk() { return CHUNK; }

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means none.  Returns the
// CUDA error of the launches (0 on success); -1 for an unsupported D/dtype.
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
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, slot_pos, cur, part_m, part_l,
                              part_acc, o, B, S, H, KV, scale, window, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, slot_pos, cur, part_m, part_l,
                                     part_acc, o, B, S, H, KV, scale, window,
                                     st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, slot_pos, cur, part_m,
                                      part_l, part_acc, o, B, S, H, KV,
                                      scale, window, st);
  return -1;
}
