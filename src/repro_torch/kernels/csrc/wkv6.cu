// RWKV6 WKV recurrence (kernel B5) for Hopper, hand-written in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::_kernel (pallas_call
// at :74, wrapper wkv6_pallas :63).  Same function, per (batch, head),
// with a state S [D, D] (k-dim x v-dim) in f32:
//   y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(exp(-exp(w_t))) S + k_t^T v_t
// sequential in t, as the reference keeps it: the per-channel decay makes
// the parallel form need exp(+cumsum) ratios that overflow in f32.
//
// What bounds it on this card: the bytes of r, k, v, w in and y out (2
// bytes each in bf16) at every shape (~0.1 ms at S = 4096, B = 2,
// H = 64), a launch's latency and the state's 2 MB in and out at the
// serving decode (S = 1), and, in f32 on the CUDA cores, the sequential
// form's 3 D^2 operations a step and head (~0.19 ms at S = 4096).  One
// block per (batch, head) (128 blocks at the serving shape, about one an
// SM) keeps the whole state in registers for the whole sequence, so a
// step can only go as fast as one SM issues it.  The design keeps each
// step to those 3 operations a state entry and takes everything else off
// the step:
//
// * The bonus term leaves the step.  y_t = r_t S + a_t v_t with
//   a_t = sum_d r_t[d] u[d] k_t[d], a number a step that 8 threads
//   reduce (3 shuffles) for every step of a chunk at once, while the
//   chunk is converted to f32 and decay = exp(-exp(w)) computed (16-byte
//   vectors, all independent).  The step is then kv = k v, acc += r S
//   and S = decay S + kv: an FMUL and two FFMAs an entry.
// * y's sum over d leaves the step.  Thread (rg, cg) owns the RT x CT
//   tile of rows RT rg.. and columns CT cg.. of S (RT = 8, CT = 2 with
//   256 threads: r, k and decay arrive as two float4 each, v as a
//   float2, for 48 FP operations), and writes its CT partial sums of y_t
//   to shared memory; after the chunk's steps one pass adds the D / RT
//   partials of each (t, e) and a_t v_t[e], and stores y as coalesced
//   rows.  No shuffle, barrier or predicated store is left in a step:
//   the only dependence from one step to the next is one FFMA an entry,
//   and the shared loads of UT steps are issued before their FMAs.
// * r, k, v and w are staged TC steps at a time with cp.async, the next
//   chunk's copies in flight while this chunk runs (the first chunk's
//   while the state loads).  Any S: S = 1 (every decode step) is one
//   chunk of one row.
//
// Inputs are contiguous, 16-byte aligned r/k/v/w [B,S,H,64] in bf16 or
// f32 (one dtype), u [H,64] f32 and s0 [B,H,64,64] f32 (or null for
// zeros); outputs y [B,S,H,64] in r's dtype and the state [B,H,64,64] f32.
// The 8 x 2 tile and the 4 steps whose loads issue together measured
// faster than 4 x 4, 4 x 2 and 16 x 1 tiles and 2 steps (PERF.md
// section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int D = 64;                 // head dim
constexpr int TC = 32;                // steps a chunk
constexpr int RT = 8;                 // state rows a thread owns
constexpr int CT = 2;                 // state columns a thread owns
constexpr int UT = 4;                 // steps whose loads issue together
constexpr int NT = D * D / (RT * CT); // threads a block
constexpr int NCG = D / CT;           // column groups
constexpr int NRG = D / RT;           // row groups: y's partials a step
constexpr int AG = NT / TC;           // threads a step of a_t
constexpr int AD = D / AG;            // d's a thread of a_t
constexpr int NOUT = TC * D / 4 / NT; // 4-wide y vectors a thread
static_assert(AG == 8 && AD == 8 && NOUT == 2, "the 8 x 2 tile's splits");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive floats at p (aligned to min(N, 4) floats) <-> registers:
// N = 2 (a tile's columns) or a multiple of 4 (its rows, y's vectors)
template <int N>
__device__ __forceinline__ void load_vec(float (&out)[N], const float* p) {
  static_assert(N == 2 || N % 4 == 0, "2 or 4k floats");
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&in)[N]) {
  static_assert(N == 2 || N % 4 == 0, "2 or 4k floats");
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(in[i], in[i + 1], in[i + 2], in[i + 3]);
  }
}

// N consecutive Tin at p, 16-byte aligned, in 16-byte vectors, to f32
template <int N, typename Tin>
__device__ __forceinline__ void load_f32(float (&out)[N], const Tin* p) {
  constexpr int PER = 16 / sizeof(Tin);
  static_assert(N % PER == 0, "whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N; i += PER) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
    const Tin* e = reinterpret_cast<const Tin*>(&raw);
#pragma unroll
    for (int j = 0; j < PER; ++j) out[i + j] = to_f32(e[j]);
  }
}

// 4 floats to 4 consecutive outputs (8- or 16-byte aligned)
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned*>(&lo);
  v.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// One step on this thread's tile: y_t's partial r_t S_{t-1} over the
// tile's rows to `part`, then S <- decay S + k v.
__device__ __forceinline__ void step(float (&st)[RT][CT], const float (&rr)[RT],
                                     const float (&kk)[RT],
                                     const float (&dd)[RT],
                                     const float (&vv)[CT], float* part) {
  float acc[CT];
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    acc[c] = rr[0] * st[0][c];
#pragma unroll
    for (int i = 1; i < RT; ++i) acc[c] = fmaf(rr[i], st[i][c], acc[c]);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < CT; ++c)
      st[i][c] = fmaf(dd[i], st[i][c], kk[i] * vv[c]);
  store_vec(part, acc);
}

template <typename Tin>
constexpr size_t smem_bytes() {
  // raw [2][4][TC][D] of Tin; f32 r, k, v, decay [4][TC][D]; y's
  // partials [TC][NRG][D]; a_t [TC]
  return 2 * 4 * TC * D * sizeof(Tin) +
         (4 * TC * D + TC * NRG * D + TC) * sizeof(float);
}
static_assert(smem_bytes<float>() <= 232448, "shared memory per block");

template <typename Tin>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
            const Tin* __restrict__ v, const Tin* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            Tin* __restrict__ y, float* __restrict__ sout, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* raw = reinterpret_cast<Tin*>(smem_raw);
  float* f32 =
      reinterpret_cast<float*>(smem_raw + 2 * 4 * TC * D * sizeof(Tin));
  const float* fr = f32;             // [4][TC][D]: r, k, v, decay
  const float* fk = f32 + TC * D;
  const float* fv = f32 + 2 * TC * D;
  const float* fdec = f32 + 3 * TC * D;
  float* ys = f32 + 4 * TC * D;      // [TC][NRG][D]
  float* ya = ys + TC * NRG * D;     // [TC]

  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int cg = tid % NCG, rg = tid / NCG;
  const int d0 = rg * RT, c0 = cg * CT;   // this thread's tile of S

  const size_t row = (size_t)H * D;
  const size_t base = (size_t)bi * S * row + (size_t)h * D;
  const Tin* src[4] = {r + base, k + base, v + base, w + base};
  constexpr int VEC = 16 / sizeof(Tin);   // elements a 16-byte copy
  constexpr int PER_ROW = D / VEC;
  constexpr int NCONV = 4 * TC * D / VEC / NT;   // vectors a thread
  static_assert(4 * TC * D / VEC % NT == 0, "conversion split");
  const int n_chunks = (S + TC - 1) / TC;

  auto copy_chunk = [&](int chunk) {
    const int t0 = chunk * TC, tc = min(TC, S - t0);
    Tin* dst = raw + (size_t)(chunk & 1) * 4 * TC * D;
    for (int i = tid; i < 4 * tc * PER_ROW; i += NT) {
      const int arr = i / (tc * PER_ROW), rem = i % (tc * PER_ROW);
      const int t = rem / PER_ROW, col = (rem % PER_ROW) * VEC;
      cp_async16(dst + ((size_t)arr * TC + t) * D + col,
                 src[arr] + (size_t)(t0 + t) * row + col);
    }
    cp_async_commit();
  };

  copy_chunk(0);   // in flight while the state and u arrive
  const size_t soff = ((size_t)bi * H + h) * D * D;
  float st[RT][CT];
  const bool s0_vec = (reinterpret_cast<uintptr_t>(s0) & 15) == 0;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (s0 == nullptr) {
#pragma unroll
      for (int c = 0; c < CT; ++c) st[i][c] = 0.f;
      continue;
    }
    const float* p = s0 + soff + (size_t)(d0 + i) * D + c0;
    if (s0_vec) {
      load_vec(st[i], p);
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c) st[i][c] = p[c];
    }
  }
  // a_t: AG threads a step, each over AD of the d's of u
  const int at = tid / AG, ad0 = (tid % AG) * AD;
  float uu[AD];
#pragma unroll
  for (int i = 0; i < AD; ++i) uu[i] = u[(size_t)h * D + ad0 + i];

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * TC, tc = min(TC, S - t0);
    if (ch + 1 < n_chunks) {
      copy_chunk(ch + 1); // its buffer's last reader (chunk ch-1) is done
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();      // chunk ch's copies are visible to every thread
    const Tin* cur = raw + (size_t)(ch & 1) * 4 * TC * D;
    // to f32 (decay = exp(-exp(w))), 16-byte vectors, all independent
#pragma unroll
    for (int m = 0; m < NCONV; ++m) {
      const int q = tid + m * NT;
      const int arr = q / (TC * D / VEC), e0 = q % (TC * D / VEC) * VEC;
      if (e0 < tc * D) {
        float x[VEC];
        load_f32(x, cur + arr * TC * D + e0);
        if (arr == 3) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) x[i] = expf(-expf(x[i]));
        }
        store_vec(f32 + arr * TC * D + e0, x);
      }
    }
    {   // a_t = sum_d r_t[d] u[d] k_t[d], AG threads a step
      float a = 0.f;
      if (at < tc) {
        float rv[AD], kv[AD];
        load_f32(rv, cur + at * D + ad0);
        load_f32(kv, cur + TC * D + at * D + ad0);
#pragma unroll
        for (int i = 0; i < AD; ++i) a = fmaf(rv[i] * uu[i], kv[i], a);
      }
#pragma unroll
      for (int off = 1; off < AG; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (tid % AG == 0 && at < tc) ya[at] = a;
    }
    __syncthreads();

    int t = 0;
    for (; t + UT <= tc; t += UT) {
      float rr[UT][RT], kk[UT][RT], dd[UT][RT], vv[UT][CT];
#pragma unroll
      for (int q = 0; q < UT; ++q) {   // every load of the group first
        load_vec(rr[q], fr + (t + q) * D + d0);
        load_vec(kk[q], fk + (t + q) * D + d0);
        load_vec(dd[q], fdec + (t + q) * D + d0);
        load_vec(vv[q], fv + (t + q) * D + c0);
      }
#pragma unroll
      for (int q = 0; q < UT; ++q)
        step(st, rr[q], kk[q], dd[q], vv[q],
             ys + ((size_t)(t + q) * NRG + rg) * D + c0);
    }
    for (; t < tc; ++t) {
      float rr[RT], kk[RT], dd[RT], vv[CT];
      load_vec(rr, fr + t * D + d0);
      load_vec(kk, fk + t * D + d0);
      load_vec(dd, fdec + t * D + d0);
      load_vec(vv, fv + t * D + c0);
      step(st, rr, kk, dd, vv, ys + ((size_t)t * NRG + rg) * D + c0);
    }
    __syncthreads();      // every partial of the chunk is written
    Tin* yb = y + base + (size_t)t0 * row;
#pragma unroll
    for (int m = 0; m < NOUT; ++m) {   // y = a_t v_t + the D/RT partials
      const int q = tid + m * NT;
      const int ti = q / (D / 4), e0 = q % (D / 4) * 4;
      if (ti < tc) {
        float o[4], p[4];
        load_vec(o, fv + ti * D + e0);
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] *= ya[ti];
#pragma unroll
        for (int g = 0; g < NRG; ++g) {
          load_vec(p, ys + ((size_t)ti * NRG + g) * D + e0);
#pragma unroll
          for (int c = 0; c < 4; ++c) o[c] += p[c];
        }
        store4(yb + (size_t)ti * row + e0, o);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
    store_vec(sout + soff + (size_t)(d0 + i) * D + c0, st[i]);
}

template <typename Tin>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* y, float* sout, int B,
           int S, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<Tin>();
  auto kern = wkv6_kernel<Tin>;
  static PerDeviceAttr smem_set;      // once a device: costs host time
  const int attr_rc = smem_set.ensure(smem, [&] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (attr_rc != 0) return attr_rc;
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const Tin*>(w), u, s0,
      static_cast<Tin*>(y), sout, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_head_dim() { return D; }
extern "C" int wkv6_chunk() { return TC; }

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and y).  s0 may be null.
// Returns the CUDA error of the launch (0 on success); -1 for a dtype the
// library is not built for.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const float* u, const float* s0,
                           void* y, float* sout, int B, int S, int H,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s0, y, sout, B, S, H, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, sout, B, S, H, st);
  return -1;
}
