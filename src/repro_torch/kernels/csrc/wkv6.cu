// RWKV6 WKV recurrence (kernel B5) for Hopper, hand-written in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::_kernel (pallas_call
// at :74, wrapper wkv6_pallas :63).  Same function, per (batch, head),
// with a state S [D, D] (k-dim x v-dim) in f32:
//   y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(exp(-exp(w_t))) S + k_t^T v_t
// sequential in t, as the reference keeps it: the per-channel decay makes
// the parallel form need exp(+cumsum) ratios that overflow in f32.
//
// What bounds it on this card: ~3 D^2 multiply-adds a step and head
// against the bytes of r, k, v, w in and y out (2 bytes each in bf16):
// bytes bind at every shape (~0.1 ms at S = 4096, B = 2, H = 64), and a
// launch's latency at the serving decode (S = 1).  What the design does
// about it: one block of 256 threads per (batch, head) (128 blocks at the
// serving shape, about one an SM) keeps the whole state in registers for
// the whole sequence: thread (warp w, lane l) owns column e = 8 w + l / 4
// and the 16 rows d = 16 ii + 4 (l % 4) + jj, so a step is 48 FMAs a
// thread from shared memory read as float4, and y_t's sum over d is two
// shuffles inside the warp, with no barrier a step.  r, k, v and w are
// staged TC steps at a time with cp.async, the next chunk's copies in
// flight while this chunk runs; each chunk is converted to f32 once
// (decay = exp(-exp(w)) in f32 from w's dtype), and y leaves a chunk at a
// time as coalesced rows.  Any S: S = 1 (every decode step) is one chunk
// of one row.
//
// Inputs are contiguous, 16-byte aligned r/k/v/w [B,S,H,64] in bf16 or
// f32 (one dtype), u [H,64] f32 and s0 [B,H,64,64] f32 (or null for
// zeros); outputs y [B,S,H,64] in r's dtype and the state [B,H,64,64] f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;      // head dim
constexpr int TC = 32;     // steps a chunk
constexpr int NT = 256;    // threads a block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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

template <typename Tin>
constexpr size_t smem_bytes() {
  // raw [2][4][TC][D] of Tin, then f32 r/k/v/decay [4][TC][D], ys [TC][D]
  return 2 * 4 * TC * D * sizeof(Tin) + 5 * TC * D * sizeof(float);
}

template <typename Tin>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const Tin* __restrict__ r, const Tin* __restrict__ k,
            const Tin* __restrict__ v, const Tin* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            Tin* __restrict__ y, float* __restrict__ sout, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tin* raw = reinterpret_cast<Tin*>(smem_raw);
  float* fr = reinterpret_cast<float*>(smem_raw + 2 * 4 * TC * D * sizeof(Tin));
  float* fk = fr + TC * D;
  float* fv = fk + TC * D;
  float* fdec = fv + TC * D;
  float* ys = fdec + TC * D;

  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = warp * 8 + (lane >> 2);   // the v column this thread owns
  const int g = lane & 3;                 // rows d = 16 ii + 4 g + jj

  const size_t soff = ((size_t)bi * H + h) * D * D;
  float st[16], uu[16];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int d = 16 * ii + 4 * g + jj;
      st[4 * ii + jj] = s0 ? s0[soff + (size_t)d * D + e] : 0.f;
      uu[4 * ii + jj] = u[(size_t)h * D + d];
    }

  const size_t row = (size_t)H * D;
  const size_t base = (size_t)bi * S * row + (size_t)h * D;
  const Tin* src[4] = {r + base, k + base, v + base, w + base};
  constexpr int VEC = 16 / sizeof(Tin);   // elements a 16-byte copy
  constexpr int PER_ROW = D / VEC;
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

  copy_chunk(0);
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
    for (int i = tid; i < tc * D; i += NT) {
      fr[i] = to_f32(cur[i]);
      fk[i] = to_f32(cur[TC * D + i]);
      fv[i] = to_f32(cur[2 * TC * D + i]);
      fdec[i] = expf(-expf(to_f32(cur[3 * TC * D + i])));
    }
    __syncthreads();

    for (int t = 0; t < tc; ++t) {
      const float ve = fv[t * D + e];
      float yp[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int d0 = t * D + 16 * ii + 4 * g;
        const float4 r4 = *reinterpret_cast<const float4*>(fr + d0);
        const float4 k4 = *reinterpret_cast<const float4*>(fk + d0);
        const float4 w4 = *reinterpret_cast<const float4*>(fdec + d0);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        float acc = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int q = 4 * ii + jj;
          const float kv = kk[jj] * ve;
          acc = fmaf(rr[jj], fmaf(uu[q], kv, st[q]), acc);
          st[q] = fmaf(ww[jj], st[q], kv);
        }
        yp[ii] = acc;
      }
      float yt = (yp[0] + yp[1]) + (yp[2] + yp[3]);
      yt += __shfl_xor_sync(0xffffffffu, yt, 1);
      yt += __shfl_xor_sync(0xffffffffu, yt, 2);
      if (g == 0) ys[t * D + e] = yt;
    }
    __syncthreads();      // ys is complete; fr..fdec are free
    Tin* yb = y + base + (size_t)t0 * row;
    for (int i = tid; i < tc * D; i += NT)
      store(yb + (size_t)(i / D) * row + i % D, ys[i]);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int d = 16 * ii + 4 * g + jj;
      sout[soff + (size_t)d * D + e] = st[4 * ii + jj];
    }
}

template <typename Tin>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* s0, void* y, float* sout, int B,
           int S, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes<Tin>();
  auto kern = wkv6_kernel<Tin>;
  static bool smem_set = false;      // once: the call costs host time
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const Tin*>(r), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<const Tin*>(w), u, s0,
      static_cast<Tin*>(y), sout, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_head_dim() { return D; }

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
