// Mamba2 SSD scan (kernel B4) for Hopper, hand-written in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::_kernel
// (pallas_call at :84, wrapper ssm_scan_pallas :67).  Same function, per
// (batch, head): h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t,
// evaluated in chunks of T steps in the SSD matrix form the TPU kernel
// uses:
//   s     = cumsum(a dt)                                (within the chunk)
//   y     = (M o C B^T)(dt o X) + exp(s) C h,  M[t,u] = exp(s_t - s_u), u <= t
//   h_out = exp(s_T) h + (exp(s_T - s) dt B)^T X
// Not carried over block by block: the Pallas grid walks the chunks of a
// (batch, head) in order on one core with h in VMEM; here one block owns a
// (batch, head), loops over its chunks, and keeps h [N, P] in shared
// memory in f32 for the whole sequence.
//
// What bounds it on this card: at the serving prefill (B=2, S=32, H=64,
// N=P=64, bf16) the function moves ~4 MB (x, B, C in, y out, h out) and
// does 2 N P multiply-adds a step and head, so bytes bound it at ~1.3 us
// and a launch's latency is of the same order.  This first version does
// the chunk's four small products as f32 FMAs on the CUDA cores from
// shared memory (register micro-tiles of 4 x 4, padded rows so a warp's
// reads hit distinct banks), one block of 256 threads per (batch, head):
// 128 blocks at the serving shape, about one an SM.  Tensor-core tiles
// (mma.sync / wgmma) for the [T,N]x[N,T] and [T,T]x[T,P] products are the
// later step.
//
// T is 64, not the TPU's 128: the chunk's f32 tiles (x, B, C, the masked
// [T, T] product and h) then take ~83 KB of shared memory at N = P = 64
// instead of ~176 KB, so two blocks fit an SM.  The chunk length changes
// only the order of the sums.  The mask is applied before the
// exponential (exp(s_t - s_u) for u > t would overflow, and inf * 0 is
// NaN).  Any S: the ragged last chunk is padded with dt = 0 and x = B =
// C = 0, which adds nothing to y or h.
//
// Inputs are contiguous x [B,S,H,P], B/C [B,S,H,N] in bf16 or f32 (one
// dtype), dt [B,S,H] f32, a [H] f32, h0 [B,H,N,P] f32 (or null for zeros);
// outputs y [B,S,H,P] in x's dtype and h [B,H,N,P] f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;      // steps a chunk
constexpr int NT = 256;    // threads a block: a 16 x 16 grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int N, int P>
constexpr int smem_floats() {
  // Xs [T][P], Bs [T][N+1], Cs [T][N+1], G [T][T+1], Hs [N][P], s, dt, w
  return T * P + 2 * T * (N + 1) + T * (T + 1) + N * P + 3 * T;
}

template <typename Tin, int N, int P>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const Tin* __restrict__ b,
                const Tin* __restrict__ c, const float* __restrict__ h0,
                Tin* __restrict__ y, float* __restrict__ hout, int S,
                int H) {
  static_assert(N % 16 == 0 && P % 16 == 0, "16 x 16 thread grid");
  constexpr int NP = N + 1, TP = T + 1;
  constexpr int PJ = P / 16, NI = N / 16;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Bs = Xs + T * P;
  float* Cs = Bs + T * NP;
  float* G = Cs + T * NP;
  float* Hs = G + T * TP;
  float* s_cum = Hs + N * P;
  float* dts = s_cum + T;
  float* wfac = dts + T;

  const int h = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float ah = a[h];
  const size_t hoff = ((size_t)bi * H + h) * N * P;
  for (int i = tid; i < N * P; i += NT) Hs[i] = h0 ? h0[hoff + i] : 0.f;

  const size_t row_x = (size_t)H * P, row_n = (size_t)H * N;
  const Tin* xb = x + (size_t)bi * S * row_x + (size_t)h * P;
  Tin* yb = y + (size_t)bi * S * row_x + (size_t)h * P;
  const Tin* bb = b + (size_t)bi * S * row_n + (size_t)h * N;
  const Tin* cb = c + (size_t)bi * S * row_n + (size_t)h * N;
  const float* dtb = dt + (size_t)bi * S * H + h;

  for (int t0 = 0; t0 < S; t0 += T) {
    const int tc = min(T, S - t0);
    __syncthreads();   // the previous chunk's reads of the tiles are done
    for (int i = tid; i < T * P; i += NT) {
      const int t = i / P, p = i % P;
      Xs[i] = t < tc ? to_f32(xb[(size_t)(t0 + t) * row_x + p]) : 0.f;
    }
    for (int i = tid; i < T * N; i += NT) {
      const int t = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < tc) {
        bv = to_f32(bb[(size_t)(t0 + t) * row_n + n]);
        cv = to_f32(cb[(size_t)(t0 + t) * row_n + n]);
      }
      Bs[t * NP + n] = bv;
      Cs[t * NP + n] = cv;
    }
    if (tid < T) dts[tid] = tid < tc ? dtb[(size_t)(t0 + tid) * H] : 0.f;
    __syncthreads();

    // s = inclusive cumsum of a * dt: warp 0, two steps a lane
    if (tid < 32) {
      const float v0 = ah * dts[2 * tid], v1 = ah * dts[2 * tid + 1];
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      s_cum[2 * tid] = excl + v0;
      s_cum[2 * tid + 1] = excl + v0 + v1;
    }
    __syncthreads();
    const float s_last = s_cum[T - 1];   // padded steps add 0

    // G[t][u] = (C_t . B_u) exp(s_t - s_u) dt_u for u <= t, else 0
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tx + 16 * j;
          // the mask first: exp(s_t - s_u) overflows for u > t
          G[t * TP + u] = u <= t ? acc[i][j] * expf(s_cum[t] - s_cum[u])
                                       * dts[u]
                                 : 0.f;
        }
      }
      if (tid < T) wfac[tid] = expf(s_last - s_cum[tid]) * dts[tid];
    }
    __syncthreads();

    // y[t][p] = sum_u G[t][u] x[u][p] + exp(s_t) sum_n C[t][n] h[n][p]
    {
      float acc[4][PJ], inter[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = inter[i][j] = 0.f;
      for (int u = 0; u < tc; ++u) {
        float g[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = G[(ty + 16 * i) * TP + u];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[u * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(g[i], xv[j], acc[i][j]);
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = Hs[n * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= tc) continue;
        const float es = expf(s_cum[t]);
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          store(yb + (size_t)(t0 + t) * row_x + tx + 16 * j,
                fmaf(es, inter[i][j], acc[i][j]));
      }
    }
    __syncthreads();   // every read of the old h is done

    // h[n][p] = exp(s_T) h[n][p] + sum_u w_u B[u][n] x[u][p]
    {
      float acc[NI][PJ];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      for (int u = 0; u < tc; ++u) {
        const float wu = wfac[u];
        float bv[NI], xv[PJ];
#pragma unroll
        for (int i = 0; i < NI; ++i) bv[i] = wu * Bs[u * NP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[u * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
      const float decay = expf(s_last);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          float* hp = Hs + (ty + 16 * i) * P + tx + 16 * j;
          *hp = fmaf(decay, *hp, acc[i][j]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += NT) hout[hoff + i] = Hs[i];
}

template <typename Tin, int N, int P>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, const float* h0, void* y, float* hout, int B,
           int S, int H, cudaStream_t stream) {
  const size_t smem = smem_floats<N, P>() * sizeof(float);
  auto kern = ssm_scan_kernel<Tin, N, P>;
  static bool smem_set = false;      // once: the call costs host time
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const Tin*>(x), dt, a, static_cast<const Tin*>(b),
      static_cast<const Tin*>(c), h0, static_cast<Tin*>(y), hout, S, H);
  return (int)cudaGetLastError();
}

template <typename Tin>
int dispatch(int N, int P, const void* x, const float* dt, const float* a,
             const void* b, const void* c, const float* h0, void* y,
             float* hout, int B, int S, int H, cudaStream_t st) {
  if (N == 64 && P == 64)
    return launch<Tin, 64, 64>(x, dt, a, b, c, h0, y, hout, B, S, H, st);
  if (N == 32 && P == 64)
    return launch<Tin, 32, 64>(x, dt, a, b, c, h0, y, hout, B, S, H, st);
  if (N == 16 && P == 32)
    return launch<Tin, 16, 32>(x, dt, a, b, c, h0, y, hout, B, S, H, st);
  return -1;
}

}  // namespace

extern "C" int ssm_scan_chunk() { return T; }

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y).  h0 may be null.
// Returns the CUDA error of the launch (0 on success); -1 for an (N, P)
// or dtype the library is not built for.
extern "C" int ssm_scan_launch(const void* x, const float* dt,
                               const float* a, const void* b, const void* c,
                               const float* h0, void* y, float* hout, int B,
                               int S, int H, int N, int P, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(N, P, x, dt, a, b, c, h0, y, hout, B, S, H, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(N, P, x, dt, a, b, c, h0, y, hout, B, S,
                                   H, st);
  return -1;
}
