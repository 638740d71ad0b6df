// Mamba2 SSD scan (kernel B4) for Hopper, hand-written in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::_kernel
// (pallas_call at :84, wrapper ssm_scan_pallas :67).  Same function, per
// (batch, head): h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t,
// evaluated in chunks of T steps in the SSD matrix form the TPU kernel
// uses:
//   s     = cumsum(a dt)                                (within the chunk)
//   y     = G X + exp(s) C h,   G[t,u] = (C_t . B_u) exp(s_t - s_u) dt_u
//                               for u <= t, else 0
//   h_out = exp(s_T) h + B^T (w o X),   w_u = exp(s_T - s_u) dt_u
// Not carried over block by block: the Pallas grid walks the chunks of a
// (batch, head) in order on one core with h in VMEM.  Here a block owns PB
// of the P columns of one (batch, head) and loops over its chunks.  y[:, p]
// and h[:, p] depend on the column x[:, p] alone; G and the cumsum are
// shared by all columns, and each block recomputes them (they are cheap).
// At the serving prefill (B = 2, H = 64, P = 64) PB = 32 gives 256 blocks,
// two an SM, where one block a (batch, head) gave 128.
//
// What bounds it on this card: at the serving prefill (B=2, S=32, H=64,
// N=P=64, bf16) the function moves ~4 MB (x, B, C in, y out, h out), a
// bound of ~1.3 us, of the order of a launch's own latency; at 4,096
// steps ~270 MB (81 us).  The chain through the chunks (h) is serial, so
// what a block does a chunk sets the pace at long S.
//
// bf16 (every call the serving path makes): ssm_scan_mma_kernel, the four
// products on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
// accumulate), four warps a block.  Warp w owns y's rows 16w .. 16w + 15:
//   * C B^T: both operands are the bf16 inputs, so every product is exact
//     in f32, as in the reference, which converts to f32 first; only the
//     16-column steps u on or below the diagonal, and below the chunk's
//     real length tc, are computed (at S = 32 the 32 x 32 lower triangle);
//   * the mask is applied before the exponential (exp(s_t - s_u) for
//     u > t would overflow, and inf * 0 is NaN), then G = (C B^T) exp(..)
//     dt_u in f32 in registers, where the accumulator of two n8 tiles is,
//     pair by pair, the A fragment of the next product;
//   * G X, C h and B^T (w o X): G, h and w o X are f32 in the reference's
//     arithmetic.  They enter the tensor cores as a hi + lo pair of bf16
//     values (two mma a tile), so they keep ~16 bits; x, B and C are exact.
// h [N, PB] lives in f32 in the registers of the warps that update it (a
// WM x WN grid of warps over its 16 x 8 tiles), and, for C h, as its hi
// and lo bf16 planes in shared memory, double-buffered so that one block
// barrier a chunk orders everything.  The cumsum is computed by every warp
// for itself (64 steps, a warp scan), so it needs no barrier, in log2
// units, so that each exponential is one ex2.approx.  The next
// chunk's x, B, C and dt arrive by cp.async into the other half of a
// double buffer while this chunk's products run.  Rows past tc are zero
// (cp.async zero-fills them) and add nothing.
//
// What holds it back now: each block's chunk is a chain of dependent
// products (C B^T, then G X; the h update) behind one barrier, 4 warps a
// block and two blocks an SM, so latency, not the tensor cores' rate,
// sets the pace; and warp w's share of G grows with w (1 to 4 steps).
//
// f32 (the tests' dtype, held at 5e-4 / 1e-3, the reference's bound for
// its chunked kernel): ssm_scan_fma_kernel, f32 FMAs on the CUDA cores
// from shared memory in register micro-tiles (4 x 4 for G, 4 x PB/16 for
// y, N/16 x PB/16 for h), 256 threads a block, with the same split of P
// and the same double-buffered cp.async loads.
//
// T is 64, not the TPU's 128: shared memory is smaller here, and the
// chunk length changes only the order of the sums.  Any S: the ragged
// last chunk is padded with dt = 0 and x = B = C = 0.
//
// Inputs are contiguous x [B,S,H,P], B/C [B,S,H,N] in bf16 or f32 (one
// dtype; x, B and C 16-byte aligned), dt [B,S,H] f32, a [H] f32, h0
// [B,H,N,P] f32 (or null for zeros); outputs y [B,S,H,P] in x's dtype and
// h [B,H,N,P] f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int T = 64;             // steps a chunk
constexpr int MMA_THREADS = 128;  // four warps: warp w owns rows 16w..
constexpr int FMA_THREADS = 256;  // a 16 x 16 grid
constexpr int PB = 32;            // columns of P a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros
// when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// s = inclusive cumsum of a dt over the chunk's 64 steps, by one warp:
// two steps a lane; writes s[0..63]
__device__ __forceinline__ void chunk_cumsum(const float* dts, float ah,
                                             float* s, int lane) {
  const float v0 = ah * dts[2 * lane], v1 = ah * dts[2 * lane + 1];
  float incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  s[2 * lane] = excl + v0;
  s[2 * lane + 1] = excl + v0 + v1;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (one instruction, ~2^-22 relative
// error); the bf16 kernel keeps its cumsum in log2 units
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr,
                                              uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}
// the f32 pair (v0, v1) as two bf16 pairs, hi = bf16(v) and lo = bf16(v -
// hi): hi + lo keeps ~16 bits of v
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(v1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(v0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(v1 - __bfloat162float(h1)));
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// Shared memory of ssm_scan_mma_kernel, in bytes: two stages of (x [T][PB],
// B [T][N], C [T][N], dt [T]), two buffers of h's (hi, lo) planes [N][PB],
// and each warp's cumsum [T].  Rows are padded by 8 bf16 so that the eight
// rows an ldmatrix reads fall on distinct banks, and stay 16-byte aligned.
template <int N>
struct MmaLayout {
  static constexpr int NS = N + 8;    // B and C row pitch (bf16)
  static constexpr int XS = PB + 8;   // x and h row pitch (bf16)
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X_OFF + T * XS * 2;
  static constexpr int C_OFF = B_OFF + T * NS * 2;
  static constexpr int DT_OFF = C_OFF + T * NS * 2;
  static constexpr int STAGE = DT_OFF + T * 4;
  static constexpr int H_BYTES = N * XS * 2;   // one plane
  static constexpr int H_OFF = 2 * STAGE;      // buffer i: hi, then lo
  static constexpr int S_OFF = H_OFF + 4 * H_BYTES;
  static constexpr int BYTES = S_OFF + (MMA_THREADS / 32) * T * 4;
  static_assert(STAGE % 16 == 0 && H_BYTES % 16 == 0, "16-byte rows");
};

// one chunk's x [tc rows of PB], B, C [tc rows of N] and dt into a stage,
// zeros past tc; the caller commits
template <typename Tin, int N, int NTH, int XS, int NS, int X_OFF,
          int B_OFF, int C_OFF, int DT_OFF, int ESZ>
__device__ __forceinline__ void load_chunk(
    uint32_t stage, const Tin* xb, const Tin* bb, const Tin* cb,
    const float* dtb, int t0, int tc, size_t row_x, size_t row_n,
    size_t row_dt, int tid) {
  constexpr int VE = 16 / sizeof(Tin);   // elements a 16-byte copy
  constexpr int XV = PB / VE;
  for (int i = tid; i < T * XV; i += NTH) {
    const int t = i / XV, v = i % XV;
    const bool ok = t < tc;
    cp_async16(stage + X_OFF + (t * XS + VE * v) * ESZ,
               xb + (ok ? (size_t)(t0 + t) * row_x + VE * v : 0), ok);
  }
  if constexpr (NS % VE == 0) {          // B and C rows 16-byte aligned
    constexpr int NV = N / VE;
    for (int i = tid; i < T * NV; i += NTH) {
      const int t = i / NV, v = i % NV;
      const bool ok = t < tc;
      const size_t off = ok ? (size_t)(t0 + t) * row_n + VE * v : 0;
      cp_async16(stage + B_OFF + (t * NS + VE * v) * ESZ, bb + off, ok);
      cp_async16(stage + C_OFF + (t * NS + VE * v) * ESZ, cb + off, ok);
    }
  } else {                               // f32 rows of N + 1: by element
    for (int i = tid; i < T * N; i += NTH) {
      const int t = i / N, n = i % N;
      const bool ok = t < tc;
      const size_t off = ok ? (size_t)(t0 + t) * row_n + n : 0;
      cp_async4(stage + B_OFF + (t * NS + n) * 4, bb + off, ok);
      cp_async4(stage + C_OFF + (t * NS + n) * 4, cb + off, ok);
    }
  }
  if (tid < T) {
    const bool ok = tid < tc;
    cp_async4(stage + DT_OFF + 4 * tid,
              dtb + (ok ? (size_t)(t0 + tid) * row_dt : 0), ok);
  }
}

template <int N>
__global__ void __launch_bounds__(MMA_THREADS)
ssm_scan_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    const __nv_bfloat16* __restrict__ c,
                    const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
                    float* __restrict__ hout, int S, int H, int P) {
  using L = MmaLayout<N>;
  constexpr int NS = L::NS, XS = L::XS;
  constexpr int NK = N / 16;          // 16-wide steps over N
  constexpr int NN = PB / 8;          // n8 tiles over the block's columns
  // h's [N, PB] tiles over the four warps: a WM x WN grid, each warp MPW
  // m16 tiles by NPW n8 tiles
  constexpr int NM = N / 16;
  constexpr int WM = NM < 4 ? NM : 4, WN = 4 / WM;
  constexpr int MPW = NM / WM, NPW = NN / WN;
  static_assert(NM % WM == 0 && NN % WN == 0 && NN % 2 == 0, "tiling");

  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const int p0 = blockIdx.x * PB, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const float ah = a[h];
  const size_t row_x = (size_t)H * P, row_n = (size_t)H * N;
  const size_t seq = (size_t)bi * S * H + h;   // (bi, step 0, h)
  const __nv_bfloat16* xb = x + seq * P + p0;
  __nv_bfloat16* yb = y + seq * P + p0;
  const __nv_bfloat16* bb = b + seq * N;
  const __nv_bfloat16* cb = c + seq * N;
  const float* dtb = dt + seq;
  float* s_w = reinterpret_cast<float*>(smem + L::S_OFF) + warp * T;

  const int n_chunks = (S + T - 1) / T;
  load_chunk<__nv_bfloat16, N, MMA_THREADS, XS, NS, L::X_OFF, L::B_OFF,
             L::C_OFF, L::DT_OFF, 2>(base, xb, bb, cb, dtb, 0, min(T, S),
                                     row_x, row_n, H, tid);
  cp_async_commit();

  // this warp's share of h, in f32: m16 tiles wm + WM i, n8 tiles
  // wn NPW + j; element e at row n = 16 m + g + 8 (e / 2), column
  // p = 8 j' + 2 t4 + e % 2
  const int wm = warp % WM, wn = warp / WM;
  const size_t hoff = ((size_t)bi * H + h) * N * P + p0;
  float hacc[MPW][NPW][4];
#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (wm + WM * i) + g + 8 * (e / 2);
        const int p = 8 * (wn * NPW + j) + 2 * t4 + e % 2;
        hacc[i][j][e] = h0 ? h0[hoff + (size_t)n * P + p] : 0.f;
      }
  // h's hi and lo planes for C h, into buffer `buf`
  auto write_planes = [&](int buf) {
    __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(
        smem + L::H_OFF + buf * 2 * L::H_BYTES);
    __nv_bfloat16* lo = hi + L::H_BYTES / 2;
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int n = 16 * (wm + WM * i) + g + 8 * (e / 2);
          const int p = 8 * (wn * NPW + j) + 2 * t4;
          uint32_t vh, vl;
          split2(hacc[i][j][e], hacc[i][j][e + 1], vh, vl);
          *reinterpret_cast<uint32_t*>(hi + n * XS + p) = vh;
          *reinterpret_cast<uint32_t*>(lo + n * XS + p) = vl;
        }
  };
  write_planes(0);

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * T, tc = min(T, S - t0);
    const uint32_t st = base + (ci & 1) * L::STAGE;
    const uint32_t hs = base + L::H_OFF + (ci & 1) * 2 * L::H_BYTES;
    cp_async_wait_all();
    // this chunk's tiles and h's planes are in; every warp is done with
    // the previous chunk's stage and planes
    __syncthreads();
    if (ci + 1 < n_chunks)
      load_chunk<__nv_bfloat16, N, MMA_THREADS, XS, NS, L::X_OFF,
                 L::B_OFF, L::C_OFF, L::DT_OFF, 2>(
          base + ((ci + 1) & 1) * L::STAGE, xb, bb, cb, dtb, t0 + T,
          min(T, S - t0 - T), row_x, row_n, H, tid);
    cp_async_commit();

    const float* dts =
        reinterpret_cast<const float*>(smem + (ci & 1) * L::STAGE + L::DT_OFF);
    chunk_cumsum(dts, ah * LOG2E, s_w, lane);   // s log2(e)
    __syncwarp();
    const float s_last = s_w[T - 1];   // padded steps add 0

    // y for rows r0 .. r0 + 15
    const int r0 = 16 * warp;
    if (r0 < tc) {
      uint32_t ca[NK][4];   // C's rows as A fragments, for C B^T and C h
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldsm_x4(st + L::C_OFF +
                    2 * ((r0 + lane % 16) * NS + 16 * kk + (lane / 16) * 8),
                ca[kk]);
      float yacc[NN][4], inter[NN][4];
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = inter[j][e] = 0.f;
      // C h, h of the chunks before, as hi + lo
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int jp = 0; jp < NN / 2; ++jp) {
          const uint32_t off = 2 * ((16 * kk + (lane / 8 % 2) * 8 + lane % 8) *
                                        XS + 8 * (2 * jp + lane / 16));
          uint32_t bh[4], bl[4];
          ldsm_x4_trans(hs + off, bh);
          ldsm_x4_trans(hs + L::H_BYTES + off, bl);
          mma_bf16(inter[2 * jp], ca[kk], bh[0], bh[1]);
          mma_bf16(inter[2 * jp + 1], ca[kk], bh[2], bh[3]);
          mma_bf16(inter[2 * jp], ca[kk], bl[0], bl[1]);
          mma_bf16(inter[2 * jp + 1], ca[kk], bl[2], bl[3]);
        }
      // G X over the 16-step columns u on or below the diagonal
      const float sr0 = s_w[r0 + g], sr1 = s_w[r0 + g + 8];
#pragma unroll
      for (int ku = 0; ku < T / 16; ++ku) {
        if (ku > warp || 16 * ku >= tc) break;
        float sacc[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[jj][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t bq[4];   // B's rows u as the B operand (B^T)
          ldsm_x4(st + L::B_OFF +
                      2 * ((16 * ku + 8 * (lane / 16) + lane % 8) * NS +
                           16 * kk + (lane / 8 % 2) * 8),
                  bq);
          mma_bf16(sacc[0], ca[kk], bq[0], bq[1]);
          mma_bf16(sacc[1], ca[kk], bq[2], bq[3]);
        }
        // the mask first, then exp(s_t - s_u) dt_u; as A fragments
        uint32_t ghi[4], glo[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = r0 + g + 8 * hh;
            const float sr = hh ? sr1 : sr0;
            float gv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int u = 16 * ku + 8 * jj + 2 * t4 + e;
              gv[e] = u <= row
                          ? sacc[jj][2 * hh + e] * fast_exp2(sr - s_w[u]) *
                                dts[u]
                          : 0.f;
            }
            split2(gv[0], gv[1], ghi[2 * jj + hh], glo[2 * jj + hh]);
          }
#pragma unroll
        for (int jp = 0; jp < NN / 2; ++jp) {
          uint32_t xq[4];
          ldsm_x4_trans(st + L::X_OFF +
                            2 * ((16 * ku + (lane / 8 % 2) * 8 + lane % 8) *
                                     XS + 8 * (2 * jp + lane / 16)),
                        xq);
          mma_bf16(yacc[2 * jp], ghi, xq[0], xq[1]);
          mma_bf16(yacc[2 * jp + 1], ghi, xq[2], xq[3]);
          mma_bf16(yacc[2 * jp], glo, xq[0], xq[1]);
          mma_bf16(yacc[2 * jp + 1], glo, xq[2], xq[3]);
        }
      }
      const float e0 = fast_exp2(sr0), e1 = fast_exp2(sr1);
      const int ra = r0 + g, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        const int col = 8 * j + 2 * t4;
        if (ra < tc)
          *reinterpret_cast<__nv_bfloat162*>(
              yb + (size_t)(t0 + ra) * row_x + col) =
              __floats2bfloat162_rn(fmaf(e0, inter[j][0], yacc[j][0]),
                                    fmaf(e0, inter[j][1], yacc[j][1]));
        if (rb < tc)
          *reinterpret_cast<__nv_bfloat162*>(
              yb + (size_t)(t0 + rb) * row_x + col) =
              __floats2bfloat162_rn(fmaf(e1, inter[j][2], yacc[j][2]),
                                    fmaf(e1, inter[j][3], yacc[j][3]));
      }
    }

    // h = exp(s_T) h + B^T (w o X): A = B^T from B's rows by
    // ldmatrix.trans, B = w o X as hi + lo
    const float decay = fast_exp2(s_last);
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][j][e] *= decay;
#pragma unroll
    for (int ku = 0; ku < T / 16; ++ku) {
      if (16 * ku >= tc) break;
      // this thread's four steps of a B fragment: u0 + {0, 1, 8, 9}
      const int u0 = 16 * ku + 2 * t4;
      const float w0 = fast_exp2(s_last - s_w[u0]) * dts[u0];
      const float w1 = fast_exp2(s_last - s_w[u0 + 1]) * dts[u0 + 1];
      const float w2 = fast_exp2(s_last - s_w[u0 + 8]) * dts[u0 + 8];
      const float w3 = fast_exp2(s_last - s_w[u0 + 9]) * dts[u0 + 9];
      uint32_t ba[MPW][4];
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        const int q = lane / 8;
        ldsm_x4_trans(st + L::B_OFF +
                          2 * ((16 * ku + 8 * (q / 2) + lane % 8) * NS +
                               16 * (wm + WM * i) + 8 * (q % 2)),
                      ba[i]);
      }
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        uint32_t xq[2];
        ldsm_x2_trans(st + L::X_OFF + 2 * ((16 * ku + lane % 16) * XS +
                                           8 * (wn * NPW + j)),
                      xq);
        const float2 xa = unpack_bf16(xq[0]), xc = unpack_bf16(xq[1]);
        uint32_t bhi[2], blo[2];
        split2(w0 * xa.x, w1 * xa.y, bhi[0], blo[0]);
        split2(w2 * xc.x, w3 * xc.y, bhi[1], blo[1]);
#pragma unroll
        for (int i = 0; i < MPW; ++i) mma_bf16(hacc[i][j], ba[i], bhi[0], bhi[1]);
#pragma unroll
        for (int i = 0; i < MPW; ++i) mma_bf16(hacc[i][j], ba[i], blo[0], blo[1]);
      }
    }
    write_planes((ci + 1) & 1);
  }

#pragma unroll
  for (int i = 0; i < MPW; ++i)
#pragma unroll
    for (int j = 0; j < NPW; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int n = 16 * (wm + WM * i) + g + 8 * (e / 2);
        const int p = 8 * (wn * NPW + j) + 2 * t4;
        *reinterpret_cast<float2*>(hout + hoff + (size_t)n * P + p) =
            make_float2(hacc[i][j][e], hacc[i][j][e + 1]);
      }
}

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

// Shared memory of ssm_scan_fma_kernel, in floats: two stages of (x
// [T][PB], B and C [T][N + 1], dt [T]), the masked [T][T + 1] product G,
// h [N][PB], s and w [T].  B's and C's rows are padded by one float so
// that a warp's column reads hit distinct banks.
template <int N>
struct FmaLayout {
  static constexpr int NS = N + 1;
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X_OFF + T * PB;
  static constexpr int C_OFF = B_OFF + T * NS;
  static constexpr int DT_OFF = C_OFF + T * NS;
  static constexpr int STAGE = DT_OFF + T;
  static constexpr int G_OFF = 2 * STAGE;
  static constexpr int H_OFF = G_OFF + T * (T + 1);
  static constexpr int S_OFF = H_OFF + N * PB;
  static constexpr int W_OFF = S_OFF + T;
  static constexpr int FLOATS = W_OFF + T;
  static_assert(STAGE % 4 == 0, "x rows 16-byte aligned in both stages");
};

template <int N>
__global__ void __launch_bounds__(FMA_THREADS)
ssm_scan_fma_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ c, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ hout, int S,
                    int H, int P) {
  using L = FmaLayout<N>;
  static_assert(N % 16 == 0 && PB % 16 == 0, "16 x 16 thread grid");
  constexpr int NS = L::NS, TP = T + 1;
  constexpr int PJ = PB / 16, NI = N / 16;
  extern __shared__ __align__(16) float fsm[];
  const uint32_t base = smem_u32(fsm);
  float* G = fsm + L::G_OFF;
  float* Hs = fsm + L::H_OFF;
  float* s_cum = fsm + L::S_OFF;
  float* wfac = fsm + L::W_OFF;

  const int p0 = blockIdx.x * PB, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float ah = a[h];
  const size_t row_x = (size_t)H * P, row_n = (size_t)H * N;
  const size_t seq = (size_t)bi * S * H + h;
  const float* xb = x + seq * P + p0;
  float* yb = y + seq * P + p0;
  const float* bb = b + seq * N;
  const float* cb = c + seq * N;
  const float* dtb = dt + seq;
  const size_t hoff = ((size_t)bi * H + h) * N * P + p0;

  const int n_chunks = (S + T - 1) / T;
  load_chunk<float, N, FMA_THREADS, PB, NS, L::X_OFF * 4, L::B_OFF * 4,
             L::C_OFF * 4, L::DT_OFF * 4, 4>(base, xb, bb, cb, dtb, 0,
                                             min(T, S), row_x, row_n, H, tid);
  cp_async_commit();
  for (int i = tid; i < N * PB; i += FMA_THREADS)
    Hs[i] = h0 ? h0[hoff + (size_t)(i / PB) * P + i % PB] : 0.f;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * T, tc = min(T, S - t0);
    const float* Xs = fsm + (ci & 1) * L::STAGE + L::X_OFF;
    const float* Bs = fsm + (ci & 1) * L::STAGE + L::B_OFF;
    const float* Cs = fsm + (ci & 1) * L::STAGE + L::C_OFF;
    const float* dts = fsm + (ci & 1) * L::STAGE + L::DT_OFF;
    cp_async_wait_all();
    __syncthreads();   // this chunk is in; the previous one's reads done
    if (ci + 1 < n_chunks)
      load_chunk<float, N, FMA_THREADS, PB, NS, L::X_OFF * 4,
                 L::B_OFF * 4, L::C_OFF * 4, L::DT_OFF * 4, 4>(
          base + ((ci + 1) & 1) * L::STAGE * 4, xb, bb, cb, dtb, t0 + T,
          min(T, S - t0 - T), row_x, row_n, H, tid);
    cp_async_commit();
    if (tid < 32) chunk_cumsum(dts, ah, s_cum, tid);
    __syncthreads();
    const float s_last = s_cum[T - 1];   // padded steps add 0

    // G[t][u] = (C_t . B_u) exp(s_t - s_u) dt_u for u <= t, else 0;
    // rows t = ty + 16 i, columns u = tx + 16 j
    if (ty < tc) {   // else every row of this thread is padding
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
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
    }
    if (tid < T) wfac[tid] = expf(s_last - s_cum[tid]) * dts[tid];
    __syncthreads();

    // y[t][p] = sum_u G[t][u] x[u][p] + exp(s_t) sum_n C[t][n] h[n][p]
    if (ty < tc) {
      float acc[4][PJ], inter[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = inter[i][j] = 0.f;
      // G[t][u] = 0 for u > t: this thread's rows end at ty + 48
      const int u_end = min(tc, ty + 16 * 3 + 1);
      for (int u = 0; u < u_end; ++u) {
        float gv[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = G[(ty + 16 * i) * TP + u];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[u * PB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = Hs[n * PB + tx + 16 * j];
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
          yb[(size_t)(t0 + t) * row_x + tx + 16 * j] =
              fmaf(es, inter[i][j], acc[i][j]);
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
        for (int i = 0; i < NI; ++i) bv[i] = wu * Bs[u * NS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[u * PB + tx + 16 * j];
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
          float* hp = Hs + (ty + 16 * i) * PB + tx + 16 * j;
          *hp = fmaf(decay, *hp, acc[i][j]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * PB; i += FMA_THREADS)
    hout[hoff + (size_t)(i / PB) * P + i % PB] = Hs[i];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int N>
int launch_mma(const void* x, const float* dt, const float* a, const void* b,
               const void* c, const float* h0, void* y, float* hout, int B,
               int S, int H, int P, cudaStream_t stream) {
  constexpr int smem = MmaLayout<N>::BYTES;
  auto kern = ssm_scan_mma_kernel<N>;
  static PerDeviceAttr smem_set;      // once a device: costs host time
  const int attr_rc = smem_set.ensure(smem, [&] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (attr_rc != 0) return attr_rc;
  kern<<<dim3(P / PB, H, B), MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a,
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), h0,
      static_cast<__nv_bfloat16*>(y), hout, S, H, P);
  return (int)cudaGetLastError();
}

template <int N>
int launch_fma(const void* x, const float* dt, const float* a, const void* b,
               const void* c, const float* h0, void* y, float* hout, int B,
               int S, int H, int P, cudaStream_t stream) {
  constexpr int smem = FmaLayout<N>::FLOATS * 4;
  auto kern = ssm_scan_fma_kernel<N>;
  static PerDeviceAttr smem_set;      // once a device: costs host time
  const int attr_rc = smem_set.ensure(smem, [&] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (attr_rc != 0) return attr_rc;
  kern<<<dim3(P / PB, H, B), FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(b),
      static_cast<const float*>(c), h0, static_cast<float*>(y), hout, S, H,
      P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssm_scan_chunk() { return T; }
extern "C" int ssm_scan_block_cols() { return PB; }

// dtype: 0 = float32 (ssm_scan_fma_kernel), 1 = bfloat16
// (ssm_scan_mma_kernel), for x, b, c and y.  h0 may be null.  Returns the
// CUDA error of the launch (0 on success); -1 for an (N, P) or dtype the
// library is not built for.
extern "C" int ssm_scan_launch(const void* x, const float* dt,
                               const float* a, const void* b, const void* c,
                               const float* h0, void* y, float* hout, int B,
                               int S, int H, int N, int P, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSM_ARGS x, dt, a, b, c, h0, y, hout, B, S, H, P, st
  if (dtype == 1) {
    if (N == 64 && P == 64) return launch_mma<64>(SSM_ARGS);
    if (N == 128 && P == 64) return launch_mma<128>(SSM_ARGS);
    if (N == 32 && P == 64) return launch_mma<32>(SSM_ARGS);
    if (N == 16 && P == 32) return launch_mma<16>(SSM_ARGS);
  }
  if (dtype == 0) {
    if (N == 64 && P == 64) return launch_fma<64>(SSM_ARGS);
    if (N == 128 && P == 64) return launch_fma<128>(SSM_ARGS);
    if (N == 32 && P == 64) return launch_fma<32>(SSM_ARGS);
    if (N == 16 && P == 32) return launch_fma<16>(SSM_ARGS);
  }
#undef SSM_ARGS
  return -1;
}
