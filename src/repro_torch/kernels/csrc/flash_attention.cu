// Flash attention (prefill) for Hopper, hand-written in CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (:26; pallas_call at :88, wrapper flash_attention_pallas :70).  Same
// function: causal and sliding-window attention with a query offset and
// GQA (query head h reads kv head h / G), an f32 online softmax, masked
// scores at NEG_INF (-inf in the bf16 kernel, with guards: the same result
// when every row sees a key, which the wrapper ensures) and a
// max(l, 1e-30) denominator.  Not carried over block by
// block: the Pallas grid walks kv tiles sequentially on one core with the
// accumulators in VMEM; here one block owns a query tile of one
// (batch, head) and loops over the kv tiles its rows can see.
//
// bf16 (every call the serving path makes): flash_wgmma_kernel, on the
// tensor cores.  What bounds it: operations at long prefills (4 D
// multiply-adds a visible (query, key) pair and head: 206 GFLOP at Sq =
// Skv = 4096, H = 24, B = 2, causal; 208.5 us at the bf16 peak), launch
// latency at the serving path's 32-token prefill (a bound of ~0.3 us of
// bytes against a few us to launch and drain any kernel).
//
// Design.  One block of 288 threads owns 128 query rows of one (batch,
// head): two consumer warpgroups of 64 rows each and one producer warp.
// The producer's one thread loads Q, then K and V tiles of 128 rows, by TMA
// (cp.async.bulk.tensor) into a 2-stage ring of shared memory with
// full/empty mbarriers, so the loads overlap the products and no thread
// spends registers or instructions on the copies.  The tensor maps are 4-D
// over [B, S, heads, D], so a tile that runs past Sq or Skv is zero-filled
// within its own sequence, with the 128-byte swizzle that the wgmma
// descriptors name (two 64-column boxes a row block at D = 128).  For each
// tile a consumer warpgroup runs S = Q K^T as wgmma.mma_async m64n128k16
// (bf16 in, f32 accumulate; Q and K from shared memory, both K-major),
// masks and runs the online softmax on the accumulator rows in registers
// (a row's columns lie on the four threads of a quad), converts P to bf16
// pairs in registers (the f32 accumulator layout is, pair by pair, the A
// operand's), and runs O += P V with P from registers and V's tile
// MN-major (the transpose bit).  The two warpgroups interleave on the SM,
// one's softmax beside the other's products.  Only tiles on the causal
// diagonal, the window's edge or Skv's ragged end are masked; tiles wholly
// outside the band are never loaded.  Causal query tiles launch heaviest
// first, so the last wave is not the longest.  At 32 tokens a warpgroup
// whose 64 rows all lie past Sq does no product and stores nothing.
//
// What holds it back (CUDA-event timing of variants of this source on the
// card, chip_smoke.py --ablate-flash): the loads are hidden, and the
// softmax's instructions, not the products, set the pace.  So the softmax
// is lean: the scale goes into the exponent (p = 2^(s c - m c): one FFMA
// and one ex2.approx a score), masked scores are -inf, and O is rescaled
// without a vote.  Schedules that overlap the softmax with the products
// more tightly (FA3's ping-pong between the warpgroups, and its overlap of
// one tile's softmax with the last tile's P V inside a warpgroup, the
// latter with setmaxnreg to give the consumers 240 registers) measured
// slower than this one.
//
// Rounding, both inside the reference's bf16 tolerance: the scale is
// applied to S in f32 (as the Pallas kernel does), and P is rounded to
// bf16 before P V (as the reference oracle's p.astype(v.dtype) does; the
// oracle normalises first, this kernel after).
//
// f32 (the tests' dtype, held at 2e-5, which TF32 tensor cores cannot
// meet): flash_fma_kernel, f32 FMAs on the CUDA cores from shared memory,
// one block of 256 threads a 64-row query tile, 32-row kv tiles, register
// micro-tiles of 4 x 2 scores and 4 x D/16 outputs a thread, padded rows.
//
// Inputs are contiguous, 16-byte aligned q [B, Sq, H, D], k/v
// [B, Skv, KV, D] in bf16 or f32; output [B, Sq, H, D] in q's dtype.  D is
// 64, 112 or 128.  Any Sq and Skv: ragged tiles are masked.  The wrapper
// guarantees every query row sees at least one key (so skipping masked
// tiles is exact).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int WQ = 128;          // query rows a block: two warpgroups of 64
constexpr int WKV = 128;         // kv rows a tile
constexpr int STAGES = 2;        // K/V tiles in flight
constexpr int CONSUMERS = 256;   // threads of the two consumer warpgroups
constexpr int WG_THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int BOX_COLS = 64;     // 128 bytes of bf16: one swizzle row

// The head dim of the shared-memory tiles: whole 64-column swizzle boxes.
// At D = 112 (kimi-k2) the second box's last 16 columns lie past the
// tensor map's row and TMA fills them with zeros, which add nothing to
// Q K^T; P V runs at n = 128 and its last 16 columns are not stored.
template <int D>
__host__ __device__ constexpr int tile_cols() {
  return (D + BOX_COLS - 1) / BOX_COLS * BOX_COLS;
}

template <int D>
constexpr int wgmma_smem_bytes() {
  // Q, STAGES x (K, V), the mbarriers (q, full[], empty[]) and the slack
  // to align the tiles to the 1,024-byte swizzle atom
  return WQ * D * 2 + 2 * STAGES * WKV * D * 2 + 8 * (1 + 2 * STAGES) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one TMA box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S += A B^T with A [64 x 16] and B [128 x 16] K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// the first step, S = A B^T: S is only written, so it is dead between
// tiles
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// O += P V with P [64 x 16] in registers (bf16 pairs) and V [16 x N]
// MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (one instruction; 2^-22 relative error)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// O += P V: V's [WKV, D] tile at `v` is MN-major for the B operand
// (transposed); 16 kv rows a step, the two 64-column boxes of D = 128 LBO
// apart, 8-row groups SBO apart.  D is the tile's (whole boxes).
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2],
                                         const uint32_t (&pa)[WKV / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < WKV / 16; ++kk) {
    const uint64_t db = sw128_desc(v + kk * 16 * 128, WKV * 128, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(oacc, pa[kk], db);
    else
      wgmma_rs_n64(oacc, pa[kk], db);
  }
}

// S = Q K^T over D / 16 steps of 16 columns, Q's 64 rows at `q` in a
// [WQ, DT] tile, K's [WKV, DT] tile at `k` (DT = tile_cols<D>(): the
// columns from D on are zeros and no step reads them); a step inside a
// 128-byte swizzle row advances the descriptors by 32 bytes
template <int D>
__device__ __forceinline__ void issue_s(float (&sacc)[WKV / 2], uint32_t q,
                                        uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da =
        sw128_desc(q + (kk / 4) * WQ * 128 + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        sw128_desc(k + (kk / 4) * WKV * 128 + (kk % 4) * 32, 16, 1024);
    if (kk == 0)
      wgmma_ss_n128_first(sacc, da, db);
    else
      wgmma_ss_n128(sacc, da, db);
  }
}

// A consumer warpgroup of flash_wgmma_kernel: rows q0 + 64 wg .. + 63.
template <int D>
__device__ __forceinline__ void flash_consumer(
    uint32_t qs, uint32_t ks, uint32_t vs, uint32_t q_bar, uint32_t full_bar,
    uint32_t empty_bar, __nv_bfloat16* __restrict__ o, int q0, int h, int b,
    int k_first, int n_tiles, int Sq, int Skv, int H, float scale_log2,
    int causal, int window, int q_offset) {
  constexpr int DT = tile_cols<D>();
  constexpr int KV_BYTES = WKV * DT * 2; // one K or V tile
  constexpr int NO = DT / 2;             // output accumulators a thread
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = q0 + 64 * wg;
  const int wrows = min(64, Sq - r_lo);          // <= 0: no row of ours
  const int plo = r_lo + q_offset, phi = r_lo + wrows - 1 + q_offset;
  const int hi = wrows <= 0 ? 0 : causal ? min(Skv, phi + 1) : Skv;
  const int lo = window > 0 ? max(0, plo - window + 1) : 0;
  // this thread's two rows of the accumulators: row0 and row0 + 8
  const int row0 = r_lo + 16 * warp + g;
  const int qp0 = row0 + q_offset, qp1 = qp0 + 8;

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float sacc[WKV / 2];
  // running maxima of the raw scores (-inf until a row sees a key) and
  // this thread's share of the running sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if (wrows > 0) mbar_wait(q_bar, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = k_first + i * WKV;
    mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
    if (k0 < hi && k0 + WKV > lo) {   // a tile with keys our rows see
      // S = Q K^T
      wgmma_fence();
      issue_s<D>(sacc, qs + wg * 64 * 128, ks + s * KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // mask (only tiles on the causal diagonal, the window's edge or
      // Skv's end): accumulator k*4 + {0,1} is row0, columns
      // 8k + 2t + {0,1}; k*4 + {2,3} is row0 + 8.  A masked score is -inf.
      if (k0 + WKV > Skv || (causal && k0 + WKV - 1 > plo) ||
          (window > 0 && k0 <= phi - window)) {
#pragma unroll
        for (int k = 0; k < WKV / 8; ++k) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kp = k0 + 8 * k + 2 * t + j;
            const bool in = kp < Skv;
            if (!(in && (!causal || kp <= qp0) &&
                  (window <= 0 || kp > qp0 - window)))
              sacc[4 * k + j] = -INFINITY;
            if (!(in && (!causal || kp <= qp1) &&
                  (window <= 0 || kp > qp1 - window)))
              sacc[4 * k + 2 + j] = -INFINITY;
          }
        }
      }
      // online softmax on the raw scores; a row's 128 columns lie on the
      // four threads of a quad.  The scale goes into the exponent:
      // p = 2^(s c - m c), one FFMA and one ex2 a score, c = scale log2 e
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int k = 0; k < WKV / 8; ++k) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * k], sacc[4 * k + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * k + 2], sacc[4 * k + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a row that has seen no key yet keeps p = 0 and its factor 1
      const float mc0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
      const float mc1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
      const float a0 = fast_exp2(m0 == -INFINITY ? 0.f : m0 * scale_log2 - mc0);
      const float a1 = fast_exp2(m1 == -INFINITY ? 0.f : m1 * scale_log2 - mc1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
      // P in bf16 as the A operand of the next wgmma: the f32 accumulator
      // of columns 16kk .. 16kk + 15 is, pair by pair, the A fragment of
      // step kk
      uint32_t pa[WKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < WKV / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          p[e] = fast_exp2(fmaf(sacc[8 * kk + e], scale_log2,
                                -((e & 2) ? mc1 : mc0)));
        sum0 += (p[0] + p[1]) + (p[4] + p[5]);
        sum1 += (p[2] + p[3]) + (p[6] + p[7]);
        pa[kk][0] = pack_bf16(p[0], p[1]);
        pa[kk][1] = pack_bf16(p[2], p[3]);
        pa[kk][2] = pack_bf16(p[4], p[5]);
        pa[kk][3] = pack_bf16(p[6], p[7]);
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
      // O holds the tiles before this one: rescale it to the new maxima
      // (skipping this when no row of the warp has a new maximum measured
      // slower: the vote cost more than the multiplies it saved)
#pragma unroll
      for (int k = 0; k < NO / 4; ++k) {
        oacc[4 * k] *= a0;
        oacc[4 * k + 1] *= a0;
        oacc[4 * k + 2] *= a1;
        oacc[4 * k + 3] *= a1;
      }

      // O += P V
      fence_regs(oacc);
      wgmma_fence();
      issue_pv<DT>(oacc, pa, vs + s * KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
    }
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);   // this warp is done
  }
  if (wrows <= 0) return;

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t q_row = (size_t)H * D;
  __nv_bfloat16* o0 = o + ((size_t)b * Sq + row0) * q_row + (size_t)h * D;
  __nv_bfloat16* o1 = o0 + 8 * q_row;
#pragma unroll
  for (int k = 0; k < D / 8; ++k) {   // columns 8k + 2t < D: none past D
    const int c = 8 * k + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(oacc[4 * k] * inv0, oacc[4 * k + 1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(
          oacc[4 * k + 2] * inv1, oacc[4 * k + 3] * inv1);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                   int KV, float scale_log2, int causal, int window,
                   int q_offset) {
  constexpr int DT = tile_cols<D>();
  constexpr int NSUB = DT / BOX_COLS;    // 64-column boxes a row block
  constexpr int Q_BYTES = WQ * DT * 2;   // TMA counts the zeros too
  constexpr int KV_BYTES = WKV * DT * 2; // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  // tiles at 1,024-byte boundaries: the swizzle is a function of the
  // address, and TMA and wgmma must agree on it
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + Q_BYTES;              // stage s at + s * KV_BYTES
  const uint32_t vs = ks + STAGES * KV_BYTES;
  const uint32_t q_bar = vs + STAGES * KV_BYTES;
  const uint32_t full_bar = q_bar + 8;           // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WQ;   // heaviest first
  const int kvh = h / (H / KV);

  // the kv tiles any row of the block can see
  const int rows = min(WQ, Sq - q0);
  const int pos_lo = q0 + q_offset, pos_hi = q0 + rows - 1 + q_offset;
  const int kv_end = causal ? min(Skv, pos_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int k_first = kv_begin / WKV * WKV;
  const int n_tiles = (kv_end - k_first + WKV - 1) / WKV;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, CONSUMERS / 32);   // a warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {   // the producer warp: one thread issues TMA
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_bar, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NSUB; ++c)
        tma_load_4d(qs + c * WQ * 128, &qmap, q_bar, c * BOX_COLS, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)   // both warpgroups are done with tile i - STAGES
          mbar_wait(empty_bar + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t bar = full_bar + 8 * s;
        mbar_expect_tx(bar, 2 * KV_BYTES);
        const int k0 = k_first + i * WKV;
#pragma unroll
        for (int c = 0; c < NSUB; ++c) {
          const uint32_t off = s * KV_BYTES + c * WKV * 128;
          tma_load_4d(ks + off, &kmap, bar, c * BOX_COLS, kvh, k0, b);
          tma_load_4d(vs + off, &vmap, bar, c * BOX_COLS, kvh, k0, b);
        }
      }
    }
  } else {
    flash_consumer<D>(qs, ks, vs, q_bar, full_bar, empty_bar, o, q0, h, b,
                      k_first, n_tiles, Sq, Skv, H, scale_log2, causal,
                      window, q_offset);
  }
}

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows a block
constexpr int BKV = 32;       // kv rows a tile
constexpr int NT = 256;       // threads a block: a 16 x 16 grid

// the 16 bytes at p (16-byte aligned) as 4 floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr int smem_floats() {
  // Qs [BQ][D+1], Ks [BKV][D+1], Vs [BKV][D], Ps [BQ][BKV+1], m, l, alpha
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1) + 3 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Skv, int H, int KV, float scale, int causal,
                 int window, int q_offset) {
  using T = float;
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
  // vectors a thread; the last round is partial at D = 112
  constexpr int QIT = (BQ * NVR + NT - 1) / NT;
  constexpr int KIT = (BKV * NVR + NT - 1) / NT;
  {
    float x[QIT][VEC];
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int i = tid + it * NT, r = i / NVR, c = (i % NVR) * VEC;
      if (r < BQ && q0 + r < Sq)
        load16(qb + (size_t)(q0 + r) * q_row + c, x[it]);
      else
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[it][e] = 0.f;
    }
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int i = tid + it * NT, r = i / NVR, c = (i % NVR) * VEC;
      if (r < BQ)
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
        if (r < BKV && k0 + r < Skv) {
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
        if (r >= BKV) continue;
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime so that
// the build needs no -lcuda; null if the driver lacks it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 [B, S, heads, D] tensor as a 4-D map of [rows, 64] boxes (one
// head, one sequence) with the 128-byte swizzle; reads past S, and past D
// in a box that starts below it (D = 112), are zeros.  TMA wants row
// pitches in multiples of 16 bytes: 2 D is 128, 224 or 256.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
               int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {BOX_COLS, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(1000 + (int)r);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Skv, int H, int KV, float scale, int causal,
                 int window, int q_offset, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int rc = tensor_map(&qmap, q, B, Sq, H, D, WQ);
  if (rc == 0) rc = tensor_map(&kmap, k, B, Skv, KV, D, WKV);
  if (rc == 0) rc = tensor_map(&vmap, v, B, Skv, KV, D, WKV);
  if (rc != 0) return rc;
  constexpr int smem = wgmma_smem_bytes<tile_cols<D>()>();
  auto kern = flash_wgmma_kernel<D>;
  static PerDeviceAttr smem_set;      // once a device: costs host time
  const int attr_rc = smem_set.ensure(smem, [&] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (attr_rc != 0) return attr_rc;
  const float log2e = 1.4426950408889634f;
  dim3 grid(H * B, (Sq + WQ - 1) / WQ);
  kern<<<grid, WG_THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KV,
      scale * log2e, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, float scale, int causal,
               int window, int q_offset, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fma_kernel<D>;
  static PerDeviceAttr smem_set;      // once a device: costs host time
  const int attr_rc = smem_set.ensure(smem, [&] {
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (attr_rc != 0) return attr_rc;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (flash_fma_kernel), 1 = bfloat16 (flash_wgmma_kernel).
// window <= 0 means none.  Returns the CUDA error of the launch (0 on
// success); -1 for an unsupported D/dtype; -2 when the driver has no
// cuTensorMapEncodeTiled, -(1000 + CUresult) when it refuses a tensor map.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      int dtype, float scale, int causal,
                                      int window, int q_offset,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_fma<64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                          window, q_offset, st);
  if (dtype == 0 && D == 112)
    return launch_fma<112>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                           window, q_offset, st);
  if (dtype == 0 && D == 128)
    return launch_fma<128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                           window, q_offset, st);
  if (dtype == 1 && D == 64)
    return launch_wgmma<64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                            window, q_offset, st);
  if (dtype == 1 && D == 112)
    return launch_wgmma<112>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                             window, q_offset, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                             window, q_offset, st);
  return -1;
}
