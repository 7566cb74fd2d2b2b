// The attention forward of flash_fwd_kernel (flash_attention.cu) and
// swa_prefill_kernel (swa_attention.cu) on split-TF32 tensor cores
// (tf32_mma.cuh), at f32 accuracy.
//
// A block of 8 warps owns 128 query rows, 16 a warp, and walks its key
// steps in order (hd <= 128; FwdGeom below gives hd = 256 its own shape).
// q is resident: loaded once, scaled by hd^-1/2 as it lands, kept in
// shared memory and split at fragment load. k and v stream in steps of
// FwdGeom<HD>::kStep keys through two cp.async stages, the next step in
// flight while the current one is multiplied. An f32 tile is split once
// when it lands (big in place, small beside it); a bf16 tile is widened to
// f32 as it lands and, being a TF32 value, has no small part, so its
// products take two mma instead of three. Per step and warp:
//   s = (q scale) k^T      16 x kStep in the mma's registers (mma3 /
//                          mma2 against load_bt; above hd 128 summed in
//                          f32 64 products at a time, HdSum);
//   mask                   in the accumulator layout: lane (g, t) holds
//                          rows g and g + 8, columns 2t and 2t + 1 of each
//                          8-key tile; the caller's score(h, c, x) gives
//                          the masked score of row g + 8h, step column c;
//   online softmax         row max and sum over the 4 lanes of a row
//                          (shuffles 1 and 2), all in f32 (exp as
//                          __expf);
//   o = o corr + p v       p = exp(s - m) goes from the registers straight
//                          into the A operand (a_from_acc), v's rows
//                          permuted to match (load_bp): p never touches
//                          shared memory. The step's part is summed in
//                          zeroed fragments and added to o in f32, since
//                          the tensor cores' own accumulation cuts instead
//                          of rounding (step_sum, tf32_mma.cuh).
// o (16 rows x the warp's output columns) lives in f32 registers;
// out = o / max(l, 1e-30), lse = m + log(max(l, 1e-30)), as ref.py. Sums
// keep one order, so two launches are bit-equal.
//
// The masking convention is the reference's (ref.py): a masked key scores
// the finite NEG_INF = -1e30 and the running max starts there, so until a
// row's first visible key every masked key weighs exp(0) = 1, and the
// correction exp(-1e30 - m) = 0 wipes them when it comes; keys past the
// end score -inf and weigh 0. A row that sees no key therefore averages v
// over every key.

#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "tf32_mma.cuh"

#ifndef ATTN_FWD_STEP
#define ATTN_FWD_STEP 48
#endif

namespace {

constexpr float kNegInf = -1e30f;              // ref.py NEG_INF

// The block's shape at head dim HD. hd <= 128: 8 warps of 16 query rows
// (128 rows), ATTN_FWD_STEP-key steps, each warp all of hd's output
// columns (o: hd / 2 registers a lane). At hd = 256 (rows of 260 floats)
// that shape needs 432,640 B of shared memory and 16-key steps still
// 232,960, over the 232,448 B a block may use, and o alone would take 128
// registers a lane. So hd = 256 takes 64 query rows a block in 16-key
// steps, 166,400 B (q 66,560, two f32 stages of k and v 66,560, the small
// parts of the tiles in use 33,280; bf16 132,608), and the 8 warps pair
// up: warps w and w + 4 own the same 16 rows, each a half of the output
// columns (o: 64 registers a lane, as at hd = 128). Both of a pair take
// the whole s = q k^T and its softmax (the pair's s products are done
// twice; p v is not), so the arithmetic per output stays the hd <= 128
// path's. hd = 192 (MLA) takes the same shape: 96 columns a warp (o: 48
// registers a lane), 125,440 B.
template <int HD>
struct FwdGeom {
  static constexpr int kColSplit = HD > 128 ? 2 : 1;  // warps a row group
  static constexpr int kRowWarps = kTileWarps / kColSplit;
  static constexpr int kRows = 16 * kRowWarps;        // query rows a block
  static constexpr int kStep = HD > 128 ? 16 : ATTN_FWD_STEP;  // keys a step
  static constexpr int kCols = HD / kColSplit;        // output columns a warp
  static_assert(kStep % 8 == 0 && kCols % 8 == 0, "whole 8-wide mma tiles");
  // the warp's first row in the block and its first output column
  __device__ static int row(int warp) {
    return 16 * (kColSplit > 1 ? warp % kRowWarps : warp);
  }
  __device__ static int col(int warp) {
    return kColSplit > 1 ? (warp / kRowWarps) * kCols : 0;
  }
};

// Shared memory of the resident q, in floats.
template <int HD>
__host__ __device__ constexpr size_t q_floats() {
  return (size_t)FwdGeom<HD>::kRows * tile_ld<HD>();
}

// Rows [row0, row0 + kRows) of a slab of rows of hd elements, times
// scale, into sQ (row stride hd + 4); rows >= n read as 0. Plain loads: q
// is read once a block. hd = 8: two 16-byte (f32) or 8-byte (bf16) loads
// a row, every one inside its row.
template <int HD, typename T>
__device__ __forceinline__ void load_q(float* sQ, const T* __restrict__ g,
                                       int row0, int n, float scale) {
  constexpr int LD = tile_ld<HD>(), CPR = HD / 4;
  for (int i = threadIdx.x; i < FwdGeom<HD>::kRows * CPR;
       i += kTileThreads) {
    const int r = i / CPR, c = (i % CPR) * 4, row = row0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < n) {
      const T* p = g + (int64_t)row * HD + c;
      if constexpr (sizeof(T) == sizeof(float)) {
        const float4 y = *reinterpret_cast<const float4*>(p);
        x[0] = y.x; x[1] = y.y; x[2] = y.z; x[3] = y.w;
      } else {
        const uint2 y = *reinterpret_cast<const uint2*>(p);
        x[0] = __uint_as_float(y.x << 16);
        x[1] = __uint_as_float(y.x & 0xffff0000u);
        x[2] = __uint_as_float(y.y << 16);
        x[3] = __uint_as_float(y.y & 0xffff0000u);
      }
    }
    *reinterpret_cast<float4*>(sQ + r * LD + c) = make_float4(
        x[0] * scale, x[1] * scale, x[2] * scale, x[3] * scale);
  }
}

// The k and v tiles of a step: two stages in flight (cp.async, 16 bytes a
// copy, rows past the end zero-filled), and the tile in use made ready
// for the tensor cores. f32 (T = float): a stage is split in place (big)
// with its small part in `work`. bf16: a stage lands as it is (row stride
// hd) and is widened into `work`, small part zero. hd = 8: an f32 row is
// two 16-byte copies into a 12-float row (48 B, 16-byte aligned), a bf16
// row one copy of all its 16 bytes, widened as one 8-element group.
template <int HD, typename T>
struct KvStages {
  static constexpr int LD = tile_ld<HD>(), BK = FwdGeom<HD>::kStep;
  static constexpr bool kSplit = sizeof(T) == sizeof(float);
  static constexpr int LLD = kSplit ? LD : HD;     // landing row stride
  static constexpr size_t kLandFloats = 4 * (size_t)BK * LLD * sizeof(T) /
                                        sizeof(float);

  T* land;       // [stage][k, v][BK x LLD]
  float* work;   // [k, v][BK x LD]

  // Shared memory, in floats, from `at` on.
  __host__ __device__ static constexpr size_t floats() {
    return kLandFloats + 2 * (size_t)BK * LD;
  }
  __device__ explicit KvStages(float* at)
      : land(reinterpret_cast<T*>(at)), work(at + kLandFloats) {}

  __device__ T* landing(int st, int kv) const {
    return land + (2 * st + kv) * BK * LLD;
  }
  // The tile of k (kv = 0) or v (kv = 1) in use: big parts, small parts.
  __device__ const float* big(int st, int kv) const {
    if constexpr (kSplit)
      return reinterpret_cast<const float*>(landing(st, kv));
    return work + kv * BK * LD;
  }
  __device__ const float* small(int kv) const { return work + kv * BK * LD; }

  // Rows [row0, row0 + BK) of k and v (row r of a slab at r * stride),
  // rows >= n zero-filled, into stage st.
  __device__ void fetch(const T* kb, const T* vb, int64_t stride, int row0,
                        int n, int st) const {
    constexpr int E = 16 / sizeof(T), CPR = HD / E;
    for (int i = threadIdx.x; i < 2 * BK * CPR; i += kTileThreads) {
      const int kv = i / (BK * CPR), j = i % (BK * CPR);
      const int r = j / CPR, c = (j % CPR) * E, row = row0 + r;
      const bool ok = row < n;
      cp_async16(landing(st, kv) + r * LLD + c,
                 (kv ? vb : kb) + (ok ? row : 0) * stride + c, ok);
    }
  }

  // Stage st, landed, made ready: split (f32) or widened (bf16).
  __device__ void prepare(int st) const {
    if constexpr (kSplit) {
      split_tile<HD, BK>(reinterpret_cast<float*>(landing(st, 0)), work);
      split_tile<HD, BK>(reinterpret_cast<float*>(landing(st, 1)),
                         work + BK * LD);
    } else {
      constexpr int CPR = HD / 8;
      for (int i = threadIdx.x; i < 2 * BK * CPR; i += kTileThreads) {
        const int kv = i / (BK * CPR), j = i % (BK * CPR);
        const int r = j / CPR, c = (j % CPR) * 8;
        const uint4 x =
            *reinterpret_cast<const uint4*>(landing(st, kv) + r * HD + c);
        float* w = work + kv * BK * LD + r * LD + c;
        *reinterpret_cast<float4*>(w) = make_float4(
            __uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
            __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
        *reinterpret_cast<float4*>(w + 4) = make_float4(
            __uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
            __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
      }
    }
  }
};

// One lane's share of its warp's 16 rows: rows g and g + 8 (h = 0, 1),
// over the warp's kCols output columns.
template <int HD>
struct FwdRows {
  static constexpr int DT = FwdGeom<HD>::kCols / 8;
  float m[2], l[2], o[DT][4];

  __device__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  }
};

// One key step of one warp (rows wr .. wr + 15, output columns c0 ..
// c0 + kCols - 1): s = q k^T, masked by score(h, c, s) (row g + 8h, step
// column c), online softmax, o += p v. SPLIT: k and v have small parts
// (f32 operands).
template <int HD, bool SPLIT, typename Score>
__device__ __forceinline__ void fwd_step(const float* sQ, int wr, int c0,
                                         const float* kb,
                                         const float* ks, const float* vb,
                                         const float* vs, FwdRows<HD>& a,
                                         Score score) {
  constexpr int LD = tile_ld<HD>(), NT = FwdGeom<HD>::kStep / 8;
  constexpr int DT = FwdRows<HD>::DT;
  const int t = threadIdx.x & 3;
  auto mma = [](float(&c)[4], const FragA& x, const FragB& y) {
    if constexpr (SPLIT) mma3(c, x, y);
    else mma2(c, x, y);
  };

  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  HdSum<HD, NT> hs;                   // above hd 128: see tf32_mma.cuh
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    hs.begin(kk);
    const FragA qa = load_a<LD>(sQ, wr, kk);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma(hs.into(s, nt), qa, load_bt<LD>(kb, ks, 8 * nt, kk));
    hs.end(s, kk);
  }

  // element e of tile nt is (row g + 8 (e / 2), step column 8 nt + 2 t +
  // e % 2)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      s[nt][e] = score(h, 8 * nt + 2 * t + (e & 1), s[nt][e]);
      mx[h] = fmaxf(mx[h], s[nt][e]);
    }
  // exp as __expf, ex2.approx of x log2(e): 2 instructions instead of
  // expf's ~10, within a few ulp where a weight matters (|x| small), 0 at
  // x = -inf or -1e30; corr scales o and l alike, so out = o / l keeps f32
  // accuracy (2-4% of the forward's time, tools/attn_fwd_variants.py)
  float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(a.m[h], mx[h]);
    corr[h] = __expf(a.m[h] - m_new);
    a.m[h] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      s[nt][e] = __expf(s[nt][e] - a.m[h]);
      sum[h] += s[nt][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    a.l[h] = a.l[h] * corr[h] + sum[h];
  }

  FragA pa[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) pa[nt] = a_from_acc(s[nt]);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma(part, pa[nt], load_bp<LD>(vb, vs, 8 * nt, c0 + 8 * dt));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a.o[dt][e] = a.o[dt][e] * corr[e >> 1] + part[e];
  }
}

// out = o / max(l, 1e-30) for the rows r0 + g, r0 + g + 8 below n of a
// slab whose row r is at out + (row0 + r) * hd, columns c0 .. c0 + kCols
// - 1; lse = m + log(max(l, 1e-30)) beside it when lse is given (by the
// warp of column 0).
template <int HD>
__device__ __forceinline__ void fwd_store(const FwdRows<HD>& a,
                                          float* __restrict__ out,
                                          float* __restrict__ lse,
                                          int64_t row0, int r0, int c0,
                                          int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= n) continue;
    const float ls = fmaxf(a.l[h], 1e-30f);
    float* row = out + (row0 + r) * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < FwdRows<HD>::DT; ++dt)
      *reinterpret_cast<float2*>(row + 8 * dt) =
          make_float2(a.o[dt][2 * h] / ls, a.o[dt][2 * h + 1] / ls);
    if (lse != nullptr && t == 0 && c0 == 0)
      lse[row0 + r] = a.m[h] + logf(ls);
  }
}

}  // namespace
