// Flash attention, forward and backward, for Hopper (sm_90a): hand-written
// CUDA C++ at f32 accuracy.
//
// Replaces the Pallas TPU kernels that carry the transformer cohort's local
// training and the global layers of serve prefill
// (src/repro/kernels/flash_attention/):
//   flash_fwd_kernel      <- fwd.py flash_fwd     (_kernel)
//   flash_bwd_dq_kernel   <- bwd.py flash_bwd     (_dq_kernel)
//   flash_bwd_dkv_kernel  <- bwd.py flash_bwd     (_dkv_kernel)
//
// Layouts (the JAX kernels'): q, out, dout, dq (B, KV, G, Sq, hd); k, v, dk,
// dv (B, Sk, KV, hd); lse, delta (B, KV, G, Sq); q_pos (Sq,), kv_pos (Sk,)
// int32 absolute positions. Key j is visible to query i when
// kv_pos[j] >= 0, and (causal) q_pos[i] >= kv_pos[j], and (window > 0)
// q_pos[i] - kv_pos[j] < window. Any Sq, Sk are taken; rows past the end
// of a tile are skipped.
//
// The masking convention is the reference's (ref.py), kept exactly: a
// masked score is the finite NEG_INF = -1e30, the running max starts
// there, and the normaliser is floored at 1e-30. So a query row with no
// visible key averages v over all Sk keys and gets lse = -1e30 + log(Sk),
// which rounds to -1e30 in f32; the backward then recomputes p = 1 on
// that row. A -inf convention would give NaN or 0 there instead.
//
// Bound: operations. At the main path's shapes (B = 8, KV = 2, G = 16,
// S = 2048, hd = 128, causal) the forward does ~275 GFLOP (2 products of
// hd-long dot products a visible (query, key) pair) and the backward
// ~2.5x that, against ~0.6 GB moved: hundreds of flops per byte. The
// reference is full f32, so TF32 alone is not allowed. Every product runs
// on the tensor cores at f32 accuracy as split TF32 ("3xTF32",
// tf32_mma.cuh): 3 tensor-core products per f32 one, so 495 / 3 =
// 165 TFLOP/s of f32-accurate work on the data sheet (2.5x the 67 TFLOP/s
// of f32 FFMA), or 323.6 / 3 = 108 TFLOP/s at the rate mma.sync reaches
// on the card (tools/mma_tf32_peak.cu). The long sums (o over the keys,
// dq over the keys, dk and dv over G x Sq rows) take each step's part
// from zeroed fragments and add it in f32 (step_sum), since the tensor
// cores' own accumulation cuts instead of rounding. The split costs
// integer and f32 instructions, which compete with the mma for the
// schedulers: a streamed tile, read by all 8 warps, is therefore split
// once when it lands (big in place, small beside it), while a resident
// tile, read by one warp each, is split at fragment load. Rows are padded
// to hd + 4 floats, so a warp's fragment loads are conflict-free. Tiles
// are copied with cp.async (16 bytes a thread, zero-filled past the end)
// into two stages, the next tile in flight while the current one is split
// and multiplied. Each warp owns 16 rows of a 128-row block; score tiles
// stay in the mma's registers and feed the next product as its A operand
// (a_from_acc), so p and dS never go through shared memory.
//
//   forward  one block per (b, kv head, g, 128 query rows): q resident
//            (scaled as it lands), 48-key steps of k, v streamed;
//            s = (q*scale) k^T, online softmax in f32, o = o*corr + p v;
//            writes out and lse = m + log(max(l, 1e-30)) (attn_fwd.cuh,
//            shared with swa_prefill). Shared memory at hd = 128 (rows of
//            132 floats): q 67,584 B, two stages of k and v 101,376 B, the
//            small parts of the tiles in use 50,688 B, positions and a
//            reduction 480 B: 220,128 B, one 8-warp block an SM (24- and
//            32-key steps measured slower, tools/attn_fwd_variants.py). At
//            hd = 256 (rows of 260 floats) q alone is 133,120 B and the
//            same tiles come to 432,640 B, over the 232,448 B a block may
//            use; 16-key steps still come to 232,960 B. So hd = 256 takes
//            64-row blocks with 16-key steps, 166,624 B, and each 16 rows
//            are shared by two warps, each owning half of hd's output
//            columns (o at 64 registers a lane; FwdGeom, attn_fwd.cuh).
//   dq       one block per (b, kv head, g, 128 query rows): q, dO
//            resident, 24-key tiles of k, v streamed; p = exp(s - lse),
//            dS = p * (dO v^T - delta), dq += dS k; dq *= scale at the end.
//            211,488 B of shared memory at hd = 128.
//   dk/dv    one block per (b, kv head, 128 keys): k, v resident, (g, 24
//            query rows) steps of q, dO, lse, delta streamed over the G
//            query heads of the group, dv += p^T dO and
//            dk += dS^T (q*scale). The sum over G stays inside one block:
//            no atomics, deterministic (two launches are bit-equal).
//            211,872 B of shared memory at hd = 128.
//   hd 256   the two resident tiles of a 128-row block (q and dO, or k and
//            v) alone take 2 x 128 x 260 x 4 = 266,240 B. 64-row blocks
//            halve that to 133,120 B, but two stages of 16-row steps with
//            their small parts (6 x 16 x 1,040 = 99,840 B) still come to
//            232,960 + 224 B; 8-row steps fit: dq 183,200 B, dk/dv
//            183,328 B. As in the forward, the 8 warps pair up on 16 rows
//            each, each warp owning half of hd's output columns (dq, or
//            dk and dv): the accumulators stay at 64 (dq) and 128 (dk/dv)
//            registers a lane, as at hd = 128, while both warps of a pair
//            form the whole S and dP (BwdGeom).
//   hd 192   (MLA's qk head dim) takes hd 256's shape, as every hd above
//            128 does: 64-row blocks, 16-key forward and 8-row backward
//            steps, each warp of a pair owning 96 output columns (12 mma
//            tiles: o 48 registers a lane). Rows are 196 floats (784 B,
//            16-byte copies stay aligned); shared memory comes to
//            125,664 B (forward), 138,144 B (dq) and 138,272 B (dk/dv).
//            Above hd 128 the contractions over hd (s, dP) are summed in
//            f32 64 products at a time (HdSum, tf32_mma.cuh): left to the
//            tensor cores' cut running sum, dq and dk missed the
//            reference's elementwise bound at the trainer shapes.
//   hd 8     DT = 1: a row is 8 floats (two 16-byte copies into a 12-float
//            padded row) and every fragment load (columns t, t + 4) lies
//            inside it.
//
// A (q tile, kv tile) pair with no visible (query, key) pair is skipped,
// which is what a causal mask above the diagonal gives; it is skipped only
// when every query row of the tile sees some key, since a row that sees
// none takes every key into its average (see above). Skipping is then
// exact: such a tile adds p = 0 after the row's first visible key and is
// wiped by the correction exp(-1e30 - m) = 0 before it. Every kernel asks
// ahead of each copy, 32 tiles at a time (one lane a tile), whether the
// position ranges of the tile pair allow a visible pair; a tile it keeps
// that holds none adds exactly 0 to every row that sees some key. The
// backward knows the rows that see no key from lse; the forward finds
// them after a pass and, only then, makes a second pass over every tile.
// A forward step whose every (query, key) pair sees each other (below the
// causal diagonal, inside the window) takes its scores unmasked.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), so a refused launch is reported. The Python
// wrappers (kernels/flash_attention/flash.py) check dtypes, shapes,
// contiguity and, for the 16-byte copies, the alignment of q, k, v and
// dout.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attn_fwd.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kDeadLse = -1e29f;  // lse of a row that saw no key

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || qp >= kp) &&
         (window <= 0 || qp - kp < window);
}

// ------------------------------------------------------------- forward
// One block per (b, kv head, g, kRows query rows), the longest rows
// first; warp w owns rows FwdGeom::row(w) .. + 15 and output columns
// FwdGeom::col(w) on. q is resident (scaled as it lands); kStep-key steps
// of k, v and their positions stream through two stages (attn_fwd.cuh).
// Two passes at most: the first skips every step in which no (query,
// key) pair of the block can see each other; a row that then has seen no
// key (it averages v over all Sk keys, see the header) sends the block
// through a second pass over every step.
template <int HD>
__global__ void __launch_bounds__(kTileThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, float* __restrict__ out,
                 float* __restrict__ lse, int KV, int G, int Sq, int Sk,
                 float scale, int causal, int window) {
  using Geom = FwdGeom<HD>;
  constexpr int BQ = Geom::kRows, BK = Geom::kStep;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  const KvStages<HD, float> kv(sQ + q_floats<HD>());
  int* sKpos = reinterpret_cast<int*>(sQ + q_floats<HD>() +
                                      KvStages<HD, float>::floats());
  int* sRed = sKpos + 2 * BK;                 // sKpos: 2 stages of BK

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, wr = Geom::row(warp), c0 = Geom::col(warp);
  const int bh = blockIdx.x;                  // (b, kv head, g)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // long rows first
  const int b = bh / (KV * G), kvh = (bh / G) % KV;
  const int64_t kstride = (int64_t)KV * HD, row0 = (int64_t)bh * Sq;
  const float* kb = k + ((int64_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((int64_t)b * Sk * KV + kvh) * HD;
  const int nk = (Sk + BK - 1) / BK;

  // rows q0 + wr + g and + 8 of this lane's fragments
  int qp[2];
  int lo = INT_MAX, hi = INT_MIN, unused = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wr + g + 8 * h;
    qp[h] = r < Sq ? qpos[r] : -1;
    if (r < Sq) {
      lo = min(lo, qp[h]);
      hi = max(hi, qp[h]);
    }
  }
  block_reduce(lo, hi, unused, sRed);
  load_q<HD>(sQ, q + row0 * HD, q0, Sq, scale);

  bool every = false;                         // the second pass
  auto chunk = [&](int cb) -> unsigned {
    const int j = cb + lane;
    bool live = j < nk && every;
    if (j < nk && !every) {
      int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll 8
      for (int i = 0; i < BK; ++i) {
        const int c = j * BK + i;
        const int p = c < Sk ? kpos[c] : -1;
        if (p >= 0) {
          kmin = min(kmin, p);
          kmax = max(kmax, p);
        }
      }
      live = may_see(lo, hi, kmin, kmax, causal, window);
    }
    return __ballot_sync(0xffffffffu, live);
  };
  auto fetch = [&](int j, int st) {
    kv.fetch(kb, vb, kstride, j * BK, Sk, st);
    if (tid < BK) {
      const int c = j * BK + tid;
      cp_async4(sKpos + st * BK + tid, kpos + (c < Sk ? c : 0), c < Sk);
    }
  };

  FwdRows<HD> a;
  for (;;) {
    a.init();
    bool seen[2] = {false, false};
    int base = -32;
    unsigned mask = 0;
    int cur = first_live(0, nk, base, mask, chunk), st = 0;
    if (cur < nk) fetch(cur, 0);
    cp_async_commit();
    while (cur < nk) {
      const int nxt = first_live(cur + 1, nk, base, mask, chunk);
      if (nxt < nk) fetch(nxt, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      kv.prepare(st);
      __syncthreads();
      const int* tKpos = sKpos + st * BK;
      const int k0 = cur * BK;
      // an interior step, whose every (query, key) pair of the block sees
      // each other, takes its scores unmasked (6% of the forward's time
      // on the causal main shape, tools/attn_fwd_variants.py)
      bool all_in = true;
      for (int c = lane; c < BK; c += 32) {
        const int p = tKpos[c];
        all_in &= k0 + c < Sk && p >= 0 && (!causal || p <= lo) &&
                  (window <= 0 || (int64_t)hi - p < window);
      }
      const bool interior = __all_sync(0xffffffffu, all_in);
      if (interior) seen[0] = seen[1] = true;
      fwd_step<HD, true>(
          sQ, wr, c0, kv.big(st, 0), kv.small(0), kv.big(st, 1), kv.small(1),
          a,
          [&](int h, int c, float x) -> float {
            if (interior) return x;
            if (k0 + c >= Sk) return -INFINITY;   // no such key
            const bool vis = visible(qp[h], tKpos[c], causal, window);
            seen[h] |= vis;
            return vis ? x : kNegInf;
          });
      __syncthreads();        // this stage is free for the next copy
      st ^= 1;
      cur = nxt;
    }
    cp_async_wait<0>();
    const bool dead = (q0 + wr + g < Sq && !seen[0]) ||
                      (q0 + wr + g + 8 < Sq && !seen[1]);
    if (every || !__syncthreads_or(dead)) break;
    every = true;
  }
  fwd_store<HD>(a, out, lse, row0, q0 + wr, c0, Sq);
}

// ------------------------------------------------------------- backward
// Split-TF32 ("3xTF32") tensor-core products at f32 accuracy over tiles
// copied asynchronously (cp.async) into shared memory; see the header.

constexpr int kBwdThreads = kTileThreads;   // 8 warps, 16 rows each
constexpr int kBwdWarps = kBwdThreads / 32;

// The backward's block shape at head dim HD (see the header): hd <= 128,
// 128 rows (query rows for dq, keys for dk/dv) a block, one warp a 16-row
// tile, 24-row steps; hd = 256, 64 rows a block, 8-row steps, two warps a
// 16-row tile, each owning kCols = 128 of the output columns.
template <int HD>
struct BwdGeom {
  static constexpr int kColSplit = HD > 128 ? 2 : 1;
  static constexpr int kRowWarps = kBwdWarps / kColSplit;
  static constexpr int kRows = 16 * kRowWarps;   // rows of a block
  static constexpr int kStep = HD > 128 ? 8 : 24;  // keys (dq) or query rows
  static constexpr int kCols = HD / kColSplit;   // output columns a warp
  static_assert(kStep % 8 == 0 && kCols % 8 == 0, "whole 8-wide mma tiles");
  __device__ static int row(int warp) {
    return 16 * (kColSplit > 1 ? warp % kRowWarps : warp);
  }
  __device__ static int col(int warp) {
    return kColSplit > 1 ? (warp / kRowWarps) * kCols : 0;
  }
};

// ------------------------------------------------------------------ dq
// One block per (b, kv head, g, kRows query rows); warp w owns rows
// BwdGeom::row(w) .. + 15 and dq's columns from BwdGeom::col(w). q and dO
// stay in shared memory; kStep-key tiles of k and v stream through two
// stages. S = q k^T (times scale) and dP = dO v^T are
// 16 x 24 per warp; dS is formed in their registers and multiplies k as
// the A operand (a_from_acc), so it never goes through shared memory.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    int KV, int G, int Sq, int Sk, float scale, int causal,
                    int window) {
  using Geom = BwdGeom<HD>;
  constexpr int LD = tile_ld<HD>(), BQ = Geom::kRows, BK = Geom::kStep;
  constexpr int NT = BK / 8, DT = Geom::kCols / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + BQ * LD;
  float* sK = sDO + BQ * LD;               // 2 stages of BK x LD
  float* sV = sK + 2 * BK * LD;
  float* sKs = sV + 2 * BK * LD;           // small parts of the stage in use
  float* sVs = sKs + BK * LD;
  int* sKpos = reinterpret_cast<int*>(sVs + BK * LD);      // 2 x BK
  int* sRed = sKpos + 2 * BK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = Geom::row(warp), c0 = Geom::col(warp);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // long rows first
  const int b = bh / (KV * G), kvh = (bh / G) % KV;
  const int64_t kstride = (int64_t)KV * HD, row0 = (int64_t)bh * Sq;
  const float* kb = k + ((int64_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((int64_t)b * Sk * KV + kvh) * HD;
  const int nk = (Sk + BK - 1) / BK;

  copy_tile<HD, BQ>(sQ, q + row0 * HD, HD, q0, Sq);
  copy_tile<HD, BQ>(sDO, dout + row0 * HD, HD, q0, Sq);
  cp_async_commit();

  // rows q0 + wr + g and + 8 of this lane's fragments
  int qp[2];
  float ls[2], dl[2];
  int lo = INT_MAX, hi = INT_MIN, dead = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wr + g + 8 * h;
    const bool in = r < Sq;
    qp[h] = in ? qpos[r] : -1;
    ls[h] = in ? lse[row0 + r] : 0.f;
    dl[h] = in ? delta[row0 + r] : 0.f;
    if (in) {
      lo = min(lo, qp[h]);
      hi = max(hi, qp[h]);
      dead |= ls[h] < kDeadLse;
    }
  }
  block_reduce(lo, hi, dead, sRed);
  // a key tile is skipped only when every row sees some key (see header)
  auto chunk = [&](int cb) -> unsigned {
    const int j = cb + lane;
    bool live = j < nk && dead;
    if (j < nk && !dead) {
      int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll 8
      for (int i = 0; i < BK; ++i) {
        const int c = j * BK + i;
        const int p = c < Sk ? kpos[c] : -1;
        if (p >= 0) {
          kmin = min(kmin, p);
          kmax = max(kmax, p);
        }
      }
      live = may_see(lo, hi, kmin, kmax, causal, window);
    }
    return __ballot_sync(0xffffffffu, live);
  };
  auto fetch = [&](int j, int st) {
    copy_tile<HD, BK>(sK + st * BK * LD, kb, kstride, j * BK, Sk);
    copy_tile<HD, BK>(sV + st * BK * LD, vb, kstride, j * BK, Sk);
    if (tid < BK) {
      const int c = j * BK + tid;
      cp_async4(sKpos + st * BK + tid, kpos + (c < Sk ? c : 0), c < Sk);
    }
  };

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int base = -32;
  unsigned mask = 0;
  int cur = first_live(0, nk, base, mask, chunk), st = 0;
  if (cur < nk) fetch(cur, 0);
  cp_async_commit();
  while (cur < nk) {
    const int nxt = first_live(cur + 1, nk, base, mask, chunk);
    if (nxt < nk) fetch(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* tK = sK + st * BK * LD;
    float* tV = sV + st * BK * LD;
    const int* tKpos = sKpos + st * BK;
    split_tile<HD, BK>(tK, sKs);
    split_tile<HD, BK>(tV, sVs);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    HdSum<HD, NT> hs, hp;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      hs.begin(kk);
      hp.begin(kk);
      const FragA a = load_a<LD>(sQ, wr, kk);
      const FragA o = load_a<LD>(sDO, wr, kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma3(hs.into(s, nt), a, load_bt<LD>(tK, sKs, 8 * nt, kk));
        mma3(hp.into(dp, nt), o, load_bt<LD>(tV, sVs, 8 * nt, kk));
      }
      hs.end(s, kk);
      hp.end(dp, kk);
    }
    // dS = p * (dP - delta), p = exp(s - lse); element e of tile nt is
    // (row g + 8 (e / 2), key 8 nt + 2 t + e % 2)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = 8 * nt + 2 * t + (e & 1);
        float ds = 0.f;
        if (cur * BK + c < Sk) {
          const float x = visible(qp[h], tKpos[c], causal, window)
                              ? s[nt][e] * scale : kNegInf;
          ds = expf(x - ls[h]) * (dp[nt][e] - dl[h]);
        }
        s[nt][e] = ds;
      }
    // dq += dS k, this step's part first in zeroed fragments (step_sum)
    FragA da[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) da[nt] = a_from_acc(s[nt]);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float part[4] = {};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma3(part, da[nt], load_bp<LD>(tK, sKs, 8 * nt, c0 + 8 * dt));
      step_sum(acc[dt], part);
    }
    __syncthreads();          // this stage is free for the next copy
    st ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wr + g + 8 * h;
    if (r >= Sq) continue;
    float* row = dq + (row0 + r) * HD + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(row + 8 * dt) =
          make_float2(acc[dt][2 * h] * scale, acc[dt][2 * h + 1] * scale);
  }
}

// --------------------------------------------------------------- dk/dv
// One block per (b, kv head, kRows keys); warp w owns keys BwdGeom::row(w)
// .. + 15 and dk's and dv's columns from BwdGeom::col(w). k and v stay in
// shared memory; (g, kStep query rows) steps of q, dO, lse,
// delta and positions stream through two stages, every g of the group in
// order, so the sum over G stays inside the block: no atomics,
// deterministic. S^T = k q^T (times scale) and dP^T = v dO^T are 16 x 24
// per warp; p^T and dS^T are formed in their registers and multiply dO
// and q as A operands (a_from_acc); dk takes the scale at the end.
template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, int KV, int G, int Sq, int Sk,
                     float scale, int causal, int window) {
  using Geom = BwdGeom<HD>;
  constexpr int LD = tile_ld<HD>(), BKV = Geom::kRows, BQ = Geom::kStep;
  constexpr int NT = BQ / 8, DT = Geom::kCols / 8;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;               // 2 stages of BQ x LD
  float* sDO = sQ + 2 * BQ * LD;
  float* sQs = sDO + 2 * BQ * LD;          // small parts of the stage in use
  float* sDOs = sQs + BQ * LD;
  float* sLse = sDOs + BQ * LD;            // 2 x BQ each
  float* sDelta = sLse + 2 * BQ;
  int* sQpos = reinterpret_cast<int*>(sDelta + 2 * BQ);
  int* sRed = sQpos + 2 * BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = Geom::row(warp), c0 = Geom::col(warp);
  const int bk = blockIdx.x;                       // (b, kv head)
  const int k0 = blockIdx.y * BKV;
  const int b = bk / KV, kvh = bk % KV;
  const int64_t kstride = (int64_t)KV * HD;
  const int64_t kvoff = ((int64_t)b * Sk * KV + kvh) * HD;
  const int nq = (Sq + BQ - 1) / BQ, n = G * nq;   // steps (g, q tile)

  copy_tile<HD, BKV>(sK, k + kvoff, kstride, k0, Sk);
  copy_tile<HD, BKV>(sV, v + kvoff, kstride, k0, Sk);
  cp_async_commit();

  // keys k0 + wk + g and + 8 of this lane's fragments (-1: past Sk)
  int kp[2];
  int lo = INT_MAX, hi = INT_MIN, unused = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = k0 + wk + g + 8 * h;
    kp[h] = c < Sk ? kpos[c] : -1;
    if (kp[h] >= 0) {
      lo = min(lo, kp[h]);
      hi = max(hi, kp[h]);
    }
  }
  block_reduce(lo, hi, unused, sRed);
  // a step runs when some pair of it may see each other, or when one of
  // its rows sees no key at all (that row takes every key; see header)
  auto chunk = [&](int cb) -> unsigned {
    const int i = cb + lane;
    bool live = false;
    if (i < n) {
      const int gg = i / nq, r0 = (i % nq) * BQ;
      const float* l = lse + ((int64_t)bk * G + gg) * Sq;
      int qmin = INT_MAX, qmax = INT_MIN;
      bool dead = false;
#pragma unroll 8
      for (int r = 0; r < BQ; ++r) {
        if (r0 + r < Sq) {
          const int p = qpos[r0 + r];
          qmin = min(qmin, p);
          qmax = max(qmax, p);
          dead |= l[r0 + r] < kDeadLse;
        }
      }
      live = dead || may_see(qmin, qmax, lo, hi, causal, window);
    }
    return __ballot_sync(0xffffffffu, live);
  };
  auto fetch = [&](int i, int st) {
    const int gg = i / nq, r0 = (i % nq) * BQ;
    const int64_t row0 = ((int64_t)bk * G + gg) * Sq;   // (b, kvh, g) rows
    copy_tile<HD, BQ>(sQ + st * BQ * LD, q + row0 * HD, HD, r0, Sq);
    copy_tile<HD, BQ>(sDO + st * BQ * LD, dout + row0 * HD, HD, r0, Sq);
    if (tid < BQ) {
      const int r = r0 + tid;
      const bool ok = r < Sq;
      const int64_t at = row0 + (ok ? r : 0);
      cp_async4(sLse + st * BQ + tid, lse + at, ok);
      cp_async4(sDelta + st * BQ + tid, delta + at, ok);
      cp_async4(sQpos + st * BQ + tid, qpos + (ok ? r : 0), ok);
    }
  };

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  int base = -32;
  unsigned mask = 0;
  int cur = first_live(0, n, base, mask, chunk), st = 0;
  if (cur < n) fetch(cur, 0);
  cp_async_commit();
  while (cur < n) {
    const int nxt = first_live(cur + 1, n, base, mask, chunk);
    if (nxt < n) fetch(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* tQ = sQ + st * BQ * LD;
    float* tDO = sDO + st * BQ * LD;
    const float* tLse = sLse + st * BQ;
    const float* tDelta = sDelta + st * BQ;
    const int* tQpos = sQpos + st * BQ;
    const int r0 = (cur % nq) * BQ;
    split_tile<HD, BQ>(tQ, sQs);
    split_tile<HD, BQ>(tDO, sDOs);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    HdSum<HD, NT> hs, hp;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      hs.begin(kk);
      hp.begin(kk);
      const FragA a = load_a<LD>(sK, wk, kk);
      const FragA w = load_a<LD>(sV, wk, kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma3(hs.into(s, nt), a, load_bt<LD>(tQ, sQs, 8 * nt, kk));
        mma3(hp.into(dp, nt), w, load_bt<LD>(tDO, sDOs, 8 * nt, kk));
      }
      hs.end(s, kk);
      hp.end(dp, kk);
    }
    // p^T and dS^T; element e of tile nt is (key g + 8 (e / 2), query row
    // 8 nt + 2 t + e % 2)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = 8 * nt + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (r0 + r < Sq) {
          const float x = visible(tQpos[r], kp[h], causal, window)
                              ? s[nt][e] * scale : kNegInf;
          p = expf(x - tLse[r]);
          ds = p * (dp[nt][e] - tDelta[r]);
        }
        s[nt][e] = p;
        dp[nt][e] = ds;
      }
    // dv += p^T dO, then dk += dS^T q (times scale at the end), this
    // step's part first in zeroed fragments (step_sum); one product at a
    // time keeps the split A operands of only one live
    auto accumulate = [&](const float(&x)[NT][4], const float* big,
                          const float* small, float(&out)[DT][4]) {
      FragA a[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) a[nt] = a_from_acc(x[nt]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        float part[4] = {};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3(part, a[nt], load_bp<LD>(big, small, 8 * nt, c0 + 8 * dt));
        step_sum(out[dt], part);
      }
    };
    accumulate(s, tDO, sDOs, dva);
    accumulate(dp, tQ, sQs, dka);
    __syncthreads();          // this stage is free for the next copy
    st ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = k0 + wk + g + 8 * h;
    if (c >= Sk) continue;
    const int64_t off = kvoff + (int64_t)c * kstride + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<float2*>(dk + off + 8 * dt) =
          make_float2(dka[dt][2 * h] * scale, dka[dt][2 * h + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * dt) =
          make_float2(dva[dt][2 * h], dva[dt][2 * h + 1]);
    }
  }
}

// Shared memory of each kernel, in bytes.
template <int HD>
constexpr size_t fwd_smem() {
  return (q_floats<HD>() + KvStages<HD, float>::floats()) * sizeof(float) +
         (2 * FwdGeom<HD>::kStep + 3 * kTileWarps) * sizeof(int);
}
template <int HD>
constexpr size_t dq_smem() {
  using G = BwdGeom<HD>;
  return (2 * G::kRows + 6 * G::kStep) * (HD + 4) * sizeof(float) +
         (2 * G::kStep + 3 * kBwdWarps) * sizeof(int);
}
template <int HD>
constexpr size_t dkv_smem() {
  using G = BwdGeom<HD>;
  return ((2 * G::kRows + 6 * G::kStep) * (HD + 4) + 4 * G::kStep) *
             sizeof(float) +
         (2 * G::kStep + 3 * kBwdWarps) * sizeof(int);
}
template <int HD>
constexpr bool fits() {
  return fwd_smem<HD>() <= 232448 && dq_smem<HD>() <= 232448 &&
         dkv_smem<HD>() <= 232448;
}
static_assert(fits<8>() && fits<16>() && fits<32>() && fits<64>() &&
                  fits<128>() && fits<192>() && fits<256>(),
              "a block fits the 227 KB a block may use");

int ceil_div(int n, int d) { return (n + d - 1) / d; }

template <int HD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       const int* qpos, const int* kpos, float* out,
                       float* lse, int B, int KV, int G, int Sq, int Sk,
                       float scale, int causal, int window, cudaStream_t s) {
  const size_t smem = fwd_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * KV * G, ceil_div(Sq, FwdGeom<HD>::kRows));
  flash_fwd_kernel<HD><<<grid, kTileThreads, smem, s>>>(
      q, k, v, qpos, kpos, out, lse, KV, G, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const int* qpos, const int* kpos, const float* lse,
                      const float* delta, const float* dout, float* dq, int B,
                      int KV, int G, int Sq, int Sk, float scale, int causal,
                      int window, cudaStream_t s) {
  const size_t smem = dq_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * KV * G, ceil_div(Sq, BwdGeom<HD>::kRows));
  flash_bwd_dq_kernel<HD><<<grid, kBwdThreads, smem, s>>>(
      q, k, v, qpos, kpos, lse, delta, dout, dq, KV, G, Sq, Sk, scale,
      causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const int* qpos, const int* kpos, const float* lse,
                       const float* delta, const float* dout, float* dk,
                       float* dv, int B, int KV, int G, int Sq, int Sk,
                       float scale, int causal, int window, cudaStream_t s) {
  const size_t smem = dkv_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * KV, ceil_div(Sk, BwdGeom<HD>::kRows));
  flash_bwd_dkv_kernel<HD><<<grid, kBwdThreads, smem, s>>>(
      q, k, v, qpos, kpos, lse, delta, dout, dk, dv, KV, G, Sq, Sk, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// Head dims the kernels are built for: 8 to 256, powers of two, and 192
// (MLA's qk head dim).
#define FLASH_HD_SWITCH(hd, LAUNCH)              \
  switch (hd) {                                  \
    case 8: return (int)LAUNCH(8);               \
    case 16: return (int)LAUNCH(16);             \
    case 32: return (int)LAUNCH(32);             \
    case 64: return (int)LAUNCH(64);             \
    case 128: return (int)LAUNCH(128);           \
    case 192: return (int)LAUNCH(192);           \
    case 256: return (int)LAUNCH(256);           \
    default: return (int)cudaErrorInvalidValue;  \
  }

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int flash_fwd(const float* q, const float* k, const float* v, const int* qpos,
              const int* kpos, float* out, float* lse, int B, int KV, int G,
              int Sq, int Sk, int hd, float scale, int causal, int window,
              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(HD) launch_fwd<HD>(q, k, v, qpos, kpos, out, lse, B, KV, G, Sq, \
                                Sk, scale, causal, window, s)
  FLASH_HD_SWITCH(hd, CALL)
#undef CALL
}

int flash_bwd_dq(const float* q, const float* k, const float* v,
                 const int* qpos, const int* kpos, const float* lse,
                 const float* delta, const float* dout, float* dq, int B,
                 int KV, int G, int Sq, int Sk, int hd, float scale,
                 int causal, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(HD) launch_dq<HD>(q, k, v, qpos, kpos, lse, delta, dout, dq, B, \
                               KV, G, Sq, Sk, scale, causal, window, s)
  FLASH_HD_SWITCH(hd, CALL)
#undef CALL
}

int flash_bwd_dkv(const float* q, const float* k, const float* v,
                  const int* qpos, const int* kpos, const float* lse,
                  const float* delta, const float* dout, float* dk, float* dv,
                  int B, int KV, int G, int Sq, int Sk, int hd, float scale,
                  int causal, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(HD) launch_dkv<HD>(q, k, v, qpos, kpos, lse, delta, dout, dk, \
                                dv, B, KV, G, Sq, Sk, scale, causal, window, s)
  FLASH_HD_SWITCH(hd, CALL)
#undef CALL
}

// Dynamic shared memory each kernel's launch requests at head dim hd, in
// bytes: kernel 0 flash_fwd, 1 flash_bwd_dq, 2 flash_bwd_dkv.
int flash_smem_bytes(int kernel, int hd) {
#define CALL(HD) (kernel == 0 ? fwd_smem<HD>() \
                  : kernel == 1 ? dq_smem<HD>() : dkv_smem<HD>())
  FLASH_HD_SWITCH(hd, CALL)
#undef CALL
}

}  // extern "C"
