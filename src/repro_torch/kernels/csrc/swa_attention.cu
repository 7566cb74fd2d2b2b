// Sliding-window attention for serving, for Hopper (sm_90a): hand-written
// CUDA C++, f32 arithmetic on f32 or bf16 operands.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/swa_attention/:
//   swa_decode_kernel      <- decode.py  swa_decode  (_kernel)
//   swa_prefill_kernel     <- prefill.py swa_prefill (_kernel)
//
// Layouts (the JAX kernels'): decode q, out (B, KV, G, hd); prefill q, out
// (B, KV, G, S, hd); k, v (B, S, KV, hd), the model's cache layout, read
// as it is; key_pos (S,) int32. Operands are f32 or bf16 (prefill: q, k
// and v of one type; decode: k and v of one type, q its own); outputs are
// f32. The masking convention is the reference's (ref.py), kept exactly:
// a masked score is the finite NEG_INF = -1e30 and the normaliser is
// floored at 1e-30, so a query that sees no key averages v over every key.
//
// swa_decode — one query token per sequence against a (ring) cache. Slot
// s is visible when key_pos[s] >= 0, key_pos[s] <= q_pos and (window > 0)
// q_pos - key_pos[s] < window: the three conditions of decode.py _kernel.
// Bound: bytes. Each visible slot's k and v row is read once and used for
// ~4 flops per element, far below the card's 20 flops per byte. The TPU
// kernel walks S in order per (b, kv head), which on this card would give
// B * KV blocks (64 at the serve shape, 8 at the benchmark's) for 132
// SMs. So this is flash-decoding in ONE launch with no scratch in device
// memory: a thread-block cluster of n_split blocks (4 warps each) per
// (b, kv head, group of up to GC query heads), at most 8 blocks (16,
// non-portable, where 8 would leave SMs idle; swa.py decode_split).
// Block r walks the 16-slot groups r, r + n_split, ... of S, so a
// window's visible slots spread over every block of the cluster. The GC
// heads share every k and v row, read once. Each warp walks 4 slots a
// step with their 8 k and v loads in flight, and learns which of its
// next 32 slots are visible from one ballot over one coalesced key_pos
// load, so key_pos leaves the dependent chain and a step with no visible
// slot costs nothing (the JAX benchmark's shape sees 1 slot in 16). More
// rows in flight lost at the serve shapes on the H100 (PERF.md): 8
// slots a step took 126 registers against 72, fitted fewer clusters at
// once and ran 25% slower; two cp.async stages a warp (the next step's
// rows landing in shared memory) ran 4% slower. The lanes split hd, a
// butterfly of shuffles sums each score, every lane keeps the
// online-softmax state (m, l) and its slice of acc in registers. The 4
// warps' states merge in shared memory into the block's; after
// cluster.sync() each block reads its peers' (m, l, acc)
// through distributed shared memory (cluster.map_shared_rank), in rank
// order, and writes its own slice of the GC x hd outputs, out = sum acc
// e^(m-M) / max(sum l e^(m-M), 1e-30); a last cluster.sync() keeps every
// block's shared memory alive until its peers have read it. A step with
// no visible slot is skipped, k and v unread, and masked slots read no k
// or v. That is exact whenever the query sees some slot: a masked slot's
// weight is then exp(-1e30 - m) = 0 in the reference too. A query that
// sees no slot at all is the one case where the reference weighs every
// slot equally; every block then holds l = 0, which all of them see
// after the first sync, and only then does each sum v over its own
// groups, exchange the sums across the cluster and write the mean of v
// over all S slots.
//
// With a non-null lse (B, KV, G) the same launch also writes each head's
// log-sum-exp of its visible slots' scaled scores, M + log L of the
// cluster's merge (the merge holds both already), or -inf where the call
// sees no visible slot. A cache whose slots are cut over several
// processes (the sequence-split decode cache: each process attends over
// its block of slots) combines the parts' outputs by these values; out
// is written exactly as without lse.
//
// swa_prefill — banded attention over a prompt at positions arange(S):
// key j is visible to query i when (causal) j <= i and (window > 0)
// i - j < window. Bound: operations (hd-long dot products for every
// visible (query, key) pair, ~1e11-1e12 flops against ~1 GB at the serve
// shape). The reference is f32, so every product runs on the tensor cores
// at f32 accuracy as split TF32 (tf32_mma.cuh): 495 / 3 = 165 TFLOP/s of
// f32-accurate work on the data sheet, or 323.6 / 3 = 108 TFLOP/s at the
// rate mma.sync reaches on the card (tools/mma_tf32_peak.cu). The kernel
// is the flash forward's core (attn_fwd.cuh): one block of 8 warps per
// (b, kv head, query head, 128 queries), q resident, 48-key steps of k
// and v through two cp.async stages, each split once as it lands, scores
// and probabilities kept in the mma's registers, o += p v added in f32
// step by step. A block visits only the steps of its band,
// [q0 - window + 1, q0 + 127] (causal) clamped to [0, S), each once, and
// masks only the steps at the band's edges: an interior step, whose every
// (query, key) pair is visible, takes its scores as they are. Every query
// sees at least its own key, so no row is left without one. bf16 operands
// are widened to f32 as their tiles land (q as it is loaded); a bf16 k or
// v value is exactly a TF32 value, so its small part is zero and its
// products take two mma instead of three. causal = 0 takes only
// window = 0 (full bidirectional); the wrapper says why. Shared memory at
// hd = 128: f32 219,648 B (q 67,584, two stages of k and v 101,376, the
// small parts of the tiles in use 50,688, as flash_fwd); bf16 167,424 B
// (q 67,584, two bf16 stages 49,152, the widened tiles 50,688). At
// hd = 256 the f32 layout would need 432,640 B, over the 232,448 a block
// may use, so hd = 256 takes the forward core's own shape (FwdGeom,
// attn_fwd.cuh): 64 queries a block, 16-key steps, two warps to each 16
// rows, one half of the output columns each; f32 166,400 B, bf16
// 132,608 B.
//
// Head dims: 8 to 256, powers of two. At hd = 8 a decode lane holds one
// column (8 of the 32 lanes hold data, the rest add zeros to the score's
// butterfly); at hd = 256 it holds 8 (two 16-byte loads of f32, one of
// bf16), and a cluster serves at most 4 query heads (kMaxGroup), which
// keeps q, acc and a step's k and v rows (32 + 32 + 64 floats) in
// registers without spilling.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), so a refused launch is reported. The Python
// wrappers (kernels/swa_attention/swa.py) check dtypes, shapes, contiguity
// and alignment.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fwd.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive elements (N * sizeof(T) bytes, aligned to that) as floats.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&o)[N]) {
  if constexpr (N == 8) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    const float4 y = *reinterpret_cast<const float4*>(p + 4);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
    o[4] = y.x; o[5] = y.y; o[6] = y.z; o[7] = y.w;
  } else if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    o[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p,
                                         float (&o)[N]) {
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = a.x;
      o[2 * i + 1] = a.y;
    }
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
    o[0] = __bfloat162float(*p);
  }
}

// ================================================================ decode
constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kUnroll = 4;                          // slots per warp step
constexpr int kKeysPerStep = kDecWarps * kUnroll;   // swa.py's group, 16
constexpr int kMaxCluster = 16;                     // non-portable limit

// Query heads a decode cluster serves at most (swa.py group_chunk).
template <int HD>
constexpr int kMaxGroup = HD > 128 ? 4 : 8;

// The decode kernel's minimum of resident blocks an SM, given to ptxas:
// 1 up to hd 128, where with none given ptxas spilled a few registers of
// several instances (at 48-64 of 255); none at hd 256, where the minimum
// stops <256, 1, f32>'s spill but runs slower (PERF.md section 6).
template <int HD>
constexpr int kDecMinBlocks = HD > 128 ? 0 : 1;

// One cluster of n_split blocks per (b, kv head, group of up to GC query
// heads); block r walks the 16-slot groups r, r + n_split, ... of S, and
// the blocks merge their softmax states through distributed shared
// memory. q is f32 or bf16 (q_bf16), k and v of type T; out is f32.
template <int HD, int GC, typename T>
__global__ void __launch_bounds__(kDecThreads, kDecMinBlocks<HD>)
swa_decode_kernel(const void* __restrict__ q_, int q_bf16,
                  const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ kpos, float* __restrict__ out,
                  float* __restrict__ lse, int KV, int G, int S, int qpos,
                  int window, float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;   // elements per lane
  constexpr int LANES = HD / EPL;               // lanes that hold data
  // the warps' states, merged into the block's; peers read the block's
  __shared__ float sm[kDecWarps][GC], sl[kDecWarps][GC];
  __shared__ float sacc[kDecWarps][GC][HD];
  __shared__ float bm[GC], bl[GC], bacc[GC][HD];
  __shared__ float bsum[HD];                    // no visible slot: sum of v
  __shared__ int seen;                          // some block saw a slot

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_gc = (G + GC - 1) / GC;
  const int bk = blockIdx.y / n_gc;             // b * KV + kv head
  const int g0 = (blockIdx.y % n_gc) * GC;
  const int b = bk / KV, kvh = bk % KV;
  const bool active = lane < LANES;
  const int d0 = lane * EPL;

  float qr[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float x = 0.f;
      if (active && g0 + g < G) {
        const int64_t off = ((int64_t)bk * G + g0 + g) * HD + d0 + e;
        x = q_bf16 ? __bfloat162float(
                         reinterpret_cast<const __nv_bfloat16*>(q_)[off])
                   : reinterpret_cast<const float*>(q_)[off];
      }
      qr[g][e] = x * scale;
    }

  float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int64_t kstride = (int64_t)KV * HD;
  const T* kb = k + ((int64_t)b * S * KV + kvh) * HD + d0;
  const T* vb = v + ((int64_t)b * S * KV + kvh) * HD + d0;
  // The warp's steps, kBatch at a time: lane i reads key_pos of slot
  // i % kUnroll of step i / kUnroll, and one ballot gives the visibility
  // of all kBatch * kUnroll slots, so a step with no visible slot costs
  // nothing and key_pos's latency is paid once a batch.
  constexpr int kBatch = 32 / kUnroll;
  const int n_groups = (S + kKeysPerStep - 1) / kKeysPerStep;
  const int my_steps = (n_groups - rank + n_split - 1) / n_split;
  for (int t0 = 0; t0 < my_steps; t0 += kBatch) {
    const int ts = t0 + lane / kUnroll;
    const int slot = (rank + ts * n_split) * kKeysPerStep +
                     warp * kUnroll + lane % kUnroll;
    const int kp = ts < my_steps && slot < S ? kpos[slot] : -1;
    const unsigned vis = __ballot_sync(
        0xffffffffu,
        kp >= 0 && kp <= qpos && (window <= 0 || qpos - kp < window));
#pragma unroll 1
    for (int tt = 0; tt < kBatch; ++tt) {
      const unsigned bits =
          (vis >> (tt * kUnroll)) & ((1u << kUnroll) - 1u);
      if (!bits) continue;                  // warp-uniform: a ballot
      const int s0 = (rank + (t0 + tt) * n_split) * kKeysPerStep +
                     warp * kUnroll;
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ok[u] = (bits >> u) & 1u;

      // every visible slot's k and v rows of the step in flight at once
      float kx[kUnroll][EPL], vx[kUnroll][EPL];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u] && active) {
          load_vec<EPL>(kb + (int64_t)(s0 + u) * kstride, kx[u]);
          load_vec<EPL>(vb + (int64_t)(s0 + u) * kstride, vx[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kx[u][e] = vx[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        // head g's scores (the lanes split hd; a butterfly sums each)
        float sc[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            dot = fmaf(qr[g][e], kx[u][e], dot);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sc[u] = dot;
        }
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (ok[u]) mx = fmaxf(mx, sc[u]);
        const float corr = expf(m[g] - mx);
        float p[kUnroll], sum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = ok[u] ? expf(sc[u] - mx) : 0.f;
          sum += p[u];
        }
        l[g] = l[g] * corr + sum;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = acc[g][e] * corr;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vx[u][e], a);
          acc[g][e] = a;
        }
        m[g] = mx;
      }
    }
  }

  // the warps' states -> the block's (m, l, acc); l = 0 marks a warp, and
  // a block, that saw no visible slot
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      sm[warp][g] = m[g];
      sl[warp][g] = l[g];
    }
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) sacc[warp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GC * HD; idx += kDecThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      if (sl[w][g] > 0.f) M = fmaxf(M, sm[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      if (sl[w][g] > 0.f) {
        const float c = expf(sm[w][g] - M);
        L = fmaf(sl[w][g], c, L);
        A = fmaf(sacc[w][g][d], c, A);
      }
    bacc[g][d] = A;
    if (d == 0) {
      bm[g] = M;
      bl[g] = L;
    }
  }
  cluster.sync();                 // every block's state is in place

  // The cluster's merge: block `rank` writes its slice of the GC x HD
  // outputs, reading every block's state in rank order (deterministic).
  const int n_out = GC * HD;
  const int per = (n_out + n_split - 1) / n_split;
  const int lo = rank * per, hi = min(n_out, lo + per);
  if (threadIdx.x == 0) {
    // visibility is the same for every head, so head 0 tells
    int any = 0;
    for (int r = 0; r < n_split; ++r)
      any |= cluster.map_shared_rank(bl, r)[0] > 0.f;
    seen = any;
  }
  __syncthreads();
  const int64_t orow = (int64_t)bk * G + g0;
  if (seen) {
    for (int idx = lo + threadIdx.x; idx < hi; idx += kDecThreads) {
      const int g = idx / HD, d = idx % HD;
      if (g0 + g >= G) continue;
      float M = -INFINITY;
      for (int r = 0; r < n_split; ++r)
        if (cluster.map_shared_rank(bl, r)[g] > 0.f)
          M = fmaxf(M, cluster.map_shared_rank(bm, r)[g]);
      float L = 0.f, A = 0.f;
      for (int r = 0; r < n_split; ++r) {
        const float pl = cluster.map_shared_rank(bl, r)[g];
        if (pl > 0.f) {
          const float c = expf(cluster.map_shared_rank(bm, r)[g] - M);
          L = fmaf(pl, c, L);
          A = fmaf(cluster.map_shared_rank(&bacc[0][0], r)[idx], c, A);
        }
      }
      out[orow * HD + idx] = A / fmaxf(L, 1e-30f);
      if (lse != nullptr && d == 0) lse[orow + g] = M + logf(L);
    }
  } else {
    // No visible slot anywhere: every slot scores NEG_INF in the
    // reference and weighs exp(0) = 1, so the output is the mean of v
    // over all S slots. Each block sums v over its own groups, then the
    // blocks add the sums up.
    for (int d = threadIdx.x; d < HD; d += kDecThreads) {
      const T* vd = vb - d0 + d;
      float a = 0.f;
      for (int s0 = rank * kKeysPerStep; s0 < S;
           s0 += n_split * kKeysPerStep)
        for (int s = s0; s < min(S, s0 + kKeysPerStep); ++s)
          a += to_f32(vd[(int64_t)s * kstride]);
      bsum[d] = a;
    }
    cluster.sync();
    for (int idx = lo + threadIdx.x; idx < hi; idx += kDecThreads) {
      const int g = idx / HD, d = idx % HD;
      if (g0 + g >= G) continue;
      float A = 0.f;
      for (int r = 0; r < n_split; ++r)
        A += cluster.map_shared_rank(bsum, r)[d];
      out[orow * HD + idx] = A / (float)S;
      if (lse != nullptr && d == 0) lse[orow + g] = -INFINITY;
    }
  }
  cluster.sync();                 // no block leaves while a peer reads it
}

template <int HD, int GC, typename T>
cudaError_t launch_decode(const void* q, int q_bf16, const T* k, const T* v,
                          const int* kpos, float* out, float* lse, int B,
                          int KV, int G, int S, int n_split, int qpos,
                          int window, float scale, cudaStream_t s) {
  auto kernel = swa_decode_kernel<HD, GC, T>;
  if (n_split > 8) {              // beyond the portable cluster size
    static bool allowed = false;
    if (!allowed) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
      allowed = true;
    }
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * KV * ((G + GC - 1) / GC));
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, q, q_bf16, k, v,
                                           kpos, out, lse, KV, G, S, qpos,
                                           window, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int HD, typename T>
cudaError_t decode_by_group(const void* q, int q_bf16, const T* k,
                            const T* v, const int* kpos, float* out,
                            float* lse, int B, int KV, int G, int S,
                            int n_split, int qpos, int window, float scale,
                            cudaStream_t s) {
#define DEC(GC) launch_decode<HD, GC, T>(q, q_bf16, k, v, kpos, out, lse, B, \
                                         KV, G, S, n_split, qpos, window,    \
                                         scale, s)
  if (G <= 1) return DEC(1);
  if (G <= 2) return DEC(2);
  if (G <= 4 || kMaxGroup<HD> == 4) return DEC(4);
  // swa.py group_chunk: a larger group takes several clusters
  return DEC(kMaxGroup<HD>);
#undef DEC
}

// =============================================================== prefill
__device__ __forceinline__ bool band_visible(int qp, int kp, int causal,
                                             int window) {
  return (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

// One block per (b, kv head, g, kRows queries), the longest rows first;
// warp w owns queries FwdGeom::row(w) .. + 15 of the block and the output
// columns from FwdGeom::col(w).
template <int HD, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
swa_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ out, int KV,
                   int G, int S, float scale, int causal, int window) {
  using Geom = FwdGeom<HD>;
  constexpr int BQ = Geom::kRows, BK = Geom::kStep;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  const KvStages<HD, T> kv(sQ + q_floats<HD>());

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = Geom::row(warp), c0 = Geom::col(warp);
  const int bh = blockIdx.x;                  // (b, kv head, g)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // long rows first
  const int b = bh / (KV * G), kvh = (bh / G) % KV;
  const int64_t kstride = (int64_t)KV * HD, row0 = (int64_t)bh * S;
  const T* kb = k + ((int64_t)b * S * KV + kvh) * HD;
  const T* vb = v + ((int64_t)b * S * KV + kvh) * HD;
  const int qi[2] = {q0 + wr + (lane >> 2), q0 + wr + (lane >> 2) + 8};

  // the band: keys [lo, hi] cover every key a query of the block sees
  const int q_last = min(S - 1, q0 + BQ - 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? q_last : S - 1;
  const int j_lo = lo / BK, j_hi = hi / BK;

  load_q<HD>(sQ, q + row0 * HD, q0, S, scale);
  FwdRows<HD> a;
  a.init();
  kv.fetch(kb, vb, kstride, j_lo * BK, S, 0);
  cp_async_commit();
  for (int j = j_lo, st = 0; j <= j_hi; ++j, st ^= 1) {
    if (j < j_hi) kv.fetch(kb, vb, kstride, (j + 1) * BK, S, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    kv.prepare(st);
    __syncthreads();
    const int k0 = j * BK;
    // every (query, key) pair of an interior step sees each other
    const bool interior = k0 + BK <= S &&
                          (!causal || k0 + BK - 1 <= q0) &&
                          (window <= 0 || q_last - k0 < window);
    fwd_step<HD, KvStages<HD, T>::kSplit>(
        sQ, wr, c0, kv.big(st, 0), kv.small(0), kv.big(st, 1), kv.small(1),
        a,
        [&](int h, int c, float x) -> float {
          if (interior) return x;
          if (k0 + c >= S) return -INFINITY;    // no such key
          return band_visible(qi[h], k0 + c, causal, window) ? x : kNegInf;
        });
    __syncthreads();          // this stage is free for the next copy
  }
  cp_async_wait<0>();
  fwd_store<HD>(a, out, nullptr, row0, q0 + wr, c0, S);
}

template <int HD, typename T>
constexpr size_t prefill_smem() {
  return (q_floats<HD>() + KvStages<HD, T>::floats()) * sizeof(float);
}
static_assert(prefill_smem<128, float>() <= 232448 &&
                  prefill_smem<256, float>() <= 232448,
              "a block fits the 227 KB a block may use");

template <int HD, typename T>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           float* out, int B, int KV, int G, int S,
                           float scale, int causal, int window,
                           cudaStream_t s) {
  const size_t smem = prefill_smem<HD, T>();
  cudaError_t e = cudaFuncSetAttribute(
      swa_prefill_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int n_blocks = (S + FwdGeom<HD>::kRows - 1) / FwdGeom<HD>::kRows;
  swa_prefill_kernel<HD, T><<<dim3(B * KV * G, n_blocks), kTileThreads, smem,
                              s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, KV, G, S, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// Head dims the kernels are built for: 8 to 256, powers of two (192, MLA's
// qk head dim, comes with MLA).
#define SWA_HD_SWITCH(hd, LAUNCH)                \
  switch (hd) {                                  \
    case 8: return (int)LAUNCH(8);               \
    case 16: return (int)LAUNCH(16);             \
    case 32: return (int)LAUNCH(32);             \
    case 64: return (int)LAUNCH(64);             \
    case 128: return (int)LAUNCH(128);           \
    case 256: return (int)LAUNCH(256);           \
    default: return (int)cudaErrorInvalidValue;  \
  }

extern "C" {

const char* swa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// lse: null, or (B, KV, G) f32 for the log-sum-exp (see swa_decode above).
int swa_decode(const void* q, int q_bf16, const void* k, const void* v,
               int kv_bf16, const int* kpos, float* out, float* lse, int B,
               int KV, int G, int S, int hd, int n_split, int qpos,
               int window, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_split < 1 || n_split > kMaxCluster) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
#define CALL(HD)                                                             \
  (kv_bf16 ? decode_by_group<HD, bf>(q, q_bf16, static_cast<const bf*>(k),  \
                                     static_cast<const bf*>(v), kpos, out,  \
                                     lse, B, KV, G, S, n_split, qpos,       \
                                     window, scale, s)                      \
           : decode_by_group<HD, float>(                                     \
                 q, q_bf16, static_cast<const float*>(k),                    \
                 static_cast<const float*>(v), kpos, out, lse, B, KV, G, S,  \
                 n_split, qpos, window, scale, s))
  SWA_HD_SWITCH(hd, CALL)
#undef CALL
}

int swa_prefill(const void* q, const void* k, const void* v, int bf16,
                float* out, int B, int KV, int G, int S, int hd, int causal,
                int window, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!causal && window > 0) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
#define CALL(HD)                                                           \
  (bf16 ? launch_prefill<HD, bf>(q, k, v, out, B, KV, G, S, scale, causal, \
                                 window, s)                                \
        : launch_prefill<HD, float>(q, k, v, out, B, KV, G, S, scale,      \
                                    causal, window, s))
  SWA_HD_SWITCH(hd, CALL)
#undef CALL
}

// Dynamic shared memory a swa_prefill launch requests at head dim hd, in
// bytes, for f32 or bf16 (bf16) operands.
int swa_prefill_smem_bytes(int hd, int bf16) {
#define CALL(HD) (bf16 ? prefill_smem<HD, __nv_bfloat16>() \
                       : prefill_smem<HD, float>())
  SWA_HD_SWITCH(hd, CALL)
#undef CALL
}

}  // extern "C"
