// Sliding-window attention for serving, for Hopper (sm_90a): hand-written
// CUDA C++, f32 arithmetic on f32 or bf16 operands.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/swa_attention/:
//   swa_decode_split_kernel + swa_decode_combine_kernel
//                          <- decode.py  swa_decode  (_kernel)
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
// SMs. So this is flash-decoding:
//   split   one block (4 warps) per (chunk of S, b, kv head, group of up
//           to GC query heads). The GC heads share every k and v row,
//           read once. Each warp walks 4 slots at a time (8 vector loads
//           in flight per lane): the lanes split hd, a butterfly of
//           shuffles sums each score, every lane keeps the online-softmax
//           state (m, l) and its slice of acc in registers. The 4 warps'
//           states are merged in shared memory into the chunk's partial
//           (m, l, acc).
//   combine one block per (b, kv head, query head): merges the chunks'
//           partials, out = sum acc e^(m-M) / max(sum l e^(m-M), 1e-30).
// Four slots with none visible are skipped, k and v unread. That is exact
// whenever the query sees some slot: a masked slot's weight is then
// exp(-1e30 - m) = 0 in the reference too, wherever it falls. A query
// that sees no slot at all is the one case where the reference weighs
// every slot equally; every chunk then reports l = 0, and the combine
// pass computes that case as it is defined, the mean of v over all S
// slots. Slots inside a visited four that are masked read no k or v.
//
// swa_prefill — banded attention over a prompt at positions arange(S):
// key j is visible to query i when (causal) j <= i and (window > 0)
// i - j < window. Bound: operations (hd-long dot products for every
// visible (query, key) pair, ~1e11-1e12 flops against ~1 GB at the serve
// shape), on the f32 FFMA units: the port keeps TF32 off. One block of
// 256 threads per (b, kv head, query head, 64-query tile) visits only the
// 64-key tiles of its band, [q0 - window + 1, q0 + 63] clamped to
// [0, S), each once; the tile code is the flash forward's (operand tiles
// in shared memory, rows padded to hd + 1 floats, a 4 x 4 score tile and
// a 4 x hd/16 output tile per thread, online softmax in registers). Every
// query sees at least its own key, so no row is left without one. bf16
// operands are widened to f32 as tiles are loaded. causal = 0 takes only
// window = 0 (full bidirectional); the wrapper says why.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), so a refused launch is reported. The Python
// wrappers (kernels/swa_attention/swa.py) check dtypes, shapes, contiguity
// and alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // ref.py NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N consecutive elements (N * sizeof(T) bytes, aligned to that) as floats.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&o)[N]) {
  if constexpr (N == 4) {
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
  if constexpr (N == 4) {
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
constexpr int kKeysPerStep = kDecWarps * kUnroll;   // swa.py's 16

template <int HD, int GC, typename T>
__global__ void __launch_bounds__(kDecThreads)
swa_decode_split_kernel(const void* __restrict__ q_, int q_bf16,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ kpos, float* __restrict__ pm,
                        float* __restrict__ pl, float* __restrict__ pacc,
                        int KV, int G, int S, int chunk, int n_split,
                        int qpos, int window, float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;   // elements per lane
  constexpr int LANES = HD / EPL;               // lanes that hold data
  __shared__ float sm[kDecWarps][GC], sl[kDecWarps][GC];
  __shared__ float sacc[kDecWarps][GC][HD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
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
  const int s_begin = split * chunk;
  const int s_end = min(S, s_begin + chunk);

  for (int s0 = s_begin + warp * kUnroll; s0 < s_end; s0 += kKeysPerStep) {
    bool ok[kUnroll];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      const int kp = s < s_end ? kpos[s] : -1;
      ok[u] = kp >= 0 && kp <= qpos && (window <= 0 || qpos - kp < window);
      any |= ok[u];
    }
    if (!any) continue;                   // warp-uniform: same positions

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
    float sc[GC][kUnroll];
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kx[u][e], dot);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[g][u] = dot;
      }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[g][u]);
      const float corr = expf(m[g] - mx);
      float p[kUnroll], sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = ok[u] ? expf(sc[g][u] - mx) : 0.f;
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

  // merge the warps' states into the chunk's partial; l = 0 marks a
  // warp (and a chunk) that saw no visible slot
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
    if (g0 + g >= G) continue;
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
    const int64_t row = ((int64_t)bk * n_split + split) * G + g0 + g;
    pacc[row * HD + d] = A;
    if (d == 0) {
      pm[row] = M;
      pl[row] = L;
    }
  }
}

template <typename T>
__global__ void swa_decode_combine_kernel(const float* __restrict__ pm,
                                          const float* __restrict__ pl,
                                          const float* __restrict__ pacc,
                                          const T* __restrict__ v,
                                          float* __restrict__ out, int KV,
                                          int G, int S, int hd, int n_split) {
  const int row = blockIdx.x;                   // (b * KV + kv head) * G + g
  const int bk = row / G, g = row % G, d = threadIdx.x;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    const int64_t r = ((int64_t)bk * n_split + s) * G + g;
    if (pl[r] > 0.f) M = fmaxf(M, pm[r]);
  }
  float L = 0.f, A = 0.f;
  if (M > -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      const int64_t r = ((int64_t)bk * n_split + s) * G + g;
      if (pl[r] > 0.f) {
        const float c = expf(pm[r] - M);
        L = fmaf(pl[r], c, L);
        A = fmaf(pacc[r * hd + d], c, A);
      }
    }
    out[(int64_t)row * hd + d] = A / fmaxf(L, 1e-30f);
    return;
  }
  // no visible slot: every slot scores NEG_INF in the reference and gets
  // weight exp(0) = 1, so the output is the mean of v over all S slots
  const int b = bk / KV, kvh = bk % KV;
  const T* vb = v + ((int64_t)b * S * KV + kvh) * hd + d;
  for (int s = 0; s < S; ++s) A += to_f32(vb[(int64_t)s * KV * hd]);
  out[(int64_t)row * hd + d] = A / (float)S;
}

template <int HD, int GC, typename T>
cudaError_t launch_decode(const void* q, int q_bf16, const T* k, const T* v,
                          const int* kpos, float* pm, float* pl, float* pacc,
                          float* out, int B, int KV, int G, int S, int chunk,
                          int n_split, int qpos, int window, float scale,
                          cudaStream_t s) {
  const int n_gc = (G + GC - 1) / GC;
  swa_decode_split_kernel<HD, GC, T>
      <<<dim3(n_split, B * KV * n_gc), kDecThreads, 0, s>>>(
          q, q_bf16, k, v, kpos, pm, pl, pacc, KV, G, S, chunk, n_split,
          qpos, window, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  swa_decode_combine_kernel<T><<<B * KV * G, HD, 0, s>>>(
      pm, pl, pacc, v, out, KV, G, S, HD, n_split);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t decode_by_group(const void* q, int q_bf16, const T* k,
                            const T* v, const int* kpos, float* pm,
                            float* pl, float* pacc, float* out, int B,
                            int KV, int G, int S, int chunk, int n_split,
                            int qpos, int window, float scale,
                            cudaStream_t s) {
#define DEC(GC) launch_decode<HD, GC, T>(q, q_bf16, k, v, kpos, pm, pl, pacc, \
                                         out, B, KV, G, S, chunk, n_split,    \
                                         qpos, window, scale, s)
  if (G <= 1) return DEC(1);
  if (G <= 2) return DEC(2);
  if (G <= 4) return DEC(4);
  return DEC(8);          // swa.py group_chunk: G > 8 takes several blocks
#undef DEC
}

// =============================================================== prefill
constexpr int kThreads = 256;       // 16 x 16
constexpr int kTile = 64;           // queries and keys per tile
constexpr int kLP = kTile + 16;     // row stride of the score tile

// Rows [row0, row0 + 64) of a slab whose row r starts at g + r * stride,
// times `scale`, into s (row stride hd + 1); rows >= n read as 0.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* s, const T* __restrict__ g,
                                          int64_t stride, int row0, int n,
                                          float scale) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    s[r * (HD + 1) + d] = row < n ? to_f32(g[row * stride + d]) * scale : 0.f;
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool band_visible(int qp, int kp, int causal,
                                             int window) {
  return (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
swa_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, float* __restrict__ out, int KV,
                   int G, int S, float scale, int causal, int window) {
  constexpr int LD = HD + 1, RC = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;                      // (b, kv head, g)
  const int q0 = blockIdx.y * kTile;
  const int b = bh / (KV * G), kvh = (bh / G) % KV;
  const int64_t kstride = (int64_t)KV * HD;
  const T* kb = k + ((int64_t)b * S * KV + kvh) * HD;
  const T* vb = v + ((int64_t)b * S * KV + kvh) * HD;

  // the band: keys [lo, hi] cover every key a query of [q0, q0 + 64) sees
  const int q_last = min(S - 1, q0 + kTile - 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? q_last : S - 1;
  const int t_lo = lo / kTile, t_hi = hi / kTile;

  load_tile<HD>(sQ, q + (int64_t)bh * S * HD, HD, q0, S, scale);

  float m[4], l[4], o[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) o[i][jj] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                              // sK, sV, sP are free
    load_tile<HD>(sK, kb, kstride, k0, S, 1.f);
    load_tile<HD>(sV, vb, kstride, k0, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        // keys past S do not exist; masked keys score NEG_INF
        const float x = kp >= S ? -INFINITY
                        : band_visible(qp, kp, causal, window) ? s[i][j]
                                                              : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[r * kLP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < RC; ++jj) o[i][jj] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float vv[RC];
#pragma unroll
      for (int jj = 0; jj < RC; ++jj) vv[jj] = sV[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * kLP + kk];
#pragma unroll
        for (int jj = 0; jj < RC; ++jj) o[i][jj] = fmaf(p, vv[jj], o[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    float* orow = out + ((int64_t)bh * S + r) * HD;
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) orow[tx + 16 * jj] = o[i][jj] / ls;
  }
}

constexpr size_t prefill_smem(int hd) {
  return (3 * (size_t)kTile * (hd + 1) + (size_t)kTile * kLP) * sizeof(float);
}

template <int HD, typename T>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           float* out, int B, int KV, int G, int S,
                           float scale, int causal, int window,
                           cudaStream_t s) {
  const size_t smem = prefill_smem(HD);
  cudaError_t e = cudaFuncSetAttribute(
      swa_prefill_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (S + kTile - 1) / kTile;
  swa_prefill_kernel<HD, T><<<dim3(B * KV * G, n_tiles), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out, KV, G, S, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// Head dims the kernels are built for (a multiple of 16, at most 128).
#define SWA_HD_SWITCH(hd, LAUNCH)                \
  switch (hd) {                                  \
    case 16: return (int)LAUNCH(16);             \
    case 32: return (int)LAUNCH(32);             \
    case 64: return (int)LAUNCH(64);             \
    case 128: return (int)LAUNCH(128);           \
    default: return (int)cudaErrorInvalidValue;  \
  }

extern "C" {

const char* swa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int swa_decode(const void* q, int q_bf16, const void* k, const void* v,
               int kv_bf16, const int* kpos, float* pm, float* pl,
               float* pacc, float* out, int B, int KV, int G, int S, int hd,
               int chunk, int n_split, int qpos, int window, float scale,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (chunk % kKeysPerStep || (int64_t)chunk * n_split < S ||
      (int64_t)chunk * (n_split - 1) >= S)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
#define CALL(HD)                                                              \
  (kv_bf16 ? decode_by_group<HD, bf>(q, q_bf16, static_cast<const bf*>(k),   \
                                     static_cast<const bf*>(v), kpos, pm, pl, \
                                     pacc, out, B, KV, G, S, chunk, n_split,  \
                                     qpos, window, scale, s)                  \
           : decode_by_group<HD, float>(                                      \
                 q, q_bf16, static_cast<const float*>(k),                     \
                 static_cast<const float*>(v), kpos, pm, pl, pacc, out, B,    \
                 KV, G, S, chunk, n_split, qpos, window, scale, s))
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

}  // extern "C"
