// Flash attention, forward and backward, for Hopper (sm_90a): hand-written
// CUDA C++ in f32.
//
// Replaces the Pallas TPU kernels that carry the transformer cohort's local
// training (src/repro/kernels/flash_attention/):
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
// S = 2048, hd = 128, causal) the forward does ~275 GFLOP and the
// backward ~2.5x that against ~0.6 GB moved, i.e. hundreds of flops per
// byte, so the card's f32 rate (67 TFLOP/s, no tensor cores: the port
// keeps TF32 off) is the limit. The design is the simple one that is
// right: a block of 256 threads owns a 64-row tile, walks the 64-key
// tiles in order, and keeps every (64 x hd) operand tile in shared memory
// with rows padded to hd + 1 floats, so the column reads of a warp fall in
// 16 distinct banks; each thread holds a 4 x 4 tile of scores and a
// 4 x hd/16 tile of the output in registers (f32 FFMA). Online softmax
// statistics live in registers of the 16 threads that share a row and
// are combined with warp shuffles.
//
//   forward  one block per (b, kv head, g, q tile): S = (q*scale) k^T,
//            online softmax, O += P v; writes out and lse = m + log(l).
//   dq       one block per (b, kv head, g, q tile): p = exp(s - lse),
//            dS = p * (dO v^T - delta), dq += dS k; dq *= scale at the end.
//   dk/dv    one block per (b, kv head, kv tile): walks the G query heads
//            of the group and every q tile, dv += p^T dO and
//            dk += dS^T (q*scale). The sum over G stays inside one block:
//            no atomics, deterministic.
//
// A (q tile, kv tile) pair with no visible (query, key) pair is skipped,
// which is what a causal mask above the diagonal gives; it is skipped only
// when every query row of the tile sees some key, since a row that sees
// none takes every key into its average (see above). Skipping is then
// exact: such a tile adds p = 0 after the row's first visible key and is
// wiped by the correction exp(-1e30 - m) = 0 before it.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), so a refused launch is reported. The Python
// wrappers (kernels/flash_attention/flash.py) check dtypes, shapes and
// contiguity.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kTile = 64;           // query rows and keys per tile
constexpr int kLP = kTile + 16;     // row stride of the 64-wide tiles: the
                                    // two rows a warp writes sit 16 banks
                                    // apart
constexpr float kNegInf = -1e30f;   // ref.py NEG_INF
constexpr float kDeadLse = -1e29f;  // lse of a row that saw no key
static_assert(kTile * 4 == kThreads, "four threads per row in dead_rows");

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || qp >= kp) &&
         (window <= 0 || qp - kp < window);
}

// Rows [row0, row0 + 64) of a slab whose row r starts at g + r * stride,
// times `scale`, into s (row stride hd + 1); rows >= n read as 0.
template <int HD>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g,
                                          int64_t stride, int row0, int n,
                                          float scale) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    s[r * (HD + 1) + d] = row < n ? g[row * stride + d] * scale : 0.f;
  }
}

// Positions of rows [row0, row0 + 64); rows >= n read as -1.
__device__ __forceinline__ void load_pos(int* s, const int* __restrict__ g,
                                         int row0, int n) {
  if (threadIdx.x < kTile)
    s[threadIdx.x] = row0 + threadIdx.x < n ? g[row0 + threadIdx.x] : -1;
}

// Reduce over the 16 lanes that share a row (tx = lane % 16).
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

// True when some query row q0 + r < Sq of the tile sees no key at all
// (block-uniform). Four threads scan each row's keys.
__device__ bool dead_rows(const int* sQpos, int q0, int Sq,
                          const int* __restrict__ kpos, int Sk, int causal,
                          int window) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const bool in = q0 + r < Sq;
  int alive = 0;
  if (in) {
    const int qp = sQpos[r];
    for (int s = part; s < Sk && !alive; s += 4)
      alive = visible(qp, kpos[s], causal, window);
  }
  alive |= __shfl_xor_sync(0xffffffffu, alive, 1);
  alive |= __shfl_xor_sync(0xffffffffu, alive, 2);
  return __syncthreads_or(in && !alive);
}

// Does any (query, key) pair of the tile pair see each other? Each thread
// checks its 4 x 4 pairs: queries ty + 16 i and keys tx + 16 j when
// q_rows, the transpose otherwise (the dk/dv kernel's layout).
__device__ __forceinline__ bool tile_visible(const int* sQpos, int q0, int Sq,
                                             const int* sKpos, int k0, int Sk,
                                             int causal, int window,
                                             bool q_rows) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = q_rows ? ty + 16 * i : tx + 16 * j;
      const int kj = q_rows ? tx + 16 * j : ty + 16 * i;
      any |= q0 + qi < Sq && k0 + kj < Sk &&
             visible(sQpos[qi], sKpos[kj], causal, window);
    }
  return any;
}

// ------------------------------------------------------------- forward
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, float* __restrict__ out,
                 float* __restrict__ lse, int KV, int G, int Sq, int Sk,
                 float scale, int causal, int window) {
  constexpr int LD = HD + 1, RC = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;
  int* sQpos = reinterpret_cast<int*>(sP + kTile * kLP);
  int* sKpos = sQpos + kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;                      // (b, kv head, g)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // long rows first
  const int b = bh / (KV * G), kvh = (bh / G) % KV;
  const int64_t kstride = (int64_t)KV * HD;
  const float* kb = k + ((int64_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((int64_t)b * Sk * KV + kvh) * HD;

  load_pos(sQpos, qpos, q0, Sq);
  load_tile<HD>(sQ, q + (int64_t)bh * Sq * HD, HD, q0, Sq, scale);
  __syncthreads();
  const bool may_skip = !dead_rows(sQpos, q0, Sq, kpos, Sk, causal, window);

  float m[4], l[4], o[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) o[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    load_pos(sKpos, kpos, k0, Sk);
    __syncthreads();
    if (!__syncthreads_or(tile_visible(sQpos, q0, Sq, sKpos, k0, Sk, causal,
                                       window, true)) && may_skip)
      continue;
    load_tile<HD>(sK, kb, kstride, k0, Sk, 1.f);
    load_tile<HD>(sV, vb, kstride, k0, Sk, 1.f);
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
      const int r = ty + 16 * i, qp = sQpos[r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // keys past Sk do not exist; masked keys score NEG_INF
        const float x = k0 + c >= Sk ? -INFINITY
                        : visible(qp, sKpos[c], causal, window) ? s[i][j]
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
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    float* orow = out + ((int64_t)bh * Sq + r) * HD;
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) orow[tx + 16 * jj] = o[i][jj] / ls;
    if (tx == 0) lse[(int64_t)bh * Sq + r] = m[i] + logf(ls);
  }
}

// ------------------------------------------------------------------ dq
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ dout, float* __restrict__ dq,
                    int KV, int G, int Sq, int Sk, float scale, int causal,
                    int window) {
  constexpr int LD = HD + 1, RC = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;
  float* sLse = sDS + kTile * kLP;
  float* sDelta = sLse + kTile;
  int* sQpos = reinterpret_cast<int*>(sDelta + kTile);
  int* sKpos = sQpos + kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int b = bh / (KV * G), kvh = (bh / G) % KV;
  const int64_t kstride = (int64_t)KV * HD, row0 = (int64_t)bh * Sq;
  const float* kb = k + ((int64_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((int64_t)b * Sk * KV + kvh) * HD;

  load_pos(sQpos, qpos, q0, Sq);
  if (tid < kTile) {
    const bool in = q0 + tid < Sq;
    sLse[tid] = in ? lse[row0 + q0 + tid] : 0.f;
    sDelta[tid] = in ? delta[row0 + q0 + tid] : 0.f;
  }
  load_tile<HD>(sQ, q + row0 * HD, HD, q0, Sq, scale);
  load_tile<HD>(sDO, dout + row0 * HD, HD, q0, Sq, 1.f);
  __syncthreads();
  const bool may_skip = !__syncthreads_or(
      tid < kTile && q0 + tid < Sq && sLse[tid] < kDeadLse);

  float acc[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) acc[i][jj] = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    load_pos(sKpos, kpos, k0, Sk);
    __syncthreads();
    if (!__syncthreads_or(tile_visible(sQpos, q0, Sq, sKpos, k0, Sk, causal,
                                       window, true)) && may_skip)
      continue;
    load_tile<HD>(sK, kb, kstride, k0, Sk, 1.f);
    load_tile<HD>(sV, vb, kstride, k0, Sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float a[4], g[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty + 16 * i) * LD + d];
        g[i] = sDO[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = sK[(tx + 16 * j) * LD + d];
        w[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = sQpos[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (k0 + c < Sk) {
          const float x = visible(qp, sKpos[c], causal, window) ? s[i][j]
                                                               : kNegInf;
          ds = expf(x - sLse[r]) * (dp[i][j] - sDelta[r]);
        }
        sDS[r * kLP + c] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float kv[RC];
#pragma unroll
      for (int jj = 0; jj < RC; ++jj) kv[jj] = sK[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sDS[(ty + 16 * i) * kLP + kk];
#pragma unroll
        for (int jj = 0; jj < RC; ++jj) acc[i][jj] = fmaf(ds, kv[jj], acc[i][jj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    float* row = dq + (row0 + r) * HD;
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) row[tx + 16 * jj] = acc[i][jj] * scale;
  }
}

// --------------------------------------------------------------- dk/dv
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, int KV, int G, int Sq, int Sk,
                     float scale, int causal, int window) {
  constexpr int LD = HD + 1, RC = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sPT = sDO + kTile * LD;         // p^T: (key, query)
  float* sDST = sPT + kTile * kLP;       // dS^T
  float* sLse = sDST + kTile * kLP;
  float* sDelta = sLse + kTile;
  int* sQpos = reinterpret_cast<int*>(sDelta + kTile);
  int* sKpos = sQpos + kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bk = blockIdx.x;                       // (b, kv head)
  const int k0 = blockIdx.y * kTile;
  const int b = bk / KV, kvh = bk % KV;
  const int64_t kstride = (int64_t)KV * HD;
  const int64_t kvoff = ((int64_t)b * Sk * KV + kvh) * HD;

  load_pos(sKpos, kpos, k0, Sk);
  load_tile<HD>(sK, k + kvoff, kstride, k0, Sk, 1.f);
  load_tile<HD>(sV, v + kvoff, kstride, k0, Sk, 1.f);

  // rows of the accumulators are this block's keys c = ty + 16 i
  float dka[4][RC], dva[4][RC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) dka[i][jj] = dva[i][jj] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int64_t row0 = ((int64_t)bk * G + g) * Sq;    // (b, kvh, g) rows
    for (int q0 = 0; q0 < Sq; q0 += kTile) {
      __syncthreads();
      load_pos(sQpos, qpos, q0, Sq);
      if (tid < kTile) {
        const bool in = q0 + tid < Sq;
        sLse[tid] = in ? lse[row0 + q0 + tid] : 0.f;
        sDelta[tid] = in ? delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      const bool dead = tid < kTile && q0 + tid < Sq && sLse[tid] < kDeadLse;
      if (!__syncthreads_or(dead || tile_visible(sQpos, q0, Sq, sKpos, k0, Sk,
                                                 causal, window, false)))
        continue;
      load_tile<HD>(sQ, q + row0 * HD, HD, q0, Sq, scale);
      load_tile<HD>(sDO, dout + row0 * HD, HD, q0, Sq, 1.f);
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float kk[4], vv[4], a[4], gg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = sK[(ty + 16 * i) * LD + d];
          vv[i] = sV[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = sQ[(tx + 16 * j) * LD + d];
          gg[j] = sDO[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kk[i], a[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], gg[j], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i, kp = sKpos[c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          float p = 0.f, ds = 0.f;
          if (q0 + r < Sq && k0 + c < Sk) {
            const float x = visible(sQpos[r], kp, causal, window) ? st[i][j]
                                                                 : kNegInf;
            p = expf(x - sLse[r]);
            ds = p * (dpt[i][j] - sDelta[r]);
          }
          sPT[c * kLP + r] = p;
          sDST[c * kLP + r] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float gv[RC], qv[RC];
#pragma unroll
        for (int jj = 0; jj < RC; ++jj) {
          gv[jj] = sDO[r * LD + tx + 16 * jj];
          qv[jj] = sQ[r * LD + tx + 16 * jj];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = sPT[(ty + 16 * i) * kLP + r];
          const float ds = sDST[(ty + 16 * i) * kLP + r];
#pragma unroll
          for (int jj = 0; jj < RC; ++jj) {
            dva[i][jj] = fmaf(p, gv[jj], dva[i][jj]);
            dka[i][jj] = fmaf(ds, qv[jj], dka[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
    const int64_t off = kvoff + (int64_t)c * kstride;
#pragma unroll
    for (int jj = 0; jj < RC; ++jj) {
      dk[off + tx + 16 * jj] = dka[i][jj];
      dv[off + tx + 16 * jj] = dva[i][jj];
    }
  }
}

// Shared memory of each kernel, in bytes.
constexpr size_t fwd_smem(int hd) {
  return (3 * kTile * (hd + 1) + kTile * kLP) * sizeof(float) +
         2 * kTile * sizeof(int);
}
constexpr size_t dq_smem(int hd) {
  return (4 * kTile * (hd + 1) + kTile * kLP + 2 * kTile) * sizeof(float) +
         2 * kTile * sizeof(int);
}
constexpr size_t dkv_smem(int hd) {
  return (4 * kTile * (hd + 1) + 2 * kTile * kLP + 2 * kTile) *
             sizeof(float) +
         2 * kTile * sizeof(int);
}

int n_tiles(int n) { return (n + kTile - 1) / kTile; }

template <int HD>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       const int* qpos, const int* kpos, float* out,
                       float* lse, int B, int KV, int G, int Sq, int Sk,
                       float scale, int causal, int window, cudaStream_t s) {
  const size_t smem = fwd_smem(HD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<HD><<<dim3(B * KV * G, n_tiles(Sq)), kThreads, smem, s>>>(
      q, k, v, qpos, kpos, out, lse, KV, G, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const int* qpos, const int* kpos, const float* lse,
                      const float* delta, const float* dout, float* dq, int B,
                      int KV, int G, int Sq, int Sk, float scale, int causal,
                      int window, cudaStream_t s) {
  const size_t smem = dq_smem(HD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<HD><<<dim3(B * KV * G, n_tiles(Sq)), kThreads, smem,
                            s>>>(q, k, v, qpos, kpos, lse, delta, dout, dq,
                                 KV, G, Sq, Sk, scale, causal, window);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const int* qpos, const int* kpos, const float* lse,
                       const float* delta, const float* dout, float* dk,
                       float* dv, int B, int KV, int G, int Sq, int Sk,
                       float scale, int causal, int window, cudaStream_t s) {
  const size_t smem = dkv_smem(HD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<HD><<<dim3(B * KV, n_tiles(Sk)), kThreads, smem, s>>>(
      q, k, v, qpos, kpos, lse, delta, dout, dk, dv, KV, G, Sq, Sk, scale,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

// Head dims the kernels are built for (a multiple of 16, at most 128).
#define FLASH_HD_SWITCH(hd, LAUNCH)              \
  switch (hd) {                                  \
    case 16: return (int)LAUNCH(16);             \
    case 32: return (int)LAUNCH(32);             \
    case 64: return (int)LAUNCH(64);             \
    case 128: return (int)LAUNCH(128);           \
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

}  // extern "C"
