// Flash attention, forward and backward, for Hopper (sm_90a): hand-written
// CUDA C++ at f32 accuracy.
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
// byte. The reference is full f32, so TF32 alone is not allowed.
//
// Forward: f32 FFMA (67 TFLOP/s). A block of 256 threads owns a 64-row
// tile, walks the 64-key tiles in order, and keeps every (64 x hd) operand
// tile in shared memory with rows padded to hd + 1 floats; each thread
// holds a 4 x 4 tile of scores and a 4 x hd/16 tile of the output in
// registers. Online softmax statistics live in registers of the 16
// threads that share a row and are combined with warp shuffles.
//
//   forward  one block per (b, kv head, g, q tile): S = (q*scale) k^T,
//            online softmax, O += P v; writes out and lse = m + log(l).
//
// Backward: every product runs on the tensor cores at f32 accuracy
// ("3xTF32", CUTLASS's OpMultiplyAddFastF32, the route of PyTorch's own
// f32 memory-efficient attention): each f32 operand x is split into
// big = tf32(x) and small = tf32(x - big), and a b is taken as
// small.big + big.small + big.big with f32 accumulation
// (mma.sync.m16n8k8 tf32); the long sums (dq over the keys, dk and dv
// over G x Sq rows) take each step's part from zeroed fragments and add
// it in f32 (step_sum), since the tensor cores' own accumulation cuts
// instead of rounding. That is 3 tensor-core products per f32 one:
// 495 / 3 = 165 TFLOP/s of f32-accurate work, 2.5x the FFMA peak, which
// bounds the pair. The split costs integer and f32 instructions, which
// compete with the mma for the schedulers: a streamed tile, read by all 8
// warps, is therefore split once when it lands (big in place, small
// beside it), while a resident tile, read by one warp each, is split at
// fragment load. Rows are padded to hd + 4 floats, so a warp's fragment
// loads are conflict-free. Tiles are copied with cp.async (16 bytes a
// thread, zero-filled past the end) into two stages, the next tile in
// flight while the current one is split and multiplied. Each warp owns
// 16 rows of a 128-row block; the 16 x 24 score tiles stay in the mma's
// registers and feed the next product as its A operand (a_from_acc), so
// p and dS never go through shared memory. One block of 8 warps fits an
// SM at hd = 128 (~207 KB of shared memory; a 32-row step would not fit
// beside the small parts).
//
//   dq       one block per (b, kv head, g, 128 query rows): q, dO
//            resident, 24-key tiles of k, v streamed; p = exp(s - lse),
//            dS = p * (dO v^T - delta), dq += dS k; dq *= scale at the end.
//   dk/dv    one block per (b, kv head, 128 keys): k, v resident, (g, 24
//            query rows) steps of q, dO, lse, delta streamed over the G
//            query heads of the group, dv += p^T dO and
//            dk += dS^T (q*scale). The sum over G stays inside one block:
//            no atomics, deterministic (two launches are bit-equal).
//
// A (q tile, kv tile) pair with no visible (query, key) pair is skipped,
// which is what a causal mask above the diagonal gives; it is skipped only
// when every query row of the tile sees some key, since a row that sees
// none takes every key into its average (see above). Skipping is then
// exact: such a tile adds p = 0 after the row's first visible key and is
// wiped by the correction exp(-1e30 - m) = 0 before it. The backward asks
// ahead of each copy, 32 tiles at a time (one lane a tile), whether the
// position ranges of the tile pair allow a visible pair; a tile it keeps
// that holds none adds exactly 0 to every row that sees some key.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(), so a refused launch is reported. The Python
// wrappers (kernels/flash_attention/flash.py) check dtypes, shapes,
// contiguity and, for the backward's 16-byte copies, the alignment of q,
// k, v and dout.

#include <cuda_runtime.h>
#include <limits.h>
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
// checks its 4 x 4 pairs: queries ty + 16 i and keys tx + 16 j.
__device__ __forceinline__ bool tile_visible(const int* sQpos, int q0, int Sq,
                                             const int* sKpos, int k0, int Sk,
                                             int causal, int window) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  bool any = false;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = ty + 16 * i, kj = tx + 16 * j;
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
                                       window)) && may_skip)
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

// ------------------------------------------------------------- backward
// Split-TF32 ("3xTF32") tensor-core products at f32 accuracy over tiles
// copied asynchronously (cp.async) into shared memory; see the header.

constexpr int kBwdThreads = 256;    // 8 warps, 16 rows of the block each
constexpr int kBwdRows = 128;       // query rows (dq) or keys (dk/dv) a block
constexpr int kBwdStep = 24;        // keys (dq) or query rows (dk/dv) a step
constexpr int kBwdWarps = kBwdThreads / 32;
static_assert(kBwdRows == 16 * kBwdWarps, "one 16-row mma tile a warp");

// The row stride of every backward tile, hd + 4 floats (4 mod 8): the
// fragment loads (rows g, columns t) and (rows 2t, columns g) of a warp,
// g = lane / 4, t = lane % 4, then fall in 32 distinct banks.
template <int HD>
__host__ __device__ constexpr int bwd_ld() { return HD + 4; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a slab whose row r starts at g + r * stride
// into s (row stride hd + 4), 16 bytes a copy; rows >= n are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void copy_tile(float* s, const float* g,
                                          int64_t stride, int row0, int n) {
  constexpr int LD = bwd_ld<HD>(), CPR = HD / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kBwdThreads) {
    const int r = i / CPR, c = (i % CPR) * 4, row = row0 + r;
    const bool ok = row < n;
    cp_async16(s + r * LD + c, g + (ok ? row : 0) * stride + c, ok);
  }
}

// x = big + small, both TF32, rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero).
struct Split {
  uint32_t big, small;
};

// cvt.rna.tf32.f32 in two integer operations: half a TF32 ulp added to
// the magnitude bits (the sign bit stands apart), the 13 dropped bits
// cleared. Equal to the instruction on every finite x and on +-inf; the
// instruction itself compiles to twice as many, guarding inf and NaN.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// The operands of one m16n8k8 product, split: A 16 x 8 (row-major; lane
// (g, t) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)), B 8 x 8
// (lane (g, t) holds rows t and t + 4 of column g).
struct FragA {
  Split x[4];
};
struct FragB {
  Split x[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a b at f32 accuracy: small.big + big.small + big.big, the small
// terms first (CUTLASS's OpMultiplyAddFastF32); small.small (< 2^-22
// relative) is dropped.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  const Split *x = a.x, *y = b.x;
  mma_tf32(c, x[0].small, x[1].small, x[2].small, x[3].small, y[0].big,
           y[1].big);
  mma_tf32(c, x[0].big, x[1].big, x[2].big, x[3].big, y[0].small,
           y[1].small);
  mma_tf32(c, x[0].big, x[1].big, x[2].big, x[3].big, y[0].big, y[1].big);
}

// acc += part in f32 adds. The tensor cores do not round to nearest when
// they add to an accumulator (the running sum is cut, not rounded), so a
// sum over thousands of products taken by mma alone drifts: 2e-4 of the
// scale on dk at the main shape (G x S = 32768 rows) on the card. Each
// step's products go into zeroed fragments, nine mma deep, and only
// those parts are added here.
__device__ __forceinline__ void step_sum(float (&acc)[4],
                                         const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// A = rows [r0, r0 + 16) x columns [c0, c0 + 8) of a shared tile.
template <int LD>
__device__ __forceinline__ FragA load_a(const float* s, int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (r0 + g) * LD + c0 + t;
  return {{split(p[0]), split(p[8 * LD]), split(p[4]), split(p[8 * LD + 4])}};
}

// A streamed tile, read by every warp, is split once when it has landed:
// big in place, small into sm (same layout).
template <int HD, int ROWS>
__device__ __forceinline__ void split_tile(float* s, float* sm) {
  constexpr int LD = bwd_ld<HD>(), CPR = HD / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kBwdThreads) {
    const int at = (i / CPR) * LD + (i % CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(s + at);
    const Split a = split(x.x), b = split(x.y), c = split(x.z),
                d = split(x.w);
    *reinterpret_cast<uint4*>(s + at) = make_uint4(a.big, b.big, c.big,
                                                   d.big);
    *reinterpret_cast<uint4*>(sm + at) = make_uint4(a.small, b.small,
                                                    c.small, d.small);
  }
}

__device__ __forceinline__ Split pair(const float* big, const float* small,
                                      int at) {
  return {__float_as_uint(big[at]), __float_as_uint(small[at])};
}

// B(k, n) = s[(n0 + n) * LD + k0 + k] of a split tile: the transpose of a
// tile whose rows are the product's columns (k^T in q k^T).
template <int LD>
__device__ __forceinline__ FragB load_bt(const float* big, const float* small,
                                         int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int at = (n0 + g) * LD + k0 + t;
  return {{pair(big, small, at), pair(big, small, at + 4)}};
}

// A from an mma result tile c (16 x 8, the 8 columns being the next
// product's contraction index), without moving a value between lanes: the
// product's index t is taken to be column 2t of c and t + 4 column 2t + 1.
// The B operand of that product must order its rows the same (load_bp).
__device__ __forceinline__ FragA a_from_acc(const float (&c)[4]) {
  return {{split(c[0]), split(c[2]), split(c[1]), split(c[3])}};
}

// B(k, n) = s[(k0 + row(k)) * LD + n0 + n] of a split tile, with rows
// permuted as a_from_acc orders them: k = t is row 2t, k = t + 4 row
// 2t + 1.
template <int LD>
__device__ __forceinline__ FragB load_bp(const float* big, const float* small,
                                         int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int at = (k0 + 2 * t) * LD + n0 + g;
  return {{pair(big, small, at), pair(big, small, at + LD)}};
}

// Can some (query, key) pair with positions in [qmin, qmax] x [kmin, kmax]
// see each other? False only when none can (kmin > kmax: no valid key).
__device__ __forceinline__ bool may_see(int qmin, int qmax, int kmin,
                                        int kmax, int causal, int window) {
  return kmin <= kmax && (!causal || qmax >= kmin) &&
         (window <= 0 || (int64_t)qmin - kmax < window);
}

// (min, max, or) of every thread's values, returned to every thread.
__device__ __forceinline__ void block_reduce(int& lo, int& hi, int& any,
                                             int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    any |= __shfl_xor_sync(0xffffffffu, any, o);
  }
  if (lane == 0) {
    red[warp] = lo;
    red[kBwdWarps + warp] = hi;
    red[2 * kBwdWarps + warp] = any;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kBwdWarps; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[kBwdWarps + w]);
    any |= red[2 * kBwdWarps + w];
  }
}

// The first live item >= from of a walk over n items, or n. Liveness is
// asked 32 items at a time (chunk(cb): bit l says item cb + l is live) and
// kept in (base, mask). Every warp walks the same items.
template <typename Chunk>
__device__ __forceinline__ int first_live(int from, int n, int& base,
                                          unsigned& mask, Chunk chunk) {
  while (from < n) {
    const int cb = from & ~31;
    if (cb != base) {
      base = cb;
      mask = chunk(cb);
    }
    const unsigned m = mask & (0xffffffffu << (from - cb));
    if (m) return cb + __ffs(m) - 1;
    from = cb + 32;
  }
  return n;
}

// ------------------------------------------------------------------ dq
// One block per (b, kv head, g, 128 query rows); warp w owns rows 16w ..
// 16w + 15. q and dO stay in shared memory; 24-key tiles of k and v stream
// through two stages. S = q k^T (times scale) and dP = dO v^T are
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
  constexpr int LD = bwd_ld<HD>(), BQ = kBwdRows, BK = kBwdStep;
  constexpr int NT = BK / 8, DT = HD / 8;
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
  const int g = lane >> 2, t = lane & 3, wr = 16 * warp;
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
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      const FragA a = load_a<LD>(sQ, wr, kk);
      const FragA o = load_a<LD>(sDO, wr, kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma3(s[nt], a, load_bt<LD>(tK, sKs, 8 * nt, kk));
        mma3(dp[nt], o, load_bt<LD>(tV, sVs, 8 * nt, kk));
      }
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
        mma3(part, da[nt], load_bp<LD>(tK, sKs, 8 * nt, 8 * dt));
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
    float* row = dq + (row0 + r) * HD + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<float2*>(row + 8 * dt) =
          make_float2(acc[dt][2 * h] * scale, acc[dt][2 * h + 1] * scale);
  }
}

// --------------------------------------------------------------- dk/dv
// One block per (b, kv head, 128 keys); warp w owns keys 16w .. 16w + 15.
// k and v stay in shared memory; (g, 24 query rows) steps of q, dO, lse,
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
  constexpr int LD = bwd_ld<HD>(), BKV = kBwdRows, BQ = kBwdStep;
  constexpr int NT = BQ / 8, DT = HD / 8;
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
  const int g = lane >> 2, t = lane & 3, wk = 16 * warp;
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
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      const FragA a = load_a<LD>(sK, wk, kk);
      const FragA w = load_a<LD>(sV, wk, kk);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma3(s[nt], a, load_bt<LD>(tQ, sQs, 8 * nt, kk));
        mma3(dp[nt], w, load_bt<LD>(tDO, sDOs, 8 * nt, kk));
      }
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
          mma3(part, a[nt], load_bp<LD>(big, small, 8 * nt, 8 * dt));
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
    const int64_t off = kvoff + (int64_t)c * kstride + 2 * t;
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
constexpr size_t fwd_smem(int hd) {
  return (3 * kTile * (hd + 1) + kTile * kLP) * sizeof(float) +
         2 * kTile * sizeof(int);
}
constexpr size_t dq_smem(int hd) {
  return (2 * kBwdRows + 6 * kBwdStep) * (hd + 4) * sizeof(float) +
         (2 * kBwdStep + 3 * kBwdWarps) * sizeof(int);
}
constexpr size_t dkv_smem(int hd) {
  return ((2 * kBwdRows + 6 * kBwdStep) * (hd + 4) + 4 * kBwdStep) *
             sizeof(float) +
         (2 * kBwdStep + 3 * kBwdWarps) * sizeof(int);
}
static_assert(dq_smem(128) <= 232448 && dkv_smem(128) <= 232448,
              "a backward block fits the 227 KB a block may use");

int ceil_div(int n, int d) { return (n + d - 1) / d; }
int n_tiles(int n) { return ceil_div(n, kTile); }

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
  flash_bwd_dq_kernel<HD><<<dim3(B * KV * G, ceil_div(Sq, kBwdRows)),
                            kBwdThreads, smem, s>>>(
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
  const size_t smem = dkv_smem(HD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<HD><<<dim3(B * KV, ceil_div(Sk, kBwdRows)),
                             kBwdThreads, smem, s>>>(
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
