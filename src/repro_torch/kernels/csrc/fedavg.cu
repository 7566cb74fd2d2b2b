// FedAvg aggregation kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the seven Pallas TPU kernels of the JAX package that carry
// its aggregation (src/repro/kernels/fedavg/fedavg.py):
//   weighted_sum_kernel   <- weighted_sum_2d  (_kernel)         paper Eq. 1
//   plane_agg_kernel      <- plane_agg_2d     (_plane_kernel)   coverage pass
//     and, without a fallback, weighted_sum_masked_2d (_masked_kernel) and
//     weighted_sum_masked_mult_2d (_masked_mult_kernel): the per-leaf
//     coverage average, bound as two entry points of their own
//   plane_accum_kernel    <- plane_accum_2d   (_accum_kernel)   streaming fold
//     (f32 or bf16 chunks: the bf16 wire's chunk is read as it is)
//   plane_accum_q_kernel  <- plane_accum_q_2d (_accum_q_kernel) int8 wire:
//     dequantize + streaming fold in one pass
//   plane_finish_kernel   <- plane_finish_2d  (_finish_kernel)  streaming close
//
// Bound: device-memory bandwidth. Each kernel does 1-3 flops per 4-byte
// element it reads (about 0.25-0.5 flop/byte), two orders of magnitude
// below the card's balance point, so the only lever is to move each byte
// once. The design does exactly that: a block owns a tile of
// kCols * kThreads adjacent columns of the (K, N) row-major operands and
// each thread kCols columns of it, kThreads apart, so every load of a
// warp reads 32 consecutive floats (128 contiguous bytes, coalesced).
// A thread walks k = 0..K-1 in order with its running sums in f32
// registers; every operand byte is read once and every output byte
// written once, and nothing is staged through shared memory except the
// K client weights. The sum over k is sequential per column, so results
// are deterministic (no atomics, no cross-block reduction). Template
// flags drop the operands a variant does not have, so the unmasked
// filler path streams only x.
//
// Any N is taken as it is: the last tile's columns past N are skipped,
// so callers hand over their (K, N) planes without padding copies. Rows
// need no alignment beyond the element's (a plane with N % 4 != 0 has
// rows at every 4-byte offset, and an int8 chunk's rows at every byte
// offset): the kernels above plane_accum_q load one element at a time;
// plane_accum_q, whose int8 rows would make byte loads, owns 8 adjacent
// columns a thread instead (4 in its coverage variants) and realigns
// aligned 8-byte int8 words (4-byte with masks) in registers (its own
// note below).
//
// Layout contract (checked by the Python wrappers): every array is
// contiguous and f32, except a streamed chunk, which may be bf16
// (plane_accum) or int8 with f32 per-tile scales (plane_accum_q); K * 4
// bytes of weights fit in shared memory. Each entry
// point launches on the given stream and returns cudaGetLastError() so a
// refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                      // columns per thread
constexpr int kTile = kThreads * kCols;       // columns per block

// The K client weights, once per block, in shared memory.
__device__ __forceinline__ void stage_weights(float* sw, const float* w, int K) {
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
}

// This thread's first column; its j-th is col0 + j * kThreads.
__device__ __forceinline__ int64_t first_col() {
  return blockIdx.x * (int64_t)kTile + threadIdx.x;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// This thread's kCols columns of the row starting at `row`, as f32;
// columns past n read as `pad`. All loads of a row are started before any
// is used, so each thread keeps kCols loads per operand in flight.
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ row,
                                          int64_t c0, int64_t n, float pad,
                                          float v[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t c = c0 + j * kThreads;
    v[j] = c < n ? to_f32(row[c]) : pad;
  }
}

// out[n] = sum_k w[k] x[k, n]
__global__ void weighted_sum_kernel(const float* __restrict__ x,
                                    const float* __restrict__ w,
                                    float* __restrict__ out, int K, int64_t n) {
  extern __shared__ float sw[];
  stage_weights(sw, w, K);
  const int64_t c0 = first_col();
  float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xv[kCols];
    load_cols(x + k * n, c0, n, 0.f, xv);
    const float wk = sw[k];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] += wk * xv[j];
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t c = c0 + j * kThreads;
    if (c < n) out[c] = acc[j];
  }
}

// Per coordinate: wm = w m [/ mu, mu <= 0 read as 1]; num = sum wm x;
// renorm -> num / sum wm where that is > 0, else 0; fb where sum m == 0.
template <bool kMult, bool kFb, bool kRenorm>
__global__ void plane_agg_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ m,
                                 const float* __restrict__ mu,
                                 const float* __restrict__ fb,
                                 float* __restrict__ out, int K, int64_t n) {
  extern __shared__ float sw[];
  stage_weights(sw, w, K);
  const int64_t c0 = first_col();
  float num[kCols] = {0.f, 0.f, 0.f, 0.f};
  float den[kCols] = {0.f, 0.f, 0.f, 0.f};
  float cov[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const int64_t off = k * n;
    float xv[kCols], mv[kCols], uv[kCols];
    load_cols(x + off, c0, n, 0.f, xv);
    load_cols(m + off, c0, n, 0.f, mv);
    if (kMult) load_cols(mu + off, c0, n, 1.f, uv);
    const float wk = sw[k];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float wm = wk * mv[j];
      if (kMult) wm = wm / (uv[j] > 0.f ? uv[j] : 1.f);
      num[j] += wm * xv[j];
      den[j] += wm;
      cov[j] += mv[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t c = c0 + j * kThreads;
    if (c < n) {
      float o = num[j];
      if (kRenorm) o = den[j] > 0.f ? num[j] / den[j] : 0.f;
      if (kFb) o = cov[j] > 0.f ? o : fb[c];
      out[c] = o;
    }
  }
}

// In place: num += sum wm x, den += sum wm, cov += sum m (m = 1 when absent).
// cov stays its own buffer so the w = 0 corner reads coverage like
// plane_agg_kernel does. T is the chunk's element type (f32, or bf16 for
// the bf16 wire: each element is widened to f32 in registers, as the
// Pallas kernel casts its block in VMEM, so the f32 chunk never exists).
// A bf16 row load moves half the bytes of an f32 one, so the bf16
// instance unrolls 4 rows instead of 2 to keep as many bytes in flight.
template <typename T, bool kMask, bool kMult>
__global__ void plane_accum_kernel(float* __restrict__ num,
                                   float* __restrict__ den,
                                   float* __restrict__ cov,
                                   const T* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ m,
                                   const float* __restrict__ mu,
                                   int K, int64_t n) {
  extern __shared__ float sw[];
  stage_weights(sw, w, K);
  const int64_t c0 = first_col();
  float sn[kCols] = {0.f, 0.f, 0.f, 0.f};
  float sd[kCols] = {0.f, 0.f, 0.f, 0.f};
  float sc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll (sizeof(T) < 4 ? 4 : 2)
  for (int k = 0; k < K; ++k) {
    const int64_t off = k * n;
    float xv[kCols], mv[kCols] = {1.f, 1.f, 1.f, 1.f}, uv[kCols];
    load_cols(x + off, c0, n, 0.f, xv);
    if (kMask) load_cols(m + off, c0, n, 0.f, mv);
    if (kMult) load_cols(mu + off, c0, n, 1.f, uv);
    const float wk = sw[k];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float wm = wk * mv[j];
      if (kMult) wm = wm / (uv[j] > 0.f ? uv[j] : 1.f);
      sn[j] += wm * xv[j];
      sd[j] += wm;
      sc[j] += mv[j];
    }
  }
  float a[kCols], d[kCols], v[kCols];
  load_cols(num, c0, n, 0.f, a);
  load_cols(den, c0, n, 0.f, d);
  load_cols(cov, c0, n, 0.f, v);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t c = c0 + j * kThreads;
    if (c < n) {
      num[c] = a[j] + sn[j];
      den[c] = d[j] + sd[j];
      cov[c] = v[j] + sc[j];
    }
  }
}

// ------------------------------------------------------------ plane_accum_q
// The int8 wire's fused dequantize-accumulate, in place on num/den/cov:
// x[k, c] = q[k, c] * s[k, c / tile] in registers, then plane_accum's
// fold (masks m, multiplicities mu), or with kFold the filler_mode=
// "global" fold x m + base (1 - m) followed by an UNMASKED accumulate
// (den += w, cov += 1 per row), as _accum_q_kernel does.
//
// Bound: bytes. Per chunk row it reads 1 byte per coordinate (plus 4 per
// mask/mult coordinate) and a scale per tile, and the three f32 buffers
// are read and written once per launch, so an unmasked 16-row chunk moves
// 40 bytes per coordinate against 88 for an f32 chunk. Byte loads move 32
// bytes a warp instruction, so each lane owns C ADJACENT columns and
// reads a row as aligned words (RowC): a row of an odd-width chunk starts
// at any byte offset o (one value per row: every lane's first column is
// a multiple of C), so a lane loads the aligned words holding its C
// bytes from the first, takes the word after them from its right
// neighbour with a shuffle (the warp's last lane loads it), and cuts its
// bytes out with selects and funnel shifts; an aligned row skips both.
// Only words holding a byte of the row are read, so no load leaves the
// allocation's granules, whatever the chunk's base (a row slice xq[lo:hi]
// starts anywhere). The f32 masks and multiplicities are read the same
// way (offsets in whole floats), the f32 buffers num/den/cov and base as
// float4 where all C columns exist and the buffers are 16-byte aligned.
// int8 -> f32 is exact with a byte permute: 0x4B000000 | (q ^ 0x80) is
// 2^23 + q + 128. The C columns lie in one scale tile (tile is a multiple
// of 128), so a lane loads one scale a row. The arithmetic per column is
// plane_accum's, rows in order in f32 registers, no atomics; den and cov,
// the same for every column without masks, are one register each there.
// The loads of kAccumQRows rows (kAccumQRowsMasked with masks or the
// fold) are issued before any is used. C is kAccumQCols = 8 (8-byte
// int8 words, two float4 of f32) without masks and kAccumQColsMasked =
// 4 (4-byte int8 words, one float4 of each f32 operand) in the coverage
// variants. Measured on the H100 at the VGG plane, with builds since
// removed (PERF.md): 16 columns a lane (16-byte int8 words) took
// 80 registers against 48, read num/den/cov 64 bytes a lane apart and
// ran 2% (16 rows) and 14% (4 rows) slower than 8; 2 and 8 rows in
// flight were within the spread of 4; the coverage variants, whose
// per-column den and cov take registers, ran fastest at 4 columns and
// one row in flight.
constexpr int kAccumQCols = 8;
constexpr int kAccumQColsMasked = 4;
constexpr int kAccumQRows = 4;
constexpr int kAccumQRowsMasked = 1;

// A lane's C consecutive elements of E bytes (1: int8, 4: f32) of a row
// that starts at any E-aligned address. fetch() issues the loads of the
// aligned V-byte words (V = C E up to 16) that hold the lane's C E bytes
// from its first and, on the warp's last lane, of the word after them;
// get() realigns them, taking the word after the lane's own from its
// right neighbour. Every lane of the warp calls get().
template <int E, int C>
struct RowC {
  static constexpr int B = C * E;             // bytes a lane owns
  static constexpr int V = B < 16 ? B : 16;   // bytes a load moves
  static constexpr int KW = B / 4, VW = V / 4;
  using Vec = std::conditional_t<
      V == 16, uint4, std::conditional_t<V == 8, uint2, uint32_t>>;
  uint32_t w[KW];
  uint32_t tail[VW];
  int o;                                      // the row's offset mod V

  __device__ __forceinline__ void fetch(const void* row, int64_t n,
                                        int64_t c0, int lane) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row);
    const uintptr_t end = lo + (uintptr_t)n * E;
    o = (int)(lo % V);
    const uintptr_t a = lo + (uintptr_t)c0 * E - o;
#pragma unroll
    for (int j = 0; j < B / V; ++j) {
      Vec x = {};
      if (a + V * j < end)
        x = __ldg(reinterpret_cast<const Vec*>(a + V * j));
      memcpy(&w[VW * j], &x, V);
    }
    Vec t = {};
    if (lane == 31 && o != 0 && a + B < end)
      t = __ldg(reinterpret_cast<const Vec*>(a + B));
    memcpy(tail, &t, V);
  }

  __device__ __forceinline__ void get(uint32_t (&out)[KW], int lane) const {
    if (o == 0) {                   // an aligned row: the lane's own words
#pragma unroll
      for (int j = 0; j < KW; ++j) out[j] = w[j];
      return;
    }
    uint32_t x[KW + VW];
#pragma unroll
    for (int j = 0; j < KW; ++j) x[j] = w[j];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      x[KW + j] = __shfl_down_sync(0xffffffffu, w[j], 1);
      if (lane == 31) x[KW + j] = tail[j];
    }
    // u[j] = x[j + o / 4]: skip whole words (one select stage per bit of
    // o / 4 < VW), then o % 4 bytes (int8 only: f32 rows sit at whole
    // floats, and their funnel shifts would read one word more)
    constexpr int NU = E == 1 ? KW + 1 : KW;
    const int q = o >> 2;
    uint32_t u[NU];
    if constexpr (VW == 4) {
      uint32_t t[NU + 1];
#pragma unroll
      for (int j = 0; j < NU + 1; ++j) t[j] = (q & 2) ? x[j + 2] : x[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) u[j] = (q & 1) ? t[j + 1] : t[j];
    } else if constexpr (VW == 2) {
#pragma unroll
      for (int j = 0; j < NU; ++j) u[j] = (q & 1) ? x[j + 1] : x[j];
    } else {                                  // 4-byte words: q is 0
#pragma unroll
      for (int j = 0; j < NU; ++j) u[j] = x[j];
    }
    if constexpr (E == 1) {
      const unsigned sh = 8u * (o & 3);
#pragma unroll
      for (int j = 0; j < KW; ++j)
        out[j] = __funnelshift_r(u[j], u[j + 1], sh);
    } else {
#pragma unroll
      for (int j = 0; j < KW; ++j) out[j] = u[j];
    }
  }
};

// Byte j (0..3) of w, a signed int8, as f32 (exact).
__device__ __forceinline__ float int8_at(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7440u | j)) - 8388736.f;
}

// C columns c0.. of an f32 row of n as float4 when all exist and `vec`
// (the buffer is 16-byte aligned); columns past n read as 0.
template <int C>
__device__ __forceinline__ void load_run(const float* __restrict__ p,
                                         int64_t c0, int64_t n, bool vec,
                                         float (&v)[C]) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < C; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c0 + j);
      v[j] = x.x; v[j + 1] = x.y; v[j + 2] = x.z; v[j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = c0 + j < n ? p[c0 + j] : 0.f;
  }
}

template <int C>
__device__ __forceinline__ void store_run(float* __restrict__ p, int64_t c0,
                                          int64_t n, bool vec,
                                          const float (&v)[C]) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < C; j += 4)
      *reinterpret_cast<float4*>(p + c0 + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (c0 + j < n) p[c0 + j] = v[j];
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Columns a lane owns: kAccumQCols, or kAccumQColsMasked for the
// coverage variants.
template <bool kMask>
__host__ __device__ constexpr int accum_q_cols() {
  return kMask ? kAccumQColsMasked : kAccumQCols;
}

template <bool kMask, bool kMult, bool kFold>
__global__ void __launch_bounds__(kThreads)
plane_accum_q_kernel(float* __restrict__ num, float* __restrict__ den,
                     float* __restrict__ cov, const int8_t* __restrict__ xq,
                     const float* __restrict__ s, const float* __restrict__ w,
                     const float* __restrict__ m,
                     const float* __restrict__ mu,
                     const float* __restrict__ base, int K, int64_t n,
                     int64_t n_tiles, int tile) {
  constexpr bool kReadM = kMask || kFold;
  constexpr int R = kReadM ? kAccumQRowsMasked : kAccumQRows;
  constexpr int C = accum_q_cols<kMask>();
  constexpr int NC = kMask ? C : 1;           // den, cov: per column or one
  extern __shared__ float sw[];
  stage_weights(sw, w, K);
  const int lane = threadIdx.x & 31;
  const int64_t c0 = (blockIdx.x * (int64_t)kThreads + threadIdx.x) * C;
  const int64_t t = (c0 < n ? c0 : n - 1) / tile;
  const bool full = c0 + C <= n;
  const bool vec = full && aligned16(num) && aligned16(den) &&
                   aligned16(cov);
  float bv[C];
  if (kFold) load_run<C>(base, c0, n, full && aligned16(base), bv);
  float sn[C], sd[NC], sc[NC];
#pragma unroll
  for (int j = 0; j < C; ++j) sn[j] = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) sd[j] = sc[j] = 0.f;

  // rows k0 .. k0 + NR - 1: every load first, then the arithmetic in order
  auto rows = [&](int k0, auto nr) {
    constexpr int NR = decltype(nr)::value;
    RowC<1, C> xr[NR];
    RowC<4, C> mr[NR], ur[NR];
    float sv[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int64_t off = (int64_t)(k0 + r) * n;
      xr[r].fetch(xq + off, n, c0, lane);
      sv[r] = __ldg(s + (int64_t)(k0 + r) * n_tiles + t);
      if (kReadM) mr[r].fetch(m + off, n, c0, lane);
      if (kMult) ur[r].fetch(mu + off, n, c0, lane);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float wk = sw[k0 + r];
      uint32_t xw[C / 4], mw[C], uw[C];   // int8: 4 columns a word
      xr[r].get(xw, lane);
      if (kReadM) mr[r].get(mw, lane);
      if (kMult) ur[r].get(uw, lane);
#pragma unroll
      for (int j = 0; j < C; ++j) {
        float x = int8_at(xw[j >> 2], j & 3) * sv[r];
        if (kFold) {
          const float mv = __uint_as_float(mw[j]);
          x = x * mv + bv[j] * (1.f - mv);
        }
        if (kMask) {
          const float mv = __uint_as_float(mw[j]);
          float wm = wk * mv;
          if (kMult) {
            const float uv = __uint_as_float(uw[j]);
            wm = wm / (uv > 0.f ? uv : 1.f);
          }
          sn[j] += wm * x;
          sd[j] += wm;
          sc[j] += mv;
        } else {
          sn[j] += wk * x;
        }
      }
      if (!kMask) {
        sd[0] += wk;
        sc[0] += 1.f;
      }
    }
  };
  int k = 0;
  for (; k + R <= K; k += R) rows(k, std::integral_constant<int, R>());
  for (; k < K; ++k) rows(k, std::integral_constant<int, 1>());

  if (c0 >= n) return;
  float a[C], d[C], v[C];
  load_run<C>(num, c0, n, vec, a);
  load_run<C>(den, c0, n, vec, d);
  load_run<C>(cov, c0, n, vec, v);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    a[j] += sn[j];
    d[j] += sd[kMask ? j : 0];
    v[j] += sc[kMask ? j : 0];
  }
  store_run<C>(num, c0, n, vec, a);
  store_run<C>(den, c0, n, vec, d);
  store_run<C>(cov, c0, n, vec, v);
}

// out = num [/ den where den > 0, else 0]; fb where cov == 0.
template <bool kRenorm, bool kFb>
__global__ void plane_finish_kernel(const float* __restrict__ num,
                                    const float* __restrict__ den,
                                    const float* __restrict__ cov,
                                    const float* __restrict__ fb,
                                    float* __restrict__ out, int64_t n) {
  const int64_t c0 = first_col();
  float o[kCols], dv[kCols], cv[kCols], fv[kCols];
  load_cols(num, c0, n, 0.f, o);
  if (kRenorm) load_cols(den, c0, n, 0.f, dv);
  if (kFb) {
    load_cols(cov, c0, n, 0.f, cv);
    load_cols(fb, c0, n, 0.f, fv);
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t c = c0 + j * kThreads;
    if (kRenorm) o[j] = dv[j] > 0.f ? o[j] / dv[j] : 0.f;
    if (kFb) o[j] = cv[j] > 0.f ? o[j] : fv[j];
    if (c < n) out[c] = o[j];
  }
}

unsigned int grid_for(int64_t n) {
  return (unsigned int)((n + kTile - 1) / kTile);
}

template <bool kMult, bool kFb>
void launch_agg(bool renorm, const float* x, const float* w, const float* m,
                const float* mu, const float* fb, float* out, int K,
                int64_t n, cudaStream_t s) {
  const size_t smem = (size_t)K * sizeof(float);
  if (renorm)
    plane_agg_kernel<kMult, kFb, true><<<grid_for(n), kThreads, smem, s>>>(
        x, w, m, mu, fb, out, K, n);
  else
    plane_agg_kernel<kMult, kFb, false><<<grid_for(n), kThreads, smem, s>>>(
        x, w, m, mu, fb, out, K, n);
}

template <typename T, bool kMask>
void launch_accum(bool mult, float* num, float* den, float* cov,
                  const T* x, const float* w, const float* m,
                  const float* mu, int K, int64_t n, cudaStream_t s) {
  const size_t smem = (size_t)K * sizeof(float);
  if (mult)
    plane_accum_kernel<T, kMask, true><<<grid_for(n), kThreads, smem, s>>>(
        num, den, cov, x, w, m, mu, K, n);
  else
    plane_accum_kernel<T, kMask, false><<<grid_for(n), kThreads, smem, s>>>(
        num, den, cov, x, w, m, mu, K, n);
}

template <typename T>
void dispatch_accum(float* num, float* den, float* cov, const T* x,
                    const float* w, const float* m, const float* mu, int K,
                    int64_t n, cudaStream_t s) {
  if (m != nullptr)
    launch_accum<T, true>(mu != nullptr, num, den, cov, x, w, m, mu, K, n, s);
  else
    launch_accum<T, false>(false, num, den, cov, x, w, m, mu, K, n, s);
}

template <bool kMask, bool kMult, bool kFold>
void launch_accum_q(float* num, float* den, float* cov, const int8_t* xq,
                    const float* sc, const float* w, const float* m,
                    const float* mu, const float* base, int K, int64_t n,
                    int64_t n_tiles, int tile, cudaStream_t s) {
  constexpr int64_t tile_cols = (int64_t)kThreads * accum_q_cols<kMask>();
  plane_accum_q_kernel<kMask, kMult, kFold>
      <<<(unsigned int)((n + tile_cols - 1) / tile_cols), kThreads,
         (size_t)K * sizeof(float), s>>>(num, den, cov, xq, sc, w, m, mu,
                                         base, K, n, n_tiles, tile);
}

template <bool kRenorm>
void launch_finish(bool has_fb, const float* num, const float* den,
                   const float* cov, const float* fb, float* out, int64_t n,
                   cudaStream_t s) {
  if (has_fb)
    plane_finish_kernel<kRenorm, true><<<grid_for(n), kThreads, 0, s>>>(
        num, den, cov, fb, out, n);
  else
    plane_finish_kernel<kRenorm, false><<<grid_for(n), kThreads, 0, s>>>(
        num, den, cov, fb, out, n);
}

}  // namespace

extern "C" {

const char* fedavg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fedavg_weighted_sum(const float* x, const float* w, float* out, int K,
                        long long n, void* stream) {
  weighted_sum_kernel<<<grid_for(n), kThreads, (size_t)K * sizeof(float),
                        (cudaStream_t)stream>>>(x, w, out, K, n);
  return (int)cudaGetLastError();
}

// mu and fb may be null (no multiplicity / no fallback).
int fedavg_plane_agg(const float* x, const float* w, const float* m,
                     const float* mu, const float* fb, float* out, int K,
                     long long n, int renorm, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mu != nullptr) {
    if (fb != nullptr) launch_agg<true, true>(renorm, x, w, m, mu, fb, out, K, n, s);
    else launch_agg<true, false>(renorm, x, w, m, mu, fb, out, K, n, s);
  } else {
    if (fb != nullptr) launch_agg<false, true>(renorm, x, w, m, mu, fb, out, K, n, s);
    else launch_agg<false, false>(renorm, x, w, m, mu, fb, out, K, n, s);
  }
  return (int)cudaGetLastError();
}

// The per-leaf coverage average: plane_agg without a fallback (an
// uncovered coordinate renorms to 0). mu must be null here and non-null
// in the _mult entry point.
int fedavg_weighted_sum_masked(const float* x, const float* w,
                               const float* m, float* out, int K,
                               long long n, int renorm, void* stream) {
  launch_agg<false, false>(renorm, x, w, m, nullptr, nullptr, out, K, n,
                           (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int fedavg_weighted_sum_masked_mult(const float* x, const float* w,
                                    const float* m, const float* mu,
                                    float* out, int K, long long n,
                                    int renorm, void* stream) {
  launch_agg<true, false>(renorm, x, w, m, mu, nullptr, out, K, n,
                          (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// m and mu may be null (unmasked Eq. 1 chunk / no multiplicity); mu
// needs m. x is f32 (fedavg_plane_accum) or bf16 (_bf16).
int fedavg_plane_accum(float* num, float* den, float* cov, const float* x,
                       const float* w, const float* m, const float* mu, int K,
                       long long n, void* stream) {
  dispatch_accum<float>(num, den, cov, x, w, m, mu, K, n,
                        (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int fedavg_plane_accum_bf16(float* num, float* den, float* cov,
                            const void* x, const float* w, const float* m,
                            const float* mu, int K, long long n,
                            void* stream) {
  dispatch_accum<__nv_bfloat16>(num, den, cov,
                                (const __nv_bfloat16*)x, w, m, mu, K, n,
                                (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// xq: int8 (K, n); sc: f32 (K, n_tiles) with n_tiles = ceil(n / tile).
// m, mu and base may be null: m alone = coverage, m + mu = coverage with
// multiplicity, m + base = the fold (mu null).
int fedavg_plane_accum_q(float* num, float* den, float* cov,
                         const signed char* xq, const float* sc,
                         const float* w, const float* m, const float* mu,
                         const float* base, int K, long long n,
                         long long n_tiles, int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* q = (const int8_t*)xq;
  if (base != nullptr)
    launch_accum_q<false, false, true>(num, den, cov, q, sc, w, m, mu, base,
                                       K, n, n_tiles, tile, s);
  else if (mu != nullptr)
    launch_accum_q<true, true, false>(num, den, cov, q, sc, w, m, mu, base,
                                      K, n, n_tiles, tile, s);
  else if (m != nullptr)
    launch_accum_q<true, false, false>(num, den, cov, q, sc, w, m, mu, base,
                                       K, n, n_tiles, tile, s);
  else
    launch_accum_q<false, false, false>(num, den, cov, q, sc, w, m, mu,
                                        base, K, n, n_tiles, tile, s);
  return (int)cudaGetLastError();
}

// fb may be null; den and cov are read only when renorm / fb need them.
int fedavg_plane_finish(const float* num, const float* den, const float* cov,
                        const float* fb, float* out, long long n, int renorm,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (renorm) launch_finish<true>(fb != nullptr, num, den, cov, fb, out, n, s);
  else launch_finish<false>(fb != nullptr, num, den, cov, fb, out, n, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
