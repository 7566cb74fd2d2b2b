// Split-TF32 ("3xTF32") tensor-core pieces for the attention kernels of
// flash_attention.cu and swa_attention.cu (sm_90a).
//
// Every f32 operand x is split into big = tf32(x) and small =
// tf32(x - big), and a b is taken as small.big + big.small + big.big with
// f32 accumulation (mma.sync.m16n8k8 tf32; CUTLASS's OpMultiplyAddFastF32,
// the route of PyTorch's own f32 memory-efficient attention): f32 accuracy
// at 3 tensor-core products per f32 one, 495 / 3 = 165 TFLOP/s on the H100
// data sheet. A value that is already a TF32 value (a bf16 one) has a zero
// small part, and its products need only the two terms with its big part.
//
// Tiles are copied with cp.async (16 bytes a thread, zero-filled past the
// end) into shared memory whose rows are padded to hd + 4 floats (4 mod 8):
// the fragment loads (rows g, columns t) and (rows 2t, columns g) of a
// warp, g = lane / 4, t = lane % 4, then fall in 32 distinct banks. A block
// has kTileThreads threads, 8 warps of 16 rows each.
//
// The header is included by one .cu file of each library, so its
// definitions sit in an anonymous namespace.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;

// The row stride of every tile, hd + 4 floats.
template <int HD>
__host__ __device__ constexpr int tile_ld() { return HD + 4; }

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
  constexpr int LD = tile_ld<HD>(), CPR = HD / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kTileThreads) {
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

// c += a b where b's small part is zero (b a TF32 value: a bf16 one):
// small.big + big.big.
__device__ __forceinline__ void mma2(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  const Split *x = a.x, *y = b.x;
  mma_tf32(c, x[0].small, x[1].small, x[2].small, x[3].small, y[0].big,
           y[1].big);
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

// The contractions over hd (s = q k^T, dP = dO v^T) from hd 128 up: the
// products go into zeroed fragments kHdPart k-steps (8-deep products) at
// a time, each part then added to the running sum in f32 as step_sum
// does, instead of the tensor cores accumulating the whole hd (as they
// do below hd 128). Left to the cut running sum, the backward's dq and
// dk lie past tests/test_flash.py's elementwise bound (1e-5 + 1e-5 |x|)
// from the float64 function at the trainer shapes (S 2048, 128 heads)
// at hd 192 and 256, and dk at hd 128 on glm4-9b's training shape (B 8,
// KV 2, G 16, S 2048); in parts of 8 k-steps they keep inside it or
// closer to it (tools/flash_accuracy_probe.py reads the built kernels'
// share of the bound).
constexpr int kHdPart = 8;

template <int HD>
__host__ __device__ constexpr bool round_hd() {
  return HD >= 128;
}

// NT accumulator tiles' sums over hd, k-step kk at a time: products go
// into(sum, nt); begin and end bracket each k-step.
template <int HD, int NT>
struct HdSum {
  float part[round_hd<HD>() ? NT : 1][4];

  __device__ __forceinline__ void begin(int kk) {
    if constexpr (round_hd<HD>()) {
      if ((kk / 8) % kHdPart == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
      }
    }
  }
  __device__ __forceinline__ float (&into(float (&sum)[NT][4],
                                          int nt))[4] {
    if constexpr (round_hd<HD>()) return part[nt];
    else return sum[nt];
  }
  __device__ __forceinline__ void end(float (&sum)[NT][4], int kk) {
    if constexpr (round_hd<HD>()) {
      if ((kk / 8) % kHdPart == kHdPart - 1 || kk + 8 == HD) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) step_sum(sum[nt], part[nt]);
      }
    }
  }
};

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
  constexpr int LD = tile_ld<HD>(), CPR = HD / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += kTileThreads) {
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
    red[kTileWarps + warp] = hi;
    red[2 * kTileWarps + warp] = any;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kTileWarps; ++w) {
    lo = min(lo, red[w]);
    hi = max(hi, red[kTileWarps + w]);
    any |= red[2 * kTileWarps + w];
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

}  // namespace
