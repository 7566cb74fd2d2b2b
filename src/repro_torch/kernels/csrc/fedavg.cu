// FedAvg aggregation kernels for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the four Pallas TPU kernels of the JAX package that carry the
// unified engine's aggregation (src/repro/kernels/fedavg/fedavg.py):
//   weighted_sum_kernel  <- weighted_sum_2d  (_kernel)         paper Eq. 1
//   plane_agg_kernel     <- plane_agg_2d     (_plane_kernel)   coverage pass
//   plane_accum_kernel   <- plane_accum_2d   (_accum_kernel)   streaming fold
//   plane_finish_kernel  <- plane_finish_2d  (_finish_kernel)  streaming close
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
// so callers hand over their (K, N) planes without padding copies. Loads
// are 4-byte, so rows need no alignment beyond a float's (a plane with
// N % 4 != 0 has rows at every 4-byte offset).
//
// Layout contract (checked by the Python wrappers): every array is f32
// and contiguous, K * 4 bytes of weights fit in shared memory. Each entry
// point launches on the given stream and returns cudaGetLastError() so a
// refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

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

// This thread's kCols columns of the row starting at `row`; columns past
// n read as `pad`. All loads of a row are issued before any is used, so
// each thread keeps kCols loads per operand in flight.
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int64_t c0, int64_t n, float pad,
                                          float v[kCols]) {
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int64_t c = c0 + j * kThreads;
    v[j] = c < n ? row[c] : pad;
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
// plane_agg_kernel does.
template <bool kMask, bool kMult>
__global__ void plane_accum_kernel(float* __restrict__ num,
                                   float* __restrict__ den,
                                   float* __restrict__ cov,
                                   const float* __restrict__ x,
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
#pragma unroll 2
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

template <bool kMask>
void launch_accum(bool mult, float* num, float* den, float* cov,
                  const float* x, const float* w, const float* m,
                  const float* mu, int K, int64_t n, cudaStream_t s) {
  const size_t smem = (size_t)K * sizeof(float);
  if (mult)
    plane_accum_kernel<kMask, true><<<grid_for(n), kThreads, smem, s>>>(
        num, den, cov, x, w, m, mu, K, n);
  else
    plane_accum_kernel<kMask, false><<<grid_for(n), kThreads, smem, s>>>(
        num, den, cov, x, w, m, mu, K, n);
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

// m and mu may be null (unmasked Eq. 1 chunk / no multiplicity); mu
// needs m.
int fedavg_plane_accum(float* num, float* den, float* cov, const float* x,
                       const float* w, const float* m, const float* mu, int K,
                       long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m != nullptr)
    launch_accum<true>(mu != nullptr, num, den, cov, x, w, m, mu, K, n, s);
  else
    launch_accum<false>(false, num, den, cov, x, w, m, mu, K, n, s);
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
