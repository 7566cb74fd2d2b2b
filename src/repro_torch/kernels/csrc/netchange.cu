// NetChange To-Wider (paper Alg. 2) for Hopper (sm_90a): hand-written CUDA
// C++, f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/netchange/widen.py
// widen_2d (_kernel): out[r, j] = x[r, map[j]] * scale[j]. The TPU kernel
// turns that gather into a matmul against a scaled one-hot selection
// block, which keeps the TPU's matrix unit busy and its lanes dense. Here
// that would do `old` multiply-adds per output where the gather needs
// one, so this is the gather itself.
//
// The operand is any tensor widened along one axis, seen as (outer, old,
// inner) with that axis in the middle: out[o, j, i] = x[o, map[j], i] *
// scale[j]; a null scale is 1 (duplicate incoming weights; the outgoing
// weights' split divides each duplicate group by its size). Bound: bytes
// (at most one multiply per output element against 8 bytes moved): x
// read once, out written once.
//   cols  inner == 1, a matrix widened along its columns. A block stages
//         a whole row of x in shared memory (one coalesced read), then
//         writes the row of out in column order (coalesced), gathering
//         from shared memory: a duplicated column costs no second read of
//         device memory. Blocks walk rows; map and scale come through the
//         L1 cache. Rows longer than kMaxSmemCols floats take the plain
//         gather (a thread per column, reads from L2).
//   rows  inner > 1, widened along a leading axis. A block copies whole
//         inner rows, x row map[j] -> out row (o, j), 16 bytes a thread
//         when inner is a multiple of 4 and the rows are aligned.
// Any shape is taken as it is, with no padding.
//
// The entry point launches on the given stream and returns
// cudaGetLastError(). The Python wrapper (kernels/netchange/widen.py)
// checks dtypes, shapes and contiguity; kernels/netchange/ops.py checks
// that every map[j] lies in [0, old).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 512;
constexpr int kMaxSmemCols = 12288;   // 48 KB of f32: no opt-in needed
constexpr int kRowsPerThread = 8;     // gather: rows each thread walks
constexpr int kMaxGridY = 65535;
constexpr int kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kRowThreads)
widen_cols_smem_kernel(const float* __restrict__ x,
                       const int* __restrict__ map,
                       const float* __restrict__ scale,
                       float* __restrict__ out, int64_t rows, int old,
                       int nw) {
  extern __shared__ float srow[];
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    __syncthreads();                   // the previous row is written out
    const float* xr = x + r * old;
    for (int i = threadIdx.x; i < old; i += kRowThreads) srow[i] = xr[i];
    __syncthreads();
    float* orow = out + r * nw;
    for (int j = threadIdx.x; j < nw; j += kRowThreads)
      orow[j] = srow[__ldg(map + j)] * (scale ? __ldg(scale + j) : 1.f);
  }
}

__global__ void __launch_bounds__(kThreads)
widen_cols_kernel(const float* __restrict__ x, const int* __restrict__ map,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int64_t rows, int old, int nw) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nw) return;
  const int src = map[j];
  const float sc = scale ? scale[j] : 1.f;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y)
    out[r * nw + j] = x[r * old + src] * sc;
}

template <bool VEC4>
__global__ void __launch_bounds__(kThreads)
widen_rows_kernel(const float* __restrict__ x, const int* __restrict__ map,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int64_t outer, int old, int nw, int64_t inner) {
  const int64_t pairs = outer * nw;
  for (int64_t p = blockIdx.x; p < pairs; p += gridDim.x) {
    const int64_t o = p / nw;
    const int j = (int)(p - o * nw);
    const float sc = scale ? scale[j] : 1.f;
    const float* xr = x + (o * old + map[j]) * inner;
    float* orow = out + p * inner;
    if (VEC4) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      float4* o4 = reinterpret_cast<float4*>(orow);
      for (int64_t i = threadIdx.x; i < inner / 4; i += kThreads) {
        float4 a = x4[i];
        a.x *= sc; a.y *= sc; a.z *= sc; a.w *= sc;
        o4[i] = a;
      }
    } else {
      for (int64_t i = threadIdx.x; i < inner; i += kThreads)
        orow[i] = xr[i] * sc;
    }
  }
}

int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

}  // namespace

extern "C" {

const char* widen_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int widen(const float* x, const int* map, const float* scale, float* out,
          int64_t outer, int old, int nw, int64_t inner, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (outer < 1 || old < 1 || nw < 1 || inner < 1)
    return (int)cudaErrorInvalidValue;
  if (inner == 1 && old <= kMaxSmemCols) {
    widen_cols_smem_kernel<<<(unsigned)min64(outer, kMaxBlocks), kRowThreads,
                             old * sizeof(float), s>>>(x, map, scale, out,
                                                       outer, old, nw);
  } else if (inner == 1) {
    const int64_t gy = (outer + kRowsPerThread - 1) / kRowsPerThread;
    const dim3 grid((nw + kThreads - 1) / kThreads,
                    (unsigned)min64(gy, kMaxGridY));
    widen_cols_kernel<<<grid, kThreads, 0, s>>>(x, map, scale, out, outer,
                                                old, nw);
  } else {
    const unsigned grid = (unsigned)min64(outer * nw, kMaxBlocks);
    const bool vec4 = inner % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    if (vec4)
      widen_rows_kernel<true><<<grid, kThreads, 0, s>>>(x, map, scale, out,
                                                        outer, old, nw,
                                                        inner);
    else
      widen_rows_kernel<false><<<grid, kThreads, 0, s>>>(x, map, scale, out,
                                                         outer, old, nw,
                                                         inner);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
