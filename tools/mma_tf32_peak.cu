// The rate of the TF32 tensor-core instruction the flash backward uses
// (mma.sync.aligned.m16n8k8 tf32 with f32 accumulation), on one card: the
// ceiling of a kernel built from it, beside the data sheet's dense TF32
// rate (495 TFLOP/s on an H100 SXM), which only wgmma reaches.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_tf32_peak \
//       tools/mma_tf32_peak.cu && ./mma_tf32_peak
//
// Each warp runs `chains` independent accumulators through `iters`
// products on values held in registers (no memory traffic); four blocks
// of 8 warps per SM.
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a,
                                         uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(b), "r"(b + 1));
}

template <int CHAINS>
__global__ void products(float* out, int iters) {
  float c[CHAINS][4] = {};
  const uint32_t a = threadIdx.x, b = 3 * threadIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma_tf32(c[j], a, b + j);
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS>
void run(float* out, int sms) {
  const int iters = 4096, warps = 8, blocks = 4 * sms;
  products<CHAINS><<<blocks, 32 * warps>>>(out, 16);   // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  products<CHAINS><<<blocks, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flops = 2.0 * 16 * 8 * 8 * CHAINS * (double)iters * blocks *
                       warps;
  printf("mma.sync m16n8k8 tf32, %d chains a warp: %.1f TFLOP/s\n", CHAINS,
         flops / ms / 1e9);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  float* out = nullptr;
  cudaMalloc(&out, 4 * prop.multiProcessorCount * 256 * sizeof(float));
  run<1>(out, prop.multiProcessorCount);
  run<2>(out, prop.multiProcessorCount);
  run<4>(out, prop.multiProcessorCount);
  run<8>(out, prop.multiProcessorCount);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
