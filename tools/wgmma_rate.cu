// The rate of wgmma.m64nNk16 (bf16 in, f32 accumulate) with both
// operands K-major in shared memory without swizzle: the layout of the
// conv body's halo and weights (src/repro_torch/kernels/csrc/
// conv_mma.cuh), at the wgmma widths it uses (N 16, 32, 64), one to four
// warpgroups a block, an A plane stride (LBO) of a real halo's 189 rows
// and of one core matrix, beside the 128-byte swizzle of the matmul body.
// One block an SM, 132 blocks; each warpgroup issues 8 wgmmas a commit,
// 200 commits, and the block's clock64 span gives FLOP a clock an SM
// (the bf16 dense peak is about 4,096).  On a card with nvcc:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -I src/repro_torch/kernels/csrc -o build/wgmma_rate \
//       tools/wgmma_rate.cu && build/wgmma_rate
#include <cstdio>

#include "hopper.cuh"

using namespace rt;

constexpr int kSmem = 200 * 1024;
constexpr int kIters = 200;

// layout 0: no swizzle, LBO a_lbo / b_lbo and SBO 128 bytes; layout 1:
// the 128-byte swizzle (rows of 128 bytes, SBO 1024 bytes)
template <int N>
__global__ void rate(uint32_t a_lbo, uint32_t b_lbo, int layout,
                     long long* out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int i = threadIdx.x; i < kSmem / 4; i += blockDim.x)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  hw::fence_proxy_async();
  __syncthreads();
  float acc[N / 2];
  const uint32_t a0 = hw::smem_u32(smem) + (threadIdx.x / 128) * 8192;
  const uint32_t b0 = hw::smem_u32(smem) + 65536;
  const uint32_t lbo_a = layout ? 1 : a_lbo, lbo_b = layout ? 1 : b_lbo;
  const uint32_t sbo = layout ? 64 : 8, step = layout ? 32 : 0;
  const long long t0 = clock64();
  hw::wgmma_fence();
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      hw::WgmmaKMajor<N>::run(
          acc, hw::make_desc(a0 + k * step, lbo_a, sbo, layout),
          hw::make_desc(b0 + k * step, lbo_b, sbo, layout), it + k > 0);
    hw::wgmma_commit();
  }
  hw::wgmma_wait<0>();
  hw::fence_regs(acc, N / 2);
  const long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = t1 - t0;
    out[2 * blockIdx.x + 1] = static_cast<long long>(s);
  }
}

template <int N>
void run(int wgs, uint32_t a_lbo, uint32_t b_lbo, int layout) {
  long long* d = nullptr;
  cudaMalloc(&d, 132 * 2 * sizeof(long long));
  cudaFuncSetAttribute(rate<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  rate<N><<<132, 128 * wgs, kSmem>>>(a_lbo, b_lbo, layout, d);
  const cudaError_t err = cudaDeviceSynchronize();
  long long h[2] = {0, 0};
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  const double flop = 2.0 * 64 * N * 16 * 8 * kIters * wgs;
  std::printf("N=%d warpgroups=%d a_lbo=%u b_lbo=%u swizzle128=%d: "
              "%lld cycles, %.1f FLOP a clock an SM (%s)\n",
              N, wgs, a_lbo, b_lbo, layout, h[0], flop / h[0],
              cudaGetErrorString(err));
  cudaFree(d);
}

int main() {
  // LBO in 16-byte units: a 189-row halo plane, B planes of N rows
  for (int wgs : {1, 2, 4}) {
    run<64>(wgs, 189, 64, 0);
    run<64>(wgs, 8, 8, 0);
    run<32>(wgs, 189, 32, 0);
    run<16>(wgs, 189, 16, 0);
    run<64>(wgs, 1, 1, 1);
  }
  return 0;
}
