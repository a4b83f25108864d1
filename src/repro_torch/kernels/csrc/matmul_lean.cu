// The lean instances of the bf16 matmul body (matmul_mma.cuh): built
// beside matmul.cu's full ones, in a process of their own.
#include "matmul_mma.cuh"

namespace rt {
namespace mm {

MmaKernel mma_kernel_lean(int wg, int bn_pad) {
#define RT_MM_CASE(W, N) \
  if (wg == W && bn_pad == N) return matmul_mma_kernel<W, N, false>;
  RT_MM_CASE(1, 16) RT_MM_CASE(1, 32) RT_MM_CASE(1, 64) RT_MM_CASE(1, 96)
  RT_MM_CASE(1, 128) RT_MM_CASE(1, 192) RT_MM_CASE(1, 256)
  RT_MM_CASE(2, 16) RT_MM_CASE(2, 32) RT_MM_CASE(2, 64) RT_MM_CASE(2, 96)
  RT_MM_CASE(2, 128) RT_MM_CASE(2, 192) RT_MM_CASE(2, 256)
#undef RT_MM_CASE
  return nullptr;
}

}  // namespace mm
}  // namespace rt
