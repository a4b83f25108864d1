// Direct "valid" convolution of a pre-padded NCHW image with a
// permutable block order and both accumulation variants of the thesis'
// schedule space.  Two bodies, chosen by dtype (a fixed rule: both are
// checked on the card by chip_smoke.py):
//
// Replaces: src/repro/kernels/conv2d/kernel.py, conv2d_pallas (bodies
//   _conv_kernel_scratch and _conv_kernel_rmw).
// Bound on an H100: at the thesis' Table 4.1 layers and batch 32 the
//   arithmetic intensity is 26-400 FLOP per byte of the data each call
//   needs; the bound (chip_smoke.py's [time] lines: bytes at 3.35 TB/s
//   or FLOPs at the 989 TFLOP/s bf16 tensor-core peak) is 1.6-9.2 us a
//   layer, 43 us for the eight.  On the CUDA cores (fp32 FMA, 67
//   TFLOP/s) the same layers need at least 0.23 ms.  At batch 1 the
//   whole layer is < 0.5 us of work and a launch costs more.
//
// bfloat16: conv_mma_kernel<false> of conv_mma.cuh, an implicit GEMM on
//   the tensor cores (mma.sync.m16n8k16): the halo staged channels-last
//   and read by ldmatrix at each tap's shift, the next channel block's
//   loads in flight during the MMAs (the header holds its design notes).
//   Block order and variant as the JAX kernel's: the output tiles are
//   linearised into blockIdx in the schedule's order; with no output
//   axis after ic one launch sums every channel block and rounds once
//   (scratch), otherwise the wrapper runs one launch per channel block
//   (read-modify-write).
//
// float32: the CUDA-core tile kernel of conv_common.cuh (the block-sparse
//   conv's body too), in IEEE fp32: no TF32.
#include "conv_common.cuh"
#include "conv_mma.cuh"

// float32: the CUDA-core tile kernel (conv_common.cuh).
extern "C" int conv2d_fwd(const void* img, const void* wgt, void* out,
                          int N, int IC, int H2, int W2, int OC, int KH,
                          int KW, int boc, int bic, int by, int bx,
                          int groups, int per_thread, int ord0, int ord1,
                          int ord2, int ic_begin, int ic_count,
                          int accumulate, void* stream) {
  rt::ConvArgs a{};
  a.img = img;
  a.wgt = wgt;
  a.out = out;
  a.N = N; a.IC = IC; a.H2 = H2; a.W2 = W2; a.OC = OC; a.KH = KH; a.KW = KW;
  a.H = H2 - KH + 1;
  a.W = W2 - KW + 1;
  a.boc = boc; a.bic = bic; a.by = by; a.bx = bx;
  a.groups = groups;
  a.per_thread = per_thread;
  if (boc < 1 || by < 1 || bx < 1 || OC % boc || a.H % by || a.W % bx ||
      ic_begin < 0 || ic_count < bic || ic_count % bic ||
      ic_begin + ic_count > IC)
    return static_cast<int>(cudaErrorInvalidValue);
  a.trips[0] = OC / boc;
  a.trips[1] = a.H / by;
  a.trips[2] = a.W / bx;
  a.order[0] = ord0; a.order[1] = ord1; a.order[2] = ord2;
  if (ord0 + ord1 + ord2 != 3 || ord0 == ord1 || ord1 == ord2 ||
      ord0 == ord2 || ord0 < 0 || ord1 < 0 || ord2 < 0 || ord0 > 2 ||
      ord1 > 2 || ord2 > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  a.ic_begin = ic_begin;
  a.ic_count = ic_count;
  a.accumulate = accumulate;
  a.idx = nullptr;
  a.counts = nullptr;
  a.max_nnz = 0;
  const int smem = (groups * per_thread * bic * KH * KW +
                    bic * (by + KH - 1) * (bx + KW - 1)) * 4;
  if (!rt::conv_args_ok(a, smem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      rt::conv_launch(a, smem, static_cast<cudaStream_t>(stream)));
}

// bfloat16: the implicit GEMM.  `warps` is the wrapper's layout
// (kernels/_geometry.py, conv_mma_tile); the rest is derived and checked
// here.
extern "C" int conv2d_mma_fwd(const void* img, const void* wgt, void* out,
                              int N, int IC, int H2, int W2, int OC, int KH,
                              int KW, int boc, int bic, int by, int bx,
                              int warps, int ord0, int ord1, int ord2,
                              int ic_begin, int ic_count, int accumulate,
                              void* stream) {
  using namespace rt::cm;
  ConvMmaArgs a{};
  a.img = static_cast<const bf16*>(img);
  a.wgt = static_cast<const bf16*>(wgt);
  a.out = static_cast<bf16*>(out);
  a.N = N; a.IC = IC; a.H2 = H2; a.W2 = W2; a.OC = OC; a.KH = KH; a.KW = KW;
  a.H = H2 - KH + 1;
  a.W = W2 - KW + 1;
  a.boc = boc; a.bic = bic; a.by = by; a.bx = bx;
  if (bic < 1 || ic_begin < 0 || ic_count < bic || ic_count % bic ||
      ic_begin + ic_count > IC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ord0 + ord1 + ord2 != 3 || ord0 == ord1 || ord1 == ord2 ||
      ord0 == ord2 || ord0 < 0 || ord1 < 0 || ord2 < 0 || ord0 > 2 ||
      ord1 > 2 || ord2 > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  a.order[0] = ord0; a.order[1] = ord1; a.order[2] = ord2;
  a.ic_begin = ic_begin;
  a.ic_count = ic_count;
  a.accumulate = accumulate;
  const long long smem = conv_mma_layout(a, warps, 0);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      conv_mma_launch<false>(a, smem, static_cast<cudaStream_t>(stream)));
}
