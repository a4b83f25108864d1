// Direct "valid" convolution of a pre-padded NCHW image with a
// permutable block order and both accumulation variants of the thesis'
// schedule space.
//
// Replaces: src/repro/kernels/conv2d/kernel.py, conv2d_pallas (bodies
//   _conv_kernel_scratch and _conv_kernel_rmw).
// Bound on an H100: at the thesis' Table 4.1 layers and batch 32 the
//   arithmetic intensity is 26-400 FLOP per byte of the data each call
//   needs; the bound (chip_smoke.py's [time] lines: bytes at 3.35 TB/s
//   or FLOPs at the 989 TFLOP/s bf16 tensor-core peak) is 1.6-9.2 us a
//   layer.  This kernel runs on the CUDA cores (fp32 FMA, 67 TFLOP/s),
//   where the same layers need 5-83 us.  At batch 1 the whole layer is
//   < 0.5 us of work and a launch costs more.
// Design: the tile kernel of conv_common.cuh, one block per output tile
//   (n, oc block, y block, x block) with the weight tile and the image
//   halo staged in shared memory and the taps run from there, so each
//   input byte is read from device memory once per tile that needs it.
//   The schedule still changes what runs:
//   - block order: the output axes are linearised into blockIdx in the
//     schedule's order (batch outermost, the last axis fastest), which
//     decides which tiles run together and share weights or image rows
//     through the 50 MB L2 (the counterpart of the TPU's grid order);
//   - accumulation variant, by the TPU rule: with no output axis after
//     ic (ic innermost) one launch sums every channel block in f32
//     registers and rounds once (scratch); otherwise the wrapper runs
//     one launch per channel block, each reading the output, adding in
//     f32 and rounding back to the output type (read-modify-write).
//   float32 runs in IEEE fp32 on the CUDA cores: no TF32.
// What it leaves on the table: no tensor cores, one shared-memory read
//   per FMA for the weights; wgmma on [boc, bic] x [bic, by*bx] tap
//   products is the later design.
#include "conv_common.cuh"

extern "C" int conv2d_fwd(const void* img, const void* wgt, void* out,
                          int N, int IC, int H2, int W2, int OC, int KH,
                          int KW, int boc, int bic, int by, int bx,
                          int groups, int per_thread, int ord0, int ord1,
                          int ord2, int ic_begin, int ic_count,
                          int accumulate, int is_bf16, void* stream) {
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
  const int elem = is_bf16 ? 2 : 4;
  const int smem = (groups * per_thread * bic * KH * KW +
                    bic * (by + KH - 1) * (bx + KW - 1)) * elem;
  if (!rt::conv_args_ok(a, smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? rt::conv_launch<__nv_bfloat16>(a, smem, st)
                                  : rt::conv_launch<float>(a, smem, st);
  return static_cast<int>(err);
}
