// Block-sparse direct convolution: for each output-channel block only
// the compacted list of input-channel blocks with a nonzero weight is
// summed (idx [n_oc, max_nnz], counts [n_oc], built on the host by
// build_block_index); an oc block with count 0 writes zeros.
//
// Replaces: src/repro/kernels/sparse_conv/kernel.py,
//   sparse_conv2d_pallas (body _sparse_kernel).
// Bound on an H100: what the data needs at a block density d is the
//   image, the nonzero weight blocks and the output, and 2 d MACs of
//   the dense layer; at the thesis' Fig 6.2 layer (128 x 128, 25 x 25,
//   3 x 3) and fire9-conv3x3-2 in bf16 at batch 32 the bytes bind below
//   density 1 and the tensor-core peak at density 1 (1.1-6.0 us,
//   chip_smoke.py's [time] lines).
// Design: the tile kernel of conv_common.cuh with the channel-block
//   loop over idx[o, :counts[o]]: each block loads its oc block's count
//   and index row itself (the Pallas kernel prefetched them as scalars),
//   so skipped blocks cost neither a load nor an FMA.  The Pallas kernel
//   kept the full spatial extent of a block in VMEM; a Hopper block has
//   227 KB, so the output is tiled spatially (up to 8 x 16 pixels,
//   kernels/_geometry.py) with the ragged edge masked.  Sums are f32 and
//   the tile is written once, in the output type.
#include "conv_common.cuh"

extern "C" int sparse_conv2d_fwd(const void* img, const void* wgt,
                                 const void* idx, const void* counts,
                                 void* out, int N, int IC, int H2, int W2,
                                 int OC, int KH, int KW, int boc, int bic,
                                 int max_nnz, int by, int bx, int groups,
                                 int per_thread, int is_bf16, void* stream) {
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
  if (boc < 1 || by < 1 || bx < 1 || OC % boc || max_nnz < 1 ||
      idx == nullptr || counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.trips[0] = OC / boc;
  a.trips[1] = (a.H + by - 1) / by;
  a.trips[2] = (a.W + bx - 1) / bx;
  a.order[0] = 0; a.order[1] = 1; a.order[2] = 2;
  a.ic_begin = 0;
  a.ic_count = IC;
  a.accumulate = 0;
  a.idx = static_cast<const int*>(idx);
  a.counts = static_cast<const int*>(counts);
  a.max_nnz = max_nnz;
  const int elem = is_bf16 ? 2 : 4;
  const int smem = (groups * per_thread * bic * KH * KW +
                    bic * (by + KH - 1) * (bx + KW - 1)) * elem;
  if (!rt::conv_args_ok(a, smem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? rt::conv_launch<__nv_bfloat16>(a, smem, st)
                                  : rt::conv_launch<float>(a, smem, st);
  return static_cast<int>(err);
}
