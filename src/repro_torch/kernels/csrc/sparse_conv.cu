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
// Two bodies, chosen by dtype (kernels/_geometry.py, tensor_cores):
// - bfloat16: the dense conv's implicit GEMM on the tensor cores
//   (conv_mma_kernel<true> of conv_mma.cuh) with each step's channel
//   block taken from the oc block's own index row: each block loads its
//   count and index row into shared memory (the Pallas kernel prefetched
//   them as scalars), so a skipped block costs neither a load nor an MMA,
//   and the next nonzero block's loads are in flight during this one's
//   MMAs.  The Pallas kernel kept the whole image of a block in VMEM; a
//   Hopper block has 227 KB, so the output is tiled spatially, with the
//   dense conv model's cheapest pixel tile for the skip block's (oc, ic)
//   at the caller's batch (core/sparsity.py, sparse_pixel_tile), which
//   divides H and W.  Skip blocks pad to the MMA shape (oc and ic to 16)
//   with zero channels.  One launch sums every nonzero block in f32 and
//   rounds once.
// - float32: the CUDA-core tile kernel of conv_common.cuh with the
//   channel-block loop over idx[o, :counts[o]], spatial tiles of up to
//   8 x 16 pixels with the ragged edge masked, in IEEE fp32 (the tensor
//   cores do only TF32 on float32).
#include "conv_common.cuh"
#include "conv_mma.cuh"

// `groups` and `per_thread` are the float32 tile's layout, `warps` the
// bf16 one's (kernels/_geometry.py: conv_tile, conv_mma_tile); the other
// is ignored.
extern "C" int sparse_conv2d_fwd(const void* img, const void* wgt,
                                 const void* idx, const void* counts,
                                 void* out, int N, int IC, int H2, int W2,
                                 int OC, int KH, int KW, int boc, int bic,
                                 int max_nnz, int by, int bx, int groups,
                                 int per_thread, int warps, int is_bf16,
                                 void* stream) {
  if (max_nnz < 1 || idx == nullptr || counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using namespace rt::cm;
    ConvMmaArgs a{};
    a.img = static_cast<const bf16*>(img);
    a.wgt = static_cast<const bf16*>(wgt);
    a.out = static_cast<bf16*>(out);
    a.N = N; a.IC = IC; a.H2 = H2; a.W2 = W2; a.OC = OC; a.KH = KH;
    a.KW = KW;
    a.H = H2 - KH + 1;
    a.W = W2 - KW + 1;
    a.boc = boc; a.bic = bic; a.by = by; a.bx = bx;
    a.order[0] = 0; a.order[1] = 1; a.order[2] = 2;
    a.ic_begin = 0;
    a.ic_count = IC;
    a.accumulate = 0;
    a.idx = static_cast<const int*>(idx);
    a.counts = static_cast<const int*>(counts);
    a.max_nnz = max_nnz;
    if (bic < 1 || max_nnz > IC / bic)
      return static_cast<int>(cudaErrorInvalidValue);
    // the index row sits after the epilogue tiles
    const long long smem =
        conv_mma_layout(a, warps, (max_nnz * 4 + 15) / 16 * 16);
    if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(conv_mma_launch<true>(a, smem, st));
  }
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
  if (boc < 1 || by < 1 || bx < 1 || OC % boc)
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
  const int smem = (groups * per_thread * bic * KH * KW +
                    bic * (by + KH - 1) * (bx + KW - 1)) * 4;
  if (!rt::conv_args_ok(a, smem)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rt::conv_launch(a, smem, st));
}
