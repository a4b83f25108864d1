// Direct-convolution tile kernel on the CUDA cores, in IEEE fp32: the
// float32 body of the dense conv (conv2d.cu) and of the block-sparse conv
// (sparse_conv.cu).  (bf16 runs the tensor-core body of conv_mma.cuh.)
//
//   out[n, oc, y, x] = sum_{ic, ky, kx} wgt[oc, ic, ky, kx]
//                                       * img[n, ic, y + ky, x + kx]
// img [N, IC, H + KH - 1, W + KW - 1] (pre-padded), wgt [OC, IC, KH, KW],
// out [N, OC, H, W], all float32.
//
// A thread block owns one (n, oc block, y block, x block) output tile.
// For each input-channel block it sums (the dense kernel: the blocks of
// [ic_begin, ic_begin + ic_count); the sparse kernel: the compacted
// list idx[o, :counts[o]]), it stages the [boc, bic, KH, KW] weight tile
// and the [bic, by + KH - 1, bx + KW - 1] image halo in shared memory and
// runs the taps from there.  Thread t owns pixel p = t % (by * bx) of the
// tile and the J contiguous output channels g J .. g J + J - 1 of it, g =
// t / (by * bx), J a power of two up to 16.  The weight tile is staged
// transposed, [bic, KH, KW, G J] with zeros past boc, so a thread's J
// weights of one tap are contiguous and load as 16-byte vectors (the
// same address across a warp: a broadcast), and one image value feeds J
// FMAs.  Each channel block's contribution is summed into fresh
// registers and then added to the running total, as the TPU kernel adds
// each block's dot product into its f32 scratch.  The tile is written
// once, or, for an RMW pass (accumulate = 1), added to the value already
// in `out`, as _conv_kernel_rmw does.  Pixels outside H x W (the
// sparse kernel's ragged edge) are masked.
#pragma once
#include "common.cuh"
#include "hopper.cuh"

namespace rt {
// Internal linkage: conv2d.cu and sparse_conv.cu each get their own
// instances, so the two objects never register the same kernel symbol.
namespace {

struct ConvArgs {
  const void* img;
  const void* wgt;
  void* out;
  int N, IC, H2, W2, OC, KH, KW, H, W;
  int boc, bic, by, bx;
  int groups, per_thread;      // G and J of the tile layout
  int trips[3];                // output-tile trips: oc, y, x
  int order[3];                // output axes outer -> inner (0 oc, 1 y, 2 x)
  int ic_begin, ic_count;      // dense: the channel range this launch sums
  int accumulate;              // 1: an RMW pass after the first
  const int* idx;              // sparse: [n_oc, max_nnz] nonzero ic blocks
  const int* counts;           // sparse: [n_oc]; null for the dense kernel
  int max_nnz;
};

// The J weights of one tap, contiguous in shared memory: 16-byte vector
// loads where J fills them (4 floats).
template <int J>
__device__ __forceinline__ void load_taps(const float* p, float* w) {
  if constexpr (J % 4 == 0) {
#pragma unroll
    for (int j = 0; j < J; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      w[j] = v.x; w[j + 1] = v.y; w[j + 2] = v.z; w[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) w[j] = p[j];
  }
}

template <int J>
__global__ void __launch_bounds__(1024) conv_tile_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);
  const int taps = a.KH * a.KW;
  const int ocp = a.groups * J;                 // padded channels a row
  float* i_s = w_s + ocp * a.bic * taps;
  const int hh = a.by + a.KH - 1, ww = a.bx + a.KW - 1;

  // The block's output tile: batch outermost, then the output axes in
  // the schedule's order, the last fastest.
  long long lin = blockIdx.x;
  int t[3];
  for (int i = 2; i >= 0; --i) {
    const int ax = a.order[i];
    t[ax] = static_cast<int>(lin % a.trips[ax]);
    lin /= a.trips[ax];
  }
  const int n = static_cast<int>(lin);
  const int oc0 = t[0] * a.boc, y0 = t[1] * a.by, x0 = t[2] * a.bx;

  const int pixels = a.by * a.bx;
  const int g = threadIdx.x / pixels, p = threadIdx.x % pixels;
  const int py = p / a.bx, px = p % a.bx;

  const float* img = static_cast<const float*>(a.img);
  const float* wgt = static_cast<const float*>(a.wgt);
  float total[J];
#pragma unroll
  for (int j = 0; j < J; ++j) total[j] = 0.f;

  const int nblocks = a.counts != nullptr ? a.counts[t[0]]
                                          : a.ic_count / a.bic;
  const int row = a.bic * taps;                 // weights of one channel
  const int bd = blockDim.x;
  // each thread's first staged element and its stride, as carried indices
  const int w_o0 = threadIdx.x / row, w_r0 = threadIdx.x % row;
  const int w_do = bd / row, w_dr = bd % row;
  const int i_c0 = threadIdx.x / (hh * ww), i_r0 = (threadIdx.x / ww) % hh,
            i_q0 = threadIdx.x % ww;
  const int i_dc = bd / (hh * ww), i_dr = (bd / ww) % hh, i_dq = bd % ww;
  for (int b = 0; b < nblocks; ++b) {
    const int ic0 = a.counts != nullptr
                        ? a.idx[t[0] * a.max_nnz + b] * a.bic
                        : a.ic_begin + b * a.bic;
    __syncthreads();   // the previous block's taps are done with smem
    // Staging walks each thread's elements with carried indices (no
    // integer division per element).  Weights: global reads run along a
    // channel's (ic, ky, kx), shared writes transpose to [ic, ky, kx, oc].
    for (int o = w_o0, r = w_r0; o < ocp;) {
      const int oc = oc0 + o;
      w_s[r * ocp + o] =
          (o < a.boc && oc < a.OC)
              ? wgt[(static_cast<size_t>(oc) * a.IC + ic0) * taps + r]
              : 0.f;
      r += w_dr;
      o += w_do;
      if (r >= row) { r -= row; ++o; }
    }
    // image halo [bic, hh, ww], x fastest
    const float* isrc =
        img + (static_cast<size_t>(n) * a.IC + ic0) * a.H2 * a.W2;
    for (int c = i_c0, r = i_r0, q = i_q0; c < a.bic;) {
      const int yy = y0 + r, xx = x0 + q;
      i_s[(c * hh + r) * ww + q] =
          (yy < a.H2 && xx < a.W2)
              ? isrc[(static_cast<size_t>(c) * a.H2 + yy) * a.W2 + xx]
              : 0.f;
      q += i_dq;
      r += i_dr;
      c += i_dc;
      if (q >= ww) { q -= ww; ++r; }
      if (r >= hh) { r -= hh; ++c; }
    }
    __syncthreads();
    float part[J];
#pragma unroll
    for (int j = 0; j < J; ++j) part[j] = 0.f;
    const float* wcol = w_s + g * J;
    for (int c = 0; c < a.bic; ++c) {
      for (int ky = 0; ky < a.KH; ++ky) {
        const float* irow = i_s + (c * hh + py + ky) * ww + px;
        const float* wtap =
            wcol + static_cast<size_t>((c * a.KH + ky) * a.KW) * ocp;
        for (int kx = 0; kx < a.KW; ++kx) {
          const float v = irow[kx];
          float w[J];
          load_taps<J>(wtap + kx * ocp, w);
#pragma unroll
          for (int j = 0; j < J; ++j) part[j] = fmaf(w[j], v, part[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) total[j] += part[j];
  }

  const int y = y0 + py, x = x0 + px;
  if (y >= a.H || x >= a.W) return;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = g * J + j, oc = oc0 + o;
    if (o >= a.boc || oc >= a.OC) continue;
    const size_t off = ((static_cast<size_t>(n) * a.OC + oc) * a.H + y) * a.W + x;
    out[off] = a.accumulate ? out[off] + total[j] : total[j];
  }
}

template <int J>
cudaError_t conv_launch_j(const ConvArgs& a, int smem, cudaStream_t st) {
  // above 48 KB a block's dynamic shared memory must be opted into
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(conv_tile_kernel<J>), 232448);
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(a.N) * a.trips[0] *
                           a.trips[1] * a.trips[2];
  if (blocks < 1 || blocks > 2147483647LL) return cudaErrorInvalidValue;
  conv_tile_kernel<J><<<static_cast<unsigned>(blocks),
                              a.groups * a.by * a.bx, smem, st>>>(a);
  return cudaGetLastError();
}

inline cudaError_t conv_launch(const ConvArgs& a, int smem, cudaStream_t st) {
  switch (a.per_thread) {
    case 1: return conv_launch_j<1>(a, smem, st);
    case 2: return conv_launch_j<2>(a, smem, st);
    case 4: return conv_launch_j<4>(a, smem, st);
    case 8: return conv_launch_j<8>(a, smem, st);
    case 16: return conv_launch_j<16>(a, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

// Checks shared by both entry points; the wrappers check the same limits
// first (kernels/_geometry.py) and raise with a message.
inline bool conv_args_ok(const ConvArgs& a, int smem) {
  const int threads = a.groups * a.by * a.bx;
  return a.N >= 1 && a.IC >= 1 && a.OC >= 1 && a.KH >= 1 && a.KW >= 1 &&
         a.H == a.H2 - a.KH + 1 && a.W == a.W2 - a.KW + 1 && a.H >= 1 &&
         a.W >= 1 && a.boc >= 1 && a.bic >= 1 && a.IC % a.bic == 0 &&
         a.by >= 1 && a.bx >= 1 && a.groups >= 1 && threads <= 1024 &&
         a.per_thread >= 1 && a.per_thread <= 16 &&
         a.groups * a.per_thread >= a.boc && smem <= 232448 &&
         a.trips[0] >= 1 && a.trips[1] >= 1 && a.trips[2] >= 1;
}

}  // namespace
}  // namespace rt
