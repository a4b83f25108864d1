// The bf16 implicit GEMM on the tensor cores, shared by the dense conv
// (conv2d.cu) and the block-sparse conv (sparse_conv.cu).
//
//   out[n, oc, y, x] = sum_{ic, ky, kx} wgt[oc, ic, ky, kx]
//                                       * img[n, ic, y + ky, x + kx]
// img [N, IC, H + KH - 1, W + KW - 1] (pre-padded), wgt [OC, IC, KH, KW],
// out [N, OC, H, W], all bf16.
//
// conv_mma_kernel<Sparse>: a block owns one output tile (n, oc block,
//   y block, x block) and computes D[pixels, oc] = sum over taps and
//   channel blocks of A_tap[pixels, ic] . B_tap[ic, oc] -- the JAX
//   kernel's per-tap [BOC, BIC] x [BIC, BY*BX] contraction -- with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Where a step's
//   channel block comes from is the template's one difference:
//   - dense (Sparse = false): the range [ic_begin, ic_begin + ic_count)
//     in blocks of bic;
//   - sparse (Sparse = true): idx[o, j] for j < counts[o], o the tile's
//     oc block.  The block loads its own count and index row into shared
//     memory before the first stage (the Pallas kernel's scalar
//     prefetch), so the in-flight loads of the next channel block follow
//     idx[o, j + 1]; an oc block with count 0 stages nothing and writes
//     zeros.  Every nonzero block is summed in one launch and rounded
//     once, as _sparse_kernel does.
//   - Staging: per channel block the image halo is staged channels-last,
//     [by+KH-1][bx+KW-1][bic_pad + 8] (the transpose from NCHW happens
//     here, eight channels of a pixel packed into one 16-byte store), and
//     the weights as [taps][boc_pad][bic_pad + 8], ic contiguous, so both
//     operands' fragments load by ldmatrix without .trans.  Rows are
//     16-byte aligned and their stride is an odd number of 16-byte units
//     (no bank conflicts across ldmatrix's eight rows).  Every tap reads
//     the same halo at a shift: lane l gives ldmatrix the address of its
//     pixel's row plus the tap's offset ky (bx+KW-1) + kx, so any tap and
//     any tile shape work without a copy per tap.
//   - Padding: pixels pad to 16 (the MMA's M), oc to 16 (ldmatrix.x4
//     loads two n8 fragments), ic to 16 (its K); the padded channels are
//     zero in both operands, padded pixels read pixel 0 and are never
//     stored, so every block that divides its dimension is taken.
//   - Warps: each warp owns a 32-pixel x 32-channel tile (2 x 4 MMAs,
//     32 f32 accumulators a thread); a block has up to 16 warps, and a
//     larger output tile is covered in rounds, each restaging the halo
//     and the weights.
//   - Overlap: two stage buffers; before channel block b's MMAs every
//     thread issues the global loads of its first kUnits staging units of
//     block b + 1 into registers, and stores them into the other buffer
//     after the MMAs, so those loads are in flight while block b
//     multiplies.  Units past kUnits a thread are staged after the MMAs
//     (the tuner's cost model charges them).  One __syncthreads a block.
//   - Epilogue: each warp writes its accumulators to its own f32 tile in
//     shared memory and stores them channel by channel with lanes along
//     the pixels, so stores are coalesced along x in NCHW; an RMW pass
//     reads the output, adds in f32 and rounds back.
//   - Block order: the output tiles are linearised into blockIdx in the
//     schedule's order (batch outermost, the last axis fastest).
//   Why mma.sync and not wgmma: wgmma's A operand from shared memory must
//   sit in its canonical (swizzled, 8-row-core-matrix) layout, which a
//   tap's shifted pixel rows do not; from registers it would take the
//   same ldmatrix loads.  wgmma would add its asynchronous issue (MMAs
//   overlapping the next tap's fragment loads) and a 64 x N tile per
//   instruction, halving the shared-memory reads per FLOP of the
//   weights; the 32 x 32 warp tile here reads 16 bytes of shared memory
//   per 16 FLOP, which bounds it near half the bf16 peak.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace rt {
// Internal linkage: conv2d.cu and sparse_conv.cu each get their own
// instances, so the two objects never register the same kernel symbol.
namespace {
namespace cm {

using bf16 = __nv_bfloat16;
constexpr int kMaxWarps = 16;
constexpr int kUnits = 4;          // staging units a thread keeps in flight
constexpr int kEpiStride = 36;     // f32 row of a warp's epilogue tile
constexpr int kEpiBytes = 32 * kEpiStride * 4;

struct ConvMmaArgs {
  const bf16* img;
  const bf16* wgt;
  bf16* out;
  int N, IC, H2, W2, OC, KH, KW, H, W;
  int boc, bic, by, bx;
  int trips[3];                // output-tile trips: oc, y, x
  int order[3];                // output axes outer -> inner (0 oc, 1 y, 2 x)
  int ic_begin, ic_count;      // dense: the channel range this launch sums
  int accumulate;              // 1: an RMW pass after the first
  const int* idx;              // sparse: [n_oc, max_nnz] nonzero ic blocks
  const int* counts;           // sparse: [n_oc]
  int max_nnz;
  int warps, wt_m, wt_n, rounds;
  int p16, boc16, bic_pad, cstr;   // padded pixels, oc, ic; row stride
  int halo_bytes, stage_bytes;     // one stage: halo, then weights
};

// One staging unit: eight channels of one halo pixel or of one weight
// row of a tap, loaded through registers and stored as 16 bytes.  The
// loaded halves stay unpacked until the store, so nothing waits on the
// loads before then.
struct Unit {
  unsigned short h[8];
  int dst;                     // byte offset in the stage buffer; -1: none
};

__device__ __forceinline__ void store_unit(unsigned char* buf, const Unit& x) {
  *reinterpret_cast<uint4*>(buf + x.dst) = make_uint4(
      x.h[0] | (uint32_t(x.h[1]) << 16), x.h[2] | (uint32_t(x.h[3]) << 16),
      x.h[4] | (uint32_t(x.h[5]) << 16), x.h[6] | (uint32_t(x.h[7]) << 16));
}

// A thread's walk over the staging units u = tid, tid + T, ... of one
// channel block (T threads).  Halo units decode as (q, r, oct), q
// fastest, so lanes read along x; weight units as (o, t, oct), o
// fastest, so the 16-byte stores are conflict-free.  The decode does not
// depend on the channel block (only the source's ic0 term does), so each
// thread decodes its first halo unit and its first weight unit once, by
// division, and then carries the indices forward by T.
struct Walk {
  int u;                       // the unit
  int a, b, c;                 // halo: q, r, oct; weights: o, t, oct
};

struct WalkPlan {
  Walk halo0, wgt0;            // this thread's first halo / weight unit
  int da, db, dc;              // T as a halo step: q, r, oct
  int ea, eb, ec;              // T as a weight step: o, t, oct
  int n_halo, n_units;
};

__device__ __forceinline__ WalkPlan make_plan(const ConvMmaArgs& a, int tid,
                                              int nthreads) {
  const int hh = a.by + a.KH - 1, ww = a.bx + a.KW - 1;
  const int taps = a.KH * a.KW;
  const int noct = (a.bic + 7) / 8;
  WalkPlan p;
  p.n_halo = hh * ww * noct;
  p.n_units = p.n_halo + taps * a.boc * noct;
  p.halo0 = {tid, tid % ww, (tid / ww) % hh, tid / (ww * hh)};
  const int uw = tid >= p.n_halo
                     ? tid
                     : tid + (p.n_halo - tid + nthreads - 1) / nthreads * nthreads;
  const int w = uw - p.n_halo;
  p.wgt0 = {uw, w % a.boc, (w / a.boc) % taps, w / (a.boc * taps)};
  p.da = nthreads % ww; p.db = (nthreads / ww) % hh; p.dc = nthreads / (ww * hh);
  p.ea = nthreads % a.boc; p.eb = (nthreads / a.boc) % taps;
  p.ec = nthreads / (a.boc * taps);
  return p;
}

__device__ __forceinline__ void advance(Walk& w, const WalkPlan& p,
                                        const ConvMmaArgs& a, int nthreads) {
  const int nu = w.u + nthreads;
  if (w.u < p.n_halo) {
    if (nu >= p.n_halo) { w = p.wgt0; return; }   // wgt0.u == nu
    const int hh = a.by + a.KH - 1, ww = a.bx + a.KW - 1;
    w.a += p.da; w.b += p.db; w.c += p.dc;
    if (w.a >= ww) { w.a -= ww; ++w.b; }
    if (w.b >= hh) { w.b -= hh; ++w.c; }
  } else {
    const int taps = a.KH * a.KW;
    w.a += p.ea; w.b += p.eb; w.c += p.ec;
    if (w.a >= a.boc) { w.a -= a.boc; ++w.b; }
    if (w.b >= taps) { w.b -= taps; ++w.c; }
  }
  w.u = nu;
}

// The unit at `w` of the channel block whose halo starts at `img_b` and
// whose weight tile starts at `wgt_b` (both already offset by ic0).
__device__ __forceinline__ Unit load_unit(const ConvMmaArgs& a, const Walk& w,
                                          const WalkPlan& p,
                                          const unsigned short* img_b,
                                          const unsigned short* wgt_b) {
  const int taps = a.KH * a.KW;
  const unsigned short* src;
  int stride;
  Unit out;
  if (w.u < p.n_halo) {
    const int ww = a.bx + a.KW - 1;
    src = img_b + (8 * w.c * a.H2 + w.b) * a.W2 + w.a;
    stride = a.H2 * a.W2;
    out.dst = ((w.b * ww + w.a) * a.cstr + 8 * w.c) * 2;
  } else {
    src = wgt_b + (w.a * a.IC + 8 * w.c) * taps + w.b;
    stride = taps;
    out.dst = a.halo_bytes + ((w.b * a.boc16 + w.a) * a.cstr + 8 * w.c) * 2;
  }
  const int valid = min(8, a.bic - 8 * w.c);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    out.h[j] = j < valid ? __ldg(src + j * stride)
                         : static_cast<unsigned short>(0);
  return out;
}

template <bool Sparse>
__global__ void __launch_bounds__(32 * kMaxWarps)
conv_mma_kernel(const ConvMmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* epi = reinterpret_cast<float*>(smem_raw + 2 * a.stage_bytes) +
               (threadIdx.x / 32) * 32 * kEpiStride;

  // the block's output tile: batch outermost, then the output axes in
  // the schedule's order, the last fastest
  long long lin = blockIdx.x;
  int t[3];
  for (int i = 2; i >= 0; --i) {
    const int ax = a.order[i];
    t[ax] = static_cast<int>(lin % a.trips[ax]);
    lin /= a.trips[ax];
  }
  const int n = static_cast<int>(lin);
  const int oc0 = t[0] * a.boc, y0 = t[1] * a.by, x0 = t[2] * a.bx;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ww = a.bx + a.KW - 1;
  const int taps = a.KH * a.KW;
  const int pixels = a.by * a.bx;
  const int noct = (a.bic + 7) / 8;
  const int n_units = ((a.by + a.KH - 1) * ww + taps * a.boc) * noct;
  // channel blocks this tile sums: the dense range, or the oc block's
  // nonzero count
  const int nblocks = Sparse ? a.counts[t[0]] : a.ic_count / a.bic;
  int* idx_s = reinterpret_cast<int*>(smem_raw + 2 * a.stage_bytes +
                                      a.warps * kEpiBytes);
  if constexpr (Sparse) {
    if (nblocks == 0) {      // no nonzero block: the tile is zero
      unsigned short* out = reinterpret_cast<unsigned short*>(a.out);
      for (int i = tid; i < a.boc * pixels; i += nthreads) {
        const int o = i / pixels, p = i % pixels;
        out[((static_cast<size_t>(n) * a.OC + oc0 + o) * a.H + y0 +
             p / a.bx) * a.W + x0 + p % a.bx] = 0;
      }
      return;
    }
    for (int j = tid; j < nblocks; j += nthreads)
      idx_s[j] = a.idx[t[0] * a.max_nnz + j];
  }
  const int steps = a.rounds * nblocks;

  // zero both stages once: padded channels and rows stay zero (the
  // barrier also publishes the sparse index row)
  for (int i = tid; i < a.stage_bytes * 2 / 16; i += nthreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const WalkPlan plan = make_plan(a, tid, nthreads);
  const unsigned short* img_n = reinterpret_cast<const unsigned short*>(a.img) +
      (static_cast<size_t>(n) * a.IC * a.H2 + y0) * a.W2 + x0;
  const unsigned short* wgt_o = reinterpret_cast<const unsigned short*>(a.wgt) +
      static_cast<size_t>(oc0) * a.IC * taps;
  // step st's first input channel
  auto ic_of = [&](int st) {
    if constexpr (Sparse) return idx_s[st % nblocks] * a.bic;
    else return a.ic_begin + (st % nblocks) * a.bic;
  };
  // step st's channel block: its halo and weight-tile sources
  auto img_of = [&](int st) {
    return img_n + static_cast<size_t>(ic_of(st)) * a.H2 * a.W2;
  };
  auto wgt_of = [&](int st) { return wgt_o + ic_of(st) * taps; };
  const Walk start = tid < plan.n_halo ? plan.halo0 : plan.wgt0;
  // stage the units of step st from `w` on (synchronously)
  auto stage_rest = [&](int st, Walk w, unsigned char* buf) {
    const unsigned short* ib = img_of(st);
    const unsigned short* wb = wgt_of(st);
    for (; w.u < n_units; advance(w, plan, a, nthreads))
      store_unit(buf, load_unit(a, w, plan, ib, wb));
  };
  stage_rest(0, start, smem_raw);
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int st = 0; st < steps; ++st) {
    const int rd = st / nblocks;
    const bool last_of_round = st % nblocks == nblocks - 1;
    unsigned char* buf = smem_raw + (st & 1) * a.stage_bytes;
    // the first kUnits units of the next step: loads in flight during
    // this step's MMAs
    Unit pre[kUnits];
    Walk w = start;
    const bool next = st + 1 < steps;
    if (next) {
      const unsigned short* ib = img_of(st + 1);
      const unsigned short* wb = wgt_of(st + 1);
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        if (w.u < n_units) {
          pre[i] = load_unit(a, w, plan, ib, wb);
          advance(w, plan, a, nthreads);
        } else {
          pre[i].dst = -1;
        }
      }
    }

    // ---- this warp's MMAs on stage `buf`
    const int wt = rd * a.warps + warp;
    const bool has_tile = wt < a.wt_m * a.wt_n;
    const int pm0 = (wt % a.wt_m) * 32, pn0 = (wt / a.wt_m) * 32;
    if (has_tile) {
      const uint32_t halo = hw::smem_u32(buf);
      const uint32_t wts = halo + a.halo_bytes;
      bool m_on[2], n_on[2];
      uint32_t a_row[2], b_row[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        m_on[mt] = pm0 + 16 * mt < a.p16;
        int p = pm0 + 16 * mt + (lane & 15);
        if (p >= pixels) p = 0;                  // padded rows read pixel 0
        a_row[mt] = halo + (((p / a.bx) * ww + p % a.bx) * a.cstr +
                            (lane >> 4) * 8) * 2;
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        n_on[np] = pn0 + 16 * np < a.boc16;
        b_row[np] = wts + ((pn0 + 16 * np + (lane >> 4) * 8 + (lane & 7)) *
                               a.cstr + ((lane >> 3) & 1) * 8) * 2;
      }
      const uint32_t tap_rows = a.boc16 * a.cstr * 2;   // bytes a tap
      for (int ky = 0; ky < a.KH; ++ky) {
        for (int kx = 0; kx < a.KW; ++kx) {
          const uint32_t a_tap = (ky * ww + kx) * a.cstr * 2;
          const uint32_t b_tap = (ky * a.KW + kx) * tap_rows;
          for (int kc = 0; kc < a.bic_pad; kc += 16) {
            uint32_t af[2][4], bf[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              if (m_on[mt]) hw::ldmatrix_x4(af[mt], a_row[mt] + a_tap + kc * 2);
#pragma unroll
            for (int np = 0; np < 2; ++np)
              if (n_on[np]) hw::ldmatrix_x4(bf[np], b_row[np] + b_tap + kc * 2);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nb = 0; nb < 4; ++nb)
                if (m_on[mt] && n_on[nb / 2])
                  hw::mma_16816(acc[mt][nb], af[mt], bf[nb / 2][2 * (nb % 2)],
                                bf[nb / 2][2 * (nb % 2) + 1]);
          }
        }
      }
    }

    if (next) {
      unsigned char* nbuf = smem_raw + ((st + 1) & 1) * a.stage_bytes;
#pragma unroll
      for (int i = 0; i < kUnits; ++i)
        if (pre[i].dst >= 0) store_unit(nbuf, pre[i]);
      stage_rest(st + 1, w, nbuf);
    }

    if (last_of_round && has_tile) {
      // accumulators -> this warp's f32 tile [oc 32][pixel 32] -> output
      const int g = lane / 4, q = lane % 4;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            epi[(8 * nb + 2 * q + (e & 1)) * kEpiStride + 16 * mt + g +
                8 * (e >> 1)] = acc[mt][nb][e];
            acc[mt][nb][e] = 0.f;
          }
      __syncwarp();
      const int p = pm0 + lane;
      if (p < pixels) {
        const int y = y0 + p / a.bx, x = x0 + p % a.bx;
        unsigned short* out = reinterpret_cast<unsigned short*>(a.out);
        for (int o = 0; o < 32 && pn0 + o < a.boc; ++o) {
          const size_t off =
              ((static_cast<size_t>(n) * a.OC + oc0 + pn0 + o) * a.H + y) *
                  a.W + x;
          float v = epi[o * kEpiStride + lane];
          if (a.accumulate)
            v += __bfloat162float(__ushort_as_bfloat16(out[off]));
          out[off] = __bfloat16_as_ushort(__float2bfloat16(v));
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// Fills the tile layout of `a` from its shapes, blocks and `warps` (the
// wrapper's layout, kernels/_geometry.py conv_mma_tile) and returns the
// dynamic shared memory a block needs, `extra` bytes after the epilogue
// tiles included; -1 when the tile or the launch does not fit.
inline long long conv_mma_layout(ConvMmaArgs& a, int warps, int extra) {
  if (a.N < 1 || a.IC < 1 || a.OC < 1 || a.KH < 1 || a.KW < 1 ||
      a.H < 1 || a.W < 1 || a.boc < 1 || a.bic < 1 || a.by < 1 ||
      a.bx < 1 || a.OC % a.boc || a.IC % a.bic || a.H % a.by ||
      a.W % a.bx || warps < 1 || warps > kMaxWarps)
    return -1;
  a.trips[0] = a.OC / a.boc;
  a.trips[1] = a.H / a.by;
  a.trips[2] = a.W / a.bx;
  a.p16 = (a.by * a.bx + 15) / 16 * 16;
  a.boc16 = (a.boc + 15) / 16 * 16;
  a.bic_pad = (a.bic + 15) / 16 * 16;
  a.cstr = a.bic_pad + 8;
  a.wt_m = (a.p16 + 31) / 32;
  a.wt_n = (a.boc16 + 31) / 32;
  a.warps = warps;
  a.rounds = (a.wt_m * a.wt_n + warps - 1) / warps;
  a.halo_bytes = (a.by + a.KH - 1) * (a.bx + a.KW - 1) * a.cstr * 2;
  a.stage_bytes = a.halo_bytes + a.KH * a.KW * a.boc16 * a.cstr * 2;
  const long long smem = 2LL * a.stage_bytes +
                         static_cast<long long>(warps) * kEpiBytes + extra;
  const long long blocks = static_cast<long long>(a.N) * a.trips[0] *
                           a.trips[1] * a.trips[2];
  if (smem > 232448 || blocks > 2147483647LL || warps > a.wt_m * a.wt_n)
    return -1;
  return smem;
}

template <bool Sparse>
cudaError_t conv_mma_launch(const ConvMmaArgs& a, long long smem,
                            cudaStream_t stream) {
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(conv_mma_kernel<Sparse>), 232448);
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(a.N) * a.trips[0] *
                           a.trips[1] * a.trips[2];
  conv_mma_kernel<Sparse><<<static_cast<unsigned>(blocks), 32 * a.warps,
                            static_cast<int>(smem), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace cm
}  // namespace
}  // namespace rt
