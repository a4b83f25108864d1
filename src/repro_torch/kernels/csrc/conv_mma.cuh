// The bf16 implicit GEMM on the tensor cores, shared by the dense conv
// (conv2d.cu) and the block-sparse conv (sparse_conv.cu).
//
//   out[n, oc, y, x] = sum_{ic, ky, kx} wgt[oc, ic, ky, kx]
//                                       * img[n, ic, y + ky, x + kx]
// img [N, IC, H + KH - 1, W + KW - 1] (pre-padded), wgt [OC, IC, KH, KW],
// out [N, OC, H, W], all bf16.
//
// conv_mma_kernel<Sparse, MT>: the output tiles (n, oc block, y block, x
//   block) are linearised in the schedule's order (batch outermost, the
//   last axis fastest), and a block walks `walk` consecutive tiles of
//   one group: the tiles that share one operand (the fixed one) --
//   - the last output axis y or x: the group is the tiles after oc in
//     the order, which share the oc block's weights;
//   - the last output axis oc: the group is the oc blocks of one pixel
//     tile, which share its image halo.
//   Each tile is D[pixels, oc] = sum over taps and channel blocks of
//   A_tap[pixels, ic] . B_tap[ic, oc] -- the JAX kernel's per-tap
//   [BOC, BIC] x [BIC, BY*BX] contraction -- with mma.sync.m16n8k16
//   (bf16 in, f32 accumulate), summed over every channel block of the
//   launch and rounded once.  The channel blocks are the dense range
//   [ic_begin, ic_begin + ic_count) in blocks of bic, or (Sparse) the
//   oc block's nonzero list idx[o, :counts[o]], which the block loads
//   into shared memory before its first stage (the Pallas kernel's
//   scalar prefetch); an oc block with count 0 writes zeros.
//   - Loads: every operand arrives by cp.async, 16 bytes at a time, on
//     the aligned cover of its contiguous runs: a channel's halo rows
//     (one run when the tile spans the image width, else a run a row),
//     and an oc row's weights of the channel block (bic KH KW elements).
//     Neither needs 16-byte aligned rows (TMA would: the thesis' rows are
//     60, 114, 110, 54, 26, 30 and 54 bytes), and a cover never crosses
//     a page, so the bytes it reads past a run are harmless and unused.
//   - Ring: the raw runs land in a ring of `stages` (2 or 3) slots, one
//     cp.async group a step, so the next stages - 1 steps' loads are in
//     flight while a step multiplies.  A step: wait for step s + 1's
//     loads, one __syncthreads, issue step s + stages's loads, transpose
//     step s + 1 into its operand slots, multiply step s.
//   - Channels-last pass: the raw runs are rewritten in shared memory as
//     the halo [by+KH-1][bx+KW-1][bic_pad + 8] and the weights [taps]
//     [boc_pad][bic_pad + 8], ic contiguous, eight channels of a pixel or
//     an oc row packed into one 16-byte store (lanes along the pixels,
//     resp. the oc rows; a weight run's slot is an odd number of 16-byte
//     units, so those reads spread over the banks), so both operands'
//     fragments load by ldmatrix without .trans.  Rows are 16-byte
//     aligned and their stride is an odd number of 16-byte units (no
//     bank conflicts across ldmatrix's eight rows).  Every tap reads the
//     same halo at a shift: lane l gives ldmatrix the address of its
//     pixel's row plus the tap's offset ky (bx+KW-1) + kx, so any tap and
//     any tile shape work without a copy per tap.
//   - Residency: when a block walks more than one tile, the fixed
//     operand of every channel block is loaded and transposed once, in
//     the walk's first steps (through the same ring), and stays in its
//     own slots for the whole walk; only the other operand streams, two
//     transposed slots deep.  A walk of one tile streams both.  Where two
//     slots of each streamed operand do not fit (kernels of up to 11 x 11
//     taps, large pixel tiles), they take one, and step s + 1 is
//     transposed after step s's MMAs and a second barrier (`late`).
//   - Padding: pixels pad to 16 (the MMA's M), oc to 16 (ldmatrix.x4
//     loads two n8 fragments), ic to 16 (its K); the pass writes zeros
//     past bic within a unit of eight channels, the units past those and
//     the padded oc rows are zeroed once a block; padded pixels read
//     pixel 0 and are never stored, so every block that divides its
//     dimension is taken.
//   - Warps: each warp owns a 32-pixel x 32-channel tile (2 x 4 MMAs,
//     32 f32 accumulators a thread), or a 48-pixel one (3 x 4) where that
//     takes fewer rounds (the body's template argument MT, 2 or 3 m16
//     tiles); a block has up to 16 warps, and a larger output tile is
//     covered in rounds, each re-streaming the channel blocks.  A block
//     has at least 8 warps: those past its warp tiles only load and
//     write the pass, which small tiles would otherwise leave to a few
//     warps.
//   - Epilogue: each warp passes its accumulators through its own f32
//     staging tile, 8 channels at a time, so that lanes run along the
//     pixels: lane l stores pixels 2 (l % 16), + 1 of channel l / 16 (of
//     a pair), one 4-byte bf16 pair along x where both share a row and
//     the address is aligned (two 2-byte stores otherwise), and a store
//     instruction writes two channels' 32 neighbouring pixels.  Where the
//     staging does not fit beside the rest (large kernels near 227 KB),
//     lanes g and g ^ 1 of a fragment swap one value and store the pairs
//     straight from it, lanes across 8 channels, which spreads a store's
//     bytes over 8 rows (the slower epilogue where the output is large).
//     A read-modify-write pass reads the output the same way, adds in
//     f32 and rounds once.
//   Why mma.sync and not wgmma: wgmma's A operand from shared memory must
//   sit in its canonical (swizzled, 8-row-core-matrix) layout, which a
//   tap's shifted pixel rows do not; from registers it would take the
//   same ldmatrix loads.  wgmma would add its asynchronous issue (MMAs
//   overlapping the next tap's fragment loads) and a 64 x N tile per
//   instruction, halving the shared-memory reads per FLOP of the
//   weights; the 32 x 32 warp tile here reads 16 bytes of shared memory
//   per 16 FLOP, which bounds it near half the bf16 peak.
//   CM_T_BEGIN / CM_T_MARK(k) / CM_T_END mark the body's phases for
//   launch/conv_timeline.py (which defines them and builds a scratch
//   copy); here they compile to nothing.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

#ifndef CONV_MMA_TIMELINE
#define CM_T_BEGIN()
#define CM_T_MARK(k)
#define CM_T_END()
#endif

namespace rt {
// Internal linkage: conv2d.cu and sparse_conv.cu each get their own
// instances, so the two objects never register the same kernel symbol.
namespace {
namespace cm {

using bf16 = __nv_bfloat16;
constexpr int kMaxWarps = 16;
// the epilogue's staging: a warp's f32 values of 8 channels x its 16 MT
// pixels, rows 16 MT + 4 floats apart (the fragment writes hit 32 banks)
__host__ __device__ constexpr int epi_stride(int mt) { return 16 * mt + 4; }
__host__ __device__ constexpr int epi_bytes(int mt) {
  return 8 * epi_stride(mt) * 4;
}

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
  // ---- the layout (conv_mma_layout; kernels/_geometry.py conv_mma_tile)
  int warps, wt_m, wt_n, rounds;
  int mt;                          // m16 tiles a warp (2 or 3)
  int epi_staged;                  // 1: the epilogue's staging fits
  int p16, boc16, bic_pad, cstr;   // padded pixels, oc, ic; row stride
  int hh, ww, taps, noct;          // halo rows, columns; taps; 8-ch units
  int walk, stages;                // tiles a block walks; ring slots
  int late;                        // 1: streamed operands take one slot,
                                   //    transposed after the step's MMAs
  int fixed_halo;                  // 1: the halo is the fixed operand
  int resident;                    // 1: the fixed operand stays (walk > 1)
  int group, per_group;            // tiles a group; blocks a group
  int g_from;                      // the group's axes: order[g_from..2]
  int h_row_runs;                  // 1: a halo run a channel row
  int h_len, h_slot;               // a halo run: elements, 16-byte units
  int w_len, w_slot;               // an oc row's run: elements, units
  int raw_w_off, raw_bytes;        // one ring slot: halo, then weights
  int th_bytes, tw_bytes;          // one transposed halo / weight slot
  int h_slots, w_slots;            // transposed slots of each operand
  int off_tw, off_raw, off_epi;    // shared-memory offsets (halo at 0)
  int off_idx;
  long long blocks;
};

struct Tile {
  int n, ob, oc0, y0, x0;      // ob: the oc block
};

// The tile at linear index `lin` (batch outermost, then the output axes
// in the schedule's order, the last fastest): once a block.
__device__ __forceinline__ Tile tile_of(const ConvMmaArgs& a, long long lin) {
  int t[3];
#pragma unroll
  for (int i = 2; i >= 0; --i) {
    const int ax = a.order[i];
    t[ax] = static_cast<int>(lin % a.trips[ax]);
    lin /= a.trips[ax];
  }
  return {static_cast<int>(lin), t[0], t[0] * a.boc, t[1] * a.by,
          t[2] * a.bx};
}

// Tile `gi` of the group whose first tile is `base`: the group's axes
// (order[g_from..2]) decoded from gi, the others base's.
__device__ __forceinline__ Tile tile_in_group(const ConvMmaArgs& a,
                                              const Tile& base, int gi) {
  Tile t = base;
  for (int i = 2; i >= a.g_from; --i) {
    const int ax = a.order[i], n = a.trips[ax];
    const int v = gi % n;
    gi /= n;
    if (ax == 0) { t.ob = v; t.oc0 = v * a.boc; }
    else if (ax == 1) t.y0 = v * a.by;
    else t.x0 = v * a.bx;
  }
  return t;
}

__device__ __forceinline__ const unsigned short* halo_src(
    const ConvMmaArgs& a, const Tile& t, int ic0) {
  return reinterpret_cast<const unsigned short*>(a.img) +
         ((static_cast<size_t>(t.n) * a.IC + ic0) * a.H2 + t.y0) * a.W2 +
         t.x0;
}

__device__ __forceinline__ const unsigned short* wgt_src(
    const ConvMmaArgs& a, const Tile& t, int ic0) {
  return reinterpret_cast<const unsigned short*>(a.wgt) +
         (static_cast<size_t>(t.oc0) * a.IC + ic0) * a.taps;
}

// A thread's walk over the units u = tid, tid + T, ... of a three-digit
// index (x fastest, then y, then z; extents nx, ny): each step adds T's
// digits with carries, so no unit pays a division.
struct Walk {
  int x, y, z;                 // the unit's digits
  int dx, dy, dz;              // T's digits
};

__device__ __forceinline__ Walk walk_from(int tid, int nthr, int nx, int ny) {
  return {tid % nx, (tid / nx) % ny, tid / (nx * ny),
          nthr % nx, (nthr / nx) % ny, nthr / (nx * ny)};
}

__device__ __forceinline__ void advance(Walk& w, int nx, int ny) {
  w.x += w.dx; w.y += w.dy; w.z += w.dz;
  if (w.x >= nx) { w.x -= nx; ++w.y; }
  if (w.y >= ny) { w.y -= ny; ++w.z; }
}

// cp.async of the runs of one operand: run (y, z) starts y ystride +
// z zstride elements past `src` and lands at dst + 16 slot (y + z ny);
// unit x of each run's 16-byte aligned cover (units past the cover copy
// nothing).  The run's element offset is carried with the walk, so a
// unit costs a few integer instructions and one cp.async.
__device__ __forceinline__ void load_runs(const unsigned short* src,
                                          uint32_t dst, int len, int slot,
                                          int ny, int nz, int ystride,
                                          int zstride, int tid, int nthr) {
  Walk w = walk_from(tid, nthr, slot, ny);
  int off = w.y * ystride + w.z * zstride;
  const int doff = w.dy * ystride + w.dz * zstride;
  while (w.z < nz) {
    const uintptr_t s = reinterpret_cast<uintptr_t>(src + off);
    const int cover = static_cast<int>(((s + 2 * len + 15) >> 4) - (s >> 4));
    if (w.x < cover)
      hw::cp_async_16(dst + 16 * ((w.y + w.z * ny) * slot + w.x),
                      reinterpret_cast<const void*>((s & ~uintptr_t(15)) +
                                                    16 * w.x), 16);
    w.x += w.dx; w.y += w.dy; w.z += w.dz;
    off += doff;
    if (w.x >= slot) { w.x -= slot; ++w.y; off += ystride; }
    if (w.y >= ny) { w.y -= ny; ++w.z; off += zstride - ny * ystride; }
  }
}

// The halo of one channel block: run (row y, channel z) when a run is a
// row, else run (channel y).
__device__ __forceinline__ void load_halo(const ConvMmaArgs& a,
                                          const unsigned short* src,
                                          uint32_t dst, int tid, int nthr) {
  const int plane = a.H2 * a.W2;
  if (a.h_row_runs)
    load_runs(src, dst, a.h_len, a.h_slot, a.hh, a.bic, a.W2, plane, tid,
              nthr);
  else
    load_runs(src, dst, a.h_len, a.h_slot, a.bic, 1, plane, 0, tid, nthr);
}

// The weights of one channel block: run o is oc row o's bic KH KW
// elements.
__device__ __forceinline__ void load_wgt(const ConvMmaArgs& a,
                                         const unsigned short* src,
                                         uint32_t dst, int tid, int nthr) {
  load_runs(src, dst, a.w_len, a.w_slot, a.boc, 1, a.IC * a.taps, 0, tid,
            nthr);
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return lo | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void store_unit(unsigned char* dst,
                                           const unsigned short* v) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}

// Raw halo runs (landed from `src`) -> the channels-last halo at `dst`:
// unit (column x, row y, eight channels z), lanes along the pixels.
// Channel c's run (of row r) starts in the slot at c run_c (+ r h_slot 8
// for row runs) and its first element sits at the run's phase, (src +
// the run's start) mod 16 bytes, which repeats every 8 channels: a
// unit's eight loads sit at eight offsets fixed a call (a row run's
// phase also moves with its row), and none sits behind a branch, so
// their latencies overlap.
__device__ __forceinline__ void transpose_halo(const ConvMmaArgs& a,
                                               const unsigned short* src,
                                               const unsigned short* raw,
                                               unsigned char* dst, int tid,
                                               int nthr) {
  const int p0 = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 1) &
                                  7);
  const int plane = a.H2 * a.W2;
  const int run_c = (a.h_row_runs ? a.hh : 1) * a.h_slot * 8;
  const int last = a.bic - 8 * (a.noct - 1);  // channels of the last unit
  int off[8];
  if (!a.h_row_runs) {
    // the phase of channel 8 oct + i does not depend on the pixel
#pragma unroll
    for (int i = 0; i < 8; ++i) off[i] = i * run_c + ((p0 + i * plane) & 7);
    for (Walk w = walk_from(tid, nthr, a.ww, a.hh); w.z < a.noct;
         advance(w, a.ww, a.hh)) {
      const int q = w.y * a.ww + w.x, oct = w.z;
      const unsigned short* base = raw + 8 * oct * run_c + w.y * a.W2 + w.x;
      const int valid = oct + 1 < a.noct ? 8 : last;
      unsigned short v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // past the block's channels, load channel 8 oct's and drop it
        const unsigned short x = base[i < valid ? off[i] : off[0]];
        v[i] = i < valid ? x : static_cast<unsigned short>(0);
      }
      store_unit(dst + (q * a.cstr + 8 * oct) * 2, v);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) off[i] = p0 + i * plane;   // before mod 8
  for (Walk w = walk_from(tid, nthr, a.ww, a.hh); w.z < a.noct;
       advance(w, a.ww, a.hh)) {
    const int r = w.y, col = w.x, oct = w.z;
    const int rw = r * a.W2;                          // run start, row part
    const unsigned short* base =
        raw + 8 * oct * run_c + r * a.h_slot * 8 + col;
    const int valid = oct + 1 < a.noct ? 8 : last;
    unsigned short v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = i < valid ? i : 0;
      const unsigned short x =
          base[k * run_c + (((i < valid ? off[i] : off[0]) + rw) & 7)];
      v[i] = i < valid ? x : static_cast<unsigned short>(0);
    }
    store_unit(dst + ((r * a.ww + col) * a.cstr + 8 * oct) * 2, v);
  }
}

// Raw weight runs -> [taps][boc16][cstr]: unit (oc row x, tap y, eight
// channels z), lanes along the oc rows; the eight loads of a unit sit at
// offsets fixed a call.
__device__ __forceinline__ void transpose_wgt(const ConvMmaArgs& a,
                                              const unsigned short* src,
                                              const unsigned short* raw,
                                              unsigned char* dst, int tid,
                                              int nthr) {
  const int p0 = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 1) &
                                  7);
  const int row = a.IC * a.taps, taps = a.taps;
  const int last = a.bic - 8 * (a.noct - 1);
  int off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) off[i] = i * taps;
  for (Walk w = walk_from(tid, nthr, a.boc, taps); w.z < a.noct;
       advance(w, a.boc, taps)) {
    const int o = w.x, t = w.y, oct = w.z;
    const unsigned short* run = raw + o * a.w_slot * 8 +
                                ((p0 + o * row) & 7) + 8 * oct * taps + t;
    const int valid = oct + 1 < a.noct ? 8 : last;
    unsigned short v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned short x = run[i < valid ? off[i] : 0];
      v[i] = i < valid ? x : static_cast<unsigned short>(0);
    }
    store_unit(dst + ((t * a.boc16 + o) * a.cstr + 8 * oct) * 2, v);
  }
}

// One output value pair (pixels p, p + 1 of the tile at (py, px) and
// after it, one channel) to `out`: a 4-byte store where both share a row
// and the address is aligned, else one 2-byte store each; `accumulate`
// adds the output's value in f32 first.
__device__ __forceinline__ void store_pair(const ConvMmaArgs& a, const Tile& t,
                                           int oc, int p, int py, int px,
                                           float v0, float v1) {
  const int pixels = a.by * a.bx;
  if (p >= pixels) return;
  unsigned short* o = reinterpret_cast<unsigned short*>(a.out) +
      ((static_cast<size_t>(t.n) * a.OC + t.oc0 + oc) * a.H + t.y0 + py) *
          a.W + t.x0 + px;
  if (p + 1 < pixels && px + 1 < a.bx &&
      (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    if (a.accumulate) {
      const float2 old = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o));
      v0 += old.x;
      v1 += old.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (a.accumulate) v0 += __bfloat162float(__ushort_as_bfloat16(o[0]));
  o[0] = __bfloat16_as_ushort(__float2bfloat16(v0));
  if (p + 1 >= pixels) return;
  if (px + 1 >= a.bx)                  // pixel p + 1 opens the next row
    o += a.W - a.bx + 1;
  else
    o += 1;
  if (a.accumulate) v1 += __bfloat162float(__ushort_as_bfloat16(o[0]));
  o[0] = __bfloat16_as_ushort(__float2bfloat16(v1));
}

template <bool Sparse, int MT>
__global__ void __launch_bounds__(32 * kMaxWarps)
conv_mma_kernel(const ConvMmaArgs a) {
  constexpr int kEpiStride = epi_stride(MT);
  extern __shared__ __align__(16) unsigned char smem[];
  CM_T_BEGIN()
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  // the block's walk: tiles g0 .. g0 + nt - 1 of its group
  const int grp = static_cast<int>(blockIdx.x / a.per_group);
  const int part = static_cast<int>(blockIdx.x % a.per_group);
  const Tile base = tile_of(a, static_cast<long long>(grp) * a.group);
  const int g0 = part * a.walk;             // the walk's first in the group
  const int nt = min(a.walk, a.group - g0);
  const Tile first = tile_in_group(a, base, g0);
  const int pixels = a.by * a.bx;

  // channel blocks each tile sums: the dense range, or the oc block's
  // nonzero count (every tile of a walk has the walk's oc block, or, with
  // the halo fixed, the dense range)
  const int nblocks = Sparse ? a.counts[first.ob] : a.ic_count / a.bic;
  int* idx_s = reinterpret_cast<int*>(smem + a.off_idx);
  if constexpr (Sparse) {
    if (nblocks == 0) {      // no nonzero block: the tiles are zero
      unsigned short* out = reinterpret_cast<unsigned short*>(a.out);
      // unit (column x, row y of oc row r = y / by, tile z)
      const int rows = a.boc * a.by;
      for (Walk w = walk_from(tid, nthr, a.bx, rows); w.z < nt;
           advance(w, a.bx, rows)) {
        const Tile t = tile_in_group(a, base, g0 + w.z);
        const int o = w.y / a.by, py = w.y - o * a.by;
        out[((static_cast<size_t>(t.n) * a.OC + t.oc0 + o) * a.H + t.y0 +
             py) * a.W + t.x0 + w.x] = 0;
      }
      return;
    }
    for (int j = tid; j < nblocks; j += nthr)
      idx_s[j] = a.idx[first.ob * a.max_nnz + j];
  }
  // zero, once, what the pass never writes: the unit of channels
  // 8 noct .. bic_pad - 1 of every row, and the padded oc rows
  {
    const uint4 z = make_uint4(0, 0, 0, 0);
    const int hrows = a.h_slots * a.hh * a.ww;
    const int wrows = a.w_slots * a.taps * a.boc16;
    if (8 * a.noct < a.bic_pad) {
      for (int i = tid; i < hrows; i += nthr)
        *reinterpret_cast<uint4*>(smem + (i * a.cstr + 8 * a.noct) * 2) = z;
      for (int i = tid; i < wrows; i += nthr)
        *reinterpret_cast<uint4*>(smem + a.off_tw +
                                  (i * a.cstr + 8 * a.noct) * 2) = z;
    }
    const int pad_oc = a.boc16 - a.boc, per = a.bic_pad / 8;
    for (int i = tid; i < a.w_slots * a.taps * pad_oc * per; i += nthr) {
      const int k = i % per, r = i / per;
      const int row = (r / pad_oc) * a.boc16 + a.boc + r % pad_oc;
      *reinterpret_cast<uint4*>(smem + a.off_tw +
                                (row * a.cstr + 8 * k) * 2) = z;
    }
  }
  __syncthreads();

  auto ic_of = [&](int b) {
    if constexpr (Sparse) return idx_s[b] * a.bic;
    else return a.ic_begin + b * a.bic;
  };
  // steps: with a resident operand, its nblocks loads first (no MMA),
  // then nt x rounds x nblocks multiply steps
  const int pre = a.resident ? nblocks : 0;
  const int per_tile = a.rounds * nblocks;
  const int steps = pre + nt * per_tile;
  const uint32_t raw0 = hw::smem_u32(smem + a.off_raw);

  // the operands step s loads and where they go
  struct Step {
    Tile t;
    int b, c;            // channel block; multiply index (-1: none)
    bool halo, wgt;      // operands loaded this step
  };
  auto step_of = [&](int s) {
    Step st;
    if (s < pre) {
      st.t = first; st.b = s; st.c = -1;
      st.halo = a.fixed_halo; st.wgt = !a.fixed_halo;
    } else {
      st.c = s - pre;
      st.t = tile_in_group(a, base, g0 + st.c / per_tile);
      st.b = st.c % nblocks;
      st.halo = !(a.resident && a.fixed_halo);
      st.wgt = !(a.resident && !a.fixed_halo);
    }
    return st;
  };
  // step s's loads into ring slot s % stages, one cp.async group
  auto issue = [&](int s) {
    const Step st = step_of(s);
    const int ic0 = ic_of(st.b);
    const uint32_t dst = raw0 + (s % a.stages) * a.raw_bytes;
    if (st.halo) load_halo(a, halo_src(a, st.t, ic0), dst, tid, nthr);
    if (st.wgt)
      load_wgt(a, wgt_src(a, st.t, ic0), dst + a.raw_w_off, tid, nthr);
  };
  // the transposed slots step s writes and its multiply reads
  auto h_slot_of = [&](const Step& st) {
    return a.resident && a.fixed_halo ? st.b : a.late ? 0 : st.c & 1;
  };
  auto w_slot_of = [&](const Step& st) {
    return a.resident && !a.fixed_halo ? st.b : a.late ? 0 : st.c & 1;
  };
  // step s's operands into their slots
  auto transpose = [&](int s) {
    const Step st = step_of(s);
    const int ic0 = ic_of(st.b);
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(
        smem + a.off_raw + (s % a.stages) * a.raw_bytes);
    if (st.halo)
      transpose_halo(a, halo_src(a, st.t, ic0), raw,
                     smem + h_slot_of(st) * a.th_bytes, tid, nthr);
    if (st.wgt)
      transpose_wgt(a, wgt_src(a, st.t, ic0), raw + a.raw_w_off / 2,
                    smem + a.off_tw + w_slot_of(st) * a.tw_bytes, tid, nthr);
  };

  // prologue: the first `stages` steps' loads, one group each
  for (int s = 0; s < a.stages; ++s) {
    if (s < steps) issue(s);
    hw::cp_async_commit();
  }
  if (a.stages == 3) hw::cp_async_wait<2>(); else hw::cp_async_wait<1>();
  __syncthreads();
  transpose(0);

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int ww = a.ww;
  CM_T_MARK(0)

  for (int s = 0; s < steps; ++s) {
    // step s + 1's loads landed (this thread's, then everyone's); after
    // the barrier step s's transposed operands are complete and step
    // s - 1's MMAs are done, so step s's ring slot is free
    if (a.stages == 3) hw::cp_async_wait<1>(); else hw::cp_async_wait<0>();
    __syncthreads();
    CM_T_MARK(1)
    if (s + a.stages < steps) issue(s + a.stages);
    hw::cp_async_commit();
    CM_T_MARK(2)
    // single slots are still read by this step's MMAs: step s + 1 writes
    // them after those
    const bool mma_now = s >= pre;
    if (s + 1 < steps && !(a.late && mma_now)) transpose(s + 1);
    CM_T_MARK(3)
    if (!mma_now) continue;

    // ---- this warp's MMAs on step s's operands
    const Step st = step_of(s);
    const int rd = (st.c / nblocks) % a.rounds;
    const int wt = rd * a.warps + warp;
    const bool has_tile = wt < a.wt_m * a.wt_n;
    const int pm0 = (wt % a.wt_m) * 16 * MT, pn0 = (wt / a.wt_m) * 32;
    if (has_tile) {
      const uint32_t halo = hw::smem_u32(smem + h_slot_of(st) * a.th_bytes);
      const uint32_t wts =
          hw::smem_u32(smem + a.off_tw + w_slot_of(st) * a.tw_bytes);
      bool m_on[MT], n_on[2];
      uint32_t a_row[MT], b_row[2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
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
      // the k steps (tap, 16 channels) in order, the fragments of step
      // j + 1 loaded while step j multiplies (two fragment sets)
      const uint32_t tap_rows = a.boc16 * a.cstr * 2;   // bytes a tap
      const int kc_end = a.bic_pad * 2, row_skip = (ww - a.KW) * a.cstr * 2;
      const int steps_k = a.taps * (a.bic_pad / 16);
      uint32_t a_off = 0, b_off = 0;    // the next k step's byte offsets
      int kc = 0, kx = 0;
      auto next_k = [&]() {
        kc += 32;
        if (kc == kc_end) {
          kc = 0;
          a_off += a.cstr * 2 - kc_end + 32;
          b_off += tap_rows - kc_end + 32;
          if (++kx == a.KW) { kx = 0; a_off += row_skip; }
        } else {
          a_off += 32;
          b_off += 32;
        }
      };
      uint32_t fa0[MT][4], fb0[2][4], fa1[MT][4], fb1[2][4];
      auto load = [&](uint32_t (&fa)[MT][4], uint32_t (&fb)[2][4]) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (m_on[mt]) hw::ldmatrix_x4(fa[mt], a_row[mt] + a_off);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          if (n_on[np]) hw::ldmatrix_x4(fb[np], b_row[np] + b_off);
        next_k();
      };
      auto mma = [&](const uint32_t (&fa)[MT][4],
                     const uint32_t (&fb)[2][4]) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nb = 0; nb < 4; ++nb)
            if (m_on[mt] && n_on[nb / 2])
              hw::mma_16816(acc[mt][nb], fa[mt], fb[nb / 2][2 * (nb % 2)],
                            fb[nb / 2][2 * (nb % 2) + 1]);
      };
      load(fa0, fb0);
      for (int j = 0; j < steps_k; j += 2) {
        if (j + 1 < steps_k) load(fa1, fb1);
        mma(fa0, fb0);
        if (j + 1 < steps_k) {
          if (j + 2 < steps_k) load(fa0, fb0);
          mma(fa1, fb1);
        }
      }
    }
    CM_T_MARK(4)

    if (st.b == nblocks - 1 && has_tile && !a.epi_staged) {
      // no room for the staging: lanes g and g ^ 1 of an accumulator
      // fragment (pixels g, g + 8 of each m16, channels 2q, 2q + 1 of
      // each n8) swap one value, so each holds the pixel pair (g & ~1,
      // g | 1) of one channel (2q + (g & 1))
      const int g = lane >> 2, q = lane & 3, odd = g & 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pm0 + 16 * mt + 8 * h + (g & ~1);
          const int py = p / a.bx, px = p - py * a.bx;
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const float x0 = acc[mt][nb][2 * h], x1 = acc[mt][nb][2 * h + 1];
            const float got = __shfl_xor_sync(0xffffffffu, odd ? x0 : x1, 4);
            const int oc = pn0 + 8 * nb + 2 * q + odd;
            if (oc < a.boc)
              store_pair(a, st.t, oc, p, py, px, odd ? got : x0,
                         odd ? x1 : got);
          }
        }
    }
    if (st.b == nblocks - 1 && has_tile && a.epi_staged) {
      // accumulator fragment: lane (g, q) holds pixels g, g + 8 of each
      // m16 and channels 2q, 2q + 1 of each n8; through the staging tile
      // [8 channels][16 mt pixels], lane l then holds pixels pj, pj + 1
      // (pj = 2 (l % 16) + 32 r) of channel l / 16 + 2k, k = 0..3
      float* epi = reinterpret_cast<float*>(smem + a.off_epi) +
                   warp * (8 * kEpiStride);
      const int g = lane >> 2, q = lane & 3, half = lane >> 4;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (pn0 + 8 * nb < a.boc) {            // the same for every lane
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              epi[(2 * q + (e & 1)) * kEpiStride + 16 * mt + g +
                  8 * (e >> 1)] = acc[mt][nb][e];
          __syncwarp();
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int pj = 2 * (lane & 15) + 32 * r;
            if (pj < 16 * MT) {
              const int p = pm0 + pj;
              const int py = p / a.bx, px = p - py * a.bx;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int o = 2 * k + half, oc = pn0 + 8 * nb + o;
                const float2 v = *reinterpret_cast<const float2*>(
                    epi + o * kEpiStride + pj);
                if (oc < a.boc) store_pair(a, st.t, oc, p, py, px, v.x, v.y);
              }
            }
          }
          __syncwarp();
        }
      }
    }
    if (st.b == nblocks - 1 && has_tile) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
    CM_T_MARK(5)
    if (a.late && s + 1 < steps) {
      __syncthreads();
      transpose(s + 1);
      CM_T_MARK(3)
    }
  }
  CM_T_END()
}

// Fills the tile layout of `a` from its shapes, blocks, `warps`, `walk`,
// `stages`, `late` and `staged` (the wrapper's layout,
// kernels/_geometry.py conv_mma_tile, which must agree byte for byte)
// and returns the dynamic shared memory a block needs, `extra` bytes
// for the sparse index row included; -1
// when the tile or the launch does not fit.  The resident operand's
// slots are the sparse conv's max_nnz (> 0), or the dense conv's IC /
// bic, so every launch of a read-modify-write schedule (each sums one
// channel block) has the scratch launch's layout.
inline long long conv_mma_layout(ConvMmaArgs& a, int warps, int walk,
                                 int stages, int late, int staged,
                                 int extra) {
  if (a.N < 1 || a.IC < 1 || a.OC < 1 || a.KH < 1 || a.KW < 1 ||
      a.H < 1 || a.W < 1 || a.boc < 1 || a.bic < 1 || a.by < 1 ||
      a.bx < 1 || a.OC % a.boc || a.IC % a.bic || a.H % a.by ||
      a.W % a.bx || warps < 1 || warps > kMaxWarps || walk < 1 ||
      stages < 2 || stages > 3 || late < 0 || late > 1 || staged < 0 ||
      staged > 1)
    return -1;
  a.trips[0] = a.OC / a.boc;
  a.trips[1] = a.H / a.by;
  a.trips[2] = a.W / a.bx;
  a.p16 = (a.by * a.bx + 15) / 16 * 16;
  a.boc16 = (a.boc + 15) / 16 * 16;
  a.bic_pad = (a.bic + 15) / 16 * 16;
  a.cstr = a.bic_pad + 8;
  // a warp's tile: 2 m16 tiles (32 pixels), or 3 where that takes fewer
  // rounds of kMaxWarps warps
  a.wt_n = (a.boc16 + 31) / 32;
  const int r2 = ((a.p16 + 31) / 32 * a.wt_n + kMaxWarps - 1) / kMaxWarps;
  const int r3 = ((a.p16 + 47) / 48 * a.wt_n + kMaxWarps - 1) / kMaxWarps;
  a.mt = r3 < r2 ? 3 : 2;
  a.wt_m = (a.p16 + 16 * a.mt - 1) / (16 * a.mt);
  a.warps = warps;
  a.rounds = (a.wt_m * a.wt_n + warps - 1) / warps;
  a.hh = a.by + a.KH - 1;
  a.ww = a.bx + a.KW - 1;
  a.taps = a.KH * a.KW;
  a.noct = (a.bic + 7) / 8;
  // the group: the tiles after oc in the order (they share the weights),
  // or, with oc last, the oc blocks of a pixel tile (they share the halo)
  a.fixed_halo = a.order[2] == 0;
  a.group = 1;
  a.g_from = 3;
  if (a.fixed_halo) {
    a.group = a.trips[0];
    a.g_from = 2;
  } else {
    for (int i = 2; i >= 0 && a.order[i] != 0; --i) {
      a.group *= a.trips[a.order[i]];
      a.g_from = i;
    }
  }
  if (walk > a.group) return -1;
  a.walk = walk;
  a.stages = stages;
  a.late = late;
  a.resident = walk > 1;
  a.per_group = (a.group + walk - 1) / walk;
  const long long tiles = static_cast<long long>(a.N) * a.trips[0] *
                          a.trips[1] * a.trips[2];
  a.blocks = tiles / a.group * a.per_group;
  // raw runs: a channel's rows (the tile spans the width) or each row
  a.h_row_runs = a.ww != a.W2;
  const int h_runs = a.bic * (a.h_row_runs ? a.hh : 1);
  a.h_len = a.h_row_runs ? a.ww : a.hh * a.W2;
  a.h_slot = (a.h_len + 14) / 8;
  a.w_len = a.bic * a.taps;
  a.w_slot = ((a.w_len + 14) / 8) | 1;
  const int raw_h = h_runs * a.h_slot * 16;
  const int raw_w = a.boc * a.w_slot * 16;
  a.raw_w_off = a.resident ? 0 : raw_h;
  a.raw_bytes = a.resident ? (raw_h > raw_w ? raw_h : raw_w) : raw_h + raw_w;
  a.th_bytes = a.hh * a.ww * a.cstr * 2;
  a.tw_bytes = a.taps * a.boc16 * a.cstr * 2;
  const int fixed_slots = a.max_nnz > 0 ? a.max_nnz : a.IC / a.bic;
  a.h_slots = a.resident && a.fixed_halo ? fixed_slots : 2 - late;
  a.w_slots = a.resident && !a.fixed_halo ? fixed_slots : 2 - late;
  const long long off_tw = static_cast<long long>(a.h_slots) * a.th_bytes;
  const long long off_raw = off_tw + static_cast<long long>(a.w_slots) *
                                         a.tw_bytes;
  const long long off_epi = off_raw + static_cast<long long>(stages) *
                                          a.raw_bytes;
  // the epilogue's staging, or the fragments' own pairs
  a.epi_staged = staged;
  const long long off_idx =
      off_epi + (staged ? static_cast<long long>(warps) * epi_bytes(a.mt)
                        : 0);
  const long long smem = off_idx + extra;
  if (smem > 232448 || a.blocks > 2147483647LL)
    return -1;
  a.off_tw = static_cast<int>(off_tw);
  a.off_raw = static_cast<int>(off_raw);
  a.off_epi = static_cast<int>(off_epi);
  a.off_idx = static_cast<int>(off_idx);
  return smem;
}

template <bool Sparse, int MT>
cudaError_t conv_mma_launch_mt(const ConvMmaArgs& a, long long smem,
                               cudaStream_t stream) {
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(conv_mma_kernel<Sparse, MT>), 232448);
  if (attr != cudaSuccess) return attr;
  conv_mma_kernel<Sparse, MT><<<static_cast<unsigned>(a.blocks),
                                32 * a.warps, static_cast<int>(smem),
                                stream>>>(a);
  return cudaGetLastError();
}

// The body at the layout's warp tile (2 or 3 m16 tiles a warp).
template <bool Sparse>
cudaError_t conv_mma_launch(const ConvMmaArgs& a, long long smem,
                            cudaStream_t stream) {
  return a.mt == 3 ? conv_mma_launch_mt<Sparse, 3>(a, smem, stream)
                   : conv_mma_launch_mt<Sparse, 2>(a, smem, stream);
}

}  // namespace cm
}  // namespace
}  // namespace rt
