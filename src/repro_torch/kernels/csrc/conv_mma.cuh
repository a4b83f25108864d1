// The bf16 implicit GEMM on the tensor cores, shared by the dense conv
// (conv2d.cu) and the block-sparse conv (sparse_conv.cu).
//
//   out[n, oc, y, x] = sum_{ic, ky, kx} wgt[oc, ic, ky, kx]
//                                       * img[n, ic, y + ky, x + kx]
// img [N, IC, H + KH - 1, W + KW - 1] (pre-padded), wgt [OC, IC, KH, KW],
// out [N, OC, H, W], all bf16.
//
// conv_mma_kernel<Sparse, NT, MT>: the output tiles (n, oc block, y block,
//   x block) are linearised in the schedule's order (batch outermost, the
//   last axis fastest), and a block walks `walk` consecutive tiles of
//   one group: the tiles that share one operand (the fixed one) --
//   - the last output axis y or x: the group is the tiles after oc in
//     the order, which share the oc block's weights;
//   - the last output axis oc: the group is the oc blocks of one pixel
//     tile, which share its image halo.
//   Each tile is D[rows, oc] = sum over taps and channel blocks of
//   A_tap[rows, ic] . B_tap[ic, oc] -- the JAX kernel's per-tap
//   [BOC, BIC] x [BIC, BY*BX] contraction -- with wgmma.m64nNTk16 (bf16
//   in, f32 accumulate), both operands read from shared memory through
//   descriptors, and rounded once.  The channel blocks are the dense
//   range [ic_begin, ic_begin + ic_count) in blocks of bic, or (Sparse)
//   the oc block's nonzero list idx[o, :counts[o]], which the block loads
//   into shared memory before its first stage (the Pallas kernel's
//   scalar prefetch); an oc block with count 0 writes zeros.
//   - Rows: the M rows are the halo's pixels, row r = py ww + px of the
//     halo (ww = bx + KW - 1 columns), for r < (by - 1) ww + bx.  A row
//     with px >= bx is a junk row: it is computed and never stored.  In
//     return every tap reads the same halo at a constant shift, ky ww +
//     kx rows, so the tap's A operand is the halo itself, a descriptor
//     that starts that many 16-byte rows later.  A 1 x 1 kernel has no
//     junk row; a k x k kernel (KW - 1) / ww of them.
//   - Layouts: the halo is [ic / 8][hh ww rows][8 channels] and the
//     weights [taps][ic / 8][boc_pad][8]: wgmma's K-major canonical
//     layout without swizzle, whose 8 x 16-byte core matrices are 8
//     consecutive rows (SBO 128 bytes) and whose next 8 channels lie one
//     plane further (LBO = the plane).  A descriptor may start at any
//     16-byte row, which is what makes the tap's shift free.  Rows past
//     a plane's end (the last M tile's junk rows at a shift) read the
//     next plane or the slot's tail: junk in, junk out.
//   - Loads: every operand arrives by cp.async, 16 bytes at a time, on
//     the aligned cover of its contiguous runs: a channel's halo rows
//     (one run when the tile spans the image width, else a run a row),
//     and an oc row's weights of the channel block (bic KH KW elements).
//     Neither needs 16-byte aligned rows (TMA would: the thesis' rows are
//     60, 114, 110, 54, 26, 30 and 54 bytes, and every 1 x 1 layer has an
//     odd pixel count), and a cover never crosses a page, so the bytes it
//     reads past a run are harmless and unused.
//   - Ring: the raw runs land in a ring of `stages` (2 or 3) slots, one
//     cp.async group a step, so the next stages - 1 steps' loads are in
//     flight while a step multiplies.  A step: wait for step s + 1's
//     loads, one __syncthreads, issue step s + stages's loads, issue step
//     s's wgmmas (asynchronous), transpose step s + 1 into its operand
//     slots while the tensor cores run, then wait for the wgmmas.
//   - Channels-last pass: the raw runs are rewritten in shared memory
//     into those layouts, eight channels of a pixel or an oc row packed
//     into one 16-byte store, lanes along the pixels (resp. the oc rows),
//     so a store instruction writes 512 consecutive bytes.
//   - Residency: when a block walks more than one tile, the fixed
//     operand of every channel block is loaded and transposed once, in
//     the walk's first steps (through the same ring), and stays in its
//     own slots for the whole walk; only the other operand streams, two
//     transposed slots deep.  A walk of one tile streams both.  Where two
//     slots of each streamed operand do not fit (kernels of up to 11 x 11
//     taps, large pixel tiles), they take one, and step s + 1 is
//     transposed after step s's wgmmas completed and a second barrier
//     (`late`).
//   - Padding: M pads to 64 MT (a warpgroup tile's rows), oc to NT (the
//     wgmma's N, 16, 32 or 64: the one whose wgmmas read the fewest
//     bytes), ic to 16 (its K); the pass writes zeros past bic within a
//     unit of eight channels, and the planes past those are zeroed once a
//     block (both operands, so a padded channel adds 0 x 0).  Padded oc
//     rows of the weights are never written: they only feed output
//     columns that are not stored.
//   - Warpgroups: each owns MT 64-row x NT-channel tiles (MT NT / 2 f32
//     accumulators a thread; where tiles sum several channel blocks, MT
//     the fewest, up to 3, that cover the tile in one round); a block has
//     2 to 4 warpgroups and covers a larger output tile in rounds.  Where
//     a tile sums one channel block (a read-modify-write launch, or bic =
//     the launch's channels), a step runs every round on the operands it
//     holds; otherwise each round re-streams the channel blocks.
//     Warpgroups past the round's tiles multiply its last tile again and
//     store nothing.
//   - Long sums: no accumulator sums more than part_k k16 steps
//     (MMA_PART_K = 4096 terms, kernels/_geometry.py) before it joins an
//     f32 sum on the CUDA cores (each thread's own slots of a buffer in
//     shared memory, present where a launch can need it).  A part is
//     whole channel blocks (a block of more than part_k k16 steps, bic
//     KH KW > 4096, is refused), the most that fit, in the layout's
//     order, so two calls are bit-identical.  Table 4.1's sums (576
//     terms at most) are one part.
//   - Epilogue: each warp passes its sums through its own f32 staging
//     tile, 8 channels x its 16 rows at a time, so that lanes run along
//     the rows: lane l stores rows 2 (l % 8), + 1 of channels l / 8 and
//     l / 8 + 4, one 4-byte bf16 pair where both are stored neighbours
//     in memory and the address is aligned (two 2-byte stores
//     otherwise); each lane's output offsets are computed once a tile.
//     A read-modify-write pass reads the output the same way, adds in
//     f32 and rounds once.
//   Why wgmma and not mma.sync (this body's design before): a 32 x 32
//   mma.sync warp tile read its A and B fragments from shared memory by
//   ldmatrix, 16 bytes per 16 FLOP, and the warps issued every product
//   in turn with their pass.  Here a warpgroup's 64 x NT product reads 2
//   KB + NT x 32 bytes per k step (32 FLOP a byte at NT 64, the peak
//   rate in this layout; 2/3 of it at NT 32, 2/5 at NT 16) with no
//   instruction of the warps, and runs while they write the next step's
//   operands.  What bounds a block now is not its products: its steps'
//   loads, pass and epilogue stores run in turn.  ptxas serializes every
//   wgmma of the body if an instruction on a conditional path defines
//   their accumulators, hence the unconditional wait and scale_d.
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
constexpr int kRows = 64;            // a warpgroup's M rows
// terms an accumulator part sums at most: MMA_PART_K (kernels/
// _geometry.py), 16 channels a k16 step
constexpr int kMmaPartK = 4096;
// the epilogue's staging: a warp's f32 values of 8 channels x its 16
// rows, rows 16 + 4 floats apart (the fragment writes hit 32 banks);
// a warpgroup's four
constexpr int kEpiStride = 16 + 4;
constexpr int kEpiBytes = 4 * 8 * kEpiStride * 4;

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
  int warps, nt, mt;               // warps; wgmma N; 64-row tiles a
                                   // warpgroup tile holds
  int wg_m, wg_n, rounds;          // warpgroup tiles; rounds of them
  int rows;                        // M rows: (by - 1) ww + bx
  int boc_pad, bic_pad, nkc;       // padded oc, ic; 8-channel planes
  int hh, ww, taps, noct;          // halo rows, columns; taps; 8-ch units
  int hpl;                         // rows of a halo plane (hh ww)
  int part_k;                      // k16 steps an accumulator part sums
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
  int off_part, off_idx;           // the part buffer (0 bytes where no
                                   // launch of the layout has two parts)
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


// Raw halo runs (landed from `src`) -> the halo planes at `dst`: unit
// (column x, row y, eight channels z) is row y ww + x of plane z, lanes
// along the pixels.  Channel c's run (of row r) starts in the slot at c
// run_c (+ r h_slot 8 for row runs) and its first element sits at the
// run's phase, (src + the run's start) mod 16 bytes, which repeats every
// 8 channels: a unit's eight loads sit at eight offsets fixed a call (a
// row run's phase also moves with its row), and none sits behind a
// branch, so their latencies overlap.
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
      store_unit(dst + (oct * a.hpl + q) * 16, v);
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
    store_unit(dst + (oct * a.hpl + r * a.ww + col) * 16, v);
  }
}

// Raw weight runs -> [taps][nkc][boc_pad][8]: unit (oc row x, tap y,
// eight channels z), lanes along the oc rows; the eight loads of a unit
// sit at offsets fixed a call.
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
    store_unit(dst + ((t * a.nkc + oct) * a.boc_pad + o) * 16, v);
  }
}

// A lane's rows r, r + 1 of a warpgroup tile as element offsets in a
// channel's output plane from the tile's origin (-1: a junk row or past
// the tile, not stored), and whether the two are neighbours in memory
// (a row's pixels, or a full-width tile's row end and next row start).
// Computed once a tile; the channels then differ only by their plane.
struct RowPair {
  int o0, o1;
  bool adjacent;
};

__device__ __forceinline__ RowPair row_pair(const ConvMmaArgs& a, int r) {
  const int py = r / a.ww, px = r - py * a.ww;
  int py1 = py, px1 = px + 1;
  if (px1 == a.ww) { px1 = 0; ++py1; }
  RowPair p;
  p.o0 = py < a.by && px < a.bx ? py * a.W + px : -1;
  p.o1 = py1 < a.by && px1 < a.bx ? py1 * a.W + px1 : -1;
  p.adjacent = p.o0 >= 0 && p.o1 == p.o0 + 1;
  return p;
}

__device__ __forceinline__ void store_one(const ConvMmaArgs& a,
                                          unsigned short* o, float v) {
  if (a.accumulate) v += __bfloat162float(__ushort_as_bfloat16(o[0]));
  o[0] = __bfloat16_as_ushort(__float2bfloat16(v));
}

// The values of a lane's row pair in the output plane `plane`: a 4-byte
// store where the two are neighbours and the address is aligned, else a
// 2-byte store each (junk rows store nothing); `accumulate` adds the
// output's value in f32 first.
__device__ __forceinline__ void store_rows(const ConvMmaArgs& a,
                                           unsigned short* plane,
                                           const RowPair& p, float v0,
                                           float v1) {
  if (p.adjacent && (reinterpret_cast<uintptr_t>(plane + p.o0) & 3) == 0) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(plane + p.o0);
    if (a.accumulate) {
      const float2 old = __bfloat1622float2(*o);
      v0 += old.x;
      v1 += old.y;
    }
    *o = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (p.o0 >= 0) store_one(a, plane + p.o0, v0);
  if (p.o1 >= 0) store_one(a, plane + p.o1, v1);
}

template <bool Sparse, int NT, int MT>
__global__ void __launch_bounds__(32 * kMaxWarps)
conv_mma_kernel(const ConvMmaArgs a) {
  constexpr int kAcc = NT / 2;     // a 64-row tile's accumulators
  extern __shared__ __align__(128) unsigned char smem[];
  CM_T_BEGIN()
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wgs = a.warps / 4;
  // the block's walk: tiles g0 .. g0 + nt - 1 of its group
  const int grp = static_cast<int>(blockIdx.x / a.per_group);
  const int part = static_cast<int>(blockIdx.x % a.per_group);
  const Tile base = tile_of(a, static_cast<long long>(grp) * a.group);
  const int g0 = part * a.walk;             // the walk's first in the group
  const int nt = min(a.walk, a.group - g0);
  const Tile first = tile_in_group(a, base, g0);

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
  // zero, once, what the pass never writes: the plane of channels
  // 8 noct .. bic_pad - 1 of every slot, in both operands
  if (a.noct < a.nkc) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < a.h_slots * a.hpl; i += nthr) {
      const int sl = i / a.hpl, q = i - sl * a.hpl;
      *reinterpret_cast<uint4*>(smem + sl * a.th_bytes +
                                (a.noct * a.hpl + q) * 16) = z;
    }
    for (int i = tid; i < a.w_slots * a.taps * a.boc_pad; i += nthr) {
      const int o = i % a.boc_pad, r = i / a.boc_pad;   // r: slot, tap
      const int sl = r / a.taps, t = r - sl * a.taps;
      *reinterpret_cast<uint4*>(smem + a.off_tw + sl * a.tw_bytes +
                                ((t * a.nkc + a.noct) * a.boc_pad + o) *
                                    16) = z;
    }
  }
  __syncthreads();

  auto ic_of = [&](int b) {
    if constexpr (Sparse) return idx_s[b] * a.bic;
    else return a.ic_begin + b * a.bic;
  };
  // rounds a step runs: every round of the tile where it sums one
  // channel block (its operands then stream once a tile), else one
  const int rps = nblocks == 1 ? a.rounds : 1;
  // steps: with a resident operand, its nblocks loads first (no MMA),
  // then nt x rounds / rps x nblocks multiply steps
  const int pre = a.resident ? nblocks : 0;
  const int per_tile = a.rounds / rps * nblocks;
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
  // step s's operands into their slots, then visible to the wgmmas
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
    hw::fence_proxy_async();
  };

  // prologue: the first `stages` steps' loads, one group each
  for (int s = 0; s < a.stages; ++s) {
    if (s < steps) issue(s);
    hw::cp_async_commit();
  }
  if (a.stages == 3) hw::cp_async_wait<2>(); else hw::cp_async_wait<1>();
  __syncthreads();
  transpose(0);

  // acc[m]: the tensor cores' running part of the warpgroup tile's m-th
  // 64 rows.  Only wgmmas write acc (a part's first one with scale_d 0,
  // which drops acc's old values, so acc needs no initial value), and
  // every step waits for its wgmmas at one unconditional point: ptxas
  // keeps the wgmmas in flight only if no instruction on a conditional
  // path defines their accumulators.  A part that closes before a tile's
  // last channel block is added in f32 into the thread's own slots of
  // the part buffer ([MT kAcc][threads] floats); the epilogue adds the
  // last part to it.
  float acc[MT][kAcc];
  float* pbuf = reinterpret_cast<float*>(smem + a.off_part);
  int kdone = 0;                  // k16 steps in acc's part
  int scale = 0;                  // 0: the next wgmma opens a part
  bool parted = false;            // the part buffer holds earlier parts
  const int ksteps = a.taps * (a.nkc / 2);   // k16 steps a channel block
  CM_T_MARK(0)

  for (int s = 0; s < steps; ++s) {
    // step s + 1's loads landed (this thread's, then everyone's); after
    // the barrier step s's operands are complete and visible, step s's
    // ring slot is free, and step s - 1's operand slots (whose wgmmas
    // every warpgroup waited for) may be rewritten
    if (a.stages == 3) hw::cp_async_wait<1>(); else hw::cp_async_wait<0>();
    __syncthreads();
    CM_T_MARK(1)
    if (s + a.stages < steps) issue(s + a.stages);
    hw::cp_async_commit();
    CM_T_MARK(2)
    const bool mma_now = s >= pre;
    const Step st = step_of(s);
    // the step's first round
    const int rd0 = mma_now ? (st.c / nblocks) % (a.rounds / rps) * rps : 0;
    for (int r = 0; r < rps; ++r) {
      // this warpgroup's tile of the round; a warpgroup past the round's
      // tiles multiplies the last one again (its products are not
      // stored), so that no branch on the warpgroup surrounds a wgmma
      const int wt_all = (rd0 + r) * wgs + wg, tiles_wg = a.wg_m * a.wg_n;
      const bool has_tile = wt_all < tiles_wg;
      const int wt = has_tile ? wt_all : tiles_wg - 1;
      const int m0 = (wt % a.wg_m) * (kRows * MT), n0 = (wt / a.wg_m) * NT;
      if (mma_now) {
        // ---- this warpgroup's wgmmas on step s's operands, issued
        const uint32_t hb =
            hw::smem_u32(smem + h_slot_of(st) * a.th_bytes) + m0 * 16;
        const uint32_t wb = hw::smem_u32(smem + a.off_tw +
                                         w_slot_of(st) * a.tw_bytes) +
                            n0 * 16;
        hw::wgmma_fence();
        for (int t = 0, ky = 0, kx = 0; t < a.taps; ++t) {
          const uint32_t ha = hb + (ky * a.ww + kx) * 16;
          const uint32_t wa = wb + t * a.nkc * a.boc_pad * 16;
          for (int kc = 0; kc < a.nkc; kc += 2) {
            const uint64_t db =
                hw::make_desc(wa + kc * a.boc_pad * 16, a.boc_pad, 8, 0);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const uint64_t da = hw::make_desc(
                  ha + (m * kRows + kc * a.hpl) * 16, a.hpl, 8, 0);
              hw::WgmmaKMajor<NT>::run(acc[m], da, db, scale);
            }
            scale = 1;
          }
          if (++kx == a.KW) { kx = 0; ++ky; }
        }
        hw::wgmma_commit();
      }
      CM_T_MARK(4)
      // single slots are still read by this step's wgmmas: step s + 1
      // writes them after those
      if (r == rps - 1 && s + 1 < steps && !(a.late && mma_now)) {
        transpose(s + 1);
        CM_T_MARK(3)
      }
      hw::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MT; ++m) hw::fence_regs(acc[m], kAcc);
      CM_T_MARK(4)
      if (!mma_now) continue;

      // a part closes where the next channel block would take it past
      // part_k k16 steps, before the tile's last block
      kdone += ksteps;
      const bool last = st.b == nblocks - 1;
      if (!last && kdone + ksteps > a.part_k) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < kAcc; ++i) {
            float& p = pbuf[(m * kAcc + i) * nthr + tid];
            p = parted ? p + acc[m][i] : acc[m][i];
          }
        parted = true;
        kdone = 0;
        scale = 0;
      }
      if (last) {
        if (has_tile) {
          // accumulator fragment: lane (g, q) of warp w holds rows 16 (w
          // % 4) + g, + 8 of each 64 and channels 2q, 2q + 1 of each n8;
          // through the warp's staging tile [8 channels][16 rows], lane l
          // then holds rows 2 (l % 8), + 1 of the warp's 16 and channels
          // l / 8 and l / 8 + 4: a store instruction writes four
          // channels' 16 neighbouring rows, and no barrier but the
          // warp's is needed
          float* epi = reinterpret_cast<float*>(smem + a.off_epi) +
                       warp * (8 * kEpiStride);
          const int g = lane >> 2, q = lane & 3, wr = warp & 3;
          const int pr = lane & 7, ch0 = lane >> 3;
          const size_t plane = static_cast<size_t>(a.H) * a.W;
          unsigned short* tb = reinterpret_cast<unsigned short*>(a.out) +
              ((static_cast<size_t>(st.t.n) * a.OC + st.t.oc0 + n0) * a.H +
               st.t.y0) * a.W + st.t.x0;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const RowPair rows =
                row_pair(a, m0 + m * kRows + 16 * wr + 2 * pr);
#pragma unroll
            for (int j = 0; j < NT / 8; ++j) {
              if (n0 + 8 * j < a.boc) {        // the same for the warpgroup
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int i = 4 * j + e;
                  epi[(2 * q + (e & 1)) * kEpiStride + g + 8 * (e >> 1)] =
                      parted ? pbuf[(m * kAcc + i) * nthr + tid] + acc[m][i]
                             : acc[m][i];
                }
                __syncwarp();
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int ch = ch0 + 4 * h, oc = n0 + 8 * j + ch;
                  const float2 v = *reinterpret_cast<const float2*>(
                      epi + ch * kEpiStride + 2 * pr);
                  if (oc < a.boc)
                    store_rows(a, tb + (8 * j + ch) * plane, rows, v.x,
                               v.y);
                }
                __syncwarp();
              }
            }
          }
        }
        parted = false;
        kdone = 0;
        scale = 0;
      }
      CM_T_MARK(5)
    }
    if (a.late && mma_now && s + 1 < steps) {
      __syncthreads();
      transpose(s + 1);
      CM_T_MARK(3)
    }
  }
  CM_T_END()
}

// Fills the tile layout of `a` from its shapes, blocks, `warps`, `walk`,
// `stages` and `late` (the wrapper's layout, kernels/_geometry.py
// conv_mma_tile, which must agree byte for byte) and returns the dynamic
// shared memory a block needs, `extra` bytes for the sparse index row
// included; -1 when the tile or the launch does not fit.  The resident
// operand's slots are the sparse conv's max_nnz (> 0), or the dense
// conv's IC / bic, so every launch of a read-modify-write schedule (each
// sums one channel block) has the scratch launch's layout.
inline long long conv_mma_layout(ConvMmaArgs& a, int warps, int walk,
                                 int stages, int late, int extra) {
  if (a.N < 1 || a.IC < 1 || a.OC < 1 || a.KH < 1 || a.KW < 1 ||
      a.H < 1 || a.W < 1 || a.boc < 1 || a.bic < 1 || a.by < 1 ||
      a.bx < 1 || a.OC % a.boc || a.IC % a.bic || a.H % a.by ||
      a.W % a.bx || warps < 8 || warps > kMaxWarps || warps % 4 ||
      walk < 1 || stages < 2 || stages > 3 || late < 0 || late > 1)
    return -1;
  a.trips[0] = a.OC / a.boc;
  a.trips[1] = a.H / a.by;
  a.trips[2] = a.W / a.bx;
  a.hh = a.by + a.KH - 1;
  a.ww = a.bx + a.KW - 1;
  a.taps = a.KH * a.KW;
  a.noct = (a.bic + 7) / 8;
  a.bic_pad = (a.bic + 15) / 16 * 16;
  a.nkc = a.bic_pad / 8;
  a.hpl = a.hh * a.ww;
  a.part_k = kMmaPartK / 16;
  // an accumulator part is whole channel blocks
  if (a.taps * (a.nkc / 2) > a.part_k) return -1;
  // the wgmma's N: of 64, 32 and 16 the one whose wgmmas read the
  // fewest shared-memory bytes a k step, oc_pad (2048 / N + 32), the
  // widest among equals
  a.nt = 64;
  a.boc_pad = (a.boc + 63) / 64 * 64;
  for (int n = 32; n >= 16; n /= 2) {
    const int pad = (a.boc + n - 1) / n * n;
    if (pad * (2048 / n + 32) < a.boc_pad * (2048 / a.nt + 32)) {
      a.nt = n;
      a.boc_pad = pad;
    }
  }
  a.wg_n = a.boc_pad / a.nt;
  a.rows = (a.by - 1) * a.ww + a.bx;
  // 64-row tiles a warpgroup holds (its accumulators: mt nt / 2 floats,
  // at most 64): where the tiles sum more than one channel block, the
  // fewest that cover the tile in one round of kMaxWarps / 4 warpgroups,
  // else the most (each further round re-streams the blocks); one where
  // they sum one block (a step then runs every round)
  const int fixed_slots = a.max_nnz > 0 ? a.max_nnz : a.IC / a.bic;
  const int m_tiles = (a.rows + kRows - 1) / kRows;
  const int mt_max = fixed_slots == 1 ? 1 : a.nt == 64 ? 2 : 3;
  for (a.mt = 1; a.mt < mt_max; ++a.mt)
    if ((m_tiles + a.mt - 1) / a.mt * a.wg_n <= kMaxWarps / 4) break;
  a.wg_m = (m_tiles + a.mt - 1) / a.mt;
  a.warps = warps;
  a.rounds = (a.wg_m * a.wg_n + warps / 4 - 1) / (warps / 4);
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
  // a halo slot: its planes, and past the last one the rows that the
  // last M tile's junk rows read at the largest shift
  const int reach = a.wg_m * a.mt * kRows + (a.KH - 1) * a.ww + a.KW - 1;
  const int tail = reach > a.hpl ? reach - a.hpl : 0;
  a.th_bytes = (a.nkc * a.hpl + tail) * 16;
  a.tw_bytes = a.taps * a.nkc * a.boc_pad * 16;
  a.h_slots = a.resident && a.fixed_halo ? fixed_slots : 2 - late;
  a.w_slots = a.resident && !a.fixed_halo ? fixed_slots : 2 - late;
  const long long off_tw = static_cast<long long>(a.h_slots) * a.th_bytes;
  const long long off_raw = off_tw + static_cast<long long>(a.w_slots) *
                                         a.tw_bytes;
  const long long off_epi = off_raw + static_cast<long long>(stages) *
                                          a.raw_bytes;
  const long long off_part = off_epi + static_cast<long long>(warps / 4) *
                                           kEpiBytes;
  // the part buffer, where a launch can sum more than part_k k16 steps
  const bool parts = static_cast<long long>(fixed_slots) * a.taps *
                         (a.nkc / 2) > a.part_k;
  const long long off_idx =
      off_part + (parts ? 32LL * warps * a.mt * (a.nt / 2) * 4 : 0);
  const long long smem = off_idx + extra;
  if (smem > 232448 || a.blocks > 2147483647LL)
    return -1;
  a.off_tw = static_cast<int>(off_tw);
  a.off_raw = static_cast<int>(off_raw);
  a.off_epi = static_cast<int>(off_epi);
  a.off_part = static_cast<int>(off_part);
  a.off_idx = static_cast<int>(off_idx);
  return smem;
}

template <bool Sparse, int NT, int MT>
cudaError_t conv_mma_launch_t(const ConvMmaArgs& a, long long smem,
                              cudaStream_t stream) {
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(conv_mma_kernel<Sparse, NT, MT>),
      232448);
  if (attr != cudaSuccess) return attr;
  conv_mma_kernel<Sparse, NT, MT><<<static_cast<unsigned>(a.blocks),
                                    32 * a.warps, static_cast<int>(smem),
                                    stream>>>(a);
  return cudaGetLastError();
}

template <bool Sparse, int NT>
cudaError_t conv_mma_launch_nt(const ConvMmaArgs& a, long long smem,
                               cudaStream_t stream) {
  if constexpr (NT == 64)
    return a.mt == 2 ? conv_mma_launch_t<Sparse, NT, 2>(a, smem, stream)
                     : conv_mma_launch_t<Sparse, NT, 1>(a, smem, stream);
  else
    return a.mt == 3   ? conv_mma_launch_t<Sparse, NT, 3>(a, smem, stream)
           : a.mt == 2 ? conv_mma_launch_t<Sparse, NT, 2>(a, smem, stream)
                       : conv_mma_launch_t<Sparse, NT, 1>(a, smem, stream);
}

// The body at the layout's wgmma width (NT 16, 32 or 64 channels) and
// 64-row tiles a warpgroup (MT 1 to 3; 2 at NT 64).
template <bool Sparse>
cudaError_t conv_mma_launch(const ConvMmaArgs& a, long long smem,
                            cudaStream_t stream) {
  return a.nt == 64   ? conv_mma_launch_nt<Sparse, 64>(a, smem, stream)
         : a.nt == 32 ? conv_mma_launch_nt<Sparse, 32>(a, smem, stream)
                      : conv_mma_launch_nt<Sparse, 16>(a, smem, stream);
}

}  // namespace cm
}  // namespace
}  // namespace rt
