// The bf16 body of the tiled matmul (matmul.cu describes it): its
// arguments, the producer's fills, the persistent walk and the kernel,
// in two flavours of one template.  FULL compiles every path (the tail
// split's fix-up, the resident RHS); a launch with neither (no split, B
// streamed) takes the lean flavour, which leaves their code out.
// matmul.cu holds the full instances, matmul_lean.cu the lean ones
// (built in parallel).
#pragma once
#include "common.cuh"
#include "hopper.cuh"

#ifndef MATMUL_TIMELINE
#define MM_T_BEGIN()
#define MM_T_MARK(k)
#define MM_T_END()
#endif

namespace rt {
namespace mm {

using bf16 = __nv_bfloat16;
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;
constexpr int kBarrierBytes = 256;   // full, empty, the panel's two, a flag
// At two consumer warpgroups the 384 threads launch with 168 registers
// each (__launch_bounds__(384, 1)); the producer warpgroup gives back to
// 56 and the consumers take 224: 56 x 128 + 224 x 256 <= 168 x 384.
constexpr int kLaunchRegs = 168, kProducerRegs = 56, kConsumerRegs = 224;

struct MmaArgs {
  const bf16* a;
  const bf16* b;
  bf16* c;
  float* ws;             // the tail's f32 partials (splits > 1)
  int* tickets;          // one a split tile, 0 between launches
  int M, N, K;
  int bm, bn;            // the schedule's tile (<= BM, BN)
  int ks;                // stage depth in k: 16, 32 or 64
  int stages;            // ring stages, 2..8
  int n_m, n_n;          // output-tile trips
  int m_outer;           // 1: n tiles fastest; 0: m tiles fastest
  int k_begin, k_end;    // the k range this launch sums
  int chunks;            // its ks-deep chunks
  int accumulate;        // 1: an RMW pass after the first
  int resident;          // 1: the B panel of a column stays in shared memory
  int a_tma, b_tma;      // staging route per operand
  int pairs;             // epilogue: bf16 pairs, else singles
  int b_span;            // B's swizzle span in bytes: 32, 64 or 128
  int panel_rows;        // resident: K rounded up to 64
  int a_bytes, b_bytes, panel_bytes;
  // the plan (kernels/_geometry.py, matmul_plan); the grid is gridDim.x
  int full_tiles;        // tiles summed whole, the first in the order
  int units;             // full_tiles + the tail's split parts
  int splits;            // k ranges of a tail tile (1: no tail split)
};

__host__ __device__ inline int round1024(int x) { return (x + 1023) & ~1023; }

// Producer fill of one swizzled tile through registers: ROWS x COLS
// elements of src (row stride ld) starting at (r0, c0), zero outside
// [0, r_end) x [0, c_end).  The tile is [COLS / W][rows][W], W = span /
// 2 elements a row of an atom, the span the widest swizzle (128, 64 or
// 32 bytes) that divides a row of COLS elements: for A one atom (W =
// COLS = ks), for B the wgmma width's layout.  Consecutive threads take
// consecutive columns (coalesced along the source's rows); COLS is a
// compile-time constant, so no division runs per element, and the loop
// is unrolled to keep loads in flight.
template <int COLS>
__device__ __forceinline__ void fill_tile(unsigned char* dst,
                                          const bf16* __restrict__ src,
                                          int ld, int r0, int c0, int rows,
                                          int r_end, int c_end, int pt) {
  constexpr int span = (COLS * 2) % 128 == 0 ? 128
                       : (COLS * 2) % 64 == 0 ? 64 : 32;
  constexpr int w = span / 2;
  constexpr uint32_t mask = span / 16 - 1;
  constexpr int kBatch = 8;                   // loads in flight a thread
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const int total = rows * COLS;
  for (int e0 = pt; e0 < total; e0 += 128 * kBatch) {
    unsigned short v[kBatch];
    uint32_t off[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {        // element e: row e / COLS
      const int e = e0 + 128 * i;
      const int r = e / COLS, c = e - r * COLS;
      const int gr = r0 + r, gc = c0 + c;
      v[i] = (e < total && gr < r_end && gc < c_end)
                 ? __ldg(s + static_cast<size_t>(gr) * ld + gc)
                 : static_cast<unsigned short>(0);
      const int atom = c / w;
      off[i] = hw::swizzle(static_cast<uint32_t>(
                               atom * rows * span + r * span + (c - atom * w) * 2),
                           mask);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (e0 + 128 * i < total)
        *reinterpret_cast<unsigned short*>(dst + off[i]) = v[i];
  }
}

// The A stage through registers: ks (16, 32 or 64) as a constant.
__device__ __forceinline__ void fill_a(unsigned char* dst, const MmaArgs& p,
                                       int m0, int k0, int rows, int pt) {
  switch (p.ks) {
    case 16: fill_tile<16>(dst, p.a, p.K, m0, k0, rows, p.M, p.k_end, pt); break;
    case 32: fill_tile<32>(dst, p.a, p.K, m0, k0, rows, p.M, p.k_end, pt); break;
    default: fill_tile<64>(dst, p.a, p.K, m0, k0, rows, p.M, p.k_end, pt); break;
  }
}

// One unit of a block's walk: its output tile, its k chunks [c0, c1) and,
// for a part of a split tail tile, which part and which partial slot.
struct Unit {
  int tm, tn, c0, c1, split, slot;
};

__device__ __forceinline__ Unit unit_at(const MmaArgs& p, int u) {
  Unit w;
  int t = u;                     // tiles in the schedule's order
  w.c0 = 0;
  w.c1 = p.chunks;
  w.split = -1;
  w.slot = -1;
  if (u >= p.full_tiles) {       // a part of a split tail tile
    const int v = u - p.full_tiles;
    t = p.full_tiles + v / p.splits;
    w.split = v % p.splits;
    w.c0 = w.split * p.chunks / p.splits;
    w.c1 = (w.split + 1) * p.chunks / p.splits;
    w.slot = t - p.full_tiles;
  }
  w.tm = p.m_outer ? t / p.n_n : t % p.n_m;
  w.tn = p.m_outer ? t % p.n_n : t / p.n_m;
  return w;
}

// The units block `bid` of `grid` walks: every grid-th from bid (the
// units in flight at once are neighbours), or, with a resident RHS, a
// contiguous run (a block stays in one n column as long as it can).
__device__ __forceinline__ void walk_of(const MmaArgs& p, bool resident,
                                        int bid, int grid, int& first,
                                        int& end, int& stride) {
  if (resident) {
    const int q = p.units / grid, rem = p.units % grid;
    first = bid * q + (bid < rem ? bid : rem);
    end = first + q + (bid < rem ? 1 : 0);
    stride = 1;
  } else {
    first = bid;
    end = p.units;
    stride = grid;
  }
}

// One consumer warpgroup at a narrow tile is held to three blocks an SM
// (80 registers a thread): the 1x1 GEMM forms' hundreds of small tiles
// then run in one round (fire4-conv1x1-1 0.0150 -> 0.0108 ms on an
// H100 80GB HBM3).
template <int WG, int BN, bool FULL>
__global__ void __launch_bounds__(128 * (WG + 1),
                                  WG == 1 && BN <= 32 ? 3 : 1)
matmul_mma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const MmaArgs p) {
  constexpr int BM = 64 * WG;
  constexpr int CT = 128 * WG;              // consumer threads
  constexpr bool kRebalance = WG == 2;
  // the lean flavour: no split, B streamed
  const bool resident = FULL && p.resident;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_s = sm;                                   // ring of A
  unsigned char* b_s = a_s + p.stages * p.a_bytes;           // ring of B or panel
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      b_s + (resident ? p.panel_bytes : p.stages * p.b_bytes));
  uint64_t* full = bars;                    // [kMaxStages]
  uint64_t* empty = bars + kMaxStages;      // [kMaxStages]
  uint64_t* panel_full = bars + 2 * kMaxStages;
  uint64_t* panel_empty = panel_full + 1;
  volatile int* last_flag = reinterpret_cast<volatile int*>(panel_empty + 1);

  const int tid = threadIdx.x;
  const int a_span = p.ks * 2;              // A's rows are one swizzle span
  // with every operand on TMA one producer thread drives the ring;
  // otherwise the whole producer warpgroup loads and arrives
  const bool regs = !p.a_tma || !p.b_tma;
  const int producers = regs ? 128 : 1;
  if (tid == CT) {     // the producer's first thread: the maps it reads
    if (p.a_tma) hw::tma_prefetch_map(&map_a);
    if (p.b_tma) hw::tma_prefetch_map(&map_b);
  }
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      hw::mbar_init(&full[s], producers);
      hw::mbar_init(&empty[s], 4 * WG);   // one lane a consumer warp
    }
    hw::mbar_init(panel_full, producers);
    hw::mbar_init(panel_empty, 4 * WG);
    hw::mbar_init_fence();
  }
  __syncthreads();
  int first, end, stride;
  walk_of(p, resident, static_cast<int>(blockIdx.x),
          static_cast<int>(gridDim.x), first, end, stride);

  if (tid >= CT) {
    // ---------------- producer warpgroup
    if constexpr (kRebalance) hw::regs_dec<kProducerRegs>();
    const int pt = tid - CT;
    if (pt < producers) {
      const int bw = p.b_span / 2;          // B atom width in elements
      const bool b_ring = !resident;
      const uint32_t stage_tx = (p.a_tma ? BM * p.ks * 2 : 0) +
                                (b_ring && p.b_tma ? BN * p.ks * 2 : 0);
      int stage = 0, phase = 0, panels = 0, cur_tn = -1;
      for (int u = first; u < end; u += stride) {
        const Unit w = unit_at(p, u);
        const int m0 = w.tm * p.bm, n0 = w.tn * p.bn;
        if (resident && w.tn != cur_tn) {   // this column's B panel
          if (panels > 0) hw::mbar_wait(panel_empty, (panels - 1) & 1);
          if (p.b_tma) {
            if (pt == 0) {
              hw::mbar_expect_tx(panel_full, BN * p.panel_rows * 2);
              for (int j = 0; j < BN / bw; ++j)
                for (int r = 0; r < p.panel_rows; r += 64)
                  hw::tma_load_2d(b_s + j * p.panel_rows * p.b_span +
                                      r * p.b_span,
                                  &map_b, panel_full, n0 + j * bw, r);
            }
          } else {
            fill_tile<BN>(b_s, p.b, p.N, 0, n0, p.panel_rows, p.K, p.N, pt);
            hw::fence_proxy_async();
          }
          hw::mbar_arrive(panel_full);
          ++panels;
          cur_tn = w.tn;
        }
        for (int c = w.c0; c < w.c1; ++c) {
          hw::mbar_wait(&empty[stage], phase ^ 1);
          const int k0 = p.k_begin + c * p.ks;
          unsigned char* as = a_s + stage * p.a_bytes;
          unsigned char* bs = b_s + stage * p.b_bytes;
          if (pt == 0) {
            if (stage_tx) hw::mbar_expect_tx(&full[stage], stage_tx);
            if (p.a_tma) hw::tma_load_2d(as, &map_a, &full[stage], k0, m0);
            if (b_ring && p.b_tma)
              for (int j = 0; j < BN / bw; ++j)
                hw::tma_load_2d(bs + j * p.ks * p.b_span, &map_b,
                                &full[stage], n0 + j * bw, k0);
          }
          if (regs) {
            if (!p.a_tma) fill_a(as, p, m0, k0, BM, pt);
            if (b_ring && !p.b_tma)
              fill_tile<BN>(bs, p.b, p.N, k0, n0, p.ks, p.k_end, p.N, pt);
            hw::fence_proxy_async();
          }
          hw::mbar_arrive(&full[stage]);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups: rows 64 g .. 64 g + 63
    if constexpr (kRebalance) hw::regs_inc<kConsumerRegs>();
    MM_T_BEGIN()
    const int g = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    float acc[BN / 2];
    const uint32_t a_layout = hw::swizzle_layout(a_span);
    const uint32_t b_layout = hw::swizzle_layout(p.b_span);
    const int b_rows = resident ? p.panel_rows : p.ks;   // rows of a B atom
    const uint32_t b_lbo = static_cast<uint32_t>(b_rows * p.b_span / 16);
    const uint32_t b_sbo = static_cast<uint32_t>(p.b_span / 2);
    const uint32_t a_sbo = static_cast<uint32_t>(a_span / 2);
    auto release = [&](int s) {   // a consumer warp frees a stage
      if (lane == 0) hw::mbar_arrive(&empty[s]);
    };
    unsigned short* C = reinterpret_cast<unsigned short*>(p.c);
    int stage = 0, phase = 0, panels = 0, cur_tn = -1;
    MM_T_MARK(0)
    for (int u = first; u < end; u += stride) {
      const Unit w = unit_at(p, u);
      const int m0 = w.tm * p.bm, n0 = w.tn * p.bn;
      if (resident && w.tn != cur_tn) {
        hw::mbar_wait(panel_full, panels & 1);
        ++panels;
        cur_tn = w.tn;
      }
      int prev = 0;
      for (int c = w.c0; c < w.c1; ++c) {
        hw::mbar_wait(&full[stage], phase);
        MM_T_MARK(1)
        const uint32_t a_addr =
            hw::smem_u32(a_s + stage * p.a_bytes) + g * 64 * a_span;
        const uint32_t b_addr =
            resident ? hw::smem_u32(b_s) + c * p.ks * p.b_span
                       : hw::smem_u32(b_s + stage * p.b_bytes);
        hw::wgmma_fence();
        for (int kk = 0; kk < p.ks / 16; ++kk) {
          const uint64_t da = hw::make_desc(a_addr + kk * 32, 1, a_sbo, a_layout);
          const uint64_t db = hw::make_desc(b_addr + kk * 16 * p.b_span, b_lbo,
                                            b_sbo, b_layout);
          // the tile's first product overwrites the accumulators
          hw::Wgmma<BN>::run(acc, da, db, (c > w.c0 || kk > 0) ? 1 : 0);
        }
        hw::wgmma_commit();
        if (c > w.c0) {
          hw::wgmma_wait<1>();   // chunk c - 1's products are done with its stage
          release(prev);
        }
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
        MM_T_MARK(2)
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(acc, BN / 2);
      release(prev);
      MM_T_MARK(2)
      if (resident && lane == 0 &&
          (u + stride >= end || unit_at(p, u + stride).tn != w.tn))
        hw::mbar_arrive(panel_empty);

      // this unit's thread index, opaque to the compiler: the epilogue's
      // and the fix-up's addresses are computed here, not hoisted out of
      // the walk and held in registers through the MMAs
      int ln = lane, ti = tid;
      asm volatile("" : "+r"(ln), "+r"(ti));
      if (FULL && w.split >= 0) {
        // a part of a split tile: publish the f32 partial, take a ticket;
        // the last part adds all of them in split order and stores
        constexpr int kTile4 = BM * BN / 4;
        float4* ws4 = reinterpret_cast<float4*>(p.ws) +
                      static_cast<size_t>(w.slot) * p.splits * kTile4;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q)
          __stcg(ws4 + static_cast<size_t>(w.split) * kTile4 + q * CT + ti,
                 make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                             acc[4 * q + 3]));
        __threadfence();
        hw::named_sync(1, CT);
        if (ti == 0)
          *last_flag = atomicAdd(p.tickets + w.slot, 1) == p.splits - 1;
        hw::named_sync(1, CT);
        if (!*last_flag) {
          MM_T_MARK(4)
          continue;
        }
        __threadfence();
        if (p.splits == 2) {
          // the other part's partial onto this one's registers: a sum of
          // two is the same whichever part is last
          const float4* other =
              ws4 + static_cast<size_t>(1 - w.split) * kTile4 + ti;
#pragma unroll
          for (int q = 0; q < BN / 8; ++q) {
            const float4 x = __ldcg(other + q * CT);
            acc[4 * q] += x.x;
            acc[4 * q + 1] += x.y;
            acc[4 * q + 2] += x.z;
            acc[4 * q + 3] += x.w;
            // eight float4s in flight at a time: loads batched across the
            // whole unrolled loop would hold BN / 2 more registers
            if (q % 8 == 7) asm volatile("" ::: "memory");
          }
        } else {
          // every part from L2 in split order, this block's too (the
          // same bits it holds): a select of its own registers costs
          // another BN / 2 registers
#pragma unroll
          for (int q = 0; q < BN / 8; ++q) {
            float4 s = __ldcg(ws4 + q * CT + ti);
            for (int j = 1; j < p.splits; ++j) {
              const float4 x =
                  __ldcg(ws4 + static_cast<size_t>(j) * kTile4 + q * CT + ti);
              s.x += x.x;
              s.y += x.y;
              s.z += x.z;
              s.w += x.w;
            }
            acc[4 * q] = s.x;
            acc[4 * q + 1] = s.y;
            acc[4 * q + 2] = s.z;
            acc[4 * q + 3] = s.w;
            if (q % 8 == 7) asm volatile("" ::: "memory");
          }
        }
        if (ti == 0) p.tickets[w.slot] = 0;
        MM_T_MARK(4)
      }

      // epilogue: rows past bm and columns past bn are never stored; an
      // RMW pass adds the stored value in f32
      const int rb = g * 64 + warp * 16 + ln / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (ln % 4);
        if (col >= p.bn) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rb + 8 * h;
          if (r >= p.bm) continue;
          const size_t off = static_cast<size_t>(m0 + r) * p.N + n0 + col;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (p.pairs) {   // N and bn even: col + 1 < bn, 4-byte aligned
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(C + off);
            if (p.accumulate) {
              const float2 old = __bfloat1622float2(*dst);
              v0 += old.x;
              v1 += old.y;
            }
            *dst = __floats2bfloat162_rn(v0, v1);
          } else {
            for (int e = 0; e < 2 && col + e < p.bn; ++e) {
              float v = e ? v1 : v0;
              if (p.accumulate)
                v += __bfloat162float(__ushort_as_bfloat16(C[off + e]));
              C[off + e] = __bfloat16_as_ushort(__float2bfloat16(v));
            }
          }
        }
        asm volatile("" ::: "memory");   // (as in the fix-up)
      }
      MM_T_MARK(3)
    }
    MM_T_END()
  }
}

// A 2-D bf16 tensor map: `cols` x `rows` (row stride `ld` elements),
// box `box_c` x `box_r`, swizzled by `span` (16: none); out-of-range
// boxes read 0 and write nothing.
inline bool make_map(CUtensorMap* map, const void* base, int cols, int rows,
                     int ld, int box_c, int box_r, int span) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  return hw::make_map_bf16(map, base, 2, dims, strides, box, span);
}

typedef void (*MmaKernel)(const CUtensorMap, const CUtensorMap,
                          const MmaArgs);

// The lean instances (matmul_lean.cu), nullptr where none is.
MmaKernel mma_kernel_lean(int wg, int bn_pad);

}  // namespace mm
}  // namespace rt
