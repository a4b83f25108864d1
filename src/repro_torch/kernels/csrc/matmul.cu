// Tiled matmul C[m, n] = A[m, k] . B[k, n] with f32 accumulation and the
// output in A's type, a permutable block order, both accumulation
// variants and a resident-RHS mode.  Two bodies, chosen by dtype (a
// fixed rule: both are checked on the card by chip_smoke.py):
//
// Replaces: src/repro/kernels/matmul/kernel.py, matmul_pallas (bodies
//   _mm_scratch_kernel, _mm_rmw_kernel and _mm_resident_kernel).
// Bound on an H100: phi3-mini's QKV projection at the largest prefill
//   bucket (m 512, k 3072, n 9216, bf16) is 29 GFLOP, 29 us on the bf16
//   tensor cores (989 TFLOP/s) and 0.43 ms on the CUDA cores (67
//   TFLOP/s); the GEMM form of the 1x1 Table 4.1 layers at batch 1 moves
//   < 2.1 MB and is bound by bytes (< 0.7 us) and, in practice, by the
//   launch.
//
// bfloat16: matmul_mma_kernel, on the tensor cores (wgmma).
//   - A block computes a bm x bn output tile padded to BM x BN: BM = 64
//     rows a consumer warpgroup (one or two of them), BN the wgmma width
//     in {16, 32, 64, 96, 128, 192, 256} at or above bn.  Rows and
//     columns past bm / bn are computed from the neighbouring data and
//     masked on store; k past the pass's range is zero-filled.
//   - A producer warpgroup (one thread of it when both operands go by
//     TMA) fills a ring of 2-4 shared-memory stages of A
//     [BM, ks] (K-major) and B [ks, BN] (N-major: B stays row-major in
//     device memory and wgmma reads it transposed), each stage completed
//     on an mbarrier and released by the consumers on another, so k
//     chunk i + 1 loads while chunk i multiplies.  ks, the stage depth,
//     is the schedule's k block rounded up to 16, 32 or 64 elements (a
//     32, 64 or 128-byte swizzle row); a deeper k block spans stages.
//   - Staging route, a shape rule per operand: an operand whose rows are
//     16-byte multiples (k % 8 for A, n % 8 for B) is copied by TMA
//     (cp.async.bulk.tensor, the tensor map's box swizzled as wgmma
//     reads it, out-of-range elements zero-filled); the others (the 1x1
//     GEMM forms' B, rows of 169, 729 or 3025 elements) are loaded
//     through the producer's registers into the same swizzled layout.
//   - The schedule changes what runs as before: the output tiles are
//     linearised into blockIdx with m or n fastest; k innermost (or a
//     resident RHS) sums every k block in one launch and rounds once,
//     otherwise one launch per k block reads the output tile, adds in
//     f32 and rounds back; a resident RHS loads the block's whole
//     [k, BN] B panel into shared memory once (k 3072 allows bn <= 32)
//     and streams only A through the ring.
//   What it leaves out: persistent blocks walking several tiles (so one
//   tile's epilogue overlaps the next one's loads), thread-block
//   clusters with TMA multicast of the shared operand, split-K across
//   the 2.2 waves that phi3's QKV makes of 128 x 128 tiles on 132 SMs,
//   and a TMA store epilogue.
//
// float32: matmul_kernel, on the CUDA cores in IEEE fp32 (the tensor
//   cores only take float32 as TF32, which would break the 1e-5 float32
//   contract).  256 threads a block (16 x 16), one block per (bm, bn)
//   output tile; thread (ty, tx) owns the MI x MJ outputs (ty + 16 i,
//   tx + 16 j), MI, MJ in {2, 4, 8}, so one A value and one B value read
//   from shared memory feed MJ and MI FMAs.  An A chunk [16 MI, bk + 1]
//   (row-major, written along k as it is read, the row padded by one
//   element so a warp's two rows fall in different banks) and a B chunk
//   [bk, 16 MJ] are staged per k block.  Each k block's product is
//   summed into fresh f32 registers and added to the running total, as
//   the TPU kernel adds each block's dot into its f32 scratch.  Block
//   order, variant and resident RHS as above (the resident panel up to
//   227 KB).
#include "common.cuh"
#include "hopper.cuh"

namespace rt {

constexpr int kTx = 16, kTy = 16, kThreads = kTx * kTy;

struct MatmulArgs {
  const void* a;
  const void* b;
  void* c;
  int M, N, K;
  int bm, bn, bk;
  int n_m, n_n;          // output-tile trips
  int m_outer;           // 1: n tiles fastest; 0: m tiles fastest
  int k_begin, k_count;  // the k range this launch sums
  int accumulate;        // 1: an RMW pass after the first
  int resident;          // 1: the whole B panel stays in shared memory
};

template <typename T, int MI, int MJ>
__global__ void __launch_bounds__(kThreads) matmul_kernel(MatmulArgs p) {
  constexpr int BMP = kTy * MI, BNP = kTx * MJ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = p.bk + 1;
  T* a_s = reinterpret_cast<T*>(smem_raw);    // [BMP][bk + 1]
  T* b_s = a_s + BMP * lda;                      // [bk or K][BNP]
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int lin = blockIdx.x;
  const int tm = p.m_outer ? lin / p.n_n : lin % p.n_m;
  const int tn = p.m_outer ? lin % p.n_n : lin / p.n_m;
  const int m0 = tm * p.bm, n0 = tn * p.bn;
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);

  if (p.resident) {   // the [K, bn] panel, loaded once
    for (int e = tid; e < p.k_count * BNP; e += kThreads) {
      const int kk = e / BNP, c = e % BNP;   // BNP is a power of two
      b_s[e] = c < p.bn ? B[static_cast<size_t>(p.k_begin + kk) * p.N + n0 + c]
                        : from_f<T>(0.f);
    }
  }
  // A chunk staging walks (row, k) with carried indices: no division by
  // the runtime bk per element
  const int a_r0 = tid / p.bk, a_k0 = tid % p.bk;
  const int a_dr = kThreads / p.bk, a_dk = kThreads % p.bk;
  float total[MI][MJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) total[i][j] = 0.f;

  for (int k0 = 0; k0 < p.k_count; k0 += p.bk) {
    __syncthreads();   // the previous chunk's products are done with smem
    for (int r = a_r0, kk = a_k0; r < BMP;) {   // coalesced along k
      a_s[r * lda + kk] =
          r < p.bm ? A[static_cast<size_t>(m0 + r) * p.K + p.k_begin + k0 + kk]
                   : from_f<T>(0.f);
      kk += a_dk;
      r += a_dr;
      if (kk >= p.bk) { kk -= p.bk; ++r; }
    }
    if (!p.resident) {
      for (int e = tid; e < p.bk * BNP; e += kThreads) {
        const int kk = e / BNP, c = e % BNP;
        b_s[e] = c < p.bn
                     ? B[static_cast<size_t>(p.k_begin + k0 + kk) * p.N + n0 + c]
                     : from_f<T>(0.f);
      }
    }
    __syncthreads();
    const T* brows = p.resident ? b_s + static_cast<size_t>(k0) * BNP : b_s;
    float part[MI][MJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) part[i][j] = 0.f;
    for (int kk = 0; kk < p.bk; ++kk) {
      float av[MI], bv[MJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) av[i] = to_f(a_s[(ty + kTy * i) * lda + kk]);
#pragma unroll
      for (int j = 0; j < MJ; ++j) bv[j] = to_f(brows[kk * BNP + tx + kTx * j]);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < MJ; ++j) total[i][j] += part[i][j];
  }

  T* C = static_cast<T*>(p.c);
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + kTy * i;
    if (r >= p.bm) continue;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int col = tx + kTx * j;
      if (col >= p.bn) continue;
      const size_t off = static_cast<size_t>(m0 + r) * p.N + n0 + col;
      const float v = p.accumulate ? to_f(C[off]) + total[i][j] : total[i][j];
      C[off] = from_f<T>(v);
    }
  }
}

template <typename T, int MI, int MJ>
cudaError_t mm_launch(const MatmulArgs& p, int smem, cudaStream_t st) {
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(matmul_kernel<T, MI, MJ>), 232448);
  if (attr != cudaSuccess) return attr;
  matmul_kernel<T, MI, MJ><<<p.n_m * p.n_n, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int MI>
cudaError_t mm_dispatch_mj(int mj, const MatmulArgs& p, int smem,
                           cudaStream_t st) {
  switch (mj) {
    case 2: return mm_launch<T, MI, 2>(p, smem, st);
    case 4: return mm_launch<T, MI, 4>(p, smem, st);
    case 8: return mm_launch<T, MI, 8>(p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t mm_dispatch(int mi, int mj, const MatmulArgs& p, int smem,
                        cudaStream_t st) {
  switch (mi) {
    case 2: return mm_dispatch_mj<T, 2>(mj, p, smem, st);
    case 4: return mm_dispatch_mj<T, 4>(mj, p, smem, st);
    case 8: return mm_dispatch_mj<T, 8>(mj, p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rt

namespace rt {
namespace mm {

using bf16 = __nv_bfloat16;
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;

struct MmaArgs {
  const bf16* a;
  const bf16* b;
  bf16* c;
  int M, N, K;
  int bm, bn;            // the schedule's tile (<= BM, BN)
  int ks;                // stage depth in k: 16, 32 or 64
  int stages;            // ring stages, 2..4
  int n_m, n_n;          // output-tile trips
  int m_outer;           // 1: n tiles fastest; 0: m tiles fastest
  int k_begin, k_count;  // the k range this launch sums
  int accumulate;        // 1: an RMW pass after the first
  int resident;          // 1: the whole B panel stays in shared memory
  int a_tma, b_tma;      // staging route per operand
  int b_span;            // B's swizzle span in bytes: 32, 64 or 128
  int panel_rows;        // resident: K rounded up to 64
  int a_bytes, b_bytes, panel_bytes;   // one A stage, one B stage, panel
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
  const int k_end = p.k_begin + p.k_count;
  switch (p.ks) {
    case 16: fill_tile<16>(dst, p.a, p.K, m0, k0, rows, p.M, k_end, pt); break;
    case 32: fill_tile<32>(dst, p.a, p.K, m0, k0, rows, p.M, k_end, pt); break;
    default: fill_tile<64>(dst, p.a, p.K, m0, k0, rows, p.M, k_end, pt); break;
  }
}

template <int WG, int BN>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
matmul_mma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const MmaArgs p) {
  constexpr int BM = 64 * WG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* a_s = sm;                                   // ring of A
  unsigned char* b_s = a_s + p.stages * p.a_bytes;           // ring of B or panel
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      b_s + (p.resident ? p.panel_bytes : p.stages * p.b_bytes));
  uint64_t* full = bars;                    // [kMaxStages]
  uint64_t* empty = bars + kMaxStages;      // [kMaxStages]
  uint64_t* panel = bars + 2 * kMaxStages;

  const int tid = threadIdx.x;
  const int lin = blockIdx.x;
  const int tm = p.m_outer ? lin / p.n_n : lin % p.n_m;
  const int tn = p.m_outer ? lin % p.n_n : lin / p.n_m;
  const int m0 = tm * p.bm, n0 = tn * p.bn;
  const int k_end = p.k_begin + p.k_count;
  const int n_chunks = (p.k_count + p.ks - 1) / p.ks;
  const int a_span = p.ks * 2;              // A's rows are one swizzle span

  // with every operand on TMA one producer thread drives the ring;
  // otherwise the whole producer warpgroup loads and arrives
  const bool regs = !p.a_tma || !p.b_tma;
  const int producers = regs ? 128 : 1;
  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      hw::mbar_init(&full[s], producers);
      hw::mbar_init(&empty[s], 4 * WG);     // one lane per consumer warp
    }
    hw::mbar_init(panel, producers);
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * WG) {
    // ---------------- producer warpgroup
    const int pt = tid - 128 * WG;
    if (pt >= producers) return;
    const int bw = p.b_span / 2;            // B atom width in elements
    if (p.resident) {
      if (p.b_tma) {
        if (pt == 0) {
          hw::mbar_expect_tx(panel, BN * p.panel_rows * 2);
          for (int j = 0; j < BN / bw; ++j)
            for (int r = 0; r < p.panel_rows; r += 64)
              hw::tma_load_2d(b_s + j * p.panel_rows * p.b_span + r * p.b_span,
                              &map_b, panel, n0 + j * bw, r);
        }
      } else {
        fill_tile<BN>(b_s, p.b, p.N, 0, n0, p.panel_rows, p.K, p.N, pt);
        hw::fence_proxy_async();
      }
      hw::mbar_arrive(panel);
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % p.stages, round = c / p.stages;
      if (round > 0) hw::mbar_wait(&empty[s], (round - 1) & 1);
      const int k0 = p.k_begin + c * p.ks;
      unsigned char* as = a_s + s * p.a_bytes;
      unsigned char* bs = b_s + s * p.b_bytes;
      const bool b_ring = !p.resident;
      if (pt == 0) {
        const uint32_t tx = (p.a_tma ? BM * p.ks * 2 : 0) +
                            (b_ring && p.b_tma ? BN * p.ks * 2 : 0);
        if (tx) hw::mbar_expect_tx(&full[s], tx);
        if (p.a_tma) hw::tma_load_2d(as, &map_a, &full[s], k0, m0);
        if (b_ring && p.b_tma)
          for (int j = 0; j < BN / bw; ++j)
            hw::tma_load_2d(bs + j * p.ks * p.b_span, &map_b, &full[s],
                            n0 + j * bw, k0);
      }
      if (!p.a_tma) fill_a(as, p, m0, k0, BM, pt);
      if (b_ring && !p.b_tma)
        fill_tile<BN>(bs, p.b, p.N, k0, n0, p.ks, k_end, p.N, pt);
      if (!p.a_tma || (b_ring && !p.b_tma)) hw::fence_proxy_async();
      hw::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---------------- consumer warpgroups: rows 64 g .. 64 g + 63
  const int g = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_layout = hw::swizzle_layout(a_span);
  const uint32_t b_layout = hw::swizzle_layout(p.b_span);
  const int b_rows = p.resident ? p.panel_rows : p.ks;   // rows of a B atom
  const uint32_t b_lbo = static_cast<uint32_t>(b_rows * p.b_span / 16);
  const uint32_t b_sbo = static_cast<uint32_t>(p.b_span / 2);
  const uint32_t a_sbo = static_cast<uint32_t>(a_span / 2);
  if (p.resident) hw::mbar_wait(panel, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % p.stages;
    hw::mbar_wait(&full[s], (c / p.stages) & 1);
    const uint32_t a_addr =
        hw::smem_u32(a_s + s * p.a_bytes) + g * 64 * a_span;
    const uint32_t b_addr =
        p.resident ? hw::smem_u32(b_s) + c * p.ks * p.b_span
                   : hw::smem_u32(b_s + s * p.b_bytes);
    hw::wgmma_fence();
    for (int kk = 0; kk < p.ks / 16; ++kk) {
      const uint64_t da = hw::make_desc(a_addr + kk * 32, 1, a_sbo, a_layout);
      const uint64_t db = hw::make_desc(b_addr + kk * 16 * p.b_span, b_lbo,
                                        b_sbo, b_layout);
      hw::Wgmma<BN>::run(acc, da, db);
    }
    hw::wgmma_commit();
    if (c > 0) {
      hw::wgmma_wait<1>();   // chunk c - 1's products are done with its stage
      if (lane == 0) hw::mbar_arrive(&empty[(c - 1) % p.stages]);
    }
  }
  hw::wgmma_wait<0>();
  if (n_chunks > 0 && lane == 0) hw::mbar_arrive(&empty[(n_chunks - 1) % p.stages]);

  // epilogue: mask the padded rows and columns; an RMW pass adds in f32
  unsigned short* C = reinterpret_cast<unsigned short*>(p.c);
  const int r_base = g * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r_base + 8 * (e / 2);
      const int col = 8 * j + 2 * (lane % 4) + (e % 2);
      if (r >= p.bm || col >= p.bn) continue;
      const size_t off = static_cast<size_t>(m0 + r) * p.N + n0 + col;
      float v = acc[4 * j + e];
      if (p.accumulate) v += __bfloat162float(__ushort_as_bfloat16(C[off]));
      C[off] = __bfloat16_as_ushort(__float2bfloat16(v));
    }
  }
}

// A 2-D bf16 tensor map: `cols` x `rows` (row stride `ld` elements),
// box `box_c` x `box_r`, swizzled by `span`; out-of-range boxes read 0.
inline bool make_map(CUtensorMap* map, const void* base, int cols, int rows,
                     int ld, int box_c, int box_r, int span) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c),
                             static_cast<cuuint32_t>(box_r)};
  return hw::make_map_bf16(map, base, 2, dims, strides, box, span);
}

template <int WG, int BN>
cudaError_t mma_launch(const CUtensorMap& ma, const CUtensorMap& mb,
                       const MmaArgs& p, int smem, cudaStream_t st) {
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(matmul_mma_kernel<WG, BN>),
      kSmemLimit);
  if (attr != cudaSuccess) return attr;
  matmul_mma_kernel<WG, BN><<<p.n_m * p.n_n, 128 * (WG + 1), smem, st>>>(
      ma, mb, p);
  return cudaGetLastError();
}

template <int WG>
cudaError_t mma_dispatch_bn(int bn_pad, const CUtensorMap& ma,
                            const CUtensorMap& mb, const MmaArgs& p, int smem,
                            cudaStream_t st) {
  switch (bn_pad) {
    case 16: return mma_launch<WG, 16>(ma, mb, p, smem, st);
    case 32: return mma_launch<WG, 32>(ma, mb, p, smem, st);
    case 64: return mma_launch<WG, 64>(ma, mb, p, smem, st);
    case 96: return mma_launch<WG, 96>(ma, mb, p, smem, st);
    case 128: return mma_launch<WG, 128>(ma, mb, p, smem, st);
    case 192: return mma_launch<WG, 192>(ma, mb, p, smem, st);
    case 256: return mma_launch<WG, 256>(ma, mb, p, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mm
}  // namespace rt

extern "C" int matmul_fwd(const void* a, const void* b, void* c, int M,
                          int N, int K, int bm, int bn, int bk, int mi,
                          int mj, int m_outer, int k_begin, int k_count,
                          int accumulate, int resident, void* stream) {
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1 || M % bm ||
      N % bn || K % bk || bm > rt::kTy * mi || bn > rt::kTx * mj ||
      k_begin < 0 || k_count < bk || k_count % bk || k_begin + k_count > K ||
      (resident && (k_begin != 0 || k_count != K)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = (static_cast<long long>(bk + 1) * rt::kTy * mi +
                          static_cast<long long>(resident ? K : bk) * rt::kTx * mj) * 4;
  const long long tiles = static_cast<long long>(M / bm) * (N / bn);
  if (smem > 232448 || tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::MatmulArgs p{a, b, c, M, N, K, bm, bn, bk, M / bm, N / bn, m_outer,
                   k_begin, k_count, accumulate, resident};
  return static_cast<int>(rt::mm_dispatch<float>(
      mi, mj, p, static_cast<int>(smem), static_cast<cudaStream_t>(stream)));
}

// The bf16 body.  bn_pad and stages are the wrapper's layout
// (kernels/_geometry.py, matmul_mma_tile); a_tma / b_tma its staging
// route, refused here unless the operand's rows and base are 16-byte
// aligned.
extern "C" int matmul_mma_fwd(const void* a, const void* b, void* c, int M,
                              int N, int K, int bm, int bn, int bk,
                              int bn_pad, int stages, int m_outer,
                              int k_begin, int k_count, int accumulate,
                              int resident, int a_tma, int b_tma,
                              void* stream) {
  using namespace rt::mm;
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1 || M % bm ||
      N % bn || K % bk || bm > 128 || bn > bn_pad || bn_pad > 256 ||
      k_begin < 0 || k_count < bk || k_count % bk || k_begin + k_count > K ||
      stages < 2 || stages > kMaxStages ||
      (resident && (k_begin != 0 || k_count != K)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((a_tma && (K % 8 || reinterpret_cast<uintptr_t>(a) % 16)) ||
      (b_tma && (N % 8 || reinterpret_cast<uintptr_t>(b) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int wg = bm <= 64 ? 1 : 2;
  const int ks = bk <= 16 ? 16 : bk <= 32 ? 32 : 64;
  const int b_span = (bn_pad * 2) % 128 == 0 ? 128
                     : (bn_pad * 2) % 64 == 0 ? 64 : 32;
  MmaArgs p{};
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.c = static_cast<bf16*>(c);
  p.M = M; p.N = N; p.K = K; p.bm = bm; p.bn = bn; p.ks = ks;
  p.stages = stages; p.n_m = M / bm; p.n_n = N / bn; p.m_outer = m_outer;
  p.k_begin = k_begin; p.k_count = k_count; p.accumulate = accumulate;
  p.resident = resident; p.a_tma = a_tma; p.b_tma = b_tma;
  p.b_span = b_span;
  p.panel_rows = resident ? (K + 63) / 64 * 64 : 0;
  p.a_bytes = round1024(64 * wg * ks * 2);
  p.b_bytes = resident ? 0 : round1024(bn_pad * ks * 2);
  p.panel_bytes = resident ? round1024(bn_pad * p.panel_rows * 2) : 0;
  const long long smem = 1024LL + static_cast<long long>(stages) *
                         (p.a_bytes + p.b_bytes) + p.panel_bytes +
                         (2 * kMaxStages + 1) * 8;
  const long long tiles = static_cast<long long>(M / bm) * (N / bn);
  // the resident panel's atom stride must fit the descriptor's 14 bits
  if (smem > kSmemLimit || tiles > 2147483647LL ||
      (resident && p.panel_rows * b_span / 16 > 16383))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma{}, mb{};
  if (a_tma && !make_map(&ma, a, k_begin + k_count, M, K, ks, 64 * wg, 2 * ks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b_tma && !make_map(&mb, b, N, k_begin + k_count, N, b_span / 2,
                         resident ? 64 : ks, b_span))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = static_cast<int>(smem);
  const cudaError_t err =
      wg == 1 ? mma_dispatch_bn<1>(bn_pad, ma, mb, p, s, st)
              : mma_dispatch_bn<2>(bn_pad, ma, mb, p, s, st);
  return static_cast<int>(err);
}
