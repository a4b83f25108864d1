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
// bfloat16: matmul_mma_kernel (matmul_mma.cuh), a persistent wgmma
//   GEMM.  At QKV the body before it ran two waves of one tile a block
//   (192 tiles on 132 SMs: the second a third full) with the MMAs at
//   half of a block's time, its waits on loads a quarter to a third and
//   its epilogue a fifth; this one walks the tiles and splits the tail.
//   - Tile: a bm x bn output tile padded to BM x BN: BM = 64 rows a
//     consumer warpgroup (one or two of them), BN the wgmma width in
//     {16, 32, 64, 96, 128, 192, 256} at or above bn.  Rows and columns
//     past bm / bn are computed from the neighbouring data and never
//     stored; k past the pass's range is zero-filled.
//   - Ring: a producer warpgroup (one thread of it when both operands go
//     by TMA) fills 2-8 shared-memory stages of A [BM, ks] (K-major) and
//     B [ks, BN] (N-major: wgmma reads row-major B transposed), each
//     completed on a `full` mbarrier and released by the consumers on an
//     `empty` one.  ks is the schedule's k block rounded up to 16, 32 or
//     64 (a 32, 64 or 128-byte swizzle row).  An operand whose rows are
//     16-byte multiples comes by TMA, the others (the 1x1 GEMM forms' B,
//     rows of 169, 729 or 3025 elements) through the producer's
//     registers into the same swizzled layout.
//   - Persistent walk: the grid is the number of blocks that can be
//     resident at once (the occupancy query, at launch); each walks
//     units of the output in the schedule's order (m or n tiles
//     fastest), so the tiles in flight together are neighbours.  The
//     ring's stage and its barriers' parities carry on from tile to
//     tile, so the producer loads the next tile while the consumers
//     finish this one.  At two consumer warpgroups setmaxnreg moves
//     registers from the producer to the consumers (a 128 x 256 tile
//     holds 128 f32 accumulators a thread).
//   - The tail: the planner (kernels/_geometry.py, matmul_plan) splits
//     the k range of the last partial wave's tiles (or of every tile,
//     when there are fewer than the blocks) over the blocks that wave
//     would leave idle, and every tile of a k longer than 4096 (the
//     tensor cores' f32 accumulation over 8192 drifts past 2 bf16 ulps
//     near zero).  Each part writes its f32 partial to the wrapper's
//     workspace and takes a ticket; the part that takes the last ticket
//     adds the partials in split order (of two parts, the other's onto
//     its own registers; of more, all from L2), rounds once and stores,
//     and sets the ticket back to 0 for the next launch (a captured
//     graph replays with no memset).  No block waits on another, so
//     correctness does not rest on the blocks being resident together;
//     the sum's order is fixed, so two calls are bit-identical.
//   - Epilogue: straight from the fragments, as bf16 pairs where N and
//     bn are even, else one element at a time; a read-modify-write pass
//     reads its C tile first.  The producer already fills the ring for
//     the next tile while the consumers store.
//   - Schedule: k innermost (or a resident RHS) sums every k block in one
//     launch and rounds once; otherwise one launch per k block reads the
//     output tile, adds in f32 and rounds back.  A resident RHS keeps
//     the [k, BN] B panel of one n column in shared memory (k 3072
//     allows bn <= 32): each block walks a contiguous run of tiles, m
//     fastest, and loads the panel once per column it meets, streaming
//     only A through the ring (no tail split).
//   - Two flavours of the template (matmul_mma.cuh): a launch with no
//     split and no resident RHS runs the lean one (matmul_lean.cu),
//     compiled without those paths.
//   MM_T_BEGIN / MM_T_MARK(k) / MM_T_END mark a consumer's phases for
//   launch/matmul_timeline.py (which defines them and builds a scratch
//   copy); here they compile to nothing.
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
#include <map>
#include <mutex>
#include <set>
#include <tuple>

#include "matmul_mma.cuh"

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

// The instance of a launch: the full flavour where the plan takes a
// split or a resident RHS, the lean one otherwise.
inline MmaKernel mma_kernel(int wg, int bn_pad, bool full) {
  if (!full) return mma_kernel_lean(wg, bn_pad);
#define RT_MM_CASE(W, N) \
  if (wg == W && bn_pad == N) return matmul_mma_kernel<W, N, true>;
  RT_MM_CASE(1, 16) RT_MM_CASE(1, 32) RT_MM_CASE(1, 64) RT_MM_CASE(1, 96)
  RT_MM_CASE(1, 128) RT_MM_CASE(1, 192) RT_MM_CASE(1, 256)
  RT_MM_CASE(2, 16) RT_MM_CASE(2, 32) RT_MM_CASE(2, 64) RT_MM_CASE(2, 96)
  RT_MM_CASE(2, 128) RT_MM_CASE(2, 192) RT_MM_CASE(2, 256)
#undef RT_MM_CASE
  return nullptr;
}

// Opts the instance into `smem` bytes and checks that, at two consumer
// warpgroups, it launches with the registers setmaxnreg moves (fewer
// would leave the consumers' request unmet).
inline cudaError_t mma_prepare(MmaKernel fn, int wg) {
  const void* f = reinterpret_cast<const void*>(fn);
  cudaError_t err = hw::smem_opt_in(f, kSmemLimit);
  if (err != cudaSuccess || wg != 2) return err;
  static std::mutex mu;
  static std::set<const void*> checked;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (checked.count(f)) return cudaSuccess;
  }
  cudaFuncAttributes at{};
  err = cudaFuncGetAttributes(&at, f);
  if (err != cudaSuccess) return err;
  if (at.numRegs < kLaunchRegs) return cudaErrorInvalidConfiguration;
  std::lock_guard<std::mutex> lock(mu);
  checked.insert(f);
  return cudaSuccess;
}

// Blocks of this instance at `smem` bytes that can be resident on the
// device at once (the SMs times the blocks an SM holds), cached per
// (instance, device, smem).
inline cudaError_t mma_resident(MmaKernel fn, int wg, int smem, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> seen;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(fn), dev,
                                   smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = seen.find(key);
    if (it != seen.end()) {
      *out = it->second;
      return cudaSuccess;
    }
  }
  err = mma_prepare(fn, wg);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, 128 * (wg + 1), static_cast<size_t>(smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  seen[key] = *out;
  return cudaSuccess;
}

// The shared-memory layout of the launch, as kernels/_geometry.py's
// matmul_mma_tile computes it.
struct MmaSmem {
  int a_bytes, b_bytes, panel_rows, panel_bytes, total;
};

inline MmaSmem mma_smem(int wg, int bn_pad, int ks, int stages, int K,
                        int resident) {
  MmaSmem s{};
  s.a_bytes = round1024(64 * wg * ks * 2);
  s.b_bytes = resident ? 0 : round1024(bn_pad * ks * 2);
  s.panel_rows = resident ? (K + 63) / 64 * 64 : 0;
  s.panel_bytes = resident ? round1024(bn_pad * s.panel_rows * 2) : 0;
  const long long total =
      1024LL + static_cast<long long>(stages) * (s.a_bytes + s.b_bytes) +
      s.panel_bytes + kBarrierBytes;
  s.total = total > kSmemLimit ? -1 : static_cast<int>(total);
  return s;
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


// Resident blocks of the bf16 instance at `smem` bytes, into *out (the
// planner's grid limit).
extern "C" int matmul_mma_resident(int bm, int bn_pad, int smem, void* out) {
  using namespace rt::mm;
  const int wg = bm <= 64 ? 1 : 2;
  // the full flavour's count: a launch of the lean one (no more
  // registers) takes the same grid
  const MmaKernel fn = mma_kernel(wg, bn_pad, true);
  if (fn == nullptr || bm < 1 || bm > 128 || out == nullptr || smem < 1 ||
      smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(mma_resident(fn, wg, smem, static_cast<int*>(out)));
}

// The bf16 body.  bn_pad and stages are the wrapper's layout
// (kernels/_geometry.py, matmul_mma_tile); a_tma / b_tma its staging
// route, refused here unless the operand's rows and base are 16-byte
// aligned; grid .. splits its plan (matmul_plan), refused unless it
// covers the tiles and fits the resident blocks; ws / tickets the tail's
// partials and tickets (zeroed tickets, left zeroed).
extern "C" int matmul_mma_fwd(const void* a, const void* b, void* c,
                              void* ws, void* tickets, int M, int N, int K,
                              int bm, int bn, int bk, int bn_pad, int stages,
                              int m_outer, int k_begin, int k_count,
                              int accumulate, int resident, int a_tma,
                              int b_tma, int grid, int full_tiles,
                              int tail_tiles, int splits, void* stream) {
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
  const bool full = splits > 1 || resident;
  const MmaKernel fn = mma_kernel(wg, bn_pad, full);
  const MmaKernel planned = mma_kernel(wg, bn_pad, true);
  const MmaSmem sm = mma_smem(wg, bn_pad, ks, stages, K, resident);
  const long long tiles = static_cast<long long>(M / bm) * (N / bn);
  // the resident panel's atom stride must fit the descriptor's 14 bits
  if (fn == nullptr || sm.total < 0 || tiles > (1LL << 30) ||
      (resident && sm.panel_rows * b_span / 16 > 16383))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_m = M / bm, n_n = N / bn;
  const int chunks = (k_count + ks - 1) / ks;
  const long long tail_parts = static_cast<long long>(tail_tiles) * splits;
  if (grid < 1 || full_tiles < 0 || tail_tiles < 0 || splits < 1 ||
      splits > chunks || full_tiles + tail_tiles != tiles ||
      (splits == 1) != (tail_tiles == 0) || (resident && splits > 1) ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int resident_blocks = 0;
  cudaError_t err = mma_resident(planned, wg, sm.total, &resident_blocks);
  if (err == cudaSuccess && !full) err = mma_prepare(fn, wg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > resident_blocks) return static_cast<int>(cudaErrorInvalidValue);
  MmaArgs p{};
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.c = static_cast<bf16*>(c);
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<int*>(tickets);
  p.M = M; p.N = N; p.K = K; p.bm = bm; p.bn = bn; p.ks = ks;
  p.stages = stages; p.n_m = n_m; p.n_n = n_n;
  p.m_outer = m_outer; p.k_begin = k_begin; p.k_end = k_begin + k_count;
  p.chunks = chunks; p.accumulate = accumulate; p.resident = resident;
  p.a_tma = a_tma; p.b_tma = b_tma;
  p.pairs = N % 2 == 0 && bn % 2 == 0 &&
            reinterpret_cast<uintptr_t>(c) % 4 == 0;
  p.b_span = b_span; p.panel_rows = sm.panel_rows;
  p.a_bytes = sm.a_bytes; p.b_bytes = sm.b_bytes;
  p.panel_bytes = sm.panel_bytes;
  p.full_tiles = full_tiles;
  p.units = full_tiles + static_cast<int>(tail_parts); p.splits = splits;
  CUtensorMap ma{}, mb{};
  if (a_tma && !make_map(&ma, a, k_begin + k_count, M, K, ks, 64 * wg, 2 * ks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b_tma && !make_map(&mb, b, N, k_begin + k_count, N, b_span / 2,
                         resident ? 64 : ks, b_span))
    return static_cast<int>(cudaErrorInvalidValue);
  fn<<<grid, 128 * (wg + 1), sm.total, static_cast<cudaStream_t>(stream)>>>(
      ma, mb, p);
  return static_cast<int>(cudaGetLastError());
}
