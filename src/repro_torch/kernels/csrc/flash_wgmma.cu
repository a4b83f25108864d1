// bf16 flash attention on wgmma + TMA: the bf16 body at the models' head
// dims, at every length; flash_mma_kernel (flash_attention.cu) keeps the
// other head dims, with the same function, masks and arithmetic
// contract.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (bodies _flash_kernel, _flash_kernel_starts),
//   at the shapes kernels/_geometry.py (flash_body) gives it: bf16, head
//   dim 64, 96, 128 or 256, 16-byte aligned rows.
// Bound on an H100: bytes at the engine's prefills (phi3-mini's S <= 512,
//   causal, far below the card's ~295 operations a byte); operations
//   where a row walks more than ~600 keys.  Whisper's encoder ([4, 20,
//   1500, 64], no mask) does 4 S^2 D operations a head against 8 S D
//   bytes, ~750 operations a byte: the tensor cores' rate is the floor.
//   mma.sync from 4 warps a 64-row block, with the softmax between the
//   MMAs, reached about a ninth of it there.  At the short prefills a
//   block's time is its latency: Q, the first K/V tiles and the
//   epilogue; one TMA copy a tile and a producer warp that keeps the
//   next in flight beat mma.sync's cp.async staging there too.
//
// Design (FlashAttention-3's shape, without its ping-pong scheduling):
// - Block: ROWS = 64 or 128 query rows (one or two consumer warpgroups,
//   FlashAttentionSchedule.block_q) and one producer warp.  The grid
//   runs the query tiles with the most reachable keys first, as
//   flash_mma_kernel does; a tile no row of which sees a key writes zeros.
// - Operands by TMA: Q, K, V are mapped as 3-D tensors [B x H][S][D] (K
//   and V over B x HKV: GQA reads KV head h / group), so the rows of a
//   box past S read zeros and never the next head's rows.  A row of D
//   bf16 is cut into atoms of W = 64 elements (a 128-byte swizzle row;
//   W = 32 and 64-byte rows at D 96), one box per atom: a tile is
//   [D / W][rows][W], swizzled as TMA writes it and wgmma reads it.  The
//   same layout is K-major for S = Q K^T (K's rows are N) and N-major for
//   O += P V (V's rows are k), so K and V go by the same copy.
// - The producer's lane 0 loads Q once (its own mbarrier) and K and V a
//   64-key tile at a time into a ring of two stages, each completed on a
//   `full` mbarrier by the TMA's byte count and released by the
//   consumers' warps on an `empty` one.  Two stages keep a block small
//   enough that an SM holds several (3 at D 64, 2 up to D 128: the
//   launch bounds give ptxas that register budget), whose warpgroups
//   fill each other's softmax with MMAs; more stages in fewer blocks
//   were slower.
// - Consumers: Q is scaled by 1/sqrt(D) in bf16 in shared memory once
//   (rt::scaled_q, as every Pallas entry does; fence.proxy.async before
//   wgmma reads it).  Each tile: S[64, 64] = Q K^T by four (D 64) to
//   sixteen (D 256) wgmma k-steps from shared-memory descriptors into 32
//   f32 registers a thread; masks per element only on edge tiles (the
//   causal diagonal, the window's edge, starts, keys past S); the online
//   softmax in f32 registers (m from rt::kMinFloor, so a masked key
//   gives exactly 0 and l == 0 writes zeros), exp(s - m) as one FFMA and
//   ex2 on the special-function unit (relative error < 2^-22), O's
//   rescale skipped when no row of the warp moved its maximum (a
//   multiplication by 1); then O[64, D] += P V with P
//   in registers as wgmma's A operand (the accumulator's S columns are
//   the A fragment as they lie) and V by descriptor.  p = p_hi + p_lo in
//   bf16, two wgmma per k-step into one f32 accumulator, as in
//   flash_mma_kernel: p rounded once misses the 2-ulp contract.
// - A warpgroup skips the MMAs of a tile none of its rows can see (it
//   still waits for and releases the stage, so the ring stays in step).
// - Within a warpgroup the MMAs and the softmax alternate.  Issuing tile
//   t's Q K^T with tile t - 1's P V and running t's softmax under it
//   (FA3's intra-warpgroup overlap) made ptxas serialize every wgmma of
//   the body (C7510-family notes), and it ran slower.
// - Registers: O is D / 2 f32 a thread (128 at D 256), S 32, P's hi and
//   lo 16 each.  One producer warp, not a warpgroup, leaves 224 registers
//   a thread at two consumer warpgroups (288 threads); at D 256 that is
//   short (ptxas spills and serializes the wgmmas), so D 256 runs best
//   at 64 rows (FlashAttentionSchedule's default), where one warpgroup
//   has 255.
// - Epilogue: O / l rounded to bf16 and stored from registers, rows past
//   S skipped.
// What it leaves out: FA3's ping-pong of two warpgroups (one's softmax
// under the other's MMAs, by named barriers), setmaxnreg for D 256 at
// 128 rows, a TMA store of O, persistent blocks.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {
namespace fw {

namespace hw = rt::hw;
using bf16 = __nv_bfloat16;
constexpr int kKeys = 64;            // keys a K/V tile
constexpr int kStages = 2;          // K/V ring stages
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;

// A head dim's atoms: W elements (a swizzle span of 2 W bytes) a row.
template <int DP>
struct Atoms {
  static constexpr int W = DP % 64 == 0 ? 64 : 32;
  static constexpr int SPAN = 2 * W;
  static constexpr int N = DP / W;
  static constexpr int KPA = W / 16;          // k-steps an atom
};

__host__ __device__ constexpr int q_bytes(int dp, int rows) {
  return rows * dp * 2;
}
__host__ __device__ constexpr int stage_bytes(int dp) {
  return 2 * kKeys * dp * 2;                 // K and V
}
// The alignment pad, Q, the ring and the barriers (kernels/_geometry.py,
// flash_wgmma_tile, computes the same).
__host__ __device__ constexpr int smem_of(int dp, int rows) {
  return 1024 + q_bytes(dp, rows) + kStages * stage_bytes(dp) + 256;
}
// Blocks of one consumer warpgroup an SM should hold, as a register
// budget for ptxas: 3 at D 64 (128 registers a thread), 2 up to D 128;
// D 256 (O alone is 128 registers) and two warpgroups take one.
__host__ __device__ constexpr int min_blocks(int dp, int wg) {
  return wg == 1 ? (dp <= 64 ? 3 : dp <= 128 ? 2 : 1) : 1;
}

struct Args {
  bf16* o;
  const int* starts;
  int B, HQ, HKV, S, D, causal, window;
  float scale;                       // 1/sqrt(D), already rounded to bf16
  int n_qt;                          // query tiles
};

template <int DP, int WG>
__global__ void __launch_bounds__(128 * WG + 32, min_blocks(DP, WG))
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Args a) {
  using AT = Atoms<DP>;
  constexpr int ROWS = 64 * WG;
  constexpr int STAGES = kStages;
  constexpr int QB = q_bytes(DP, ROWS);
  constexpr int SB = stage_bytes(DP);
  constexpr int KVB = kKeys * DP * 2;        // K (or V) of a stage
  constexpr uint32_t LAYOUT = AT::SPAN == 128 ? 1u : 2u;
  constexpr uint32_t SBO = AT::SPAN / 2;     // 8 rows, in 16-byte units
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = sm;
  unsigned char* kv_s = sm + QB;
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + STAGES * SB);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;
  uint64_t* q_bar = bars + 2 * kStages;

  const int bhs = a.B * a.HQ;
  const int qt = a.n_qt - 1 - static_cast<int>(blockIdx.x) / bhs;
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / a.HQ, h = bh % a.HQ;
  const int kvh = h / (a.HQ / a.HKV);
  const int q0 = qt * ROWS;
  const int tid = threadIdx.x;
  const int S = a.S;
  const int start = a.starts ? max(a.starts[b], 0) : 0;
  unsigned short* o_g = reinterpret_cast<unsigned short*>(a.o) +
                        static_cast<size_t>(bh) * S * DP;

  // keys any row of the tile can reach: [lo, hi)
  int lo = start;
  if (a.window > 0) lo = max(lo, q0 - a.window + 1);
  const int hi = a.causal ? min(S, q0 + ROWS) : S;
  if (lo >= hi) {                    // no row has a valid key: zeros
    const int rows = min(ROWS, S - q0);
    for (int i = tid; i < rows * DP; i += blockDim.x)
      o_g[static_cast<size_t>(q0) * DP + i] = 0;
    return;
  }
  const int t_begin = lo / kKeys;
  const int n_tiles = (hi + kKeys - 1) / kKeys - t_begin;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 4 * WG);     // lane 0 of each consumer warp
    }
    hw::mbar_init(q_bar, 1);
    hw::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * WG) {
    // ---------------- producer warp: lane 0 issues every copy
    if (tid != 128 * WG) return;
    hw::mbar_expect_tx(q_bar, QB);
    for (int at = 0; at < AT::N; ++at)
      for (int g = 0; g < WG; ++g)
        hw::tma_load_3d(q_s + (at * ROWS + g * 64) * AT::SPAN, &map_q, q_bar,
                        at * AT::W, q0 + g * 64, bh);
    hw::mbar_arrive(q_bar);
    const int kv_row = b * a.HKV + kvh;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, round = i / STAGES;
      if (round > 0) hw::mbar_wait(&empty[s], (round - 1) & 1);
      unsigned char* ks = kv_s + s * SB;
      const int k0 = (t_begin + i) * kKeys;
      hw::mbar_expect_tx(&full[s], SB);
      for (int at = 0; at < AT::N; ++at) {
        hw::tma_load_3d(ks + at * kKeys * AT::SPAN, &map_k, &full[s],
                        at * AT::W, k0, kv_row);
        hw::tma_load_3d(ks + KVB + at * kKeys * AT::SPAN, &map_v, &full[s],
                        at * AT::W, k0, kv_row);
      }
      hw::mbar_arrive(&full[s]);
    }
    return;
  }

  // ---------------- consumer warpgroup g: query rows q0 + 64 g ..
  const int g = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int gt = tid % 128;
  const int qg = q0 + 64 * g;                // the warpgroup's first row
  const int qw = qg + 16 * warp;             // the warp's first row
  const int r_lane = lane / 4, c_lane = 2 * (lane % 4);

  // ---- Q, scaled in bf16 in place (16-byte units: the swizzle moves
  // whole units, so an element's neighbours stay its neighbours)
  hw::mbar_wait(q_bar, 0);
  for (int u = gt; u < AT::N * 64 * AT::SPAN / 16; u += 128) {
    const int at = u / (64 * AT::SPAN / 16), r = u % (64 * AT::SPAN / 16);
    uint4* p = reinterpret_cast<uint4*>(
        q_s + (at * ROWS + g * 64) * AT::SPAN) + r;
    uint4 x = *p;
    unsigned short* e = reinterpret_cast<unsigned short*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __bfloat16_as_ushort(__float2bfloat16(
          rt::scaled_q(__ushort_as_bfloat16(e[j]), a.scale)));
    *p = x;
  }
  hw::fence_proxy_async();
  hw::named_sync(1 + g, 128);

  const uint32_t q_addr = hw::smem_u32(q_s) + g * 64 * AT::SPAN;
  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  float m_r[2] = {rt::kMinFloor, rt::kMinFloor}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (t_begin + i) * kKeys;
    hw::mbar_wait(&full[s], (i / STAGES) & 1);
    const bool any = qg < S && !(a.causal && k0 > qg + 63) &&
                     k0 + kKeys > start &&
                     !(a.window > 0 && k0 + kKeys - 1 <= qg - a.window);
    if (any) {
      const uint32_t k_addr = hw::smem_u32(kv_s + s * SB);
      const uint32_t v_addr = k_addr + KVB;
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int at = kk / AT::KPA, ko = (kk % AT::KPA) * 32;
        const uint64_t dq = hw::make_desc(q_addr + at * ROWS * AT::SPAN + ko,
                                          1, SBO, LAYOUT);
        const uint64_t dk = hw::make_desc(
            k_addr + at * kKeys * AT::SPAN + ko, 1, SBO, LAYOUT);
        hw::WgmmaKMajor<64>::run(sc, dq, dk);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(sc, 32);
      const bool full_tile = (!a.causal || k0 + kKeys - 1 <= qw) &&
                             k0 >= start && k0 + kKeys <= S &&
                             (a.window <= 0 || k0 > qw + 15 - a.window);
      if (!full_tile) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + c_lane + (e & 1);
            const int qp = qw + r_lane + 8 * (e >> 1);
            const bool ok = kp < S && kp >= start &&
                            (!a.causal || kp <= qp) &&
                            (a.window <= 0 || kp > qp - a.window);
            if (!ok) sc[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2], ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = hw::ex2((m_r[r] - mx[r]) * kLog2e);
        m_r[r] = mx[r];
        l_r[r] *= alpha[r];
        ml[r] = mx[r] * kLog2e;
      }
      // O keeps its scale unless a row's maximum moved (exact: x 1)
      if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o_acc[4 * j + e] *= alpha[e >> 1];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        sc[j] = hw::ex2(fmaf(sc[j], kLog2e, -ml[(j >> 1) & 1]));
        l_r[(j >> 1) & 1] += sc[j];
      }
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* s0 = sc + 8 * kk;
        ph[kk][0] = hw::split_pair(s0[0], s0[1], pl[kk][0]);
        ph[kk][1] = hw::split_pair(s0[2], s0[3], pl[kk][1]);
        ph[kk][2] = hw::split_pair(s0[4], s0[5], pl[kk][2]);
        ph[kk][3] = hw::split_pair(s0[6], s0[7], pl[kk][3]);
      }
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = hw::make_desc(
            v_addr + kk * 16 * AT::SPAN, kKeys * AT::SPAN / 16, SBO, LAYOUT);
        hw::WgmmaRegA<DP>::run(o_acc, ph[kk], dv);
        hw::WgmmaRegA<DP>::run(o_acc, pl[kk], dv);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(o_acc, DP / 2);
      hw::fence_regs(&ph[0][0], 16);
      hw::fence_regs(&pl[0][0], 16);
    }
    __syncwarp();
    if (lane == 0) hw::mbar_arrive(&empty[s]);
  }
  // ---- epilogue: 1/l, bf16, stored from registers
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    l_r[r] = l_r[r] > 0.f ? 1.f / l_r[r] : 0.f;   // fully masked -> zeros
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qw + r_lane + 8 * r;
    if (qp >= S) continue;
    unsigned short* orow = o_g + static_cast<size_t>(qp) * DP;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + c_lane) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * r] * l_r[r],
                                o_acc[4 * j + 2 * r + 1] * l_r[r]);
  }
}

// Q, K or V as a 3-D map [heads][S][DP], box [1][64][W].
template <int DP>
bool map_of(CUtensorMap* map, const void* base, int heads, int S) {
  using AT = Atoms<DP>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DP),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DP) * 2,
                                 static_cast<cuuint64_t>(S) * DP * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(AT::W), 64, 1};
  return hw::make_map_bf16(map, base, 3, dims, strides, box, AT::SPAN);
}

template <int DP, int WG>
cudaError_t launch(const void* q, const void* k, const void* v, Args a,
                   cudaStream_t stream) {
  constexpr int smem = smem_of(DP, 64 * WG);
  static_assert(smem <= kSmemLimit, "flash_wgmma tile over 227 KB");
  CUtensorMap mq{}, mk{}, mv{};
  if (!map_of<DP>(&mq, q, a.B * a.HQ, a.S) ||
      !map_of<DP>(&mk, k, a.B * a.HKV, a.S) ||
      !map_of<DP>(&mv, v, a.B * a.HKV, a.S))
    return cudaErrorInvalidValue;
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(flash_wgmma_kernel<DP, WG>), smem);
  if (attr != cudaSuccess) return attr;
  a.n_qt = (a.S + 64 * WG - 1) / (64 * WG);
  const long long blocks = static_cast<long long>(a.B) * a.HQ * a.n_qt;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_wgmma_kernel<DP, WG><<<static_cast<unsigned>(blocks), 128 * WG + 32,
                               smem, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const Args& a, int rows, cudaStream_t stream) {
  if (rows == 64) return launch<DP, 1>(q, k, v, a, stream);
  if (rows == 128) return launch<DP, 2>(q, k, v, a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fw
}  // namespace

// The bf16 body at the models' head dims (kernels/_geometry.py,
// flash_body): D in {64, 96, 128, 256}, every base 16-byte aligned
// (TMA), `rows` 64 or 128 and `keys` 64 (the FlashAttentionSchedule's
// tile); anything else is refused, never run on another body.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o,
                                         const void* starts, int B, int HQ,
                                         int HKV, int S, int D, int causal,
                                         int window, float scale, int rows,
                                         int keys, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
      reinterpret_cast<uintptr_t>(o);
  if (HKV < 1 || HQ % HKV != 0 || S < 1 || B < 1 || keys != fw::kKeys ||
      bases % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fw::Args a{static_cast<__nv_bfloat16*>(o), static_cast<const int*>(starts),
             B, HQ, HKV, S, D, causal, window, scale, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(fw::launch_rows<64>(q, k, v, a, rows, st));
    case 96: return static_cast<int>(fw::launch_rows<96>(q, k, v, a, rows, st));
    case 128: return static_cast<int>(fw::launch_rows<128>(q, k, v, a, rows, st));
    case 256: return static_cast<int>(fw::launch_rows<256>(q, k, v, a, rows, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
