// Causal (optionally sliding-window) flash attention for prefill, with
// per-row `starts` masking of a left-padded batch and GQA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (bodies _flash_kernel, _flash_kernel_starts).
// Bound on an H100: bytes.  At the engine's prefill lengths (S <= 512,
//   D = 96) causal attention does about S/2 * 4 * D operations per query
//   row against 8 * D bytes of Q, K, V and O per row, far below the
//   card's ~295 operations per byte, so moving Q/K/V/O once is the floor.
// Two bodies, chosen by dtype (kernels/_geometry.py, tensor_cores):
//
// bfloat16: flash_mma_kernel<DP, ROWS>, FlashAttention-2 on mma.sync.m16n8k16
//   (bf16 in, f32 accumulate), D padded to DP, a multiple of 16 (of 32
//   above 128), up to 256.
//   - Block: 16 query rows a warp, ROWS = 64 (4 warps, the default) or
//     128 (8 warps) a block, a template parameter the wrapper takes from
//     a FlashAttentionSchedule's block_q; a warp's code is the same at
//     both.  128 rows halve the blocks (and K/V staged per query row) at
//     the cost of parallelism: 256 -> 128 blocks at a 512-token prefill
//     of 32 heads, against 132 SMs.  The grid runs
//     the query tiles with the most reachable keys first (the last ones,
//     under the causal mask), which shortens the tail; a tile whose rows
//     all lie below `starts` writes zeros and exits.
//   - Q: loaded once, scaled by 1/sqrt(D) in bf16 as every Pallas entry
//     does (rt::scaled_q), and kept in registers as A fragments (DP / 16
//     k-steps) up to DP 128.  Above it (DP 160, 192, 224, 256: D pads to
//     32 there) the O accumulator alone is DP / 2 f32 a thread, so Q's
//     fragments are re-read from its shared tile by ldmatrix for each KV
//     tile instead (a warp reads only its own 16 rows, which the
//     epilogue later overwrites with O).
//   - K and V: 64-key tiles of bf16 in shared memory, rows padded by 8
//     elements (an odd number of 16-byte units: ldmatrix's eight rows hit
//     distinct banks), double-buffered with cp.async so tile t + 1 is in
//     flight while tile t multiplies; keys past S read as zeros.  Rows
//     that are not 16-byte multiples (D % 8 != 0) or unaligned bases are
//     staged through registers into the same layout.  Only the tiles the
//     causal, window and starts masks can reach are visited; a warp skips
//     a tile none of its rows can see, and masks per element only on the
//     diagonal and edge tiles.
//   - S = Q K^T: K's rows by ldmatrix (K is [key][d], the col-major B of
//     row.col), f32 accumulators.  Online softmax in f32 registers: the
//     row max by quad shuffles, m starting at rt::kMinFloor so a masked
//     key gives exactly 0, l == 0 -> zeros.
//   - P V: the S accumulators become the A fragments in registers (no
//     shared-memory round trip), V by ldmatrix.trans.  The Pallas kernel
//     and the plain version multiply P V in f32 with p never rounded; a
//     p rounded to bf16 once adds up to 2^-9 of each term, which breaks
//     the 2-ulp contract where |o| cancels against |v|.  So p = p_hi +
//     p_lo, both bf16, in two MMAs into one f32 accumulator: p is kept to
//     ~2^-17, for twice the P V MMAs (small beside the staging here).
//   - Epilogue: scaled by 1/l, rounded to bf16, stored through shared
//     memory as 16-byte rows.
//   Why mma.sync and not wgmma: the engine's prefills are <= 512 tokens,
//   so a block sees at most 8 KV tiles and its time is latency and
//   staging, not the MMA rate.  A wgmma/TMA design (one warpgroup's
//   64-row tile per instruction, K and V by TMA into swizzled stages, a
//   producer warp, softmax overlapped with the next tile's MMAs, as
//   FlashAttention-3 does) would pay off on long prompts.
//
// float32: flash_fwd_kernel, on the CUDA cores in IEEE fp32 (the tensor
//   cores do only TF32 on float32): 256 threads, four threads per query
//   row, each owning a contiguous quarter of the head dimension in
//   registers (q and the f32 accumulator).  The block walks only the
//   32-key tiles that its causal / window / starts mask can reach, stages
//   each K and V tile in dynamic shared memory as f32 rows of 4 * DPT
//   (64 KB at D 256, past the 48 KB static limit: opted into with
//   cudaFuncSetAttribute), read with 16-byte vector loads, and keeps
//   the online softmax statistics m and l in f32 registers.  GQA reads
//   the KV head h / group directly; no repeated K/V is ever written.  S
//   need not be a multiple of a tile: keys and queries past S are masked
//   in the kernel.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 32;       // keys per shared-memory tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int DMAX = 256;

template <int DPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ starts, int HQ, int HKV, int S,
                 int D, int causal, int window, float scale) {
  constexpr int W = TPR * DPT;     // a staged row, >= D
  extern __shared__ __align__(16) float f32_smem[];
  float (*ks)[W] = reinterpret_cast<float (*)[W]>(f32_smem);
  float (*vs)[W] = reinterpret_cast<float (*)[W]>(f32_smem + BKV * W);

  const int bh = blockIdx.x;
  const int b = bh / HQ;
  const int h = bh % HQ;
  const int kvh = h / (HQ / HKV);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int t = tid % TPR;
  const int d0 = t * DPT;          // this thread's slice [d0, d0 + DPT)
  const int qpos = q0 + row;
  const bool qvalid = qpos < S;
  const int start = starts ? starts[b] : 0;

  // Columns past D stay zero for the whole kernel, so the vector loads
  // below need no guard on D.
  for (int idx = tid; idx < BKV * W; idx += THREADS) {
    const int j = idx / W, d = idx % W;
    if (d >= D) { ks[j][d] = 0.f; vs[j][d] = 0.f; }
  }

  float qr[DPT], acc[DPT];
  const float* qp = q + ((size_t)bh * S + (qvalid ? qpos : 0)) * D;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = d0 + i;
    qr[i] = (qvalid && d < D) ? rt::scaled_q(qp[d], scale) : 0.f;
    acc[i] = 0.f;
  }
  float m = rt::kMinFloor, l = 0.f;

  // Key range any row of this tile can reach.
  int lo = start;
  if (window > 0) lo = max(lo, q0 - window + 1);
  lo = max(lo, 0);
  const int hi = causal ? min(S, q0 + BQ) : S;   // exclusive
  const size_t kv_off = (size_t)(b * HKV + kvh) * S * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  for (int k0 = (lo / BKV) * BKV; k0 < hi; k0 += BKV) {
    __syncthreads();
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < S) {
        kx = rt::to_f(kb[(size_t)kp * D + d]);
        vx = rt::to_f(vb[(size_t)kp * D + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float s[BKV];
    float mt = rt::kMinFloor;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; i += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d0 + i]);
        part += qr[i] * kk.x + qr[i + 1] * kk.y + qr[i + 2] * kk.z +
                qr[i + 3] * kk.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = k0 + j;
      const bool ok = qvalid && kp < S && kp >= start &&
                      (!causal || kp <= qpos) &&
                      (window <= 0 || kp > qpos - window);
      s[j] = ok ? part : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
      s[j] = expf(s[j] - m_new);   // exactly 0 for a masked key
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BKV; ++j) {
#pragma unroll
      for (int i = 0; i < DPT; i += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d0 + i]);
        acc[i] += s[j] * vv.x;
        acc[i + 1] += s[j] * vv.y;
        acc[i + 2] += s[j] * vv.z;
        acc[i + 3] += s[j] * vv.w;
      }
    }
    m = m_new;
  }

  if (qvalid) {
    const float inv = l > 0.f ? 1.f / l : 0.f;   // fully masked -> zeros
    float* op = o + ((size_t)bh * S + qpos) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = d0 + i;
      if (d < D) op[d] = acc[i] * inv;
    }
  }
}

template <int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* starts, int B, int HQ, int HKV, int S, int D,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * BKV * TPR * DPT * 4;
  const cudaError_t attr = rt::hw::smem_opt_in(
      reinterpret_cast<const void*>(flash_fwd_kernel<DPT>), smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid(B * HQ, (S + BQ - 1) / BQ);
  flash_fwd_kernel<DPT><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), starts, HQ, HKV,
      S, D, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const int* starts, int B, int HQ, int HKV, int S,
                     int D, int causal, int window, float scale,
                     cudaStream_t stream) {
  const int per = (D + TPR - 1) / TPR;
  if (per <= 4)
    return launch<4>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 8)
    return launch<8>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 16)
    return launch<16>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 24)
    return launch<24>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 32)
    return launch<32>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 48)
    return launch<48>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  return launch<64>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
}


// ---- bf16: FlashAttention-2 on the tensor cores
namespace fa {

namespace hw = rt::hw;
using bf16 = __nv_bfloat16;
constexpr int kKeys = 64;        // keys a K/V tile
// threads of a block of `rows` query rows: one warp per 16 rows
__host__ __device__ constexpr int threads_of(int rows) {
  return rows / 16 * 32;
}

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* starts;
  int B, HQ, HKV, S, D, causal, window;
  float scale;                   // 1/sqrt(D), already rounded to bf16
  int n_qt;                      // query tiles
  int vec;                       // 1: rows are 16-byte multiples at 16-byte
                                 // aligned bases (cp.async, 16-byte stores)
};

// Shared memory of a (DP, rows) body: the Q (later O) tile [rows][DP + 8]
// and two stages of K and V, each [64][DP + 8] bf16
// (kernels/_geometry.py, flash_mma_tile, computes the same).
__host__ __device__ constexpr int smem_bytes(int dp, int rows) {
  return (rows + 4 * kKeys) * (dp + 8) * 2;
}

// (p0, p1) as bf16x2 hi and lo parts: p = hi + lo to ~2^-17.
__device__ __forceinline__ uint32_t split_pair(float p0, float p1,
                                               uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DP, int ROWS>
__global__ void __launch_bounds__(threads_of(ROWS))
flash_mma_kernel(const FlashArgs a) {
  constexpr int KD = DP / 16;      // k-steps of Q K^T, d pairs of P V
  constexpr int ND = DP / 8;       // n8 tiles of O
  constexpr bool QS = DP > 128;    // Q's fragments re-read from shared
  constexpr int STR = DP + 8;      // row stride in elements
  constexpr int QTILE = ROWS * STR;
  constexpr int TILE = kKeys * STR;
  constexpr int kThreads = threads_of(ROWS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qo_s = reinterpret_cast<bf16*>(smem_raw);     // Q, then O
  bf16* kv_s = qo_s + QTILE;                          // [stage][K, V]

  const int bhs = a.B * a.HQ;
  const int qt = a.n_qt - 1 - static_cast<int>(blockIdx.x) / bhs;
  const int bh = static_cast<int>(blockIdx.x) % bhs;
  const int b = bh / a.HQ, h = bh % a.HQ;
  const int kvh = h / (a.HQ / a.HKV);
  const int q0 = qt * ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = a.D, S = a.S;
  const int start = a.starts ? max(a.starts[b], 0) : 0;
  const int rows = min(ROWS, S - q0);
  unsigned short* o_g = reinterpret_cast<unsigned short*>(a.o) +
                        (static_cast<size_t>(bh) * S + q0) * D;

  // keys any row of the tile can reach: [lo, hi)
  int lo = start;
  if (a.window > 0) lo = max(lo, q0 - a.window + 1);
  const int hi = a.causal ? min(S, q0 + ROWS) : S;
  if (lo >= hi) {                  // no row has a valid key: zeros
    for (int i = tid; i < rows * D; i += kThreads) o_g[i] = 0;
    return;
  }

  // padded columns D .. DP-1 of every tile stay zero
  if (D < DP)
    for (int i = tid; i < (ROWS + 4 * kKeys) * (DP - D); i += kThreads)
      qo_s[(i / (DP - D)) * STR + D + i % (DP - D)] = __float2bfloat16(0.f);

  // ---- Q, scaled in bf16, into shared memory and then registers
  const unsigned short* q_g = reinterpret_cast<const unsigned short*>(a.q) +
                              (static_cast<size_t>(bh) * S + q0) * D;
  unsigned short* q_s = reinterpret_cast<unsigned short*>(qo_s);
  const bf16 zero = __float2bfloat16(0.f);
  auto scaled = [&](unsigned short x) {
    return __bfloat16_as_ushort(__float2bfloat16(
        rt::scaled_q(__ushort_as_bfloat16(x), a.scale)));
  };
  if (a.vec) {
    const int cpr = D / 8;
    for (int u = tid; u < ROWS * cpr; u += kThreads) {
      const int r = u / cpr, c = u % cpr;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < rows) {
        x = *reinterpret_cast<const uint4*>(q_g + r * D + 8 * c);
        unsigned short* e = reinterpret_cast<unsigned short*>(&x);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = scaled(e[j]);
      }
      *reinterpret_cast<uint4*>(q_s + r * STR + 8 * c) = x;
    }
  } else {
    for (int i = tid; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      q_s[r * STR + c] = r < rows ? scaled(q_g[r * D + c])
                                  : __bfloat16_as_ushort(zero);
    }
  }

  // ---- K and V tiles: rows k0 .. k0+63 into stage `st`
  const size_t kv_off = static_cast<size_t>(b * a.HKV + kvh) * S * D;
  const unsigned short* k_g =
      reinterpret_cast<const unsigned short*>(a.k) + kv_off;
  const unsigned short* v_g =
      reinterpret_cast<const unsigned short*>(a.v) + kv_off;
  auto stage = [&](int st, int k0) {
    unsigned short* ks = reinterpret_cast<unsigned short*>(kv_s) +
                         st * 2 * TILE;
    if (a.vec) {
      const int cpr = D / 8;
      for (int u = tid; u < 2 * kKeys * cpr; u += kThreads) {
        const int m = u / (kKeys * cpr), r = (u / cpr) % kKeys, c = u % cpr;
        const bool in = k0 + r < S;
        const unsigned short* src =
            (m ? v_g : k_g) + static_cast<size_t>(in ? k0 + r : 0) * D + 8 * c;
        hw::cp_async_16(hw::smem_u32(ks + m * TILE + r * STR + 8 * c), src,
                        in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < 2 * kKeys * D; i += kThreads) {
        const int m = i / (kKeys * D), r = (i / D) % kKeys, c = i % D;
        ks[m * TILE + r * STR + c] =
            k0 + r < S ? (m ? v_g : k_g)[static_cast<size_t>(k0 + r) * D + c]
                       : static_cast<unsigned short>(0);
      }
    }
  };

  const int t_begin = lo / kKeys, t_end = (hi + kKeys - 1) / kKeys;
  stage(0, t_begin * kKeys);
  hw::cp_async_commit();
  __syncthreads();                 // Q and the padded columns are in place

  // lane's ldmatrix address of Q's k-step kk
  const uint32_t q_lane = hw::smem_u32(qo_s) +
      ((warp * 16 + (lane & 15)) * STR + (lane >> 4) * 8) * 2;
  uint32_t qf[QS ? 1 : KD][4];
  if constexpr (!QS) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) hw::ldmatrix_x4(qf[kk], q_lane + kk * 32);
  }

  float o_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m_r[2] = {rt::kMinFloor, rt::kMinFloor}, l_r[2] = {0.f, 0.f};
  const int qw = q0 + warp * 16;             // the warp's first row
  const int g = lane / 4, qd = lane % 4;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKeys;
    const int st = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage(st ^ 1, k0 + kKeys);
      hw::cp_async_commit();
      hw::cp_async_wait<1>();
    } else {
      hw::cp_async_wait<0>();
    }
    __syncthreads();

    // does any row of this warp see a key of the tile?
    const bool any = qw < S && !(a.causal && k0 > qw + 15) &&
                     k0 + kKeys > start &&
                     !(a.window > 0 && k0 + kKeys - 1 <= qw - a.window);
    if (any) {
      // every key of the tile valid for every row of the warp: no mask
      const bool full = (!a.causal || k0 + kKeys - 1 <= qw) &&
                        k0 >= start && k0 + kKeys <= S &&
                        (a.window <= 0 || k0 > qw + 15 - a.window);
      const uint32_t kb = hw::smem_u32(kv_s + st * 2 * TILE);
      const uint32_t vb = kb + TILE * 2;

      // ---- S = Q K^T, [16 rows][64 keys] a warp
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint32_t* qa = qf[QS ? 0 : kk];
        if constexpr (QS) hw::ldmatrix_x4(qf[0], q_lane + kk * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          hw::ldmatrix_x4(kf, kb + ((np * 16 + (lane >> 4) * 8 +
                                     (lane & 7)) * STR + kk * 16 +
                                    ((lane >> 3) & 1) * 8) * 2);
          hw::mma_16816(s[2 * np], qa, kf[0], kf[1]);
          hw::mma_16816(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }
      if (!full) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * qd + (e & 1);
            const int qp = qw + g + 8 * (e >> 1);
            const bool ok = kp < S && kp >= start &&
                            (!a.causal || kp <= qp) &&
                            (a.window <= 0 || kp > qp - a.window);
            if (!ok) s[j][e] = -INFINITY;
          }
      }

      // ---- online softmax, rows g and g + 8 of the warp
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float alpha = expf(m_r[i] - mx[i]);
        m_r[i] = mx[i];
        l_r[i] *= alpha;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o_acc[j][2 * i] *= alpha;
          o_acc[j][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m_r[e >> 1]);   // exactly 0 if masked
          l_r[e >> 1] += s[j][e];
        }

      // ---- O += P V, p split into bf16 hi + lo
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        ph[0] = split_pair(s[2 * kk][0], s[2 * kk][1], pl[0]);
        ph[1] = split_pair(s[2 * kk][2], s[2 * kk][3], pl[1]);
        ph[2] = split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], pl[2]);
        ph[3] = split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < KD; ++dp) {
          uint32_t vf[4];
          hw::ldmatrix_x4_trans(
              vf, vb + ((kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * STR +
                        dp * 16 + (lane >> 4) * 8) * 2);
          hw::mma_16816(o_acc[2 * dp], ph, vf[0], vf[1]);
          hw::mma_16816(o_acc[2 * dp], pl, vf[0], vf[1]);
          hw::mma_16816(o_acc[2 * dp + 1], ph, vf[2], vf[3]);
          hw::mma_16816(o_acc[2 * dp + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();               // the stage is free for tile t + 2
  }

  // ---- epilogue: 1/l, bf16, through this warp's rows of the O tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    l_r[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;   // fully masked -> zeros
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(
          qo_s + (warp * 16 + g + 8 * i) * STR + 8 * j + 2 * qd) =
          __floats2bfloat162_rn(o_acc[j][2 * i] * l_r[i],
                                o_acc[j][2 * i + 1] * l_r[i]);
  __syncwarp();
  const int r0 = warp * 16, wrows = min(16, rows - r0);
  const unsigned short* os = reinterpret_cast<const unsigned short*>(qo_s);
  if (a.vec) {
    const int cpr = D / 8;
    for (int u = lane; u < wrows * cpr; u += 32) {
      const int r = r0 + u / cpr, c = u % cpr;
      *reinterpret_cast<uint4*>(o_g + r * D + 8 * c) =
          *reinterpret_cast<const uint4*>(os + r * STR + 8 * c);
    }
  } else {
    for (int i = lane; i < wrows * D; i += 32) {
      const int r = r0 + i / D, c = i % D;
      o_g[r * D + c] = os[r * STR + c];
    }
  }
}

template <int DP, int ROWS>
cudaError_t launch(FlashArgs a, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be opted into, at
  // this instance's own size
  constexpr int smem = smem_bytes(DP, ROWS);
  static_assert(smem <= 232448, "flash tile over 227 KB");
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(flash_mma_kernel<DP, ROWS>), smem);
  if (attr != cudaSuccess) return attr;
  a.n_qt = (a.S + ROWS - 1) / ROWS;
  const long long blocks = static_cast<long long>(a.B) * a.HQ * a.n_qt;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_mma_kernel<DP, ROWS><<<static_cast<unsigned>(blocks),
                               threads_of(ROWS), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_rows(const FlashArgs& a, int rows, cudaStream_t stream) {
  if (rows == 64) return launch<DP, 64>(a, stream);
  if (rows == 128) return launch<DP, 128>(a, stream);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const int* starts, int B, int HQ, int HKV, int S,
                     int D, int causal, int window, float scale, int rows,
                     cudaStream_t stream) {
  FlashArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<bf16*>(o), starts,
              B, HQ, HKV, S, D, causal, window, scale, 0, 0};
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
      reinterpret_cast<uintptr_t>(o);
  a.vec = D % 8 == 0 && bases % 16 == 0;
  switch ((D + 15) / 16) {
    case 1: return launch_rows<16>(a, rows, stream);
    case 2: return launch_rows<32>(a, rows, stream);
    case 3: return launch_rows<48>(a, rows, stream);
    case 4: return launch_rows<64>(a, rows, stream);
    case 5: return launch_rows<80>(a, rows, stream);
    case 6: return launch_rows<96>(a, rows, stream);
    case 7: return launch_rows<112>(a, rows, stream);
    case 8: return launch_rows<128>(a, rows, stream);
    case 9: case 10: return launch_rows<160>(a, rows, stream);
    case 11: case 12: return launch_rows<192>(a, rows, stream);
    case 13: case 14: return launch_rows<224>(a, rows, stream);
    case 15: case 16: return launch_rows<256>(a, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fa

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* starts, int B, int HQ,
                                   int HKV, int S, int D, int causal,
                                   int window, float scale, int is_bf16,
                                   int rows, int keys, void* stream) {
  if (D < 1 || D > DMAX || HKV < 1 || HQ % HKV != 0 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the bodies' tiles (kernels/_geometry.py, flash_tile_error): bf16
  // 64 or 128 rows at 64 keys, float32 its single BQ x BKV tile
  if (is_bf16 ? keys != fa::kKeys : (rows != BQ || keys != BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  cudaError_t err =
      is_bf16 ? fa::dispatch(q, k, v, o, sp, B, HQ, HKV, S, D, causal, window, scale, rows, st)
              : dispatch(q, k, v, o, sp, B, HQ, HKV, S, D, causal, window, scale, st);
  return static_cast<int>(err);
}
