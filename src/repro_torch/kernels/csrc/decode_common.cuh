// Single-query flash decode shared by the contiguous and the paged
// kernels, split across blocks along the keys (flash-decoding).
//
// Bound on an H100: bytes.  A decode step does 4 * D operations per
// (query head, key) against 4 * D bytes of bf16 K and V per (KV head,
// key), about one operation per byte, so the floor is the valid K/V
// window over the 3.35 TB/s memory rate.  Reaching it takes many bytes
// in flight on every SM: one block per (row, KV head) walking its whole
// window alone leaves ~128 blocks of dependent round trips on 132 SMs
// at the main shapes, so the keys are split across blocks.
//
// Design (the plan is kernels/_geometry.py, decode_plan, fixed by static
// shapes only, so the launch never depends on pos/starts and no host
// sync is needed):
// - Grid (B * HKV * chunks, splits).  Block x serves one (row, KV head)
//   and a chunk of at most DEC_MAX_HEADS of that KV group's query heads;
//   block y owns keys [y * SK, (y + 1) * SK) of the row and walks their
//   valid part [max(lo, y SK), min(hi, y SK + SK - 1)] in tiles of TK
//   keys.  Keys outside the row's window are never read.  The live
//   splits of a row, those holding a valid key, are lo / SK .. hi / SK,
//   which every block of the row computes from pos and starts; a split
//   outside them exits at once, without a partial or a ticket (empty
//   partials would make the merge wait on loads of every split and keep
//   dead blocks in SM slots).  A row with no
//   valid key is written as zeros by its split 0.  Paged splits are
//   whole pool blocks: the split's table entries are read once into
//   shared memory, and blocks past pos[b] are never touched.
// - q of the chunk sits in shared memory as f32 (scaled in q's dtype,
//   rt::scaled_q), not in registers: a group of 16 at D 256 would need
//   4,096 floats, so registers would cap the group; shared memory takes
//   any group.  The plan's head chunks (<= 8 heads, and <= 512 outputs
//   where the group allows, so 4 a thread) bound a block's work: 16
//   heads of 256 run as 8 chunks of 2, each re-reading its split's K/V
//   (from L2 after the first).
// - Staging: each tile's K and V rows are copied into shared memory by
//   cp.async, 16 bytes a thread, all of the tile in flight at once, K
//   and V in two groups so the scores and the softmax run while V is in
//   flight (rows that are not 16-byte multiples, or unaligned bases, are
//   copied element by element into the same layout).  A staged row is an odd
//   number of 16-byte units, so the eight rows a quarter-warp reads with
//   16-byte loads fall on distinct banks.
// - Lane mapping: scores take keys across threads (a power-of-two group
//   of threads shares a key's dot product when the tile has fewer pairs
//   than threads, reduced by shuffles), because a key row is then read
//   as whole 16-byte vectors; P V takes D across threads (thread owns
//   outputs (g, d) = o * 128 + tid), because each output then sums its
//   own column with no reduction.  f32 online softmax per head across
//   the split's tiles, one warp a head.
// - Merge in the same launch: each live split writes (m, l, acc) of its
//   heads to an f32 workspace and, after a block barrier, takes a ticket
//   (one GPU-scope acquire-release atomicAdd on its grid row's counter,
//   which publishes the block's stores); the block that draws the last
//   ticket resets the counter to 0 and merges: M = max m_i, then sum l_i
//   exp(m_i - M) and acc_i exp(m_i - M), divided by the sum of l once,
//   each output loading DEC_MERGE (4) splits' partials at a time, one
//   L2 round trip a batch.  A row with one live split writes its output
//   directly.  The ticket counters persist between calls (zeroed once
//   by the wrapper), so two launches that may run at the same time, on
//   two streams, must not share them: one launch's blocks would draw the
//   other's tickets, and a row would merge before all of its splits
//   were written.
#pragma once
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace rt {

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_DMAX = 256;
constexpr int DEC_MAX_HEADS = 8;
// outputs (g, d) a thread owns at most
constexpr int DEC_ACC = DEC_MAX_HEADS * DEC_DMAX / DEC_THREADS;
constexpr int DEC_STATS_BYTES = (3 * DEC_MAX_HEADS + 4) * 4;
constexpr int DEC_SMEM_MAX = 232448;
// live splits the merge loads at once: at 8, the batch's 24 loads took
// the body to 128 registers a thread instead of 80 (four blocks an SM
// instead of six; the main shapes ran ~10% slower on an H100)
constexpr int DEC_MERGE = 4;

__host__ __device__ inline int dec_align16(int x) { return (x + 15) / 16 * 16; }

// Byte offsets of a block's shared memory (kernels/_geometry.py,
// dec_smem, computes the same total).
struct DecLayout {
  int units;       // 16-byte units of a staged K/V row (odd)
  int v, q, p, stats, table, bytes;
};

__host__ __device__ inline DecLayout dec_layout(int D, int eb, int TK,
                                                int HC, int n_tab) {
  DecLayout L;
  L.units = ((D * eb + 15) / 16) | 1;
  const int kv = TK * L.units * 16;
  L.v = kv;
  L.q = 2 * kv;
  L.p = L.q + HC * L.units * 16 / eb * 4;
  L.stats = L.p + dec_align16(HC * TK * 4);
  L.table = L.stats + DEC_STATS_BYTES;
  L.bytes = L.table + dec_align16(4 * n_tab);
  return L;
}

// K/V addressing of a contiguous cache [B, HKV, S, D]: the row index of
// key kp of (b, h).
template <typename T>
struct ContigKV {
  const T* k;
  const T* v;
  int HKV, S;
  __host__ __device__ int limit() const { return S; }
  __device__ __forceinline__ void load_table(int*, int, int, int) const {}
  __device__ __forceinline__ size_t row(int b, int h, int kp, const int*,
                                        int) const {
    return ((size_t)b * HKV + h) * S + kp;
  }
};

// K/V addressing of a block-paged pool [NB, HKV, bs, D] through the
// row's block table [B, MB]: the split reads the entries of its blocks
// klo / bs .. khi / bs into shared memory once (what the TPU kernel's
// scalar prefetch did), and rows are found through them.
template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  const int* tables;
  int HKV, bs, MB;
  __host__ __device__ int limit() const { return MB * bs; }
  __device__ __forceinline__ void load_table(int* tb, int b, int klo,
                                             int khi) const {
    const int first = klo / bs;
    for (int i = threadIdx.x; i <= khi / bs - first; i += DEC_THREADS)
      tb[i] = tables[(size_t)b * MB + first + i];
  }
  __device__ __forceinline__ size_t row(int b, int h, int kp,
                                        const int* tb, int klo) const {
    return ((size_t)tb[kp / bs - klo / bs] * HKV + h) * bs + kp % bs;
  }
};

struct DecArgs {
  const void* q;         // [B, HQ, D]
  void* o;               // [B, HQ, D]
  const int* pos;        // [B]
  const long long* starts;  // [B], or null
  float* ws;             // [rows, splits, HC, D + 2] partials (splits > 1)
  int* tickets;          // [rows], zero between calls
  int HQ, HKV, D;
  int TK, SK, HC, chunks, n_tab;
  float scale;           // 1/sqrt(D), already rounded to T
  int vec;               // rows are 16-byte multiples at aligned bases
};

// 16 bytes of a staged K row against the matching f32 q values.
__device__ __forceinline__ float dot16(const __nv_bfloat16* k,
                                       const float* q) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4 q0 = *reinterpret_cast<const float4*>(q);
  const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  return q0.x * a.x + q0.y * a.y + q0.z * b.x + q0.w * b.y +
         q1.x * c.x + q1.y * c.y + q1.z * d.x + q1.w * d.y;
}

__device__ __forceinline__ float dot16(const float* k, const float* q) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  const float4 b = *reinterpret_cast<const float4*>(q);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// atomicAdd at GPU scope with acquire-release order: after a
// __syncthreads, one thread's release publishes every thread's earlier
// stores, and its acquire orders the block's later loads (with a second
// __syncthreads) after the other blocks' stores.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// x, with its value hidden from the optimizer.  With the tile count and
// the tile's key count visible, nvcc's loop analysis of the tile loop
// below ran for minutes without ending (cicc at -O2 and -O3); hidden,
// each instance compiles in seconds.
__device__ __forceinline__ int opaque_int(int x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

// Valid keys of row b: lo <= kp <= hi with lo = starts[b] (0 without
// starts) and hi = min(pos[b], limit - 1).
template <typename T, typename KV>
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_kernel(const DecArgs a, const KV kv) {
  constexpr int VE = 16 / sizeof(T);      // elements of a 16-byte unit
  extern __shared__ __align__(16) unsigned char smem[];
  const DecLayout L = dec_layout(a.D, sizeof(T), a.TK, a.HC, a.n_tab);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L.v);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + DEC_MAX_HEADS;
  float* al_s = l_s + DEC_MAX_HEADS;
  int* last_s = reinterpret_cast<int*>(al_s + DEC_MAX_HEADS);
  int* tb = reinterpret_cast<int*>(smem + L.table);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D;
  const int STR = L.units * VE;           // staged row, in elements
  const int rc = blockIdx.x;
  const int chunk = rc % a.chunks, bh = rc / a.chunks;
  const int b = bh / a.HKV, kvh = bh % a.HKV;
  const int group = a.HQ / a.HKV;
  const int hc = min(a.HC, group - chunk * a.HC);   // heads of this chunk
  const size_t q_row = (size_t)b * a.HQ + kvh * group + chunk * a.HC;
  const int split = blockIdx.y, n_split = gridDim.y;

  // pos, starts and q are loaded together: one round trip, not two
  const int pos_b = a.pos[b];
  const int lo =
      a.starts ? static_cast<int>(min(max(a.starts[b], 0LL), 2147483647LL))
               : 0;
  const T* qg = static_cast<const T*>(a.q);
  for (int i = tid; i < hc * STR; i += DEC_THREADS) {
    const int g = i / STR, d = i % STR;
    qs[i] = d < D ? scaled_q(qg[(q_row + g) * D + d], a.scale) : 0.f;
  }
  const int hi = min(pos_b, kv.limit() - 1);
  // the row's live splits, first .. last: those holding a valid key
  const int first = lo / a.SK, last = hi / a.SK;
  const int n_live = lo <= hi ? last - first + 1 : 0;
  T* og = static_cast<T*>(a.o);
  if (n_live == 0) {                      // no valid key: zeros
    if (split == 0)
      for (int i = tid; i < hc * D; i += DEC_THREADS)
        og[q_row * D + i] = from_f<T>(0.f);
    return;
  }
  if (split < first || split > last) return;   // nothing to read
  const int klo = max(lo, split * a.SK);
  const int khi = min(hi, split * a.SK + a.SK - 1);

  float acc[DEC_ACC];
#pragma unroll
  for (int o = 0; o < DEC_ACC; ++o) acc[o] = 0.f;
  if (tid < DEC_MAX_HEADS) {
    m_s[tid] = kMinFloor;
    l_s[tid] = 0.f;
  }
  kv.load_table(tb, b, klo, khi);
  __syncthreads();
  const int ud = (D + VE - 1) / VE;     // units that hold data

  const int n_tiles = opaque_int((khi - klo) / a.TK + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = klo + t * a.TK;
    const int nk = opaque_int(min(a.TK, khi - t0 + 1));
    // ---- stage keys t0 .. t0 + nk - 1: K, then V in a second cp.async
    // group, so the scores and the softmax run while V is in flight
    if (a.vec) {
      for (int m = 0; m < 2; ++m) {
        for (int u = tid; u < nk * ud; u += DEC_THREADS) {
          const int j = u / ud, c = u % ud;
          const size_t r = kv.row(b, kvh, t0 + j, tb, klo);
          hw::cp_async_16(hw::smem_u32((m ? vs : ks) + j * STR + c * VE),
                          (m ? kv.v : kv.k) + r * D + c * VE, 16);
        }
        hw::cp_async_commit();
      }
      hw::cp_async_wait<1>();
    } else {
      // columns D .. ud * VE - 1 are zeros: a 16-byte read of the last
      // unit multiplies them by q's zero columns
      const int w = ud * VE;
      for (int i = tid; i < 2 * nk * w; i += DEC_THREADS) {
        const int m = i / (nk * w), j = (i / w) % nk, d = i % w;
        T x = from_f<T>(0.f);
        if (d < D)
          x = (m ? kv.v : kv.k)[kv.row(b, kvh, t0 + j, tb, klo) * D + d];
        (m ? vs : ks)[j * STR + d] = x;
      }
    }
    __syncthreads();

    // ---- scores of (head g, key j): tpp threads a pair
    const int pairs = hc * nk;
    int tpp = 1;
    while (tpp < 32 && tpp < ud && 2 * tpp * pairs <= DEC_THREADS) tpp *= 2;
    const int per = DEC_THREADS / tpp;
    for (int base = 0; base < pairs; base += per) {
      const int pr = base + tid / tpp;
      const int g = pr / nk, j = pr % nk;
      float part = 0.f;
      if (pr < pairs) {
        const T* kr = ks + j * STR;
        const float* qr = qs + g * STR;
        for (int c = tid % tpp; c < ud; c += tpp)
          part += dot16(kr + c * VE, qr + c * VE);
      }
      for (int o = tpp / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (pr < pairs && tid % tpp == 0) ps[g * a.TK + j] = part;
    }
    __syncthreads();

    // ---- online softmax, one warp a head; p replaces the scores
    for (int g = warp; g < hc; g += DEC_WARPS) {
      float* pg = ps + g * a.TK;
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float e = expf(pg[j] - m_new);
        pg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    hw::cp_async_wait<0>();               // V is in
    __syncthreads();

    // ---- acc = acc * alpha + P V, D across threads
#pragma unroll
    for (int o = 0; o < DEC_ACC; ++o) {
      const int idx = o * DEC_THREADS + tid;
      if (idx < hc * D) {
        const int g = idx / D, d = idx % D;
        const float* pg = ps + g * a.TK;
        const T* vc = vs + d;
        // four partial sums: a chain of nk / 4 dependent FMAs
        float x0 = acc[o] * al_s[g], x1 = 0.f, x2 = 0.f, x3 = 0.f;
        int j = 0;
        for (; j + 4 <= nk; j += 4) {
          x0 += pg[j] * to_f(vc[j * STR]);
          x1 += pg[j + 1] * to_f(vc[(j + 1) * STR]);
          x2 += pg[j + 2] * to_f(vc[(j + 2) * STR]);
          x3 += pg[j + 3] * to_f(vc[(j + 3) * STR]);
        }
        for (; j < nk; ++j) x0 += pg[j] * to_f(vc[j * STR]);
        acc[o] = (x0 + x1) + (x2 + x3);
      }
    }
    __syncthreads();    // the tile's buffers are free for the next one
  }

  if (n_live == 1) {                      // the row's only live split
#pragma unroll
    for (int o = 0; o < DEC_ACC; ++o) {
      const int idx = o * DEC_THREADS + tid;
      if (idx < hc * D) {
        const float l = l_s[idx / D];
        og[q_row * D + idx] = from_f<T>(l > 0.f ? acc[o] / l : 0.f);
      }
    }
    return;
  }

  // ---- publish this split's partial: [m[HC], l[HC], acc[HC][D]]
  const size_t part_floats = (size_t)a.HC * (D + 2);
  float* part = a.ws + ((size_t)rc * n_split + split) * part_floats;
  if (tid < hc) {
    part[tid] = m_s[tid];
    part[a.HC + tid] = l_s[tid];
  }
#pragma unroll
  for (int o = 0; o < DEC_ACC; ++o) {
    const int idx = o * DEC_THREADS + tid;
    if (idx < hc * D) part[2 * a.HC + idx] = acc[o];
  }
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomic_add_acq_rel(a.tickets + rc, 1);
    *last_s = ticket == n_live - 1;
    if (*last_s) a.tickets[rc] = 0;     // ready for the next launch
  }
  __syncthreads();
  if (!*last_s) return;

  // ---- the last live split merges the row's live partials (read
  // from L2) in batches of DEC_MERGE splits: each output loads a batch's
  // m, l and acc at once (one round trip a batch) and folds them into its
  // running max M and sums l and x, rescaled by exp(M_old - M) where M
  // grows; x / l once at the end.  Neither loop is unrolled, so only one
  // batch's loads are live at a time.
  const float* row_ws =
      a.ws + ((size_t)rc * n_split + first) * part_floats;
#pragma unroll 1
  for (int idx = tid; idx < hc * D; idx += DEC_THREADS) {
    const int g = idx / D;
    float M = kMinFloor, l = 0.f, x = 0.f;
#pragma unroll 1
    for (int k0 = 0; k0 < n_live; k0 += DEC_MERGE) {
      float mv[DEC_MERGE], lv[DEC_MERGE], av[DEC_MERGE];
#pragma unroll
      for (int k = 0; k < DEC_MERGE; ++k) {
        const float* w = row_ws + (size_t)(k0 + k) * part_floats;
        const bool in = k0 + k < n_live;
        mv[k] = in ? __ldcg(w + g) : kMinFloor;
        lv[k] = in ? __ldcg(w + a.HC + g) : 0.f;
        av[k] = in ? __ldcg(w + 2 * a.HC + idx) : 0.f;
      }
      float Mn = M;
#pragma unroll
      for (int k = 0; k < DEC_MERGE; ++k) Mn = fmaxf(Mn, mv[k]);
      const float c0 = expf(M - Mn);
      l *= c0;
      x *= c0;
#pragma unroll
      for (int k = 0; k < DEC_MERGE; ++k) {
        const float c = k0 + k < n_live ? expf(mv[k] - Mn) : 0.f;
        l += lv[k] * c;
        x += av[k] * c;
      }
      M = Mn;
    }
    og[q_row * D + idx] = from_f<T>(x / l);
  }
}

// Launch with the plan's values; the plan's shared-memory size must
// match this file's layout (a mismatch means the two disagree).
template <typename T, typename KV>
cudaError_t decode_launch(DecArgs a, const KV& kv, int B, int SK, int TK,
                          int HC, int smem, cudaStream_t stream) {
  const int group = a.HQ / a.HKV;
  const int limit = kv.limit();
  if (HC < 1 || HC > DEC_MAX_HEADS || TK < 1 || SK < 1)
    return cudaErrorInvalidValue;
  a.SK = SK;
  a.TK = TK;
  a.HC = HC;
  a.chunks = (group + HC - 1) / HC;
  if ((group + a.chunks - 1) / a.chunks != HC) return cudaErrorInvalidValue;
  const long long splits = (limit + SK - 1) / SK;
  const long long rows = (long long)B * a.HKV * a.chunks;
  if (splits > 65535 || rows > 2147483647LL) return cudaErrorInvalidValue;
  if (splits > 1 && (a.ws == nullptr || a.tickets == nullptr))
    return cudaErrorInvalidValue;
  const DecLayout L = dec_layout(a.D, sizeof(T), TK, HC, a.n_tab);
  if (L.bytes != smem || smem > DEC_SMEM_MAX) return cudaErrorInvalidValue;
  // above 48 KB a block's dynamic shared memory must be opted into
  const cudaError_t attr = hw::smem_opt_in(
      reinterpret_cast<const void*>(decode_split_kernel<T, KV>),
      DEC_SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(splits));
  decode_split_kernel<T, KV><<<grid, DEC_THREADS, smem, stream>>>(a, kv);
  return cudaGetLastError();
}

inline bool decode_args_ok(int B, int HQ, int HKV, int D) {
  return B >= 1 && HKV >= 1 && HQ >= 1 && HQ % HKV == 0 && D >= 1 &&
         D <= DEC_DMAX;
}

// Whether 16-byte copies can stage the rows: D * sizeof(T) a multiple
// of 16 and every K/V base 16-byte aligned.
template <typename T>
inline int decode_vec(int D, const void* k, const void* v) {
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  return (D * static_cast<int>(sizeof(T))) % 16 == 0 && bases % 16 == 0;
}

}  // namespace rt
