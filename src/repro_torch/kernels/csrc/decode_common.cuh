// Single-query flash decode shared by the contiguous and the paged
// kernels: one thread block per (batch row, KV head) serves every query
// head of that KV group, so each K/V element is read from device memory
// once per step however many query heads share it.
//
// Bound on an H100: bytes.  A decode step does 4 * D operations per
// (query head, key) against 4 * D bytes of bf16 K and V per (KV head,
// key), about one operation per byte, so the floor is the valid K/V
// prefix over the 3.35 TB/s memory rate.
// Design against that bound: eight warps split the row's valid keys in
// chunks of UNR = 8 consecutive keys; a warp starts all of a chunk's K
// and V loads before it uses any of them (memory-level parallelism
// instead of one dependent load per key), lanes split the head dimension
// (d = lane + 32 * i) so a key's row is one coalesced read, the dot
// product is a warp shuffle reduction, and each warp keeps its own f32
// online-softmax state (m, l, acc) per query head.  The warps' partial
// states are merged through shared memory at the end.  Keys outside the
// row's window are never read.  q is scaled by 1/sqrt(D) on load,
// rounded to q's dtype as the Pallas kernels do.
#pragma once
#include "common.cuh"

namespace rt {

constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_UNR = 8;
constexpr int DEC_DMAX = 128;

// K/V addressing of a contiguous cache [B, HKV, S, D].
template <typename T>
struct ContigKV {
  const T* k;
  const T* v;
  int HKV, S, D;
  __device__ __forceinline__ size_t off(int b, int h, int kp) const {
    return (((size_t)b * HKV + h) * S + kp) * D;
  }
  __device__ __forceinline__ int limit() const { return S; }
};

// K/V addressing of a block-paged pool [NB, HKV, bs, D] through the
// row's block table [B, MB]: the block reads its own table entries
// (what the TPU kernel's scalar prefetch did).
template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  const int* tables;
  int HKV, bs, MB, D;
  __device__ __forceinline__ size_t off(int b, int h, int kp) const {
    const int blk = tables[(size_t)b * MB + kp / bs];
    return (((size_t)blk * HKV + h) * bs + kp % bs) * D;
  }
  __device__ __forceinline__ int limit() const { return MB * bs; }
};

// q, o: [B, HQ, D].  Valid keys of row b: lo <= kp <= hi with
// lo = starts[b] (0 without starts) and hi = min(pos[b], limit - 1).
template <typename T, int G, int DPL, typename KV>
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const T* __restrict__ q, T* __restrict__ o, KV kv,
              const int* __restrict__ pos, const int* __restrict__ starts,
              int HQ, int HKV, int D, float scale) {
  __shared__ float sm_m[DEC_WARPS][G];
  __shared__ float sm_l[DEC_WARPS][G];
  __shared__ float sm_acc[DEC_WARPS][G][DEC_DMAX];

  const int b = blockIdx.x / HKV;
  const int kvh = blockIdx.x % HKV;
  const int group = HQ / HKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[G][DPL], acc[G][DPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qp = q + ((size_t)b * HQ + kvh * group + (g < group ? g : 0)) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < group && d < D) ? scaled_q(qp[d], scale) : 0.f;
      acc[g][i] = 0.f;
    }
    m[g] = kMinFloor;
    l[g] = 0.f;
  }

  const int lo = starts ? max(starts[b], 0) : 0;
  const int hi = min(pos[b], kv.limit() - 1);

  for (int base = lo + warp * DEC_UNR; base <= hi;
       base += DEC_WARPS * DEC_UNR) {
    float kx[DEC_UNR][DPL], vx[DEC_UNR][DPL];
#pragma unroll
    for (int j = 0; j < DEC_UNR; ++j) {
      const int kp = base + j;
      const bool ok = kp <= hi;
      const size_t off = kv.off(b, kvh, ok ? kp : base);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const bool in = ok && d < D;
        kx[j][i] = in ? to_f(kv.k[off + d]) : 0.f;
        vx[j][i] = in ? to_f(kv.v[off + d]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
      float s[DEC_UNR];
      float mt = kMinFloor;
#pragma unroll
      for (int j = 0; j < DEC_UNR; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += qr[g][i] * kx[j][i];
        part = warp_sum(part);
        s[j] = (base + j <= hi) ? part : -INFINITY;
        mt = fmaxf(mt, s[j]);
      }
      const float m_new = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < DEC_UNR; ++j) {
        s[j] = expf(s[j] - m_new);   // exactly 0 for a masked key
        psum += s[j];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float a = acc[g][i] * alpha;
#pragma unroll
        for (int j = 0; j < DEC_UNR; ++j) a += s[j] * vx[j][i];
        acc[g][i] = a;
      }
      m[g] = m_new;
    }
  }

  // Merge the warps' partial softmax states.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) sm_acc[warp][g][d] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * D; idx += DEC_THREADS) {
    const int g = idx / D, d = idx % D;
    float mx = kMinFloor;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * c;
      a += sm_acc[w][g][d] * c;
    }
    const float out = lsum > 0.f ? a / lsum : 0.f;   // no valid key -> 0
    o[((size_t)b * HQ + kvh * group + g) * D + d] = from_f<T>(out);
  }
}

template <typename T, int G, int DPL, typename KV>
cudaError_t decode_launch(const void* q, void* o, const KV& kv,
                          const int* pos, const int* starts, int B, int HQ,
                          int HKV, int D, float scale, cudaStream_t stream) {
  decode_kernel<T, G, DPL, KV><<<B * HKV, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(o), kv, pos, starts, HQ,
      HKV, D, scale);
  return cudaGetLastError();
}

template <typename T, int G, typename KV>
cudaError_t decode_dispatch_d(const void* q, void* o, const KV& kv,
                              const int* pos, const int* starts, int B,
                              int HQ, int HKV, int D, float scale,
                              cudaStream_t st) {
  const int dpl = (D + 31) / 32;
  if (dpl == 1) return decode_launch<T, G, 1>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
  if (dpl == 2) return decode_launch<T, G, 2>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
  if (dpl == 3) return decode_launch<T, G, 3>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
  return decode_launch<T, G, 4>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
}

// Dispatch on the GQA group size (query heads per KV head, <= 8).
template <typename T, typename KV>
cudaError_t decode_dispatch(const void* q, void* o, const KV& kv,
                            const int* pos, const int* starts, int B,
                            int HQ, int HKV, int D, float scale,
                            cudaStream_t st) {
  const int group = HQ / HKV;
  if (group == 1) return decode_dispatch_d<T, 1>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
  if (group == 2) return decode_dispatch_d<T, 2>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
  if (group <= 4) return decode_dispatch_d<T, 4>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
  return decode_dispatch_d<T, 8>(q, o, kv, pos, starts, B, HQ, HKV, D, scale, st);
}

inline bool decode_args_ok(int B, int HQ, int HKV, int D) {
  return B >= 1 && HKV >= 1 && HQ % HKV == 0 && HQ / HKV <= 8 && D >= 1 &&
         D <= DEC_DMAX;
}

}  // namespace rt
