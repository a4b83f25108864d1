// Causal (optionally sliding-window) flash attention for prefill, with
// per-row `starts` masking of a left-padded batch and GQA.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_pallas (bodies _flash_kernel, _flash_kernel_starts).
// Bound on an H100: bytes.  At the engine's prefill lengths (S <= 512,
//   D = 96) causal attention does about S/2 * 4 * D operations per query
//   row against 8 * D bytes of Q, K, V and O per row, far below the
//   card's ~295 operations per byte, so moving Q/K/V/O once is the floor.
// Design: one thread block per (batch * query head, 64-row query tile),
//   256 threads, four threads per query row, each owning a contiguous
//   quarter of the head dimension in registers (q and the f32
//   accumulator).  The block walks only the 32-key tiles that its causal
//   / window / starts mask can reach, stages each K and V tile in shared
//   memory as f32 (read with 16-byte vector loads), and keeps the online
//   softmax statistics m and l in f32 registers.  GQA reads the KV head
//   h / group directly; no repeated K/V is ever written.  S need not be a
//   multiple of a tile: keys and queries past S are masked in the kernel.
//   q is scaled by 1/sqrt(D) on load, rounded to q's dtype as every
//   Pallas entry does.  No tensor cores, TMA or warp specialisation yet.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 32;       // keys per shared-memory tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;
constexpr int DMAX = 128;

template <typename T, int DPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ starts, int HQ, int HKV, int S,
                 int D, int causal, int window, float scale) {
  __shared__ __align__(16) float ks[BKV][DMAX];
  __shared__ __align__(16) float vs[BKV][DMAX];

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
  for (int idx = tid; idx < BKV * DMAX; idx += THREADS) {
    const int j = idx / DMAX, d = idx % DMAX;
    if (d >= D) { ks[j][d] = 0.f; vs[j][d] = 0.f; }
  }

  float qr[DPT], acc[DPT];
  const T* qp = q + ((size_t)bh * S + (qvalid ? qpos : 0)) * D;
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
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

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
    T* op = o + ((size_t)bh * S + qpos) * D;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = d0 + i;
      if (d < D) op[d] = rt::from_f<T>(acc[i] * inv);
    }
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* starts, int B, int HQ, int HKV, int S, int D,
                   int causal, int window, float scale, cudaStream_t stream) {
  dim3 grid(B * HQ, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T, DPT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), starts, HQ, HKV, S, D,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const int* starts, int B, int HQ, int HKV, int S,
                     int D, int causal, int window, float scale,
                     cudaStream_t stream) {
  const int per = (D + TPR - 1) / TPR;
  if (per <= 4)
    return launch<T, 4>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 8)
    return launch<T, 8>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 16)
    return launch<T, 16>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  if (per <= 24)
    return launch<T, 24>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
  return launch<T, 32>(q, k, v, o, starts, B, HQ, HKV, S, D, causal, window, scale, stream);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* starts, int B, int HQ,
                                   int HKV, int S, int D, int causal,
                                   int window, float scale, int is_bf16,
                                   void* stream) {
  if (D < 1 || D > DMAX || HKV < 1 || HQ % HKV != 0 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, sp, B, HQ, HKV, S, D, causal, window, scale, st)
              : dispatch<float>(q, k, v, o, sp, B, HQ, HKV, S, D, causal, window, scale, st);
  return static_cast<int>(err);
}
