// Mamba-1 selective scan with an explicit initial state:
//   da = exp(dt * a),  h = da * h + (dt * x) * b,  y = sum_n h * c + d * x
// x, dt [Bt, S, Di]; b, c [Bt, S, N]; a [Di, N]; d [Di]; h0 [Bt, Di, N]
// (zeros when null) -> y [Bt, S, Di] in x's type, hout [Bt, Di, N] f32.
// One kernel serves prefill (h0 null) and the S = 1 decode step (h0 =
// the cache).
//
// Replaces: src/repro/kernels/ssm_scan/kernel.py, ssm_scan_pallas (body
//   _ssm_kernel).
// Bound on an H100: at the largest engine prefill [1, 512, 8192], N 16,
//   bf16, the data is ~35 MB (x, dt in f32, y, a, the final state):
//   ~10 us at 3.35 TB/s.  The 67 M exps run on the special-function
//   units, 16 a clock per SM: 132 * 16 * 1.98 GHz = 4.18e12 a second,
//   ~16 us.  So the exps bind prefill; the S = 1 decode step (state read
//   and written in f32) is bound by bytes and, at ~1.5 us, by the launch.
// Design: the grid is (Bt, Di / block_d) and the sequence loop runs
//   inside the block, the state in registers for the whole sequence, as
//   the TPU kernel's stayed in VMEM: no [Bt, S, Di, N] tensor reaches
//   device memory.
//   - A channel's N states are split across L = N / kP consecutive lanes
//     of a warp, kP states a lane (a compile-time constant), so a block
//     has block_d * L threads and a batch-1 scan at Di 8192 has 32,768
//     threads at kP 4 (one a channel left two warps an SM).  A lane
//     keeps its kP entries of a and of h in registers.  Consecutive
//     lanes own consecutive states, so h0, hout and a ([.., N], n
//     fastest) move as contiguous 16-byte vectors: coalesced.
//   - y_t is the lanes' partial <h, c> summed over the channel's lanes.
//     Steps go in groups of L: each lane keeps its partial of each, and
//     a reduce-scatter (L / 2, ..., 1 apart, log2 L shuffle rounds)
//     leaves lane l the whole sum of step l of the group: the sums of an
//     xor tree over the lanes, in its order, for 1 - 1 / L of its
//     shuffles.
//   - Every input of a step comes from shared memory: the block's x and
//     dt columns and the tile's b and c rows are staged kTile steps at a
//     time with cp.async, double-buffered, tile k + 1 in flight while
//     tile k is scanned, so no global load sits on a step's chain.  A
//     full tile's y stays in registers (kTile / L a lane) until its last
//     step, is then written over the staged x, and the block writes it
//     out in 16-byte vectors: no shared-memory store sits between one
//     step's loads and the next's.
//   - A full tile runs its kTile steps unrolled (a compile-time trip
//     count), and a group computes its steps' exps before their h
//     updates, so exp(dt_{t+1} a) and dt x b of later steps, which do not
//     depend on h, issue under step t's chain; only h = da * h + dbx (one
//     FMA a state) is serial.  The last, ragged tile runs one group at a
//     time and skips the steps past its end, so the S = 1 decode step
//     scans one step, not kTile.
//   - exp(dt a) is ex2.approx(dt * (a log2 e)) with a log2 e rounded once:
//     two instructions where expf takes eight, the special-function
//     units' rate binding.  It holds every float32 check of chip_smoke.py
//     to 1e-5, the error of expf's build measured beside it
//     (launch/scan_variants.py, PERF.md).  A step whose x and b are 0 (a
//     masked pad) leaves a zero state exactly 0.
//   Rows whose pointers are not 16-byte aligned, or whose Di is not a
//   whole number of 16-byte vectors, take plain loads and stores instead
//   of the vectors (the same steps; slower staging).
// block_d (channels a block) is the launch parameter, the counterpart of
//   the TPU schedule's block size: block_d * L <= 1024 threads and two
//   stages of shared memory within the SM's 227 KB.
#include "common.cuh"
#include "hopper.cuh"

namespace rt {

constexpr int kP = 4;                      // states of a channel a lane holds
constexpr int kTile = 32;                  // steps a staged tile holds
constexpr float kLog2e = 1.44269502f;      // log2(e) rounded to float

// One stage: dt [kTile][bd] f32, b and c [kTile][N] f32, then x [kTile]
// [bd] in x's type (y written over it).  Every part starts 16-byte
// aligned: bd is a multiple of 32.
template <typename T, int N>
__host__ __device__ constexpr int scan_stage_bytes(int bd) {
  return kTile * bd * 4 + 2 * kTile * N * 4 + kTile * bd * int(sizeof(T));
}

template <typename T, int N>
struct ScanStage {
  float* dt;
  float* b;
  float* c;
  T* x;
  __device__ ScanStage(char* base, int bd)
      : dt(reinterpret_cast<float*>(base)),
        b(dt + kTile * bd),
        c(b + kTile * N),
        x(reinterpret_cast<T*>(c + kTile * N)) {}
};

// kP floats at p (16-byte aligned when vec) into r.
__device__ __forceinline__ void load_states(float (&r)[kP], const float* p,
                                            bool vec) {
  if (vec && kP % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kP; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kP; ++i) r[i] = p[i];
  }
}

__device__ __forceinline__ void store_states(float* p, const float (&r)[kP],
                                             bool vec) {
  if (vec && kP % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kP; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kP; ++i) p[i] = r[i];
  }
}

// Stage steps t0 .. t0 + len - 1 of the block's channels c0 .. c0 + bd - 1
// (rows from `row` = bt * S); channels at or past Di read as zeros.  With
// vec, as cp.async groups the caller waits for; else plain loads.
template <typename T, int N>
__device__ __forceinline__ void stage_tile(
    ScanStage<T, N> s, const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm, size_t row,
    int t0, int len, int c0, int bd, int Di, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t r0 = row + t0;
  if (vec) {
    constexpr int kXE = 16 / sizeof(T);     // x elements a vector
    const int dv = bd / 4, xv = bd / kXE;
    for (int i = tid; i < len * dv; i += nt) {
      const int t = i / dv, c = (i % dv) * 4;
      const bool in = c0 + c < Di;
      hw::cp_async_16(hw::smem_u32(s.dt + t * bd + c),
                      in ? dt + (r0 + t) * Di + c0 + c : dt, in ? 16 : 0);
    }
    for (int i = tid; i < len * xv; i += nt) {
      const int t = i / xv, c = (i % xv) * kXE;
      const bool in = c0 + c < Di;
      hw::cp_async_16(hw::smem_u32(s.x + t * bd + c),
                      in ? x + (r0 + t) * Di + c0 + c : x, in ? 16 : 0);
    }
    // b and c of the tile are len * N contiguous floats each
    for (int i = tid; i < len * N / 4; i += nt) {
      hw::cp_async_16(hw::smem_u32(s.b + 4 * i), bm + r0 * N + 4 * i, 16);
      hw::cp_async_16(hw::smem_u32(s.c + 4 * i), cm + r0 * N + 4 * i, 16);
    }
    hw::cp_async_commit();
  } else {
    for (int i = tid; i < len * bd; i += nt) {
      const int t = i / bd, c = i % bd;
      const bool in = c0 + c < Di;
      const size_t off = (r0 + t) * Di + c0 + c;
      s.dt[t * bd + c] = in ? dt[off] : 0.f;
      s.x[t * bd + c] = in ? x[off] : from_f<T>(0.f);
    }
    for (int i = tid; i < len * N; i += nt) {
      s.b[i] = bm[r0 * N + i];
      s.c[i] = cm[r0 * N + i];
    }
  }
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Steps t .. t + L - 1 of the staged tile (t a multiple of L) for this
// lane's kP states of channel cl: h = exp(dt a) h + (dt x) b, and the
// lane's partial <h, c> of each step.  A reduce-scatter over the
// channel's L lanes (L / 2, ..., 1 apart) then leaves lane l the whole
// sum of step t + l, which is returned: the same sums, in the same
// order, as an xor tree over the lanes for each step.  With kGuard, the
// steps at or past len are skipped.
template <typename T, int N, bool kGuard>
__device__ __forceinline__ float scan_group(ScanStage<T, N> s, int t,
                                            int len, int bd, int cl,
                                            int lane, float (&h)[kP],
                                            const float (&av)[kP]) {
  constexpr int L = N / kP;
  // the group's exps first: they do not depend on h, and their latency
  // then runs under the h chain of the steps before
  float part[L], dx[L], da[L][kP];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    part[j] = 0.f;
    dx[j] = 0.f;
    if (kGuard && t + j >= len) continue;
    const float xt = to_f(s.x[(t + j) * bd + cl]);
    const float dtt = s.dt[(t + j) * bd + cl];
    dx[j] = dtt * xt;
#pragma unroll
    for (int p = 0; p < kP; ++p)
      da[j][p] = ex2_approx(dtt * (av[p] * kLog2e));
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (kGuard && t + j >= len) continue;
    float bv[kP], cv[kP];
    load_states(bv, s.b + (t + j) * N + lane * kP, true);
    load_states(cv, s.c + (t + j) * N + lane * kP, true);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      h[p] = da[j][p] * h[p] + dx[j] * bv[p];
      part[j] += h[p] * cv[p];
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    // keep the half of the steps whose bit o matches the lane's; send
    // the other half to the lane o apart
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < o; ++j) {
      const float keep = upper ? part[j + o] : part[j];
      const float send = upper ? part[j] : part[j + o];
      part[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return part[0];
}

template <typename T, int N>
__global__ void __launch_bounds__(1024) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const T* __restrict__ d,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ hout, int S, int Di, int vec) {
  constexpr int L = N / kP;
  static_assert(N % kP == 0 && L <= 32 && (L & (L - 1)) == 0 &&
                    kTile % L == 0,
                "a channel's lanes must be a power of two within a warp");
  extern __shared__ __align__(16) char smem[];
  const int bd = blockDim.x / L;
  const int stage = scan_stage_bytes<T, N>(bd);
  const int bt = blockIdx.x;
  const int cl = threadIdx.x / L, lane = threadIdx.x % L;
  const int c0 = blockIdx.y * bd;
  const int ch = c0 + cl;
  const bool live = ch < Di;     // the ragged last block masks its tail
  const size_t row = static_cast<size_t>(bt) * S;
  const size_t hoff = (static_cast<size_t>(bt) * Di + ch) * N + lane * kP;
  float av[kP], h[kP];
  float dv = 0.f;
#pragma unroll
  for (int p = 0; p < kP; ++p) av[p] = h[p] = 0.f;
  if (live) {
    load_states(av, a + static_cast<size_t>(ch) * N + lane * kP, vec);
    if (h0 != nullptr) load_states(h, h0 + hoff, vec);
    dv = to_f(d[ch]);
  }
  const int n_tiles = (S + kTile - 1) / kTile;
  stage_tile(ScanStage<T, N>(smem, bd), x, dt, bm, cm, row, 0,
             min(kTile, S), c0, bd, Di, vec);
  for (int k = 0; k < n_tiles; ++k) {
    const ScanStage<T, N> cur(smem + (k & 1) * stage, bd);
    const int t0 = k * kTile;
    const int len = min(kTile, S - t0);
    hw::cp_async_wait<0>();
    // Tile k is in for every thread, and every thread is done with the
    // other stage (tile k - 1's y is out): stage tile k + 1 into it.
    __syncthreads();
    if (k + 1 < n_tiles)
      stage_tile(ScanStage<T, N>(smem + ((k + 1) & 1) * stage, bd), x, dt,
                 bm, cm, row, t0 + kTile,
                 min(kTile, S - t0 - kTile), c0, bd, Di, vec);
    if (len == kTile) {
      // y of the tile stays in registers until every step has read its
      // x: no shared-memory store sits between one step's loads and the
      // next's, so the unrolled steps overlap
      float ys[kTile / L];
#pragma unroll
      for (int g = 0; g < kTile / L; ++g)
        ys[g] = scan_group<T, N, false>(cur, g * L, kTile, bd, cl, lane, h,
                                        av);
      __syncwarp();
#pragma unroll
      for (int g = 0; g < kTile / L; ++g) {
        T* xy = cur.x + (g * L + lane) * bd + cl;
        *xy = from_f<T>(ys[g] + dv * to_f(*xy));
      }
    } else {
#pragma unroll 1
      for (int t = 0; t < len; t += L) {
        const float ysum = scan_group<T, N, true>(cur, t, len, bd, cl, lane,
                                                  h, av);
        // rows t .. t + L - 1 are read: write y of row t + lane
        T* xy = cur.x + (t + lane) * bd + cl;
        if (t + lane < len) *xy = from_f<T>(ysum + dv * to_f(*xy));
      }
    }
    __syncthreads();             // the tile's y is in shared memory
    const size_t r0 = row + t0;
    if (vec) {
      constexpr int kXE = 16 / sizeof(T);
      const int xv = bd / kXE;
      for (int i = threadIdx.x; i < len * xv; i += blockDim.x) {
        const int t = i / xv, c = (i % xv) * kXE;
        if (c0 + c < Di)
          *reinterpret_cast<uint4*>(y + (r0 + t) * Di + c0 + c) =
              *reinterpret_cast<const uint4*>(cur.x + t * bd + c);
      }
    } else {
      for (int i = threadIdx.x; i < len * bd; i += blockDim.x) {
        const int t = i / bd, c = i % bd;
        if (c0 + c < Di) y[(r0 + t) * Di + c0 + c] = cur.x[t * bd + c];
      }
    }
  }
  if (live) store_states(hout + hoff, h, vec);
}

template <typename T, int N>
cudaError_t ssm_launch(const void* x, const void* dt, const void* b,
                       const void* c, const void* a, const void* d,
                       const void* h0, void* y, void* hout, int Bt, int S,
                       int Di, int block_d, int vec, cudaStream_t st) {
  constexpr int L = N / kP;
  const int smem = 2 * scan_stage_bytes<T, N>(block_d);
  if (block_d * L > 1024 || smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = hw::smem_opt_in(
        reinterpret_cast<const void*>(&ssm_scan_kernel<T, N>), smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(Bt, (Di + block_d - 1) / block_d);
  ssm_scan_kernel<T, N><<<grid, block_d * L, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const T*>(d),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hout), S, Di, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ssm_dispatch_n(int N, const void* x, const void* dt,
                           const void* b, const void* c, const void* a,
                           const void* d, const void* h0, void* y,
                           void* hout, int Bt, int S, int Di, int block_d,
                           int vec, cudaStream_t st) {
  switch (N) {
    case 16:
      return ssm_launch<T, 16>(x, dt, b, c, a, d, h0, y, hout, Bt, S, Di,
                               block_d, vec, st);
    case 8:
      return ssm_launch<T, 8>(x, dt, b, c, a, d, h0, y, hout, Bt, S, Di,
                              block_d, vec, st);
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace rt

extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* b,
                            const void* c, const void* a, const void* d,
                            const void* h0, void* y, void* hout, int Bt,
                            int S, int Di, int N, int block_d, int is_bf16,
                            void* stream) {
  if (Bt < 1 || S < 1 || Di < 1 || block_d < 32 || block_d % 32 != 0 ||
      (Di + block_d - 1) / block_d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte vectors: every pointer aligned, and rows of x, y and dt
  // whole vectors (the x of a row in 16 / sizeof(T) elements)
  const int x_vec = is_bf16 ? 8 : 4;
  const int vec = Di % x_vec == 0 && rt::aligned16(x) && rt::aligned16(dt) &&
                  rt::aligned16(b) && rt::aligned16(c) && rt::aligned16(a) &&
                  rt::aligned16(y) && rt::aligned16(hout) &&
                  (h0 == nullptr || rt::aligned16(h0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? rt::ssm_dispatch_n<__nv_bfloat16>(N, x, dt, b, c, a, d, h0,
                                                  y, hout, Bt, S, Di,
                                                  block_d, vec, st)
              : rt::ssm_dispatch_n<float>(N, x, dt, b, c, a, d, h0, y,
                                          hout, Bt, S, Di, block_d, vec, st);
  return static_cast<int>(err);
}
