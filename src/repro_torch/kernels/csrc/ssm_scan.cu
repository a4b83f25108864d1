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
// Design: one thread per channel, its N states and N entries of a in
//   registers for the whole sequence; the grid is (Bt, Di / block_d) and
//   the sequence loop runs inside the block, as the TPU kernel's state
//   stayed in VMEM.  No [Bt, S, Di, N] tensor ever reaches device memory.
//   b_t and c_t are shared by the block's channels: they are staged in
//   shared memory a tile of kTile steps at a time, double-buffered, so
//   one __syncthreads per tile suffices.  x_t, dt_t and y_t are coalesced
//   across the block's channels.  expf, not __expf: the float32 checks
//   hold the kernel to 1e-5 of the plain version.
// block_d is a launch parameter (the counterpart of the TPU schedule's
//   block size).  The main path uses 64, chosen before measuring so that
//   Di = 8192 at batch 1 gives 128 blocks for the 132 SMs (128 would give
//   64).  Measured on the H100, 32 to 256 run within 8% of their mean at
//   the largest prefill, 128 the fastest (PERF.md): the SMs in use matter
//   little when one warp's instruction stream sets the pace (below).
//   Choosing it per shape is the tuning layer's job.
// What this design leaves on the table: each thread runs all N states'
//   work for a step in order (~250 instructions with the exps), and a
//   batch-1 scan has only 8192 threads, two warps an SM, so the scan runs
//   at the pace of one warp's dependent instruction stream, not at the
//   exp rate.  Splitting N across threads is the next design.
#include "common.cuh"

namespace rt {

constexpr int kTile = 32;   // steps of b and c staged per tile

template <typename T, int N>
__global__ void __launch_bounds__(1024) ssm_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const T* __restrict__ d,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ hout, int S, int Di) {
  __shared__ float b_s[2][kTile * N];
  __shared__ float c_s[2][kTile * N];
  const int bt = blockIdx.x;
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = ch < Di;     // the ragged last block masks its tail
  float av[N], h[N];
  float dv = 0.f;
  if (live) {
    const size_t hoff = (static_cast<size_t>(bt) * Di + ch) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      av[n] = a[static_cast<size_t>(ch) * N + n];
      h[n] = h0 != nullptr ? h0[hoff + n] : 0.f;
    }
    dv = to_f(d[ch]);
  }
  const size_t row = static_cast<size_t>(bt) * S;
  int buf = 0;
  for (int t0 = 0; t0 < S; t0 += kTile, buf ^= 1) {
    const int len = min(kTile, S - t0);
    const float* bsrc = bm + (row + t0) * N;
    const float* csrc = cm + (row + t0) * N;
    // This buffer was last read two tiles ago, before every thread
    // passed the previous tile's barrier: one barrier per tile suffices.
    for (int i = threadIdx.x; i < len * N; i += blockDim.x) {
      b_s[buf][i] = bsrc[i];
      c_s[buf][i] = csrc[i];
    }
    __syncthreads();
    if (live) {
      const float* bt_s = b_s[buf];
      const float* ct_s = c_s[buf];
      for (int t = 0; t < len; ++t) {
        const size_t off = (row + t0 + t) * Di + ch;
        const float xt = to_f(x[off]);
        const float dtt = dt[off];
        const float dx = dtt * xt;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float da = expf(dtt * av[n]);
          h[n] = da * h[n] + dx * bt_s[t * N + n];
          acc += h[n] * ct_s[t * N + n];
        }
        y[off] = from_f<T>(acc + dv * xt);
      }
    }
  }
  if (live) {
    const size_t hoff = (static_cast<size_t>(bt) * Di + ch) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) hout[hoff + n] = h[n];
  }
}

template <typename T, int N>
cudaError_t ssm_launch(const void* x, const void* dt, const void* b,
                       const void* c, const void* a, const void* d,
                       const void* h0, void* y, void* hout, int Bt, int S,
                       int Di, int block_d, cudaStream_t st) {
  dim3 grid(Bt, (Di + block_d - 1) / block_d);
  ssm_scan_kernel<T, N><<<grid, block_d, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const T*>(d),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hout), S, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ssm_dispatch_n(int N, const void* x, const void* dt,
                           const void* b, const void* c, const void* a,
                           const void* d, const void* h0, void* y,
                           void* hout, int Bt, int S, int Di, int block_d,
                           cudaStream_t st) {
  switch (N) {
    case 16:
      return ssm_launch<T, 16>(x, dt, b, c, a, d, h0, y, hout, Bt, S, Di,
                               block_d, st);
    case 8:
      return ssm_launch<T, 8>(x, dt, b, c, a, d, h0, y, hout, Bt, S, Di,
                              block_d, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace rt

extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* b,
                            const void* c, const void* a, const void* d,
                            const void* h0, void* y, void* hout, int Bt,
                            int S, int Di, int N, int block_d, int is_bf16,
                            void* stream) {
  if (Bt < 1 || S < 1 || Di < 1 || block_d < 32 || block_d > 1024 ||
      block_d % 32 != 0 || (Di + block_d - 1) / block_d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? rt::ssm_dispatch_n<__nv_bfloat16>(N, x, dt, b, c, a, d, h0,
                                                  y, hout, Bt, S, Di,
                                                  block_d, st)
              : rt::ssm_dispatch_n<float>(N, x, dt, b, c, a, d, h0, y,
                                          hout, Bt, S, Di, block_d, st);
  return static_cast<int>(err);
}
