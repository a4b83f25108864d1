// Tiled matmul C[m, n] = A[m, k] . B[k, n] with f32 accumulation and the
// output in A's type, a permutable block order, both accumulation
// variants and a resident-RHS mode.
//
// Replaces: src/repro/kernels/matmul/kernel.py, matmul_pallas (bodies
//   _mm_scratch_kernel, _mm_rmw_kernel and _mm_resident_kernel).
// Bound on an H100: phi3-mini's QKV projection at the largest prefill
//   bucket (m 512, k 3072, n 9216, bf16) is 29 GFLOP, 29 us on the bf16
//   tensor cores and 0.43 ms on the CUDA cores (67 TFLOP/s), which is
//   where this kernel runs; the GEMM form of the 1x1 Table 4.1 layers at
//   batch 1 moves < 2.1 MB and is bound by bytes (< 0.7 us) and, in
//   practice, by the launch.
// Design: 256 threads a block (16 x 16), one block per (bm, bn) output
//   tile; thread (ty, tx) owns the MI x MJ outputs (ty + 16 i, tx + 16 j),
//   MI, MJ in {2, 4, 8}, so one A value and one B value read from shared
//   memory feed MJ and MI FMAs.  An A chunk [16 MI, bk + 1] (row-major,
//   written along k as it is read, the row padded by one element so a
//   warp's two rows fall in different banks) and a B chunk [bk, 16 MJ]
//   are staged per k block.  Each k block's product is summed into fresh
//   f32 registers and added to the running total, as the TPU kernel
//   adds each block's dot into its f32 scratch.  The schedule changes
//   what runs:
//   - block order: the output tiles are linearised into blockIdx with m
//     or n fastest as the schedule orders them;
//   - variant: k innermost sums every k block in one launch and rounds
//     once (scratch); otherwise the wrapper runs one launch per k block,
//     each adding its product to the output in f32 and rounding back
//     (read-modify-write), as _mm_rmw_kernel does;
//   - resident_rhs: the block loads its whole [k, bn] B panel into shared
//     memory once (up to 227 KB: k 3072 allows bn <= 32 in bf16) and
//     loops over k inside, as _mm_resident_kernel does.
//   No cuBLAS and no tensor cores; float32 is IEEE fp32 (no TF32).
// What it leaves on the table: tensor cores (wgmma), TMA and
//   double-buffered staging.
#include "common.cuh"

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
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_kernel<T, MI, MJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      232448);
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

extern "C" int matmul_fwd(const void* a, const void* b, void* c, int M,
                          int N, int K, int bm, int bn, int bk, int mi,
                          int mj, int m_outer, int k_begin, int k_count,
                          int accumulate, int resident, int is_bf16,
                          void* stream) {
  if (M < 1 || N < 1 || K < 1 || bm < 1 || bn < 1 || bk < 1 || M % bm ||
      N % bn || K % bk || bm > rt::kTy * mi || bn > rt::kTx * mj ||
      k_begin < 0 || k_count < bk || k_count % bk || k_begin + k_count > K ||
      (resident && (k_begin != 0 || k_count != K)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = is_bf16 ? 2 : 4;
  const long long smem = (static_cast<long long>(bk + 1) * rt::kTy * mi +
                          static_cast<long long>(resident ? K : bk) * rt::kTx * mj) * elem;
  const long long tiles = static_cast<long long>(M / bm) * (N / bn);
  if (smem > 232448 || tiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::MatmulArgs p{a, b, c, M, N, K, bm, bn, bk, M / bm, N / bn, m_outer,
                   k_begin, k_count, accumulate, resident};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int s = static_cast<int>(smem);
  const cudaError_t err = is_bf16 ? rt::mm_dispatch<__nv_bfloat16>(mi, mj, p, s, st)
                                  : rt::mm_dispatch<float>(mi, mj, p, s, st);
  return static_cast<int>(err);
}
