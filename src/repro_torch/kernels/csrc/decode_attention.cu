// Single-query flash decode over a contiguous KV cache [B, HKV, S, D]
// with the per-row window starts[b] <= kpos <= pos[b].
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   decode_attention_pallas (body _decode_kernel).
// Bound and design: see decode_common.cuh (bytes of the valid K/V
//   window; one block per (row, KV head), keys outside the window are
//   never read, which is what the TPU kernel's block skipping did).
#include "decode_common.cuh"

extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, const void* pos,
                                    const void* starts, int B, int HQ,
                                    int HKV, int S, int D, float scale,
                                    int is_bf16, void* stream) {
  if (!rt::decode_args_ok(B, HQ, HKV, D) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pp = static_cast<const int*>(pos);
  const int* sp = static_cast<const int*>(starts);
  cudaError_t err;
  if (is_bf16) {
    rt::ContigKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                                   static_cast<const __nv_bfloat16*>(v), HKV, S, D};
    err = rt::decode_dispatch<__nv_bfloat16>(q, o, kv, pp, sp, B, HQ, HKV, D, scale, st);
  } else {
    rt::ContigKV<float> kv{static_cast<const float*>(k),
                           static_cast<const float*>(v), HKV, S, D};
    err = rt::decode_dispatch<float>(q, o, kv, pp, sp, B, HQ, HKV, D, scale, st);
  }
  return static_cast<int>(err);
}
