// Single-query flash decode over a block-paged KV pool [NB, HKV, bs, D]
// through per-row block tables [B, MB]; row b attends to its logical
// keys 0..pos[b].
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   paged_decode_attention_pallas (body _paged_decode_kernel).
// Bound and design: see decode_common.cuh (bytes of the valid K/V
//   prefix).  The block reads tables[b, kpos / bs] itself (the TPU
//   kernel's scalar prefetch); logical blocks past pos[b] are never
//   touched, and nothing is gathered into a contiguous buffer.
#include "decode_common.cuh"

extern "C" int paged_decode_attention_fwd(const void* q, const void* k_pool,
                                          const void* v_pool, void* o,
                                          const void* tables, const void* pos,
                                          int B, int HQ, int HKV, int bs,
                                          int MB, int D, float scale,
                                          int is_bf16, void* stream) {
  if (!rt::decode_args_ok(B, HQ, HKV, D) || bs < 1 || MB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(tables);
  const int* pp = static_cast<const int*>(pos);
  cudaError_t err;
  if (is_bf16) {
    rt::PagedKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k_pool),
                                  static_cast<const __nv_bfloat16*>(v_pool), tp,
                                  HKV, bs, MB, D};
    err = rt::decode_dispatch<__nv_bfloat16>(q, o, kv, pp, nullptr, B, HQ, HKV, D, scale, st);
  } else {
    rt::PagedKV<float> kv{static_cast<const float*>(k_pool),
                          static_cast<const float*>(v_pool), tp, HKV, bs, MB, D};
    err = rt::decode_dispatch<float>(q, o, kv, pp, nullptr, B, HQ, HKV, D, scale, st);
  }
  return static_cast<int>(err);
}
