// Single-query flash decode over a block-paged KV pool [NB, HKV, bs, D]
// through per-row block tables [B, MB]; row b attends to its logical
// keys 0..pos[b].
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   paged_decode_attention_pallas (body _paged_decode_kernel).
// Bound and design: see decode_common.cuh (bytes of the valid K/V
//   prefix).  Splits are whole pool blocks; each reads its blocks' table
//   entries once (the TPU kernel's scalar prefetch); logical blocks past
//   pos[b] are never touched, and nothing is gathered into a contiguous
//   buffer.
#include "decode_common.cuh"

// ws, tickets, SK, TK, HC, smem: as decode_attention_fwd (SK a multiple
// of bs).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool, void* o,
    const void* tables, const void* pos, void* ws, void* tickets, int B,
    int HQ, int HKV, int bs, int MB, int D, int SK, int TK, int HC,
    int smem, float scale, int is_bf16, void* stream) {
  if (!rt::decode_args_ok(B, HQ, HKV, D) || bs < 1 || MB < 1 || SK < 1 ||
      SK % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tp = static_cast<const int*>(tables);
  rt::DecArgs a{};
  a.q = q;
  a.o = o;
  a.pos = static_cast<const int*>(pos);
  a.starts = nullptr;
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.HQ = HQ;
  a.HKV = HKV;
  a.D = D;
  a.scale = scale;
  a.n_tab = SK / bs;
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    rt::PagedKV<T> kv{static_cast<const T*>(k_pool),
                      static_cast<const T*>(v_pool), tp, HKV, bs, MB};
    a.vec = rt::decode_vec<T>(D, k_pool, v_pool);
    err = rt::decode_launch<T>(a, kv, B, SK, TK, HC, smem, st);
  } else {
    rt::PagedKV<float> kv{static_cast<const float*>(k_pool),
                          static_cast<const float*>(v_pool), tp, HKV, bs, MB};
    a.vec = rt::decode_vec<float>(D, k_pool, v_pool);
    err = rt::decode_launch<float>(a, kv, B, SK, TK, HC, smem, st);
  }
  return static_cast<int>(err);
}
