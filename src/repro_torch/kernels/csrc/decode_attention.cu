// Single-query flash decode over a contiguous KV cache [B, HKV, S, D]
// with the per-row window starts[b] <= kpos <= pos[b].
//
// Replaces: src/repro/kernels/decode_attention/kernel.py,
//   decode_attention_pallas (body _decode_kernel).
// Bound and design: see decode_common.cuh (bytes of the valid K/V
//   window; the keys split across blocks and merged in the same launch;
//   keys outside the window are never read, which is what the TPU
//   kernel's block skipping did; a GQA or MQA group in bf16 runs the
//   packed body, its heads as tensor-core rows, which fetches a split's
//   first tile before pos arrives and zeroes its V rows past pos).
#include "decode_common.cuh"

// pos: [B] int32 positions.  starts: [B] int64 (the model's own
// dtype), or null.  ws: the plan's f32 partials (null with one split);
// tickets: one zeroed int per (row, KV head, head chunk), private to the
// caller's stream.  SK, TK, HC, smem: the plan (kernels/_geometry.py,
// decode_plan); packed: its body (1: decode_packed_kernel, bf16 only).
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, const void* pos,
                                    const void* starts, void* ws,
                                    void* tickets, int B, int HQ, int HKV,
                                    int S, int D, int SK, int TK, int HC,
                                    int smem, int packed, float scale,
                                    int is_bf16, void* stream) {
  if (!rt::decode_args_ok(B, HQ, HKV, D) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rt::DecArgs a{};
  a.q = q;
  a.o = o;
  a.pos = static_cast<const int*>(pos);
  a.starts = static_cast<const long long*>(starts);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.HQ = HQ;
  a.HKV = HKV;
  a.D = D;
  a.scale = scale;
  a.n_tab = 0;
  cudaError_t err;
  if (is_bf16) {
    using T = __nv_bfloat16;
    rt::ContigKV<T> kv{static_cast<const T*>(k), static_cast<const T*>(v),
                       HKV, S};
    a.vec = rt::decode_vec<T>(D, k, v);
    err = packed ? rt::decode_packed_launch(a, kv, B, SK, TK, HC, smem, st)
                 : rt::decode_launch<T>(a, kv, B, SK, TK, HC, smem, st);
  } else if (packed) {
    err = cudaErrorInvalidValue;       // the packed body is bf16 only
  } else {
    rt::ContigKV<float> kv{static_cast<const float*>(k),
                           static_cast<const float*>(v), HKV, S};
    a.vec = rt::decode_vec<float>(D, k, v);
    err = rt::decode_launch<float>(a, kv, B, SK, TK, HC, smem, st);
  }
  return static_cast<int>(err);
}
