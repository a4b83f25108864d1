"""Wrappers of the CUDA decode kernels (contiguous and paged).

``decode_attention`` replaces ``decode_attention_pallas`` and
``paged_decode_attention`` replaces ``paged_decode_attention_pallas``
(both in ``src/repro/kernels/decode_attention/kernel.py``).  On an H100
both are bound by bytes: every step streams each row's valid K/V once at
about one operation per byte.  Their design (``csrc/decode_common.cuh``):
one block per (row, KV head) serving all the query heads of that group,
eight warps splitting the valid keys in chunks of eight with all of a
chunk's loads in flight together, f32 online softmax per warp, a shared-memory
merge; keys outside the row's window, and for the paged kernel logical
blocks past ``pos``, are never read.

For CPU tensors the wrappers run the plain versions in ``ref.py``; for
CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same,
                                         int32_vector, on_cpu, q_scale,
                                         require)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

MAX_HEAD_DIM = 128
MAX_GROUP = 8


def _check_q(name: str, q: torch.Tensor, hkv: int) -> None:
    """Shape, dtype and head checks shared by both decode wrappers."""
    require(q.dim() == 4 and q.shape[2] == 1,
            f"{name}: q must be [B,HQ,1,D], got {tuple(q.shape)}")
    hq, d = q.shape[1], q.shape[3]
    require(hq % hkv == 0 and hq // hkv <= MAX_GROUP,
            f"{name}: HQ={hq} must be a multiple of HKV={hkv} with at "
            f"most {MAX_GROUP} query heads per KV head")
    require(1 <= d <= MAX_HEAD_DIM,
            f"{name}: head_dim {d} not in [1, {MAX_HEAD_DIM}]")
    require(q.dtype in KERNEL_DTYPES, f"{name}: dtype {q.dtype} not "
            f"supported")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, *, starts: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q [B,HQ,1,D]; k/v [B,HKV,S,D]; ``pos`` scalar or [B]; ``starts``
    optional [B].  Valid keys: ``starts[b] <= kp <= pos[b]``."""
    if on_cpu(q):
        return decode_attention_ref(q, k, v, pos, starts=starts)
    name = "decode_attention"
    require(k.dim() == 4, f"{name}: k must be [B,HKV,S,D]")
    b, hq, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    _check_q(name, q, hkv)
    require(k.shape == (b, hkv, s, d) and v.shape == k.shape,
            f"{name}: cache shape {tuple(k.shape)} does not match q")
    check_same(name, [q, k, v], q.dtype)
    pos_t = int32_vector(pos, b, q.device, "pos")
    st = (None if starts is None
          else int32_vector(starts, b, q.device, "starts"))
    out = torch.empty_like(q)
    rc = _build.load().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos_t.data_ptr(), None if st is None else st.data_ptr(),
        b, hq, hkv, s, d, q_scale(q), int(q.dtype == torch.bfloat16),
        _build.stream_handle(q.device))
    _build.check(rc, "decode_attention_fwd")
    decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """q [B,HQ,1,D]; pools [NB,HKV,bs,D]; tables [B,MB] int; pos [B].

    Row ``b`` attends to its logical keys ``0..pos[b]``; logical key
    ``p`` lives in pool block ``tables[b, p // bs]`` at slot ``p % bs``.
    Table entries past ``pos[b] // bs`` are never read."""
    if on_cpu(q):
        return paged_decode_attention_ref(q, k_pool, v_pool, tables, pos)
    name = "paged_decode_attention"
    require(k_pool.dim() == 4, f"{name}: pools must be [NB,HKV,bs,D]")
    b, hq, _, d = q.shape
    nb, hkv, bs, _ = k_pool.shape
    _check_q(name, q, hkv)
    require(k_pool.shape == (nb, hkv, bs, d) and v_pool.shape ==
            k_pool.shape, f"{name}: pool shape {tuple(k_pool.shape)} "
            f"does not match q")
    require(tables.dim() == 2 and tables.shape[0] == b,
            f"{name}: tables must be [B,MB]")
    check_same(name, [q, k_pool, v_pool], q.dtype)
    tb = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos_t = int32_vector(pos, b, q.device, "pos")
    out = torch.empty_like(q)
    rc = _build.load().paged_decode_attention_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        out.data_ptr(), tb.data_ptr(), pos_t.data_ptr(), b, hq, hkv, bs,
        tables.shape[1], d, q_scale(q), int(q.dtype == torch.bfloat16),
        _build.stream_handle(q.device))
    _build.check(rc, "paged_decode_attention_fwd")
    paged_decode_attention.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0

__all__ = ["decode_attention", "paged_decode_attention"]
