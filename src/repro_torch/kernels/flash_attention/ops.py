"""Wrapper of the CUDA flash-attention kernel (prefill).

Replaces ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_pallas``).  On an H100 the kernel is bound by bytes
at the engine's prefill lengths (S <= 512): it reads Q, K and V once and
writes O once, and its causal operation count stays far below the
card's ridge; a row that walks more than ~600 keys (S / 2 operations a
byte without the mask: whisper's 1500-frame encoder; recurrentgemma's
4096-token bucket) is bound by operations.  Its design
(``csrc/flash_wgmma.cu``, ``csrc/flash_attention.cu``): one block per
(batch x query head, 64- or 128-row query tile), K/V tiles staged in
shared memory, f32 online softmax in registers, only the KV tiles the
mask can reach are visited, GQA by indexing the KV head.  The body follows the dtype
(``_geometry.tensor_cores``) and, in bf16, the head dim
(``_geometry.flash_body``): at D 64, 96, 128 or 256 wgmma with K/V by
TMA into a ring of stages and a producer warp (``"wgmma"``,
``csrc/flash_wgmma.cu``, layout ``_geometry.flash_wgmma_tile``), at
every length; at other head dims FlashAttention-2 on mma.sync with K/V
double-buffered by cp.async (``"mma"``, layout
``_geometry.flash_mma_tile``); both multiply P V in f32 from a bf16 hi
+ lo split of p.  float32 runs the CUDA-core body in IEEE fp32.  They
take any GQA group and 1 <= D <= 256 (``MAX_HEAD_DIM``).

The bf16 body's block of query rows is a launch parameter: 64 rows (4
warps, the default) or 128 (8 warps), at 64-key tiles; the float32 body
has one 64 x 32 tile (``_geometry.flash_tile_error``).
:func:`flash_attention_scheduled` takes them from a
:class:`~repro_torch.core.schedule.FlashAttentionSchedule`, and
:func:`flash_attention_dispatched` from the port's dispatch service.

For a CPU tensor the wrapper runs :func:`flash_attention_ref` (which has
no blocks); for a CUDA tensor it launches the kernel or raises, also on
a tile the body refuses: no body stands in for another.
``flash_attention.launches`` counts every launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same,
                                         int_vector, on_cpu, q_scale,
                                         require)
from repro_torch.kernels._geometry import (FLASH_MAX_D, flash_body,
                                           flash_default_tile,
                                           flash_tile_error, tensor_cores)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

MAX_HEAD_DIM = FLASH_MAX_D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    starts: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None) -> torch.Tensor:
    """q [B,HQ,S,D]; k/v [B,HKV,S,D] -> [B,HQ,S,D] (see
    :func:`flash_attention_ref` for the exact function).

    ``starts`` ([B] int, optional) masks keys below each row's first
    real token; ``window`` keeps keys with ``kp > qp - window``.
    ``block_q`` / ``block_kv`` (None: the body's default tile) are the
    query rows and keys of a block's tile; a tile the body refuses
    raises."""
    if on_cpu(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   starts=starts)
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
            "flash_attention: q, k, v must be [B,H,S,D]")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    require(k.shape == (b, hkv, s, d) and v.shape == k.shape,
            f"flash_attention: k/v shape {tuple(k.shape)} does not match "
            f"q {tuple(q.shape)}")
    require(hq % hkv == 0, "flash_attention: HQ must be a multiple of HKV")
    require(q.dtype in KERNEL_DTYPES,
            f"flash_attention: dtype {q.dtype} not supported")
    eb = q.element_size()
    rows0, keys0 = flash_default_tile(eb)
    rows = rows0 if block_q is None else int(block_q)
    keys = keys0 if block_kv is None else int(block_kv)
    err = flash_tile_error(d, eb, rows, keys)
    require(err is None, f"flash_attention: {err}")
    require(window is None or window > 0, "flash_attention: window <= 0")
    body = flash_body(d, eb)
    check_same("flash_attention", [q, k, v], q.dtype)
    st = (None if starts is None
          else int_vector(starts, b, q.device, "starts"))
    out = torch.empty_like(q)
    lib = _build.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if st is None else st.data_ptr(), b, hq, hkv, s, d,
            int(bool(causal)), int(window or 0), q_scale(q))
    if body == "wgmma":
        rc = lib.flash_attention_wgmma_fwd(*args, rows, keys,
                                           _build.stream_handle(q.device))
        _build.check(rc, "flash_attention_wgmma_fwd")
    else:
        rc = lib.flash_attention_fwd(*args, int(tensor_cores(eb)), rows,
                                     keys, _build.stream_handle(q.device))
        _build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
    _launches.note("flash_attention", block_q=rows, block_kv=keys)
    return out


flash_attention.launches = 0


def flash_attention_scheduled(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, schedule=None,
                              causal: bool = True,
                              window: Optional[int] = None,
                              starts: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """:func:`flash_attention` with a
    :class:`~repro_torch.core.schedule.FlashAttentionSchedule`'s tile
    (a tile the body refuses raises before any launch; None: the
    default tile)."""
    if schedule is None:
        return flash_attention(q, k, v, causal=causal, window=window,
                               starts=starts)
    return flash_attention(q, k, v, causal=causal, window=window,
                           starts=starts, block_q=schedule.block_q,
                           block_kv=schedule.block_kv)


def flash_attention_dispatched(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: Optional[int] = None,
                               starts: Optional[torch.Tensor] = None,
                               service=None) -> torch.Tensor:
    """:func:`flash_attention` through the port's dispatch service: the
    tile comes from the registry-backed top-K for this (B, HQ, HKV, S,
    D) shape, and the call's time (synchronised on the card) feeds the
    selector, which commits and writes back once steady."""
    from repro_torch.runtime.dispatch import get_dispatch_service
    b, hq, s, d = q.shape
    svc = service if service is not None else get_dispatch_service()
    problem = {"b": b, "hq": hq, "hkv": k.shape[1], "s": s, "d": d,
               "causal": bool(causal)}
    with svc.measure("flash_attention", problem,
                     elem_bytes=q.element_size(), device=q.device) as sched:
        out = flash_attention_scheduled(q, k, v, schedule=sched,
                                        causal=causal, window=window,
                                        starts=starts)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out


__all__ = ["flash_attention", "flash_attention_scheduled",
           "flash_attention_dispatched", "MAX_HEAD_DIM"]
