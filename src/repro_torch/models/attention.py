"""Attention of the dense decoder (port of ``repro.models.attention``).

Backends: ``"plain"`` is the PyTorch counterpart of the JAX package's
``"xla"`` path (q upcast to float32 before the ``1/sqrt(D)`` scale);
``"cuda"`` goes through the port's hand-written kernels, whose wrappers
scale q in q's dtype as the Pallas entries do and run the kernels' plain
versions for CPU tensors.  With ``"cuda"`` each kernel call takes the
launch parameters of its ``schedule`` (a committed
:class:`~repro_torch.core.schedule.FlashAttentionSchedule` or
:class:`~repro_torch.core.schedule.DecodeAttentionSchedule`; None: the
kernel's defaults); the plain path has no launch to set.  The paged
decode kernel honours its schedule, where the JAX package's paged kernel
takes none.  The JAX ``chunked`` and ``stub`` backends and
``cross_attention`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_scheduled as decode_kernel,
    paged_decode_attention_scheduled as paged_kernel)
from repro_torch.kernels.flash_attention import flash_attention_scheduled
from repro_torch.models.layers import (ParamInit, Params, RopeTables,
                                       apply_rope, dense, rmsnorm)

BACKENDS = ("plain", "cuda")
NEG = -1e30


def _check_backend(backend: str) -> None:
    """Raise on a backend name the port does not have."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(scores) @ v in float32 (v upcast)."""
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, v.float())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              backend: str = "plain",
              starts: Optional[torch.Tensor] = None,
              schedule=None) -> torch.Tensor:
    """Causal attention: q [B,HQ,S,D]; k/v [B,HKV,S,D] -> [B,HQ,S,D]
    (GQA aware).  The sliding-window variant comes with the hybrid
    family; the kernel already takes ``window``.

    ``starts`` ([B] int, optional) is each left-padded row's first real
    token: keys below it are masked for every query.  Queries inside the
    pad prefix are fully masked and their outputs are garbage that the
    caller discards (with ``"cuda"`` they are zeros)."""
    _check_backend(backend)
    if backend == "cuda":
        return flash_attention_scheduled(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            starts=starts, schedule=schedule)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, s, d).float()
    scale = 1.0 / (d ** 0.5)
    scores = torch.matmul(qg * scale, k.float()[:, :, None]
                          .transpose(-1, -2))             # [B,HKV,G,S,S]
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    scores = scores.masked_fill(kpos > qpos, NEG)
    if starts is not None:
        st = torch.as_tensor(starts, device=q.device).to(torch.int64)
        key_ok = kpos >= st[:, None]                      # [B, S]
        scores = scores.masked_fill(~key_ok[:, None, None, None, :], NEG)
    out = _softmax_pv(scores, v[:, :, None])
    return out.reshape(b, hq, s, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *, backend: str = "plain",
                     starts: Optional[torch.Tensor] = None,
                     schedule=None) -> torch.Tensor:
    """One-token attention against a contiguous cache.

    q [B,HQ,1,D]; caches [B,HKV,S,D]; ``pos`` (scalar or [B]) is the
    current position, entries past it are invalid; ``starts`` ([B],
    optional) masks each row's left-pad prefix."""
    _check_backend(backend)
    if backend == "cuda":
        return decode_kernel(q.contiguous(), k_cache, v_cache, pos,
                             starts=starts, schedule=schedule)
    b, hq, _, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d).float()
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bhgd,bhkd->bhgk", qg * scale, k_cache.float())
    kpos = torch.arange(s, device=q.device)[None, :]
    pos_b = torch.as_tensor(pos, device=q.device).to(torch.int64)
    pos_b = pos_b.expand(b) if pos_b.dim() == 0 else pos_b
    valid = kpos <= pos_b[:, None]
    if starts is not None:
        st = torch.as_tensor(starts, device=q.device).to(torch.int64)
        valid &= kpos >= st[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def paged_slots(tables: torch.Tensor, pos: torch.Tensor, hkv: int,
                bs: int) -> torch.Tensor:
    """[B*HKV] row indices into a pool viewed as [NB*HKV*bs, D] where
    each row's token at logical position ``pos[b]`` goes: pool block
    ``tables[b, pos[b] // bs]``, slot ``pos[b] % bs``, for every KV head.
    The same for every layer of a step, so a step computes it once."""
    pos_l = pos.to(torch.int64)
    rows = torch.arange(tables.shape[0], device=tables.device)
    blk = tables.to(torch.int64)[rows, pos_l // bs]            # [B]
    heads = torch.arange(hkv, device=tables.device)
    return ((blk[:, None] * hkv + heads[None, :]) * bs
            + (pos_l % bs)[:, None]).reshape(-1)


def paged_update_kv(pool_k: torch.Tensor, pool_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step's k/v [B,HKV,1,D] into the block pools
    [NB,HKV,bs,D] at :func:`paged_slots`.

    The JAX version rebuilds the pools (``.at[].set``); this one writes
    them in place with ``index_copy_`` and returns the same tensors.
    Idle rows point at the reserved block 0, so their writes land in the
    sink."""
    nb, hkv, bs, d = pool_k.shape
    n = k.shape[0] * hkv
    pool_k.view(nb * hkv * bs, d).index_copy_(
        0, slots, k[:, :, 0, :].reshape(n, d).to(pool_k.dtype))
    pool_v.view(nb * hkv * bs, d).index_copy_(
        0, slots, v[:, :, 0, :].reshape(n, d).to(pool_v.dtype))
    return pool_k, pool_v


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *, backend: str = "plain",
                           schedule=None) -> torch.Tensor:
    """One-token attention against a block-paged pool.

    q [B,HQ,1,D]; pools [NB,HKV,bs,D]; tables [B,MB]; pos [B].  Row
    ``b`` attends to logical keys ``0..pos[b]`` through its table; the
    plain path gathers the table's blocks (reference semantics), the
    ``"cuda"`` kernel reads them in place, split as ``schedule`` says
    (its ``block_kv`` rounded up to the pool block)."""
    _check_backend(backend)
    if backend == "cuda":
        return paged_kernel(q.contiguous(), pool_k, pool_v, tables, pos,
                            schedule=schedule)
    b, hq, _, d = q.shape
    _, hkv, bs, _ = pool_k.shape
    mb = tables.shape[1]
    idx = tables.to(device=q.device, dtype=torch.int64)
    kg = pool_k[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    vg = pool_v[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    scale = 1.0 / (d ** 0.5)
    scores = torch.einsum("bhgd,bhkd->bhgk", qg * scale, kg.float())
    pos_b = pos.to(device=q.device, dtype=torch.int64)
    valid = (torch.arange(mb * bs, device=q.device)[None, :]
             <= pos_b[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, vg.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def attn_params(b: ParamInit, prefix: str, n_layers: int, d: int,
                n_heads: int, n_kv: int, hd: int, qk_norm: bool) -> None:
    """Stacked attention weights under ``prefix`` (same paths as JAX)."""
    b.normal(f"{prefix}/wq", [n_layers, d, n_heads * hd], fan_in=d)
    b.normal(f"{prefix}/wk", [n_layers, d, n_kv * hd], fan_in=d)
    b.normal(f"{prefix}/wv", [n_layers, d, n_kv * hd], fan_in=d)
    b.normal(f"{prefix}/wo", [n_layers, n_heads * hd, d],
             fan_in=n_heads * hd)
    if qk_norm:
        b.zeros(f"{prefix}/q_norm", [n_layers, hd])
        b.zeros(f"{prefix}/k_norm", [n_layers, hd])


def qkv_project(x: torch.Tensor, p: Params, *, n_heads: int, n_kv: int,
                hd: int, rope: RopeTables, qk_norm: bool,
                norm_eps: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> q [B,HQ,S,hd], k/v [B,HKV,S,hd] (contiguous); ``rope``
    holds the step's :func:`~repro_torch.models.layers.rope_tables`."""
    b_, s, _ = x.shape
    q = dense(x, p["wq"]).reshape(b_, s, n_heads, hd).transpose(1, 2)
    k = dense(x, p["wk"]).reshape(b_, s, n_kv, hd).transpose(1, 2)
    v = dense(x, p["wv"]).reshape(b_, s, n_kv, hd).transpose(1, 2)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"], norm_eps)
        k = rmsnorm(k, p["k_norm"], norm_eps)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    return q.contiguous(), k.contiguous(), v.contiguous()


def attn_out(ctx: torch.Tensor, p: Params) -> torch.Tensor:
    """ctx [B,H,S,hd] -> [B,S,D]."""
    b_, h, s, hd = ctx.shape
    return dense(ctx.transpose(1, 2).reshape(b_, s, h * hd), p["wo"])


def update_kv_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one step's k/v [B,HKV,1,hd] at slot ``pos`` (an int64
    tensor of one element on the cache's device), in place where the
    JAX version rebuilds the cache; returns the same tensors.  The slot
    is an index op on the device, so the host reads no value and a
    captured step writes where ``pos`` points at each replay."""
    idx = pos.reshape(1)
    cache_k.index_copy_(2, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(2, idx, v.to(cache_v.dtype))
    return cache_k, cache_v


__all__ = ["BACKENDS", "attention", "decode_attention", "paged_slots",
           "paged_update_kv",
           "paged_decode_attention", "attn_params", "qkv_project",
           "attn_out", "update_kv_cache"]
