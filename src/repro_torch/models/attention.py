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
takes none.  ``cross_attention`` is the JAX ``"xla"`` path on both
backends, as in JAX (no Pallas kernel attends over the encoder memory).

Two more backends reach :func:`attention` only, as in JAX: ``"chunked"``
(:func:`attention_chunked`, an online softmax over KV chunks in plain
torch loops, no kernel in either package) and ``"stub"`` (the
roofline's calibration stand-in: the right shape and dtype, almost no
work, never a model).  Every other layer, the decode attentions
included, takes its plain path under these names, as the JAX layers take
their ``"xla"`` path for any backend but ``"pallas"``.

On a mesh (q, k, v DTensors) :func:`attention` runs on each rank's
local shards: attention is independent per row and head, and DTensor
has no strategy for the grouped product's flattening of a sharded head
dimension.  So q, k and v are first redistributed explicitly to one
placement that shards at most rows and heads (:func:`_local_placements`),
and the result is a DTensor of that placement.

The decode attentions do the same against a sharded cache
(:func:`_decode_local`, :func:`_paged_local`): each mesh dimension keeps
the cache's split of rows (``Shard(0)``; the per-row ``pos`` and
``starts`` are cut to the rank's rows) or of KV heads (``Shard(1)``),
q is brought to it, and a cache split another way is gathered for the
read.  The in-place cache writes (:func:`update_kv_cache`,
:func:`paged_update_kv`) act on the cache's local shard, k and v brought
to its placements first, so a write never moves the cache.  A paged
pool may be split over its KV heads only (its first dimension is
blocks, not rows); a contiguous cache over rows and KV heads only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_scheduled as decode_kernel,
    paged_decode_attention_scheduled as paged_kernel)
from repro_torch.kernels.flash_attention import flash_attention_scheduled
from repro_torch.models.layers import (ParamInit, Params, RopeTables,
                                       apply_rope, dense, placed_as,
                                       rmsnorm)

BACKENDS = ("plain", "cuda", "chunked", "stub")
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


def _local_placements(q, k, v, starts) -> list:
    """One placement for q, k and v under which attention is local: each
    mesh dimension keeps q's ``Shard(0)`` (rows; not with ``starts``,
    which index rows globally) or a ``Shard(1)`` (heads) that q, k and v
    share; every other mesh dimension is replicated."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pq, pk, pv in zip(q.placements, k.placements, v.placements):
        if pq == Shard(0) and starts is None:
            out.append(Shard(0))
        elif pq == pk == pv == Shard(1):
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return out


def _attention_local(q, k, v, **kw):
    """:func:`attention` of DTensors q, k, v on their local shards (see
    the module docstring)."""
    from torch.distributed.tensor import DTensor
    mesh = q.device_mesh
    place = _local_placements(q, k, v, kw.get("starts"))
    ql, kl, vl = (t.redistribute(mesh, place).to_local() for t in (q, k, v))
    return DTensor.from_local(attention(ql, kl, vl, **kw), mesh, place,
                              run_check=False)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              backend: str = "plain",
              starts: Optional[torch.Tensor] = None,
              schedule=None) -> torch.Tensor:
    """q [B,HQ,S,D]; k/v [B,HKV,S_kv,D] -> [B,HQ,S,D] (GQA aware).

    ``causal`` keeps keys ``kp <= qp``; ``window`` (local attention)
    keys ``kp > qp - window``.  ``starts`` ([B] int, optional) is each
    left-padded row's first real token: keys below it are masked for
    every query.  Queries inside the pad prefix are fully masked and
    their outputs are garbage that the caller discards (with ``"cuda"``
    they are zeros).  DTensor inputs run on their local shards."""
    _check_backend(backend)
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _attention_local(q, k, v, causal=causal, window=window,
                                backend=backend, starts=starts,
                                schedule=schedule)
    if backend == "cuda":
        return flash_attention_scheduled(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, starts=starts, schedule=schedule)
    if backend == "chunked":
        if starts is not None:
            raise NotImplementedError(
                "attention_chunked does not support per-row starts")
        return attention_chunked(q, k, v, causal=causal, window=window)
    if backend == "stub":
        return (v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
                + q * torch.zeros((), dtype=q.dtype, device=q.device))
    b, hq, s, d = q.shape
    hkv, s_kv = k.shape[1], k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, s, d).float()
    scale = 1.0 / (d ** 0.5)
    scores = torch.matmul(qg * scale, k.float()[:, :, None]
                          .transpose(-1, -2))             # [B,HKV,G,S,Skv]
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s_kv, device=q.device)[None, :]
    if causal:
        scores = scores.masked_fill(kpos > qpos, NEG)
    if window is not None:
        scores = scores.masked_fill(kpos <= qpos - window, NEG)
    if starts is not None:
        st = torch.as_tensor(starts, device=q.device).to(torch.int64)
        key_ok = kpos >= st[:, None]                      # [B, S]
        scores = scores.masked_fill(~key_ok[:, None, None, None, :], NEG)
    out = _softmax_pv(scores, v[:, :, None])
    return out.reshape(b, hq, s, d).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      chunk_q: int = 512, chunk_kv: int = 1024
                      ) -> torch.Tensor:
    """Flash-style attention in plain torch (JAX ``attention_chunked``):
    a loop over query chunks and, inside, over KV chunks carrying the
    running ``(m, l, acc)`` statistics, so the largest intermediate is
    one [CQ, CKV] score block per head, never [S, S].  ``chunk_q`` and
    ``chunk_kv`` are halved until they divide S.  Scores and statistics
    are float32; the probability block is rounded to bfloat16 for the
    P V product (accumulated in float32, v in its own dtype), as JAX
    does.  q [B,HQ,S,D], k/v
    [B,HKV,S,D] -> [B,HQ,S,D] in q's dtype."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    cq, ckv = min(chunk_q, s), min(chunk_kv, s)
    while s % cq:
        cq //= 2
    while s % ckv:
        ckv //= 2
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, group, s, d)
    outs = []
    for q0 in range(0, s, cq):
        qc = qg[:, :, :, q0:q0 + cq].float() * scale
        m = torch.full((b, hkv, group, cq, 1), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, group, cq, d), dtype=torch.float32,
                          device=q.device)
        qpos = torch.arange(q0, q0 + cq, device=q.device)[:, None]
        for k0 in range(0, s, ckv):
            kc = k[:, :, None, k0:k0 + ckv].float()
            sblk = torch.matmul(qc, kc.transpose(-1, -2))
            kpos = torch.arange(k0, k0 + ckv, device=q.device)[None, :]
            ok = torch.ones((cq, ckv), dtype=torch.bool, device=q.device)
            if causal:
                ok &= kpos <= qpos
            if window is not None:
                ok &= kpos > qpos - window
            sblk = torch.where(ok, sblk, torch.full_like(sblk, NEG))
            m_new = torch.maximum(m, sblk.amax(dim=-1, keepdim=True))
            p = torch.exp(sblk - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = torch.matmul(p.to(torch.bfloat16).float(),
                              v[:, :, None, k0:k0 + ckv].float())
            acc = acc * alpha + pv
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / l).to(q.dtype))
    return torch.cat(outs, dim=3).reshape(b, hq, s, d)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Unmasked attention over a fixed memory (the whisper decoder over
    the encoder's K/V [B,HKV,S_enc,D]): the plain path on every backend,
    as JAX runs its ``"xla"`` path here."""
    return attention(q, k, v, causal=False, backend="plain")


def mean_rows_before_start(ctx: torch.Tensor, v: torch.Tensor,
                           starts: torch.Tensor) -> torch.Tensor:
    """ctx [B,HQ,S,D] with every query row before its row's start (one
    with no valid key) replaced by the mean of its KV head's ``v``
    [B,HKV,S,D] over all S keys: what a softmax over scores that are
    all masked gives, the JAX xla/reference attention's value there and
    the plain path's.  The cuda kernels give zeros there, as the JAX
    Pallas flash kernel does.  A caller whose pad positions reach other
    tokens (a moe layer routes them, and they take expert capacity)
    restores the xla/reference value with it, so that a moe prefill on
    the card gives the plain path's tokens."""
    b, hq, s, d = ctx.shape
    group = hq // v.shape[1]
    mean = v.float().mean(dim=2).to(ctx.dtype)
    mean = mean.repeat_interleave(group, dim=1)[:, :, None, :]
    st = torch.as_tensor(starts, device=ctx.device).to(torch.int64)
    before = torch.arange(s, device=ctx.device)[None, :] < st[:, None]
    return torch.where(before[:, None, :, None], mean, ctx)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     window: Optional[int] = None, backend: str = "plain",
                     starts: Optional[torch.Tensor] = None,
                     schedule=None) -> torch.Tensor:
    """One-token attention against a contiguous cache.

    q [B,HQ,1,D]; caches [B,HKV,S,D]; ``pos`` (scalar or [B]) is the
    current position, entries past it are invalid; ``starts`` ([B],
    optional) masks each row's left-pad prefix.  With ``window`` the
    cache is a rolling buffer of S slots (slot ``p % S`` holds position
    p) and the valid slots are ``kpos <= min(pos, S-1)``: every slot
    once the buffer has wrapped.  The kernel's ``kpos <= pos`` is the
    same rule, so ``"cuda"`` takes no window (as the Pallas kernel).
    A DTensor cache runs on local shards (see the module docstring)."""
    _check_backend(backend)
    from torch.distributed.tensor import DTensor
    if isinstance(k_cache, DTensor):
        return _decode_local(q, k_cache, v_cache, pos, window=window,
                             backend=backend, starts=starts,
                             schedule=schedule)
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
    if window is not None:
        pos_b = pos_b.clamp_max(s - 1)
    valid = kpos <= pos_b[:, None]
    if starts is not None:
        st = torch.as_tensor(starts, device=q.device).to(torch.int64)
        valid &= kpos >= st[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _cache_placements(cache, allowed: Tuple[int, ...]) -> list:
    """Per mesh dimension, ``cache``'s ``Shard(d)`` for ``d`` in
    ``allowed``, ``Replicate()`` otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    return [pl if any(pl == Shard(d) for d in allowed) else Replicate()
            for pl in cache.placements]


def _rows_local(t, mesh, place):
    """A per-row tensor ``t`` [B] (plain, the same on every rank, or a
    DTensor) cut to this rank's rows under ``place``'s ``Shard(0)``
    dimensions; a scalar (plain or DTensor) as a plain tensor; None
    passes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if t is None:
        return None
    if not isinstance(t, DTensor):
        t = torch.as_tensor(t)
        if t.dim() == 0:
            return t
    if t.dim() == 0:
        return t.full_tensor()
    rows = [Shard(0) if pl == Shard(0) else Replicate() for pl in place]
    return placed_as(t, mesh, rows).to_local()


def _decode_local(q, k_cache, v_cache, pos, *, starts, **kw):
    """:func:`decode_attention` against a DTensor cache, on local shards
    (see the module docstring)."""
    from torch.distributed.tensor import DTensor
    mesh = k_cache.device_mesh
    place = _cache_placements(k_cache, (0, 1))
    ql, kl, vl = (placed_as(t, mesh, place).to_local()
                  for t in (q, k_cache, v_cache))
    out = decode_attention(ql, kl, vl, _rows_local(pos, mesh, place),
                           starts=_rows_local(starts, mesh, place), **kw)
    return DTensor.from_local(out, mesh, place, run_check=False)


def _full(t):
    """A DTensor gathered whole (others as they are)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _pool_placements(pool) -> list:
    """A paged pool's placements, which may split its KV heads only."""
    place = _cache_placements(pool, (1,))
    if list(pool.placements) != place:
        raise ValueError(f"a paged pool may be sharded over its KV heads "
                         f"(dim 1) only, got {tuple(pool.placements)}")
    return place


def _paged_local(q, pool_k, pool_v, tables, pos, **kw):
    """:func:`paged_decode_attention` against DTensor pools, on local
    shards: rows replicated, KV heads as the pool splits them."""
    from torch.distributed.tensor import DTensor
    mesh = pool_k.device_mesh
    place = _pool_placements(pool_k)
    out = paged_decode_attention(
        placed_as(q, mesh, place).to_local(), pool_k.to_local(),
        pool_v.to_local(), _full(tables), _full(pos), **kw)
    return DTensor.from_local(out, mesh, place, run_check=False)


def _local_heads(pool, hkv: int) -> torch.Tensor:
    """The global indices of the KV heads in ``pool``'s local shard."""
    from torch.distributed.tensor import Replicate, Shard
    heads = torch.arange(hkv, device=pool.to_local().device)
    place = [Shard(0) if pl == Shard(1) else Replicate()
             for pl in _pool_placements(pool)]
    return placed_as(heads, pool.device_mesh, place).to_local()


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
    sink.  DTensor pools are written on their local shards: ``slots``
    (global, from the pool's full shape) are renumbered for the local
    KV heads."""
    from torch.distributed.tensor import DTensor
    if isinstance(pool_k, DTensor):
        mesh = pool_k.device_mesh
        place = _pool_placements(pool_k)
        hkv, bs = pool_k.shape[1], pool_k.shape[2]
        heads = _local_heads(pool_k, hkv)
        sl = _full(slots).reshape(-1, hkv)[:, heads]       # [B, HKV_l]
        local = ((sl // (hkv * bs)) * heads.numel()
                 + torch.arange(heads.numel(), device=sl.device)) * bs \
            + sl % bs
        paged_update_kv(pool_k.to_local(), pool_v.to_local(),
                        placed_as(k, mesh, place).to_local(),
                        placed_as(v, mesh, place).to_local(),
                        local.reshape(-1))
        return pool_k, pool_v
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
    (its ``block_kv`` rounded up to the pool block).  DTensor pools run
    on local shards (see the module docstring)."""
    _check_backend(backend)
    from torch.distributed.tensor import DTensor
    if isinstance(pool_k, DTensor):
        return _paged_local(q, pool_k, pool_v, tables, pos,
                            backend=backend, schedule=schedule)
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
    """Stacked attention weights under ``prefix`` (same paths and
    logical axes as JAX)."""
    b.normal(f"{prefix}/wq", [n_layers, d, n_heads * hd],
             ("layers", "embed", "heads"), fan_in=d)
    b.normal(f"{prefix}/wk", [n_layers, d, n_kv * hd],
             ("layers", "embed", "kv_heads"), fan_in=d)
    b.normal(f"{prefix}/wv", [n_layers, d, n_kv * hd],
             ("layers", "embed", "kv_heads"), fan_in=d)
    b.normal(f"{prefix}/wo", [n_layers, n_heads * hd, d],
             ("layers", "heads", "embed"), fan_in=n_heads * hd)
    if qk_norm:
        b.zeros(f"{prefix}/q_norm", [n_layers, hd], ("layers", None))
        b.zeros(f"{prefix}/k_norm", [n_layers, hd], ("layers", None))


def heads_divide(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` [..., n * hd], a DTensor whose last dimension is split over
    more shards than ``n`` heads divide (the rules shard ``n * hd``
    whenever it divides, e.g. 8 KV heads of 128 on 16 devices), with
    that dimension replicated: the split into heads needs whole heads on
    each shard.  Other tensors pass."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    last = t.ndim - 1
    dims = [i for i, pl in enumerate(t.placements)
            if pl.is_shard() and pl.dim in (last, -1)]
    ways = 1
    for i in dims:
        ways *= t.device_mesh.size(i)
    if n % ways == 0:
        return t
    place = [Replicate() if i in dims else pl
             for i, pl in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, place)


def qkv_project(x: torch.Tensor, p: Params, *, n_heads: int, n_kv: int,
                hd: int, rope: Optional[RopeTables], qk_norm: bool,
                use_rope: bool = True, norm_eps: float = 1e-6
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> q [B,HQ,S,hd], k/v [B,HKV,S,hd] (contiguous); ``rope``
    holds the step's :func:`~repro_torch.models.layers.rope_tables`
    (unused, and may be None, with ``use_rope=False``: the whisper
    encoder has no rotary positions).  On a mesh a projection split
    over more shards than its heads divide is replicated over them
    before the split into heads (:func:`heads_divide`)."""
    b_, s, _ = x.shape
    q = heads_divide(dense(x, p["wq"]), n_heads).reshape(
        b_, s, n_heads, hd).transpose(1, 2)
    k = heads_divide(dense(x, p["wk"]), n_kv).reshape(
        b_, s, n_kv, hd).transpose(1, 2)
    v = heads_divide(dense(x, p["wv"]), n_kv).reshape(
        b_, s, n_kv, hd).transpose(1, 2)
    if qk_norm:
        q = rmsnorm(q, p["q_norm"], norm_eps)
        k = rmsnorm(k, p["k_norm"], norm_eps)
    if use_rope:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)
    return q.contiguous(), k.contiguous(), v.contiguous()


def merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """ctx [B,H,S,hd] -> [B,S,H*hd].  A DTensor is merged on its local
    shard (rows, heads or sequence split as ctx splits them): the
    backward pass splits the merged gradient into heads again, which
    DTensor refuses (torch 2.11) when its own choice of placement has
    split the merged dimension across heads; the local merge's backward
    brings the gradient to ctx's placements first."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(ctx, DTensor):
        b_, h, s, hd = ctx.shape
        return ctx.transpose(1, 2).reshape(b_, s, h * hd)
    to = {0: 0, 1: 2, 2: 1}          # ctx's dim -> the merged one's
    if any(pl.is_shard() and pl.dim not in to for pl in ctx.placements):
        raise ValueError(f"head_dim of ctx is split: {ctx.placements}")
    place = [Shard(to[pl.dim]) if pl.is_shard() else pl
             for pl in ctx.placements]
    return DTensor.from_local(merge_heads(ctx.to_local()), ctx.device_mesh,
                              place, run_check=False)


def attn_out(ctx: torch.Tensor, p: Params) -> torch.Tensor:
    """ctx [B,H,S,hd] -> [B,S,D] (:func:`merge_heads`, then ``wo``)."""
    return dense(merge_heads(ctx), p["wo"])


def update_kv_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one step's k/v [B,HKV,1,hd] at slot ``pos`` (an int64
    tensor of one element on the cache's device; with ``window``, slot
    ``pos % S`` of a rolling buffer of S slots), in place where the JAX
    version rebuilds the cache; returns the same tensors.  The slot is
    an index op on the device, so the host reads no value and a captured
    step writes where ``pos`` points at each replay.  A DTensor cache is
    written on its local shard (rows and KV heads; see the module
    docstring)."""
    from torch.distributed.tensor import DTensor
    if isinstance(cache_k, DTensor):
        mesh = cache_k.device_mesh
        place = _cache_placements(cache_k, (0, 1))
        if list(cache_k.placements) != place:
            raise ValueError(f"a cache written in place may be sharded "
                             f"over rows and KV heads only, got "
                             f"{tuple(cache_k.placements)}")
        update_kv_cache(cache_k.to_local(), cache_v.to_local(),
                        placed_as(k, mesh, place).to_local(),
                        placed_as(v, mesh, place).to_local(),
                        _rows_local(pos, mesh, place), window=window)
        return cache_k, cache_v
    idx = pos.reshape(1)
    if window is not None:
        idx = torch.remainder(idx, cache_k.shape[2])
    cache_k.index_copy_(2, idx, k.to(cache_k.dtype))
    cache_v.index_copy_(2, idx, v.to(cache_v.dtype))
    return cache_k, cache_v


__all__ = ["BACKENDS", "attention", "attention_chunked", "cross_attention",
           "heads_divide",
           "mean_rows_before_start",
           "decode_attention", "paged_slots",
           "paged_update_kv",
           "paged_decode_attention", "attn_params", "qkv_project",
           "merge_heads", "attn_out", "update_kv_cache"]
