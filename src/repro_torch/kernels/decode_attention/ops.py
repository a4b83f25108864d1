"""Wrappers of the CUDA decode kernels (contiguous and paged).

``decode_attention`` replaces ``decode_attention_pallas`` and
``paged_decode_attention`` replaces ``paged_decode_attention_pallas``
(both in ``src/repro/kernels/decode_attention/kernel.py``).  On an H100
both are bound by bytes: every step streams each row's valid K/V once at
about one operation per byte.  Their design (``csrc/decode_common.cuh``)
splits each row's keys across blocks (flash-decoding): the grid is
(row x KV head x head chunk, splits), each block stages its split's
valid keys by cp.async and keeps an f32 online softmax per query head,
and the last block of a row to finish merges the f32 partials in the
same launch.  The split plan is ``_geometry.decode_plan``, fixed by the
static shapes alone (never by ``pos`` or ``starts``, which stay on the
device); ``block_kv`` (a
:class:`~repro_torch.core.schedule.DecodeAttentionSchedule`'s, through
the ``*_scheduled`` and ``*_dispatched`` entries) sets the keys a split
takes in its place: a multiple of 16 for the contiguous kernel, rounded
up to the pool block for the paged one, so split boundaries fall on
pool blocks.  A split the kernel refuses raises before any launch.
Keys outside the row's window, and for the paged kernel logical blocks
past ``pos``, are never read.

The merge finds the last block through a ticket counter per grid row.
The counters are zeroed once and kept per (device, stream) here, since
two launches running at once on two streams would draw each other's
tickets; each launch's last blocks leave them at zero again
(``csrc/decode_common.cuh``), so a CUDA graph's replay needs no memset.
A graph bakes in the counters' address.  They must exist before its
capture: counters first made inside a capture would come from the
graph's private memory pool and stay cached here for eager launches on
that stream.  A :class:`~repro_torch.serving.captured.CapturedStep`
warms up on the capture stream first, which makes them; a first use
inside a capture raises.  Every graph shares one capture stream, so a
later build may need more counters than its stream holds: the larger
counters replace the old ones for new launches, and the old ones are
kept, never freed, since a graph captured earlier still uses them.

For CPU tensors the wrappers run the plain versions in ``ref.py``; for
CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same,
                                         int_vector, on_cpu, q_scale,
                                         require)
from repro_torch.kernels._geometry import DEC_MAX_D, DecodePlan, decode_plan
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

MAX_HEAD_DIM = DEC_MAX_D

# (device index, raw stream) -> zeroed int32 ticket counters
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
# counters that larger ones replaced: a graph may hold their address
_RETIRED: List[torch.Tensor] = []


def _check_q(name: str, q: torch.Tensor, hkv: int) -> None:
    """Shape, dtype and head checks shared by both decode wrappers: any
    group (HQ a multiple of HKV), 1 <= D <= 256, bf16 or float32."""
    require(q.dim() == 4 and q.shape[2] == 1,
            f"{name}: q must be [B,HQ,1,D], got {tuple(q.shape)}")
    hq, d = q.shape[1], q.shape[3]
    require(hkv >= 1 and hq % hkv == 0,
            f"{name}: HQ={hq} must be a multiple of HKV={hkv}")
    require(1 <= d <= MAX_HEAD_DIM,
            f"{name}: head_dim {d} not in [1, {MAX_HEAD_DIM}]")
    require(q.dtype in KERNEL_DTYPES, f"{name}: dtype {q.dtype} not "
            f"supported")


def _plan(name: str, q: torch.Tensor, hkv: int, limit: int,
          block_size: int, split_keys: Optional[int]) -> DecodePlan:
    """The call's split plan from its static shapes (and the split, when
    given); raises on one the kernel cannot run."""
    b, hq, _, d = q.shape
    plan = decode_plan(b, hq, hkv, d, limit, block_size, q.element_size(),
                       split_keys)
    require(plan.error is None, f"{name}: {plan.error}")
    return plan


def paged_split_keys(block_kv: int, block_size: int) -> int:
    """The paged kernel's split for a schedule's ``block_kv``: rounded up
    to a whole number of pool blocks."""
    return -(-int(block_kv) // block_size) * block_size


def _scratch(plan: DecodePlan, device: torch.device):
    """(partials workspace or None, ticket counters) for one launch: the
    workspace from the caching allocator (no launch), the counters those
    of the current stream, zeroed when first made or grown (never
    inside a CUDA graph capture; the ones they replace are kept: see
    the module's docstring)."""
    ws = (torch.empty(plan.workspace_floats, dtype=torch.float32,
                      device=device) if plan.workspace_floats else None)
    key = (device.index, _build.stream_handle(device))
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < plan.tickets:
        require(not torch.cuda.is_current_stream_capturing(),
                "decode ticket counters must exist before a CUDA graph "
                "capture: warm the step up on the capture stream first")
        if tickets is not None:
            _RETIRED.append(tickets)
        tickets = torch.zeros(max(plan.tickets, 4096), dtype=torch.int32,
                              device=device)
        _TICKETS[key] = tickets
    return ws, tickets


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, *, starts: Optional[torch.Tensor] = None,
                     block_kv: Optional[int] = None) -> torch.Tensor:
    """q [B,HQ,1,D]; k/v [B,HKV,S,D]; ``pos`` scalar or [B]; ``starts``
    optional [B].  Valid keys: ``starts[b] <= kp <= pos[b]``.
    ``block_kv`` (None: the plan's own) is the keys a split takes."""
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
    plan = _plan(name, q, hkv, s, 0, block_kv)
    pos_t = int_vector(pos, b, q.device, "pos")
    # int64, the model's own dtype: its starts pass without a conversion
    st = (None if starts is None
          else int_vector(starts, b, q.device, "starts", torch.int64))
    out = torch.empty_like(q)
    ws, tickets = _scratch(plan, q.device)
    rc = _build.load().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos_t.data_ptr(), None if st is None else st.data_ptr(),
        None if ws is None else ws.data_ptr(), tickets.data_ptr(),
        b, hq, hkv, s, d, plan.split_keys,
        plan.tile_keys, plan.head_chunk, plan.smem, q_scale(q),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    _build.check(rc, "decode_attention_fwd")
    decode_attention.launches += 1
    _launches.note(name, block_kv=block_kv, split_keys=plan.split_keys,
                   splits=plan.splits)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           block_kv: Optional[int] = None) -> torch.Tensor:
    """q [B,HQ,1,D]; pools [NB,HKV,bs,D]; tables [B,MB] int; pos [B].

    Row ``b`` attends to its logical keys ``0..pos[b]``; logical key
    ``p`` lives in pool block ``tables[b, p // bs]`` at slot ``p % bs``.
    Table entries past ``pos[b] // bs`` are never read.  ``block_kv``
    (None: the plan's own) is the keys a split takes, rounded up to the
    pool block (:func:`paged_split_keys`)."""
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
    mb = tables.shape[1]
    plan = _plan(name, q, hkv, mb * bs, bs,
                 None if block_kv is None
                 else paged_split_keys(block_kv, bs))
    tb = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos_t = int_vector(pos, b, q.device, "pos")
    out = torch.empty_like(q)
    ws, tickets = _scratch(plan, q.device)
    rc = _build.load().paged_decode_attention_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        out.data_ptr(), tb.data_ptr(), pos_t.data_ptr(),
        None if ws is None else ws.data_ptr(), tickets.data_ptr(), b, hq,
        hkv, bs, mb, d, plan.split_keys, plan.tile_keys, plan.head_chunk,
        plan.smem, q_scale(q), int(q.dtype == torch.bfloat16),
        _build.stream_handle(q.device))
    _build.check(rc, "paged_decode_attention_fwd")
    paged_decode_attention.launches += 1
    _launches.note(name, block_kv=block_kv, split_keys=plan.split_keys,
                   splits=plan.splits)
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0


def decode_attention_scheduled(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, pos, *, schedule=None,
                               starts: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """:func:`decode_attention` split as a
    :class:`~repro_torch.core.schedule.DecodeAttentionSchedule` says
    (None: the plan's own split)."""
    return decode_attention(
        q, k, v, pos, starts=starts,
        block_kv=None if schedule is None else schedule.block_kv)


def paged_decode_attention_scheduled(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     tables: torch.Tensor, pos: torch.Tensor,
                                     *, schedule=None) -> torch.Tensor:
    """:func:`paged_decode_attention` split as a
    :class:`~repro_torch.core.schedule.DecodeAttentionSchedule` says
    (rounded up to the pool block; None: the plan's own split).  The
    reference's paged kernel takes no schedule; this one honours it."""
    return paged_decode_attention(
        q, k_pool, v_pool, tables, pos,
        block_kv=None if schedule is None else schedule.block_kv)


def decode_attention_dispatched(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, pos, *,
                                starts: Optional[torch.Tensor] = None,
                                service=None) -> torch.Tensor:
    """:func:`decode_attention` through the port's dispatch service: the
    split for this (B, HQ, HKV, S, D) cache comes from the
    registry-backed top-K, and the call's time (synchronised on the
    card) feeds the selector, which commits and writes back once
    steady."""
    from repro_torch.runtime.dispatch import get_dispatch_service
    b, hq, _, d = q.shape
    svc = service if service is not None else get_dispatch_service()
    problem = {"b": b, "hq": hq, "hkv": k.shape[1], "s": k.shape[2],
               "d": d}
    with svc.measure("decode_attention", problem,
                     elem_bytes=q.element_size(), device=q.device) as sched:
        out = decode_attention_scheduled(q, k, v, pos, schedule=sched,
                                         starts=starts)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out


__all__ = ["decode_attention", "decode_attention_scheduled",
           "decode_attention_dispatched", "paged_decode_attention",
           "paged_decode_attention_scheduled", "paged_split_keys",
           "MAX_HEAD_DIM"]
