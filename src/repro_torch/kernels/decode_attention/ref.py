"""Plain PyTorch versions of the two decode kernels.

They compute what ``decode_attention_pallas`` and
``paged_decode_attention_pallas`` (``src/repro/kernels/decode_attention/
kernel.py``) compute, including the scaling of q in q's own dtype, with
float32 scores and softmax; a row with no valid key gives zeros.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import scale_q


def _decode_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """q [B,HQ,1,D]; k/v [B,HKV,S,D]; valid [B,S] bool -> [B,HQ,1,D]."""
    b, hq, _, d = q.shape
    hkv = k.shape[1]
    qs = scale_q(q).float().reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum("bhgd,bhkd->bhgk", qs, k.float())
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, pos, *,
                         starts: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """q [B,HQ,1,D]; k/v [B,HKV,S,D]; ``pos`` scalar or [B]; valid keys
    are ``starts[b] <= kp <= pos[b]``."""
    b, s = q.shape[0], k.shape[2]
    pos_b = torch.as_tensor(pos, device=q.device).to(torch.int64)
    pos_b = pos_b.expand(b) if pos_b.dim() == 0 else pos_b
    kpos = torch.arange(s, device=q.device)[None, :]
    valid = kpos <= pos_b[:, None]
    if starts is not None:
        st = torch.as_tensor(starts, device=q.device).to(torch.int64)
        valid &= kpos >= st[:, None]
    return _decode_core(q, k, v, valid)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, tables: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """q [B,HQ,1,D]; pools [NB,HKV,bs,D]; tables [B,MB]; pos [B].  Row
    ``b`` attends to logical keys ``0..pos[b]`` gathered through its
    table."""
    b, _, _, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    mb = tables.shape[1]
    idx = tables.to(device=q.device, dtype=torch.int64)
    kg = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    vg = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(b, hkv, mb * bs, d)
    pos_b = torch.as_tensor(pos, device=q.device).to(torch.int64)
    valid = (torch.arange(mb * bs, device=q.device)[None, :]
             <= pos_b[:, None])
    return _decode_core(q, kg, vg, valid)


__all__ = ["decode_attention_ref", "paged_decode_attention_ref"]
