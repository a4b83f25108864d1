"""Plain PyTorch version of the flash-attention kernel.

It computes what ``repro.kernels.flash_attention.flash_attention_pallas``
computes, including the Pallas entry's scaling of q in q's own dtype,
with float32 scores and softmax.  A query row with no valid key gives
zeros, as the CUDA kernel's does; the TPU kernel's output for such pad
rows depends on its block structure, and callers discard them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._checks import scale_q


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        starts: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """q [B,HQ,S,D], k/v [B,HKV,S,D] -> [B,HQ,S,D] in q's dtype.

    Key ``kp`` is valid for query ``qp`` of row ``b`` when
    ``kp <= qp`` (causal), ``kp > qp - window`` (window) and
    ``kp >= starts[b]`` (left padding)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    qs = scale_q(q).float().reshape(b, hkv, group, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qs, k.float())
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    ok = ok[None].expand(b, s, s)
    if starts is not None:
        st = starts.to(device=q.device, dtype=torch.int64)
        ok = ok & (kpos[None] >= st[:, None, None])
    ok = ok[:, None, None]                                  # [B,1,1,S,S]
    scores = scores.masked_fill(~ok, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(b, hq, s, d).to(q.dtype)


__all__ = ["flash_attention_ref"]
