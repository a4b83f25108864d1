"""Plain PyTorch version of the selective-scan kernel (Mamba-1).

Port of ``src/repro/kernels/ssm_scan/ref.py``, extended to take an
initial state ``h0`` and return the final state, as
``ssm_scan_pallas`` (``src/repro/kernels/ssm_scan/kernel.py``) does.
Given pre-activated inputs (``dt`` already softplus'd, B/C projected):

    dA_t = exp(dt_t * A)                       # [Di, N] per step
    h_t  = dA_t * h_{t-1} + (dt_t * x_t) * B_t
    y_t  = <h_t, C_t> + D * x_t

It materialises the [Bt, S, Di, N] tensors and runs the recurrence as a
sequential loop over S, in float32, in the kernel's order of operations:
a step whose ``x`` is 0 (a masked pad) leaves a zero state exactly 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt [Bt,S,Di]; b, c [Bt,S,N]; a [Di,N]; d [Di]; h0 [Bt,Di,N]
    (zeros when None) -> (y [Bt,S,Di] in x's dtype, final state
    [Bt,Di,N] float32)."""
    bt, seq, di = x.shape
    n = b.shape[-1]
    xf, dtf = x.float(), dt.float()
    da = torch.exp(dtf[..., None] * a.float())                # [Bt,S,Di,N]
    dbx = (dtf * xf)[..., None] * b.float()[:, :, None, :]
    h = (torch.zeros((bt, di, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(seq):
        h = da[:, t] * h + dbx[:, t]
        hs.append(h)
    y = (torch.stack(hs, dim=1) * c.float()[:, :, None, :]).sum(-1)
    y = y + d.float() * xf
    return y.to(x.dtype), h


__all__ = ["ssm_scan_ref"]
