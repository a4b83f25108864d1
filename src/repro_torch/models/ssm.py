"""Mamba-1 selective SSM block (port of the Mamba part of
``repro.models.ssm``; the RG-LRU block arrives with the hybrid family).

``mamba_block`` has two backends, as the JAX block has two branches:

* ``"plain"`` mirrors the XLA branch: it materialises ``exp(dt·A)`` and
  ``dt·B·x`` as [B,S,Di,N] tensors, runs :func:`linear_scan` and keeps
  ``y`` in float32;
* ``"cuda"`` mirrors the Pallas branch: it calls the port's
  :func:`~repro_torch.kernels.ssm_scan.ssm_scan_scheduled` wrapper (the
  CUDA kernel on the card, its plain version on the CPU), which returns ``y`` rounded to
  x's dtype, as the Pallas kernel writes it.

So the two backends differ in bf16 by that rounding, by design.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ssm_scan_scheduled
from repro_torch.models.layers import ParamInit, Params, dense


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along ``dim``, every ``h_t`` returned.

    ``h0`` (the shape without ``dim``) is folded into the first step as
    the JAX version does (``b_0' = a_0 h0 + b_0``).  Torch has no
    associative scan, so this is a sequential loop over ``dim``; the
    recurrence is the same, the float32 sums are taken in another order
    than XLA's scan tree."""
    a_t, b_t = a.movedim(dim, 0), b.movedim(dim, 0)
    h = b_t[0] if h0 is None else a_t[0] * h0 + b_t[0]
    hs = [h]
    for t in range(1, a_t.shape[0]):
        h = a_t[t] * h + b_t[t]
        hs.append(h)
    return torch.stack(hs, dim=dim)


def mamba_params(b: ParamInit, prefix: str, n_layers: int, d: int,
                 d_inner: int, state: int, conv: int, dt_rank: int) -> None:
    """Stacked Mamba-1 weights under ``prefix`` (same paths, shapes and
    std rule as the JAX tree)."""
    b.normal(f"{prefix}/in_proj", [n_layers, d, 2 * d_inner], fan_in=d)
    b.normal(f"{prefix}/conv_w", [n_layers, d_inner, conv], fan_in=conv)
    b.zeros(f"{prefix}/conv_b", [n_layers, d_inner])
    b.normal(f"{prefix}/x_proj", [n_layers, d_inner, dt_rank + 2 * state],
             fan_in=d_inner)
    b.normal(f"{prefix}/dt_proj", [n_layers, dt_rank, d_inner],
             fan_in=dt_rank)
    b.zeros(f"{prefix}/dt_bias", [n_layers, d_inner])
    # log(1..N) in float32 on the host (numpy, as the JAX init's XLA
    # computes it on a CPU), so the card and the CPU get the same values
    a_init = torch.from_numpy(np.log(np.arange(1, state + 1,
                                               dtype=np.float32)))
    b.const(f"{prefix}/A_log", a_init.expand(n_layers, d_inner, state))
    b.ones(f"{prefix}/D", [n_layers, d_inner])
    b.normal(f"{prefix}/out_proj", [n_layers, d_inner, d], fan_in=d_inner)


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence.  x [B,S,C]; w [C,K];
    ``state`` [B,K-1,C] holds the last K-1 inputs (decode).  Sums in
    float32 in tap order, adds the bias, then casts to x's dtype."""
    k = w.shape[-1]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s, :].float() * wf[:, i]
    return (out + b.float()).to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``), with no
    threshold: torch's ``F.softplus`` returns x itself above 20."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def mamba_block(x: torch.Tensor, p: Params, *, state: int, conv: int,
                dt_rank: int, cache: Optional[Dict[str, torch.Tensor]] = None,
                backend: str = "plain",
                seq_valid: Optional[torch.Tensor] = None,
                schedule=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,S,D] -> ([B,S,D], new cache).  With ``cache`` (decode, S=1)
    the SSM and conv states are carried: the result holds the new
    states, the ``cache`` tensors are not modified.  ``schedule`` (an
    :class:`~repro_torch.core.schedule.SSMScanSchedule`, ``"cuda"``
    only) sets the scan kernel's ``block_d``.

    ``seq_valid`` ([B,S] bool) marks real tokens of left-padded rows.
    As in JAX it masks pads twice: the conv input, and the post-silu
    conv output (the conv bias would otherwise feed the scan before the
    first real token), so a pad step leaves the state exactly 0.  The
    new conv state holds the last K-1 masked conv *inputs*."""
    if backend not in ("plain", "cuda"):
        raise ValueError(f"backend must be 'plain' or 'cuda', got "
                         f"{backend!r}")
    xz = dense(x, p["in_proj"])
    d_inner = xz.shape[-1] // 2
    xin, z = xz[..., :d_inner], xz[..., d_inner:]
    if seq_valid is not None:
        xin = torch.where(seq_valid[..., None], xin, torch.zeros_like(xin))

    conv_state = cache["conv"] if cache is not None else None
    xc = _causal_conv1d(xin, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc.float()).to(x.dtype)
    if seq_valid is not None:
        xc = torch.where(seq_valid[..., None], xc, torch.zeros_like(xc))

    xdbl = dense(xc, p["x_proj"]).float()               # [B,S,dr+2N]
    dt = xdbl[..., :dt_rank]
    bmat = xdbl[..., dt_rank:dt_rank + state]
    cmat = xdbl[..., dt_rank + state:]
    dt = softplus(torch.matmul(dt, p["dt_proj"].float())
                  + p["dt_bias"].float())               # [B,S,di]
    a = -torch.exp(p["A_log"].float())                  # [di,N]

    if cache is not None:
        new_conv = torch.cat([conv_state[:, 1:],
                              xin.to(conv_state.dtype)], dim=1)
        h_prev = cache["ssm"].float()
        ssm_dtype = cache["ssm"].dtype
    else:
        # a copy, so the cache does not keep the layer's whole xz alive
        new_conv = xin[:, -(conv - 1):, :].clone(
            memory_format=torch.contiguous_format)
        h_prev = None
        ssm_dtype = x.dtype

    if backend == "cuda":
        y, h_last = ssm_scan_scheduled(xc, dt, bmat.contiguous(),
                                       cmat.contiguous(), a, p["D"],
                                       h_prev, schedule=schedule)
        y = y.float()
    else:
        da = torch.exp(dt[..., None] * a)                # [B,S,di,N]
        dbx = (dt[..., None] * bmat[:, :, None, :]
               * xc.float()[..., None])                 # [B,S,di,N]
        h = linear_scan(da, dbx, dim=1, h0=h_prev)
        h_last = h[:, -1]
        y = torch.einsum("bsdn,bsn->bsd", h, cmat)
        y = y + p["D"].float() * xc.float()
    new_cache = {"ssm": h_last.to(ssm_dtype), "conv": new_conv}
    y = y * F.silu(z.float())
    return dense(y.to(x.dtype), p["out_proj"]), new_cache


def mamba_cache_init(bsz: int, d_inner: int, state: int, conv: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> Dict[str, torch.Tensor]:
    """Zero SSM state [B,Di,N] and conv state [B,K-1,Di]."""
    return {"ssm": torch.zeros((bsz, d_inner, state), dtype=dtype,
                               device=device),
            "conv": torch.zeros((bsz, conv - 1, d_inner), dtype=dtype,
                                device=device)}


__all__ = ["linear_scan", "mamba_params", "mamba_block",
           "mamba_cache_init", "softplus"]
