"""Plain PyTorch versions of the direct convolution.

Semantics match the thesis' nest (Fig 3.1): 'valid' convolution (really
cross-correlation) of a pre-padded input::

    out[n, oc, y, x] = sum_{ic, ky, kx} wgt[oc, ic, ky, kx]
                                        * img[n, ic, y+ky, x+kx]

``conv2d_ref`` is the JAX package's oracle: float32 out, whatever the
input type.  ``conv2d_plain`` is what the CUDA kernel computes: the same
sums in float32, rounded to the image's type at the schedule's rounding
points (once for the scratch variant; after every input-channel block
for the read-modify-write variant, as ``_conv_kernel_rmw`` rounds).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

GRID_AXES: Tuple[str, ...] = ("oc", "ic", "y", "x")


def uses_scratch(grid_order: Sequence[str]) -> bool:
    """The TPU kernel's rule: f32 scratch partial sums when no output
    axis (oc, y, x) iterates inside the reduction axis ic, else
    read-modify-write through the output."""
    order = list(grid_order)
    return not [a for a in order[order.index("ic") + 1:]
                if a in ("oc", "y", "x")]


def _contribution(img: torch.Tensor, wgt: torch.Tensor, ic0: int,
                  ic1: int) -> torch.Tensor:
    """float32 sum over channels [ic0, ic1) and every tap."""
    n, _, h2, w2 = img.shape
    oc, _, kh, kw = wgt.shape
    h, w = h2 - kh + 1, w2 - kw + 1
    out = torch.zeros((n, oc, h, w), dtype=torch.float32, device=img.device)
    for ky in range(kh):
        for kx in range(kw):
            patch = img[:, ic0:ic1, ky:ky + h, kx:kx + w].float()
            tap = wgt[:, ic0:ic1, ky, kx].float()
            out = out + torch.einsum("nihw,oi->nohw", patch, tap)
    return out


def conv2d_ref(img: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """img [N, IC, H+KH-1, W+KW-1]; wgt [OC, IC, KH, KW] ->
    out [N, OC, H, W] in float32 (the JAX oracle's type)."""
    if img.shape[1] != wgt.shape[1]:
        raise ValueError(f"channel mismatch {tuple(img.shape)} "
                         f"{tuple(wgt.shape)}")
    return _contribution(img, wgt, 0, img.shape[1])


def conv2d_plain(img: torch.Tensor, wgt: torch.Tensor, *,
                 block: Dict[str, int], grid_order: Sequence[str],
                 with_peak: bool = False
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's function in img's type at the schedule's rounding
    points.  With ``with_peak`` also returns, per element, the largest
    magnitude the output takes at any rounding point (float32): a bf16
    check allows one rounding step's worth of that magnitude, because a
    float32 sum taken in another order may round the other way at an
    intermediate point of the read-modify-write variant."""
    if uses_scratch(grid_order):
        out = conv2d_ref(img, wgt).to(img.dtype)
        peak = out.float().abs()
    else:
        bic = block["ic"]
        out = peak = None
        for ic0 in range(0, img.shape[1], bic):
            c = _contribution(img, wgt, ic0, ic0 + bic)
            out = (c if out is None else out.float() + c).to(img.dtype)
            mag = out.float().abs()
            peak = mag if peak is None else torch.maximum(peak, mag)
    return (out, peak) if with_peak else out


__all__ = ["conv2d_ref", "conv2d_plain", "uses_scratch", "GRID_AXES"]
