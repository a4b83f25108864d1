"""Plain PyTorch versions of the tiled matmul.

``matmul_ref`` is the JAX package's oracle: ``A @ B`` with float32
accumulation, output in A's type.  ``matmul_plain`` is what the CUDA
kernel computes at the schedule's rounding points: once for k innermost
or a resident RHS, after every k block for the read-modify-write
variant (as ``_mm_rmw_kernel`` rounds).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import torch

GRID_AXES: Tuple[str, ...] = ("m", "n", "k")


def uses_scratch(grid_order: Sequence[str], resident_rhs: bool) -> bool:
    """The TPU kernel's rule: one f32 accumulation when k is innermost
    (or the RHS is resident), read-modify-write otherwise."""
    return resident_rhs or tuple(grid_order)[-1] == "k"


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with float32 accumulation; output in A's type."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 block: Dict[str, int], grid_order: Sequence[str],
                 resident_rhs: bool = False, with_peak: bool = False
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's function in A's type at the schedule's rounding
    points; ``with_peak`` also returns the largest magnitude each element
    takes at a rounding point (see ``conv2d_plain``)."""
    if uses_scratch(grid_order, resident_rhs):
        out = matmul_ref(a, b)
        peak = out.float().abs()
    else:
        bk = block["k"]
        out = peak = None
        for k0 in range(0, a.shape[1], bk):
            c = a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
            out = (c if out is None else out.float() + c).to(a.dtype)
            mag = out.float().abs()
            peak = mag if peak is None else torch.maximum(peak, mag)
    return (out, peak) if with_peak else out


__all__ = ["matmul_ref", "matmul_plain", "uses_scratch", "GRID_AXES"]
