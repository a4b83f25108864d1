"""Plain PyTorch versions of the block-sparse convolution.

Semantics are those of the dense conv: a zero weight block contributes
zero.  ``sparse_conv_ref`` is the JAX package's oracle (the dense
``conv2d_ref`` on the already-zeroed weights, float32 out).
``sparse_conv_plain`` is what the CUDA kernel computes: the dense conv
of the weights with every block outside the sparsity structure zeroed,
summed in float32 and rounded once to the image's type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.conv2d.ref import conv2d_ref as sparse_conv_ref


def block_mask(counts: np.ndarray, idx: np.ndarray, n_ic: int
               ) -> np.ndarray:
    """[n_oc, n_ic] boolean mask of the blocks a (idx, counts) structure
    lists."""
    mask = np.zeros((len(counts), n_ic), dtype=bool)
    for o, c in enumerate(counts):
        mask[o, idx[o, :int(c)]] = True
    return mask


def sparse_conv_plain(img: torch.Tensor, wgt: torch.Tensor, idx: np.ndarray,
                      counts: np.ndarray, block) -> torch.Tensor:
    """The kernel's function: only the listed (oc, ic) blocks count; f32
    sums, rounded once to img's type."""
    boc, bic = block["oc"], block["ic"]
    mask = block_mask(counts, idx, wgt.shape[1] // bic)
    keep = torch.from_numpy(np.repeat(np.repeat(mask, boc, 0), bic, 1))
    w = wgt * keep.to(device=wgt.device, dtype=wgt.dtype)[:, :, None, None]
    return sparse_conv_ref(img, w).to(img.dtype)


__all__ = ["sparse_conv_ref", "sparse_conv_plain", "block_mask"]
