"""Wrapper of the CUDA block-sparse convolution (``csrc/sparse_conv.cu``).

``sparse_conv2d`` replaces ``sparse_conv2d_pallas`` (``src/repro/kernels/
sparse_conv/kernel.py``).  The block structure is built on the host with
numpy, as in the JAX package: :func:`build_block_index` compacts a
[n_oc, n_ic] block-nonzero mask into (idx, counts), :func:`analyze_weights`
builds it from the weights, and :class:`BlockSparsity` carries it with
its density and imbalance (the thesis' straggler measure) and its copy on
each device, made at first use there: a call given the structure
launches only the kernel.

For CPU tensors the wrapper runs the plain version (``ref.
sparse_conv_plain``); for CUDA tensors it launches the kernel or raises:
bf16 runs the dense conv's implicit GEMM on the tensor cores over each oc
block's nonzero ic blocks, at the dense model's pixel tile for the skip
block and batch (``core.sparsity.sparse_pixel_tile``); float32 the
CUDA-core tile kernel (``_geometry.sparse_layout`` gives each one's
layout).  ``sparse_conv2d.launches`` counts launches, one per call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same, on_cpu,
                                         require)
from repro_torch.kernels._geometry import (sparse_layout, sparse_tile,
                                           tensor_cores)
from repro_torch.kernels.sparse_conv.ref import (sparse_conv_plain,
                                                 sparse_conv_ref)


def build_block_index(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Compact a [n_oc, n_ic] block-nonzero mask into (idx, counts):
    idx[o, j] = j-th nonzero ic block of oc block o (padded with 0),
    counts[o] = number of valid entries."""
    n_oc, _ = mask.shape
    counts = mask.sum(axis=1).astype(np.int32)
    width = max(int(counts.max(initial=0)), 1)
    idx = np.zeros((n_oc, width), np.int32)
    for o in range(n_oc):
        nz = np.nonzero(mask[o])[0]
        idx[o, :len(nz)] = nz
    return idx, counts


@dataclasses.dataclass(frozen=True)
class BlockSparsity:
    """Host-side compacted sparsity structure of a weight tensor (its
    arrays are not changed after it is made: their device copies are
    kept)."""
    idx: np.ndarray        # [n_oc_blocks, max_nnz]
    counts: np.ndarray     # [n_oc_blocks]
    block: Dict[str, int]
    n_ic_blocks: int
    # device -> (idx, counts) int32 tensors there; not part of equality
    _on_device: Dict = dataclasses.field(default_factory=dict,
                                         compare=False, repr=False)

    def device_index(self, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(idx, counts) as int32 tensors on ``device``: copied there at
        the first call on it, reused by every later one."""
        hit = self._on_device.get(device)
        if hit is None:
            hit = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)
                                         ).to(device)
                        for a in (self.idx, self.counts))
            self._on_device[device] = hit
        return hit

    @property
    def density(self) -> float:
        """Share of (oc, ic) blocks with a nonzero weight."""
        return float(self.counts.sum()) / (len(self.counts)
                                           * self.n_ic_blocks)

    @property
    def imbalance(self) -> float:
        """max/mean nonzero count across oc blocks (thesis §3.6)."""
        mean = max(float(self.counts.mean()), 1e-9)
        return float(self.counts.max(initial=0)) / mean


def _host_weights(wgt) -> np.ndarray:
    """The weights as a float numpy array on the host (a device tensor is
    pulled to the host, as the JAX wrapper's ``np.asarray`` pulls it)."""
    if isinstance(wgt, torch.Tensor):
        return wgt.detach().float().cpu().numpy()
    return np.asarray(wgt)


def analyze_weights(wgt, block: Dict[str, int],
                    threshold: float = 0.0) -> BlockSparsity:
    """The block structure of ``wgt`` [OC, IC, KH, KW] at ``block``
    {"oc", "ic"}: a block counts when any |weight| in it is above
    ``threshold``."""
    w = np.abs(_host_weights(wgt))
    oc, ic = w.shape[0], w.shape[1]
    boc, bic = block["oc"], block["ic"]
    w = w.reshape(oc // boc, boc, ic // bic, bic, -1)
    idx, counts = build_block_index(w.max(axis=(1, 3, 4)) > threshold)
    return BlockSparsity(idx=idx, counts=counts, block=dict(block),
                         n_ic_blocks=ic // bic)


@functools.lru_cache(maxsize=512)
def _pixel_tile(layer, boc: int, bic: int, batch: int):
    """The bf16 body's pixel tile (:func:`repro_torch.core.sparsity.
    sparse_pixel_tile`), memoised per shape and batch so that a call
    pays the dense model's ranking once."""
    from repro_torch.core.sparsity import sparse_pixel_tile
    return sparse_pixel_tile(layer, boc, bic, batch)


def sparse_conv2d(img: torch.Tensor, wgt: torch.Tensor, *,
                  block: Dict[str, int],
                  sparsity: Optional[BlockSparsity] = None) -> torch.Tensor:
    """Block-sparse direct conv (valid, pre-padded input); recomputes the
    structure from the weights when ``sparsity`` is not given.
    img [N, IC, H+KH-1, W+KW-1]; wgt [OC, IC, KH, KW] -> [N, OC, H, W]
    in img's type."""
    require(img.dim() == 4 and wgt.dim() == 4 and img.shape[1] ==
            wgt.shape[1], f"sparse_conv2d: img [N,IC,H2,W2] and wgt "
            f"[OC,IC,KH,KW], got {tuple(img.shape)} {tuple(wgt.shape)}")
    n, ic, h2, w2 = img.shape
    oc, _, kh, kw = wgt.shape
    h, w = h2 - kh + 1, w2 - kw + 1
    boc, bic = block["oc"], block["ic"]
    require(oc % boc == 0 and ic % bic == 0, f"sparse_conv2d: blocks "
            f"{block} must divide oc={oc} ic={ic}")
    cpu = on_cpu(img)
    if not cpu:
        # checked before the structure is built, so a tensor the kernel
        # cannot take raises before any host work
        require(img.dtype in KERNEL_DTYPES, f"sparse_conv2d: dtype "
                f"{img.dtype} not supported")
        check_same("sparse_conv2d", [img, wgt], img.dtype)
    if sparsity is None:
        sparsity = analyze_weights(wgt, block)
    require(sparsity.block == dict(block) and sparsity.idx.shape[0] ==
            oc // boc, f"sparse_conv2d: structure for {sparsity.block} "
            f"does not match block {block}")
    if cpu:
        return sparse_conv_plain(img, wgt, sparsity.idx, sparsity.counts,
                                 block)
    mma = tensor_cores(img.element_size())
    if mma:
        from repro_torch.core.loopnest import ConvLayer
        pix = _pixel_tile(ConvLayer(oc, ic, h, w, kh, kw), boc, bic, n)
        require(pix is not None, f"sparse_conv2d: block {block} with a "
                f"{kh}x{kw} kernel fits no pixel tile of the bf16 kernel")
        by, bx = pix
    else:
        by, bx = sparse_tile(h, w)
    tile = sparse_layout(boc, bic, by, bx, kh, kw, ic // bic,
                         img.element_size(), oc=oc, ic=ic, h=h, w=w,
                         batch=n, max_nnz=sparsity.idx.shape[1])
    require(tile.error is None, f"sparse_conv2d: block {block} with a "
            f"{kh}x{kw} kernel does not fit the kernel: {tile.error}")
    idx, counts = sparsity.device_index(img.device)
    out = torch.empty((n, oc, h, w), dtype=img.dtype, device=img.device)
    rc = _build.load().sparse_conv2d_fwd(
        img.data_ptr(), wgt.data_ptr(), idx.data_ptr(), counts.data_ptr(),
        out.data_ptr(), n, ic, h2, w2, oc, kh, kw, boc, bic, idx.shape[1],
        by, bx, 0 if mma else tile.groups, 0 if mma else tile.per_thread,
        tile.warps if mma else 0, tile.walk if mma else 0,
        tile.stages if mma else 0, int(mma and tile.late), int(mma),
        _build.stream_handle(img.device))
    _build.check(rc, "sparse_conv2d_fwd")
    sparse_conv2d.launches += 1
    return out


sparse_conv2d.launches = 0


def sparse_conv2d_scheduled(img: torch.Tensor, wgt: torch.Tensor, *,
                            schedule,
                            sparsity: Optional[BlockSparsity] = None
                            ) -> torch.Tensor:
    """``sparse_conv2d`` with a :class:`~repro_torch.core.schedule.
    SparseConvSchedule` skip-block shape."""
    return sparse_conv2d(img, wgt, block=schedule.block_dict(),
                         sparsity=sparsity)


def sparse_conv2d_dispatched(img: torch.Tensor, wgt: torch.Tensor, *,
                             density: Optional[float] = None,
                             service=None) -> torch.Tensor:
    """``sparse_conv2d`` through the port's dispatch service.  The key
    uses the weights' element-level density quantised to a 1/16 grid (an
    upper bound on the block density at any granularity) and the batch
    ``n`` (the bf16 body's pixel tile depends on it).  As in the JAX
    package, the timed body rebuilds the block structure from the
    weights on the host, so the measured time includes pulling the
    weights to the host and copying the index to the card; passing
    ``density`` saves only the pull that computes it, outside the timed
    window."""
    from repro_torch.core.registry import quantize_density
    from repro_torch.runtime.dispatch import get_dispatch_service
    n, ic, h2, w2 = img.shape
    oc, _, kh, kw = wgt.shape
    if density is None:
        density = float((np.abs(_host_weights(wgt)) > 0.0).mean())
    svc = service if service is not None else get_dispatch_service()
    problem = {"oc": oc, "ic": ic, "h": h2 - kh + 1, "w": w2 - kw + 1,
               "kh": kh, "kw": kw, "density_16": quantize_density(density),
               "n": n}
    with svc.measure("sparse_conv", problem, elem_bytes=img.element_size(),
                     device=img.device) as sched:
        out = sparse_conv2d(img, wgt, block=sched.block_dict())
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out


__all__ = ["sparse_conv2d", "sparse_conv2d_scheduled",
           "sparse_conv2d_dispatched", "sparse_conv_ref",
           "sparse_conv_plain", "analyze_weights", "BlockSparsity",
           "build_block_index"]
