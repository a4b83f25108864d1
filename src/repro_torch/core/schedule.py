"""Schedules of the port's kernels: one point each of the design space.

A thesis schedule is a grid order plus block shapes (plus, for matmul,
the resident-RHS switch).  The tuner ranks them with the H100 cost
model, the online selector probes the top few and commits, and the
kernels take a schedule as launch parameters: on the card the grid order
is the order in which output tiles are linearised into ``blockIdx``, and
it decides the accumulation variant (scratch or read-modify-write).

The serving kernels' schedules keep the JAX package's names and fields
(so registry dicts and bundle reports compare one for one) with the
card's meaning of each field:

- :class:`FlashAttentionSchedule`: ``block_q`` the query rows a block
  holds (bf16: 64 or 128, 16 a warp), ``block_kv`` the staged key tile
  (bf16 64; the float32 body has the single tile 64 x 32);
- :class:`DecodeAttentionSchedule`: ``block_kv`` the keys one thread
  block takes, the split of the split decode (the card's counterpart of
  the streamed KV block);
- :class:`SSMScanSchedule`: ``block_d`` the channels a block scans.

A :class:`ScheduleBundle` holds one schedule per family for a captured
step; it is part of the step's
:class:`~repro_torch.serving.cache.ExecKey`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ConvSchedule:
    """Conv2d launch point: grid order + block shapes (Table 4.1 axes)."""

    grid_order: Tuple[str, ...]           # permutation of (oc, ic, y, x)
    block: Tuple[Tuple[str, int], ...]    # hashable block dict

    def block_dict(self) -> Dict[str, int]:
        """Block shapes as a plain dict (the kernels' kwarg form)."""
        return dict(self.block)

    @staticmethod
    def make(grid_order, block: Dict[str, int]) -> "ConvSchedule":
        """Build from a plain block dict (canonicalised for hashing)."""
        return ConvSchedule(tuple(grid_order), tuple(sorted(block.items())))

    def run(self, img, wgt):
        """Run the conv2d kernel with this schedule's parameters."""
        from repro_torch.kernels.conv2d import conv2d
        return conv2d(img, wgt, block=self.block_dict(),
                      grid_order=self.grid_order)


@dataclasses.dataclass(frozen=True)
class MatmulSchedule:
    """Matmul launch point: grid order, blocks, and the resident RHS."""

    grid_order: Tuple[str, ...]           # permutation of (m, n, k)
    block: Tuple[Tuple[str, int], ...]
    resident_rhs: bool = False            # the "tiles-for-L2" switch

    def block_dict(self) -> Dict[str, int]:
        """Block shapes as a plain dict (the kernels' kwarg form)."""
        return dict(self.block)

    @staticmethod
    def make(grid_order, block: Dict[str, int],
             resident_rhs: bool = False) -> "MatmulSchedule":
        """Build from a plain block dict (canonicalised for hashing)."""
        return MatmulSchedule(tuple(grid_order),
                              tuple(sorted(block.items())), resident_rhs)

    def run(self, a, b):
        """Run the matmul kernel with this schedule's parameters."""
        from repro_torch.kernels.matmul import matmul
        return matmul(a, b, block=self.block_dict(),
                      grid_order=self.grid_order,
                      resident_rhs=self.resident_rhs)


@dataclasses.dataclass(frozen=True)
class SparseConvSchedule:
    """Block-sparse conv launch point: (oc, ic) skip-block shape."""

    block: Tuple[Tuple[str, int], ...]    # hashable {"oc","ic"} dict

    def block_dict(self) -> Dict[str, int]:
        """Block shapes as a plain dict (the kernels' kwarg form)."""
        return dict(self.block)

    @staticmethod
    def make(block: Dict[str, int]) -> "SparseConvSchedule":
        """Build from a plain block dict (canonicalised for hashing)."""
        return SparseConvSchedule(tuple(sorted(block.items())))

    def run(self, img, wgt, *, sparsity=None):
        """Run the block-sparse conv kernel with this schedule."""
        from repro_torch.kernels.sparse_conv import sparse_conv2d
        return sparse_conv2d(img, wgt, block=self.block_dict(),
                             sparsity=sparsity)


@dataclasses.dataclass(frozen=True)
class FlashAttentionSchedule:
    """Prefill attention launch point: query rows and key tile a block."""

    block_q: int
    block_kv: int

    def to_dict(self) -> Dict:
        """Registry-serialisable form (see registry.schedule_to_dict)."""
        from repro_torch.core import registry
        return registry.schedule_to_dict(self)

    def run(self, q, k, v, *, causal: bool = True,
            window: Optional[int] = None, starts=None):
        """Run flash attention with this schedule's tile."""
        from repro_torch.kernels.flash_attention import (
            flash_attention_scheduled)
        return flash_attention_scheduled(q, k, v, schedule=self,
                                         causal=causal, window=window,
                                         starts=starts)


@dataclasses.dataclass(frozen=True)
class DecodeAttentionSchedule:
    """Decode-step launch point: the keys a thread block takes (split)."""

    block_kv: int

    def to_dict(self) -> Dict:
        """Registry-serialisable form (see registry.schedule_to_dict)."""
        from repro_torch.core import registry
        return registry.schedule_to_dict(self)

    def run(self, q, k, v, pos, *, starts=None):
        """Run one contiguous decode attention step with this split."""
        from repro_torch.kernels.decode_attention import (
            decode_attention_scheduled)
        return decode_attention_scheduled(q, k, v, pos, schedule=self,
                                          starts=starts)


@dataclasses.dataclass(frozen=True)
class SSMScanSchedule:
    """Selective-scan launch point: the channels a block scans."""

    block_d: int

    def to_dict(self) -> Dict:
        """Registry-serialisable form (see registry.schedule_to_dict)."""
        from repro_torch.core import registry
        return registry.schedule_to_dict(self)

    def run(self, x, dt, b, c, a, d, h0=None):
        """Run the selective scan with this channel block."""
        from repro_torch.kernels.ssm_scan import ssm_scan_scheduled
        return ssm_scan_scheduled(x, dt, b, c, a, d, h0, schedule=self)


@dataclasses.dataclass(frozen=True)
class ScheduleBundle:
    """The schedules a captured model step runs with, one per family.

    Frozen and hashable: it is part of a step's
    :class:`~repro_torch.serving.cache.ExecKey`, so a different bundle is
    a different step (another capture) and an equal one a cache hit.
    ``None`` fields leave the kernel at its default launch parameters.
    :meth:`repro_torch.runtime.dispatch.DispatchService.schedule_bundle`
    resolves one (committed winner > registry measurement > offline
    rank-0); the models only read it."""

    flash_attention: Optional[FlashAttentionSchedule] = None
    decode_attention: Optional[DecodeAttentionSchedule] = None
    ssm_scan: Optional[SSMScanSchedule] = None
    matmul: Optional[MatmulSchedule] = None
    conv2d: Optional[ConvSchedule] = None
    sparse_conv: Optional[SparseConvSchedule] = None

    def get(self, kind: str):
        """Schedule for a dispatch-kind name (None when unset)."""
        return getattr(self, kind, None)

    def replace(self, **kw) -> "ScheduleBundle":
        """A copy with the given per-family slots swapped out."""
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict:
        """Per-family serialisable dict (None for unset slots)."""
        from repro_torch.core import registry
        return {f.name: (registry.schedule_to_dict(getattr(self, f.name))
                         if getattr(self, f.name) is not None else None)
                for f in dataclasses.fields(self)}


__all__ = ["ConvSchedule", "MatmulSchedule", "SparseConvSchedule",
           "FlashAttentionSchedule", "DecodeAttentionSchedule",
           "SSMScanSchedule", "ScheduleBundle"]
