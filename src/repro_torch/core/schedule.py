"""Schedules of the thesis kernels: one point each of the design space.

A schedule is a grid order plus block shapes (plus, for matmul, the
resident-RHS switch).  The tuner ranks them with the H100 cost model,
the online selector probes the top few and commits, and the kernels take
a schedule as launch parameters: on the card the grid order is the order
in which output tiles are linearised into ``blockIdx``, and it decides
the accumulation variant (scratch or read-modify-write).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


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


__all__ = ["ConvSchedule", "MatmulSchedule", "SparseConvSchedule"]
