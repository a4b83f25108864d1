"""One convolutional layer's parameters (thesis Table 4.1 columns).

The port keeps only :class:`ConvLayer` of the JAX package's loop-nest
module; the 720-permutation footprint machinery is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolutional layer's parameters (thesis Table 4.1 columns)."""

    oc: int          # output channels
    ic: int          # input channels
    h: int           # output image height
    w: int           # output image width
    kh: int          # kernel height
    kw: int          # kernel width
    elem_bytes: int = 4   # thesis uses 32-bit words

    def trips(self) -> Dict[str, int]:
        """Trip count per loop name (the six extents of the nest)."""
        return {"oc": self.oc, "ic": self.ic, "y": self.h, "x": self.w,
                "ky": self.kh, "kx": self.kw}

    @property
    def iterations(self) -> int:
        """Total inner-body iterations (product of all six loops)."""
        return self.oc * self.ic * self.h * self.w * self.kh * self.kw

    @property
    def macs(self) -> int:
        """Multiply-accumulates: one per inner-body iteration."""
        return self.iterations

    def array_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Logical shapes of the three arrays (out / wgt / img)."""
        return {
            "out": (self.oc, self.h, self.w),
            "wgt": (self.oc, self.ic, self.kh, self.kw),
            "img": (self.ic, self.h + self.kh - 1, self.w + self.kw - 1),
        }

    def array_bytes(self) -> Dict[str, int]:
        """Total bytes of each array at ``elem_bytes`` per element."""
        return {k: math.prod(v) * self.elem_bytes
                for k, v in self.array_shapes().items()}


__all__ = ["ConvLayer"]
