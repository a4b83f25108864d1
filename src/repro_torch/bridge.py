"""Load a JAX parameter tree, converted to numpy, into the port.

A test builds ``repro``'s model, calls ``jax.tree.map(np.asarray,
model.init(key)[0])`` and hands the result to :func:`params_from_numpy`,
so both packages compute with the same weights.  This module takes numpy
only and imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _to_tensor(a, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One numpy leaf as a tensor (bfloat16 arrays via their bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))   # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, Any]:
    """The same nested dict with every numpy leaf as a tensor on
    ``device`` (CUDA by default), cast to ``dtype`` when given."""
    dev = resolve_device(device)

    def conv(node):
        """Convert one subtree."""
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    return conv(tree)


__all__ = ["params_from_numpy"]
