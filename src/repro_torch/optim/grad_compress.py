"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Per-leaf symmetric int8 quantisation with a float32 scale; the
quantisation error is carried in an error-feedback buffer and added to
the next step's gradient, so the scheme is unbiased over time (EF-SGD).
The JAX module's ``allreduce_compressed`` needs a process group and
comes with the port's sharding.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import map_tree


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) with ``scale = max|g| / 127`` (at
    least 1e-12 / 127) and ``q = clip(round(g / scale), -127, 127)``
    (round half to even, as ``jnp.round``)."""
    scale = _scale(g)
    return _quantize_at(g, scale), scale


def _scale(g: torch.Tensor) -> torch.Tensor:
    """The float32 scale ``max(max|g|, 1e-12) / 127``."""
    return torch.clamp(g.float().abs().max(), min=1e-12) / 127.0


def _quantize_at(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``clip(round(g / scale), -127, 127)``."""
    return torch.clamp(torch.round(g.float() / scale), -127,
                       127).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 ``q * scale``."""
    return q.float() * scale


def compress_tree(grads: Any, error: Optional[Any] = None
                  ) -> Tuple[Any, Any, Any]:
    """Quantise a gradient tree after adding the error feedback
    ``error`` (zeros when None); returns (q tree, scale tree, the new
    error tree: what the quantisation lost)."""
    if error is None:
        error = map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)
    corrected = map_tree(lambda g, e: g.float() + e, grads, error)
    s = map_tree(_scale, corrected)
    q = map_tree(_quantize_at, corrected, s)
    new_err = map_tree(lambda c, qq, ss: c - dequantize(qq, ss),
                       corrected, q, s)
    return q, s, new_err


def decompress_tree(q: Any, s: Any) -> Any:
    """The float32 tree ``q * scale``."""
    return map_tree(dequantize, q, s)


__all__ = ["quantize", "dequantize", "compress_tree", "decompress_tree"]
