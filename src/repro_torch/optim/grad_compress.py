"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Per-leaf symmetric int8 quantisation with a float32 scale; the
quantisation error is carried in an error-feedback buffer and added to
the next step's gradient, so the scheme is unbiased over time (EF-SGD).
:func:`allreduce_compressed` is the data-parallel mean of such
gradients over a ``torch.distributed`` process group (what the JAX
function does inside ``shard_map`` over the data axis): 1 byte a
gradient element on the wire in place of 4.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import leaves, map_tree, map_with_paths


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


def allreduce_compressed(grads: Any, error: Optional[Any] = None,
                         group=None) -> Tuple[Any, Any]:
    """The int8-quantised mean all-reduce of each rank's gradient tree
    over ``group`` (None: the default group), with error feedback.
    Returns (the float32 mean tree, the new error tree).

    Per leaf, after adding ``error``: (1) an all-reduce ``MAX`` of the
    local scales, so every rank quantises against the same global
    scale; (2) an all-reduce ``SUM`` of the int8 values as int32; (3)
    the sum times the scale over the group's size.  What this rank's
    rounding lost is its new error, as in JAX."""
    import torch.distributed as dist
    if error is None:
        error = map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)
    n = dist.get_world_size(group)

    def one(c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, new error) of one corrected leaf."""
        scale = _scale(c)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q = _quantize_at(c, scale)
        new_e = c - dequantize(q, scale)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.float() * scale / n, new_e

    pairs = [one(g.float() + e)
             for g, e in zip(leaves(grads), leaves(error))]
    means, errs = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (map_with_paths(lambda _, __: next(means), grads),
            map_with_paths(lambda _, __: next(errs), grads))


__all__ = ["quantize", "dequantize", "compress_tree", "decompress_tree",
           "allreduce_compressed"]
