"""Shared layers and the parameter initialiser (port of
``repro.models.layers``).

Parameters are nested dicts of tensors whose paths and shapes match the
JAX package's pytree, layer weights stacked on a leading ``[L, ...]``
axis, so :mod:`repro_torch.bridge` can load a JAX init one leaf at a
time and both packages compute with the same weights.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


class ParamInit:
    """Creates parameters under ``/``-separated paths with the JAX
    package's init std rule: ``scale / sqrt(fan_in)``, where ``fan_in``
    defaults to ``shape[-2]`` (or ``shape[-1]`` for vectors).

    Each tensor is drawn on ``device`` from one seeded
    ``torch.Generator`` and cast to ``dtype`` on its own, so a
    full-size model never needs a float32 copy of all its weights.  The
    numbers differ from ``jax.random``'s: tests that need the JAX
    weights load them through :func:`repro_torch.bridge.params_from_numpy`.
    """

    def __init__(self, seed: int, dtype: torch.dtype,
                 device: torch.device):
        """Seed one generator on ``device``; tensors come out as ``dtype``."""
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.dtype = dtype
        self.device = device
        self.params: Params = {}

    def _put(self, path: str, value: torch.Tensor) -> None:
        """Store ``value`` at ``path`` in the nested dict."""
        keys = path.split("/")
        node = self.params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def normal(self, path: str, shape: Sequence[int],
               fan_in: Optional[int] = None, scale: float = 1.0) -> None:
        """Normal weights with std ``scale / sqrt(fan_in)``."""
        std = scale / math.sqrt(fan_in if fan_in else shape[-2]
                                if len(shape) >= 2 else shape[-1])
        v = torch.randn(tuple(shape), generator=self.gen,
                        device=self.device, dtype=torch.float32)
        self._put(path, v.mul_(std).to(self.dtype))

    def zeros(self, path: str, shape: Sequence[int]) -> None:
        """Zero-initialised parameters (norm gains are ``1 + w``)."""
        self._put(path, torch.zeros(tuple(shape), dtype=self.dtype,
                                    device=self.device))

    def ones(self, path: str, shape: Sequence[int]) -> None:
        """Parameters initialised to one (the Mamba skip gain ``D``)."""
        self._put(path, torch.ones(tuple(shape), dtype=self.dtype,
                                   device=self.device))

    def const(self, path: str, value: torch.Tensor) -> None:
        """A given value cast to the model dtype, as the JAX
        initialiser's ``const`` does (a bf16 model stores ``A_log``
        rounded to bf16)."""
        self._put(path, value.to(device=self.device, dtype=self.dtype))


def dtype_of(name: str) -> torch.dtype:
    """Torch dtype of a config's ``dtype`` string."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm with float32 statistics, applied in x's dtype with a
    ``(1 + w)`` gain, as the JAX layer does."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    w1 = (1.0 + w.float()).to(x.dtype)
    return x * scale * w1


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., D] @ w [D, F]`` in the params dtype.  cuBLAS accumulates
    a bf16 product in float32 and rounds once, like the JAX dot with
    ``preferred_element_type=float32`` followed by a cast."""
    return torch.matmul(x, w)


def _swiglu_only(kind: str) -> None:
    """Raise for an MLP flavour the port does not have yet."""
    if kind != "swiglu":
        raise NotImplementedError(
            f"the port has the swiglu MLP only so far, got {kind!r}")


def mlp(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    """The SwiGLU feed-forward block, float32 gate, x's dtype in and out."""
    _swiglu_only(kind)
    gate = F.silu(dense(x, p["w1"]).float())
    up = dense(x, p["w3"]).float()
    return dense((gate * up).to(x.dtype), p["w2"])


def mlp_params(b: ParamInit, prefix: str, n_layers: int, d: int, f: int,
               kind: str) -> None:
    """Stacked SwiGLU weights under ``prefix`` (same paths as JAX)."""
    _swiglu_only(kind)
    b.normal(f"{prefix}/w1", [n_layers, d, f], fan_in=d)
    b.normal(f"{prefix}/w3", [n_layers, d, f], fan_in=d)
    b.normal(f"{prefix}/w2", [n_layers, f, d], fan_in=f)


RopeTables = Tuple[torch.Tensor, torch.Tensor]


def rope_tables(positions: torch.Tensor, hd: int,
                theta: float = 10000.0) -> RopeTables:
    """float32 (cos, sin) of the half-split rotary angles for positions
    [S] (shared: tables [1,1,S,hd/2]) or [B, S] (per row: [B,1,S,hd/2]).
    A forward or decode step computes them once for all its layers."""
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    pos = positions.float()
    if pos.dim() == 1:
        ang = (pos[:, None] * freq[None, :])[None, None]
    else:
        ang = pos[:, None, :, None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, tables: RopeTables) -> torch.Tensor:
    """Rotate x [B, H, S, hd] by :func:`rope_tables`' angles (float32
    arithmetic, result in x's dtype)."""
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Half-split rotary embedding (JAX ``layers.rope``).  x: [B, H, S,
    hd]; positions: [S] (shared) or [B, S] (per row)."""
    return apply_rope(x, rope_tables(positions.to(x.device), x.shape[-1],
                                     theta))


__all__ = ["Params", "ParamInit", "RopeTables", "dtype_of", "rmsnorm",
           "dense", "mlp", "mlp_params", "rope", "rope_tables",
           "apply_rope"]
