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

# The most elements :meth:`ParamInit.normal` draws as one float32
# tensor: 2**32, the largest tensor of phi3-mini-3.8b and falcon-mamba-7b
# (falcon-mamba's ``in_proj``, [64, 4096, 16384]), so their weights stay
# as they were; qwen3-32b's MLP matrices (8.39e9 each) are drawn a layer
# at a time, so the model initialises on one 80 GB card.
WHOLE_DRAW_LIMIT = 2 ** 32


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
        """Normal weights with std ``scale / sqrt(fan_in)``.  A tensor of
        more than :data:`WHOLE_DRAW_LIMIT` elements is drawn one slice of
        its leading (layer) axis at a time into its ``dtype`` result, so
        its float32 draw never exists whole; a smaller one is drawn
        whole, as before, so its values do not change."""
        std = scale / math.sqrt(fan_in if fan_in else shape[-2]
                                if len(shape) >= 2 else shape[-1])
        shape = tuple(shape)
        if math.prod(shape) <= WHOLE_DRAW_LIMIT:
            v = torch.randn(shape, generator=self.gen, device=self.device,
                            dtype=torch.float32)
            self._put(path, v.mul_(std).to(self.dtype))
            return
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for i in range(shape[0]):
            v = torch.randn(shape[1:], generator=self.gen,
                            device=self.device, dtype=torch.float32)
            out[i].copy_(v.mul_(std))
            del v
        self._put(path, out)

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


MLP_KINDS = ("swiglu", "relu2", "gelu")


def _check_kind(kind: str) -> None:
    """Raise for an MLP flavour that is not one of :data:`MLP_KINDS`."""
    if kind not in MLP_KINDS:
        raise ValueError(f"mlp kind must be one of {MLP_KINDS}, got "
                         f"{kind!r}")


def mlp(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    """The feed-forward block, x's dtype in and out, the activation in
    float32: ``swiglu`` (silu gate times up), ``relu2`` (squared ReLU,
    the nemotron family) or ``gelu`` (the tanh approximation, which is
    ``jax.nn.gelu``'s default)."""
    _check_kind(kind)
    h = dense(x, p["w1"]).float()
    if kind == "swiglu":
        h = F.silu(h) * dense(x, p["w3"]).float()
    elif kind == "relu2":
        h = torch.relu(h) ** 2
    else:
        h = F.gelu(h, approximate="tanh")
    return dense(h.to(x.dtype), p["w2"])


def mlp_params(b: ParamInit, prefix: str, n_layers: int, d: int, f: int,
               kind: str) -> None:
    """Stacked MLP weights under ``prefix`` (same paths as JAX): ``w1``
    and ``w2``, and ``w3`` for swiglu only."""
    _check_kind(kind)
    b.normal(f"{prefix}/w1", [n_layers, d, f], fan_in=d)
    if kind == "swiglu":
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


def sinusoidal_positions(seq: int, d: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """[seq, d] float32 sinusoidal position table (sines of the first
    ``d/2`` angles, then their cosines), the encoder's positions."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    # a Python base: no host-to-device copy, so a captured step may
    # build the table
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


__all__ = ["Params", "ParamInit", "WHOLE_DRAW_LIMIT", "MLP_KINDS",
           "RopeTables", "dtype_of", "rmsnorm",
           "dense", "mlp", "mlp_params", "rope", "rope_tables",
           "apply_rope", "sinusoidal_positions"]
