"""Shared layers and the parameter initialiser (port of
``repro.models.layers``).

Parameters are nested dicts of tensors whose paths and shapes match the
JAX package's pytree, layer weights stacked on a leading ``[L, ...]``
axis, so :mod:`repro_torch.bridge` can load a JAX init one leaf at a
time and both packages compute with the same weights.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]
# one logical axis name (or None) per dimension of a parameter
Axes = Tuple[Optional[str], ...]

# The most elements :meth:`ParamInit.normal` draws as one float32
# tensor: 2**32, the largest tensor of phi3-mini-3.8b and falcon-mamba-7b
# (falcon-mamba's ``in_proj``, [64, 4096, 16384]), so their weights stay
# as they were; qwen3-32b's MLP matrices (8.39e9 each) are drawn a layer
# at a time, so the model initialises on one 80 GB card.
WHOLE_DRAW_LIMIT = 2 ** 32


class ParamInit:
    """Creates parameters under ``/``-separated paths with the JAX
    package's init std rule: ``scale / sqrt(fan_in)``, where ``fan_in``
    defaults to ``shape[-2]`` (or ``shape[-1]`` for vectors), and beside
    each one its tuple of logical axis names (``"embed"``, ``"heads"``,
    ``None``, ... one a dimension) in the parallel tree ``axes``, as the
    JAX ``ParamBuilder`` does; :mod:`repro_torch.runtime.sharding` maps
    them to mesh axes.

    Each tensor is drawn on ``device`` from one seeded
    ``torch.Generator`` and cast to ``dtype`` on its own, so a
    full-size model never needs a float32 copy of all its weights.  The
    numbers differ from ``jax.random``'s: tests that need the JAX
    weights load them through :func:`repro_torch.bridge.params_from_numpy`.

    On ``torch.device("meta")`` nothing is drawn (a generator has no meta
    device): every parameter is a storage-less meta tensor of its shape
    and dtype, which is how ``Model.abstract_params`` and
    ``Model.axes_tree`` build their trees without touching what a real
    init draws.
    """

    def __init__(self, seed: int, dtype: torch.dtype,
                 device: torch.device):
        """Seed one generator on ``device`` (none on the meta device);
        tensors come out as ``dtype``."""
        self.meta = torch.device(device).type == "meta"
        self.gen = None
        if not self.meta:
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(int(seed))
        self.dtype = dtype
        self.device = device
        self.params: Params = {}
        self.axes: Params = {}

    @staticmethod
    def _set(tree: Params, path: str, value: Any) -> None:
        """Store ``value`` at ``path`` in the nested dict ``tree``."""
        keys = path.split("/")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def _put(self, path: str, value: torch.Tensor,
             axes: Optional[Axes]) -> None:
        """Store ``value`` and its axes (all ``None`` when not given)."""
        if axes is None:
            axes = (None,) * value.dim()
        if len(axes) != value.dim():
            raise ValueError(f"{path}: axes {axes} for shape "
                             f"{tuple(value.shape)}")
        self._set(self.params, path, value)
        self._set(self.axes, path, tuple(axes))

    def _empty(self, shape: Sequence[int]) -> torch.Tensor:
        """A storage-less tensor on the meta device."""
        return torch.empty(tuple(shape), dtype=self.dtype, device="meta")

    def normal(self, path: str, shape: Sequence[int],
               axes: Optional[Axes] = None, fan_in: Optional[int] = None,
               scale: float = 1.0) -> None:
        """Normal weights with std ``scale / sqrt(fan_in)``.  A tensor of
        more than :data:`WHOLE_DRAW_LIMIT` elements is drawn one slice of
        its leading (layer) axis at a time into its ``dtype`` result, so
        its float32 draw never exists whole; a smaller one is drawn
        whole, as before, so its values do not change."""
        std = scale / math.sqrt(fan_in if fan_in else shape[-2]
                                if len(shape) >= 2 else shape[-1])
        shape = tuple(shape)
        if self.meta:
            self._put(path, self._empty(shape), axes)
            return
        if math.prod(shape) <= WHOLE_DRAW_LIMIT:
            v = torch.randn(shape, generator=self.gen, device=self.device,
                            dtype=torch.float32)
            self._put(path, v.mul_(std).to(self.dtype), axes)
            return
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        for i in range(shape[0]):
            v = torch.randn(shape[1:], generator=self.gen,
                            device=self.device, dtype=torch.float32)
            out[i].copy_(v.mul_(std))
            del v
        self._put(path, out, axes)

    def zeros(self, path: str, shape: Sequence[int],
              axes: Optional[Axes] = None) -> None:
        """Zero-initialised parameters (norm gains are ``1 + w``)."""
        self._put(path, torch.zeros(tuple(shape), dtype=self.dtype,
                                    device=self.device), axes)

    def ones(self, path: str, shape: Sequence[int],
             axes: Optional[Axes] = None) -> None:
        """Parameters initialised to one (the Mamba skip gain ``D``)."""
        self._put(path, torch.ones(tuple(shape), dtype=self.dtype,
                                   device=self.device), axes)

    def const(self, path: str, value: torch.Tensor,
              axes: Optional[Axes] = None) -> None:
        """A given value cast to the model dtype, as the JAX
        initialiser's ``const`` does (a bf16 model stores ``A_log``
        rounded to bf16)."""
        self._put(path, value.to(device=self.device, dtype=self.dtype),
                  axes)


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table ``emb`` [V, D]: the
    token's row.  On a mesh (``emb`` a DTensor) the gather and its
    backward (an indexed accumulate) have no dependable DTensor sharding
    strategy, so they are redistributed explicitly: the table and the
    tokens are gathered whole on every rank, every rank looks up every
    row on plain tensors, and the result is placed with the tokens'
    rows (the backward sums the ranks' gradients into the table's
    placements)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(emb, DTensor):
        return emb[tokens.to(emb.device).long()]
    mesh = emb.device_mesh
    rep = [Replicate()] * mesh.ndim
    tok = tokens.full_tensor() if isinstance(tokens, DTensor) else tokens
    table = emb.redistribute(mesh, rep).to_local()
    out = DTensor.from_local(table[tok.to(table.device).long()], mesh, rep,
                             run_check=False)
    if isinstance(tokens, DTensor):
        out = out.redistribute(mesh, [pl if pl == Shard(0) else Replicate()
                                      for pl in tokens.placements])
    return out


def on_replicated(fn: Callable, x: torch.Tensor, p: Params, **kw) -> Any:
    """``fn(x, p, **kw)`` -> (out, *rest) for a DTensor ``x``, run on
    plain tensors: ``x``, the weights ``p`` and the tensors of ``kw``
    (and of their dicts) gathered replicated on every rank, ``fn`` run
    there (the same on every rank, so their gradients are replicated
    too), each tensor of the result made a replicated DTensor again and
    ``out`` redistributed to ``x``'s placements (the backward sums the
    ranks' output gradients; a ``Partial`` placement of ``x``, a decode
    step's residual, becomes ``Replicate``).  The explicit
    redistribution of a layer whose ops have no dependable DTensor
    sharding strategy."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def local(t):
        """A DTensor (or a dict of them) replicated, as plain tensors."""
        if isinstance(t, dict):
            return {k: local(v) for k, v in t.items()}
        if isinstance(t, DTensor):
            return t.redistribute(mesh, rep).to_local()
        return t

    def wrap(t):
        """A plain tensor (or a dict of them) as replicated DTensors."""
        if isinstance(t, dict):
            return {k: wrap(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, rep, run_check=False)
        return t

    out, *rest = fn(local(x), local(p),
                    **{k: local(v) for k, v in kw.items()})
    place = [Replicate() if pl.is_partial() else pl for pl in x.placements]
    return (wrap(out).redistribute(mesh, place),
            *(wrap(r) for r in rest))


def placed_as(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t`` as a DTensor of placements ``place`` on ``mesh``: a DTensor
    redistributed, a plain tensor (the same value on every rank) taken
    as replicated and cut to this rank's shard (no communication)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, place)


def reduced(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each ``Partial`` placement of a DTensor summed to
    ``Replicate`` (an all-reduce; DTensor would reduce it before the
    next nonlinear op anyway, and on torch 2.11 picks no valid strategy
    for some products of a partial operand); other tensors pass."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or not any(pl.is_partial()
                                             for pl in t.placements):
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_partial() else pl for pl in t.placements])


def copy_local_(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``; for a DTensor ``dst`` (a sharded cache
    updated in place) on its local shard, ``src`` first brought to
    ``dst``'s placements, so the write stays in ``dst``'s own storage
    and no placement of ``dst`` changes."""
    from torch.distributed.tensor import DTensor
    if not isinstance(dst, DTensor):
        return dst.copy_(src)
    dst.to_local().copy_(
        placed_as(src, dst.device_mesh, dst.placements).to_local())
    return dst


def identity_shard(x: torch.Tensor, where: str = "boundary"
                   ) -> torch.Tensor:
    """The default ``shard_fn`` of the models: ``x`` unchanged.  A meshed
    caller passes :func:`repro_torch.runtime.sharding.
    make_activation_shard_fn`'s function instead; the models call it
    where the JAX models call theirs (``where``: ``"boundary"``, the
    residual stream; ``"experts"``, a moe layer's [E, C, D] buffers)."""
    return x


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
    ax = ("layers", "embed", "ffn")
    b.normal(f"{prefix}/w1", [n_layers, d, f], ax, fan_in=d)
    if kind == "swiglu":
        b.normal(f"{prefix}/w3", [n_layers, d, f], ax, fan_in=d)
    b.normal(f"{prefix}/w2", [n_layers, f, d], ("layers", "ffn", "embed"),
             fan_in=f)


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


# the tensors the "moe" remat policy keeps (JAX names them with
# ``jax.ad_checkpoint.checkpoint_name`` in its moe layer)
CHECKPOINT_NAMES = ("moe_in", "moe_out")


def checkpoint_name(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` marked for the "moe" remat policy (``name`` one of
    :data:`CHECKPOINT_NAMES`): an alias, the one op that policy keeps
    (a view: no copy, no kernel)."""
    if name not in CHECKPOINT_NAMES:
        raise ValueError(f"no remat policy keeps {name!r}")
    return torch.ops.aten.alias(t)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the positions with ``labels >= 0``, plus
    the z-loss ``z_loss * mean(lse ** 2)`` over the same positions
    (logits [..., V], labels [...] int); returns (loss, the count of
    those positions, at least 1), float32 scalars.

    As the JAX layer, the label's log-probability is a one-hot
    contraction with the float32 logits (under a vocabulary-sharded
    head it partitions where a gather would not).  The one-hot is an
    explicit comparison with ``arange(V)``: ``F.one_hot`` scatters on
    real tensors and compares on fake ones, and the dry-run's op count
    of a fake step must equal a real step's."""
    lf = logits.float()
    labels = labels.to(lf.device)
    lse = torch.logsumexp(lf, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=lf.device)
    onehot = (labels.clamp(min=0).long()[..., None]
              == vocab).to(torch.float32)
    ll = torch.einsum("...v,...v->...", lf, onehot)
    nll = lse - ll
    mask = (labels >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    zl = z_loss * ((lse ** 2) * mask).sum() / denom
    return loss + zl, denom


__all__ = ["Params", "Axes", "ParamInit", "identity_shard", "embed_lookup",
           "on_replicated",
           "WHOLE_DRAW_LIMIT", "MLP_KINDS",
           "RopeTables", "dtype_of", "rmsnorm",
           "dense", "mlp", "mlp_params", "rope", "rope_tables",
           "apply_rope", "sinusoidal_positions", "CHECKPOINT_NAMES",
           "checkpoint_name", "softmax_xent"]
