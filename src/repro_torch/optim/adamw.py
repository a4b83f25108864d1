"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The arithmetic is the JAX package's, operation for operation: clip by
the global norm first (``g * scale`` in g's dtype), then per element

    m' = b1 m + (1 - b1) g            v' = b2 v + (1 - b2) g g
    delta = (m' / bc1) / (sqrt(v' / bc2) + eps) + wd p
    p' = (p - lr delta) in p's dtype,  bc = 1 - b ** t, t = step + 1

in float32, each product and sum rounded on its own (no fused
multiply-add).  ``m`` and ``v`` are float32 whatever the parameters'
dtype, the step an int32 scalar.

Where the port differs: :func:`apply` updates the parameters, ``m`` and
``v`` in place, and clips the gradients in place, where the JAX function
returns new trees.  Each leaf is updated :data:`CHUNK` elements at a
time (the arithmetic is elementwise, so the numbers do not change), so
an update holds a few float32 temporaries of one chunk, never a float32
copy of a whole leaf (phi3-mini-3.8b's ``layers/mlp/w1`` is 3.2 GB in
float32).

On a mesh the parameters, gradients and moments are DTensors of one
placement a leaf (the trainer brings each gradient to its parameter's
placements first): the update then runs on each rank's local shard, and
the global norm sums the shards' squares over the mesh dimensions that
shard the leaf.  A parameter placed otherwise than its moments (ZeRO-1:
parameters replicated over the data axes, moments sharded) is updated
on the moments' shards: the parameter and its gradient are cut to them
(no communication), and the updated shard is gathered back into the
parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, map_tree

# elements of a leaf one update pass holds float32 temporaries for
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    """The optimizer state: ``step`` (int32 scalar) and the float32
    moments ``m`` and ``v``, trees like the parameters."""
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """Hyper-parameters (the JAX defaults)."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params: Any) -> AdamWState:
    """Zero moments beside each parameter (float32, on its device and,
    for a DTensor, with its placements) and step 0 on the device of the
    first leaf."""
    zeros = map_tree(lambda p: torch.zeros_like(
        p, dtype=torch.float32, requires_grad=False), params)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v=map_tree(torch.clone, zeros))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself under ``no_grad``, so
    writing it writes the DTensor); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _placed_apart(p: Any, m: Any) -> bool:
    """True for a DTensor parameter placed otherwise than its moment."""
    from torch.distributed.tensor import DTensor
    return (isinstance(p, DTensor)
            and tuple(p.placements) != tuple(m.placements))


def _sum_over_shards(part: torch.Tensor, like: Any) -> torch.Tensor:
    """``part``, a sum over ``like``'s local shard, summed over the mesh
    dimensions that shard ``like`` (a plain tensor: ``part``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(like, DTensor):
        return part
    place = [Partial() if pl.is_shard() else Replicate()
             for pl in like.placements]
    return DTensor.from_local(part, like.device_mesh, place,
                              run_check=False).full_tensor()


def _chunks(t: torch.Tensor):
    """Flat views of ``t`` of at most :data:`CHUNK` elements (``t`` must
    be contiguous: the chunks are written in place)."""
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in JAX's order) of each leaf's float32
    sum of squares; a float32 scalar.  A leaf is squared a chunk at a
    time, so no float32 copy of it exists whole."""
    total = None
    for leaf in leaves(tree):
        sq = None
        for c in _chunks(_local(leaf.detach()).contiguous()):
            cf = c.float()
            part = torch.sum(cf * cf)
            sq = part if sq is None else sq + part
        sq = _sum_over_shards(sq, leaf)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place by ``min(1, max_norm / max(norm, 1e-9))``
    (the scale cast to each leaf's dtype first, as JAX casts it); returns
    (grads, the norm before clipping)."""
    norm = global_norm(grads)
    # a true division (a Python number over a tensor is a reciprocal
    # times the number in torch: two roundings)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in leaves(grads):
            _local(g).mul_(scale.to(g.dtype))
    return grads, norm


def _update_chunk(cfg: AdamWConfig, p, g, m, v, bc1, bc2, lr) -> None:
    """One chunk of the update, in place on ``p``, ``m`` and ``v``."""
    gf = g.float()
    t = gf * (1 - cfg.b1)
    m.mul_(cfg.b1).add_(t)
    t = gf * (1 - cfg.b2)
    t.mul_(gf)
    v.mul_(cfg.b2).add_(t)
    del gf
    den = v / bc2
    den.sqrt_().add_(cfg.eps)
    upd = m / bc1
    upd.div_(den)
    del den
    pf = p.float()
    upd.add_(pf * cfg.weight_decay)
    upd.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(upd)
    else:
        p.copy_(pf.sub_(upd))


def apply(cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState,
          lr: Optional[torch.Tensor] = None
          ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW update (``lr`` overrides ``cfg.lr``: the schedule's
    float32 scalar).  Updates ``params``, ``state.m`` and ``state.v`` in
    place and clips ``grads`` in place; returns (params, the state with
    the step advanced, ``{"grad_norm": the norm before clipping}``)."""
    dev = state.step.device
    lr = (torch.tensor(cfg.lr, dtype=torch.float32, device=dev)
          if lr is None else torch.as_tensor(lr, dtype=torch.float32)
          .to(dev))
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    t = step.to(torch.float32)
    # device tensors, so a division by them is a true division on the
    # card too (a CPU scalar divisor becomes a reciprocal multiply there)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=dev), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=dev), t)
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            on_moments = _placed_apart(p, m)
            if on_moments:
                whole = p
                p, g = (t.redistribute(m.device_mesh, m.placements)
                        for t in (p.detach(), g))
            # a parameter updated in place must be its own storage; a
            # shard cut for the moments is copied back whole below
            pl = _local(p).contiguous() if on_moments else _local(p)
            gl = _local(g).contiguous()
            for pc, gc, mc, vc in zip(_chunks(pl), _chunks(gl),
                                      _chunks(_local(m)), _chunks(_local(v))):
                _update_chunk(cfg, pc, gc, mc, vc, bc1, bc2, lr)
            if on_moments:
                from torch.distributed.tensor import DTensor
                shard = DTensor.from_local(pl, m.device_mesh, m.placements,
                                           run_check=False)
                _local(whole).copy_(_local(shard.redistribute(
                    whole.device_mesh, whole.placements)))
    return (params, AdamWState(step=step, m=state.m, v=state.v),
            {"grad_norm": gnorm})


__all__ = ["AdamWState", "AdamWConfig", "CHUNK", "init", "global_norm",
           "clip_by_global_norm", "apply"]
