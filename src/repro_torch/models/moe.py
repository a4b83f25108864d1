"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``).

Routing is softmax top-k over the experts, the gates renormalised to
sum to one.  Each (token, k) entry takes a slot in its expert's
capacity buffer: the entries are sorted by expert with a stable sort
(so an expert's slots go to its entries in token order), an entry's
position in its expert's group comes from ``searchsorted``, and entries
beyond the capacity ``C`` (:func:`capacity`) are dropped.  The experts
run as three batched products over the ``[E, C, D]`` buffers, and each
token sums its kept experts' outputs, weighted by their gates.  Shared
experts run as one SwiGLU over every token.

Everything has static shapes and reads no value on the host (no
``nonzero``, no ``.item()``, no mask that changes a shape), so a step
that runs this layer is captured as a CUDA graph like a dense one.  Pad
rows and pad positions are routed and take slots like real tokens, as
in the JAX package.

Where the port follows the JAX package's numbers exactly:

* ``jax.lax.top_k`` puts the lower expert first among equal
  probabilities; ``torch.topk`` promises no order, so the top k come
  from a stable descending sort (:func:`sorted_top_k`).
* The JAX scatter-add sums a token's contributions from zero in the
  sorted order (by expert id); the port adds them in that order, one
  ``k`` at a time, in float32, with no atomic ``index_add_``, whose
  order changes from run to run on the card.

Where it does not: the JAX expert products keep ``h1``, ``h3`` and
``y`` in float32 (``preferred_element_type``); the port's batched
products return the operands' dtype, so a bf16 model rounds them to
bf16 (cuBLAS accumulates in float32 and rounds once).  A float32 model
computes the same numbers.

:func:`drop_tally` counts the dropped slots on the device, for a
caller that wants to see how often capacity bites.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (ParamInit, Params, checkpoint_name,
                                       dense, identity_shard, mlp,
                                       on_replicated)

# one counter of dropped slots per device, never freed (a graph captured
# while a drop_tally was open adds to it at every replay, also after the
# tally closed); _TALLY is the one moe_ffn adds to while a tally is open
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_TALLY: Optional[torch.Tensor] = None


def moe_params(b: ParamInit, prefix: str, n_layers: int, d: int,
               n_experts: int, moe_ff: int, n_shared: int,
               shared_ff: int) -> None:
    """Stacked router, expert and shared-expert weights under ``prefix``
    (the JAX paths and shapes)."""
    b.normal(f"{prefix}/router", [n_layers, d, n_experts],
             ("layers", "embed", None), fan_in=d)
    ax = ("layers", "experts", "embed", "ffn")
    b.normal(f"{prefix}/w1", [n_layers, n_experts, d, moe_ff], ax, fan_in=d)
    b.normal(f"{prefix}/w3", [n_layers, n_experts, d, moe_ff], ax, fan_in=d)
    b.normal(f"{prefix}/w2", [n_layers, n_experts, moe_ff, d],
             ("layers", "experts", "ffn", "embed"), fan_in=moe_ff)
    if n_shared:
        f = shared_ff * n_shared if shared_ff else 0
        b.normal(f"{prefix}/shared_w1", [n_layers, d, f],
                 ("layers", "embed", "ffn"), fan_in=d)
        b.normal(f"{prefix}/shared_w3", [n_layers, d, f],
                 ("layers", "embed", "ffn"), fan_in=d)
        b.normal(f"{prefix}/shared_w2", [n_layers, f, d],
                 ("layers", "ffn", "embed"), fan_in=f)


def capacity(n_tokens: int, n_experts: int, k: int, factor: float) -> int:
    """Slots per expert: ``ceil(k * T / E * factor)`` rounded up to a
    multiple of 8 (of 128 from 128 on), at least 8."""
    c = math.ceil(k * n_tokens / n_experts * factor)
    return max(8, -(-c // 128) * 128 if c >= 128 else -(-c // 8) * 8)


def sorted_top_k(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of each row in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt: torch.Tensor, router: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 router probabilities [T, E] and the renormalised top-k
    gates and experts [T, k]."""
    logits = dense(xt, router).float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert = sorted_top_k(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, expert


@contextlib.contextmanager
def drop_tally(device) -> Iterator[torch.Tensor]:
    """``device``'s int64 counter of dropped slots, zeroed: every
    :func:`moe_ffn` run (or captured) while the tally is open adds its
    dropped slots to it, on the device.  The counter is the device's one
    and lives as long as the process, so a graph captured inside adds
    to it at every replay, also after the tally closed."""
    global _TALLY
    prev = _TALLY
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = _COUNTERS.get(device)
    if counter is None:
        counter = _COUNTERS[device] = torch.zeros(
            (), dtype=torch.int64, device=device)
    _TALLY = counter.zero_()
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def moe_ffn(x: torch.Tensor, p: Params, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25,
            shard_fn: Callable = identity_shard
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D] in x's dtype, the float32
    load-balancing aux loss, Switch-style).  ``shard_fn(t, "experts")``
    places the [E, C, D] expert buffers (in and out), as in JAX.

    On a mesh (``x`` a DTensor) the routing's sorts and searches have no
    DTensor sharding strategy, so the layer is redistributed explicitly
    here: its input and weights are gathered (replicated) on every rank,
    every rank runs the layer on plain tensors, and the output goes back
    to ``x``'s placements (:func:`~repro_torch.models.layers.
    on_replicated`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return on_replicated(moe_ffn, x, p, n_experts=n_experts,
                             top_k=top_k, capacity_factor=capacity_factor)
    bsz, seq, d = x.shape
    t = bsz * seq
    dev = x.device
    xt = x.reshape(t, d)
    probs, gate, expert = _route(xt, p["router"], top_k)

    experts = torch.arange(n_experts, device=dev)
    density = (expert[:, :1] == experts).float().mean(dim=0)
    aux = n_experts * torch.sum(density * probs.mean(dim=0))

    c = capacity(t, n_experts, top_k, capacity_factor)
    tk = t * top_k
    flat_expert = expert.reshape(tk)
    flat_gate = gate.reshape(tk)
    flat_token = torch.arange(t, device=dev)[:, None].expand(
        t, top_k).reshape(tk)

    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    group_start = torch.searchsorted(sorted_expert, experts, side="left")
    pos_in_expert = torch.arange(tk, device=dev) - group_start[sorted_expert]
    keep = pos_in_expert < c
    slot = sorted_expert * c + pos_in_expert
    if _TALLY is not None:
        _TALLY.add_((~keep).sum())

    src_token = flat_token[order]
    src_gate = flat_gate[order]

    # the capacity buffers [E*C] of token ids, t the sentinel (a zero
    # row); a dropped entry writes to the extra slot E*C, cut off after
    buf_token = torch.full((n_experts * c + 1,), t, dtype=torch.int64,
                           device=dev)
    buf_token.index_copy_(0, torch.where(keep, slot, n_experts * c),
                          src_token)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    expert_in = checkpoint_name(shard_fn(
        x_pad[buf_token[:-1]].reshape(n_experts, c, d), "experts"),
        "moe_in")

    h1 = torch.bmm(expert_in, p["w1"])
    h3 = torch.bmm(expert_in, p["w3"])
    h = (F.silu(h1.float()) * h3.float()).to(x.dtype)
    y = checkpoint_name(shard_fn(torch.bmm(h, p["w2"]), "experts"),
                        "moe_out").reshape(n_experts * c, d)

    # each token's k contributions, summed from zero in sorted order
    w = torch.where(keep, src_gate, torch.zeros_like(src_gate))[:, None]
    contrib = y[torch.where(keep, slot, 0)].float() * w        # [T*k, D]
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(tk, device=dev))
    mine = torch.sort(rank.reshape(t, top_k), dim=1).values    # [T, k]
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for i in range(top_k):
        out = out + contrib[mine[:, i]]

    if "shared_w1" in p:
        shared = mlp(xt, {"w1": p["shared_w1"], "w3": p["shared_w3"],
                          "w2": p["shared_w2"]}, "swiglu")
        out = out + shared.float()
    return out.reshape(bsz, seq, d).to(x.dtype), aux


def moe_ffn_ref(x: torch.Tensor, p: Params, *, n_experts: int,
                top_k: int) -> torch.Tensor:
    """Oracle: every expert on every token, no capacity (the JAX
    ``moe_ffn_ref``)."""
    bsz, seq, d = x.shape
    xt = x.reshape(bsz * seq, d)
    _, gate, expert = _route(xt, p["router"], top_k)
    out = torch.zeros((bsz * seq, d), dtype=torch.float32, device=x.device)
    for e in range(n_experts):
        pe = {"w1": p["w1"][e], "w3": p["w3"][e], "w2": p["w2"][e]}
        ye = mlp(xt, pe, "swiglu").float()
        wsel = torch.where(expert == e, gate,
                           torch.zeros_like(gate)).sum(-1)[:, None]
        out = out + wsel * ye
    if "shared_w1" in p:
        out = out + mlp(xt, {"w1": p["shared_w1"], "w3": p["shared_w3"],
                             "w2": p["shared_w2"]}, "swiglu").float()
    return out.reshape(bsz, seq, d).to(x.dtype)


__all__ = ["moe_params", "capacity", "sorted_top_k", "drop_tally", "moe_ffn",
           "moe_ffn_ref"]
