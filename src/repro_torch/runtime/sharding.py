"""Logical-axis sharding rules onto a torch ``DeviceMesh`` (port of
``repro.runtime.sharding``): FSDP x TP x DP(+EP/SP) with divisibility
fallbacks.

The models name every parameter dimension with a *logical* axis
(:class:`~repro_torch.models.layers.ParamInit`, ``Model.axes_tree``);
this module maps the names to mesh axes:

    vocab   -> model            (embedding / LM-head TP)
    embed   -> (pod, data)      (FSDP: parameters and optimizer state
                                 sharded over the data axes)
    heads   -> model            (attention TP)
    kv_heads-> model            (dropped when indivisible, e.g. MQA)
    ffn     -> model            (MLP TP)
    experts -> model            (expert parallelism)
    inner   -> model            (mamba / RG-LRU inner width)
    layers  -> None             (the stacked layer axis)

A mesh axis is used at most once per leaf, the longest prefix of a
multi-axis rule whose size product divides the dimension is kept, and a
dimension that does not divide drops its assignment.  The rules table is
a plain dict.

A spec is a plain tuple with one entry a tensor dimension: ``None``, a
mesh axis name, or a tuple of names (the counterpart of JAX's
``PartitionSpec``, so specs compare directly).  :func:`placements` turns
one into DTensor placements: ``Shard(d)`` on each mesh dimension that
shards tensor dimension ``d``, ``Replicate()`` on the others.  A
dimension split over ``("pod", "data")`` is ``Shard(d)`` on both, which
DTensor splits in mesh-dimension order, pod-major, as JAX splits
``P(("pod", "data"))``.

A mesh is any object with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``, or a stand-in of those two attributes for specs alone).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Tuple[str, ...]
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]

# Order within a value = the mesh axes composing that dimension's sharding.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "vocab": ("model",),
    "embed": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "inner": ("model",),
    "inner2": (),
    "layers": (),
    "batch": ("pod", "data"),
    "capacity": (),
    "seq": (),
    "act_embed": (),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical name -> mesh axes."""
    rules: Dict[str, MeshAxes] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **kw: MeshAxes) -> "ShardingRules":
        """A copy with some names remapped."""
        r = dict(self.rules)
        r.update(kw)
        return ShardingRules(rules=r)


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{mesh axis name: size}``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: ShardingRules) -> Spec:
    """Logical axes and a concrete shape -> a spec.

    Per dimension: look the name up, keep the mesh axes that exist in
    this mesh and are unused so far, then keep the longest prefix whose
    size product divides the dimension."""
    sizes = _axis_sizes(mesh)
    used: set = set()
    out: List[SpecEntry] = []
    for ax, dim in zip(axes, shape):
        best: Tuple[str, ...] = ()
        if ax is not None:
            want = [a for a in rules.rules.get(ax, ())
                    if a in sizes and a not in used]
            prod = 1
            for a in want:
                prod *= sizes[a]
                if dim % prod:
                    break
                best = best + (a,)
        used.update(best)
        out.append(None if not best else best[0] if len(best) == 1
                   else best)
    return tuple(out)


def _is_axes(x: Any) -> bool:
    """True for an axes-tree leaf: a tuple of names and Nones."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(axes_tree: Any, abstract_tree: Any, mesh,
               rules: ShardingRules) -> Any:
    """Matching (axes, shaped leaf) trees -> a tree of specs.  A shaped
    leaf is anything with ``shape`` (a tensor, a meta tensor, an
    array)."""
    if _is_axes(axes_tree):
        return resolve_spec(axes_tree, abstract_tree.shape, mesh, rules)
    return {k: tree_specs(v, abstract_tree[k], mesh, rules)
            for k, v in axes_tree.items()}


def batch_spec(shape: Sequence[int], mesh, rules: ShardingRules) -> Spec:
    """A data batch: dim 0 over the batch rule, the rest replicated."""
    axes = ["batch"] + [None] * (len(shape) - 1)
    return resolve_spec(axes, shape, mesh, rules)


def batch_specs(batch_tree: Dict[str, Any], mesh,
                rules: ShardingRules) -> Dict[str, Spec]:
    """:func:`batch_spec` of every field of a batch."""
    return {k: batch_spec(v.shape, mesh, rules)
            for k, v in batch_tree.items()}


_CACHE_AXES: Dict[Tuple[str, int], Tuple[Optional[str], ...]] = {
    # kv caches
    ("k", 5): ("layers", "batch", "kv_heads", "seq", None),
    ("v", 5): ("layers", "batch", "kv_heads", "seq", None),
    ("k", 4): ("batch", "kv_heads", "seq", None),
    ("v", 4): ("batch", "kv_heads", "seq", None),
    # mamba / rglru states
    ("ssm", 4): ("layers", "batch", "inner", None),
    ("ssm", 3): ("batch", "inner", None),
    ("conv", 4): ("layers", "batch", None, "inner"),
    ("conv", 3): ("batch", None, "inner"),
    ("h", 3): ("layers", "batch", "inner"),
    ("h", 2): ("batch", "inner"),
}


def cache_specs(cache_tree: Any, mesh, rules: ShardingRules) -> Any:
    """Specs of a decode cache tree, matched on each leaf's name and
    rank (the models own the cache layout); an unknown leaf shards its
    first dimension over the batch rule."""
    def walk(node, name):
        """Specs of one subtree whose key is ``name``."""
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        axes = _CACHE_AXES.get((name, len(node.shape)))
        if axes is None:
            axes = ("batch",) + (None,) * (len(node.shape) - 1)
        return resolve_spec(axes, node.shape, mesh, rules)

    return walk(cache_tree, "")


def placements(spec: Spec, mesh) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dimension named at tensor dimension ``d``, ``Replicate()``
    on the rest.  A tuple entry must name its axes in mesh order (DTensor
    splits mesh-dimension-major)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def distribute(t: torch.Tensor, spec: Spec, mesh) -> Any:
    """``t`` (the same full value on every rank) as a DTensor placed by
    ``spec``; keeps ``requires_grad``."""
    from torch.distributed.tensor import distribute_tensor
    out = distribute_tensor(t.detach(), mesh, placements(spec, mesh))
    return out.requires_grad_(t.requires_grad)


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` as a DTensor placed by the matching spec of
    ``specs`` (a tree of the same dict structure)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    return distribute(tree, specs, mesh)


def make_activation_shard_fn(mesh, rules: ShardingRules):
    """The activation ``shard_fn`` of a meshed model: redistributes a
    3-D DTensor activation to its spec's placements.

    ``where="boundary"`` (default): the residual stream [batch, seq,
    embed] -> (batch rule, seq rule, act_embed rule); with
    ``rules.with_overrides(seq=("model",))`` this is Megatron-style
    sequence parallelism.  ``where="inner"``: [batch, seq, embed] with
    seq replicated.  ``where="experts"``: a moe layer's [E, C, D]
    buffers, sharded over capacity (experts rarely divide the model
    axis).  A tensor that is not a DTensor or not 3-D, and an all-None
    spec (which would pin the tensor replicated), pass unchanged."""
    from torch.distributed.tensor import DTensor

    def shard_fn(x, where: str = "boundary"):
        """Place activation ``x`` (see :func:`make_activation_shard_fn`)."""
        if not isinstance(x, DTensor) or x.ndim != 3:
            return x
        if where == "experts":
            axes = (None, "capacity", None)
        elif where == "inner":
            axes = ("batch", None, None)
        else:
            axes = ("batch", "seq", "act_embed")
        spec = resolve_spec(axes, x.shape, mesh, rules)
        if all(s is None for s in spec):
            return x
        return x.redistribute(mesh, placements(spec, mesh))

    return shard_fn


def is_dtensor(t: Any) -> bool:
    """True for a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def meshed(tree: Any):
    """``implicit_replication`` when a leaf of ``tree`` (a parameter
    tree) is a DTensor, else a null context: plain tensors a meshed step
    makes inside itself (rope tables, masks, positions) then join
    DTensors as replicated.  The train step and the model's prefill,
    forward and decode entry points run under it."""
    from repro_torch.tree import leaves
    if any(is_dtensor(p) for p in leaves(tree)):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def mesh_contains(mesh, axis: str) -> bool:
    """True when ``mesh`` has an axis named ``axis``."""
    return axis in tuple(mesh.mesh_dim_names)


__all__ = ["DEFAULT_RULES", "ShardingRules", "Spec", "resolve_spec",
           "tree_specs", "batch_spec", "batch_specs", "cache_specs",
           "placements", "distribute", "distribute_tree",
           "make_activation_shard_fn", "is_dtensor", "meshed",
           "mesh_contains"]
