"""Parameter trees: nested dicts of tensors (and the optimizer state, a
NamedTuple of such trees), walked in the JAX package's leaf order.

``jax.tree_util`` visits a dict's keys sorted and a NamedTuple's fields
in order; the checkpoint format keys a leaf by its path in that walk
(``layers/attn/wq``; a NamedTuple field as ``.m``, as ``str`` of JAX's
``GetAttrKey`` reads).  Walking the same order here makes the global
norm's sum and a checkpoint's byte layout the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node: Any) -> bool:
    """True for a NamedTuple instance (a tuple with ``_fields``)."""
    return isinstance(node, tuple) and hasattr(node, "_fields")


def map_with_paths(fn: Callable[[str, Any], Any], tree: Any,
                   prefix: str = "") -> Any:
    """A tree of the same structure with ``fn(path, leaf)`` at each leaf,
    visited in JAX's order: dict keys sorted, NamedTuple fields in order
    (``.name``), list and tuple items by index; anything else is a
    leaf.  A rebuilt dict keeps ``tree``'s key order."""
    def join(k) -> str:
        """The child's path."""
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        done = {k: map_with_paths(fn, tree[k], join(k)) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_paths(fn, getattr(tree, n),
                                           join(f".{n}"))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf in JAX's order (see
    :func:`map_with_paths`)."""
    out: List[Tuple[str, Any]] = []
    map_with_paths(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map_tree(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """A tree of the same structure as ``tree`` (dicts, NamedTuples,
    lists, tuples) with ``fn(leaf, *leaves of rest)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, getattr(tree, n),
                                     *(getattr(r, n) for r in rest))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


__all__ = ["map_with_paths", "flatten_with_paths", "leaves", "map_tree"]
