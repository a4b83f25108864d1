"""Permutation indexing utilities (thesis §4.2).

The thesis introduces a *Hamiltonian-path index* for the 720 permutations of
the six convolution loops: order the permutations along the path produced by
the Steinhaus–Johnson–Trotter (SJT) algorithm, so that consecutive indices
differ by exactly one adjacent transposition.  Performance "signatures"
plotted in this order are spatially smooth, which (a) makes good/bad regions
visible and (b) enables locality-aware search (neighbour-swap hill climbing,
BFS on the permutohedron — thesis §7.2).

This module provides, for any n:
  - ``sjt_permutations(n)``     — the SJT Hamiltonian path (list of tuples)
  - ``hamiltonian_index(perm)`` — position of ``perm`` on that path
  - ``lex_index`` / ``revlex_index`` — the two baseline indexings (Fig 4.2)
  - ``permutohedron_neighbors(perm)`` — adjacent-transposition neighbours
  - ``permutohedron_graph(n)``  — the full graph as an adjacency dict

It is the JAX package's module (``repro.core.permutations``), copied: the
orders and indices are equal.
"""
from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import Dict, Iterator, List, Sequence, Tuple

Perm = Tuple[int, ...]


def _sjt_generator(n: int) -> Iterator[Perm]:
    """Steinhaus–Johnson–Trotter with Even's speedup.

    Yields every permutation of ``range(n)`` exactly once; consecutive
    permutations differ by one adjacent transposition (a Hamiltonian path on
    the permutohedron graph).
    """
    # Each element carries a direction: -1 (left) or +1 (right); 0 at ends.
    perm = list(range(n))
    direction = [-1] * n
    direction[0] = 0
    yield tuple(perm)
    while True:
        # Find the largest mobile element (non-zero direction).
        mobile_idx = -1
        mobile_val = -1
        for i, v in enumerate(perm):
            if direction[v] != 0 and v > mobile_val:
                mobile_val = v
                mobile_idx = i
        if mobile_idx < 0:
            return
        j = mobile_idx + direction[mobile_val]
        perm[mobile_idx], perm[j] = perm[j], perm[mobile_idx]
        yield tuple(perm)
        # If the moved element reached a boundary or a larger element,
        # freeze it.
        nj = j + direction[mobile_val]
        if nj < 0 or nj >= n or perm[nj] > mobile_val:
            direction[mobile_val] = 0
        # Reactivate all larger elements, pointing them at the moved one.
        for v in range(mobile_val + 1, n):
            pos = perm.index(v)
            direction[v] = -1 if pos > j else 1


@lru_cache(maxsize=8)
def sjt_permutations(n: int) -> Tuple[Perm, ...]:
    """All n! permutations of range(n) in SJT (Hamiltonian-path) order."""
    return tuple(_sjt_generator(n))


@lru_cache(maxsize=8)
def _sjt_index_table(n: int) -> Dict[Perm, int]:
    """Permutation -> position along the SJT Hamiltonian path."""
    return {p: i for i, p in enumerate(sjt_permutations(n))}


def hamiltonian_index(perm: Sequence[int]) -> int:
    """Index of ``perm`` along the SJT Hamiltonian path (thesis §4.2)."""
    p = tuple(perm)
    return _sjt_index_table(len(p))[p]


def lex_index(perm: Sequence[int]) -> int:
    """Lexicographic rank of a permutation of range(n) (factorial number
    system; O(n^2), fine for n<=8)."""
    p = list(perm)
    n = len(p)
    rank = 0
    for i in range(n):
        smaller = sum(1 for j in range(i + 1, n) if p[j] < p[i])
        rank += smaller * math.factorial(n - 1 - i)
    return rank


def lex_permutations(n: int) -> List[Perm]:
    """All n! permutations of range(n) in lexicographic order."""
    return list(itertools.permutations(range(n)))


def revlex_index(perm: Sequence[int]) -> int:
    """Reverse-lexicographic rank (thesis Fig 4.2's second baseline: the
    lexicographic order of the reversed permutation, which groups the 120
    permutations sharing an innermost loop into contiguous segments)."""
    return lex_index(tuple(reversed(tuple(perm))))


def permutohedron_neighbors(perm: Sequence[int]) -> List[Perm]:
    """Permutations that differ from ``perm`` by one adjacent swap."""
    p = tuple(perm)
    out = []
    for i in range(len(p) - 1):
        q = list(p)
        q[i], q[i + 1] = q[i + 1], q[i]
        out.append(tuple(q))
    return out


def permutohedron_graph(n: int) -> Dict[Perm, List[Perm]]:
    """Adjacency dict of the permutohedron graph (n! nodes,
    n!*(n-1)/2 edges).  Thesis Fig 4.1 shows the n=4 instance."""
    return {p: permutohedron_neighbors(p) for p in itertools.permutations(range(n))}


def perm_apply(perm: Sequence[int], items: Sequence) -> Tuple:
    """Reorder ``items`` so position k holds items[perm[k]]."""
    return tuple(items[i] for i in perm)


def perm_inverse(perm: Sequence[int]) -> Perm:
    """The inverse permutation: perm_apply(inv, perm_apply(perm, x)) == x."""
    inv = [0] * len(perm)
    for i, v in enumerate(perm):
        inv[v] = i
    return tuple(inv)
