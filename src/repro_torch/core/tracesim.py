"""Exact trace-driven cache simulator (thesis §2.3.1, the Pin-tool role).

The thesis explores the 720-permutation space with a fast cache simulator
built on binary instrumentation.  Here the "binary" is the six-loop nest
itself: we *generate* the exact memory-reference trace a given permutation
produces (vectorised numpy, no Python loop over iterations) and push it
through a faithful multi-level cache model — direct-mapped L1 and N-way L2
with LRU or random replacement, 32-byte blocks, shared scope — i.e. thesis
Table 2.1.

This simulator is exact but O(trace); it validates the analytic footprint
model of :mod:`repro_torch.core.loki` on small layers, mirroring the
thesis' MARSSx86-vs-simulator comparison (Fig 2.3).

It is the JAX package's module (``repro.core.tracesim``), copied: traces,
misses and cycles are equal.  It imports numpy and the Loki model only,
so the exact sweep's worker processes (:func:`exact_cycles`) never import
torch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import loopnest as ln
from repro_torch.core.loki import EVAL_COUNTS, MachineModel
from repro_torch.core.loopnest import ConvLayer, LOOPS


def generate_trace(layer: ConvLayer, perm: Sequence[int],
                   partial_sums: bool = True,
                   max_iters: Optional[int] = None,
                   ) -> Tuple[np.ndarray, int]:
    """Byte-address trace of the nest under ``perm``.

    Returns ``(addresses, n_iterations)``; the per-iteration access order is
    (img read, wgt read[, out read/write]).  With ``partial_sums`` the out[]
    access happens only when the innermost reduction run completes (thesis
    §3.3).  ``max_iters`` truncates the trace like the thesis' 100M/500M
    instruction caps (§4.3.2).
    """
    trips_map = layer.trips()
    order = [LOOPS[p] for p in perm]
    trips = [trips_map[name] for name in order]
    total = math.prod(trips)
    n = min(total, max_iters) if max_iters else total

    # Loop variable value per iteration: mixed-radix decode of the
    # iteration counter in permutation order.
    it = np.arange(n, dtype=np.int64)
    values: Dict[str, np.ndarray] = {}
    stride = total
    for name, t in zip(order, trips):
        stride //= t
        values[name] = (it // stride) % t

    oc, ic = values["oc"], values["ic"]
    y, x = values["y"], values["x"]
    ky, kx = values["ky"], values["kx"]
    eb = layer.elem_bytes
    H2, W2 = layer.h + layer.kh - 1, layer.w + layer.kw - 1

    shapes = layer.array_bytes()
    img_base = 0
    wgt_base = img_base + shapes["img"]
    out_base = wgt_base + shapes["wgt"]

    img_addr = img_base + ((ic * H2 + (y + ky)) * W2 + (x + kx)) * eb
    wgt_addr = wgt_base + (((oc * layer.ic + ic) * layer.kh + ky)
                           * layer.kw + kx) * eb
    out_addr = out_base + ((oc * layer.h + y) * layer.w + x) * eb

    if partial_sums:
        # out[] touched once per completed innermost reduction run.
        run = 1
        for name, t in zip(reversed(order), reversed(trips)):
            if name in ln.REDUCTION_LOOPS:
                run *= t
            else:
                break
        spill = (it % run) == (run - 1)
        # Per iteration 2 or 3 accesses; place them at cumulative offsets to
        # preserve exact time order.
        k = 2 + spill.astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(k)[:-1]])
        trace = np.zeros(int(k.sum()), dtype=np.int64)
        trace[offs] = img_addr
        trace[offs + 1] = wgt_addr
        trace[offs[spill] + 2] = out_addr[spill]
        return trace, n
    else:
        trace = np.empty(3 * n, dtype=np.int64)
        trace[0::3] = img_addr
        trace[1::3] = wgt_addr
        trace[2::3] = out_addr
        return trace, n


def simulate_direct_mapped(blocks: np.ndarray, n_sets: int) -> np.ndarray:
    """Vectorised direct-mapped cache: returns a boolean miss mask.

    For each set, an access misses iff its block differs from the previous
    block mapped to that set (plus the compulsory first access).
    """
    sets = blocks % n_sets
    order = np.argsort(sets, kind="stable")
    sorted_blocks = blocks[order]
    sorted_sets = sets[order]
    miss_sorted = np.ones(len(blocks), dtype=bool)
    same_set = sorted_sets[1:] == sorted_sets[:-1]
    same_block = sorted_blocks[1:] == sorted_blocks[:-1]
    miss_sorted[1:] = ~(same_set & same_block)
    miss = np.empty(len(blocks), dtype=bool)
    miss[order] = miss_sorted
    return miss


def simulate_set_associative(blocks: np.ndarray, n_sets: int, ways: int,
                             policy: str = "random",
                             seed: int = 0) -> np.ndarray:
    """N-way set-associative cache (LRU or random replacement, thesis
    Table 2.1 uses random for L2).  Per-set Python loop — use on the
    (already-filtered) L1-miss stream, which is short."""
    rng = np.random.default_rng(seed)
    miss = np.zeros(len(blocks), dtype=bool)
    sets = blocks % n_sets
    for s in np.unique(sets):
        idx = np.nonzero(sets == s)[0]
        content: list = []
        for i in idx:
            b = blocks[i]
            if b in content:
                if policy == "lru":
                    content.remove(b)
                    content.append(b)
            else:
                miss[i] = True
                if len(content) >= ways:
                    if policy == "lru":
                        content.pop(0)
                    else:
                        content.pop(int(rng.integers(len(content))))
                content.append(b)
    return miss


@dataclasses.dataclass(frozen=True)
class TraceSimResult:
    """One exact simulation: cycles, accesses, per-level misses, iterations."""

    cycles: float
    accesses: int
    misses: Dict[str, int]
    iterations: int


def simulate_trace(layer: ConvLayer, perm: Sequence[int],
                   machine: MachineModel = MachineModel(),
                   partial_sums: bool = True,
                   max_iters: Optional[int] = None,
                   l2_policy: str = "random") -> TraceSimResult:
    """End-to-end: generate trace, run it through L1 then L2, produce the
    thesis' cycle estimate (1 cycle/instr + per-level hit latencies)."""
    EVAL_COUNTS["tracesim"] += 1
    trace, iters = generate_trace(layer, perm, partial_sums, max_iters)
    l1, l2 = machine.levels[0], machine.levels[1]

    blocks1 = trace // l1.block_bytes
    n_sets1 = l1.size_bytes // (l1.block_bytes * l1.associativity)
    if l1.associativity == 1:
        miss1 = simulate_direct_mapped(blocks1, n_sets1)
    else:
        miss1 = simulate_set_associative(blocks1, n_sets1, l1.associativity,
                                         "lru")
    l1_miss_stream = trace[miss1] // l2.block_bytes
    n_sets2 = l2.size_bytes // (l2.block_bytes * l2.associativity)
    miss2 = simulate_set_associative(l1_miss_stream, n_sets2,
                                     l2.associativity, l2_policy)

    m1 = int(miss1.sum())
    m2 = int(miss2.sum())
    accesses = len(trace)
    cycles = (iters * machine.instrs_per_iter * machine.cpi_compute
              + (accesses - m1) * l1.latency
              + (m1 - m2) * l2.latency
              + m2 * machine.mem_latency)
    return TraceSimResult(cycles=cycles, accesses=accesses,
                          misses={"L1": m1, "L2": m2}, iterations=iters)


def reuse_analysis(trace: np.ndarray, block_bytes: int = 32
                   ) -> Dict[str, float]:
    """Thesis Fig 3.3: address/block reuse statistics of a trace.

    Addresses are renamed by order of first appearance (the thesis'
    compaction for visualisation); we report the quantitative summary the
    figure is read for — distinct blocks (working-set proxy), the mean
    reuse distance at block granularity, and the reuse fraction.
    """
    blocks = trace // block_bytes
    _, first_idx, inverse, counts = np.unique(
        blocks, return_index=True, return_inverse=True,
        return_counts=True)
    distinct = len(first_idx)
    reuse_fraction = 1.0 - distinct / len(blocks)
    # mean distance between consecutive touches of the same block
    order = np.argsort(inverse, kind="stable")
    sorted_pos = np.arange(len(blocks))[order]
    sorted_ids = inverse[order]
    same = sorted_ids[1:] == sorted_ids[:-1]
    gaps = (sorted_pos[1:] - sorted_pos[:-1])[same]
    mean_dist = float(gaps.mean()) if len(gaps) else 0.0
    return {"accesses": float(len(blocks)),
            "distinct_blocks": float(distinct),
            "working_set_bytes": float(distinct * block_bytes),
            "reuse_fraction": reuse_fraction,
            "mean_reuse_distance": mean_dist}


def exact_cycles(args) -> float:
    """Pool target of ``tuner.exact_sweep``: one trace-driven simulation
    of ``(layer, perm, machine, max_iters)``, returning its cycles."""
    layer, perm, machine, max_iters = args
    return float(simulate_trace(layer, perm, machine,
                                max_iters=max_iters).cycles)


__all__ = ["generate_trace", "simulate_direct_mapped",
           "simulate_set_associative", "TraceSimResult", "simulate_trace",
           "reuse_analysis", "exact_cycles"]
