"""The Loki machine model: the thesis' analytic cache model (§2.3.1).

A multi-level cache model parameterised like thesis Table 2.1 (L1 64 KB /
L2 512 KB / 32 B blocks, latencies 3/10/30).  For a loop permutation of
the six-loop conv nest it predicts per-level misses and "cycles" with the
thesis' accounting (1 cycle per instruction + hit latencies).  It is
*analytic*, footprint mathematics instead of a trace, so one query costs
microseconds and the 720-permutation sweeps of Ch. 4/5 run in seconds.
The exact trace-driven simulator in :mod:`repro_torch.core.tracesim`
validates it.

This is the JAX package's model (``repro.core.cost_model``: ``simulate``,
``simulate_batch`` and their types), copied, so sweeps give equal arrays
in both packages.  It lives in a module of its own, importing numpy and
:mod:`repro_torch.core.loopnest` only, so that a worker process of the
exact sweep (``tuner.exact_sweep``) never imports torch;
:mod:`repro_torch.core.cost_model` re-exports every name, beside the
H100 model.

:data:`LOKI_MODEL_VERSION` keys the Loki records (``conv_sweep``).  It is
its own string, not the H100 model's ``COST_MODEL_VERSION``: a refit of
the H100 constants leaves every Loki sweep valid, and the port's
``conv_sweep`` keys equal the JAX package's (which key on its
``COST_MODEL_VERSION``, ``"1"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import loopnest as ln
from repro_torch.core.loopnest import ConvLayer, LOOPS

# Bump whenever a change below alters predicted cycles: the registry keys
# Loki sweeps on it, so stale predictions self-invalidate.
LOKI_MODEL_VERSION = "1"

# Cost-model queries in this process, one per candidate scored (tier-1
# sweeps, the tier-2 ECM batch, tier-3 exact traces).  The H100 model's
# counters join this dict in :mod:`repro_torch.core.cost_model`, so
# ``cost_model.total_evals`` sums both machines, as the JAX package's does.
EVAL_COUNTS: Dict[str, int] = {"simulate": 0, "simulate_batch": 0,
                               "ecm_batch": 0, "tracesim": 0}


# ---------------------------------------------------------------------------
# Paper-faithful cache hierarchy model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheLevel:
    """One level of the modelled cache hierarchy (thesis Table 2.1 row)."""

    name: str
    size_bytes: int
    block_bytes: int
    latency: int          # access latency in cycles (thesis Table 2.1)
    associativity: int = 1  # kept for parity with tracesim; analytic model
    #                         treats capacity as fully effective


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Thesis Table 2.1 defaults: Loki-like hierarchy."""
    levels: Tuple[CacheLevel, ...] = (
        CacheLevel("L1", 64 * 1024, 32, 3),
        CacheLevel("L2", 512 * 1024, 32, 10, associativity=8),
    )
    mem_latency: int = 30
    cpi_compute: float = 1.0   # non-memory instructions per iteration cost
    instrs_per_iter: float = 4.0  # mul+add+addr+branch (post §3.1 opts)
    atomic_cost: float = 10.0  # extra cycles per atomic out[] update (§3.4)

    def with_caches(self, l1_kb: int, l2_kb: int) -> "MachineModel":
        """This machine with resized L1/L2 (the §5.1 hierarchy knob)."""
        lv = (CacheLevel("L1", l1_kb * 1024, 32, 3),
              CacheLevel("L2", l2_kb * 1024, 32, 10, associativity=8))
        return dataclasses.replace(self, levels=lv)


# The three cache hierarchies of thesis §5.1.
HIERARCHIES: Dict[str, MachineModel] = {
    "16K/128K": MachineModel().with_caches(16, 128),
    "32K/512K": MachineModel().with_caches(32, 512),
    "64K/960K": MachineModel().with_caches(64, 960),
}


@dataclasses.dataclass(frozen=True)
class CacheSimResult:
    """One permutation's predicted cycles, accesses and per-level misses."""

    cycles: float
    accesses: float
    misses: Dict[str, float]          # per level name
    misses_by_array: Dict[str, Dict[str, float]]  # level -> array -> misses
    working_set_blocks: Dict[str, float]   # level -> fitting-depth footprint


def _fetches_per_level(layer: ConvLayer, perm: Sequence[int],
                       capacity_blocks: float, block_bytes: int,
                       ) -> Dict[str, float]:
    """Block fetches ("misses") per array for one cache level.

    Recursive footprint model, innermost to outermost:

    * If one iteration of the loop at depth d keeps the *total* inner
      footprint within capacity, all reuse across that loop's iterations is
      realised: fetches collapse to the distinct blocks over depths >= d
      (this also captures sliding-window halo reuse exactly, because
      footprints of coupled dims use the a+b-1 extent arithmetic).
    * Otherwise the inner working set is evicted between iterations and
      fetches multiply by the trip count — whether or not the loop indexes
      the array (a non-indexing loop re-touches the same, evicted, blocks).
    * Hot-set exception: an array whose own full-depth footprint is <= half
      the capacity is re-touched every iteration and survives streaming
      (LRU keeps re-used blocks); its fetches stay at the one-pass count.
    """
    trips = layer.trips()
    n = len(perm)
    # Total footprint (blocks, all arrays) at each depth d = loops [d..n).
    total_fp = []
    for d in range(n + 1):
        inner = ln.inner_set(perm, d)
        total_fp.append(sum(
            ln.footprint_blocks(layer, a, inner, block_bytes)
            for a in ln.ARRAY_DIMS))

    fetches: Dict[str, float] = {}
    for array in ln.ARRAY_DIMS:
        full_fp = ln.footprint_blocks(layer, array, ln.inner_set(perm, 0),
                                      block_bytes)
        if full_fp <= capacity_blocks / 2:
            # Hot set: survives any streaming; compulsory misses only.
            fetches[array] = float(full_fp)
            continue
        f = 1.0  # innermost body touches one block of each array
        for d in range(n - 1, -1, -1):
            name = LOOPS[perm[d]]
            if total_fp[d] <= capacity_blocks:
                # Whole sub-nest at depth d fits: one-pass distinct blocks.
                f = float(ln.footprint_blocks(
                    layer, array, ln.inner_set(perm, d), block_bytes))
            else:
                inner_fits = total_fp[d + 1] <= capacity_blocks
                if inner_fits and name not in ln.ARRAY_LOOPS[array]:
                    # Same blocks each iteration and they survive (one
                    # iteration's set fits): no multiplier.
                    pass
                elif inner_fits and name in ln.ARRAY_LOOPS[array]:
                    # Fresh data each iteration, but coupled (halo) overlap
                    # is reused: charge distinct blocks over this depth.
                    f = float(ln.footprint_blocks(
                        layer, array, ln.inner_set(perm, d), block_bytes))
                else:
                    f *= trips[name]
        fetches[array] = f
    return fetches


def simulate(layer: ConvLayer, perm: Sequence[int],
             machine: MachineModel = MachineModel(),
             threads: int = 1,
             partial_sums: bool = True) -> CacheSimResult:
    """Predict cycles / per-level misses for one loop permutation.

    ``threads`` parallelises the outermost loop (thesis §3.4): effective
    parallelism is capped by that loop's trip count, and permutations whose
    outermost loop does not index ``out`` pay an atomic-update cost per
    output write.
    """
    EVAL_COUNTS["simulate"] += 1
    trips = layer.trips()
    per_iter = ln.accesses_per_iteration(partial_sums)
    iters = layer.iterations

    accesses = sum(per_iter.values()) * iters
    out_writes = (ln.out_writes_with_partial_sums(layer, perm)
                  if partial_sums else 0)
    accesses += 2 * out_writes  # read+write per accumulator spill

    misses: Dict[str, float] = {}
    misses_by_array: Dict[str, Dict[str, float]] = {}
    ws: Dict[str, float] = {}
    for level in machine.levels:
        cap_blocks = level.size_bytes / level.block_bytes
        per_array = _fetches_per_level(layer, perm, cap_blocks,
                                       level.block_bytes)
        if partial_sums:
            # out[] traffic at block granularity: each spill run touches its
            # block once; bounded by one access per spill.
            blk_elems = level.block_bytes // layer.elem_bytes
            per_array["out"] = min(per_array["out"], float(out_writes))
            per_array["out"] = max(per_array["out"],
                                   layer.oc * layer.h * layer.w / blk_elems)
        misses_by_array[level.name] = per_array
        misses[level.name] = sum(per_array.values())
        ws[level.name] = cap_blocks

    # Cycle accounting exactly as thesis §2.3.1: every access costs the
    # latency of the level it hits in; plus 1 cycle per instruction.
    l1, l2 = machine.levels[0], machine.levels[1]
    m1, m2 = misses["L1"], misses["L2"]
    m2 = min(m2, m1)  # inclusive hierarchy sanity
    hits_l1 = max(accesses - m1, 0.0)
    hits_l2 = max(m1 - m2, 0.0)
    cycles = (iters * machine.instrs_per_iter * machine.cpi_compute
              + hits_l1 * l1.latency + hits_l2 * l2.latency
              + m2 * machine.mem_latency)

    if threads > 1:
        outer = LOOPS[perm[0]]
        par = min(threads, trips[outer])
        cycles = cycles / par
        if outer not in ln.OUTPUT_LOOPS:
            # Threads race on out[]: atomic per output update (§3.4).
            upd = out_writes if partial_sums else iters
            cycles += machine.atomic_cost * upd / max(par, 1)

    return CacheSimResult(cycles=cycles, accesses=accesses, misses=misses,
                          misses_by_array=misses_by_array,
                          working_set_blocks=ws)


def sweep_permutations(layer: ConvLayer,
                       machine: MachineModel = MachineModel(),
                       threads: int = 1,
                       perms: Optional[Sequence[Sequence[int]]] = None,
                       ) -> List[Tuple[Tuple[int, ...], CacheSimResult]]:
    """All-720 sweep (thesis Ch. 4 experimental setup)."""
    import itertools
    if perms is None:
        perms = list(itertools.permutations(range(6)))
    return [(tuple(p), simulate(layer, p, machine, threads)) for p in perms]


# ---------------------------------------------------------------------------
# Vectorized batch engine — the whole permutation space in one shot
# ---------------------------------------------------------------------------
#
# ``simulate_batch`` is the same recursive footprint model as ``simulate``,
# restructured as dense array computation: footprints collapse onto the 64
# inner-loop subsets (precomputed once per (layer, block size) in
# loopnest.footprint_block_table), permutations become an int [P, 6] array
# of loop ids plus an int [P, 7] array of per-depth subset masks, and the
# innermost→outermost recursion becomes six rounds of np.where over all P
# candidates at once.  Arithmetic is sequenced exactly like the scalar
# model (same operand order, same float64 ops), so results are
# bit-identical, not merely close — the equivalence property tests pin
# this down.

@dataclasses.dataclass
class BatchSimResult:
    """Per-permutation arrays for one layer: ``cycles[i]`` etc. correspond
    to ``perms[i]`` (row i of the [P, 6] loop-id array)."""
    layer: ConvLayer
    perms: np.ndarray                       # int64 [P, 6]
    cycles: np.ndarray                      # float64 [P]
    accesses: np.ndarray                    # float64 [P]
    misses: Dict[str, np.ndarray]           # level -> [P]
    misses_by_array: Dict[str, Dict[str, np.ndarray]]
    working_set_blocks: Dict[str, float]    # level -> capacity in blocks

    def __len__(self) -> int:
        """Number of scored candidates (rows of ``perms``)."""
        return self.perms.shape[0]

    def result(self, i: int) -> CacheSimResult:
        """Scalar view of candidate ``i`` (same shape as ``simulate``)."""
        return CacheSimResult(
            cycles=float(self.cycles[i]),
            accesses=float(self.accesses[i]),
            misses={lv: float(v[i]) for lv, v in self.misses.items()},
            misses_by_array={lv: {a: float(v[i]) for a, v in per.items()}
                             for lv, per in self.misses_by_array.items()},
            working_set_blocks=dict(self.working_set_blocks))

    def best(self) -> Tuple[Tuple[int, ...], CacheSimResult]:
        """(argmin permutation, its scalar result) over the batch."""
        i = int(np.argmin(self.cycles))
        return tuple(int(x) for x in self.perms[i]), self.result(i)


def _depth_footprints(layer: ConvLayer, masks: np.ndarray,
                      block_bytes: int):
    """Per-depth footprint gathers shared by every cache level with this
    block size: (subset tables, per-array [P, 7] footprints, their total).
    The total is summed in ARRAY_DIMS order like the scalar model (exact
    integers in float64 — comparisons identical)."""
    tabs = ln.footprint_block_table(layer, block_bytes)
    fp = {a: tabs[a][masks] for a in ln.ARRAY_DIMS}          # [P, 7] each
    total_fp = fp["out"] + fp["wgt"] + fp["img"]
    return tabs, fp, total_fp


def _fetches_per_level_batch(layer: ConvLayer, parr: np.ndarray,
                             depth_fp, capacity_blocks: float,
                             ) -> Dict[str, np.ndarray]:
    """Vectorized :func:`_fetches_per_level`: per-array block fetches for
    every permutation at once (float64 [P] per array).

    The scalar recursion walks depths innermost→outermost carrying one
    running fetch count; here the carry is a [P] array and each depth is a
    masked select between the three scalar branches (sub-nest fits /
    resident or halo-reused / evicted-and-multiplied).  ``depth_fp`` is a
    :func:`_depth_footprints` result, computed once per block size."""
    tabs, fp, total_fp = depth_fp
    trips = ln.trips_vector(layer).astype(np.float64)
    fits = total_fp <= capacity_blocks                       # bool [P, 7]

    n = parr.shape[1]
    fetches: Dict[str, np.ndarray] = {}
    for array in ln.ARRAY_DIMS:
        full_fp = float(tabs[array][ln.FULL_MASK])
        if full_fp <= capacity_blocks / 2:
            # Hot set: survives any streaming; compulsory misses only.
            fetches[array] = np.full(parr.shape[0], full_fp)
            continue
        indexes_tab = ln.ARRAY_LOOP_MASKS[array]
        f = np.ones(parr.shape[0])
        for d in range(n - 1, -1, -1):
            loop_ids = parr[:, d]
            fits_d = fits[:, d]
            inner_fits = fits[:, d + 1]
            indexes = indexes_tab[loop_ids]
            # Branches of the scalar recursion, as one masked select:
            #   fits_d                      -> one-pass distinct blocks
            #   inner_fits & indexes        -> halo reuse: distinct blocks
            #   inner_fits & ~indexes       -> resident: carry unchanged
            #   ~inner_fits                 -> evicted: multiply by trips
            f = np.where(fits_d | (inner_fits & indexes), fp[array][:, d],
                         np.where(inner_fits, f, f * trips[loop_ids]))
        fetches[array] = f
    return fetches


def simulate_batch(layer: ConvLayer, perms: Sequence[Sequence[int]],
                   machine: MachineModel = MachineModel(),
                   threads: int = 1,
                   partial_sums: bool = True) -> BatchSimResult:
    """Score every permutation in ``perms`` with one array computation.

    Semantically ``[simulate(layer, p, machine, threads) for p in perms]``
    but ~2 orders of magnitude faster for the full 720-candidate space:
    the footprint recursion runs once over dense arrays instead of once
    per permutation in Python.  Results are bit-identical to the scalar
    path, so ranks, argmins and registry contents are unchanged.
    """
    parr = ln.perms_array(perms)
    EVAL_COUNTS["simulate_batch"] += parr.shape[0]
    masks = ln.perm_inner_masks(parr)
    trips_i = ln.trips_vector(layer)
    iters = layer.iterations

    per_iter = ln.accesses_per_iteration(partial_sums)
    out_writes = (ln.out_writes_with_partial_sums_batch(layer, parr)
                  if partial_sums else np.zeros(parr.shape[0], np.int64))
    accesses = sum(per_iter.values()) * iters + 2 * out_writes

    misses: Dict[str, np.ndarray] = {}
    misses_by_array: Dict[str, Dict[str, np.ndarray]] = {}
    ws: Dict[str, float] = {}
    depth_fp_cache: Dict[int, tuple] = {}  # levels usually share 32 B blocks
    for level in machine.levels:
        cap_blocks = level.size_bytes / level.block_bytes
        if level.block_bytes not in depth_fp_cache:
            depth_fp_cache[level.block_bytes] = _depth_footprints(
                layer, masks, level.block_bytes)
        per_array = _fetches_per_level_batch(
            layer, parr, depth_fp_cache[level.block_bytes], cap_blocks)
        if partial_sums:
            blk_elems = level.block_bytes // layer.elem_bytes
            per_array["out"] = np.minimum(per_array["out"],
                                          out_writes.astype(np.float64))
            per_array["out"] = np.maximum(
                per_array["out"], layer.oc * layer.h * layer.w / blk_elems)
        misses_by_array[level.name] = per_array
        misses[level.name] = (per_array["out"] + per_array["wgt"]
                              + per_array["img"])
        ws[level.name] = cap_blocks

    l1, l2 = machine.levels[0], machine.levels[1]
    m1 = misses["L1"]
    m2 = np.minimum(misses["L2"], m1)  # inclusive hierarchy sanity
    hits_l1 = np.maximum(accesses - m1, 0.0)
    hits_l2 = np.maximum(m1 - m2, 0.0)
    cycles = (iters * machine.instrs_per_iter * machine.cpi_compute
              + hits_l1 * l1.latency + hits_l2 * l2.latency
              + m2 * machine.mem_latency)

    if threads > 1:
        outer_ids = parr[:, 0]
        par = np.minimum(threads, trips_i[outer_ids])
        cycles = cycles / par
        # Threads race on out[] when the outermost loop does not index it:
        # atomic per output update (§3.4).
        upd = out_writes if partial_sums else np.full(parr.shape[0], iters)
        atomic = machine.atomic_cost * upd / np.maximum(par, 1)
        cycles = np.where(ln.OUTPUT_MASK[outer_ids], cycles,
                          cycles + atomic)

    return BatchSimResult(layer=layer, perms=parr, cycles=cycles,
                          accesses=accesses.astype(np.float64),
                          misses=misses, misses_by_array=misses_by_array,
                          working_set_blocks=ws)


__all__ = ["LOKI_MODEL_VERSION", "EVAL_COUNTS", "CacheLevel", "MachineModel",
           "HIERARCHIES", "CacheSimResult", "simulate", "sweep_permutations",
           "BatchSimResult", "simulate_batch"]
