"""Design-space search (thesis Ch. 4-5) and the offline schedule search
for the port's kernels on the H100.

The thesis side is the JAX package's (``repro.core.tuner``), copied: sweep
the 720 loop permutations with the Loki model, derive *static candidates*
(Fig 4.7/4.8), *top pairs* (Fig 5.3), *random-sampling bounds* (Fig 5.4),
and search the permutohedron by neighbour swaps or best-first (§7.2); the
three-tier :func:`ecm_sweep` (batch roofline, the ECM layer conditions,
exact traces where they disagree); and :func:`warm_registry`, which fills
a registry with ``conv_sweep`` (Loki) and ``conv_schedule`` (H100)
records.  Its sweeps, searches and evaluation counts equal the JAX
package's.  The exact traces are the one pooled step
(:func:`exact_sweep`): its workers start by forkserver or spawn, never
fork (the parent may hold a CUDA context, which a forked child inherits
broken), and import numpy and the Loki model only
(:func:`repro_torch.core.tracesim.exact_cycles`), never torch.

The H100 side:

The tuner enumerates the schedule space of each kernel (grid order x
block shapes, plus the resident RHS for matmul), scores the whole
enumeration with one batch call of the H100 cost model and ranks it.
The block candidates are the port's own, sized for a Hopper block
rather than the TPU's MXU and for the body the dtype runs: float32
(CUDA cores) channels around 16-128, pixels around 4-16 or the full
extent, matmul tiles around 32-128 and k chunks around 16-64 or the
whole k; bf16 (tensor cores) also channels up to 256, pixel tiles up to
28 a side (64-256 pixels fill the MMA's 16-row steps with little
padding), matmul rows of 64 or 128 (one or two warpgroups) and columns
of 16-256 (the wgmma widths).  Blocks always divide their dimensions,
and only schedules the CUDA kernels accept (``kernels/_geometry.py``,
the layout of the dtype's body) are ever returned, so a ranked
schedule never raises on the card.

The serving kernels offer only what their bodies take (``_geometry``'s
``error`` is None), by the problem's element size: flash bf16 64 or 128
query rows at the 64-key tile, float32 its single 64 x 32 tile; the
split decode ``block_kv`` (keys a block) in DECODE_SPLITS up
to the cache length, plus the split ``decode_plan`` picks by itself; the
scan ``block_d`` in SCAN_BLOCK_DS.

``cached_tune_*`` and :func:`cached_sweep_layer` put the ranking behind
the port's tuning registry: a warm hit performs zero cost-model
evaluations.  Each lookup counts on
the process metrics registry (``tune.warm_hits_total``,
``tune.sweeps_total``, ``tune.sweep_wall_s_total``,
``tune.cost_model_evals_total``, the JAX package's names).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core import ecm as ecm_model
from repro_torch.core import permutations as perms
from repro_torch.core import registry as reg
from repro_torch.core import tracesim
from repro_torch.core.loopnest import ConvLayer
from repro_torch.core.schedule import (ConvSchedule, DecodeAttentionSchedule,
                                       FlashAttentionSchedule,
                                       MatmulSchedule, SSMScanSchedule,
                                       SparseConvSchedule)
from repro_torch.kernels import _geometry as geo
from repro_torch.obs.metrics import get_metrics_registry

Perm = Tuple[int, ...]
ALL_PERMS: Tuple[Perm, ...] = tuple(itertools.permutations(range(6)))

CONV_CHANNEL_TARGETS = (16, 32, 64, 128)
CONV_PIXEL_TARGETS = (4, 8, 16)
MATMUL_TILE_TARGETS = (32, 64, 128)
MATMUL_K_TARGETS = (16, 32, 64)
# bf16, the tensor-core bodies
CONV_MMA_CHANNEL_TARGETS = (16, 32, 64, 128, 256)
CONV_MMA_PIXEL_TARGETS = (4, 8, 16, 28)
MATMUL_MMA_ROW_TARGETS = (64, 128)
MATMUL_MMA_COL_TARGETS = (16, 32, 64, 128, 192, 256)
# the serving kernels
DECODE_SPLITS = (32, 64, 128, 256, 512)
SCAN_BLOCK_DS = (32, 64, 128, 256)


# ---------------------------------------------------------------------------
# Sweeps and signatures (thesis Ch. 4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    """720-permutation sweep of one layer: the thesis' 'signature'."""
    layer: ConvLayer
    cycles: np.ndarray      # [720], indexed by lex order (ALL_PERMS)
    l1_misses: np.ndarray
    l2_misses: np.ndarray

    def signature(self, metric: str = "cycles",
                  indexing: str = "hamiltonian") -> np.ndarray:
        """Metric reordered by an indexing function (Fig 4.2)."""
        vals = {"cycles": self.cycles, "l1": self.l1_misses,
                "l2": self.l2_misses}[metric]
        order = np.empty(len(ALL_PERMS), dtype=np.int64)
        for i, p in enumerate(ALL_PERMS):
            if indexing == "hamiltonian":
                order[perms.hamiltonian_index(p)] = i
            elif indexing == "lex":
                order[perms.lex_index(p)] = i
            elif indexing == "revlex":
                order[perms.revlex_index(p)] = i
            else:
                raise ValueError(indexing)
        return vals[order]


def sweep_layer(layer: ConvLayer,
                machine: cm.MachineModel = cm.MachineModel(),
                threads: int = 1) -> SweepResult:
    """All-720 signature through the vectorized batch engine: one
    :func:`repro_torch.core.cost_model.simulate_batch` call scores the whole
    permutation space (bit-identical to per-perm ``simulate`` calls)."""
    batch = cm.simulate_batch(layer, ALL_PERMS, machine, threads)
    l1 = machine.levels[0].name
    l2 = machine.levels[1].name
    return SweepResult(layer=layer, cycles=batch.cycles,
                       l1_misses=batch.misses[l1],
                       l2_misses=batch.misses[l2])


def batch_perm_scorer(layer: ConvLayer,
                      machine: cm.MachineModel = cm.MachineModel(),
                      threads: int = 1,
                      ) -> Callable[[Sequence[Perm]], np.ndarray]:
    """A many-perms-at-once cycles scorer for the permutohedron searches:
    ``scorer(perms) -> float64 [len(perms)]``."""
    def score_batch(candidates: Sequence[Perm]) -> np.ndarray:
        """Cycles for each candidate via one simulate_batch call."""
        return cm.simulate_batch(layer, list(candidates), machine,
                                 threads).cycles
    return score_batch


def speedup_matrix(sweeps: Sequence[SweepResult],
                   metric: str = "cycles") -> np.ndarray:
    """S[l, p] = best(layer l) / metric(layer l, perm p)  (in (0, 1];
    1 = per-layer optimal).  The thesis' normalised 'speedup' measure."""
    rows = []
    for s in sweeps:
        v = s.cycles if metric == "cycles" else (
            s.l2_misses if metric == "l2" else s.l1_misses)
        v = np.maximum(v, 1e-12)
        rows.append(v.min() / v)
    return np.stack(rows)


# ---------------------------------------------------------------------------
# Static candidates (thesis §4.3, Fig 4.7/4.8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """A static permutation candidate with its design-space speedups."""

    perm: Perm
    avg_speedup: float
    worst_speedup: float
    criterion: str


def static_candidates(sweeps: Sequence[SweepResult]) -> Dict[str, Candidate]:
    """The thesis' three candidates: top average (cycles), top worst-case
    (cycles), top average (L2 misses)."""
    s_cyc = speedup_matrix(sweeps, "cycles")
    s_l2 = speedup_matrix(sweeps, "l2")
    out: Dict[str, Candidate] = {}

    avg = s_cyc.mean(axis=0)
    p = int(avg.argmax())
    out["top_average"] = Candidate(ALL_PERMS[p], float(avg[p]),
                                   float(s_cyc[:, p].min()), "cycles/avg")
    worst = s_cyc.min(axis=0)
    p = int(worst.argmax())
    out["top_worst_case"] = Candidate(ALL_PERMS[p], float(avg[p]),
                                      float(worst[p]), "cycles/worst")
    avg2 = s_l2.mean(axis=0)
    p = int(avg2.argmax())
    out["top_l2"] = Candidate(ALL_PERMS[p], float(s_cyc[:, p].mean()),
                              float(s_cyc[:, p].min()), "l2/avg")
    return out


# ---------------------------------------------------------------------------
# Top-K combinations (thesis §5.3.1, Fig 5.3)
# ---------------------------------------------------------------------------

def top_pairs(sweeps: Sequence[SweepResult], metric: str = "cycles",
              n_best: int = 5) -> List[Tuple[Perm, Perm, float, float]]:
    """Best pairs of permutations when, per layer, the better of the two is
    used (the micro-profiling pick).  Exact over all 720*719/2 pairs,
    vectorised.  Returns (perm_a, perm_b, avg_speedup, worst_speedup)."""
    S = speedup_matrix(sweeps, metric)            # [L, P]
    P = S.shape[1]
    best: List[Tuple[float, float, int, int]] = []
    for i in range(P):
        pair = np.maximum(S[:, i:i + 1], S)       # [L, P]
        avg = pair.mean(axis=0)
        avg[:i + 1] = -1.0                        # dedupe (j > i only)
        j = int(avg.argmax())
        worst = float(pair[:, j].min())
        best.append((float(avg[j]), worst, i, j))
    best.sort(reverse=True)
    return [(ALL_PERMS[i], ALL_PERMS[j], a, w) for a, w, i, j in
            best[:n_best]]


# ---------------------------------------------------------------------------
# Random sampling (thesis §5.3.2, Fig 5.4)
# ---------------------------------------------------------------------------

def sample_size_for_confidence(sweeps: Sequence[SweepResult],
                               good_threshold: float = 0.9,
                               confidence: float = 0.683,
                               metric: str = "cycles") -> int:
    """Smallest random-sample size k such that, for the *worst* layer of
    the design space, a sample of k permutations contains a >=threshold
    one with the given probability (thesis: 10 for 1 sigma, 26 for 2)."""
    S = speedup_matrix(sweeps, metric)
    n = S.shape[1]
    g_min = int((S >= good_threshold).sum(axis=1).min())
    if g_min == 0:
        return n
    for k in range(1, n + 1):
        # P(no good in k draws without replacement)
        p_none = math.prod((n - g_min - t) / (n - t) for t in range(k)
                           if n - g_min - t > 0) if k <= n - g_min else 0.0
        if 1.0 - p_none >= confidence:
            return k
    return n


def good_permutation_counts(sweeps: Sequence[SweepResult],
                            good_threshold: float = 0.9,
                            metric: str = "cycles") -> np.ndarray:
    """Per-layer count of >=threshold permutations (Fig 5.4 input)."""
    S = speedup_matrix(sweeps, metric)
    return (S >= good_threshold).sum(axis=1)


# ---------------------------------------------------------------------------
# Locality-aware search on the permutohedron (thesis §7.2 future work)
# ---------------------------------------------------------------------------

def _score_perms(score: Optional[Callable[[Perm], float]],
                 score_batch: Optional[Callable[[Sequence[Perm]],
                                                np.ndarray]],
                 candidates: Sequence[Perm]) -> List[float]:
    """Score candidates via the batch scorer when given, else per-perm."""
    if not candidates:
        return []
    if score_batch is not None:
        return [float(v) for v in score_batch(list(candidates))]
    return [score(p) for p in candidates]


def neighbor_swap_search(score: Optional[Callable[[Perm], float]],
                         start: Perm,
                         max_steps: int = 100,
                         score_batch: Optional[
                             Callable[[Sequence[Perm]], np.ndarray]] = None,
                         ) -> Tuple[Perm, float, int]:
    """Greedy descent over adjacent-transposition neighbours.  ``score`` is
    minimised (e.g. predicted cycles).  Returns (perm, score, evals).

    With ``score_batch`` (e.g. :func:`batch_perm_scorer`) each descent
    step scores its whole neighbourhood in one vectorized call; ``score``
    may then be None."""
    cur = tuple(start)
    cur_score = _score_perms(score, score_batch, [cur])[0]
    evals = 1
    for _ in range(max_steps):
        nbrs = perms.permutohedron_neighbors(cur)
        vals = _score_perms(score, score_batch, nbrs)
        evals += len(nbrs)
        best_i = min(range(len(nbrs)), key=vals.__getitem__)
        if vals[best_i] >= cur_score:
            return cur, cur_score, evals
        cur, cur_score = nbrs[best_i], vals[best_i]
    return cur, cur_score, evals


def bfs_search(score: Optional[Callable[[Perm], float]], start: Perm,
               budget: int = 60,
               score_batch: Optional[
                   Callable[[Sequence[Perm]], np.ndarray]] = None,
               ) -> Tuple[Perm, float, int]:
    """Best-first search on the permutohedron with an evaluation budget
    (the thesis' suggested BFS variant).  ``score_batch`` scores each
    expansion's unseen neighbours in one call."""
    import heapq
    start = tuple(start)
    seen = {start}
    s0 = _score_perms(score, score_batch, [start])[0]
    heap = [(s0, start)]
    best = (s0, start)
    evals = 1
    while heap and evals < budget:
        s, p = heapq.heappop(heap)
        fresh = [q for q in perms.permutohedron_neighbors(p)
                 if q not in seen][:max(budget - evals, 0)]
        seen.update(fresh)
        for q, sq in zip(fresh, _score_perms(score, score_batch, fresh)):
            evals += 1
            if sq < best[0]:
                best = (sq, q)
            heapq.heappush(heap, (sq, q))
    return best[1], best[0], evals



# ---------------------------------------------------------------------------
# H100 schedule tuning
# ---------------------------------------------------------------------------

def _divisors(n: int, cap: int = 1 << 30) -> List[int]:
    """All divisors of ``n`` up to ``cap``."""
    return [d for d in range(1, min(n, cap) + 1) if n % d == 0]


def _block_candidates(dim: int, targets: Sequence[int]) -> List[int]:
    """Divisors of ``dim`` closest below each target."""
    divs = _divisors(dim)
    return sorted({max(d for d in divs if d <= t) for t in targets if t >= 1})


def conv_blocks(layer: ConvLayer, elem_bytes: int) -> List[Dict[str, int]]:
    """The conv block candidates the dtype's kernel accepts for
    ``layer``."""
    mma = geo.tensor_cores(elem_bytes)
    ch = CONV_MMA_CHANNEL_TARGETS if mma else CONV_CHANNEL_TARGETS
    px = CONV_MMA_PIXEL_TARGETS if mma else CONV_PIXEL_TARGETS
    oc_c = _block_candidates(layer.oc, ch)
    ic_c = _block_candidates(layer.ic, ch)
    y_c = _block_candidates(layer.h, px + (layer.h,))
    x_c = _block_candidates(layer.w, px + (layer.w,))
    blocks = [{"oc": o, "ic": i, "y": y, "x": x}
              for o, i, y, x in itertools.product(oc_c, ic_c, y_c, x_c)]
    return [b for b in blocks
            if geo.conv_layout(b["oc"], b["ic"], b["y"], b["x"], layer.kh,
                               layer.kw, elem_bytes).error is None]


def _top(times: np.ndarray, feasible: np.ndarray, top_k: int) -> List[int]:
    """Flat indices of the ``top_k`` cheapest feasible candidates (a
    stable sort, so ties keep enumeration order)."""
    flat = np.where(feasible.reshape(-1), times.reshape(-1), np.inf)
    order = np.argsort(flat, kind="stable")
    return [int(i) for i in order[:top_k] if np.isfinite(flat[i])]


def tune_conv(layer: ConvLayer, spec: cm.H100Spec = cm.H100Spec(),
              elem_bytes: int = 2, top_k: int = 5, batch: int = 1,
              ) -> List[Tuple[ConvSchedule, cm.KernelCost]]:
    """Rank (grid order x block shape) conv schedules by the H100 model
    for ``batch`` images with one ``conv_schedule_cost_batch`` call (the
    tensor-core body's best tile differs between one image and a
    batch: few images want many small tiles, many want large ones)."""
    orders = list(itertools.permutations(("oc", "ic", "y", "x")))
    blocks = conv_blocks(layer, elem_bytes)
    scored = cm.conv_schedule_cost_batch(layer, orders, blocks, spec,
                                         elem_bytes, batch)
    n_b = len(blocks)
    return [(ConvSchedule.make(orders[i // n_b], blocks[i % n_b]),
             scored.cost((i // n_b, i % n_b)))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def matmul_blocks(m: int, n: int, k: int, elem_bytes: int = 2
                  ) -> List[Tuple[int, int, int]]:
    """The matmul (bm, bn, bk) candidates for the dtype's kernel
    (feasibility also depends on the resident switch, so it is applied
    on the scores)."""
    mma = geo.tensor_cores(elem_bytes)
    m_c = _block_candidates(m, MATMUL_MMA_ROW_TARGETS if mma
                            else MATMUL_TILE_TARGETS)
    n_c = _block_candidates(n, MATMUL_MMA_COL_TARGETS if mma
                            else MATMUL_TILE_TARGETS)
    k_c = _block_candidates(k, MATMUL_K_TARGETS + (k,))
    return list(itertools.product(m_c, n_c, k_c))


def tune_matmul(m: int, n: int, k: int, spec: cm.H100Spec = cm.H100Spec(),
                elem_bytes: int = 2, top_k: int = 5,
                ) -> List[Tuple[MatmulSchedule, cm.KernelCost]]:
    """Rank matmul schedules: 6 grid orders x blocks x resident RHS, with
    one ``matmul_schedule_cost_batch`` call."""
    orders = list(itertools.permutations(("m", "n", "k")))
    blocks = matmul_blocks(m, n, k, elem_bytes)
    batch = cm.matmul_schedule_cost_batch(m, n, k, blocks, orders, spec,
                                          elem_bytes)
    n_b = len(blocks)
    out: List[Tuple[MatmulSchedule, cm.KernelCost]] = []
    for i in _top(batch.time_s, batch.feasible, top_k):
        o, rem = divmod(i, n_b * 2)
        b, resident = divmod(rem, 2)
        bm, bn, bk = blocks[b]
        sched = MatmulSchedule.make(orders[o], {"m": bm, "n": bn, "k": bk},
                                    bool(resident))
        out.append((sched, batch.cost((o, b, resident))))
    return out


def sparse_blocks(layer: ConvLayer, elem_bytes: int) -> List[Dict[str, int]]:
    """The (oc, ic) skip-block candidates the sparse kernel of the dtype
    accepts: bf16 those with a pixel tile that fits the tensor-core
    layout (``sparsity.sparse_pixel_tile``: whether one fits does not
    depend on the batch), float32 those whose CUDA-core tile fits."""
    from repro_torch.core.sparsity import sparse_pixel_tile
    oc_c = _block_candidates(layer.oc, CONV_CHANNEL_TARGETS)
    ic_c = _block_candidates(layer.ic, CONV_CHANNEL_TARGETS)
    if geo.tensor_cores(elem_bytes):
        return [{"oc": o, "ic": i} for o, i in itertools.product(oc_c, ic_c)
                if sparse_pixel_tile(layer, o, i) is not None]
    by, bx = geo.sparse_tile(layer.h, layer.w)
    return [{"oc": o, "ic": i} for o, i in itertools.product(oc_c, ic_c)
            if geo.conv_tile(o, i, by, bx, layer.kh, layer.kw,
                             elem_bytes).error is None]


def tune_sparse_conv(layer: ConvLayer, density: float = 1.0,
                     spec: cm.H100Spec = cm.H100Spec(),
                     elem_bytes: int = 2, top_k: int = 5, batch: int = 1,
                     ) -> List[Tuple[SparseConvSchedule, cm.KernelCost]]:
    """Rank (oc, ic) skip blocks for the block-sparse conv kernel at a
    given block density for ``batch`` images (the bf16 body's pixel tile,
    and so its best skip block, depends on the batch)."""
    blocks = sparse_blocks(layer, elem_bytes)
    scored = cm.sparse_conv_schedule_cost_batch(layer, blocks, density,
                                                batch, spec, elem_bytes)
    return [(SparseConvSchedule.make(blocks[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def flash_attention_tiles(d: int, elem_bytes: int = 2
                          ) -> List[Tuple[int, int]]:
    """The (block_q, block_kv) tiles the flash body of the dtype takes at
    head dim ``d``: bf16 every row choice at the key tile, float32 its
    one tile."""
    if geo.tensor_cores(elem_bytes):
        tiles = [(r, geo.FLASH_KEYS) for r in geo.FLASH_ROW_CHOICES]
    else:
        tiles = [geo.FLASH_F32_TILE]
    return [t for t in tiles
            if geo.flash_tile_error(d, elem_bytes, *t) is None]


def tune_flash_attention(b: int, hq: int, hkv: int, s: int, d: int,
                         causal: bool = True,
                         spec: cm.H100Spec = cm.H100Spec(),
                         elem_bytes: int = 2, top_k: int = 5,
                         ) -> List[Tuple[FlashAttentionSchedule,
                                         cm.KernelCost]]:
    """Rank the flash tiles with one
    ``flash_attention_schedule_cost_batch`` call."""
    tiles = flash_attention_tiles(d, elem_bytes)
    scored = cm.flash_attention_schedule_cost_batch(
        b, hq, hkv, s, d, tiles, causal, spec, elem_bytes)
    return [(FlashAttentionSchedule(*tiles[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def decode_splits(b: int, hq: int, hkv: int, s: int, d: int,
                  elem_bytes: int = 2) -> List[int]:
    """The splits (``block_kv``) the contiguous split decode takes over a
    cache of ``s`` keys: the plan's own first, then DECODE_SPLITS up to
    ``s``, each once and only where ``decode_plan`` raises no error."""
    own = geo.decode_plan(b, hq, hkv, d, s, 0, elem_bytes).split_keys
    out: List[int] = []
    for k in (own,) + tuple(x for x in DECODE_SPLITS if x <= s):
        if k not in out and geo.decode_plan(b, hq, hkv, d, s, 0, elem_bytes,
                                            k).error is None:
            out.append(k)
    return out


def tune_decode_attention(b: int, hq: int, hkv: int, s: int, d: int,
                          spec: cm.H100Spec = cm.H100Spec(),
                          elem_bytes: int = 2, top_k: int = 5,
                          ) -> List[Tuple[DecodeAttentionSchedule,
                                          cm.KernelCost]]:
    """Rank decode splits with one ``decode_attention_schedule_cost_batch``
    call (ties keep the plan's own split first)."""
    splits = decode_splits(b, hq, hkv, s, d, elem_bytes)
    scored = cm.decode_attention_schedule_cost_batch(b, hq, hkv, s, d,
                                                     splits, spec,
                                                     elem_bytes)
    return [(DecodeAttentionSchedule(splits[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def scan_blocks(n: int, elem_bytes: int = 2) -> List[int]:
    """The ``block_d`` values of SCAN_BLOCK_DS the scan takes for state
    size ``n``."""
    return [bd for bd in SCAN_BLOCK_DS
            if geo.scan_layout(bd, n, elem_bytes).error is None]


def tune_ssm_scan(bt: int, seq: int, di: int, n: int,
                  spec: cm.H100Spec = cm.H100Spec(),
                  elem_bytes: int = 2, top_k: int = 5,
                  ) -> List[Tuple[SSMScanSchedule, cm.KernelCost]]:
    """Rank channel blocks with one ``ssm_scan_schedule_cost_batch``
    call."""
    blocks = scan_blocks(n, elem_bytes)
    scored = cm.ssm_scan_schedule_cost_batch(bt, seq, di, n, blocks, spec,
                                             elem_bytes)
    return [(SSMScanSchedule(blocks[i]), scored.cost(i))
            for i in _top(scored.time_s, scored.feasible, top_k)]


def _tune_counter(name: str):
    """A counter of the offline tuner on the process metrics registry."""
    return get_metrics_registry().counter(
        name, help="offline-tuner sweep accounting")


def _ranked_to_value(ranked) -> Dict:
    """Registry value for a ranked (schedule, cost) list."""
    return {"schedules": [reg.schedule_to_dict(s) for s, _ in ranked],
            "costs": [reg.cost_to_dict(c) for _, c in ranked],
            "tier": "roofline"}


def _has_ranked(value: Dict, top_k: int) -> bool:
    """A record answers a top_k request when it holds that many ranked
    pairs, or the whole (smaller) enumeration; a record made only by an
    online write-back holds no costs and must re-tune."""
    n = min(len(value.get("schedules", ())), len(value.get("costs", ())))
    if value.get("complete") and n > 0:
        return True
    return n >= top_k


def _value_to_ranked(value: Dict, top_k: Optional[int] = None):
    """Rebuild the ranked (schedule, cost) list from a registry value."""
    pairs = zip(value["schedules"][:top_k], value["costs"][:top_k])
    return [(reg.schedule_from_dict(s), reg.cost_from_dict(c))
            for s, c in pairs]


def _cached_ranked(key: reg.RegistryKey, tune: Callable[[int], List],
                   top_k: int, registry: Optional[reg.TuningRegistry],
                   refresh: bool) -> List:
    """Return the stored ranking on a warm hit (zero cost-model
    evaluations); otherwise run ``tune`` once and persist it, keeping
    any measurement already attached to the key."""
    registry = registry if registry is not None else \
        reg.TuningRegistry.default()
    prev = registry.get(key)
    rec = None if refresh else prev
    if rec is not None and _has_ranked(rec.value, top_k):
        _tune_counter("tune.warm_hits_total").inc()
        return _value_to_ranked(rec.value, top_k)
    want = max(top_k, 5)
    evals0 = cm.total_evals()
    t0 = time.perf_counter()
    ranked = tune(want)
    _tune_counter("tune.sweeps_total").inc()
    _tune_counter("tune.sweep_wall_s_total").inc(time.perf_counter() - t0)
    _tune_counter("tune.cost_model_evals_total").inc(
        cm.total_evals() - evals0)
    if not ranked:
        raise ValueError(f"no schedule of {key.kind} {key.problem_dict()} "
                         f"fits the kernel")
    value = _ranked_to_value(ranked)
    if len(ranked) < want:
        value["complete"] = True      # the whole feasible enumeration
    registry.put(reg.TuningRecord(key=key, value=value,
                                  measured=prev.measured if prev else None,
                                  source="offline"))
    return ranked[:top_k]


def cached_tune_conv(layer: ConvLayer, spec: cm.H100Spec = cm.H100Spec(),
                     elem_bytes: int = 2, top_k: int = 5,
                     registry: Optional[reg.TuningRegistry] = None,
                     refresh: bool = False, machine: Optional[str] = None,
                     batch: int = 1,
                     ) -> List[Tuple[ConvSchedule, cm.KernelCost]]:
    """:func:`tune_conv` behind the registry (the key holds the batch);
    ``machine`` overrides the key's machine part (the dispatch service
    passes spec + runtime)."""
    return _cached_ranked(
        reg.conv_schedule_key(layer, machine or spec, elem_bytes, batch),
        lambda k: tune_conv(layer, spec, elem_bytes, top_k=k, batch=batch),
        top_k, registry, refresh)


def cached_tune_matmul(m: int, n: int, k: int,
                       spec: cm.H100Spec = cm.H100Spec(),
                       elem_bytes: int = 2, top_k: int = 5,
                       registry: Optional[reg.TuningRegistry] = None,
                       refresh: bool = False, machine: Optional[str] = None,
                       ) -> List[Tuple[MatmulSchedule, cm.KernelCost]]:
    """:func:`tune_matmul` behind the registry."""
    return _cached_ranked(
        reg.matmul_schedule_key(m, n, k, machine or spec, elem_bytes),
        lambda kk: tune_matmul(m, n, k, spec, elem_bytes, top_k=kk),
        top_k, registry, refresh)


def cached_tune_sparse_conv(
        layer: ConvLayer, density: float = 1.0,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        batch: int = 1,
        ) -> List[Tuple[SparseConvSchedule, cm.KernelCost]]:
    """:func:`tune_sparse_conv` behind the registry (density quantised to
    the registry's 1/16 grid, so the key space stays finite; the key
    holds the batch)."""
    density_q = reg.quantize_density(density) / 16.0
    return _cached_ranked(
        reg.sparse_conv_schedule_key(layer, density, machine or spec,
                                     elem_bytes, batch),
        lambda k: tune_sparse_conv(layer, density_q, spec, elem_bytes,
                                   top_k=k, batch=batch),
        top_k, registry, refresh)


def cached_tune_flash_attention(
        b: int, hq: int, hkv: int, s: int, d: int, causal: bool = True,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        ) -> List[Tuple[FlashAttentionSchedule, cm.KernelCost]]:
    """:func:`tune_flash_attention` behind the registry."""
    return _cached_ranked(
        reg.flash_attention_schedule_key(b, hq, hkv, s, d, machine or spec,
                                         causal, elem_bytes),
        lambda k: tune_flash_attention(b, hq, hkv, s, d, causal, spec,
                                       elem_bytes, top_k=k),
        top_k, registry, refresh)


def cached_tune_decode_attention(
        b: int, hq: int, hkv: int, s: int, d: int,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        ) -> List[Tuple[DecodeAttentionSchedule, cm.KernelCost]]:
    """:func:`tune_decode_attention` behind the registry."""
    return _cached_ranked(
        reg.decode_attention_schedule_key(b, hq, hkv, s, d, machine or spec,
                                          elem_bytes),
        lambda k: tune_decode_attention(b, hq, hkv, s, d, spec, elem_bytes,
                                        top_k=k),
        top_k, registry, refresh)


def cached_tune_ssm_scan(
        bt: int, seq: int, di: int, n: int,
        spec: cm.H100Spec = cm.H100Spec(), elem_bytes: int = 2,
        top_k: int = 5, registry: Optional[reg.TuningRegistry] = None,
        refresh: bool = False, machine: Optional[str] = None,
        ) -> List[Tuple[SSMScanSchedule, cm.KernelCost]]:
    """:func:`tune_ssm_scan` behind the registry."""
    return _cached_ranked(
        reg.ssm_scan_schedule_key(bt, seq, di, n, machine or spec,
                                  elem_bytes),
        lambda k: tune_ssm_scan(bt, seq, di, n, spec, elem_bytes, top_k=k),
        top_k, registry, refresh)


def cached_sweep_layer(layer: ConvLayer,
                       machine: cm.MachineModel = cm.MachineModel(),
                       threads: int = 1,
                       registry: Optional[reg.TuningRegistry] = None,
                       refresh: bool = False) -> SweepResult:
    """:func:`sweep_layer` (the 720-permutation signature) memoised."""
    registry = registry if registry is not None else \
        reg.TuningRegistry.default()
    key = reg.conv_sweep_key(layer, machine, threads)
    rec = None if refresh else registry.get(key)
    if rec is not None:
        _tune_counter("tune.warm_hits_total").inc()
        v = rec.value
        return SweepResult(layer=layer,
                           cycles=np.asarray(v["cycles"]),
                           l1_misses=np.asarray(v["l1_misses"]),
                           l2_misses=np.asarray(v["l2_misses"]))
    sweep = sweep_layer(layer, machine, threads)
    registry.put(reg.TuningRecord(
        key=key,
        value={"cycles": sweep.cycles.tolist(),
               "l1_misses": sweep.l1_misses.tolist(),
               "l2_misses": sweep.l2_misses.tolist()},
        source="offline"))
    return sweep


# ---------------------------------------------------------------------------
# Multi-layer sweeps + the exact-validator pool
# ---------------------------------------------------------------------------
#
# Since the batch engine, a full 720-permutation sweep is a sub-millisecond
# array computation, so multi-layer warms run in-process: no pickling, no
# worker startup, and determinism for free (the old guarantee — parallel
# warm byte-identical to serial — now holds trivially).  The
# forkserver/spawn process pool survives only as ``exact_sweep``'s engine:
# the trace-driven validator (core/tracesim) really does cost seconds per
# permutation and still wants the fan-out.

def _map_parallel(fn, jobs: Sequence, workers: Optional[int]) -> List:
    """Map ``fn`` over ``jobs`` preserving order.  ``workers`` None/0/1 =>
    serial; otherwise a process pool (tracesim is pure Python, so threads
    gain nothing under the GIL), degrading gracefully to threads then
    serial where the platform forbids subprocesses.

    Uses a forkserver/spawn start method, never plain fork: the parent
    may hold a CUDA context (a forked child inherits it broken) and
    torch's threads (forking a multithreaded process can deadlock)."""
    if not workers or workers <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    import multiprocessing as mp
    methods = mp.get_all_start_methods()
    method = "forkserver" if "forkserver" in methods else "spawn"
    try:
        ctx = mp.get_context(method)
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=ctx) as ex:
            return list(ex.map(fn, jobs))
    except (OSError, PermissionError, concurrent.futures.process
            .BrokenProcessPool):
        try:
            with concurrent.futures.ThreadPoolExecutor(workers) as ex:
                return list(ex.map(fn, jobs))
        except OSError:
            return [fn(j) for j in jobs]


def exact_sweep(layer: ConvLayer,
                sample: Sequence[Perm],
                machine: cm.MachineModel = cm.MachineModel(),
                workers: Optional[int] = None,
                max_iters: Optional[int] = None) -> np.ndarray:
    """Exact trace-driven cycles for a permutation sample — the validator
    for the analytic batch engine, and the one remaining consumer of the
    worker pool (a trace costs seconds; the analytic batch costs
    microseconds).  ``max_iters`` truncates each trace like the thesis'
    instruction caps (§4.3.2), keeping consultations on big layers
    bounded."""
    jobs = [(layer, tuple(p), machine, max_iters) for p in sample]
    return np.asarray(_map_parallel(tracesim.exact_cycles, jobs, workers))


@dataclasses.dataclass
class ECMSweepResult:
    """Outcome of the three-tier sweep over ``L`` layers x ``P`` perms.

    ``tiers[l]`` records which tier decided layer ``l``'s winner:
    ``"ecm"`` when roofline and ECM agreed within tolerance on the
    short-list, ``"exact"`` when tracesim arbitrated.  ``consulted[l]``
    holds the permutation indices actually sent to tracesim (empty when
    the exact tier never fired).
    """

    layers: Tuple[ConvLayer, ...]
    perms: Tuple[Perm, ...]
    roofline_cycles: np.ndarray            # float64 [L, P]
    ecm_cycles: np.ndarray                 # float64 [L, P] (corrected)
    best: List[Tuple[Perm, float]]         # per-layer winner + cycles
    tiers: List[str]                       # per-layer "ecm" | "exact"
    consulted: List[Tuple[int, ...]]       # per-layer tracesim'd indices

    @property
    def consultation_rate(self) -> float:
        """Fraction of the L x P space that reached the exact tier."""
        total = len(self.layers) * len(self.perms)
        return sum(len(c) for c in self.consulted) / max(total, 1)


def ecm_sweep(layers: Sequence[ConvLayer],
              machine: cm.MachineModel = cm.MachineModel(),
              threads: int = 1,
              perms_subset: Optional[Sequence[Perm]] = None,
              top_k: int = 8,
              tolerance: float = 0.25,
              correction: Optional[ecm_model.ECMCorrection] = None,
              max_exact_iters: Optional[int] = None,
              workers: Optional[int] = None,
              consult: bool = True,
              registry: Optional[reg.TuningRegistry] = None,
              ) -> ECMSweepResult:
    """The three-tier sweep: roofline + ECM everywhere,
    tracesim only where they disagree.

    Tier 1 scores each layer's permutation space with the batch roofline
    engine; tier 2 scores all layers at once with the ECM
    layer-condition model (plus the machine's learned ``correction`` if
    given).  Per layer, the union of both tiers' top-``top_k``
    short-lists is compared: if the models' relative disagreement on any
    short-listed candidate exceeds ``tolerance``, the exact trace
    simulator arbitrates *those candidates only* (``max_exact_iters``
    bounds each trace); otherwise the ECM argmin wins without a single
    trace.  With a ``registry``, each layer's winner is persisted under
    ``ecm_sweep_key`` with its deciding tier stamped in the value.
    """
    layers = tuple(layers)
    perm_tuple: Tuple[Perm, ...] = (ALL_PERMS if perms_subset is None
                                    else tuple(tuple(p) for p
                                               in perms_subset))
    roof = np.stack([cm.simulate_batch(l, perm_tuple, machine,
                                       threads).cycles for l in layers])
    ecm_res = ecm_model.ecm_predict(layers, perm_tuple, machine, threads)
    ecm_cyc = ecm_model.apply_correction(ecm_res, correction)

    best: List[Tuple[Perm, float]] = []
    tiers: List[str] = []
    consulted: List[Tuple[int, ...]] = []
    for li, layer in enumerate(layers):
        short_r = np.argsort(roof[li], kind="stable")[:top_k]
        short_e = np.argsort(ecm_cyc[li], kind="stable")[:top_k]
        cand = np.union1d(short_r, short_e)
        rel = np.abs(ecm_cyc[li, cand] - roof[li, cand]) \
            / np.maximum(roof[li, cand], 1e-12)
        if consult and float(rel.max()) > tolerance:
            exact = exact_sweep(layer, [perm_tuple[i] for i in cand],
                                machine, workers, max_exact_iters)
            win = int(cand[int(np.argmin(exact))])
            best.append((perm_tuple[win], float(exact.min())))
            tiers.append("exact")
            consulted.append(tuple(int(i) for i in cand))
        else:
            win = int(np.argmin(ecm_cyc[li]))
            best.append((perm_tuple[win], float(ecm_cyc[li, win])))
            tiers.append("ecm")
            consulted.append(())
        if registry is not None:
            registry.put(reg.TuningRecord(
                key=reg.ecm_sweep_key(layer, machine, threads),
                value={"perm": list(best[-1][0]),
                       "cycles": best[-1][1],
                       "tier": tiers[-1],
                       "consulted": len(consulted[-1])},
                source="offline"))
    return ECMSweepResult(layers=layers, perms=perm_tuple,
                          roofline_cycles=roof, ecm_cycles=ecm_cyc,
                          best=best, tiers=tiers, consulted=consulted)


def parallel_sweep(layers: Sequence[ConvLayer],
                   machine: cm.MachineModel = cm.MachineModel(),
                   threads: int = 1) -> List[SweepResult]:
    """Sweep many layers; result order == input order, values
    bit-identical to per-layer :func:`sweep_layer` calls.  It runs in
    process: the batch engine sweeps a layer faster than a pool could
    ship the work."""
    return [sweep_layer(l, machine, threads) for l in layers]


def warm_registry(layers: Sequence[ConvLayer],
                  registry: reg.TuningRegistry,
                  machine: cm.MachineModel = cm.MachineModel(),
                  spec: cm.H100Spec = cm.H100Spec(),
                  threads: int = 1, elem_bytes: int = 2, top_k: int = 5,
                  kinds: Sequence[str] = ("conv_sweep", "conv_schedule"),
                  refresh: bool = False) -> Dict[str, int]:
    """Tune every layer (Loki sweeps and/or H100 conv schedules at one
    image) into ``registry``.

    Only missing keys are computed (unless ``refresh``); each layer is one
    batch-engine array computation, run in-process.  The merge stays
    deterministic: records land in input order and the file is compacted
    (sorted by key), so warm output is byte-identical run to run.
    """
    evals0 = cm.total_evals()
    t0 = time.perf_counter()
    done = {"conv_sweep": 0, "conv_schedule": 0, "skipped": 0}
    if "conv_sweep" in kinds:
        keys = [reg.conv_sweep_key(l, machine, threads) for l in layers]
        todo = [(l, k) for l, k in zip(layers, keys)
                if refresh or k not in registry]
        done["skipped"] += len(layers) - len(todo)
        for layer, k in todo:
            s = sweep_layer(layer, machine, threads)
            registry.put(reg.TuningRecord(
                key=k,
                value={"cycles": s.cycles.tolist(),
                       "l1_misses": s.l1_misses.tolist(),
                       "l2_misses": s.l2_misses.tolist()},
                source="offline"))
            done["conv_sweep"] += 1
    if "conv_schedule" in kinds:
        keys = [reg.conv_schedule_key(l, spec, elem_bytes) for l in layers]
        todo = [(l, k) for l, k in zip(layers, keys)
                if refresh or k not in registry]
        done["skipped"] += len(layers) - len(todo)
        for layer, k in todo:
            ranked = tune_conv(layer, spec, elem_bytes, top_k=top_k)
            value = _ranked_to_value(ranked)
            if len(ranked) < top_k:
                value["complete"] = True  # the whole feasible enumeration
            registry.put(reg.TuningRecord(key=k, value=value,
                                          source="offline"))
            done["conv_schedule"] += 1
    registry.compact()
    _tune_counter("tune.warm_hits_total").inc(done["skipped"])
    _tune_counter("tune.sweeps_total").inc(
        done["conv_sweep"] + done["conv_schedule"])
    _tune_counter("tune.sweep_wall_s_total").inc(
        time.perf_counter() - t0)
    _tune_counter("tune.cost_model_evals_total").inc(
        cm.total_evals() - evals0)
    return done


__all__ = ["ALL_PERMS", "SweepResult", "sweep_layer", "batch_perm_scorer",
           "speedup_matrix", "Candidate", "static_candidates", "top_pairs",
           "sample_size_for_confidence", "good_permutation_counts",
           "neighbor_swap_search", "bfs_search", "cached_sweep_layer",
           "exact_sweep", "ECMSweepResult", "ecm_sweep", "parallel_sweep",
           "warm_registry", "tune_conv", "tune_matmul", "tune_sparse_conv",
           "tune_flash_attention", "tune_decode_attention", "tune_ssm_scan",
           "cached_tune_conv", "cached_tune_matmul",
           "cached_tune_sparse_conv", "cached_tune_flash_attention",
           "cached_tune_decode_attention", "cached_tune_ssm_scan",
           "conv_blocks", "matmul_blocks", "sparse_blocks",
           "flash_attention_tiles", "decode_splits", "scan_blocks"]
