"""Tier-2 analytic ECM / layer-condition cost model (kerncraft-style).

The tuning stack has three cost tiers (the JAX package's docs/TUNING.md
describes them):

1. **roofline** — :func:`repro_torch.core.loki.simulate_batch`: the
   detailed recursive footprint model, batched over the 720 permutations
   of ONE layer per call.
2. **ecm** (this module) — a coarser *layer-condition* model in the style
   of kerncraft's ECM and the cache-level analysis of Bates et al.
   (*Configurable memory systems for embedded many-core processors*),
   batched over **layers x permutations at once**: the whole 216-layer
   Table 4.2/4.3 design space scores as a single ``[L, P]`` array
   computation.
3. **exact** — :mod:`repro_torch.core.tracesim` via ``tuner.exact_sweep``:
   per-access simulation, seconds per permutation, consulted only where
   tiers 1 and 2 disagree (``tuner.ecm_sweep``).

Layer conditions replace the per-depth recursion with one question per
cache level: what is the outermost depth ``d*`` whose *total* inner
footprint fits in the cache?  Everything inside ``d*`` is served from the
level (steady-state hits); each of the ``iterations / run(d*)`` visits of
the sub-nest refetches its one-pass footprint.  That is exactly the
kerncraft layer-condition argument, evaluated here against the
precomputed 64-subset footprint tables of :mod:`repro_torch.core.loopnest`
stacked into ``[L, 64]`` gathers — no per-layer Python loop at scoring
time.

Because the model is coarser than tier 1 (it drops the halo-reuse and
hot-set refinements), a small learned multiplicative correction —
log-linear ridge regression on exact<->analytic residuals — can be
fitted, persisted in the tuning registry under this module's own
:data:`ECM_MODEL_VERSION`, and applied at scoring time.

It is the JAX package's module (``repro.core.ecm``), copied: predictions
and the fitted correction's JSON are equal, byte for byte.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import loopnest as ln
from repro_torch.core.loki import EVAL_COUNTS, MachineModel
from repro_torch.core.loopnest import ConvLayer

# Version string for ECM-tier registry records (kinds ``ecm_sweep`` and
# ``ecm_correction``).  Independent of cost_model.COST_MODEL_VERSION: the
# tiers evolve separately and their cached predictions must invalidate
# separately.
ECM_MODEL_VERSION = "ecm-1"

# Features per (layer, perm) sample of the learned correction — see
# :func:`correction_features`.
N_FEATURES = 6

# The log-space correction is clipped to this band before exponentiation
# so a correction fitted on small layers cannot blow up cycle predictions
# when extrapolating to layers far outside the residual set.
CORRECTION_CLIP = 2.0


@dataclasses.dataclass
class ECMBatchResult:
    """ECM predictions for ``L`` layers x ``P`` permutations in one shot.

    Every array is ``[L, P]`` (or a per-level dict of them); row ``l``
    column ``p`` corresponds to ``layers[l]`` under ``perms[p]``.
    """

    layers: Tuple[ConvLayer, ...]
    perms: np.ndarray                       # int64 [P, 6]
    cycles: np.ndarray                      # float64 [L, P]
    accesses: np.ndarray                    # float64 [L, P]
    misses: Dict[str, np.ndarray]           # level -> float64 [L, P]
    fit_depth: Dict[str, np.ndarray]        # level -> int64 [L, P]
    out_writes: np.ndarray                  # float64 [L, P]
    machine: MachineModel

    def argmin(self) -> np.ndarray:
        """Per-layer index of the cheapest permutation (int64 ``[L]``)."""
        return np.argmin(self.cycles, axis=1)

    def best(self, layer_index: int) -> Tuple[Tuple[int, ...], float]:
        """(argmin permutation, predicted cycles) for one layer row."""
        i = int(np.argmin(self.cycles[layer_index]))
        return (tuple(int(x) for x in self.perms[i]),
                float(self.cycles[layer_index, i]))


def _layer_condition_misses(layers: Sequence[ConvLayer],
                            masks: np.ndarray, outer: np.ndarray,
                            out_writes: np.ndarray, cap_blocks: float,
                            block_bytes: int, partial_sums: bool,
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Steady-state block traffic of one cache level for every
    (layer, perm): ``(misses [L, P], fit_depth [L, P])``.

    ``d*`` = first depth (outermost-first) whose total inner footprint
    fits in ``cap_blocks``; per-array traffic = one-pass footprint at
    ``d*`` times the ``outer[l, p, d*]`` visits of that sub-nest.  With
    partial sums the out[] traffic is clamped into
    ``[full out footprint, out_writes]`` exactly like the tier-1 model,
    so the tiers agree on the register-accumulator effect.
    """
    tabs = ln.stacked_footprint_tables(layers, block_bytes)
    fp = {a: tabs[a][:, masks] for a in ln.ARRAY_DIMS}       # [L, P, 7]
    total = fp["out"] + fp["wgt"] + fp["img"]
    fits = total <= cap_blocks                               # [L, P, 7]
    # First fitting depth; depth 6 (empty inner set, ~1 block per array)
    # is the streaming fallback when not even one iteration's blocks fit.
    dstar = np.where(fits.any(axis=-1), np.argmax(fits, axis=-1),
                     masks.shape[1] - 1)                     # [L, P]
    gather = dstar[..., None]
    outer_at = np.take_along_axis(outer, gather, axis=-1)[..., 0]
    traffic = {a: np.take_along_axis(fp[a], gather, axis=-1)[..., 0]
               * outer_at for a in ln.ARRAY_DIMS}
    if partial_sums:
        floors = np.array([l.oc * l.h * l.w
                           / max(1, block_bytes // l.elem_bytes)
                           for l in layers])                 # [L]
        traffic["out"] = np.minimum(traffic["out"], out_writes)
        traffic["out"] = np.maximum(traffic["out"], floors[:, None])
    misses = traffic["out"] + traffic["wgt"] + traffic["img"]
    return misses, dstar


def ecm_predict(layers: Sequence[ConvLayer],
                perms: Sequence[Sequence[int]],
                machine: MachineModel = MachineModel(),
                threads: int = 1,
                partial_sums: bool = True) -> ECMBatchResult:
    """Score ``L`` layers x ``P`` permutations as one array computation.

    Same cycle accounting as the tier-1 model (instructions + per-level
    hit latencies + memory latency, §2.3.1; outermost-loop threading with
    the §3.4 atomic penalty) but with layer-condition miss counts, so the
    whole multi-layer design space needs no per-layer Python loop.
    """
    layers = tuple(layers)
    parr = ln.perms_array(perms)
    EVAL_COUNTS["ecm_batch"] += len(layers) * parr.shape[0]
    masks = ln.perm_inner_masks(parr)                        # [P, 7]
    trips = np.stack([ln.trips_vector(l) for l in layers]
                     ).astype(np.float64)                    # [L, 6]
    iters = np.array([float(l.iterations) for l in layers])  # [L]

    per_iter = sum(ln.accesses_per_iteration(partial_sums).values())
    if partial_sums:
        out_writes = np.stack([
            ln.out_writes_with_partial_sums_batch(l, parr)
            for l in layers]).astype(np.float64)             # [L, P]
    else:
        out_writes = np.zeros((len(layers), parr.shape[0]))
    accesses = per_iter * iters[:, None] + 2.0 * out_writes

    # run[l, p, d] = trip product of the loops at positions d..5 of perm
    # p for layer l; outer = iterations / run = visits of that sub-nest.
    n = parr.shape[1]
    run = np.ones((len(layers), parr.shape[0], n + 1))
    for d in range(n - 1, -1, -1):
        run[:, :, d] = run[:, :, d + 1] * trips[:, parr[:, d]]
    outer = iters[:, None, None] / run                       # [L, P, 7]

    misses: Dict[str, np.ndarray] = {}
    fit_depth: Dict[str, np.ndarray] = {}
    for level in machine.levels:
        cap_blocks = level.size_bytes / level.block_bytes
        misses[level.name], fit_depth[level.name] = _layer_condition_misses(
            layers, masks, outer, out_writes, cap_blocks,
            level.block_bytes, partial_sums)

    l1, l2 = machine.levels[0], machine.levels[1]
    m1 = misses[l1.name]
    m2 = np.minimum(misses[l2.name], m1)   # inclusive hierarchy sanity
    hits_l1 = np.maximum(accesses - m1, 0.0)
    hits_l2 = np.maximum(m1 - m2, 0.0)
    cycles = (iters[:, None] * machine.instrs_per_iter * machine.cpi_compute
              + hits_l1 * l1.latency + hits_l2 * l2.latency
              + m2 * machine.mem_latency)

    if threads > 1:
        outer_ids = parr[:, 0]                               # [P]
        par = np.minimum(float(threads), trips[:, outer_ids])
        cycles = cycles / par
        upd = out_writes if partial_sums else np.broadcast_to(
            iters[:, None], cycles.shape)
        atomic = machine.atomic_cost * upd / np.maximum(par, 1.0)
        cycles = np.where(ln.OUTPUT_MASK[outer_ids][None, :], cycles,
                          cycles + atomic)

    return ECMBatchResult(layers=layers, perms=parr, cycles=cycles,
                          accesses=accesses, misses=misses,
                          fit_depth=fit_depth, out_writes=out_writes,
                          machine=machine)


# ---------------------------------------------------------------------------
# Learned correction: log-linear ridge fit on exact<->analytic residuals
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ECMCorrection:
    """A fitted multiplicative correction ``exp(features . coef)``.

    ``version`` pins the feature definition + fit procedure
    (:data:`ECM_MODEL_VERSION`); registry records from a different
    version are ignored on load.
    """

    version: str
    coef: Tuple[float, ...]
    n_samples: int

    def to_dict(self) -> Dict:
        """JSON-serialisable registry value form."""
        return {"version": self.version, "coef": list(self.coef),
                "n_samples": self.n_samples}

    @staticmethod
    def from_dict(d: Dict) -> "ECMCorrection":
        """Inverse of :meth:`to_dict`."""
        return ECMCorrection(version=d["version"],
                             coef=tuple(float(c) for c in d["coef"]),
                             n_samples=int(d["n_samples"]))


def correction_features(result: ECMBatchResult) -> np.ndarray:
    """Deterministic float64 features ``[L, P, 6]`` for the correction.

    Per (layer, perm) sample: intercept, log iterations, per-level miss
    ratios (log1p of misses/accesses for L1 and L2), log of the
    reduction-run length proxy (iterations per out write), and whether
    the outermost loop indexes out[] — the axes along which the
    layer-condition model deviates from exact simulation.
    """
    L, P = result.cycles.shape
    iters = np.array([float(l.iterations) for l in result.layers])
    l1 = result.machine.levels[0].name
    l2 = result.machine.levels[1].name
    acc = np.maximum(result.accesses, 1.0)
    feats = np.empty((L, P, N_FEATURES))
    feats[:, :, 0] = 1.0
    feats[:, :, 1] = np.log(iters)[:, None]
    feats[:, :, 2] = np.log1p(result.misses[l1] / acc)
    feats[:, :, 3] = np.log1p(result.misses[l2] / acc)
    feats[:, :, 4] = np.log(iters[:, None]
                            / np.maximum(result.out_writes, 1.0) + 1.0)
    feats[:, :, 5] = ln.OUTPUT_MASK[result.perms[:, 0]][None, :]
    return feats


def fit_correction(result: ECMBatchResult,
                   samples: Sequence[Tuple[int, int, float]],
                   ) -> ECMCorrection:
    """Ridge-fit ``log(exact / ecm)`` on ``(layer_idx, perm_idx, exact)``
    residual samples.

    Samples are canonically sorted by ``(layer_idx, perm_idx)`` before
    the normal-equation solve, so the fitted coefficients — and their
    registry serialisation — are byte-deterministic for a fixed residual
    set regardless of collection order.
    """
    ordered = sorted((int(li), int(pi), float(ex))
                     for li, pi, ex in samples)
    feats = correction_features(result)
    X = np.stack([feats[li, pi] for li, pi, _ in ordered])
    y = np.array([math.log(max(ex, 1e-12)
                           / max(result.cycles[li, pi], 1e-12))
                  for li, pi, ex in ordered])
    A = X.T @ X + 1e-6 * np.eye(N_FEATURES)
    beta = np.linalg.solve(A, X.T @ y)
    return ECMCorrection(version=ECM_MODEL_VERSION,
                         coef=tuple(float(b) for b in beta),
                         n_samples=len(ordered))


def apply_correction(result: ECMBatchResult,
                     correction: Optional[ECMCorrection]) -> np.ndarray:
    """Corrected cycles ``[L, P]``; the raw prediction if no correction.

    The log-space shift is clipped to ±:data:`CORRECTION_CLIP` so a fit
    never changes a prediction by more than ``e**2`` in either direction.
    """
    if correction is None:
        return result.cycles
    shift = correction_features(result) @ np.asarray(correction.coef)
    shift = np.clip(shift, -CORRECTION_CLIP, CORRECTION_CLIP)
    return result.cycles * np.exp(shift)


def save_correction(correction: ECMCorrection, machine: MachineModel,
                    registry=None):
    """Persist a fitted correction in the tuning registry.

    Keyed by machine fingerprint under :data:`ECM_MODEL_VERSION` (see
    ``registry.ecm_correction_key``); returns the key.
    """
    from repro_torch.core import registry as reg
    registry = registry if registry is not None else \
        reg.TuningRegistry.default()
    key = reg.ecm_correction_key(machine)
    registry.put(reg.TuningRecord(key=key, value=correction.to_dict(),
                                  source="offline"))
    return key


def load_correction(machine: MachineModel,
                    registry=None) -> Optional[ECMCorrection]:
    """Load this machine's fitted correction, or None.

    Records whose stored version differs from :data:`ECM_MODEL_VERSION`
    are treated as absent (stale feature definitions must not apply).
    """
    from repro_torch.core import registry as reg
    registry = registry if registry is not None else \
        reg.TuningRegistry.default()
    rec = registry.get(reg.ecm_correction_key(machine))
    if rec is None or rec.value.get("version") != ECM_MODEL_VERSION:
        return None
    return ECMCorrection.from_dict(rec.value)
