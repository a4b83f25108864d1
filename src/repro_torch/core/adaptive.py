"""Run-time selection by micro-profiling (thesis §6.4).

The thesis' closing result: recent throughput is steady during a
convolution and predicts the total, so briefly profiling a few
candidates under the real calls and committing to the best is sound.
:class:`AdaptiveSelector` round-robins the top-K tuner candidates over
the first calls of a shape, checks that the timings are steady
(coefficient of variation), commits the argmin median and, with a
registry attached, writes the measured winner back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Generic, List, Optional, Sequence, TypeVar

import numpy as np

from repro_torch.core import registry as reg

S = TypeVar("S")  # schedule type


def steadiness(samples: Sequence[float]) -> float:
    """Coefficient of variation of call times (small, < ~0.1, means a
    short profile predicts the run)."""
    a = np.asarray(list(samples), dtype=np.float64)
    if len(a) < 2 or a.mean() == 0:
        return 0.0
    return float(a.std(ddof=1) / a.mean())


def host_time(call: Callable[[], None]) -> float:
    """Seconds one ``call`` takes on the host clock (the call must finish
    its device work before returning)."""
    t0 = time.perf_counter()
    call()
    return time.perf_counter() - t0


def microprofile(candidates: Sequence[S], run: Callable[[S], None],
                 repeats: int = 3, warmup: int = 1,
                 timer: Callable[[Callable[[], None]], float] = host_time,
                 ) -> Dict:
    """Time each candidate (median of ``repeats`` after ``warmup``) and
    return the winner with the measurements.  ``timer(call)`` gives one
    call's seconds: the host clock by default, CUDA events where the
    caller times the card."""
    timings: List[List[float]] = []
    for cand in candidates:
        for _ in range(warmup):
            run(cand)
        timings.append([timer(lambda: run(cand)) for _ in range(repeats)])
    medians = [float(np.median(t)) for t in timings]
    best = int(np.argmin(medians))
    return {"best": candidates[best], "best_index": best,
            "medians": medians, "timings": timings,
            "steadiness": [steadiness(t) for t in timings]}


def warm_median(v: Sequence[float]) -> float:
    """Median with the first sample dropped as warm-up (when there are
    more than two)."""
    return float(np.median(v[1:] if len(v) > 2 else v))


@dataclasses.dataclass
class _Slot(Generic[S]):
    """Per-shape probing state: candidates, timings, committed winner."""

    candidates: List[S]
    samples: Dict[int, List[float]]
    committed: Optional[S] = None
    next_candidate: int = 0
    registry_key: Optional[reg.RegistryKey] = None
    # the winner's median at the commit, the one source of a committed
    # slot's median (its samples stop there): a drift watch reads it
    # every step, and recomputing it cost 80-250 us a call between
    # steps on an H100 machine's host (PERF.md section 5)
    committed_median: Optional[float] = None


class AdaptiveSelector(Generic[S]):
    """Online schedule selection for a stream of calls.

    For the first ``probes_per_candidate * len(candidates)`` calls of a
    slot the selector round-robins the candidates; then it commits to
    the argmin median (the first sample of each dropped as warm-up),
    unless a candidate's timings are unsteady (CV above the threshold),
    in which case it probes up to ``max_extra_probes`` more rounds.  With
    a registry and a slot key, each commit is written back.
    """

    def __init__(self, probes_per_candidate: int = 3,
                 steadiness_threshold: float = 0.2,
                 max_extra_probes: int = 2,
                 registry: Optional[reg.TuningRegistry] = None):
        """Configure probe counts, the steadiness gate and write-back."""
        self.probes = probes_per_candidate
        self.threshold = steadiness_threshold
        self.max_extra = max_extra_probes
        self.registry = registry
        self._slots: Dict[str, _Slot] = {}

    def register(self, key: str, candidates: Sequence[S],
                 registry_key: Optional[reg.RegistryKey] = None) -> None:
        """Create a slot for ``key`` with its candidates (idempotent)."""
        if key not in self._slots:
            self._slots[key] = _Slot(list(candidates),
                                     {i: [] for i in range(len(candidates))},
                                     registry_key=registry_key)

    def register_ranked(self, key: str, ranked: Sequence,
                        registry_key: Optional[reg.RegistryKey] = None
                        ) -> None:
        """Register a slot from a ``tuner.cached_tune_*`` result."""
        self.register(key, [s for s, _ in ranked], registry_key=registry_key)

    def propose(self, key: str) -> S:
        """The schedule for this call: the committed winner or the next
        probe."""
        return self.propose_with_index(key)[1]

    def propose_with_index(self, key: str) -> tuple:
        """(candidate index, or None once committed; schedule): callers
        that may interleave capture the index and report with
        :meth:`observe_at`, so a timing never lands on the wrong
        candidate."""
        slot = self._slots[key]
        if slot.committed is not None:
            return None, slot.committed
        idx = slot.next_candidate
        return idx, slot.candidates[idx]

    def observe(self, key: str, dt: float) -> None:
        """Feed a call time to the candidate last proposed for ``key``."""
        self.observe_at(key, self._slots[key].next_candidate, dt)

    def observe_at(self, key: str, index: Optional[int], dt: float) -> None:
        """Attribute ``dt`` to candidate ``index`` (None: committed, a
        no-op); commit once every candidate has its probes and the
        timings are steady or the extra rounds are spent."""
        slot = self._slots[key]
        if slot.committed is not None or index is None:
            return
        slot.samples[index].append(dt)
        slot.next_candidate = (index + 1) % len(slot.candidates)
        min_n = min(len(v) for v in slot.samples.values())
        if min_n < self.probes:
            return
        cvs = [steadiness(v[1:]) if len(v) > 2 else 0.0
               for v in slot.samples.values()]
        if max(cvs) > self.threshold and min_n < self.probes + self.max_extra:
            return  # unsteady: keep probing
        medians = [warm_median(v) for _, v in sorted(slot.samples.items())]
        best = int(np.argmin(medians))
        self._commit(slot, best, medians[best])

    def _commit(self, slot: _Slot, index: int, median_s: float) -> None:
        """Freeze the winner and write the measurement to the registry."""
        slot.committed = slot.candidates[index]
        slot.committed_median = median_s
        if self.registry is not None and slot.registry_key is not None:
            self.registry.record_measurement(
                slot.registry_key, reg.schedule_to_dict(slot.committed),
                median_s)

    def committed(self, key: str) -> Optional[S]:
        """The committed schedule for ``key`` (None while probing)."""
        slot = self._slots.get(key)
        return slot.committed if slot else None

    def reopen(self, key: str) -> bool:
        """Drop a committed winner and its samples so the slot probes
        again (False for unknown or uncommitted slots)."""
        slot = self._slots.get(key)
        if slot is None or slot.committed is None:
            return False
        slot.committed = None
        slot.committed_median = None
        slot.samples = {i: [] for i in range(len(slot.candidates))}
        slot.next_candidate = 0
        return True

    def measured_median(self, key: str) -> Optional[float]:
        """The committed winner's median, else the fastest candidate
        median so far; None before any observation."""
        slot = self._slots.get(key)
        if slot is None:
            return None
        if slot.committed is not None:
            return slot.committed_median
        medians = [warm_median(v) for v in slot.samples.values() if v]
        return min(medians) if medians else None

    def report(self) -> Dict[str, Dict]:
        """Per-slot committed winner and raw samples."""
        return {key: {"committed": slot.committed,
                      "samples": {i: list(v)
                                  for i, v in slot.samples.items()}}
                for key, slot in self._slots.items()}


__all__ = ["AdaptiveSelector", "microprofile", "steadiness", "warm_median"]
