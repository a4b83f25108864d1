"""Cross-request executable cache (port of ``repro.serving.cache``).

A serving process pays for building a step once per *distinct step*,
not once per request: the step is fully determined by the model
architecture, the shape bucket it serves, the committed schedules baked
into it, and the backend.  :class:`ExecutableCache` keys the built
prefill and decode steps by exactly that tuple, so repeat traffic on a
warm bucket builds nothing at all.

In the JAX package an entry is an AOT-compiled XLA executable; in the
port it is a :class:`~repro_torch.serving.captured.CapturedStep`, whose
build on a card is one CUDA graph capture.

Eviction is LRU by entry count: a captured step pins its graph's
private memory pool and static buffers, so a long-lived session serving
many buckets must bound them.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ExecKey:
    """Identity of one built step function.

    ``length`` is the role's shape projection: the padded prompt length
    for prefill, the padded total (KV-capacity) length for decode, so
    requests with different decode budgets share one prefill step and
    vice versa.

    ``detail`` disambiguates steps whose shapes differ for reasons the
    other fields cannot express: the paged decode step keys on
    ``("paged", block_size, max_blocks)`` so it never collides with a
    contiguous-cache decode step of the same (batch, length).  It must
    be hashable.  ``schedules`` stays None in the port until its
    decode and scan wrappers take a schedule.
    """

    arch: str
    role: str  # "prefill" | "decode"
    batch: int
    length: int
    schedules: Optional[Any]
    backend: str
    detail: Optional[Any] = None


class ExecutableCache:
    """LRU cache of built steps keyed by :class:`ExecKey`.

    ``get(key, builder)`` returns ``(step, hit)``; on a miss the builder
    runs (one build), the result is inserted, and the least-recently-used
    entry is evicted if over capacity.  Counters (`hits`, `misses`,
    `evictions`, `compiles`) and the `compiled_log` of keys built feed
    :class:`~repro_torch.serving.session.SessionStats` and the tests.
    """

    def __init__(self, capacity: int = 16):
        """Create an empty cache bounded to ``capacity`` entries."""
        if capacity < 1:
            raise ValueError("ExecutableCache capacity must be >= 1")
        self.capacity = capacity
        self._entries: "OrderedDict[ExecKey, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compiles = 0
        self.compiled_log: List[ExecKey] = []

    def __len__(self) -> int:
        """Number of cached entries."""
        return len(self._entries)

    def __contains__(self, key: ExecKey) -> bool:
        """Alias for :meth:`contains` (no LRU/counter side effects)."""
        return key in self._entries

    def contains(self, key: ExecKey) -> bool:
        """Probe without touching LRU order or counters."""
        return key in self._entries

    def peek(self, key: ExecKey) -> Optional[Any]:
        """The entry for ``key`` or None, without touching LRU order or
        counters (the engine reads a cached decode step's pool at the
        start of an activation, before its first step looks it up)."""
        return self._entries.get(key)

    def get(self, key: ExecKey, builder: Callable[[], Any],
            ) -> Tuple[Any, bool]:
        """Return ``(step, hit)``, building and inserting on a miss."""
        with self._lock:
            exe = self._entries.get(key)
            if exe is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return exe, True
            self.misses += 1
        # Build outside the lock: a capture can take seconds and the
        # cache must stay probeable meanwhile.
        exe = builder()
        with self._lock:
            if key not in self._entries:
                self.compiles += 1
                self.compiled_log.append(key)
                self._entries[key] = exe
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self.evictions += 1
            self._entries.move_to_end(key)
            return self._entries[key], False

    def compiled_roles(self) -> Dict[str, int]:
        """Build counts per role (``{"prefill": n, "decode": m}``)."""
        out: Dict[str, int] = {}
        for k in self.compiled_log:
            out[k.role] = out.get(k.role, 0) + 1
        return out

    def stats(self) -> Dict[str, int]:
        """Counter snapshot (entries/capacity/hits/misses/evictions/compiles)."""
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "compiles": self.compiles,
        }

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses), 0.0 before any lookup."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


__all__ = ["ExecKey", "ExecutableCache"]
