"""Flight recorder: a bounded in-memory ring + postmortem bundles (the
port's copy of ``repro.obs.recorder``).

A :class:`FlightRecorder` keeps the last N operational entries of a
serving session — structured events, step spans, metric deltas — in a
bounded ring buffer, plus the latest allocator state.  When something
goes wrong (an engine fault, an SLO page, a drift alarm) the owner
dumps a ``postmortem-<reason>.json`` bundle: the recent timeline, the
lifecycle of the requests involved, the registry provenance of the
schedules that were active, and the allocator state — everything
needed to debug the incident after the process dies.

Bundles are byte-deterministic for deterministic inputs: JSON is
rendered with ``sort_keys=True`` and fixed separators (the same
convention as ``SpanTracer.to_json``), timestamps come only from the
injected clock (never wall time), and the filename is a pure function
of the dump reason — a re-dump for the same reason overwrites the
file with the refreshed state, so the artifact on disk always reflects
the latest view of that incident.
"""

from __future__ import annotations

import json
import os
import re
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from repro_torch.obs.events import Event

__all__ = ["FlightRecorder", "POSTMORTEM_KINDS"]

# Event kinds that should trigger a postmortem dump when they reach a
# session's event ledger: every engine fault of the failure contract,
# plus the watchdog's drift alarms and SLO pages.  The port's session
# emits no ``degraded`` or ``step_exception`` yet (a build or step
# that raises propagates); the set stays the JAX package's.
POSTMORTEM_KINDS = frozenset({
    "compile_failure", "degraded", "poison_row", "alloc_exhausted",
    "allocator", "admission_failure", "step_exception", "straggler",
    "drift", "slo_page",
})

_REASON_RE = re.compile(r"[^A-Za-z0-9_.-]+")


class FlightRecorder:
    """Bounded ring of recent session activity + postmortem writer.

    ``capacity`` bounds the ring (oldest entries fall off); ``out_dir``
    is where bundles land (created on first dump); ``clock`` is the
    injected monotonic clock — when ``None`` entries carry no
    timestamps of their own (event entries keep the ``ts`` their
    emitter stamped).
    """

    def __init__(self, out_dir: str = "artifacts", capacity: int = 256,
                 clock: Optional[Callable[[], float]] = None) -> None:
        """Create an empty recorder writing bundles under ``out_dir``."""
        self.out_dir = out_dir
        self.capacity = int(capacity)
        self.clock = clock
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._allocator: Dict[str, Any] = {}
        self._request_ids: List[str] = []
        self.dumps: Dict[str, int] = {}

    def bind(self, *, clock=None) -> None:
        """Late clock wiring; an explicitly constructed clock wins."""
        if clock is not None and self.clock is None:
            self.clock = clock

    # -- ring taps ---------------------------------------------------------

    def _push(self, entry: Dict[str, Any]) -> None:
        """Append one entry, stamping it from the clock when bound."""
        if self.clock is not None and "ts" not in entry:
            entry["ts"] = self.clock()
        self._ring.append(entry)

    def record_event(self, event: Event) -> None:
        """Tap one structured event into the ring."""
        entry = {"type": "event"}
        entry.update(event.as_dict())
        self._push(entry)
        rid = event.request_id
        if rid is not None and rid not in self._request_ids:
            self._request_ids.append(rid)

    def record_span(self, name: str, step: Optional[int] = None,
                    dur_s: Optional[float] = None) -> None:
        """Tap one completed span (e.g. a decode step) into the ring."""
        entry: Dict[str, Any] = {"type": "span", "name": name}
        if step is not None:
            entry["step"] = step
        if dur_s is not None:
            entry["dur_s"] = dur_s
        self._push(entry)

    def record_metric(self, name: str, value: float) -> None:
        """Tap one metric delta/level into the ring."""
        self._push({"type": "metric", "name": name, "value": value})

    def note_allocator(self, state: Dict[str, Any]) -> None:
        """Replace the latest-known allocator state (kept out of the
        ring: only the freshest view matters for a postmortem)."""
        self._allocator = dict(state)

    # -- views -------------------------------------------------------------

    def timeline(self) -> List[Dict[str, Any]]:
        """The ring contents, oldest first."""
        return list(self._ring)

    def request_ids(self) -> List[str]:
        """Requests named by any event in insertion order (the
        'affected requests' a postmortem resolves lifecycles for)."""
        return list(self._request_ids)

    # -- postmortem --------------------------------------------------------

    def dump(self, reason: str,
             context: Optional[Dict[str, Any]] = None) -> str:
        """Write ``postmortem-<reason>.json`` and return its path.

        The bundle carries the recent timeline, the latest allocator
        state, and whatever the caller assembled in ``context``
        (affected-request lifecycles, schedule provenance, watchdog
        report).  Deterministic rendering: sorted keys, fixed
        separators, clock-derived timestamp only.
        """
        safe = _REASON_RE.sub("_", reason) or "unknown"
        bundle: Dict[str, Any] = {
            "reason": reason,
            "timeline": self.timeline(),
            "allocator": dict(self._allocator),
            "affected_requests": self.request_ids(),
        }
        if self.clock is not None:
            bundle["ts"] = self.clock()
        if context:
            bundle.update(context)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"postmortem-{safe}.json")
        text = json.dumps(bundle, sort_keys=True,
                          separators=(",", ":"), default=str)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        self.dumps[reason] = self.dumps.get(reason, 0) + 1
        return path
