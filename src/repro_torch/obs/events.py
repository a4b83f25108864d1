"""One structured event schema for the port's serving stack (port of
``repro.obs.events``).

The session's stats, the fault injector and the straggler monitor all
emit :class:`Event`: one dataclass, one ``as_dict``, so the CLI summary
line and ``stats.to_dict()`` derive from the same records.  The schema
is the JAX package's, field for field, so the two packages' events
compare equal.

``kind`` is an open vocabulary; the port's emitters use:

* engine faults — ``compile_failure``, ``degraded``, ``poison_row``,
  ``alloc_exhausted``, ``allocator``, ``admission_failure``,
  ``step_exception``, ``straggler``
* injected faults (``FaultInjector``) — ``compile``, ``nan``,
  ``alloc``, ``slow``, ``doublefree``

Extra per-kind fields live in ``data`` and read back as attributes
(``event.ratio``) or through ``as_dict()``, which flattens them beside
the common fields.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["Event", "summarize_events", "format_event_summary"]


@dataclasses.dataclass
class Event:
    """A single structured operational event.

    ``kind`` names the event type; ``step`` is the engine decode-step
    index when applicable; ``request_id`` ties the event to a request;
    ``ts`` is a session-clock timestamp in seconds; ``data`` holds the
    kind-specific fields.
    """

    kind: str
    step: Optional[int] = None
    request_id: Optional[str] = None
    ts: Optional[float] = None
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        """Expose ``data`` entries as attributes (``event.ratio``)."""
        try:
            return self.__dict__["data"][name]
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}") from None

    def as_dict(self) -> Dict[str, Any]:
        """Flat JSON-serialisable dict: common fields + ``data``."""
        out: Dict[str, Any] = {"kind": self.kind}
        if self.step is not None:
            out["step"] = self.step
        if self.request_id is not None:
            out["request_id"] = self.request_id
        if self.ts is not None:
            out["ts"] = self.ts
        out.update(self.data)
        return out


def summarize_events(events: Iterable[Event]) -> Dict[str, int]:
    """Per-kind counts over an event log, sorted by kind."""
    counts = Counter(e.kind for e in events)
    return dict(sorted(counts.items()))


def format_event_summary(events: List[Event],
                         degraded: Iterable[Any] = ()) -> str:
    """The CLI fault summary line, derived from the log: e.g.
    ``"faults: none"`` or ``"faults: compile_failure=2 degraded=1 |
    degraded buckets: prefill[b1,p8]"`` (the JAX package's line)."""
    counts = summarize_events(events)
    body = (" ".join(f"{k}={n}" for k, n in counts.items())
            if counts else "none")
    line = f"faults: {body}"
    degraded = list(degraded)
    if degraded:
        line += " | degraded buckets: " + ", ".join(str(d)
                                                     for d in degraded)
    return line
