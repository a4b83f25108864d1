"""Span tracer emitting Chrome trace-event / Perfetto-loadable JSON (the
port's copy of ``repro.obs.trace``).

``SpanTracer.span(...)`` is a context manager that records a complete
("X") trace event with microsecond timestamps relative to the
tracer's construction.  The clock is injected exactly the way
``ServeSession``'s swappable ``_clock`` works: pass a zero-argument
callable returning monotonic seconds, and two runs driven by the same
fake clock produce byte-identical trace JSON (asserted by
``tests/test_torch_obs.py``).  The process name defaults to
``repro_torch``, where the JAX tracer's reads ``repro``; every event
is otherwise the same.

Per-request lifecycle tracks use async begin/end events (``"b"`` /
``"e"``) keyed by request id, so Perfetto renders each request as its
own horizontal track spanning submit → terminal state, while the
nested engine spans (step → admit/prefill/decode/compact) live on the
main thread track.

``NullTracer`` is the disabled twin: ``enabled`` is ``False`` and
instrumented code guards on that flag, so a telemetry-off run never
enters any tracer method (the null fast path, also asserted in
tests).
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["SpanTracer", "NullTracer", "TRACE_PID"]

# Single-process stack: one synthetic pid, tid 0 for engine spans.
TRACE_PID = 1


class SpanTracer:
    """Collects trace events; exports ``{"traceEvents": [...]}`` JSON."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 process_name: str = "repro_torch") -> None:
        """Create a tracer.

        ``clock`` is a zero-argument callable returning monotonic
        seconds (default ``time.perf_counter``); all event timestamps
        are microseconds relative to the first reading taken here.
        """
        self._clock = clock if clock is not None else time.perf_counter
        self._t0 = self._clock()
        self.events: List[Dict[str, Any]] = []
        self._meta(process_name)

    def _meta(self, process_name: str) -> None:
        """Emit the process/thread-name metadata events."""
        self.events.append({
            "ph": "M", "name": "process_name", "pid": TRACE_PID, "tid": 0,
            "args": {"name": process_name},
        })
        self.events.append({
            "ph": "M", "name": "thread_name", "pid": TRACE_PID, "tid": 0,
            "args": {"name": "engine"},
        })

    def _ts(self) -> float:
        """Current timestamp in microseconds since tracer start."""
        return round((self._clock() - self._t0) * 1e6, 3)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "repro", tid: int = 0,
             **args: Any) -> Iterator[None]:
        """Record a complete ("X") event covering the ``with`` body."""
        start = self._ts()
        try:
            yield
        finally:
            end = self._ts()
            self.events.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": start, "dur": round(end - start, 3),
                "pid": TRACE_PID, "tid": tid, "args": args,
            })

    def complete(self, name: str, start_s: float, end_s: float,
                 cat: str = "repro", tid: int = 0, **args: Any) -> None:
        """Record a complete ("X") event from two explicit readings of
        this tracer's clock, in seconds (for hot paths where a ``with``
        block is awkward — e.g. regions with early ``continue``)."""
        ts = round((start_s - self._t0) * 1e6, 3)
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": ts, "dur": round((end_s - start_s) * 1e6, 3),
            "pid": TRACE_PID, "tid": tid, "args": args,
        })

    def instant(self, name: str, cat: str = "repro", tid: int = 0,
                **args: Any) -> None:
        """Record an instant ("i") event at the current timestamp."""
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._ts(), "pid": TRACE_PID, "tid": tid, "args": args,
        })

    def async_begin(self, name: str, ident: str, cat: str = "request",
                    **args: Any) -> None:
        """Open an async track span (Perfetto renders one row per id)."""
        self.events.append({
            "name": name, "cat": cat, "ph": "b", "id": ident,
            "ts": self._ts(), "pid": TRACE_PID, "tid": 0, "args": args,
        })

    def async_end(self, name: str, ident: str, cat: str = "request",
                  **args: Any) -> None:
        """Close the async track span opened with the same name/id."""
        self.events.append({
            "name": name, "cat": cat, "ph": "e", "id": ident,
            "ts": self._ts(), "pid": TRACE_PID, "tid": 0, "args": args,
        })

    def to_chrome(self) -> Dict[str, Any]:
        """The trace as a Chrome trace-event JSON object."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Deterministic JSON encoding of ``to_chrome()``.

        Keys are sorted and separators fixed, so identical event
        streams (e.g. two runs under the same fake clock) serialise to
        byte-identical text.
        """
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def write(self, path: str) -> None:
        """Write the trace JSON to ``path``."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
            f.write("\n")


class NullTracer:
    """Disabled tracer: instrumented code checks ``enabled`` and never
    calls in.  Methods exist (and raise in the fast-path test when
    monkeypatched) so type-shape matches ``SpanTracer``."""

    enabled = False

    def span(self, name: str, cat: str = "repro", tid: int = 0,
             **args: Any):
        """No-op context manager (never reached when guarded)."""
        return contextlib.nullcontext()

    def complete(self, name: str, start_s: float, end_s: float,
                 cat: str = "repro", tid: int = 0, **args: Any) -> None:
        """No-op."""

    def instant(self, name: str, cat: str = "repro", tid: int = 0,
                **args: Any) -> None:
        """No-op."""

    def async_begin(self, name: str, ident: str, cat: str = "request",
                    **args: Any) -> None:
        """No-op."""

    def async_end(self, name: str, ident: str, cat: str = "request",
                  **args: Any) -> None:
        """No-op."""

    def to_chrome(self) -> Dict[str, Any]:
        """Empty trace."""
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Empty trace JSON."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def write(self, path: str) -> None:
        """Write the empty trace (keeps CLI plumbing uniform)."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_json())
            f.write("\n")
