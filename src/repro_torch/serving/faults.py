"""Deterministic fault injection for the serving engine (port of
``repro.serving.faults``).

The session's recovery paths (poison-row retirement, admission
backpressure under allocator exhaustion, double-free containment,
straggler detection, build retries) guard against faults that do not
occur on a healthy machine; a :class:`FaultInjector` handed to
``ServeSession(faults=...)`` fires :class:`FaultSpec`\\ s at exact,
reproducible points:

* ``compile`` — raise :class:`InjectedFault` at the start of a build
  attempt (``step`` indexes build attempts, counted across the session;
  a build is one step's warm-up and capture on a card).  ``times >= 1 +
  compile_retries`` makes the failure persistent, and the port then
  raises out of ``drain``, or with ``fallback_backend="eager"`` degrades
  the bucket (the JAX session's default degrades it).
* ``nan`` — write NaN into row ``row``'s decode logits at engine step
  ``step``, on the device, through the step's poison-mask input, before
  the step's finite-flag reduction.
* ``alloc`` — report the paged-KV allocator as exhausted at admission
  boundaries ``[step, step+times)`` (backpressure, no crash).
* ``slow`` — add ``magnitude`` seconds to the duration reported to the
  :class:`~repro_torch.runtime.ft.StragglerMonitor` at step ``step`` (no
  sleep: the spike is simulated, the detection path is real).
* ``doublefree`` — free a retiring row's blocks twice at step ``step``.

The CLI form (``launch/serve --inject-fault``) is
``kind@step[xTIMES][.ROW]``, e.g. ``nan@3``, ``compile@0x3``,
``nan@2.1`` (row 1 at step 2).  Everything the injector fires is logged
in :attr:`FaultInjector.fired` as :class:`~repro_torch.obs.events.Event`
records, the schema ``SessionStats.events`` uses.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Sequence

from repro_torch.obs.events import Event

KINDS = ("compile", "nan", "alloc", "slow", "doublefree")


class InjectedFault(RuntimeError):
    """Raised by the injector at a scheduled build attempt."""


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``step`` is the 0-based build-attempt index for ``compile`` and the
    0-based session decode-step boundary for everything else; ``times``
    widens the firing window to ``[step, step + times)``; ``row``
    targets an engine row (``nan`` only); ``magnitude`` is the simulated
    extra step time in seconds (``slow`` only).
    """

    kind: str
    step: int
    times: int = 1
    row: int = 0
    magnitude: float = 10.0

    def __post_init__(self):
        """Validate the spec at construction, not at firing time."""
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; choose from {KINDS}")
        if self.step < 0 or self.times < 1 or self.row < 0:
            raise ValueError(
                f"invalid fault spec {self!r}: step/row must be >= 0 "
                f"and times >= 1")


_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<step>\d+)"
    r"(?:x(?P<times>\d+))?(?:\.(?P<row>\d+))?$")


def parse_fault(spec: str) -> FaultSpec:
    """Parse the CLI form ``kind@step[xTIMES][.ROW]``."""
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"cannot parse fault spec {spec!r}: expected "
            f"kind@step[xTIMES][.ROW], e.g. nan@3 or compile@0x3")
    return FaultSpec(kind=m.group("kind"), step=int(m.group("step")),
                     times=int(m.group("times") or 1),
                     row=int(m.group("row") or 0))


class FaultInjector:
    """Fires :class:`FaultSpec`\\ s at the session's injection points.

    Stateless between points except for the build-attempt counter and
    the :attr:`fired` log, so a given (stream, spec set) pair replays
    identically.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        """Take the schedule; nothing fires until the session probes."""
        self.specs: List[FaultSpec] = list(specs)
        self.fired: List[Event] = []
        self._compile_attempts = 0

    @classmethod
    def from_strings(cls, specs: Sequence[str]) -> "FaultInjector":
        """Build from CLI strings (``launch/serve --inject-fault``)."""
        return cls([parse_fault(s) for s in specs])

    def _match(self, kind: str, index: int) -> Optional[FaultSpec]:
        """First spec of ``kind`` whose window covers ``index``."""
        for s in self.specs:
            if s.kind == kind and s.step <= index < s.step + s.times:
                return s
        return None

    def compile_fault(self, what: str) -> None:
        """Raise :class:`InjectedFault` if this build attempt is
        scheduled to fail (each call advances the attempt counter)."""
        i = self._compile_attempts
        self._compile_attempts += 1
        if self._match("compile", i) is not None:
            self.fired.append(Event(kind="compile", step=i,
                                    data={"what": what}))
            raise InjectedFault(
                f"injected compile failure at attempt {i} ({what})")

    def nan_rows(self, step: int) -> List[int]:
        """Engine rows whose logits should be NaN at ``step``."""
        rows = []
        for s in self.specs:
            if s.kind == "nan" and s.step <= step < s.step + s.times:
                rows.append(s.row)
                self.fired.append(Event(kind="nan", step=step,
                                        data={"row": s.row}))
        return rows

    def alloc_blocked(self, step: int) -> bool:
        """True when admission should see an exhausted allocator."""
        if self._match("alloc", step) is not None:
            self.fired.append(Event(kind="alloc", step=step))
            return True
        return False

    def slow_extra_s(self, step: int) -> float:
        """Simulated extra seconds for this step's straggler report."""
        s = self._match("slow", step)
        if s is None:
            return 0.0
        self.fired.append(Event(kind="slow", step=step,
                                data={"extra_s": s.magnitude}))
        return float(s.magnitude)

    def double_free(self, step: int) -> bool:
        """True when a retiring row should free its blocks twice."""
        if self._match("doublefree", step) is not None:
            self.fired.append(Event(kind="doublefree", step=step))
            return True
        return False


__all__ = ["KINDS", "InjectedFault", "FaultSpec", "parse_fault",
           "FaultInjector"]
