"""Declarative serving SLOs with multi-window burn-rate alerting (the
port's copy of ``repro.obs.slo``).

An SLO here is a threshold over one of the serving signals the engine
already measures — TTFT p95, queue-wait p95, a tokens/s floor, or the
terminal error rate — written in a tiny declarative form suitable for
a CLI flag::

    ttft_p95<=0.25      # p95 time-to-first-token at most 250 ms
    queue_p95<=0.10     # p95 queue wait at most 100 ms
    tok_s>=50           # per-step decode throughput floor
    error_rate<=0.05    # non-COMPLETED terminal fraction

Evaluation follows the multi-window burn-rate pattern: every sample is
classified good/bad against the threshold, the bad fraction over a
short and a long sliding window is divided by the SLO's error budget,
and a *page* fires only when **both** windows burn faster than the
alert threshold — the short window gives fast detection, the long
window rejects one-sample blips.  :class:`SLOTracker` exports
``slo.<name>.burn_short`` / ``slo.<name>.burn_long`` / ``slo.<name>.ok``
gauges and emits a structured ``slo_page`` :class:`~repro_torch.obs.events
.Event` (with hysteresis: one page per excursion, re-armed only after
both burn rates drop back under 1.0).
"""

from __future__ import annotations

import dataclasses
import re
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.obs.events import Event

__all__ = ["SLOSpec", "SLOTracker", "parse_slo", "SLO_SIGNALS"]

# Signals an SLO can target, with their comparison direction.
# "upper" — samples must stay at or below the threshold (latencies,
# error rates); "lower" — samples must stay at or above it (throughput
# floors).
SLO_SIGNALS: Dict[str, str] = {
    "ttft_p95": "upper",
    "queue_p95": "upper",
    "tok_s": "lower",
    "error_rate": "upper",
}

_SPEC_RE = re.compile(
    r"^(?P<name>[a-z0-9_]+)\s*(?P<op><=|>=)\s*(?P<value>[0-9.eE+-]+)$")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One parsed SLO: a named signal, a threshold, and a budget.

    ``budget`` is the tolerated bad-sample fraction that defines burn
    rate 1.0.  For percentile-style latency SLOs it defaults to 0.05
    (the p95 convention); for ``error_rate`` the threshold *is* the
    budget.
    """

    name: str
    op: str
    threshold: float
    budget: float

    def bad(self, value: float) -> bool:
        """Whether one sample violates the SLO threshold."""
        if self.op == "<=":
            return value > self.threshold
        return value < self.threshold

    def describe(self) -> str:
        """The spec in its parseable CLI form."""
        return f"{self.name}{self.op}{self.threshold:g}"


def parse_slo(spec: str) -> SLOSpec:
    """Parse one CLI-form SLO spec (``ttft_p95<=0.25``) into a
    :class:`SLOSpec`; raises ``ValueError`` on unknown signals, wrong
    comparison direction, or unparseable text."""
    m = _SPEC_RE.match(spec.strip())
    if m is None:
        raise ValueError(
            f"unparseable SLO spec {spec!r} (expected e.g. ttft_p95<=0.25)")
    name, op = m.group("name"), m.group("op")
    direction = SLO_SIGNALS.get(name)
    if direction is None:
        raise ValueError(
            f"unknown SLO signal {name!r} (known: {sorted(SLO_SIGNALS)})")
    expected = "<=" if direction == "upper" else ">="
    if op != expected:
        raise ValueError(
            f"SLO signal {name!r} takes {expected!r}, got {op!r}")
    threshold = float(m.group("value"))
    if threshold <= 0 and name != "error_rate":
        raise ValueError(f"SLO threshold must be positive: {spec!r}")
    budget = threshold if name == "error_rate" else 0.05
    # A zero budget would make burn rates undefined; clamp to a floor
    # so error_rate<=0 still pages on the first error.
    budget = max(budget, 1e-9)
    return SLOSpec(name=name, op=op, threshold=threshold, budget=budget)


class _SLOState:
    """Sliding-window sample store + page hysteresis for one spec."""

    def __init__(self, spec: SLOSpec, short_window: int,
                 long_window: int) -> None:
        """Create empty windows for ``spec``."""
        self.spec = spec
        self.short: Deque[bool] = deque(maxlen=short_window)
        self.long: Deque[bool] = deque(maxlen=long_window)
        self.paged = False  # True while inside an excursion
        self.pages = 0

    def add(self, value: float) -> None:
        """Classify one sample and push it into both windows."""
        bad = self.spec.bad(value)
        self.short.append(bad)
        self.long.append(bad)

    def burn(self, window: Deque[bool]) -> float:
        """Burn rate of one window: bad fraction over error budget."""
        if not window:
            return 0.0
        frac = sum(window) / len(window)
        return frac / self.spec.budget


class SLOTracker:
    """Evaluates a set of :class:`SLOSpec` over serving samples.

    Feed samples with :meth:`sample`; call :meth:`evaluate` at step
    boundaries to refresh gauges and collect any newly fired
    ``slo_page`` events.  ``metrics`` (a
    :class:`~repro_torch.obs.metrics.MetricsRegistry`) is optional — with
    ``None`` the tracker still pages, it just exports nothing.
    """

    def __init__(self, specs, *, short_window: int = 8,
                 long_window: int = 32, burn_threshold: float = 2.0,
                 min_samples: int = 4, metrics=None) -> None:
        """Configure windows, the paging threshold, and the exporter."""
        self.specs: List[SLOSpec] = [
            parse_slo(s) if isinstance(s, str) else s for s in specs]
        self.burn_threshold = float(burn_threshold)
        self.min_samples = int(min_samples)
        self.metrics = metrics
        self._states: Dict[str, _SLOState] = {
            spec.name: _SLOState(spec, short_window, long_window)
            for spec in self.specs}

    def sample(self, name: str, value: float) -> None:
        """Feed one sample for signal ``name`` (ignored if no SLO
        targets that signal)."""
        state = self._states.get(name)
        if state is not None:
            state.add(float(value))

    def evaluate(self, step: Optional[int] = None) -> List[Event]:
        """Refresh ``slo.*`` gauges and return newly fired page events.

        A page fires when both the short- and long-window burn rates
        exceed ``burn_threshold`` and at least ``min_samples`` samples
        have been seen; it re-arms once both rates drop below 1.0.
        """
        events: List[Event] = []
        for name, state in self._states.items():
            burn_s = state.burn(state.short)
            burn_l = state.burn(state.long)
            ok = not (burn_s > 1.0 and burn_l > 1.0)
            if self.metrics is not None:
                self.metrics.gauge(
                    f"slo.{name}.burn_short",
                    help="short-window SLO burn rate").set(burn_s)
                self.metrics.gauge(
                    f"slo.{name}.burn_long",
                    help="long-window SLO burn rate").set(burn_l)
                self.metrics.gauge(
                    f"slo.{name}.ok",
                    help="1 while the SLO is within budget").set(
                        1.0 if ok else 0.0)
            enough = len(state.long) >= self.min_samples
            firing = (enough and burn_s > self.burn_threshold
                      and burn_l > self.burn_threshold)
            if firing and not state.paged:
                state.paged = True
                state.pages += 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "slo.pages_total",
                        help="SLO burn-rate pages fired").inc()
                events.append(Event(
                    kind="slo_page", step=step,
                    data={"slo": state.spec.describe(),
                          "signal": name,
                          "burn_short": burn_s,
                          "burn_long": burn_l,
                          "threshold": state.spec.threshold}))
            elif state.paged and burn_s < 1.0 and burn_l < 1.0:
                state.paged = False  # excursion over: re-arm
        return events

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-SLO summary: burn rates, page count, sample count."""
        out: Dict[str, Dict[str, float]] = {}
        for name, state in self._states.items():
            out[name] = {
                "spec": state.spec.describe(),
                "burn_short": state.burn(state.short),
                "burn_long": state.burn(state.long),
                "pages": state.pages,
                "samples": len(state.long),
                "paged": state.paged,
            }
        return out
