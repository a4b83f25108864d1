"""The ``Telemetry`` bundle: metrics + tracer + lifecycle log (the port's
copy of ``repro.obs.telemetry``).

Instrumented components (``ServeSession``, ``DispatchService``, the
launcher) take one ``telemetry=`` object instead of three
separate handles.  ``NULL_TELEMETRY`` is the shared disabled instance:
its ``enabled`` flag is ``False`` and every instrumentation site
guards on that flag before touching the tracer or lifecycle log, so a
telemetry-off run pays one attribute check per site and nothing else
(the null fast path asserted in ``tests/test_torch_obs.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.obs.lifecycle import LifecycleLog
from repro_torch.obs.metrics import MetricsRegistry, get_metrics_registry
from repro_torch.obs.trace import NullTracer, SpanTracer

__all__ = ["Telemetry", "NULL_TELEMETRY"]


class Telemetry:
    """Live telemetry: a metrics registry, a span tracer, a lifecycle
    log, and the clock they share."""

    enabled = True

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 clock: Optional[Callable[[], float]] = None,
                 watchdog=None, recorder=None) -> None:
        """Build a live bundle.

        ``metrics`` defaults to the process-wide registry; ``tracer``
        defaults to a fresh :class:`SpanTracer` on ``clock`` (which
        defaults to ``time.perf_counter``, and is the handle tests use
        to make traces deterministic).  ``watchdog`` (a
        :class:`~repro_torch.obs.watchdog.PerformanceWatchdog`) and
        ``recorder`` (a :class:`~repro_torch.obs.recorder.FlightRecorder`)
        are optional reactive components — both default to ``None``
        (pure measurement, no reaction); components that accept a
        bundle pick them up from here unless handed one explicitly.
        """
        self.clock = clock if clock is not None else time.perf_counter
        self.metrics = metrics if metrics is not None else get_metrics_registry()
        self.tracer = tracer if tracer is not None else SpanTracer(clock=self.clock)
        self.lifecycle = LifecycleLog()
        self.watchdog = watchdog
        self.recorder = recorder


class _NullTelemetry(Telemetry):
    """Disabled bundle behind ``NULL_TELEMETRY``; never record through
    it — guarded call sites skip it entirely."""

    enabled = False

    def __init__(self) -> None:
        """Build the shared disabled instance."""
        self.clock = time.perf_counter
        self.metrics = MetricsRegistry()  # inert scratch, never exported
        self.tracer = NullTracer()
        self.lifecycle = LifecycleLog()
        self.watchdog = None
        self.recorder = None


NULL_TELEMETRY = _NullTelemetry()
