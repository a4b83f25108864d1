"""Observability of the port (its copy of ``repro.obs``).

* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges,
  fixed-bucket histograms, with Prometheus-text and JSON exporters and
  a process-wide default instance.
* :class:`~repro_torch.obs.trace.SpanTracer` — context-manager spans
  with an injected monotonic clock, exported as Chrome trace-event /
  Perfetto-loadable JSON.
* :class:`~repro_torch.obs.lifecycle.LifecycleLog` — per-request
  timelines (queued → admitted → first token → terminal) with derived
  TTFT and per-token latency.
* :class:`~repro_torch.obs.events.Event` — the structured event schema
  the session, the fault injector and the straggler monitor share.

:class:`~repro_torch.obs.telemetry.Telemetry` bundles the first three
behind one ``telemetry=`` parameter; :data:`~repro_torch.obs.telemetry.
NULL_TELEMETRY` is the shared disabled instance every component
defaults to.

The reactive layer on top:

* :class:`~repro_torch.obs.watchdog.PerformanceWatchdog` — online drift
  detection over dispatch step times (reopening drifted slots for
  re-tuning) plus declarative SLOs (:mod:`repro_torch.obs.slo`) with
  multi-window burn-rate paging.
* :class:`~repro_torch.obs.recorder.FlightRecorder` — a bounded ring of
  recent events, spans and metric values, dumped as a deterministic
  ``postmortem-<reason>.json`` bundle on faults, SLO pages and drift
  alarms.

Metric names, span names and both exporters are the JAX package's, so
the same calls give byte-equal exports and ``tools/check_trace.py``
reads either package's artifacts.  Pure Python: no torch, no JAX.
"""

from repro_torch.obs.events import (
    Event,
    format_event_summary,
    summarize_events,
)
from repro_torch.obs.lifecycle import LifecycleLog, RequestLifecycle
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_metrics_registry,
    prom_name,
    set_metrics_registry,
)
from repro_torch.obs.recorder import POSTMORTEM_KINDS, FlightRecorder
from repro_torch.obs.slo import SLOSpec, SLOTracker, parse_slo
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.obs.trace import NullTracer, SpanTracer
from repro_torch.obs.watchdog import PerformanceWatchdog

__all__ = [
    "Counter",
    "Event",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LifecycleLog",
    "MetricsRegistry",
    "NULL_TELEMETRY",
    "NullTracer",
    "POSTMORTEM_KINDS",
    "PerformanceWatchdog",
    "RequestLifecycle",
    "SLOSpec",
    "SLOTracker",
    "SpanTracer",
    "Telemetry",
    "format_event_summary",
    "get_metrics_registry",
    "parse_slo",
    "prom_name",
    "set_metrics_registry",
    "summarize_events",
]
