"""Metrics registry: counters, gauges, and fixed-bucket histograms (the
port's copy of ``repro.obs.metrics``: same names, same exports).

One ``MetricsRegistry`` holds every instrument the stack emits —
tuner sweeps, dispatch convergence, executable-cache hits, serving
lifecycle latencies, allocator occupancy.  Instruments are created
lazily on first access and are cheap enough to touch on hot paths
(one dict lookup + one float add).

Two exporters cover both operational shapes:

* ``to_prometheus()`` — Prometheus text exposition format (``# HELP``
  / ``# TYPE`` lines, ``_bucket``/``_sum``/``_count`` histogram
  series).  Dotted metric names are sanitised to underscores because
  Prometheus identifiers cannot contain ``.``.
* ``snapshot()`` — a plain JSON-serialisable dict for tests and
  summaries.

A process-wide default instance is reachable through
``get_metrics_registry()`` / ``set_metrics_registry()`` — the same
singleton pattern ``runtime.dispatch`` uses for its service — so
library code can record without threading a registry through every
call site, while tests inject a fresh one.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_metrics_registry",
    "set_metrics_registry",
    "prom_name",
]

# Default histogram buckets: latency-shaped, seconds.  Spans 100 µs to
# ~1 min which covers every timing in the stack (decode steps, TTFT,
# compiles, sweeps).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def prom_name(name: str) -> str:
    """Sanitise a dotted metric name into a Prometheus identifier."""
    s = "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
    if s and s[0].isdigit():
        s = "_" + s
    return s


class Counter:
    """Monotonically increasing count (events, hits, misses)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        """Create a zero-valued counter called ``name``."""
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` (must be >= 0) to the counter."""
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def as_dict(self) -> Dict[str, object]:
        """JSON-serialisable view of the counter."""
        return {"type": self.kind, "value": self.value, "help": self.help}


class Gauge:
    """Point-in-time value that can move both ways (occupancy, ratios)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        """Create a zero-valued gauge called ``name``."""
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, value: float) -> None:
        """Overwrite the gauge with ``value``."""
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` to the gauge."""
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        """Subtract ``amount`` from the gauge."""
        self.value -= amount

    def as_dict(self) -> Dict[str, object]:
        """JSON-serialisable view of the gauge."""
        return {"type": self.kind, "value": self.value, "help": self.help}


class Histogram:
    """Fixed-bucket histogram of observations (latency distributions).

    Buckets are cumulative upper bounds in the Prometheus style: an
    observation lands in every bucket whose bound is >= the value,
    plus the implicit ``+Inf`` bucket.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None) -> None:
        """Create an empty histogram with sorted ``buckets`` bounds."""
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        self.counts: List[int] = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        """Record one observation."""
        v = float(value)
        self.sum += v
        self.count += 1
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """Cumulative ``(upper_bound, count)`` pairs, +Inf last."""
        out: List[Tuple[float, int]] = []
        running = 0
        for bound, n in zip(self.buckets, self.counts):
            running += n
            out.append((bound, running))
        out.append((float("inf"), running + self.counts[-1]))
        return out

    def as_dict(self) -> Dict[str, object]:
        """JSON-serialisable view of the histogram."""
        return {
            "type": self.kind,
            "help": self.help,
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


class MetricsRegistry:
    """Lazily-created named instruments plus the two exporters."""

    def __init__(self) -> None:
        """Create an empty registry."""
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, help: str, **kwargs):
        """Return the instrument called ``name``, creating it if new."""
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, help=help, **kwargs)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        """Get or create the counter called ``name``."""
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        """Get or create the gauge called ``name``."""
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Get or create the histogram called ``name``."""
        return self._get(name, Histogram, help, buckets=buckets)

    def names(self) -> List[str]:
        """Sorted names of every registered instrument."""
        return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-serialisable dict of every instrument's state."""
        return {name: self._instruments[name].as_dict()
                for name in self.names()}

    def to_prometheus(self) -> str:
        """Render the registry in Prometheus text exposition format."""
        lines: List[str] = []
        for name in self.names():
            inst = self._instruments[name]
            pname = prom_name(name)
            if inst.help:
                lines.append(f"# HELP {pname} {inst.help}")
            lines.append(f"# TYPE {pname} {inst.kind}")
            if isinstance(inst, Histogram):
                for bound, cum in inst.cumulative():
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{pname}_sum {inst.sum!r}")
                lines.append(f"{pname}_count {inst.count}")
            else:
                lines.append(f"{pname} {inst.value!r}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        """Write ``to_prometheus()`` to ``path``."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_prometheus())

    def set_gauges(self, values: Dict[str, float], prefix: str = "",
                   help: str = "") -> None:
        """Bulk-set gauges from a ``{name: numeric}`` dict.

        Non-numeric values are skipped, so callers can feed raw stats
        dicts (e.g. ``TuningRegistry.stats()``) without filtering.
        """
        for key, value in values.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                continue
            self.gauge(prefix + key, help=help).set(float(value))


_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def get_metrics_registry() -> MetricsRegistry:
    """Process-wide default registry (library code records here)."""
    return _default_registry


def set_metrics_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide default registry; returns the previous one."""
    global _default_registry
    with _default_lock:
        prev = _default_registry
        _default_registry = registry
    return prev
