"""Fault tolerance: straggler detection and restartable execution (port
of ``repro.runtime.ft``).

:class:`StragglerMonitor` keeps an EWMA of step time and flags outliers
for the serving engine and the train loop; its caller decides what to do
about one (the session counts it and may hold admission for a few step
boundaries).  It takes no hook, where the JAX monitor takes
``on_straggler``: the caller reads the event
:meth:`StragglerMonitor.record` returns (a hook bound to the session
would make the session cyclic garbage, freed by the collector at any
time, possibly in the middle of a CUDA graph capture).
:func:`run_with_restart` is the launcher's retry loop around a training
run that restores from its latest checkpoint.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional

from repro_torch.obs.events import Event

log = logging.getLogger("repro_torch.ft")


class StragglerMonitor:
    """EWMA step-time outlier detector.

    ``record(step, duration)`` returns a straggler :class:`Event`
    (``data`` carries ``duration_s``/``ewma_s``/``ratio``) when
    ``duration`` exceeds ``threshold ×`` the running EWMA, after
    ``warmup_steps``; an outlier never updates the EWMA, so one spike
    does not raise the bar for the next.
    """

    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup_steps: int = 5):
        """Set the detection knobs; no state until :meth:`record`."""
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup_steps
        self.ewma: Optional[float] = None
        self.events: List[Event] = []
        self._n = 0

    def record(self, step: int, duration: float) -> Optional[Event]:
        """Feed one step time; returns the event if it was an outlier."""
        self._n += 1
        if self.ewma is None:
            self.ewma = duration
            return None
        if self._n > self.warmup and duration > self.threshold * self.ewma:
            event = Event(kind="straggler", step=step,
                          data={"duration_s": float(duration),
                                "ewma_s": float(self.ewma),
                                "ratio": float(duration / self.ewma)})
            self.events.append(event)
            log.warning("straggler step %d: %.3fs vs ewma %.3fs (x%.1f)",
                        step, duration, self.ewma, event.ratio)
            return event
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        return None

    def summary(self) -> Dict[str, float]:
        """JSON-ready snapshot: steps seen, current EWMA, event count."""
        return {"steps": float(self._n),
                "ewma_s": float(self.ewma or 0.0),
                "events": float(len(self.events))}

    def export_metrics(self, registry, prefix: str = "serve.straggler.",
                       ) -> None:
        """Publish :meth:`summary` as gauges on a
        :class:`~repro_torch.obs.metrics.MetricsRegistry`."""
        registry.set_gauges(self.summary(), prefix=prefix,
                            help="straggler-monitor snapshot")


def run_with_restart(make_state: Callable[[], Dict],
                     run: Callable[[Dict], None],
                     max_restarts: int = 3,
                     retriable: tuple = (RuntimeError,)) -> int:
    """Launcher-level retry loop: (re)build the state (which restores
    from the latest checkpoint) and run it; on a ``retriable`` failure,
    rebuild and go on, up to ``max_restarts`` times (then the failure
    propagates).  Returns the number of restarts used."""
    restarts = 0
    while True:
        state = make_state()
        try:
            run(state)
            return restarts
        except retriable as e:  # noqa: PERF203
            restarts += 1
            log.warning("run failed (%s); restart %d/%d", e, restarts,
                        max_restarts)
            if restarts > max_restarts:
                raise


__all__ = ["StragglerMonitor", "run_with_restart"]
