"""Performance watchdog: online drift detection + SLO burn tracking (the
port's copy of ``repro.obs.watchdog``).

The thesis' closing argument is that a tuned schedule is only optimal
until the workload shifts, so a production system must *measure
continuously and react*.  The telemetry modules are the measurement
half (spans, metrics, lifecycle timelines); this module is the
reactive half — it
consumes those streams online and closes the observe→react loop:

* **Drift detection** — per-slot EWMA + rolling-window baselines over
  the step times :class:`~repro_torch.runtime.dispatch.DispatchService`
  observes, compared against the committed schedule's expected time
  (measured commit median, registry ``time_s``, or the cost-model
  prediction — see ``DispatchService.baseline_time``).  A sustained
  breach past a configurable ratio threshold emits a structured
  ``drift`` :class:`~repro_torch.obs.events.Event`, increments
  ``watchdog.drift_total``, and flips the slot back to exploration via
  ``DispatchService.reopen`` so the selector re-tunes and can commit a
  better winner.  Hysteresis (a post-reopen cooldown) plus a per-slot
  re-tune budget bound flapping.
* **SLO tracking** — delegates to :class:`~repro_torch.obs.slo.SLOTracker`:
  declarative specs over TTFT p95 / queue p95 / tok/s floor / error
  rate, multi-window burn-rate paging, ``slo.*`` gauges.

The watchdog is wired one of two ways: ``ServeSession`` binds it at
construction (``watchdog=`` parameter) and feeds it at step
boundaries (the port's session binds no ``on_event``: it records the
events :meth:`PerformanceWatchdog.observe_slot` and
:meth:`PerformanceWatchdog.tick` return, so that no bound method of the
session makes it cyclic garbage), or :meth:`PerformanceWatchdog.attach`
hooks it directly onto a ``DispatchService`` for loops that drive
``observe()`` themselves.  With no watchdog bound the serving engine executes the
exact same instruction stream as before — every tap is behind an
``is not None`` guard.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from repro_torch.obs.events import Event
from repro_torch.obs.slo import SLOTracker

__all__ = ["PerformanceWatchdog"]


def _median(values) -> float:
    """Median of a non-empty sequence without a numpy dependency."""
    s = sorted(values)
    n = len(s)
    mid = n // 2
    if n % 2:
        return float(s[mid])
    return float((s[mid - 1] + s[mid]) / 2.0)


class _SlotWatch:
    """Per-slot drift state: EWMA, rolling window, streak, budget."""

    def __init__(self, window: int) -> None:
        """Create idle state with an empty ``window``-sample history."""
        self.ewma: Optional[float] = None
        self.recent: Deque[float] = deque(maxlen=window)
        self.streak = 0
        self.reopens = 0
        self.drifts = 0
        self.cooldown_left = 0

    def update_ewma(self, dt: float, alpha: float) -> float:
        """Fold one sample into the EWMA and return the new value."""
        self.ewma = (dt if self.ewma is None
                     else (1.0 - alpha) * self.ewma + alpha * dt)
        return self.ewma


class PerformanceWatchdog:
    """Closes the observe→react loop over dispatch + serving telemetry.

    Parameters
    ----------
    slos:
        Iterable of SLO specs (strings in the ``ttft_p95<=0.25`` CLI
        form or :class:`~repro_torch.obs.slo.SLOSpec` instances).
    ratio:
        Drift threshold: a step counts as breaching when its time
        exceeds ``ratio ×`` the committed baseline.
    patience:
        Consecutive breaching observations required before a ``drift``
        alarm fires (sustained breach, not a one-step blip).
    cooldown:
        Observations to ignore per slot after a reopen — the selector
        is re-probing candidates, so times are expected to be noisy
        (hysteresis).
    retune_budget:
        Maximum reopens per slot per session; past the budget drift
        alarms still fire but no longer reopen (bounded flapping).
    window:
        Rolling-window length for the measured-time percentile that
        drift events report.
    ewma_alpha:
        Smoothing factor for the per-slot EWMA; both the raw step time
        and the EWMA must breach before the streak advances.
    """

    def __init__(self, slos=(), *, ratio: float = 3.0, patience: int = 3,
                 cooldown: int = 8, retune_budget: int = 2,
                 window: int = 64, ewma_alpha: float = 0.5,
                 short_window: int = 8, long_window: int = 32,
                 burn_threshold: float = 2.0, min_samples: int = 4,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None, dispatch=None,
                 on_event: Optional[Callable[[Event], None]] = None) -> None:
        """Configure thresholds and (optionally) pre-bind collaborators."""
        self.ratio = float(ratio)
        self.patience = int(patience)
        self.cooldown = int(cooldown)
        self.retune_budget = int(retune_budget)
        self.window = int(window)
        self.ewma_alpha = float(ewma_alpha)
        self.clock = clock
        self.metrics = metrics
        self.dispatch = dispatch
        self.on_event = on_event
        self.slo = SLOTracker(slos, short_window=short_window,
                              long_window=long_window,
                              burn_threshold=burn_threshold,
                              min_samples=min_samples, metrics=metrics)
        self.events: List[Event] = []
        self._slots: Dict[str, _SlotWatch] = {}
        self._hook_obs = 0

    # -- wiring ----------------------------------------------------------

    def bind(self, *, dispatch=None, clock=None, on_event=None,
             metrics=None) -> None:
        """Late wiring (``ServeSession`` calls this at construction).

        Explicitly constructed attributes win: a clock or metrics
        registry passed to ``__init__`` is never overwritten, so tests
        can inject a fake clock before handing the watchdog to a
        session.
        """
        if dispatch is not None and self.dispatch is None:
            self.dispatch = dispatch
        if clock is not None and self.clock is None:
            self.clock = clock
        if on_event is not None and self.on_event is None:
            self.on_event = on_event
        if metrics is not None and self.metrics is None:
            self.metrics = metrics
            self.slo.metrics = metrics

    def attach(self, dispatch) -> None:
        """Standalone mode: subscribe to every ``dispatch.observe()``
        via the service's predicted-vs-measured hook (loops that drive
        dispatch directly, without a serving session)."""
        self.dispatch = dispatch
        dispatch.on_observe = self._dispatch_hook

    def _dispatch_hook(self, slot: str, kind: str, dt: float) -> None:
        """``DispatchService.on_observe`` adapter (standalone mode)."""
        self._hook_obs += 1
        self.observe_slot(slot, kind, dt, step=self._hook_obs)

    # -- drift detection --------------------------------------------------

    def observe_slot(self, slot: str, kind: str, dt: float,
                     step: Optional[int] = None) -> Optional[Event]:
        """Feed one measured step time for a dispatch slot.

        Returns the ``drift`` event when this observation completes a
        sustained breach, else ``None``.  Only committed slots are
        judged — while the selector is probing there is no baseline to
        drift from.
        """
        state = self._slots.get(slot)
        if state is None:
            state = self._slots[slot] = _SlotWatch(self.window)
        state.recent.append(dt)
        ewma = state.update_ewma(dt, self.ewma_alpha)
        dispatch = self.dispatch
        if dispatch is None or not dispatch.is_committed(slot):
            state.streak = 0
            return None
        if state.cooldown_left > 0:
            state.cooldown_left -= 1
            return None
        baseline = dispatch.baseline_time(slot)
        if baseline is None or baseline <= 0.0:
            state.streak = 0
            return None
        limit = self.ratio * baseline
        if dt > limit and ewma > limit:
            state.streak += 1
        else:
            state.streak = 0
        if state.streak < self.patience:
            return None
        return self._alarm(slot, kind, state, baseline, step)

    def _alarm(self, slot: str, kind: str, state: _SlotWatch,
               baseline: float, step: Optional[int]) -> Event:
        """Fire a drift alarm: emit the event, reopen within budget."""
        measured = _median(list(state.recent)[-self.patience:])
        old = None
        dispatch = self.dispatch
        if dispatch is not None:
            old = dispatch.committed_schedule(slot)
        reopened = False
        if dispatch is not None and state.reopens < self.retune_budget:
            reopened = dispatch.reopen(slot)
            if reopened:
                state.reopens += 1
        state.drifts += 1
        state.streak = 0
        state.cooldown_left = self.cooldown
        state.ewma = None
        state.recent.clear()
        if self.metrics is not None:
            self.metrics.counter(
                "watchdog.drift_total",
                help="sustained drift alarms fired").inc()
            if reopened:
                self.metrics.counter(
                    "watchdog.reopens_total",
                    help="slots flipped back to exploration").inc()
        event = Event(
            kind="drift", step=step,
            data={"slot": slot, "kernel_kind": kind,
                  "baseline_s": baseline, "measured_s": measured,
                  "ratio": (measured / baseline if baseline else None),
                  "reopened": reopened, "old_schedule": old,
                  "reopens_used": state.reopens,
                  "retune_budget": self.retune_budget})
        self._emit(event)
        return event

    # -- SLO sample taps ---------------------------------------------------

    def note_ttft(self, seconds: float) -> None:
        """Feed one time-to-first-token sample (admission tap)."""
        self.slo.sample("ttft_p95", seconds)

    def note_queue(self, seconds: float) -> None:
        """Feed one queue-wait sample (retire tap)."""
        self.slo.sample("queue_p95", seconds)

    def note_terminal(self, ok: bool) -> None:
        """Feed one terminal outcome (``ok`` = completed normally)."""
        self.slo.sample("error_rate", 0.0 if ok else 1.0)

    def note_step(self, tokens: int, dt: float) -> None:
        """Feed one engine step (tokens emitted + wall seconds)."""
        if dt > 0.0:
            self.slo.sample("tok_s", tokens / dt)

    def tick(self, step: Optional[int] = None) -> List[Event]:
        """Step-boundary evaluation: refresh SLO gauges, emit pages.

        Returns the newly fired events (already routed through the
        ``on_event`` sink) so callers can react inline if they want.
        """
        events = self.slo.evaluate(step)
        for ev in events:
            self._emit(ev)
        if self.metrics is not None:
            self.metrics.gauge(
                "watchdog.slots_watched",
                help="dispatch slots under drift watch").set(
                    float(len(self._slots)))
        return events

    # -- reporting ---------------------------------------------------------

    def _emit(self, event: Event) -> None:
        """Stamp, record, and route one watchdog event."""
        if event.ts is None and self.clock is not None:
            event.ts = self.clock()
        self.events.append(event)
        if self.on_event is not None:
            self.on_event(event)

    def drift_count(self) -> int:
        """Total drift alarms fired across all slots."""
        return sum(s.drifts for s in self._slots.values())

    def reopen_count(self) -> int:
        """Total reopens performed across all slots."""
        return sum(s.reopens for s in self._slots.values())

    def report(self) -> Dict[str, Any]:
        """Structured summary for CLI lines and postmortem bundles."""
        slots = {}
        for slot, state in sorted(self._slots.items()):
            slots[slot] = {
                "drifts": state.drifts,
                "reopens": state.reopens,
                "streak": state.streak,
                "cooldown_left": state.cooldown_left,
                "observations": len(state.recent),
            }
        return {
            "drifts": self.drift_count(),
            "reopens": self.reopen_count(),
            "retune_budget": self.retune_budget,
            "ratio": self.ratio,
            "patience": self.patience,
            "slots": slots,
            "slo": self.slo.report(),
        }
