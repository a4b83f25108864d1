"""ServeSession: the serving engine of the dense, moe and ssm families
(port of ``repro.serving.session``).

Requests are submitted to a queue and served by :meth:`ServeSession.drain`.
Greedy traffic runs the **in-flight engine** (:meth:`_drain_inflight`): a
step loop over a fixed set of engine rows.  For the attention families
(dense and moe) the rows are backed by a block-paged KV pool
(:mod:`repro_torch.serving.paged_kv`); at every step boundary the engine

1. retires finished rows (and rows a client cancelled or whose deadline
   passed, with their partial tokens) and frees their KV blocks,
2. compacts the pool when its fragmentation passes 1/2,
3. sweeps the queue (cancellations, blown deadlines, ``max_queue_s``
   shedding) and admits queued requests in FIFO order while a row is
   free and the allocator fits the request's whole ``prompt + budget -
   1`` footprint: a batch-1 left-padded masked prefill (flash
   attention), whose prompt K/V is scattered into the row's pool
   blocks, and
4. runs one paged ``decode_step`` over all rows (paged decode
   attention).

For the ssm family a row's state is O(1): there is no allocator, block
table or compaction.  The pool is ``init_cache(rows, cap)``; admission
runs the same batch-1 masked prefill (the selective-scan kernel) and
writes the row's final SSM and conv states into row ``r`` of every
layer, in place; each boundary runs one recurrent ``decode_step`` over
all rows.

Sampled traffic (``temperature > 0``) runs the **bucketed path**
(:meth:`_drain_batched`): the head of the queue's prompt bucket picks a
(batch, padded-length) bucket, the group is left-padded to it (pad rows
fully masked) and served to completion by :meth:`run_batch`, the body
of ``runtime.serve_loop.generate``: a batched masked prefill, then one
contiguous decode step a token (the contiguous decode kernel, or the
scan).  A sampled step draws each row's token from ``softmax(logits /
T)`` by the Gumbel-max rule, on uniform noise drawn outside the step
from the caller's ``torch.Generator`` (else one seeded 0 a call, as the
JAX package takes ``jax.random.key(0)``); its key carries the detail
:data:`~repro_torch.serving.captured.SAMPLED`.

The prefill and decode steps come from the session's
:class:`~repro_torch.serving.cache.ExecutableCache`, keyed as the JAX
session keys them: one batch-1 prefill step per prompt bucket, shared
by every activation and by ``run_batch``, and one decode step per
engine geometry and bundle, whose entry owns the pool (a CUDA graph
holds its addresses; it is zeroed at each activation's start, so a run
equals one on a fresh pool).  Every decode step of one geometry holds
the same pool, whichever bundle it was built with and whether the
engine or ``run_batch`` built it: an activation finds the pool through
any of them (``ExecutableCache.peek_geometry``), makes a new one only
when none is cached, and raises if the step it runs holds another.

With a :class:`~repro_torch.runtime.dispatch.DispatchService`
(``dispatch=``) the engine picks each activation's rows by the
service's decode step times (``_bucket_step_time``: measured, else
predicted), observes every prefill and decode step under its kernel
shape and, with ``backend="cuda"``, keys and launches its steps with a
:class:`~repro_torch.core.schedule.ScheduleBundle`: one per prompt
bucket for the prefills, one for the activation's decode step.  When
the service commits a decode winner other than the running bundle's,
the engine switches to the new key's step if it is cached
(``free_switches``), else recaptures it once over the live pool
(``recompiles``, at most ``max_recompiles`` a run; its time is kept out
of ``decode_s``), else keeps the step pinned; each such commit counts
in ``commits_seen`` (``serve_loop.switch_on_commit``).  Every
observation times the deployed step, not the candidate it is
attributed to (the JAX engine's semantics).  With ``registry=`` every
activation and every ``run_batch`` call writes a ``serve_decode``
measurement back under ``runtime_fingerprint(device)``.

On a card each step is a captured CUDA graph
(:class:`~repro_torch.serving.captured.CapturedStep`); ``capture=False``
runs the same steps eagerly, and on the CPU they always run directly.
A step's tokens, positions and block tables go in through pinned
buffers, and its token and finiteness flags come out in one copy to the
host a step.

Every request ends in a terminal :class:`RequestState` with a reason
(the operator contract of the JAX package's ``docs/SERVING.md``
§Failure semantics, as far as it is ported):

* REJECTED — the KV footprint can never fit the pool;
* TIMED_OUT — ``deadline_s`` blown (queued, or mid-decode with partial
  tokens), or shed by ``max_queue_s`` while queued;
* CANCELLED — :meth:`ServeSession.cancel` (partial tokens if decoding);
* FAILED — the row's logits were not finite (the step's device flag),
  partial tokens; or its prefill raised (that admission only); or the
  decode step it was in raised (every row in flight, partial tokens;
  the queue is kept and served on).

A step that raises is contained only while the card stays usable: the
session synchronises the device after catching it, and an error that
sticks to the CUDA context (an illegal address, a device-side assert)
raises the step's error, chained, and contains nothing.  ``run_batch``
catches nothing, as in the JAX package.

A build (warm-up and capture) is retried ``compile_retries`` times.
Then it counts a fallback (``stats.fallbacks``,
``serve.aot_fallbacks_total``) and a ``compile_failure`` event, and
``fallback_backend`` decides: ``"none"`` (the default) raises out of
:meth:`drain`; ``"eager"`` degrades the bucket: its step is built again
on the session's backend, uncaptured, under the same key (``degraded``
event and warning, ``stats.degraded``, ``degraded_buckets``), over the
same pool or state, with retries; if that build fails too (a second
fallback and ``compile_failure``), the same uncaptured step runs all
the same, the counterpart of the JAX session's un-lowered jit step.  A
degraded step launches the same kernels, one launch per op instead of
a graph replay.

A :class:`~repro_torch.runtime.ft.StragglerMonitor` watches the step
times (``on_straggler`` may hold admission for some boundaries), and a
:class:`~repro_torch.serving.faults.FaultInjector` (``faults=``) fires
each fault deterministically.

Observability (:mod:`repro_torch.obs`, the JAX session's taps at the
same points): ``telemetry`` (a :class:`~repro_torch.obs.telemetry.
Telemetry`) receives the ``serve.*`` counters, gauges and histograms,
the spans ``serve.step``, ``serve.admit``, ``serve.prefill``,
``serve.decode_step``, ``serve.compact``, ``serve.activation``,
``serve.decode`` and ``serve.aot_compile`` (here a build: warm-up and
capture) and one lifecycle record and async track per request; a
``watchdog`` (:class:`~repro_torch.obs.watchdog.PerformanceWatchdog`)
judges the decode slot's step times, fault-injected slowdowns included,
and the SLO samples, and may reopen a drifted slot; a ``recorder``
(:class:`~repro_torch.obs.recorder.FlightRecorder`) taps the event
ledger and the step spans and dumps ``postmortem-<reason>.json`` on
every event of ``POSTMORTEM_KINDS``.  Every tap runs on the host after
the step's one copy to the host; none enters a captured graph.  With
all three off the engine runs the same instruction stream on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import registry as reg
from repro_torch.models.attention import BACKENDS
from repro_torch.models.model_zoo import (Model, bucket_length,
                                          left_pad_prompts, prompt_starts)
from repro_torch.models.transformer import (ATTENTION_FAMILIES,
                                            SERVED_FAMILIES)
from repro_torch.obs.events import Event
from repro_torch.obs.recorder import POSTMORTEM_KINDS
from repro_torch.obs.telemetry import NULL_TELEMETRY
from repro_torch.runtime.ft import StragglerMonitor
from repro_torch.serving.bucketing import (Bucket, candidate_buckets,
                                           pick_bucket)
from repro_torch.serving.cache import ExecKey, ExecutableCache
from repro_torch.serving.captured import (SAMPLED, CapturedStep,
                                          contiguous_decode_step,
                                          prefill_step,
                                          recurrent_decode_step,
                                          step_inputs, step_pick)
from repro_torch.serving.paged_kv import BlockAllocator, blocks_needed

log = logging.getLogger("repro_torch.serving")

_REQUEST_IDS = itertools.count()
# the bucket of a result that never reached an engine row
_NULL_BUCKET = Bucket(0, 0, 0)
# the span of every site while telemetry is off (one shared no-op)
_NULL_SPAN = contextlib.nullcontext()
# what a build that failed every attempt falls back to
FALLBACK_BACKENDS = ("eager", "none")


class RequestState:
    """The terminal states of a request.

    * ``COMPLETED`` — full decode budget delivered.
    * ``REJECTED`` — the request's KV footprint exceeds the whole pool.
    * ``TIMED_OUT`` — ``deadline_s`` blown (queued or mid-decode, with
      partial tokens) or shed by ``max_queue_s`` while queued.
    * ``CANCELLED`` — :meth:`ServeSession.cancel` (partial tokens when
      the request was already decoding).
    * ``FAILED`` — non-finite logits retired the row (partial tokens),
      or its prefill or decode step raised.
    """

    COMPLETED = "COMPLETED"
    REJECTED = "REJECTED"
    TIMED_OUT = "TIMED_OUT"
    CANCELLED = "CANCELLED"
    FAILED = "FAILED"


@dataclasses.dataclass
class Request:
    """One submitted generation request (a single sequence)."""

    tokens: np.ndarray              # [S] int32 prompt
    max_new_tokens: int
    request_id: str
    submitted_at: float             # session clock at submission
    deadline_s: Optional[float] = None  # submit -> last token budget


@dataclasses.dataclass
class RequestResult:
    """Per-request outcome returned by :meth:`ServeSession.drain`.

    ``state`` is a terminal :class:`RequestState`; for anything but
    ``COMPLETED`` the ``tokens`` may be partial or empty (never
    admitted) and ``reason`` says why."""

    request_id: str
    tokens: np.ndarray              # [<= max_new_tokens] int32
    bucket: Bucket
    queue_s: float                  # submission -> admission
    stats: Any                      # the activation's ServeStats (shared)
    state: str = RequestState.COMPLETED
    reason: Optional[str] = None


@dataclasses.dataclass
class SessionStats:
    """What the engine did, over the session's life."""

    requests: int = 0
    batches: int = 0                # engine activations + run_batch calls
    tokens_generated: int = 0       # every delivered token
    decode_tokens: int = 0          # tokens made by decode steps only
    prefill_s: float = 0.0
    decode_s: float = 0.0
    steps: int = 0                  # engine decode steps
    inflight_admissions: int = 0    # requests admitted at step boundaries
    compactions: int = 0            # pool defragmentation passes
    fallbacks: int = 0              # builds that failed every attempt
    compile_retries: int = 0        # failed builds that were retried
    degraded: bool = False          # a bucket fell back to eager
    degraded_buckets: int = 0       # buckets running uncaptured
    rejected: int = 0               # never-fits requests (REJECTED)
    timed_out: int = 0              # deadline / queue-budget expiries
    shed: int = 0                   # subset of timed_out: max_queue_s
    cancelled: int = 0              # client cancellations
    failed: int = 0                 # rows failed (non-finite, raised)
    poisoned_rows: int = 0          # rows whose device finite flag was 0
    stragglers: int = 0             # slow-step events from the monitor
    # structured operational events (repro_torch.obs.events.Event)
    events: List[Event] = dataclasses.field(default_factory=list)
    queue_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    per_bucket: Dict[Bucket, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    cache: Dict[str, int] = dataclasses.field(default_factory=dict)
    capture_s: float = 0.0          # building steps (warm-up + capture)
    graph_pool_bytes: int = 0       # the built graphs' private pools
    recompiles: int = 0             # decode steps recaptured on a commit
    free_switches: int = 0          # switches to an already cached step
    commits_seen: int = 0           # commits of another decode winner

    def add_commits(self, counts) -> None:
        """Add one run's :class:`~repro_torch.runtime.serve_loop.
        CommitCounts`."""
        self.recompiles += counts.recompiles
        self.free_switches += counts.free_switches
        self.commits_seen += counts.commits_seen

    @staticmethod
    def _pcts(xs: List[float]) -> Tuple[float, float]:
        """(p50, p95) of ``xs`` (0.0 with no samples)."""
        if not xs:
            return 0.0, 0.0
        a = np.asarray(xs, dtype=np.float64)
        return float(np.percentile(a, 50)), float(np.percentile(a, 95))

    def queue_percentiles(self) -> Tuple[float, float]:
        """(p50, p95) queue latency in seconds."""
        return self._pcts(self.queue_s)

    def ttft_percentiles(self) -> Tuple[float, float]:
        """(p50, p95) time to first token in seconds."""
        return self._pcts(self.ttft_s)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready summary (what ``launch/serve`` prints)."""
        q50, q95 = self.queue_percentiles()
        t50, t95 = self.ttft_percentiles()
        hits = self.cache.get("hits", 0)
        lookups = hits + self.cache.get("misses", 0)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "tokens_generated": self.tokens_generated,
            "decode_tokens": self.decode_tokens,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            # a request's first token comes from its prefill, so only
            # decode-step tokens are divided by decode-step time
            "decode_tok_s": (self.decode_tokens
                             / max(self.decode_s, 1e-9)),
            "steps": self.steps,
            "inflight_admissions": self.inflight_admissions,
            "compactions": self.compactions,
            "fallbacks": self.fallbacks,
            "compile_retries": self.compile_retries,
            "degraded": self.degraded,
            "degraded_buckets": self.degraded_buckets,
            "rejected": self.rejected,
            "timed_out": self.timed_out,
            "shed": self.shed,
            "cancelled": self.cancelled,
            "failed": self.failed,
            "poisoned_rows": self.poisoned_rows,
            "stragglers": self.stragglers,
            "events": [e.as_dict() for e in self.events],
            "queue_p50_s": q50,
            "queue_p95_s": q95,
            "ttft_p50_s": t50,
            "ttft_p95_s": t95,
            "cache": dict(self.cache),
            "cache_hit_rate": hits / lookups if lookups else 0.0,
            "capture_s": self.capture_s,
            "graph_pool_bytes": self.graph_pool_bytes,
            "recompiles": self.recompiles,
            "free_switches": self.free_switches,
            "commits_seen": self.commits_seen,
            "buckets": {
                f"b{b.batch}xp{b.prompt_len}xt{b.total_len}": {
                    **{k: float(v) for k, v in e.items()},
                    "tok_s": (e["decode_tokens"]
                              / max(e["decode_s"], 1e-9)),
                }
                for b, e in sorted(self.per_bucket.items())
            },
        }


class ServeSession:
    """Persistent serving engine: queue, paged KV pool, step loop.

    ``backend`` is ``"cuda"`` (the hand-written kernels; their wrappers
    run the plain versions when the parameters live on the CPU) or
    ``"plain"``.  ``batch_sizes`` are the allowed row counts,
    ``bucket_lengths`` the padded prompt lengths (default: powers of
    two; prompts are left-padded with token 0), and ``temperature``
    the session's sampling temperature (0: greedy, the in-flight
    engine; above 0: the bucketed path).  ``kv_block_size``
    is the token slots per pool block and ``kv_blocks`` the pool size
    (None sizes it so every row reaches its full capacity); both apply
    to attention families only.  The session runs where ``params``
    live.

    ``cache_capacity`` bounds the executable cache (LRU by entry).
    ``capture`` False runs the cached steps eagerly on a card (one
    launch per op, to time the eager path; the counterpart of the JAX
    session's un-lowered jit step); a failure runs a step uncaptured
    only as a degraded bucket, with ``fallback_backend="eager"``.
    ``dispatch`` (a :class:`~repro_torch.runtime.dispatch.
    DispatchService`) feeds the adaptive runtime and, with ``"cuda"``,
    selects the steps' schedules; ``max_recompiles`` bounds the decode
    recaptures on a commit a run (an activation or a ``run_batch``
    call).  ``registry`` (a :class:`~repro_torch.core.registry.
    TuningRegistry`) receives the ``serve_decode`` write-back.

    Fault tolerance: ``request_deadline_s`` (default submit → last
    token budget; ``submit(deadline_s=)`` overrides it), ``max_queue_s``
    (load shedding), ``compile_retries`` / ``compile_backoff_s`` (a
    failed build is retried under capped exponential backoff; 0 by
    default, where the JAX session retries twice, so that a build that
    fails gives up at its first attempt, as the port's sessions did
    before retries existed), ``fallback_backend`` (``"none"``, the
    default, raises after the last attempt; ``"eager"`` degrades the
    bucket, as the module docstring says; the JAX default is
    ``"reference"``, degrading), ``straggler_threshold`` +
    ``on_straggler`` (slow-step hook; returning an int N holds
    admission for N step boundaries), and
    ``faults`` (a :class:`~repro_torch.serving.faults.FaultInjector`,
    for tests; its steps take a poison-mask input, which a session
    without one does not build).

    ``telemetry`` (default: the disabled ``NULL_TELEMETRY``), and
    ``watchdog`` and ``recorder`` (default: the telemetry bundle's, else
    None), as the module docstring says.  The session binds the
    watchdog's dispatch, clock and metrics but no ``on_event`` (the JAX
    session binds its ``_record_event``): it records the events
    ``observe_slot`` and ``tick`` return where the JAX session's sink
    would, so that no bound method of the session makes it cyclic
    garbage and a watchdog used by several sessions reports each its
    own events.  The drift watch is not shared: ``bind`` keeps the first
    dispatch service it is given, so a watchdog judges only the slots of
    the first session it was bound to, and a later session's slots go
    unwatched (as in the JAX package).
    """

    def __init__(self, model: Model, params, *, backend: str = "cuda",
                 registry: Optional[reg.TuningRegistry] = None,
                 batch_sizes: Sequence[int] = (1, 2, 4, 8),
                 bucket_lengths: Optional[Sequence[int]] = None,
                 temperature: float = 0.0,
                 kv_block_size: int = 16, kv_blocks: Optional[int] = None,
                 cache_capacity: int = 16, capture: bool = True,
                 dispatch=None, max_recompiles: int = 1,
                 request_deadline_s: Optional[float] = None,
                 max_queue_s: Optional[float] = None,
                 compile_retries: int = 0, compile_backoff_s: float = 0.01,
                 fallback_backend: str = "none",
                 straggler_threshold: float = 3.0,
                 on_straggler=None, faults=None, telemetry=None,
                 watchdog=None, recorder=None):
        """Validate the knobs and start with an empty queue."""
        if model.cfg.family not in SERVED_FAMILIES:
            raise NotImplementedError(
                f"the port's engine serves the "
                f"{', '.join(SERVED_FAMILIES)} families, got "
                f"{model.cfg.family!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.backend = backend
        self.registry = registry
        self.batch_sizes = tuple(sorted(set(int(b) for b in batch_sizes)))
        if not self.batch_sizes or self.batch_sizes[0] < 1:
            raise ValueError(
                f"batch_sizes must be positive ints, got {batch_sizes!r}")
        self.bucket_lengths = (tuple(sorted(set(int(b)
                                                for b in bucket_lengths)))
                               if bucket_lengths else None)
        self.temperature = float(temperature)
        if kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        if kv_blocks is not None and kv_blocks < 2:
            raise ValueError(
                "kv_blocks must be >= 2 (block 0 is the reserved sink)")
        self.kv_block_size = int(kv_block_size)
        self.kv_blocks = None if kv_blocks is None else int(kv_blocks)
        self.capture = bool(capture)
        if max_recompiles < 0:
            raise ValueError("max_recompiles must be >= 0")
        if compile_retries < 0:
            raise ValueError("compile_retries must be >= 0")
        if fallback_backend not in FALLBACK_BACKENDS:
            raise ValueError(
                f"fallback_backend must be 'eager' or 'none', got "
                f"{fallback_backend!r}")
        self.dispatch = dispatch
        self.max_recompiles = int(max_recompiles)
        self.request_deadline_s = request_deadline_s
        self.max_queue_s = max_queue_s
        self.compile_retries = int(compile_retries)
        self.compile_backoff_s = float(compile_backoff_s)
        self.fallback_backend = fallback_backend
        self.on_straggler = on_straggler
        self._faults = faults
        self._elem_bytes = params["embed"].element_size()
        self.exec_cache = ExecutableCache(cache_capacity)
        self.stats = SessionStats()
        self._queue: List[Request] = []
        self._done: List[RequestResult] = []    # finished outside drain
        self._cancelled: set = set()            # ids flagged for cancel
        self._running: set = set()              # ids currently on a row
        self._admission_hold = 0                # boundaries to skip admit
        self._step_count = 0                    # session-global step index
        # deadlines and shedding read this clock (tests swap in a fake
        # one); step timings always use the real perf counter
        self._clock = time.perf_counter
        # no hook on the monitor: a bound method of the session would
        # make the session (and its graphs) cyclic garbage, which the
        # collector may free in the middle of another step's capture
        self._straggler = StragglerMonitor(threshold=straggler_threshold)
        # every telemetry site guards on telemetry.enabled, every
        # watchdog and recorder tap on `is not None`
        self.telemetry = (telemetry if telemetry is not None
                          else NULL_TELEMETRY)
        self._watchdog = (watchdog if watchdog is not None
                          else self.telemetry.watchdog)
        self._recorder = (recorder if recorder is not None
                          else self.telemetry.recorder)
        if self._watchdog is not None:
            self._watchdog.bind(
                dispatch=dispatch, clock=self._clock,
                metrics=(self.telemetry.metrics
                         if self.telemetry.enabled else None))
        if self._recorder is not None:
            self._recorder.bind(clock=self._clock)
        if self.telemetry.enabled:
            self._register_instruments()

    # ------------------------------------------------------ telemetry
    def _register_instruments(self) -> None:
        """Create the session's metric families (zero-valued), so that
        the exports hold them before any traffic or fault."""
        m = self.telemetry.metrics
        m.counter("serve.requests_submitted_total",
                  help="requests submitted to the session")
        m.counter("serve.inflight_admissions_total",
                  help="requests admitted at engine step boundaries")
        m.counter("serve.events_total",
                  help="structured operational events (faults, "
                       "degradations, stragglers)")
        m.counter("serve.exec_cache_hits_total",
                  help="executable-cache hits")
        m.counter("serve.exec_cache_misses_total",
                  help="executable-cache misses")
        m.counter("serve.aot_fallbacks_total",
                  help="AOT lowerings that fell back to the jit fn")
        m.counter("serve.compile_retries_total",
                  help="failed AOT attempts that were retried")
        m.histogram("serve.ttft_seconds",
                    help="submit -> first token latency, seconds")
        m.histogram("serve.decode_step_seconds",
                    help="engine decode step wall time, seconds")
        m.gauge("serve.kv_blocks_live", help="paged-KV blocks in use")
        m.gauge("serve.kv_blocks_free", help="paged-KV blocks free")
        m.gauge("serve.kv_fragmentation",
                help="paged-KV pool fragmentation [0,1]")

    def _span(self, name: str, **args):
        """The tracer's span while telemetry is on, else the shared
        no-op context manager."""
        tel = self.telemetry
        if tel.enabled:
            return tel.tracer.span(name, **args)
        return _NULL_SPAN

    # ------------------------------------------------------- events
    def _event(self, kind: str, step: Optional[int] = None,
               request_id: Optional[str] = None, **data: Any) -> None:
        """Record one structured :class:`~repro_torch.obs.events.Event`."""
        self._record_event(Event(kind=kind, step=step,
                                 request_id=request_id,
                                 ts=self._clock(), data=data))

    def _record_event(self, ev: Event) -> None:
        """Append an event to the ledger and mirror it into telemetry
        (per-kind counters and a trace instant); with a flight recorder,
        tap it into its ring and dump a postmortem for a kind of
        ``POSTMORTEM_KINDS``."""
        self.stats.events.append(ev)
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.counter("serve.events_total").inc()
            tel.metrics.counter(f"serve.events.{ev.kind}_total").inc()
            tel.tracer.instant(f"event:{ev.kind}", step=ev.step,
                               request_id=ev.request_id)
        rec = self._recorder
        if rec is not None:
            rec.record_event(ev)
            if ev.kind in POSTMORTEM_KINDS:
                self.dump_postmortem(ev.kind)

    def _record_events(self, events) -> None:
        """Record the events the watchdog returned (a drift alarm, SLO
        pages), at the point the JAX session's sink records them."""
        if events is None:
            return
        for ev in (events if isinstance(events, list) else [events]):
            self._record_event(ev)

    def dump_postmortem(self, reason: str) -> Optional[str]:
        """Write ``postmortem-<reason>.json`` through the flight
        recorder (None without one): its recent timeline and allocator
        state, the dispatch service's report (the schedules and their
        registry provenance), the watchdog's report and the lifecycle of
        every request the timeline names.  Called when an event of
        ``POSTMORTEM_KINDS`` is recorded, and again at the end of the
        activation that dumped it, so that the file also shows what
        recovery did (a re-tuned commit)."""
        rec = self._recorder
        if rec is None:
            return None
        context: Dict[str, Any] = {}
        if self.dispatch is not None:
            context["schedules"] = self.dispatch.report()
        if self._watchdog is not None:
            context["watchdog"] = self._watchdog.report()
        tel = self.telemetry
        if tel.enabled:
            lifecycles = {}
            for rid in rec.request_ids():
                r = tel.lifecycle.records.get(rid)
                if r is not None:
                    lifecycles[rid] = r.as_dict()
            context["request_lifecycles"] = lifecycles
        return rec.dump(reason, context)

    # ------------------------------------------------------ admission
    def submit(self, tokens, max_new_tokens: int,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None) -> str:
        """Queue one request (a 1-D prompt); returns its id.

        ``deadline_s`` (submit → last token, seconds) overrides the
        session's ``request_deadline_s``; a blown deadline finishes the
        request TIMED_OUT (partial tokens if it is decoding).  A prompt
        that no bucket can hold is refused here, not in :meth:`drain`,
        where it would wedge the queue."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(tokens, dtype=np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if (self.bucket_lengths
                and prompt.size > max(self.bucket_lengths)):
            raise ValueError(
                f"prompt of length {prompt.size} exceeds the largest "
                f"bucket {max(self.bucket_lengths)}")
        rid = (request_id if request_id is not None
               else f"req-{next(_REQUEST_IDS)}")
        submitted_at = self._clock()
        self._queue.append(Request(
            tokens=prompt, max_new_tokens=int(max_new_tokens),
            request_id=rid, submitted_at=submitted_at,
            deadline_s=(deadline_s if deadline_s is not None
                        else self.request_deadline_s)))
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.counter("serve.requests_submitted_total").inc()
            tel.lifecycle.submitted(rid, submitted_at)
            tel.tracer.async_begin("request", rid, request_id=rid)
        return rid

    def pending(self) -> int:
        """Requests queued but not yet admitted."""
        return len(self._queue)

    def cancel(self, request_id: str) -> bool:
        """Cancel a request.  Queued: finished CANCELLED at once (empty
        tokens; the result comes with the next :meth:`drain`).  On an
        engine row: retired CANCELLED with its partial tokens at the
        next step boundary.  Unknown ids return False."""
        for i, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[i]
                self._finish_unadmitted(req, RequestState.CANCELLED,
                                        "cancelled while queued",
                                        self._done)
                return True
        if request_id in self._running:
            self._cancelled.add(request_id)
            return True
        return False

    # -------------------------------------- terminal-state accounting
    def _count_terminal(self, state: str) -> None:
        """Bump the per-terminal-state session counters."""
        if state == RequestState.REJECTED:
            self.stats.rejected += 1
        elif state == RequestState.TIMED_OUT:
            self.stats.timed_out += 1
        elif state == RequestState.CANCELLED:
            self.stats.cancelled += 1
        elif state == RequestState.FAILED:
            self.stats.failed += 1
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.counter(
                f"serve.requests_{state.lower()}_total").inc()

    def _finish_unadmitted(self, req: Request, state: str, reason: str,
                           sink: List[RequestResult]) -> None:
        """Terminal result for a request that never reached a row."""
        log.warning("request %s finished %s without admission: %s",
                    req.request_id, state, reason)
        queue_s = self._clock() - req.submitted_at
        sink.append(RequestResult(
            request_id=req.request_id, tokens=np.zeros((0,), np.int32),
            bucket=_NULL_BUCKET, queue_s=queue_s,
            stats=None, state=state, reason=reason))
        self.stats.requests += 1
        self._count_terminal(state)
        if self._watchdog is not None:
            self._watchdog.note_queue(queue_s)
            self._watchdog.note_terminal(state == RequestState.COMPLETED)
        tel = self.telemetry
        if tel.enabled:
            tel.lifecycle.terminal(req.request_id, self._clock(),
                                   state, reason)
            tel.tracer.async_end("request", req.request_id, state=state)

    def _sweep_queue(self, sink: List[RequestResult]) -> None:
        """Queue-level terminal outcomes, applied at every admission
        boundary: cancellations, blown deadlines and ``max_queue_s``
        shedding (both TIMED_OUT; sheds also count in ``stats.shed``)."""
        if not self._queue:
            return
        now = self._clock()
        kept: List[Request] = []
        for req in self._queue:
            wait = now - req.submitted_at
            if req.request_id in self._cancelled:
                self._cancelled.discard(req.request_id)
                self._finish_unadmitted(req, RequestState.CANCELLED,
                                        "cancelled while queued", sink)
            elif req.deadline_s is not None and wait > req.deadline_s:
                self._finish_unadmitted(
                    req, RequestState.TIMED_OUT,
                    f"deadline_s={req.deadline_s:g} blown after "
                    f"{wait:.3f}s in queue", sink)
            elif self.max_queue_s is not None and wait > self.max_queue_s:
                self.stats.shed += 1
                self._finish_unadmitted(
                    req, RequestState.TIMED_OUT,
                    f"shed: queued {wait:.3f}s > "
                    f"max_queue_s={self.max_queue_s:g}", sink)
            else:
                kept.append(req)
        self._queue = kept

    def _flush_done(self) -> List[RequestResult]:
        """Results finished outside drain (queued cancellations)."""
        out, self._done = self._done, []
        return out

    def _slow_extra(self) -> float:
        """The slowdown the injector adds to this step, read once a step
        (each read logs a ``slow`` firing): the straggler monitor and the
        watchdog judge ``dt + extra``, the dispatch service ``dt``."""
        return (self._faults.slow_extra_s(self._step_count)
                if self._faults is not None else 0.0)

    def _record_step(self, dt: float, extra: float, tokens: int,
                     slot=None) -> None:
        """Report one decode step's time plus ``extra`` to the straggler
        monitor, then (``slot``: ``(key, kind)``, the bucketed path) to
        the watchdog's drift watch, then its tokens and time to the
        watchdog's SLOs and the step's span to the flight recorder, and
        advance the session's step count.  A straggler is recorded and
        admission held for the boundaries ``on_straggler`` returns."""
        step, late = self._step_count, dt + extra
        event = self._straggler.record(step, late)
        if event is not None:
            self.stats.stragglers += 1
            self._record_event(event)
            if self.on_straggler is not None:
                hold = self.on_straggler(event)
                if isinstance(hold, int) and hold > 0:
                    self._admission_hold = max(self._admission_hold, hold)
        wd = self._watchdog
        if wd is not None:
            if slot is not None:
                self._record_events(wd.observe_slot(*slot, late, step=step))
            wd.note_step(tokens=tokens, dt=late)
            self._record_events(wd.tick(step))
        if self._recorder is not None:
            self._recorder.record_span("serve.decode_step", step=step,
                                       dur_s=late)
        self._step_count += 1

    # ------------------------------------------------------ batching
    def _prompt_bucket(self, request: Request) -> int:
        """Padded prompt length (the request's shape class)."""
        return bucket_length(len(request.tokens), self.bucket_lengths)

    def _bucket_step_time(self, bucket: Bucket) -> Optional[float]:
        """Expected decode-step seconds of a bucket's kernel shape: the
        dispatch service's measured time when observed (here or by an
        earlier process on this machine), else the cost model's best
        prediction; None without a dispatch service."""
        if self.dispatch is None:
            return None
        # here, not at the top: the serve loop imports this package
        from repro_torch.runtime.serve_loop import serve_dispatch_problems
        kind, problem = serve_dispatch_problems(
            self.model.cfg, bucket.batch, bucket.prompt_len,
            bucket.total_len)["decode"]
        eb = self._elem_bytes
        t = self.dispatch.measured_time(kind, problem, eb)
        if t is None:
            predicted = self.dispatch.predicted(kind, problem, eb)
            t = min(predicted) if predicted else None
        return t

    def _next_group(self) -> Tuple[List[Request], Bucket]:
        """The head of the queue's shape class and its best bucket (the
        new-token budget is bucketed too, so groups of other budgets
        share the decode step: only the capacity ``total_len`` is a
        dimension of it)."""
        s_pad = self._prompt_bucket(self._queue[0])
        same = [r for r in self._queue if self._prompt_bucket(r) == s_pad]
        cands = candidate_buckets([r.max_new_tokens for r in same], s_pad,
                                  self.batch_sizes)
        bucket, n_real = pick_bucket(cands, self._bucket_step_time)
        take = same[:n_real]
        taken = {id(r) for r in take}
        self._queue = [r for r in self._queue if id(r) not in taken]
        return take, bucket

    def _form_batch(self, group: List[Request], bucket: Bucket
                    ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """The group left-padded to the bucket (token 0), with rows of
        pad tokens up to the bucket's batch, and each row's start: a pad
        row's is ``prompt_len``, so every position of it is masked."""
        tokens = left_pad_prompts([r.tokens for r in group],
                                  bucket.prompt_len)
        starts = np.full((bucket.batch,), bucket.prompt_len, np.int32)
        starts[:len(group)] = prompt_starts([r.tokens for r in group],
                                            bucket.prompt_len)
        if bucket.batch > len(group):
            pad_rows = np.zeros((bucket.batch - len(group),
                                 bucket.prompt_len), np.int32)
            tokens = np.concatenate([tokens, pad_rows], axis=0)
        return {"tokens": tokens}, starts

    def drain(self, on_step=None) -> List[RequestResult]:
        """Serve every queued request; results in completion order.

        Greedy traffic runs the in-flight engine
        (:meth:`_drain_inflight`); sampled traffic (the session's
        ``temperature > 0``) the bucketed path (:meth:`_drain_batched`),
        which serves whole groups at a time.

        ``on_step(info)`` (engine only) is called after every decode
        step with ``{"step", "active", "pending", "free_blocks"}``; it
        may submit or cancel requests, which take effect at the next
        step boundary."""
        results = self._flush_done()
        if self.temperature <= 0.0:
            while self._queue:
                results.extend(self._drain_inflight(on_step))
            return results
        return results + self._drain_batched()

    def _drain_batched(self) -> List[RequestResult]:
        """Admission-granularity serving: form a group, run it to
        completion through :meth:`run_batch`, repeat.  Queue-level
        outcomes only (a group runs whole, as in the JAX session)."""
        results: List[RequestResult] = []
        tel = self.telemetry
        while self._queue:
            self._sweep_queue(results)
            if not self._queue:
                break
            group, bucket = self._next_group()
            now = self._clock()
            waits = [now - r.submitted_at for r in group]
            batch, starts = self._form_batch(group, bucket)
            out, stats = self.run_batch(
                batch, max_new_tokens=max(r.max_new_tokens for r in group),
                total_len=bucket.total_len,
                real_tokens=sum(r.max_new_tokens for r in group),
                seq_starts=starts)
            for i, r in enumerate(group):
                results.append(RequestResult(
                    request_id=r.request_id,
                    tokens=out[i, :r.max_new_tokens], bucket=bucket,
                    queue_s=waits[i], stats=stats))
            self.stats.requests += len(group)
            self.stats.queue_s.extend(waits)
            # the group's first tokens exist once its prefill finishes
            ttfts = [w + stats.prefill_s for w in waits]
            self.stats.ttft_s.extend(ttfts)
            if tel.enabled:
                t_done = self._clock()
                for r, w, tt in zip(group, waits, ttfts):
                    tel.metrics.histogram("serve.ttft_seconds").observe(tt)
                    tel.lifecycle.admitted(r.request_id, r.submitted_at + w)
                    tel.lifecycle.token(r.request_id, r.submitted_at + tt,
                                        n=r.max_new_tokens)
                    tel.lifecycle.terminal(r.request_id, t_done,
                                           RequestState.COMPLETED, None)
                    tel.tracer.async_end("request", r.request_id,
                                         state=RequestState.COMPLETED)
        return results

    # ------------------------------------------------------ execution
    def _attempts(self, what: str, build) -> Tuple[Optional[CapturedStep],
                                                   Optional[Exception]]:
        """``build()`` with ``compile_retries`` retries under capped
        exponential backoff, in one ``serve.aot_compile`` span (the JAX
        session's ``_aot_compile``); an injected ``compile`` fault fires
        at the start of an attempt.  ``(step, None)``, or ``(None, the
        last error)`` once every attempt failed."""
        delay = self.compile_backoff_s
        last: Optional[Exception] = None
        tel = self.telemetry
        with self._span("serve.aot_compile", what=what):
            for attempt in range(1 + self.compile_retries):
                try:
                    if self._faults is not None:
                        self._faults.compile_fault(what)
                    return build(), None
                except Exception as e:
                    last = e
                    log.warning("build of %s failed (attempt %d/%d): %s",
                                what, attempt + 1, 1 + self.compile_retries,
                                e)
                    if attempt < self.compile_retries:
                        self.stats.compile_retries += 1
                        if tel.enabled:
                            tel.metrics.counter(
                                "serve.compile_retries_total").inc()
                        time.sleep(min(delay, 0.5))
                        delay *= 2
        return None, last

    def _fallback(self, what: str, err: Exception) -> None:
        """Count a build that failed every attempt."""
        self.stats.fallbacks += 1
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.counter("serve.aot_fallbacks_total").inc()
        self._event("compile_failure", what=what, error=repr(err))

    def _build(self, key: ExecKey, make) -> CapturedStep:
        """The step of ``key``: ``make(backend, capture)`` on the
        session's backend, with retries (:meth:`_attempts`).  After the
        last failed attempt ``"none"`` raises the error; ``"eager"``
        degrades the bucket to ``make(backend, False)`` under the same
        key, with retries, and if that fails too, runs the same
        uncaptured step (JAX ``_build_step``: the reference rebuild,
        then the un-lowered jit step; the port's kernels launch either
        way).  A session on the plain backend does not degrade: it goes
        straight to the uncaptured step, as a JAX reference bucket does
        to its jit step."""
        what = (f"{key.role}[b{key.batch},"
                f"{'p' if key.role == 'prefill' else 't'}{key.length}]")
        step, err = self._attempts(
            what, lambda: make(self.backend, self.capture))
        if step is not None:
            return step
        self._fallback(what, err)
        if self.fallback_backend == "none":
            raise err
        if self.backend != "plain":
            log.warning("degrading %s: its step runs uncaptured", what)
            self.stats.degraded = True
            self.stats.degraded_buckets += 1
            self._event("degraded", what=what)
            what += " [degraded]"
            step, err = self._attempts(
                what, lambda: make(self.backend, False))
            if step is not None:
                return step
            self._fallback(what, err)
        log.warning("running %s uncaptured", what)
        return make(self.backend, False)

    def _compile(self, key: ExecKey, make) -> Tuple[Any, bool]:
        """Step for ``key`` via the shared cache: ``(step, was_hit)``;
        a miss builds it (:meth:`_build`).  A build's warm-up and
        capture time and its graph's pool are added to the stats."""
        step, hit = self.exec_cache.get(key, lambda: self._build(key, make))
        if not hit:
            self.stats.capture_s += step.build_s
            self.stats.graph_pool_bytes += step.pool_bytes
        self.stats.cache = self.exec_cache.stats()
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.counter(
                "serve.exec_cache_hits_total" if hit
                else "serve.exec_cache_misses_total").inc()
        return step, hit

    def _contain(self, err: Exception) -> None:
        """After a step raised ``err``: synchronise the card.  An error
        that sticks to the CUDA context (an illegal address, a
        device-side assert) raises ``err`` again, chained to it, so that
        nothing is contained on an unusable card."""
        if self.device.type == "cuda":
            try:
                torch.cuda.synchronize(self.device)
            except Exception as sticky:
                raise err from sticky

    def _write_back(self, bsz: int, prompt_len: int, new_tokens: int,
                    stats) -> None:
        """The ``serve_decode`` measurement of one run (an activation or
        a ``run_batch`` call), under the card's runtime fingerprint."""
        cfg = self.model.cfg
        key = reg.RegistryKey.make(
            "serve_decode", {"arch": cfg.name, "batch": int(bsz),
                             "prompt_len": int(prompt_len),
                             "new_tokens": int(new_tokens)},
            reg.runtime_fingerprint(self.device), "measured")
        self.registry.record_measurement(
            key, {"type": "serve_decode", "arch": cfg.name,
                  "decode_tok_s": stats.decode_tok_s},
            stats.decode_s / max(new_tokens, 1))

    def _decode_builder(self, pool: Dict[str, Any], rows: int,
                        max_blocks: Optional[int], bundle=None):
        """``make(backend, capture)`` of the engine's decode step over
        ``pool`` under ``bundle``: the paged step (tokens, per-row
        positions, block tables) for the attention families, the
        recurrent step (:func:`recurrent_decode_step`, which
        ``run_batch`` shares) for ssm; outputs :func:`step_pick` of the
        logits.  With an injector the step takes a poison mask.  The
        step owns ``pool`` (with every other step of its geometry,
        degraded ones too)."""
        model, params, dev = self.model, self.params, self.device
        poison = self._faults is not None
        if max_blocks is None:
            return lambda backend, capture: recurrent_decode_step(
                model, params, backend, rows, capture,
                layers=pool["layers"], schedules=bundle, poison=poison)

        def make(backend: str, capture: bool) -> CapturedStep:
            """Static inputs, the step function and its capture."""
            inputs = {"tokens": torch.zeros((rows, 1), dtype=torch.int64,
                                            device=dev),
                      "pos": torch.zeros((rows,), dtype=torch.int64,
                                         device=dev),
                      "tables": torch.zeros((rows, max_blocks),
                                            dtype=torch.int32, device=dev),
                      **step_inputs(rows, model.cfg.vocab_size, dev,
                                    poison=poison)}

            def fn():
                """One paged decode step over all rows."""
                lg, _ = model.decode_step(
                    params, pool, inputs["tokens"], inputs["pos"],
                    backend=backend, block_tables=inputs["tables"],
                    schedules=bundle)
                return step_pick(lg[:, -1], inputs)

            return CapturedStep(fn, dev, inputs=inputs,
                                state=pool["layers"], capture=capture)
        return make

    # ------------------------------------------- in-flight engine
    def _drain_inflight(self, on_step=None) -> List[RequestResult]:
        """One engine activation: a fixed (rows, block-table) geometry
        that serves requests at step granularity until the queue and all
        rows are empty, or the head request needs a wider table (it then
        waits for the next activation).  A recurrent (ssm) activation
        has rows only: no allocator, block table or compaction."""
        # here, not at the top: the serve loop imports this package
        from repro_torch.runtime.serve_loop import (CommitCounts, ServeStats,
                                                    resolve_bundle_report,
                                                    serve_dispatch_problems,
                                                    switch_on_commit)
        model, params, dev = self.model, self.params, self.device
        cfg = model.cfg
        backend = self.backend
        dispatch, eb = self.dispatch, self._elem_bytes
        scheduled = dispatch is not None and backend == "cuda"
        attn_family = cfg.family in ATTENTION_FAMILIES
        faults = self._faults
        tel = self.telemetry
        t_act0 = tel.clock() if tel.enabled else 0.0
        # the postmortems dumped before this activation: a reason dumped
        # during it is dumped again at its end
        dumps0 = (dict(self._recorder.dumps)
                  if self._recorder is not None else {})

        head = self._queue[0]
        s_pad = self._prompt_bucket(head)
        budgets = [r.max_new_tokens for r in self._queue
                   if self._prompt_bucket(r) == s_pad]
        cands = candidate_buckets(budgets, s_pad, self.batch_sizes)
        picked, _ = pick_bucket(cands, self._bucket_step_time)
        rows_n = picked.batch
        cap = max(self._prompt_bucket(r) + bucket_length(r.max_new_tokens)
                  for r in self._queue)
        cap = max(cap, picked.total_len)
        bs = self.kv_block_size
        if attn_family:
            max_blocks = blocks_needed(cap, bs)
            cap = max_blocks * bs       # gather extent == table reach
            n_blocks = (1 + rows_n * max_blocks if self.kv_blocks is None
                        else self.kv_blocks)
            alloc = BlockAllocator(n_blocks, bs)
            tables_np = np.zeros((rows_n, max_blocks), np.int32)
            detail = ("paged", bs, max_blocks)
        else:
            alloc = tables_np = max_blocks = detail = None
        dec = (serve_dispatch_problems(cfg, rows_n, s_pad, cap)["decode"]
               if dispatch is not None else None)
        cur_bundle = None
        if dispatch is not None:
            dispatch.resolve(*dec, eb)
            if scheduled:
                cur_bundle = dispatch.schedule_bundle([dec], eb)

        def decode_key(bundle) -> ExecKey:
            """Cache key of the engine's paged or recurrent step."""
            return ExecKey(cfg.name, "decode", rows_n, cap, bundle,
                           backend, detail)

        # The pool belongs to the geometry's decode steps, whose graphs
        # hold its addresses: every step of the geometry, whichever
        # bundle it was built with (and ``run_batch``'s of an equal ssm
        # geometry), holds the one pool, reused here, zeroed.  The step
        # itself is looked up at the first decode step, as the JAX
        # engine compiles it there.
        cached = self.exec_cache.peek_geometry(decode_key(cur_bundle))
        if cached is not None:
            pool = {"layers": cached.state}
            for t in pool["layers"].values():
                t.zero_()
        elif attn_family:
            pool = model.init_paged_cache(n_blocks, bs, dev)
        else:
            pool = model.init_cache(rows_n, cap, dev)
        engine_bucket = Bucket(rows_n, s_pad, cap)
        act_stats = ServeStats(prefill_s=0.0, decode_s=0.0,
                               tokens_generated=0, backend=backend)

        pf_bundles: Dict[int, Any] = {}

        def prefill_for(p_len: int) -> Tuple[CapturedStep, Any]:
            """The cached batch-1 prefill step of a prompt bucket and its
            dispatch problem (None without a service); the bucket's
            bundle is resolved once an activation."""
            prob, bundle = None, None
            if dispatch is not None:
                prob = serve_dispatch_problems(cfg, 1, p_len,
                                               cap)["prefill"]
                if p_len not in pf_bundles:
                    dispatch.resolve(*prob, eb)
                    pf_bundles[p_len] = (dispatch.schedule_bundle([prob], eb)
                                         if scheduled else None)
                bundle = pf_bundles[p_len]
            step, _ = self._compile(
                ExecKey(cfg.name, "prefill", 1, p_len, bundle, backend),
                lambda be, capture: prefill_step(model, params, be, 1, p_len,
                                                 capture, schedules=bundle))
            return step, prob

        row_req: List[Optional[Request]] = [None] * rows_n
        row_blocks: List[List[int]] = [[] for _ in range(rows_n)]
        row_remaining = [0] * rows_n
        row_out: List[List[int]] = [[] for _ in range(rows_n)]
        row_wait = [0.0] * rows_n
        # the terminal state a row retires with when not COMPLETED (poison
        # rows, deadlines, cancellations): set before retire() reads it
        row_fate: Dict[int, Tuple[str, Optional[str]]] = {}
        pos_np = np.zeros((rows_n,), np.int32)
        tok_np = np.zeros((rows_n,), np.int32)
        results: List[RequestResult] = []
        entry = self.stats.per_bucket.setdefault(
            engine_bucket, {"batches": 0, "tokens": 0, "decode_tokens": 0,
                            "decode_s": 0.0})

        def free_row_blocks(r: int, rid: str) -> None:
            """Release row r's pool blocks; an allocator invariant
            violation (a double free) is recorded as an ``allocator``
            event: the row is retiring anyway and the rest of the pool
            stays live."""
            try:
                alloc.free(row_blocks[r])
                if faults is not None and faults.double_free(
                        self._step_count):
                    alloc.free(row_blocks[r])
            except ValueError as e:
                log.warning("allocator error retiring %s: %s", rid, e)
                self._event("allocator", step=self._step_count,
                            request_id=rid, error=str(e))
            tables_np[r, :] = 0

        def retire(r: int) -> None:
            """Finish row r (COMPLETED unless row_fate says otherwise),
            free its blocks and emit its result with the tokens it
            delivered."""
            req = row_req[r]
            state, reason = row_fate.pop(r, (RequestState.COMPLETED, None))
            results.append(RequestResult(
                request_id=req.request_id,
                tokens=np.asarray(row_out[r], np.int32),
                bucket=engine_bucket, queue_s=row_wait[r],
                stats=act_stats, state=state, reason=reason))
            delivered = len(row_out[r])
            act_stats.tokens_generated += delivered
            self.stats.tokens_generated += delivered
            entry["tokens"] += delivered
            self.stats.requests += 1
            self._count_terminal(state)
            self.stats.queue_s.append(row_wait[r])
            if self._watchdog is not None:
                self._watchdog.note_queue(row_wait[r])
                self._watchdog.note_terminal(
                    state == RequestState.COMPLETED)
            if tel.enabled:
                tel.lifecycle.terminal(req.request_id, self._clock(),
                                       state, reason)
                tel.tracer.async_end("request", req.request_id,
                                     state=state)
            self._running.discard(req.request_id)
            self._cancelled.discard(req.request_id)
            if attn_family and row_blocks[r]:
                free_row_blocks(r, req.request_id)
            row_req[r] = None
            row_blocks[r] = []
            row_out[r] = []
            pos_np[r] = 0
            tok_np[r] = 0

        def fail_admission(req: Request, r: int, reason: str) -> None:
            """Contain a prefill's non-finite logits to the one request:
            free its blocks, emit a FAILED result, leave the row idle."""
            log.warning("admission of %s failed: %s", req.request_id,
                        reason)
            self._event("admission_failure", step=self._step_count,
                        request_id=req.request_id, error=reason)
            if attn_family and row_blocks[r]:
                free_row_blocks(r, req.request_id)
                row_blocks[r] = []
            results.append(RequestResult(
                request_id=req.request_id,
                tokens=np.zeros((0,), np.int32), bucket=engine_bucket,
                queue_s=row_wait[r], stats=act_stats,
                state=RequestState.FAILED, reason=reason))
            self.stats.requests += 1
            self._count_terminal(RequestState.FAILED)
            if self._watchdog is not None:
                self._watchdog.note_terminal(False)
            if tel.enabled:
                tel.lifecycle.terminal(req.request_id, self._clock(),
                                       RequestState.FAILED, reason)
                tel.tracer.async_end("request", req.request_id,
                                     state=RequestState.FAILED)

        def place(pool_t: torch.Tensor, pre: torch.Tensor, r: int,
                  length: int, p_len: int) -> None:
            """Scatter one prompt's real K or V ([L,1,HKV,p_len,hd]) into
            row r's first blocks; the tail of the last block is zeroed
            and later overwritten by decode writes.  In place
            (``index_copy_``) where the JAX engine rebuilds the pool."""
            nbp = blocks_needed(length, bs)
            real = pre[:, 0, :, p_len - length:, :].to(pool_t.dtype)
            ln, hkv, _, hd = real.shape
            padded = torch.zeros((ln, hkv, nbp * bs, hd),
                                 dtype=pool_t.dtype, device=dev)
            padded[:, :, :length, :] = real
            blocked = padded.reshape(ln, hkv, nbp, bs, hd).permute(
                0, 2, 1, 3, 4)
            idx = torch.as_tensor(row_blocks[r][:nbp], dtype=torch.int64,
                                  device=dev)
            pool_t.index_copy_(1, idx, blocked)

        def admit(req: Request, r: int) -> bool:
            """Prefill req into row r and scatter its K/V (or write its
            recurrent state); False (request FAILED, row still free) on
            non-finite prefill logits."""
            length = len(req.tokens)
            p_len = self._prompt_bucket(req)
            row_wait[r] = self._clock() - req.submitted_at
            t_adm0 = tel.clock() if tel.enabled else 0.0
            if attn_family:
                nb = blocks_needed(length + req.max_new_tokens - 1, bs)
                row_blocks[r] = alloc.alloc(nb)
                tables_np[r, :] = 0
                tables_np[r, :nb] = row_blocks[r]
            pf, prob = prefill_for(p_len)
            if prob is not None:
                dispatch.propose(*prob, eb)
            t_pf0 = tel.clock() if tel.enabled else 0.0
            t0 = time.perf_counter()
            pf.feed(tokens=left_pad_prompts([req.tokens], p_len),
                    starts=np.asarray([p_len - length]))
            try:
                picked, pcache = pf.replay()
                # one copy to the host: it waits for the card
                first, finite = picked[:, 0].cpu().tolist()
            except Exception as e:
                # a prefill that raises fails this request only
                self._contain(e)
                fail_admission(req, r, f"prefill raised: {e}")
                return False
            dt = time.perf_counter() - t0
            if tel.enabled:
                tel.tracer.complete("serve.prefill", t_pf0, tel.clock(),
                                    request_id=req.request_id,
                                    prompt_len=int(p_len))
            if prob is not None:
                dispatch.observe(*prob, dt, eb)
            act_stats.prefill_s += dt
            self.stats.prefill_s += dt
            if not finite:
                self.stats.poisoned_rows += 1
                fail_admission(req, r, "non-finite prefill logits")
                return False
            if attn_family:
                for name in ("k", "v"):
                    place(pool["layers"][name], pcache["layers"][name], r,
                          length, p_len)
            else:
                # a recurrent state is O(1) per row: write row r of
                # every layer, in place
                for name, t in pool["layers"].items():
                    t[:, r].copy_(pcache["layers"][name][:, 0])
            row_req[r] = req
            row_out[r] = [first]
            row_remaining[r] = req.max_new_tokens - 1
            pos_np[r] = length
            tok_np[r] = first
            self._running.add(req.request_id)
            self.stats.inflight_admissions += 1
            # the batch-1 prefill made the first token here
            now = self._clock()
            self.stats.ttft_s.append(now - req.submitted_at)
            if self._watchdog is not None:
                self._watchdog.note_ttft(now - req.submitted_at)
            if tel.enabled:
                tel.metrics.counter("serve.inflight_admissions_total").inc()
                tel.metrics.histogram("serve.ttft_seconds").observe(
                    now - req.submitted_at)
                tel.lifecycle.admitted(req.request_id,
                                       req.submitted_at + row_wait[r])
                tel.lifecycle.token(req.request_id, now)
                tel.tracer.complete("serve.admit", t_adm0, tel.clock(),
                                    request_id=req.request_id)
            return True

        step = None
        step_idx = 0
        counts = CommitCounts()
        while True:
            with self._span("serve.step", step=self._step_count):
                inj_blocked = False
                now = self._clock()
                for r in range(rows_n):
                    req = row_req[r]
                    if req is None:
                        continue
                    if row_remaining[r] <= 0:
                        retire(r)
                    elif req.request_id in self._cancelled:
                        row_fate[r] = (RequestState.CANCELLED,
                                       "cancelled mid-decode")
                        retire(r)
                    elif (req.deadline_s is not None
                            and now - req.submitted_at > req.deadline_s):
                        row_fate[r] = (
                            RequestState.TIMED_OUT,
                            f"deadline_s={req.deadline_s:g} blown "
                            f"mid-decode after {len(row_out[r])} tokens")
                        retire(r)
                if (attn_family and alloc.num_live
                        and alloc.fragmentation() > 0.5):
                    with self._span("serve.compact", step=self._step_count):
                        live = [row_blocks[r] for r in range(rows_n)
                                if row_blocks[r]]
                        perm, moved = alloc.compact_tables(tables_np, live)
                        if moved:
                            gather = torch.as_tensor(
                                perm, dtype=torch.int64, device=dev)
                            for p in pool["layers"].values():
                                p.copy_(p.index_select(1, gather))
                            self.stats.compactions += 1
                self._sweep_queue(results)
                if self._admission_hold > 0:
                    # a straggler hook asked to shrink admission: skip this
                    # boundary, serve only the rows already in flight
                    self._admission_hold -= 1
                else:
                    while self._queue:
                        free_rows = [r for r in range(rows_n)
                                     if row_req[r] is None]
                        if not free_rows:
                            break
                        nxt = self._queue[0]
                        if attn_family:
                            needed = (len(nxt.tokens) + nxt.max_new_tokens
                                      - 1)
                            nb = blocks_needed(needed, bs)
                            if nb > alloc.n_blocks - 1:
                                self._queue.pop(0)
                                self._finish_unadmitted(
                                    nxt, RequestState.REJECTED,
                                    f"needs {nb} KV blocks but the pool "
                                    f"holds {alloc.n_blocks - 1}; raise "
                                    f"kv_blocks", results)
                                continue
                            if needed > max_blocks * bs:
                                break   # wider table: next activation
                            if faults is not None and faults.alloc_blocked(
                                    self._step_count):
                                self._event("alloc_exhausted",
                                            step=self._step_count)
                                inj_blocked = True
                                break   # injected exhaustion
                            if not alloc.can_fit(needed):
                                break   # backpressure: wait for retirements
                        if not admit(self._queue.pop(0), free_rows[0]):
                            continue    # admission fault: row still free
                active = [r for r in range(rows_n) if row_req[r] is not None]
                if not active:
                    if inj_blocked and self._queue:
                        # injected exhaustion with nothing in flight: count
                        # the stalled boundary so the fault's window expires
                        self._step_count += 1
                        continue
                    break
                if not any(row_remaining[r] > 0 for r in active):
                    continue        # budget-1 admissions retire at loop top
                if step is None:
                    step, _ = self._compile(
                        decode_key(cur_bundle),
                        self._decode_builder(pool, rows_n, max_blocks,
                                             cur_bundle))
                    if any(step.state[n] is not t
                           for n, t in pool["layers"].items()):
                        raise RuntimeError(
                            f"the cached decode step "
                            f"{decode_key(cur_bundle)} holds another state "
                            f"than its geometry's pool")
                if dec is not None:
                    dispatch.propose(*dec, eb)
                feed = {"tokens": tok_np}
                if attn_family:
                    feed.update(pos=pos_np, tables=tables_np)
                if faults is not None:
                    # the rows the injector poisons get NaN logits on the
                    # device, before the step's finite-flag reduction
                    poison = np.zeros((rows_n,), bool)
                    for rr in faults.nan_rows(self._step_count):
                        if 0 <= rr < rows_n:
                            poison[rr] = True
                    feed["poison"] = poison
                t_dec0 = tel.clock() if tel.enabled else 0.0
                t_step = time.perf_counter()
                step.feed(**feed)
                try:
                    # one copy to the host a step: it waits for the card;
                    # every tap below runs after it, on the host
                    new_tok, finite = step.replay().cpu().numpy()
                except Exception as e:
                    # not one row's fault: fail the rows in flight (their
                    # blocks freed, partial tokens delivered), keep the
                    # queue; a row admitted later starts from its own
                    # prefill's state
                    self._contain(e)
                    log.warning("decode step raised: %s", e)
                    self._event("step_exception", step=self._step_count,
                                error=str(e))
                    for r in active:
                        row_fate[r] = (RequestState.FAILED,
                                       f"decode step raised: {e}")
                        retire(r)
                    self._step_count += 1
                    continue
                dt = time.perf_counter() - t_step
                extra = self._slow_extra()
                act_stats.decode_s += dt
                self.stats.decode_s += dt
                entry["decode_s"] += dt
                if tel.enabled:
                    tel.tracer.complete("serve.decode_step", t_dec0,
                                        tel.clock(), step=self._step_count,
                                        rows=len(active))
                    tel.metrics.histogram(
                        "serve.decode_step_seconds").observe(dt)
                if dec is not None:
                    dispatch.observe(*dec, dt, eb)
                    if self._watchdog is not None:
                        # the watchdog judges what the step cost with the
                        # injected slowdown; the service's medians keep dt
                        self._record_events(self._watchdog.observe_slot(
                            dispatch.resolve(*dec, eb), dec[0], dt + extra,
                            step=self._step_count))
                if scheduled:
                    step, cur_bundle = switch_on_commit(
                        step, cur_bundle, dec[0],
                        dispatch.committed(*dec, eb), key_of=decode_key,
                        build_of=lambda b, state: self._decode_builder(
                            {"layers": state}, rows_n, max_blocks, b),
                        contains=self.exec_cache.contains,
                        compile_=self._compile,
                        max_recompiles=self.max_recompiles, counts=counts)
                    pool = {"layers": step.state}
                t_tok = self._clock() if tel.enabled else 0.0
                for r in active:
                    if not finite[r]:
                        # poison row: only this row retires, at the next
                        # boundary; its batchmates' tokens are untouched
                        self.stats.poisoned_rows += 1
                        self._event("poison_row", step=self._step_count,
                                    request_id=row_req[r].request_id)
                        row_fate[r] = (
                            RequestState.FAILED,
                            f"non-finite logits at step {self._step_count}")
                        row_remaining[r] = 0
                        continue
                    if row_remaining[r] > 0:
                        t = int(new_tok[r])
                        row_out[r].append(t)
                        tok_np[r] = t
                        pos_np[r] += 1
                        row_remaining[r] -= 1
                        act_stats.decode_tokens += 1
                        self.stats.decode_tokens += 1
                        entry["decode_tokens"] += 1
                        if tel.enabled:
                            rid = row_req[r].request_id
                            tel.lifecycle.token(rid, t_tok)
                            tel.lifecycle.decode_step(rid)
                self.stats.steps += 1
                step_idx += 1
                self._record_step(dt, extra, len(active))
                rec = self._recorder
                if rec is not None:
                    rec.record_metric("serve.tokens_generated_total",
                                      self.stats.tokens_generated)
                    if attn_family:
                        rec.note_allocator({
                            "blocks_total": alloc.n_blocks,
                            "blocks_live": alloc.num_live,
                            "blocks_free": alloc.num_free,
                            "fragmentation": alloc.fragmentation()})
                if tel.enabled and attn_family:
                    tel.metrics.gauge("serve.kv_blocks_live").set(
                        alloc.num_live)
                    tel.metrics.gauge("serve.kv_blocks_free").set(
                        alloc.num_free)
                    tel.metrics.gauge("serve.kv_fragmentation").set(
                        alloc.fragmentation())
                if on_step is not None:
                    on_step({"step": step_idx,
                             "active": [row_req[r].request_id
                                        for r in range(rows_n)
                                        if row_req[r] is not None],
                             "pending": len(self._queue),
                             "free_blocks": (alloc.num_free if attn_family
                                             else None)})
        if faults is not None and step is not None:
            # a poisoned last step leaves its mask in the step's input;
            # run_batch may replay an ssm step of this geometry unfed
            step.feed(poison=np.zeros((rows_n,), bool))
        act_stats.recompiles = counts.recompiles
        act_stats.recompile_s = counts.recompile_s
        if cur_bundle is not None:
            pf_b = next((b for b in pf_bundles.values() if b is not None),
                        cur_bundle)
            act_stats.schedules = dict(resolve_bundle_report(pf_b,
                                                             cur_bundle))
        self.stats.add_commits(counts)
        self.stats.batches += 1
        entry["batches"] += 1
        self.stats.cache = self.exec_cache.stats()
        if tel.enabled:
            tel.metrics.set_gauges(dict(self.stats.cache),
                                   prefix="serve.exec_cache.",
                                   help="executable-cache snapshot")
            self._straggler.export_metrics(tel.metrics)
            tel.tracer.complete("serve.activation", t_act0, tel.clock(),
                                rows=int(rows_n), prompt_bucket=int(s_pad),
                                steps=int(step_idx))
        if self.registry is not None and step_idx:
            self._write_back(rows_n, s_pad, step_idx, act_stats)
        if self._recorder is not None:
            for reason, n in sorted(self._recorder.dumps.items()):
                if n > dumps0.get(reason, 0):
                    self.dump_postmortem(reason)
        return results

    # ---------------------------------------------- the bucketed path
    def run_batch(self, batch: Dict[str, Any], *, max_new_tokens: int,
                  temperature: Optional[float] = None,
                  generator: Optional[torch.Generator] = None,
                  total_len: Optional[int] = None,
                  real_tokens: Optional[int] = None,
                  seq_starts=None) -> Tuple[np.ndarray, Any]:
        """Greedy (or sampled) continuation of one left-padded batch,
        with its prefill and decode steps behind the executable cache
        (the body of ``serve_loop.generate``).

        ``batch["tokens"]`` is [B, S] (numpy or a CPU tensor);
        ``seq_starts`` ([B], optional) marks each row's first real token
        (zeros when not given, as the JAX session always threads them);
        a row whose start is S holds no prompt token: every position of
        it is masked, and it is a pad row.  ``total_len`` widens the
        cache beyond ``S + max_new_tokens`` so that groups of other
        budgets share the decode step.  ``real_tokens`` is the number of
        tokens delivered to requests (``_drain_batched`` passes its
        group's budgets): the session counts goodput, the returned
        :class:`~repro_torch.runtime.serve_loop.ServeStats` the step's
        ``B * max_new_tokens``.

        ``temperature`` (None: the session's) above 0 samples each token
        from ``softmax(logits / T)`` (Gumbel-max) on noise drawn from
        ``generator`` (a ``torch.Generator`` on the params' device; None:
        one seeded 0 for this call), through the steps keyed with the
        detail :data:`~repro_torch.serving.captured.SAMPLED`.

        A prefill and the cache copy are followed by ``max_new_tokens -
        1`` decode steps, each synchronised and timed (the dispatch
        service and the straggler monitor read it; the session's step
        count, which the fault injector indexes, spans activations and
        calls).  Returns (tokens [B, max_new_tokens] int32,
        ServeStats)."""
        # here, not at the top: the serve loop imports this package
        from repro_torch.runtime.serve_loop import (CommitCounts, ServeStats,
                                                    resolve_bundle_report,
                                                    serve_dispatch_problems,
                                                    switch_on_commit)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        model, params, dev = self.model, self.params, self.device
        cfg = model.cfg
        backend, dispatch, eb = self.backend, self.dispatch, self._elem_bytes
        scheduled = dispatch is not None and backend == "cuda"
        temperature = (self.temperature if temperature is None
                       else float(temperature))
        sampled = temperature > 0.0
        detail = SAMPLED if sampled else None
        toks = np.asarray(batch["tokens"])
        bsz, prompt_len = toks.shape
        starts = (np.zeros((bsz,), np.int64) if seq_starts is None
                  else np.asarray(seq_starts).reshape(bsz))
        total = prompt_len + max_new_tokens
        if total_len is not None:
            if total_len < total:
                raise ValueError(
                    f"total_len {total_len} < prompt+new {total}")
            total = int(total_len)
        arch = cfg.name
        recurrent = cfg.attention_free

        problems = (serve_dispatch_problems(cfg, bsz, prompt_len, total)
                    if dispatch is not None else {})
        prefill_bundle = decode_bundle = None
        if dispatch is not None:
            # resolve both shapes before the timed steps: a warm registry
            # answers with zero cost-model evaluations, a cold one pays
            # one batch sweep here
            for kind, problem in problems.values():
                dispatch.resolve(kind, problem, eb)
            if scheduled:
                # one bundle per role: ssm prefill and decode are both
                # ssm_scan at other shapes
                prefill_bundle = dispatch.schedule_bundle(
                    [problems["prefill"]], eb)
                decode_bundle = dispatch.schedule_bundle(
                    [problems["decode"]], eb)

        def decode_key(bundle) -> ExecKey:
            """Cache key of this batch shape's decode step."""
            return ExecKey(arch, "decode", bsz, total, bundle, backend,
                           detail)

        def build_decode(bundle, state=None):
            """``make(backend, capture)`` of the decode step under
            ``bundle`` over ``state`` (a running step's, when it replaces
            it), else over the state of a cached step of its geometry
            (the engine's too, for a greedy ssm step), else a new one: a
            geometry's steps, degraded ones too, hold one state."""
            def make(be: str, capture: bool) -> CapturedStep:
                """The step, over the geometry's state."""
                live = state
                if live is None:
                    cached = self.exec_cache.peek_geometry(
                        decode_key(bundle))
                    live = None if cached is None else cached.state
                if recurrent:
                    return recurrent_decode_step(
                        model, params, be, bsz, capture,
                        layers=live, schedules=bundle, sampled=sampled,
                        poison=self._faults is not None and not sampled)
                return contiguous_decode_step(
                    model, params, be, bsz, total, capture,
                    schedules=bundle, cache=live, sampled=sampled)
            return make

        pf, _ = self._compile(
            ExecKey(arch, "prefill", bsz, prompt_len, prefill_bundle,
                    backend, detail),
            lambda be, capture: prefill_step(
                model, params, be, bsz, prompt_len, capture,
                schedules=prefill_bundle, sampled=sampled))
        dec = None
        if max_new_tokens > 1:
            dec, _ = self._compile(decode_key(decode_bundle),
                                   build_decode(decode_bundle))
        if sampled:
            gen = (generator if generator is not None
                   else torch.Generator(device=dev).manual_seed(0))
            for s in (pf, dec):
                if s is not None:
                    s.inputs["temperature"].fill_(temperature)

        def draw(s: CapturedStep) -> None:
            """A sampled step's uniform noise, outside its graph."""
            if sampled:
                noise = s.inputs["noise"]
                torch.rand(noise.shape, generator=gen, out=noise)

        if dispatch is not None:
            dispatch.propose(*problems["prefill"], eb)
        tel = self.telemetry
        t_pf0 = tel.clock() if tel.enabled else 0.0
        t0 = time.perf_counter()
        draw(pf)
        pf.feed(tokens=toks, starts=starts)
        picked, pcache = pf.replay()
        if dispatch is not None:
            _sync(dev)
            dispatch.observe(*problems["prefill"], time.perf_counter() - t0,
                             eb)
        out = torch.empty((bsz, max_new_tokens), dtype=torch.int64,
                          device=dev)
        out[:, 0].copy_(picked[0])
        if dec is not None:
            state, ins = dec.state, dec.inputs
            for name, t in pcache["layers"].items():
                if recurrent:
                    state[name].copy_(t)
                else:
                    state[name].zero_()
                    state[name][..., :prompt_len, :].copy_(t)
            ins["tokens"].copy_(picked[0][:, None])
            if not recurrent:
                ins["pos"].fill_(prompt_len)
                ins["starts"].copy_(pf.inputs["starts"])
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        if tel.enabled:
            tel.tracer.complete("serve.prefill", t_pf0, tel.clock(),
                                batch=int(bsz), prompt_len=int(prompt_len))

        counts = CommitCounts()
        watched = self._watchdog is not None and dispatch is not None
        t_dec0 = tel.clock() if tel.enabled else 0.0
        t1 = time.perf_counter()
        for i in range(1, max_new_tokens):
            t_step = time.perf_counter()
            if dispatch is not None:
                kind, problem = problems["decode"]
                dispatch.propose(kind, problem, eb)
            draw(dec)
            out[:, i].copy_(dec.replay()[0])
            _sync(dev)
            dt = time.perf_counter() - t_step
            self._record_step(
                dt, self._slow_extra(), bsz,
                slot=((dispatch.resolve(kind, problem, eb), kind)
                      if watched else None))
            if dispatch is not None:
                dispatch.observe(kind, problem, dt, eb)
                if scheduled:
                    dec, decode_bundle = switch_on_commit(
                        dec, decode_bundle, kind,
                        dispatch.committed(kind, problem, eb),
                        key_of=decode_key, build_of=build_decode,
                        contains=self.exec_cache.contains,
                        compile_=self._compile,
                        max_recompiles=self.max_recompiles, counts=counts)
        _sync(dev)
        decode_s = time.perf_counter() - t1 - counts.recompile_s
        if tel.enabled:
            tel.tracer.complete("serve.decode", t_dec0, tel.clock(),
                                batch=int(bsz),
                                steps=int(max_new_tokens - 1))
        report = (dict(resolve_bundle_report(prefill_bundle, decode_bundle))
                  if prefill_bundle is not None else None)
        stats = ServeStats(prefill_s=prefill_s, decode_s=decode_s,
                           tokens_generated=bsz * max_new_tokens,
                           backend=backend,
                           decode_tokens=bsz * (max_new_tokens - 1),
                           recompiles=counts.recompiles,
                           recompile_s=counts.recompile_s, schedules=report)
        if self.registry is not None:
            self._write_back(bsz, prompt_len, max_new_tokens, stats)

        # the session counts goodput: delivered tokens, not pad rows
        if real_tokens is None:
            delivered, decode_delivered = (stats.tokens_generated,
                                           stats.decode_tokens)
        else:
            real_rows = int((starts < prompt_len).sum())
            delivered = int(real_tokens)
            decode_delivered = delivered - real_rows
        self.stats.batches += 1
        self.stats.prefill_s += prefill_s
        self.stats.decode_s += decode_s
        self.stats.tokens_generated += delivered
        self.stats.decode_tokens += decode_delivered
        self.stats.add_commits(counts)
        entry = self.stats.per_bucket.setdefault(
            Bucket(bsz, prompt_len, total),
            {"batches": 0, "tokens": 0, "decode_tokens": 0,
             "decode_s": 0.0})
        entry["batches"] += 1
        entry["tokens"] += delivered
        entry["decode_tokens"] += decode_delivered
        entry["decode_s"] += decode_s
        self.stats.cache = self.exec_cache.stats()
        return out.cpu().numpy().astype(np.int32), stats


def _sync(device: torch.device) -> None:
    """Wait for the card (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


__all__ = ["Request", "RequestResult", "RequestState", "SessionStats",
           "ServeSession"]
