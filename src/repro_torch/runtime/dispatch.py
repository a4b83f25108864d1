"""The port's online dispatch runtime: tune -> select -> observe per shape.

A :class:`DispatchService` keys every call by ``(kernel kind, canonical
problem, machine)``.  On first sight of a key it resolves the top-K
schedules through the tuner behind the port's registry (a warm registry
answers with zero cost-model evaluations, a cold one pays one batch
sweep) and registers them with an
:class:`~repro_torch.core.adaptive.AdaptiveSelector`.  Each later call
takes the proposed schedule, is timed, and feeds the selector, which
commits the argmin once steady and writes the measured winner back to
the registry.

The port's table holds the reference's six kernel families::

    kind               problem                       schedule
    conv2d             oc,ic,h,w,kh,kw[,n]           ConvSchedule
    matmul             m,n,k                         MatmulSchedule
    flash_attention    b,hq,hkv,s,d[,causal]         FlashAttentionSchedule
    decode_attention   b,hq,hkv,s,d                  DecodeAttentionSchedule
    ssm_scan           bt,seq,di,n                   SSMScanSchedule
    sparse_conv        oc,ic,h,w,kh,kw,density_16    SparseConvSchedule

The serving loop (``runtime/serve_loop.generate``) and the engine
(``serving/session.ServeSession``) feed it the attention and scan
shapes they run, step by step, and :meth:`DispatchService.schedule_bundle`
turns its answers into the :class:`~repro_torch.core.schedule.
ScheduleBundle` a captured step is keyed by and launches with.

The machine part of every slot's key is the service's :class:`H100Spec`
*and* the runtime fingerprint of its torch device, so a timing taken on
the CPU is never filed where the card reads, nor the reverse.  The
service always has an H100 spec (there is no TPU default), and it runs
on the card unless it is given ``device="cpu"``.  Its lifecycle
counters are the ``dispatch.{resolves,proposals,observations,commits,
reopens}_total`` counters of a :class:`~repro_torch.obs.metrics.
MetricsRegistry` (the process registry unless it is given one, so that
services share them), and ``svc.resolves`` and the like read the
service's own share of them; a ``tracer`` gets a
``dispatch.resolve`` span per cold resolution and ``dispatch.commit``
and ``dispatch.reopen`` instants.  The performance watchdog
(:mod:`repro_torch.obs.watchdog`) reads :meth:`DispatchService.
is_committed`, :meth:`~DispatchService.baseline_time` and
:meth:`~DispatchService.committed_schedule`, subscribes through
``on_observe`` and flips a drifted slot back to exploration with
:meth:`~DispatchService.reopen`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import registry as reg
from repro_torch.core import tuner
from repro_torch.core.adaptive import AdaptiveSelector, warm_median
from repro_torch.core.loopnest import ConvLayer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs.metrics import MetricsRegistry, get_metrics_registry
from repro_torch.obs.trace import NullTracer


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """One dispatchable kernel kind: how to key it and how to tune it."""
    kind: str
    dims: tuple                       # required problem-dict fields
    key_fn: Callable[..., reg.RegistryKey]
    tune_fn: Callable[..., List]      # -> [(schedule, KernelCost), ...]

    def key(self, problem: Dict[str, Any], machine: str, elem_bytes: int
            ) -> reg.RegistryKey:
        """Registry key for ``problem`` under the machine fingerprint."""
        return self.key_fn(problem, machine, elem_bytes)

    def tune(self, problem: Dict[str, Any], spec: cm.H100Spec,
             machine: str, elem_bytes: int, top_k: int,
             registry: reg.TuningRegistry) -> List:
        """Ranked ``[(schedule, KernelCost), ...]`` via the cached tuner,
        stored under the same key as :meth:`key`."""
        return self.tune_fn(problem, spec, machine, elem_bytes, top_k,
                            registry)


def _conv_layer(p: Dict[str, Any]) -> ConvLayer:
    """The tuner's ConvLayer for a conv-family problem dict."""
    return ConvLayer(p["oc"], p["ic"], p["h"], p["w"], p["kh"], p["kw"])


FAMILIES: Dict[str, KernelFamily] = {
    # conv2d's problem may carry the batch "n" (default 1): the ranking
    # of the tensor-core body depends on it
    "conv2d": KernelFamily(
        "conv2d", ("oc", "ic", "h", "w", "kh", "kw"),
        lambda p, m, eb: reg.conv_schedule_key(_conv_layer(p), m, eb,
                                               p.get("n", 1)),
        lambda p, spec, m, eb, k, r: tuner.cached_tune_conv(
            _conv_layer(p), spec, eb, top_k=k, registry=r, machine=m,
            batch=p.get("n", 1))),
    "matmul": KernelFamily(
        "matmul", ("m", "n", "k"),
        lambda p, m, eb: reg.matmul_schedule_key(p["m"], p["n"], p["k"], m,
                                                 eb),
        lambda p, spec, m, eb, k, r: tuner.cached_tune_matmul(
            p["m"], p["n"], p["k"], spec, eb, top_k=k, registry=r,
            machine=m)),
    "flash_attention": KernelFamily(
        "flash_attention", ("b", "hq", "hkv", "s", "d"),
        lambda p, m, eb: reg.flash_attention_schedule_key(
            p["b"], p["hq"], p["hkv"], p["s"], p["d"], m,
            p.get("causal", True), eb),
        lambda p, spec, m, eb, k, r: tuner.cached_tune_flash_attention(
            p["b"], p["hq"], p["hkv"], p["s"], p["d"], p.get("causal", True),
            spec, eb, top_k=k, registry=r, machine=m)),
    "decode_attention": KernelFamily(
        "decode_attention", ("b", "hq", "hkv", "s", "d"),
        lambda p, m, eb: reg.decode_attention_schedule_key(
            p["b"], p["hq"], p["hkv"], p["s"], p["d"], m, eb),
        lambda p, spec, m, eb, k, r: tuner.cached_tune_decode_attention(
            p["b"], p["hq"], p["hkv"], p["s"], p["d"], spec, eb, top_k=k,
            registry=r, machine=m)),
    "ssm_scan": KernelFamily(
        "ssm_scan", ("bt", "seq", "di", "n"),
        lambda p, m, eb: reg.ssm_scan_schedule_key(
            p["bt"], p["seq"], p["di"], p["n"], m, eb),
        lambda p, spec, m, eb, k, r: tuner.cached_tune_ssm_scan(
            p["bt"], p["seq"], p["di"], p["n"], spec, eb, top_k=k,
            registry=r, machine=m)),
    # the sparse problem may carry the batch "n" too (default 1): the
    # bf16 body's pixel tile depends on it
    "sparse_conv": KernelFamily(
        "sparse_conv", ("oc", "ic", "h", "w", "kh", "kw", "density_16"),
        lambda p, m, eb: reg.sparse_conv_schedule_key(
            _conv_layer(p), p["density_16"] / 16.0, m, eb, p.get("n", 1)),
        lambda p, spec, m, eb, k, r: tuner.cached_tune_sparse_conv(
            _conv_layer(p), p["density_16"] / 16.0, spec, eb, top_k=k,
            registry=r, machine=m, batch=p.get("n", 1))),
}


def canonical_problem(kind: str, **dims: Any) -> Dict[str, Any]:
    """Validate and canonicalise a problem dict for ``kind`` (missing
    dims raise; extra dims are kept)."""
    fam = FAMILIES.get(kind)
    if fam is None:
        raise KeyError(f"unknown kernel kind {kind!r}; known: "
                       f"{sorted(FAMILIES)}")
    missing = [d for d in fam.dims if d not in dims]
    if missing:
        raise KeyError(f"{kind} problem missing dims {missing}")
    return {k: (bool(v) if isinstance(v, bool) else int(v))
            for k, v in dims.items()}


@dataclasses.dataclass
class _Resolved:
    """Per-(kind, shape, machine) dispatch state."""
    kind: str
    problem: Dict[str, Any]
    registry_key: reg.RegistryKey
    candidates: List[Any]
    predicted: List[float]            # cost-model time_s per candidate
    observations: int = 0
    tier: str = "roofline"


class DispatchService:
    """Tune -> select -> observe scheduler for the port's kernels.

    ``registry=None`` uses the port's default registry; pass
    ``TuningRegistry(None)`` for an in-memory one.  ``device`` is where
    the dispatched calls run and are timed (the card by default; raises
    without one unless ``device="cpu"``).  Typical call site (what the
    ``*_dispatched`` wrappers do)::

        with svc.measure("matmul", dict(m=m, n=n, k=k), device=a.device) \\
                as sched:
            out = matmul_scheduled(a, b, schedule=sched)
            torch.cuda.synchronize()
    """

    def __init__(self, registry: Optional[reg.TuningRegistry] = None,
                 spec: Optional[cm.H100Spec] = None,
                 device: DeviceLike = None, top_k: int = 3,
                 probes_per_candidate: int = 3,
                 steadiness_threshold: float = 0.2,
                 max_extra_probes: int = 2,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Any] = None):
        """Bind a registry, the H100 spec and the device; configure the
        selector.  ``metrics`` (default: the process metrics registry)
        receives the ``dispatch.*`` counters; ``tracer`` (default: a
        :class:`~repro_torch.obs.trace.NullTracer`) the spans and
        instants."""
        self.registry = (registry if registry is not None
                         else reg.TuningRegistry.default())
        self.spec = spec if spec is not None else cm.H100Spec()
        self.device = resolve_device(device)
        self.machine = reg.machine_key(self.spec, self.device)
        self.top_k = top_k
        self.selector: AdaptiveSelector = AdaptiveSelector(
            probes_per_candidate=probes_per_candidate,
            steadiness_threshold=steadiness_threshold,
            max_extra_probes=max_extra_probes, registry=self.registry)
        self.metrics = (metrics if metrics is not None
                        else get_metrics_registry())
        self.tracer = tracer if tracer is not None else NullTracer()
        hlp = "adaptive-dispatch lifecycle accounting"
        self._counters = {
            name: self.metrics.counter(f"dispatch.{name}_total", help=hlp)
            for name in ("resolves", "proposals", "observations",
                         "commits", "reopens")}
        self._own = dict.fromkeys(self._counters, 0)
        # called as (slot key, kind, dt) after every observation, outside
        # the service lock: the watchdog subscribes here and may call
        # back into the service (reopen)
        self.on_observe: Optional[Callable[[str, str, float], None]] = None
        self._committed_seen: set = set()
        self._slots: Dict[str, _Resolved] = {}
        self._key_cache: Dict[tuple, str] = {}
        self._lock = threading.Lock()

    def _count(self, name: str) -> None:
        """One more ``dispatch.<name>_total``, and in this service's
        own share of it."""
        self._counters[name].inc()
        self._own[name] += 1

    # this service's share of the lifecycle counters, read-only
    @property
    def resolves(self) -> int:
        """Slots resolved (``dispatch.resolves_total``)."""
        return self._own["resolves"]

    @property
    def proposals(self) -> int:
        """Schedules proposed (``dispatch.proposals_total``)."""
        return self._own["proposals"]

    @property
    def observations(self) -> int:
        """Times observed (``dispatch.observations_total``)."""
        return self._own["observations"]

    @property
    def commits(self) -> int:
        """Commits, each re-commit after a reopen counted again
        (``dispatch.commits_total``)."""
        return self._own["commits"]

    def resolve(self, kind: str, problem: Dict[str, Any],
                elem_bytes: int = 2) -> str:
        """Ensure a slot exists for (kind, shape) on this machine and
        return its key; the first resolution consults the registry or
        runs one batch sweep, later ones are a dict probe."""
        ckey = (kind, tuple(sorted(problem.items())), elem_bytes)
        with self._lock:
            cached = self._key_cache.get(ckey)
            if cached is not None:
                return cached
        problem = canonical_problem(kind, **problem)
        fam = FAMILIES[kind]
        rkey = fam.key(problem, self.machine, elem_bytes)
        skey = rkey.canonical()
        with self._lock:
            if skey in self._slots:
                self._key_cache[ckey] = skey
                return skey
        with (self.tracer.span("dispatch.resolve", kind=kind)
              if self.tracer.enabled else contextlib.nullcontext()):
            ranked = fam.tune(problem, self.spec, self.machine, elem_bytes,
                              self.top_k, self.registry)
        rec = self.registry.get(rkey)
        tier = ((rec.value.get("tier") if rec is not None else None)
                or reg.kind_tier(rkey.kind))
        with self._lock:
            if skey not in self._slots:
                self._count("resolves")
                self.selector.register_ranked(skey, ranked,
                                              registry_key=rkey)
                self._slots[skey] = _Resolved(
                    kind=kind, problem=problem, registry_key=rkey, candidates=[s for s, _ in ranked],
                    predicted=[float(c.time_s) for _, c in ranked],
                    tier=tier)
            self._key_cache[ckey] = skey
        return skey

    def propose(self, kind: str, problem: Dict[str, Any],
                elem_bytes: int = 2) -> Any:
        """Schedule to use for this call (resolving if needed)."""
        skey = self.resolve(kind, problem, elem_bytes)
        with self._lock:
            self._count("proposals")
            return self.selector.propose(skey)

    def _after_observe(self, skey: str) -> None:
        """Count the observation; on the slot's None → committed
        transition count the commit and emit a ``dispatch.commit``
        instant (under the service lock)."""
        self._count("observations")
        slot = self._slots[skey]
        slot.observations += 1
        if (skey not in self._committed_seen
                and self.selector.committed(skey) is not None):
            self._committed_seen.add(skey)
            self._count("commits")
            if self.tracer.enabled:
                self.tracer.instant("dispatch.commit", kind=slot.kind,
                                    observations=slot.observations)

    def observe(self, kind: str, problem: Dict[str, Any], dt: float,
                elem_bytes: int = 2) -> None:
        """Feed one measured duration (seconds) for the schedule last
        proposed for this shape (sequential propose/observe protocol)."""
        skey = self.resolve(kind, problem, elem_bytes)
        with self._lock:
            self.selector.observe(skey, dt)
            self._after_observe(skey)
        if self.on_observe is not None:
            self.on_observe(skey, kind, dt)

    @contextlib.contextmanager
    def measure(self, kind: str, problem: Dict[str, Any],
                elem_bytes: int = 2, device: DeviceLike = None):
        """Propose, time the body on the host clock, observe.  The body
        must finish its device work (synchronise) before it ends.  A
        ``device`` other than the service's raises: its time would be
        filed under another machine's key."""
        if device is not None and \
                torch.device(device).type != self.device.type:
            raise ValueError(f"dispatch service times calls on "
                             f"{self.device}, got a call on {device}")
        skey = self.resolve(kind, problem, elem_bytes)
        with self._lock:
            self._count("proposals")
            idx, sched = self.selector.propose_with_index(skey)
        t0 = time.perf_counter()
        yield sched
        dt = time.perf_counter() - t0
        with self._lock:
            self.selector.observe_at(skey, idx, dt)
            self._after_observe(skey)
        if self.on_observe is not None:
            self.on_observe(skey, kind, dt)

    def committed(self, kind: str, problem: Dict[str, Any],
                  elem_bytes: int = 2) -> Optional[Any]:
        """The committed schedule for a shape, or None while probing."""
        return self.selector.committed(self.resolve(kind, problem,
                                                    elem_bytes))

    def committed_or_best(self, kind: str, problem: Dict[str, Any],
                          elem_bytes: int = 2) -> Any:
        """This process' committed winner, else the registry's persisted
        measured winner (an earlier process on this machine), else the
        offline rank-0 candidate; never None."""
        skey = self.resolve(kind, problem, elem_bytes)
        committed = self.selector.committed(skey)
        if committed is not None:
            return committed
        slot = self._slots[skey]
        rec = self.registry.get(slot.registry_key)
        if rec is not None and rec.measured:
            try:
                return reg.schedule_from_dict(rec.measured["best"])
            except (KeyError, ValueError, TypeError):
                pass
        return slot.candidates[0]

    # -- the drift surface (obs/watchdog.py) --------------------------
    def is_committed(self, slot: str) -> bool:
        """Whether a resolved slot (by key) has a committed winner."""
        return self.selector.committed(slot) is not None

    def committed_schedule(self, slot: str) -> Optional[Dict[str, Any]]:
        """A slot's committed schedule as a registry dict (None while
        probing, and for unknown slots)."""
        committed = self.selector.committed(slot)
        return (reg.schedule_to_dict(committed)
                if committed is not None else None)

    def baseline_time(self, slot: str) -> Optional[float]:
        """The committed schedule's expected time (seconds), which a
        drift detector compares live times with: the median measured at
        the commit, else the registry's persisted ``time_s``, else the
        cost model's prediction for the committed candidate.  None while
        the slot probes."""
        committed = self.selector.committed(slot)
        if committed is None:
            return None
        m = self._measured_for_slot(slot)
        if m is not None:
            return m
        s = self._slots.get(slot)
        if s is None:
            return None
        if committed in s.candidates:
            return float(s.predicted[s.candidates.index(committed)])
        return float(min(s.predicted)) if s.predicted else None

    def reopen(self, slot: str) -> bool:
        """Flip a committed slot (by key) back to exploration: the
        selector drops its winner and every sample, the next proposals
        probe the candidates from scratch, and the re-commit (possibly
        another winner) counts in ``dispatch.commits_total`` and emits
        its ``dispatch.commit`` instant like the first.  False for an
        unknown or uncommitted slot."""
        with self._lock:
            if slot not in self._slots:
                return False
            if not self.selector.reopen(slot):
                return False
            self._committed_seen.discard(slot)
            self._count("reopens")
            if self.tracer.enabled:
                self.tracer.instant("dispatch.reopen",
                                    kind=self._slots[slot].kind)
        return True

    def schedule_bundle(self, problems, elem_bytes: int = 2):
        """A :class:`~repro_torch.core.schedule.ScheduleBundle` for
        ``(kind, problem)`` pairs (e.g. the values of
        ``serve_loop.serve_dispatch_problems``): each named field is the
        :meth:`committed_or_best` schedule of its shape.  Frozen and
        hashable, so a captured step is keyed by the schedules it
        runs."""
        from repro_torch.core.schedule import ScheduleBundle
        fields = {}
        for kind, problem in problems:
            if kind in ScheduleBundle.__dataclass_fields__:
                fields[kind] = self.committed_or_best(kind, problem,
                                                      elem_bytes)
        return ScheduleBundle(**fields)

    def _measured_for_slot(self, skey: str) -> Optional[float]:
        """This process' observed median, else the registry's persisted
        measurement, else None."""
        m = self.selector.measured_median(skey)
        if m is not None:
            return m
        rec = self.registry.get(self._slots[skey].registry_key)
        if rec is not None and isinstance(rec.measured, dict):
            t = rec.measured.get("time_s")
            if isinstance(t, (int, float)):
                return float(t)
        return None

    def measured_time(self, kind: str, problem: Dict[str, Any],
                      elem_bytes: int = 2) -> Optional[float]:
        """Measured call time (seconds) for a shape, or None."""
        return self._measured_for_slot(self.resolve(kind, problem,
                                                    elem_bytes))

    def measured_table(self) -> Dict[str, Dict[str, Any]]:
        """Per-shape measured times: ``{slot key: {kind, problem,
        measured_s, predicted_best_s, observations}}`` over every slot
        resolved (``measured_s`` None while unmeasured)."""
        out: Dict[str, Dict[str, Any]] = {}
        for skey, slot in self._slots.items():
            out[skey] = {
                "kind": slot.kind,
                "problem": dict(slot.problem),
                "measured_s": self._measured_for_slot(skey),
                "predicted_best_s": (min(slot.predicted)
                                     if slot.predicted else None),
                "observations": slot.observations,
            }
        return out

    def candidates(self, kind: str, problem: Dict[str, Any],
                   elem_bytes: int = 2) -> List[Any]:
        """Top-K candidate schedules for a shape (offline rank order)."""
        return list(self._slots[self.resolve(kind, problem,
                                             elem_bytes)].candidates)

    def predicted(self, kind: str, problem: Dict[str, Any],
                  elem_bytes: int = 2) -> List[float]:
        """Cost-model time_s per candidate (same order as
        :meth:`candidates`)."""
        return list(self._slots[self.resolve(kind, problem,
                                             elem_bytes)].predicted)

    def registry_key(self, kind: str, problem: Dict[str, Any],
                     elem_bytes: int = 2) -> reg.RegistryKey:
        """The registry key a shape's measurement is written back under."""
        return self._slots[self.resolve(kind, problem,
                                        elem_bytes)].registry_key

    def report(self) -> Dict[str, Dict[str, Any]]:
        """Per-shape state: candidates, predicted and measured medians,
        observations, committed winner."""
        out: Dict[str, Dict[str, Any]] = {}
        samples_all = self.selector.report()
        for skey, slot in self._slots.items():
            committed = self.selector.committed(skey)
            samples = samples_all.get(skey, {}).get("samples", {})
            entry = {
                "kind": slot.kind, "problem": dict(slot.problem),
                "machine": slot.registry_key.machine, "tier": slot.tier,
                "n_candidates": len(slot.candidates),
                "candidates": [reg.schedule_to_dict(c)
                               for c in slot.candidates],
                "predicted_s": list(slot.predicted),
                "measured_median_s": [warm_median(v) if v else None
                                      for _, v in sorted(samples.items())],
                "observations": slot.observations,
                "committed": (reg.schedule_to_dict(committed)
                              if committed is not None else None),
                "committed_rank": (slot.candidates.index(committed)
                                   if committed is not None else None),
                "samples": {i: len(v) for i, v in samples.items()},
            }
            out[skey] = entry
        return out


_SERVICE: Optional[DispatchService] = None
_SERVICE_INSTALLED = False
_SERVICE_LOCK = threading.Lock()


def get_dispatch_service() -> DispatchService:
    """The process-wide service: an installed one as it is, otherwise a
    default-registry service on the card, created lazily and recreated
    when ``REPRO_TORCH_TUNE_REGISTRY`` is repointed."""
    global _SERVICE
    with _SERVICE_LOCK:
        if _SERVICE_INSTALLED:
            return _SERVICE
        path = reg.TuningRegistry.default_path()
        if _SERVICE is None or _SERVICE.registry.path != path:
            _SERVICE = DispatchService(reg.TuningRegistry.default())
        return _SERVICE


def set_dispatch_service(service: Optional[DispatchService]
                         ) -> Optional[DispatchService]:
    """Install (or with None, clear back to the lazy default) the
    process-wide service; returns the previous one."""
    global _SERVICE, _SERVICE_INSTALLED
    with _SERVICE_LOCK:
        prev, _SERVICE = _SERVICE, service
        _SERVICE_INSTALLED = service is not None
        return prev


__all__ = ["DispatchService", "KernelFamily", "FAMILIES",
           "canonical_problem", "get_dispatch_service",
           "set_dispatch_service"]
