"""The port's performance watchdog, SLOs and flight recorder against the
JAX package's, on the CPU.

Unit parity: the same specs parse or fail on both packages, the same
sample and observation sequences give equal ``SLOTracker.report()``,
``PerformanceWatchdog.report()``, events and metric exports, and the
same recorder taps give byte-equal postmortem files.  The port's
``DispatchService`` gains the watchdog's surface (``reopen``,
``baseline_time``, ``on_observe``, the ``dispatch.*`` counters), held to
the JAX service's values.  Then ``tests/test_watchdog.py``'s serving
loop: ``slow@3x4`` on the committed decode slot of the port's
dispatched session raises a drift alarm within ``patience`` steps, at
the JAX session's step, the slot is reopened and committed again, and
``postmortem-drift.json`` names the slot and both schedules; with the
watchdog and recorder off the tokens, states and events are those of
the run with them on; and a session holding them is freed without the
garbage collector.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.dispatch import DispatchService as JaxService  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import session as jsession  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import (FlightRecorder, MetricsRegistry,  # noqa: E402
                             PerformanceWatchdog, Telemetry, parse_slo)
from repro_torch.runtime.dispatch import DispatchService  # noqa: E402
from repro_torch.serving import (FaultInjector, RequestState,  # noqa: E402
                                 ServeSession)
from repro_torch.serving import session as tsession  # noqa: E402

PHI3, MAMBA = "phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke"
PROBLEM = {"m": 128, "n": 128, "k": 128}


class FakeClock:
    """Deterministic monotonic clock: each reading advances 1 ms."""

    def __init__(self, start=100.0, tick=1e-3):
        self.t = start
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _svc(top_k=1, **kw):
    """The port's service committing at one probe per candidate, on an
    in-memory registry and a private metrics registry."""
    return DispatchService(reg.TuningRegistry(None), device="cpu",
                           top_k=top_k, probes_per_candidate=1,
                           max_extra_probes=0, metrics=MetricsRegistry(),
                           **kw)


def _jsvc(top_k=1, **kw):
    """The JAX service with the same knobs."""
    return JaxService(jreg.TuningRegistry(None), top_k=top_k,
                      probes_per_candidate=1, max_extra_probes=0,
                      metrics=jobs.MetricsRegistry(), **kw)


def _events(evs, drop=()):
    return [{k: v for k, v in e.as_dict().items() if k not in drop}
            for e in evs]


# ------------------------------------------------------------ SLO specs

SPECS_OK = ["ttft_p95<=0.25", "tok_s >= 50", "error_rate<=0.05",
            "error_rate<=0", "queue_p95<=1e-1", " ttft_p95<=3 "]
SPECS_BAD = ["ttft_p95<0.25", "ttft_p95>=0.25", "tok_s<=50", "made_up<=1",
             "ttft_p95<=-1", "ttft_p95", "queue_p95<=0", "tok_s>=x"]


@pytest.mark.parametrize("spec", SPECS_OK)
def test_parse_slo_accepts_what_jax_accepts(spec):
    mine, theirs = parse_slo(spec), jobs.parse_slo(spec)
    assert (mine.name, mine.op, mine.threshold, mine.budget) == (
        theirs.name, theirs.op, theirs.threshold, theirs.budget)
    assert mine.describe() == theirs.describe()
    for v in (0.0, 0.05, 0.25, 0.3, 49.0, 50.0):
        assert mine.bad(v) == theirs.bad(v)


@pytest.mark.parametrize("spec", SPECS_BAD)
def test_parse_slo_rejects_what_jax_rejects(spec):
    with pytest.raises(ValueError) as mine:
        parse_slo(spec)
    with pytest.raises(ValueError) as theirs:
        jobs.parse_slo(spec)
    assert str(mine.value) == str(theirs.value)


def _drive_slo(pkg):
    m = pkg.MetricsRegistry()
    t = pkg.SLOTracker(["ttft_p95<=0.1", "tok_s>=50", "error_rate<=0.2"],
                       short_window=4, long_window=8, burn_threshold=2.0,
                       min_samples=4, metrics=m)
    fired = []
    series = [0.5] * 5 + [0.01] * 9 + [0.5] * 4
    for i, v in enumerate(series):
        t.sample("ttft_p95", v)
        t.sample("tok_s", 10.0 if i % 3 else 80.0)
        t.sample("error_rate", float(i % 4 == 0))
        t.sample("queue_p95", 99.0)       # no SLO targets it: dropped
        fired += t.evaluate(step=i)
    return t, m, fired


def test_slo_tracker_matches_jax():
    (t, m, fired), (jt, jm, jfired) = _drive_slo(obs), _drive_slo(jobs)
    assert json.dumps(t.report(), sort_keys=True) == json.dumps(
        jt.report(), sort_keys=True)
    assert _events(fired) == _events(jfired)
    assert [e.data["signal"] for e in fired].count("ttft_p95") == 2
    assert m.to_prometheus() == jm.to_prometheus()


# ------------------------------------------------- the dispatch surface

def _reopen_sequence(svc):
    slot = svc.resolve("matmul", PROBLEM)
    out = [svc.is_committed(slot), svc.baseline_time(slot),
           svc.committed_schedule(slot)]
    svc.observe("matmul", PROBLEM, 1e-3)
    svc.observe("matmul", PROBLEM, 2e-3)
    out += [svc.is_committed(slot), svc.baseline_time(slot),
            isinstance(svc.committed_schedule(slot), dict)]
    out += [svc.reopen(slot), svc.is_committed(slot), svc.baseline_time(slot),
            svc.reopen(slot), svc.reopen("no-such-slot")]
    svc.observe("matmul", PROBLEM, 3e-3)
    svc.observe("matmul", PROBLEM, 4e-3)
    out += [svc.is_committed(slot), svc.baseline_time(slot)]
    table = svc.measured_table()[slot]
    out += [table["kind"], table["problem"], table["measured_s"],
            table["observations"]]
    return out, {n: svc.metrics.counter(n).value
                 for n in ("dispatch.resolves_total",
                           "dispatch.observations_total",
                           "dispatch.commits_total",
                           "dispatch.reopens_total")}


def test_dispatch_reopen_baseline_and_counters_match_jax():
    mine, mine_counts = _reopen_sequence(_svc(top_k=2))
    theirs, their_counts = _reopen_sequence(_jsvc(top_k=2))
    assert mine == theirs
    assert mine_counts == their_counts == {
        "dispatch.resolves_total": 1, "dispatch.observations_total": 4,
        "dispatch.commits_total": 2, "dispatch.reopens_total": 1}
    assert mine[:3] == [False, None, None]
    assert mine[4] == pytest.approx(1e-3)


def test_dispatch_counters_stay_readable_as_integers():
    svc = _svc(top_k=1)
    for _ in range(3):
        svc.propose("matmul", PROBLEM)
        svc.observe("matmul", PROBLEM, 1e-3)
    assert (svc.resolves, svc.proposals, svc.observations, svc.commits) == (
        1, 3, 3, 1)
    assert all(isinstance(v, int) for v in (svc.resolves, svc.commits))
    with pytest.raises(AttributeError):
        svc.commits = 0


def test_on_observe_fires_outside_the_lock_and_may_reopen():
    for svc in (_svc(top_k=1), _jsvc(top_k=1)):
        seen = []

        def hook(slot, kind, dt, svc=svc):
            seen.append((slot, kind, dt))
            svc.reopen(slot)        # re-entering must not deadlock

        svc.on_observe = hook
        svc.observe("matmul", PROBLEM, 1e-3)
        with svc.measure("matmul", PROBLEM):
            pass
        assert [(k, pytest.approx(d)) for _, k, d in seen][:1] == [
            ("matmul", pytest.approx(1e-3))]
        assert len(seen) == 2
        assert svc.metrics.counter("dispatch.reopens_total").value == 2


# ------------------------------------------------------ drift detection

SEQUENCES = {
    "drift_reopen_recommit": dict(
        kw=dict(ratio=3.0, patience=2, cooldown=2, retune_budget=1),
        dts=[1e-3, 5e-2, 5e-2, 5e-2, 5e-2, 5e-2, 5e-2, 5e-2]),
    "single_blips": dict(kw=dict(ratio=3.0, patience=2, cooldown=2),
                         dts=[1e-3] + [5e-2, 1e-3] * 5),
    "budget_bounds_flapping": dict(
        kw=dict(ratio=3.0, patience=1, cooldown=0, retune_budget=1),
        dts=[1e-3, 5e-2, 5e-2, 2.0]),
}


def _watch(pkg, svc, kw, dts):
    m = pkg.MetricsRegistry()
    wd = pkg.PerformanceWatchdog(metrics=m, clock=FakeClock(), **kw)
    wd.attach(svc)
    for dt in dts:
        svc.observe("matmul", PROBLEM, dt)
    wd.tick(len(dts))
    return wd, m


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_watchdog_matches_jax(name):
    sc = SEQUENCES[name]
    svc, jsvc = _svc(top_k=1), _jsvc(top_k=1)
    wd, m = _watch(obs, svc, sc["kw"], sc["dts"])
    jwd, jm = _watch(jobs, jsvc, sc["kw"], sc["dts"])
    slot, jslot = (s.resolve("matmul", PROBLEM) for s in (svc, jsvc))
    rep, jrep = wd.report(), jwd.report()
    rep["slots"] = {"SLOT": rep["slots"].pop(slot)}
    jrep["slots"] = {"SLOT": jrep["slots"].pop(jslot)}
    assert json.dumps(rep, sort_keys=True) == json.dumps(jrep, sort_keys=True)
    # the events, but for the slot key and the schedule each package
    # committed (its own schedule types)
    drop = ("slot", "old_schedule")
    assert _events(wd.events, drop) == _events(jwd.events, drop)
    assert m.to_prometheus() == jm.to_prometheus()
    for k in ("dispatch.reopens_total", "dispatch.commits_total",
              "dispatch.observations_total"):
        assert (svc.metrics.counter(k).value
                == jsvc.metrics.counter(k).value)
    if name == "drift_reopen_recommit":
        (ev,) = wd.events
        assert ev.data["slot"] == slot and ev.data["reopened"] is True
        assert ev.data["old_schedule"] == svc.committed_schedule(slot)
        assert svc.baseline_time(slot) == pytest.approx(5e-2)
        assert wd.drift_count() == 1
    if name == "single_blips":
        assert wd.drift_count() == 0
    if name == "budget_bounds_flapping":
        assert (wd.drift_count(), wd.reopen_count()) == (2, 1)
        assert wd.events[-1].data["reopened"] is False


def test_watchdog_ignores_uncommitted_slots():
    svc = _svc(top_k=2)
    wd = PerformanceWatchdog(ratio=3.0, patience=1, cooldown=0)
    wd.attach(svc)
    svc.observe("matmul", PROBLEM, 10.0)
    assert wd.drift_count() == 0 and wd.report()["slots"]


# ------------------------------------------------------ flight recorder

def _record(pkg, out_dir):
    clock = FakeClock()
    rec = pkg.FlightRecorder(out_dir=str(out_dir), capacity=5, clock=clock)
    rec.bind(clock=FakeClock())          # an explicit clock wins
    for i in range(4):
        rec.record_metric("serve.tokens_generated_total", float(i))
    rec.record_span("serve.decode_step", step=3, dur_s=0.25)
    rec.record_event(pkg.Event(kind="poison_row", step=3,
                               request_id="r1", ts=100.5))
    rec.record_event(pkg.Event(kind="drift", step=4,
                               data={"slot": "s", "ratio": 50.0}))
    rec.note_allocator({"blocks_total": 9, "blocks_live": 4})
    paths = [rec.dump("drift", context={"watchdog": {"drifts": 1}}),
             rec.dump("we?ird reason/../x")]
    return rec, paths


def test_postmortem_files_are_byte_equal(tmp_path):
    rec, paths = _record(obs, tmp_path / "mine")
    jrec, jpaths = _record(jobs, tmp_path / "theirs")
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "postmortem-drift.json", "postmortem-we_ird_reason_.._x.json"]
    for a, b in zip(paths, jpaths):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert rec.dumps == jrec.dumps
    assert rec.request_ids() == ["r1"]
    bundle = json.loads(open(paths[0]).read())
    assert len(bundle["timeline"]) == 5 and bundle["ts"] > 100.0
    assert obs.POSTMORTEM_KINDS == jobs.POSTMORTEM_KINDS


# --------------------------------------------- the serving loop, end to end

def _models(arch):
    jm = jax_build_model(jax_get_config(arch))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(arch)), tp


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in (PHI3, MAMBA)}


FAULT_START, FAULT_LEN = 3, 4


class StepTime:
    """A ``time`` module for the sessions: every reading of
    ``perf_counter`` (and ``time``) advances 1 ms and ``sleep`` returns at
    once, so every decode step measures the same 1 ms and only the
    injected slowdown can breach a baseline (on a loaded host a real
    step may run 3x its neighbours twice in a row)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1e-3
        return self.t

    time = perf_counter

    def sleep(self, seconds):
        pass


def _drift_session(make, svc, wd, rec, fi):
    s = make(svc, wd, rec, fi)
    for i in range(2):
        s.submit(np.full(4, 7, dtype=np.int64), max_new_tokens=8,
                 request_id=f"r{i}")
    return s, s.drain()


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_session_drift_loop_matches_jax(models, tmp_path, monkeypatch,
                                        arch):
    """``slow@3x4`` on the committed decode slot (top_k 1: it commits at
    its first step), patience 2: the drift alarm fires within patience
    steps of the fault, at the JAX session's step; the slot is reopened
    and committed again; ``postmortem-drift.json`` names the slot, its
    old schedule and the new one; the event ledger's kinds equal the JAX
    session's.  Both sessions time their steps on :class:`StepTime`."""
    monkeypatch.setattr(jsession, "time", StepTime())
    monkeypatch.setattr(tsession, "time", StepTime())
    jm, jp, tm, tp = models[arch]
    spec = f"slow@{FAULT_START}x{FAULT_LEN}"
    wd_kw = dict(ratio=3.0, patience=2, cooldown=2, retune_budget=2)
    jwd = jobs.PerformanceWatchdog(**wd_kw)
    jsvc = _jsvc(top_k=1)
    js, jres = _drift_session(
        lambda svc, wd, rec, fi: JaxSession(
            jm, jp, dispatch=svc, backend="reference", batch_sizes=(2,),
            bucket_lengths=(8, 16), straggler_threshold=1e9, faults=fi,
            telemetry=jobs.Telemetry(metrics=jobs.MetricsRegistry()),
            watchdog=wd, recorder=rec),
        jsvc, jwd, jobs.FlightRecorder(out_dir=str(tmp_path / "jax")),
        jfaults.FaultInjector([jfaults.parse_fault(spec)]))
    wd = PerformanceWatchdog(**wd_kw)
    svc = _svc(top_k=1)
    tel = Telemetry(metrics=MetricsRegistry())
    s, res = _drift_session(
        lambda svc, wd, rec, fi: ServeSession(
            tm, tp, dispatch=svc, backend="cuda", batch_sizes=(2,),
            bucket_lengths=(8, 16), straggler_threshold=1e9, faults=fi,
            telemetry=tel, watchdog=wd, recorder=rec, max_recompiles=2),
        svc, wd, FlightRecorder(out_dir=str(tmp_path / "port")),
        FaultInjector.from_strings([spec]))
    assert all(r.state == RequestState.COMPLETED for r in res)
    assert [r.tokens.tolist() for r in res] == [
        np.asarray(r.tokens).tolist() for r in jres]

    drifts = [e for e in wd.events if e.kind == "drift"]
    jdrifts = [e for e in jwd.events if e.kind == "drift"]
    assert drifts and [e.step for e in drifts] == [e.step for e in jdrifts]
    ev = drifts[0]
    assert FAULT_START <= ev.step <= FAULT_START + wd.patience
    assert len(drifts) == 1 and ev.step == FAULT_START + 1
    assert ev.data["reopened"] is True
    slot, old = ev.data["slot"], ev.data["old_schedule"]
    assert old is not None and svc.is_committed(slot)
    new = svc.committed_schedule(slot)
    assert isinstance(new, dict)
    assert svc.metrics.counter("dispatch.reopens_total").value >= 1
    assert svc.metrics.counter("dispatch.commits_total").value >= 2
    # the ledger: every kind in the JAX session's order, the drift among
    # them, and each counted and traced on the telemetry
    assert ([e.kind for e in s.stats.events]
            == [e.kind for e in js.stats.events])
    assert "drift" in [e.kind for e in s.stats.events]
    assert tel.metrics.counter("serve.events.drift_total").value == len(
        drifts)
    assert tel.metrics.counter("watchdog.drift_total").value == len(drifts)
    instants = [e["name"] for e in tel.tracer.to_chrome()["traceEvents"]
                if e["ph"] == "i"]
    assert "event:drift" in instants
    # the injector fired one slow event a step of its window
    assert [e.step for e in s._faults.fired if e.kind == "slow"] == list(
        range(FAULT_START, FAULT_START + FAULT_LEN))

    bundle = json.loads((tmp_path / "port" / "postmortem-drift.json")
                        .read_text())
    bev = [e for e in bundle["timeline"] if e.get("kind") == "drift"][0]
    assert bev["slot"] == slot and bev["old_schedule"] == old
    assert bundle["schedules"][slot]["committed"] == new
    assert bundle["schedules"][slot]["machine"]
    assert bundle["watchdog"]["drifts"] >= 1
    assert set(bundle["request_lifecycles"]) <= {"r0", "r1"}
    jbundle = json.loads((tmp_path / "jax" / "postmortem-drift.json")
                         .read_text())
    assert sorted(bundle) == sorted(jbundle)
    assert ([e["type"] for e in bundle["timeline"]]
            == [e["type"] for e in jbundle["timeline"]])


def _stream(models, arch, backend, watchdog=None, recorder=None,
            telemetry=None):
    """The three-request reference stream, optionally with the reactive
    layer bound."""
    _, _, tm, tp = models[arch]
    s = ServeSession(tm, tp, backend=backend, batch_sizes=(1, 2),
                     bucket_lengths=(8, 16), straggler_threshold=1e9,
                     dispatch=_svc(top_k=3), watchdog=watchdog,
                     recorder=recorder, telemetry=telemetry)
    rng = np.random.default_rng(0)
    for i in range(3):
        s.submit(rng.integers(0, tm.cfg.vocab_size, 5 + i),
                 max_new_tokens=3, request_id=f"req-{i}")
    return s, s.drain()


@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_watchdog_and_recorder_off_is_bit_identical(models, tmp_path, arch,
                                                    backend):
    s_plain, plain = _stream(models, arch, backend)
    wd = PerformanceWatchdog(("ttft_p95<=10",), ratio=1e9)
    rec = FlightRecorder(out_dir=str(tmp_path / "pm"))
    s_wd, wired = _stream(models, arch, backend, watchdog=wd, recorder=rec)
    assert ([r.tokens.tolist() for r in plain]
            == [r.tokens.tolist() for r in wired])
    assert [r.state for r in plain] == [r.state for r in wired]
    assert ([e.kind for e in s_wd.stats.events]
            == [e.kind for e in s_plain.stats.events])
    assert rec.dumps == {} and not (tmp_path / "pm").exists()
    assert wd.report()["slo"]["ttft_p95"]["samples"] == 3
    assert wd.report()["slots"]          # the decode slot was watched


def test_the_session_records_the_watchdogs_events_without_a_sink(models):
    """The session binds no ``on_event``: the SLO page ``tick`` returns
    reaches its ledger, counters and trace once, and a watchdog shared by
    two sessions reports each its own events."""
    wd = PerformanceWatchdog(("ttft_p95<=1e-9",), min_samples=1,
                             short_window=1, long_window=1)
    tel = Telemetry(metrics=MetricsRegistry())
    s, _ = _stream(models, PHI3, "cuda", watchdog=wd, telemetry=tel)
    assert wd.on_event is None
    pages = [e for e in s.stats.events if e.kind == "slo_page"]
    assert len(pages) == 1 and pages[0] is wd.events[0]
    assert tel.metrics.counter("serve.events.slo_page_total").value == 1
    assert tel.metrics.counter("slo.pages_total").value == 1
    s2, _ = _stream(models, PHI3, "cuda", watchdog=wd)
    assert [e.kind for e in s2.stats.events] == []   # still paged: no re-fire
    assert wd.dispatch is s.dispatch                 # the first binding wins


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_a_session_with_a_watchdog_and_recorder_is_freed_without_gc(
        models, tmp_path, arch):
    """The watchdog and the recorder hold no bound method of the session,
    so the session (on a card, its graphs and pool) goes when its last
    reference does, and a watchdog that outlives it keeps none of it."""
    import gc
    import weakref
    _, _, tm, tp = models[arch]
    wd = PerformanceWatchdog(("ttft_p95<=10",), ratio=3.0, patience=2)
    rec = FlightRecorder(out_dir=str(tmp_path))
    collecting = gc.isenabled()
    gc.disable()
    try:
        s = ServeSession(tm, tp, dispatch=_svc(top_k=1), watchdog=wd,
                         recorder=rec, straggler_threshold=2.0,
                         telemetry=Telemetry(metrics=MetricsRegistry()),
                         faults=FaultInjector.from_strings(["slow@2x3"]))
        s.submit(np.arange(1, 6), 6)
        s.drain()
        s.run_batch({"tokens": np.ones((1, 8), np.int32)}, max_new_tokens=3)
        assert rec.dumps                 # the slowdown was recorded
        ref = weakref.ref(s)
        step = weakref.ref(s.exec_cache.peek(s.exec_cache.compiled_log[0]))
        del s
        assert ref() is None and step() is None
    finally:
        if collecting:
            gc.enable()
