"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU.

The measurement modules are the port's own copies: the same calls on
both packages must give byte-equal exports (Prometheus text, metric
snapshots, trace JSON, lifecycle records), so that
``tools/check_trace.py`` and a dashboard read either package.  Then the
port's session, instrumented at the JAX session's points, is driven
through ``tests/test_obs.py``'s three-request stream under a fake
telemetry clock: its trace is byte-identical across runs, its
``(ph, name, cat)`` sequence, counters, histogram counts and lifecycle
records equal the JAX session's (JAX ``backend="reference"``, the port
``"plain"`` and ``"cuda"``, the kernels' plain versions on CPU
tensors).  Preempted requests carry a null TTFT, the off path never
touches the tracer, and ``launch/serve``'s artifacts pass
``tools/check_trace.py``.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.dispatch import DispatchService as JaxService  # noqa: E402
from repro.runtime.ft import StragglerMonitor as JaxMonitor  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import tuner  # noqa: E402
from repro_torch.core.loopnest import ConvLayer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import (NULL_TELEMETRY, LifecycleLog,  # noqa: E402
                             MetricsRegistry, NullTracer, SpanTracer,
                             Telemetry)
from repro_torch.runtime.dispatch import DispatchService  # noqa: E402
from repro_torch.runtime.ft import StragglerMonitor  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PHI3, MAMBA = "phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke"


class FakeClock:
    """Deterministic monotonic clock: each reading advances 1 ms."""

    def __init__(self, start=100.0, tick=1e-3):
        self.t = start
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _check_trace_module():
    spec = importlib.util.spec_from_file_location(
        "check_trace", REPO / "tools" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _models(arch):
    jm = jax_build_model(jax_get_config(arch))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(arch)), tp


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in (PHI3, MAMBA)}


# ------------------------------------------------- the modules, unit parity

def _drive_metrics(pkg):
    r = pkg.MetricsRegistry()
    c = r.counter("serve.exec_cache_hits_total", help="hits")
    c.inc()
    c.inc(2.5)
    g = r.gauge("serve.kv_fragmentation")
    g.set(4)
    g.inc()
    g.dec(0.75)
    h = r.histogram("serve.ttft_seconds", help="ttft")
    for v in (0.00005, 0.003, 0.2, 7.0, 99.0, 0.0001):
        h.observe(v)
    r.histogram("c.seconds", buckets=(1.0, 0.1)).observe(0.5)
    r.set_gauges({"hits": 3, "rate": 0.5, "on": True, "name": "lru"},
                 prefix="serve.exec_cache.", help="snapshot")
    with pytest.raises(TypeError):
        r.gauge("serve.exec_cache_hits_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    return r


def test_metrics_exports_are_byte_equal(tmp_path):
    mine, theirs = _drive_metrics(obs), _drive_metrics(jobs)
    assert mine.to_prometheus() == theirs.to_prometheus()
    assert (json.dumps(mine.snapshot(), sort_keys=True)
            == json.dumps(theirs.snapshot(), sort_keys=True))
    assert mine.names() == theirs.names()
    assert "serve.exec_cache.on" not in mine.names()
    assert mine.histogram("c.seconds").buckets == (0.1, 1.0)
    for name in ("serve.ttft_seconds", "bench.serve.cache_hit_rate", "9x"):
        assert obs.prom_name(name) == jobs.prom_name(name)
    a, b = tmp_path / "a.prom", tmp_path / "b.prom"
    mine.write_prometheus(str(a))
    theirs.write_prometheus(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert _check_trace_module().check_metrics(
        str(a), ["serve_ttft_seconds", "serve_kv_fragmentation"]) == []


def test_process_registry_swap():
    fresh = MetricsRegistry()
    prev = obs.set_metrics_registry(fresh)
    try:
        assert obs.get_metrics_registry() is fresh
    finally:
        assert obs.set_metrics_registry(prev) is fresh
    assert obs.get_metrics_registry() is prev


def _drive_tracer(tr):
    with tr.span("outer", step=0):
        with tr.span("inner", cat="x", tid=1):
            tr.instant("tick", n=1)
    tr.complete("manual", 100.002, 100.004, what="x")
    tr.async_begin("request", "r1", request_id="r1")
    tr.async_end("request", "r1", state="COMPLETED")
    return tr


def test_tracer_exports_are_byte_equal(tmp_path):
    mine = _drive_tracer(SpanTracer(clock=FakeClock(), process_name="repro"))
    theirs = _drive_tracer(jobs.SpanTracer(clock=FakeClock()))
    assert mine.to_json() == theirs.to_json()
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    mine.write(str(a))
    theirs.write(str(b))
    assert a.read_bytes() == b.read_bytes()
    assert _check_trace_module().check_trace(str(a)) == []
    # the one deliberate difference: the default process name
    default = SpanTracer(clock=FakeClock())
    meta = default.to_chrome()["traceEvents"][0]
    assert meta["args"] == {"name": "repro_torch"}
    nt, jnt = NullTracer(), jobs.NullTracer()
    assert nt.enabled is jnt.enabled is False
    with nt.span("x"):
        nt.instant("y")
    nt.async_begin("request", "r")
    assert nt.to_json() == jnt.to_json()


def _drive_lifecycle(log):
    log.submitted("r1", 10.0)
    log.submitted("r1", 99.0)
    log.admitted("r1", 10.5)
    log.token("r1", 11.0)
    log.token("r1", 12.0, n=2)
    log.decode_step("r1")
    log.terminal("r1", 12.5, "COMPLETED")
    log.submitted("r0", 9.0)
    log.terminal("r0", 9.2, "REJECTED", reason="kv pool too small")
    log.submitted("r2", 11.0)
    log.admitted("r2", 11.1)
    log.terminal("r2", 11.4, "CANCELLED")
    log.token("ghost", 1.0)
    log.terminal("ghost", 2.0, "FAILED")
    return log


def test_lifecycle_records_are_equal():
    mine = _drive_lifecycle(LifecycleLog())
    theirs = _drive_lifecycle(jobs.LifecycleLog())
    assert (json.dumps(mine.as_dicts(), sort_keys=True)
            == json.dumps(theirs.as_dicts(), sort_keys=True))
    assert mine.ttft_values() == theirs.ttft_values() == [1.0]
    assert [d["ttft_s"] for d in mine.as_dicts()] == [None, 1.0, None]


def test_telemetry_bundles_match():
    assert NULL_TELEMETRY.enabled is False
    assert isinstance(NULL_TELEMETRY.tracer, NullTracer)
    assert NULL_TELEMETRY.watchdog is None and NULL_TELEMETRY.recorder is None
    clock = FakeClock()
    tel = Telemetry(clock=clock)
    assert tel.enabled and tel.clock is clock
    assert tel.metrics is obs.get_metrics_registry()
    assert tel.tracer._clock is clock
    assert sorted(obs.__all__) == sorted(jobs.__all__)


def test_straggler_summary_and_export_match_jax():
    times = [0.01] * 8 + [0.5, 0.01, 0.011, 0.2, 0.01]
    ours, ref = StragglerMonitor(threshold=3.0), JaxMonitor(threshold=3.0)
    for i, t in enumerate(times):
        ours.record(i, t)
        ref.record(i, t)
    assert ours.summary() == ref.summary()
    m, jm = MetricsRegistry(), jobs.MetricsRegistry()
    ours.export_metrics(m)
    ref.export_metrics(jm)
    assert m.to_prometheus() == jm.to_prometheus()
    assert "serve.straggler.events" in m.names()


def test_tuner_counts_sweeps_and_warm_hits():
    fresh = MetricsRegistry()
    prev = obs.set_metrics_registry(fresh)
    try:
        r = reg.TuningRegistry(None)
        layer = ConvLayer(64, 32, 14, 14, 3, 3)
        tuner.cached_tune_conv(layer, registry=r, top_k=3)
        tuner.cached_tune_conv(layer, registry=r, top_k=3)
    finally:
        obs.set_metrics_registry(prev)
    snap = fresh.snapshot()
    assert snap["tune.sweeps_total"]["value"] == 1
    assert snap["tune.warm_hits_total"]["value"] == 1
    assert snap["tune.cost_model_evals_total"]["value"] > 0
    assert snap["tune.sweep_wall_s_total"]["value"] > 0


# ------------------------------------------- the session, against JAX's

def _jax_service(metrics=None):
    return JaxService(jreg.TuningRegistry(None),
                      metrics=metrics or jobs.MetricsRegistry())


def _port_service(metrics=None):
    return DispatchService(reg.TuningRegistry(None), device="cpu",
                           metrics=metrics or MetricsRegistry())


def _stream(session, vocab):
    """``tests/test_obs.py``'s three requests (fixed ids)."""
    rng = np.random.default_rng(0)
    for i in range(3):
        session.submit(rng.integers(0, vocab, 5 + i), max_new_tokens=3,
                       request_id=f"req-{i}")
    res = session.drain()
    assert len(res) == 3
    return res


# 2 rows: with (1, 2) the dispatch-aware bucket choice weighs each
# package's own cost model (the TPU's, the H100's) and the two engines
# take other rows
BATCH_SIZES = (2,)


def _run_jax(models, arch, telemetry, **kw):
    jm, jp, _, _ = models[arch]
    s = JaxSession(jm, jp, backend="reference", batch_sizes=BATCH_SIZES,
                   bucket_lengths=(8, 16), straggler_threshold=1e9,
                   dispatch=_jax_service(telemetry and telemetry.metrics),
                   telemetry=telemetry, **kw)
    return s, _stream(s, jm.cfg.vocab_size)


def _run_port(models, arch, telemetry, backend="cuda", **kw):
    _, _, tm, tp = models[arch]
    s = ServeSession(tm, tp, backend=backend, batch_sizes=BATCH_SIZES,
                     bucket_lengths=(8, 16), straggler_threshold=1e9,
                     dispatch=_port_service(telemetry and telemetry.metrics),
                     telemetry=telemetry, **kw)
    return s, _stream(s, tm.cfg.vocab_size)


def _phases(tel):
    return [(e["ph"], e["name"], e.get("cat"))
            for e in tel.tracer.to_chrome()["traceEvents"]]


# families whose values a clock measured, and the commits, which count
# the slots whose candidates were all probed: the port offers its own
# (float32 flash, one tile; the split decode's block_kv)
NOT_COMPARED = ("serve.straggler.ewma_s", "dispatch.commits_total")


def _comparable(snapshot):
    """Counters and gauges by value, histograms by count."""
    out = {}
    for name, d in snapshot.items():
        if name in NOT_COMPARED:
            continue
        out[name] = d["count"] if d["type"] == "histogram" else d["value"]
    return out


@pytest.fixture(scope="module")
def jax_telemetry(models):
    out = {}
    for arch in (PHI3, MAMBA):
        tel = jobs.Telemetry(metrics=jobs.MetricsRegistry(),
                             clock=FakeClock())
        s, res = _run_jax(models, arch, tel)
        out[arch] = (tel, s, res)
    return out


@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_session_telemetry_matches_the_jax_session(models, jax_telemetry,
                                                   arch, backend):
    runs = []
    for _ in range(2):
        tel = Telemetry(metrics=MetricsRegistry(), clock=FakeClock())
        runs.append((tel,) + _run_port(models, arch, tel, backend=backend))
    (a, s, res), (b, _, _) = runs
    # byte-identical across runs under the fake clock
    assert a.tracer.to_json().encode() == b.tracer.to_json().encode()
    jtel, js, jres = jax_telemetry[arch]
    assert _phases(a)[2:] == _phases(jtel)[2:]
    assert _phases(a)[:2] == [("M", "process_name", None),
                              ("M", "thread_name", None)]
    names = {n for _, n, _ in _phases(a)}
    assert {"serve.step", "serve.admit", "serve.prefill",
            "serve.decode_step", "serve.activation", "serve.aot_compile",
            "request"} <= names
    # every family both export holds the JAX session's value (histograms
    # their counts)
    mine, theirs = (_comparable(a.metrics.snapshot()),
                    _comparable(jtel.metrics.snapshot()))
    shared = set(mine) & set(theirs)
    assert {"serve.requests_submitted_total", "dispatch.observations_total",
            "serve.inflight_admissions_total",
            "serve.requests_completed_total", "serve.ttft_seconds",
            "serve.decode_step_seconds", "serve.exec_cache_misses_total",
            "serve.exec_cache.compiles", "serve.straggler.steps"} <= shared
    assert {k: mine[k] for k in shared} == {k: theirs[k] for k in shared}
    assert set(theirs) - set(mine) == set()
    assert a.metrics.counter("serve.aot_fallbacks_total").value == 0
    assert (a.metrics.counter("dispatch.commits_total").value
            == s.dispatch.commits)
    # lifecycle records: states, tokens, decode steps, TTFT presence
    keep = ("request_id", "state", "tokens", "decode_steps", "reason")
    recs = [{k: d[k] for k in keep} for d in a.lifecycle.as_dicts()]
    jrecs = [{k: d[k] for k in keep} for d in jtel.lifecycle.as_dicts()]
    assert recs == jrecs
    assert ([d["ttft_s"] is None for d in a.lifecycle.as_dicts()]
            == [d["ttft_s"] is None for d in jtel.lifecycle.as_dicts()])
    assert all(d["state"] == "COMPLETED" and d["ttft_s"] > 0
               for d in a.lifecycle.as_dicts())
    assert ([r.tokens.tolist() for r in res]
            == [np.asarray(r.tokens).tolist() for r in jres])


def test_trace_and_lifecycle_pass_check_trace(models, tmp_path):
    tel = Telemetry(metrics=MetricsRegistry(), clock=FakeClock())
    _run_port(models, PHI3, tel)
    trace, prom, life = (tmp_path / "t.json", tmp_path / "m.prom",
                         tmp_path / "l.json")
    tel.tracer.write(str(trace))
    tel.metrics.write_prometheus(str(prom))
    life.write_text(json.dumps(tel.lifecycle.as_dicts()))
    ct = _check_trace_module()
    assert ct.check_trace(str(trace)) == []
    assert ct.check_metrics(str(prom), ["serve_ttft_seconds",
                                        "serve_decode_step_seconds",
                                        "serve_events_total"]) == []
    assert ct.check_lifecycle(str(life)) == []


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_preempted_requests_have_null_ttft(models, tmp_path, backend):
    """``tests/test_obs.py``'s preempted stream on both packages:
    REJECTED, TIMED_OUT before a first token and CANCELLED carry a null
    TTFT, the states equal JAX's, and the export passes
    ``check_trace.py --lifecycle``."""
    def stream(s):
        prompt = np.array([3, 5, 7], dtype=np.int64)
        s.submit(prompt, max_new_tokens=1, request_id="r-ok")
        s.submit(prompt, max_new_tokens=9, request_id="r-reject")
        s.submit(prompt, max_new_tokens=1, request_id="r-timeout",
                 deadline_s=0.0)
        s.submit(prompt, max_new_tokens=1, request_id="r-cancel")
        assert s.cancel("r-cancel") is True
        return {r.request_id: r.state for r in s.drain()}

    kw = dict(kv_block_size=4, kv_blocks=2)
    jtel = jobs.Telemetry(metrics=jobs.MetricsRegistry(), clock=FakeClock())
    jm, jp, tm, tp = models[PHI3]
    jstates = stream(JaxSession(
        jm, jp, dispatch=_jax_service(), backend="reference",
        batch_sizes=(1, 2), bucket_lengths=(8, 16), straggler_threshold=1e9,
        telemetry=jtel, **kw))
    tel = Telemetry(metrics=MetricsRegistry(), clock=FakeClock())
    states = stream(ServeSession(
        tm, tp, dispatch=_port_service(), backend=backend,
        batch_sizes=(1, 2), bucket_lengths=(8, 16), straggler_threshold=1e9,
        telemetry=tel, **kw))
    assert states == jstates == {"r-ok": "COMPLETED", "r-reject": "REJECTED",
                                 "r-timeout": "TIMED_OUT",
                                 "r-cancel": "CANCELLED"}
    recs = {d["request_id"]: d for d in tel.lifecycle.as_dicts()}
    jrecs = {d["request_id"]: d for d in jtel.lifecycle.as_dicts()}
    assert recs["r-ok"]["ttft_s"] > 0
    for rid in ("r-reject", "r-timeout", "r-cancel"):
        assert recs[rid]["first_token_ts"] is None
        assert recs[rid]["ttft_s"] is None is jrecs[rid]["ttft_s"]
        assert recs[rid]["finished_ts"] >= recs[rid]["submitted_ts"]
        assert recs[rid]["state"] == jrecs[rid]["state"]
    for state in ("rejected", "timed_out", "cancelled", "completed"):
        name = f"serve.requests_{state}_total"
        assert (tel.metrics.counter(name).value
                == jtel.metrics.counter(name).value == 1)
    path = tmp_path / "lifecycle.json"
    path.write_text(json.dumps(tel.lifecycle.as_dicts()))
    assert _check_trace_module().check_lifecycle(str(path)) == []
    trace = tmp_path / "trace.json"
    tel.tracer.write(str(trace))
    assert _check_trace_module().check_trace(str(trace)) == []


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_telemetry_off_never_touches_the_tracer(models, monkeypatch, arch):
    def boom(*a, **k):
        raise AssertionError("the telemetry-off path touched the tracer")

    for name in ("span", "complete", "instant", "async_begin", "async_end"):
        monkeypatch.setattr(NullTracer, name, boom)
    s, res = _run_port(models, arch, None)
    assert s.telemetry is NULL_TELEMETRY
    assert all(r.state == "COMPLETED" for r in res)
    assert NULL_TELEMETRY.lifecycle.records == {}
    assert NULL_TELEMETRY.metrics.names() == []


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_telemetry_on_off_results_identical(models, backend):
    tel = Telemetry(metrics=MetricsRegistry(), clock=FakeClock())
    s_on, on = _run_port(models, PHI3, tel, backend=backend)
    s_off, off = _run_port(models, PHI3, None, backend=backend)
    assert [r.tokens.tolist() for r in on] == [r.tokens.tolist() for r in off]
    assert [r.state for r in on] == [r.state for r in off]
    assert ([e.kind for e in s_on.stats.events]
            == [e.kind for e in s_off.stats.events])


def test_bucketed_path_lifecycle_and_spans(models):
    """Sampled traffic runs ``_drain_batched``: each request's lifecycle
    closes COMPLETED with its whole budget at once, as in the JAX
    session, and the trace holds the ``serve.prefill`` and
    ``serve.decode`` spans of ``run_batch``."""
    _, _, tm, tp = models[PHI3]
    tel = Telemetry(metrics=MetricsRegistry(), clock=FakeClock())
    s = ServeSession(tm, tp, batch_sizes=(1, 2), temperature=0.8,
                     telemetry=tel)
    for i, n in enumerate((5, 6, 7)):
        s.submit(np.arange(1, n + 1), max_new_tokens=3, request_id=f"b{i}")
    assert all(r.state == "COMPLETED" for r in s.drain())
    recs = tel.lifecycle.as_dicts()
    assert [(d["state"], d["tokens"]) for d in recs] == [("COMPLETED", 3)] * 3
    assert all(d["ttft_s"] > 0 for d in recs)
    names = [n for _, n, _ in _phases(tel)]
    assert names.count("serve.prefill") == names.count("serve.decode") == 2
    assert tel.metrics.histogram("serve.ttft_seconds").count == 3
    assert tel.metrics.counter("serve.requests_submitted_total").value == 3


def test_dispatch_counts_and_traces_on_the_telemetry():
    """The service's counters land on the registry it is given and its
    tracer gets a ``dispatch.resolve`` span per cold resolution and a
    ``dispatch.commit`` instant per commit, as the JAX service's."""
    tel = Telemetry(metrics=MetricsRegistry(), clock=FakeClock())
    svc = DispatchService(reg.TuningRegistry(None), device="cpu", top_k=2,
                          probes_per_candidate=1, max_extra_probes=0,
                          metrics=tel.metrics, tracer=tel.tracer)
    jtel = jobs.Telemetry(metrics=jobs.MetricsRegistry(), clock=FakeClock())
    jsvc = JaxService(jreg.TuningRegistry(None), top_k=2,
                      probes_per_candidate=1, max_extra_probes=0,
                      metrics=jtel.metrics, tracer=jtel.tracer)
    problem = {"m": 128, "n": 128, "k": 128}
    for service in (svc, jsvc):
        for dt in (2e-3, 1e-3, 1e-3):
            service.propose("matmul", problem)
            service.observe("matmul", problem, dt)
        service.reopen(service.resolve("matmul", problem))
    assert tel.metrics.to_prometheus() == jtel.metrics.to_prometheus()
    assert _phases(tel)[2:] == _phases(jtel)[2:]
    assert [n for _, n, _ in _phases(tel)[2:]] == [
        "dispatch.resolve", "dispatch.commit", "dispatch.reopen"]
    assert (svc.resolves, svc.proposals, svc.observations, svc.commits) == (
        1, 3, 3, 1)


def test_launch_serve_writes_artifacts_check_trace_accepts(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli

    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    serve_cli.main(["--arch", PHI3, "--device", "cpu", "--session",
                    "--num-requests", "4", "--batch-sizes", "1,2",
                    "--new-tokens", "6", "--dispatch",
                    "--registry", str(tmp_path / "t.jsonl"),
                    "--trace-out", str(trace), "--metrics-out", str(prom),
                    "--watchdog", "--slo", "ttft_p95<=10",
                    "--postmortem-dir", str(tmp_path / "pm")])
    out = capsys.readouterr().out
    assert "session: 4 requests" in out
    assert "watchdog: drift=" in out and "slo_pages=0" in out
    assert "ttft_p95<=10: burn 0.00/0.00" in out
    # a host-jitter straggler may dump a bundle: each is one JSON object
    for path in sorted((tmp_path / "pm").glob("postmortem-*.json")):
        assert path.stem.split("-", 1)[1] in out
        assert "timeline" in json.loads(path.read_text())
    ct = _check_trace_module()
    assert ct.main(["--trace", str(trace), "--metrics", str(prom),
                    "--require", "serve_ttft_seconds",
                    "--require", "dispatch_commits_total"]) == 0
    text = prom.read_text()
    assert "slo_ttft_p95_ok 1.0" in text and "watchdog_slots_watched" in text
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"serve.step", "request", "dispatch.resolve"} <= names
