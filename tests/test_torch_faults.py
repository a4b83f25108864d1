"""The port's request lifecycle and fault injection against the JAX
session, on the CPU.

Every scenario of ``tests/test_faults.py`` (and the backpressure,
rejection and compaction streams of ``tests/test_paged_kv.py`` under
cancellation and deadlines) is replayed on both packages with the same
weights (the JAX init, bridged) and the same fault schedule: the token
streams, the retirement order, the terminal states, the reasons (with
their wall-clock seconds masked), the session counters, the session's
events (without their timestamps) and the injector's fired log must be
equal.  The JAX session runs ``backend="reference"``, the port
``"cuda"`` (the kernels' plain versions on CPU tensors).  Both run with
``straggler_threshold=20``: the injected 10 s spike is hundreds of
times a smoke step on any CPU, while the host's own jitter stays under
it.

Where the two packages differ by design, the port's behaviour is
asserted instead: with the port's default ``fallback_backend="none"`` a
persistent build failure raises out of ``drain`` (the JAX session keeps
its un-lowered jit step), and a NaN is written into the row's logits
through the step's poison-mask input (the JAX engine sets it on the
logits it holds).

The degradation scenarios (``fallback_backend="eager"`` against the JAX
``"reference"`` with ``backend="pallas"``) and the containment of a
prefill or decode step that raises (the step callable wrapped in the
test, on both packages) are replayed the same way.
"""
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.obs import events as jevents  # noqa: E402
from repro.runtime.ft import StragglerMonitor as JaxMonitor  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import events as tevents  # noqa: E402
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.runtime.ft import StragglerMonitor  # noqa: E402
from repro_torch.serving import (FaultInjector, FaultSpec,  # noqa: E402
                                 InjectedFault, RequestState, ServeSession,
                                 parse_fault)
from repro_torch.serving import faults as tfaults  # noqa: E402

PHI3, MAMBA = "phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke"
THRESHOLD = 20.0


def _models(arch):
    jm = jax_build_model(jax_get_config(arch))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(arch)), tp


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in (PHI3, MAMBA)}


def _prompts(lengths, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=n).astype(np.int32) for n in lengths]


@dataclasses.dataclass
class Scenario:
    """A stream, the session's knobs, a fault schedule and the client's
    actions.  ``actions`` maps an engine step (``on_step``'s
    ``info["step"]``, each taken once) to ``("cancel", rid)``,
    ``("clock", t)`` (the fake session clock) or ``("submit", rid, len,
    budget)``; ``post`` runs after the first drain (``submit`` and
    ``cancel``), followed by a second drain."""

    archs: tuple
    lens: list
    budgets: list
    kw: dict = dataclasses.field(default_factory=dict)
    faults: tuple = ()
    actions: dict = dataclasses.field(default_factory=dict)
    deadlines: dict = dataclasses.field(default_factory=dict)
    fake_clock: bool = False
    hold: int = 0
    post: tuple = ()


BOTH = (PHI3, MAMBA)
SCENARIOS = {
    # tests/test_faults.py
    "nan_poison_row": Scenario(BOTH, [5, 7, 3], [6, 6, 6],
                               dict(kv_block_size=4), ("nan@2.1",),
                               post=(("submit", "after", 5, 3),)),
    "double_free": Scenario((PHI3,), [5, 7, 3], [4, 6, 5],
                            dict(kv_block_size=4), ("doublefree@0x99",)),
    "compaction_partly_failed": Scenario(
        (PHI3,), [5] * 6, [2, 12] * 3,
        dict(kv_block_size=2, batch_sizes=(4,)), ("nan@4.1",)),
    "transient_compile": Scenario(
        BOTH, [5, 7, 3], [4, 6, 5],
        dict(kv_block_size=4, compile_retries=2), ("compile@0",)),
    "alloc_backpressure": Scenario((PHI3,), [5, 7, 3], [4, 6, 5],
                                   dict(kv_block_size=4), ("alloc@0x2",)),
    "straggler_hold": Scenario(BOTH, [5, 7, 3], [10, 10, 10],
                               dict(kv_block_size=4), ("slow@7",), hold=2),
    "deadline_mid_decode": Scenario(
        BOTH, [6, 5], [10, 4], dict(kv_block_size=4),
        actions={3: [("clock", 1.0)]}, deadlines={0: 0.5},
        fake_clock=True),
    "deadline_in_queue": Scenario(BOTH, [5], [4],
                                  dict(request_deadline_s=0.0)),
    "shed": Scenario(BOTH, [5], [4], dict(max_queue_s=0.0)),
    "cancel_queued_and_running": Scenario(
        BOTH, [6, 5], [8, 8], dict(kv_block_size=4),
        actions={2: [("cancel", "r1")]},
        post=(("submit", "queued", 6, 4), ("cancel", "queued"),
              ("cancel", "nonexistent"))),
    # tests/test_paged_kv.py's streams under cancellation and deadlines
    "backpressure_cancel": Scenario(
        (PHI3,), [5, 5, 5, 5], [4, 4, 4, 4],
        dict(kv_block_size=4, kv_blocks=5, batch_sizes=(4,)),
        actions={1: [("cancel", "r0")]}),
    "rejection_deadline": Scenario(
        (PHI3,), [6, 3, 4], [8, 2, 6], dict(kv_block_size=4, kv_blocks=4),
        actions={2: [("clock", 5.0)]}, deadlines={2: 1.0},
        fake_clock=True),
    "compaction_cancel_readmit": Scenario(
        BOTH, [5] * 6, [2, 12] * 3,
        dict(kv_block_size=2, batch_sizes=(4,)),
        actions={3: [("cancel", "r1")], 4: [("submit", "late", 7, 5)]}),
}
CASES = [(name, arch) for name, sc in SCENARIOS.items() for arch in sc.archs]


def _reason_kind(reason):
    """The reason with its measured seconds masked."""
    return None if reason is None else re.sub(r"\d+\.\d+s", "<t>s", reason)


MEASURED = {"ts", "duration_s", "ewma_s", "ratio"}


def _events(evs):
    """Events as dicts without the fields a clock measured."""
    return [{k: v for k, v in e.as_dict().items() if k not in MEASURED}
            for e in evs]


def _replay(session, sc):
    """Drive ``session`` through the scenario; its results in order."""
    fake = [0.0]
    if sc.fake_clock:
        session._clock = lambda: fake[0]
    for i, (p, b) in enumerate(zip(_prompts(sc.lens), sc.budgets)):
        session.submit(p, b, request_id=f"r{i}",
                       deadline_s=sc.deadlines.get(i))
    todo = {k: list(v) for k, v in sc.actions.items()}
    cancels = []

    def act(op):
        if op[0] == "cancel":
            cancels.append((op[1], session.cancel(op[1])))
        elif op[0] == "clock":
            fake[0] = op[1]
        else:
            _, rid, n, budget = op
            session.submit(_prompts([n], seed=11)[0], budget,
                           request_id=rid)

    def on_step(info):
        for op in todo.pop(info["step"], []):
            act(op)

    res = session.drain(on_step=on_step)
    if sc.post:
        for op in sc.post:
            act(op)
        res += session.drain()
    return {"results": [(r.request_id, r.state, r.tokens.tolist(),
                         _reason_kind(r.reason)) for r in res],
            "cancels": cancels}


COUNTERS = ("requests", "batches", "steps", "inflight_admissions",
            "compactions", "compile_retries", "rejected", "timed_out", "shed",
            "cancelled", "failed", "poisoned_rows", "stragglers",
            "tokens_generated")


def _session_kw(sc, hooks):
    kw = dict(sc.kw, straggler_threshold=THRESHOLD)
    if sc.faults:
        kw["faults"] = None             # filled per package below
    if sc.hold:
        def on_straggler(ev):
            hooks.append(ev)
            return sc.hold
        kw["on_straggler"] = on_straggler
    return kw


@pytest.fixture(scope="module")
def jax_runs(models):
    out = {}
    for name, arch in CASES:
        sc = SCENARIOS[name]
        jm, jp, _, _ = models[arch]
        hooks = []
        kw = _session_kw(sc, hooks)
        fi = None
        if sc.faults:
            fi = jfaults.FaultInjector(
                [jfaults.parse_fault(f) for f in sc.faults])
            kw["faults"] = fi
        s = JaxSession(jm, jp, backend="reference", **kw)
        run = _replay(s, sc)
        out[name, arch] = (run, s, fi, hooks)
    return out


@pytest.mark.parametrize("name,arch", CASES,
                         ids=[f"{n}-{a.split('-')[0]}" for n, a in CASES])
def test_scenario_matches_the_jax_session(models, jax_runs, name, arch):
    sc = SCENARIOS[name]
    _, _, tm, tp = models[arch]
    hooks = []
    kw = _session_kw(sc, hooks)
    fi = None
    if sc.faults:
        fi = FaultInjector.from_strings(sc.faults)
        kw["faults"] = fi
    s = ServeSession(tm, tp, **kw)
    run = _replay(s, sc)
    j_run, js, j_fi, j_hooks = jax_runs[name, arch]
    assert run == j_run
    for k in COUNTERS:
        assert getattr(s.stats, k) == getattr(js.stats, k), k
    assert _events(s.stats.events) == _events(js.stats.events)
    if fi is not None:
        assert _events(fi.fired) == _events(j_fi.fired) and fi.fired
    assert len(hooks) == len(j_hooks) == (1 if sc.hold else 0)
    assert s._admission_hold == js._admission_hold == 0
    assert not s._running and not s._cancelled
    # each scenario's own contract, beside the equality
    states = {rid: st for rid, st, _, _ in run["results"]}
    if name == "nan_poison_row":
        assert states["r1"] == RequestState.FAILED
        assert s.stats.poisoned_rows == 1 and states["after"] == "COMPLETED"
    if name in ("double_free", "alloc_backpressure", "transient_compile"):
        assert set(states.values()) == {RequestState.COMPLETED}
    if name == "transient_compile":
        assert s.stats.compile_retries == 1
    if name in ("compaction_partly_failed", "compaction_cancel_readmit"):
        assert s.stats.compactions >= 1 or arch == MAMBA
    if name == "straggler_hold":
        assert s.stats.stragglers == 1 and hooks[0].ratio > THRESHOLD
    if name == "deadline_mid_decode":
        toks = {rid: t for rid, _, t, _ in run["results"]}
        assert states["r0"] == RequestState.TIMED_OUT
        assert 0 < len(toks["r0"]) < 10 and states["r1"] == "COMPLETED"
    if name == "shed":
        assert s.stats.shed == 1 == s.stats.timed_out
    if name == "cancel_queued_and_running":
        assert run["cancels"] == [("r1", True), ("queued", True),
                                  ("nonexistent", False)]
        assert states["r1"] == states["queued"] == RequestState.CANCELLED
    if name == "rejection_deadline":
        assert states["r0"] == RequestState.REJECTED
        assert states["r2"] == RequestState.TIMED_OUT
    if name == "backpressure_cancel":
        assert states["r0"] == RequestState.CANCELLED
    if name == "compaction_cancel_readmit":
        assert states["r1"] == RequestState.CANCELLED
        assert states["late"] == RequestState.COMPLETED


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_survivors_equal_an_uninjected_run(models, backend):
    """The poison row retires alone: every other request's tokens equal
    those of the same stream without the fault, on both backends."""
    _, _, tm, tp = models[PHI3]
    prompts = _prompts([5, 7, 3])

    def run(faults):
        s = ServeSession(tm, tp, backend=backend, kv_block_size=4,
                         faults=faults)
        for i, p in enumerate(prompts):
            s.submit(p, 6, request_id=f"r{i}")
        return {r.request_id: r for r in s.drain()}

    clean = run(None)
    dirty = run(FaultInjector([FaultSpec("nan", 2, row=1)]))
    assert dirty["r1"].state == "FAILED" and "non-finite" in dirty["r1"].reason
    assert dirty["r1"].tokens.tolist() == clean["r1"].tokens.tolist()[:3]
    for rid in ("r0", "r2"):
        assert dirty[rid].tokens.tolist() == clean[rid].tokens.tolist()


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_nan_reaches_the_steps_device_flag(models, arch):
    """With an injector the engine's decode step takes a poison mask and
    its own pick reports the poisoned row not finite; without one the
    step has no such input."""
    _, _, tm, tp = models[arch]
    seen = []

    def probe(s):
        def on_step(info):
            dec = [s.exec_cache.peek(k) for k in s.exec_cache.compiled_log
                   if k.role == "decode"][0]
            seen.append(("poison" in dec.inputs,
                         dec.outputs[1].tolist()))
        return on_step

    for faults in (None, FaultInjector([FaultSpec("nan", 1, row=0)])):
        s = ServeSession(tm, tp, batch_sizes=(2,), faults=faults)
        for i, p in enumerate(_prompts([5, 6])):
            s.submit(p, 4, request_id=f"r{i}")
        s.drain(on_step=probe(s))
    clean, dirty = seen[:3], seen[3:]
    assert all(not has and flags == [1, 1] for has, flags in clean)
    assert [flags for _, flags in dirty][:2] == [[1, 1], [0, 1]]
    assert all(has for has, _ in dirty)


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_persistent_build_failure_raises(models, arch):
    """``1 + compile_retries`` failed builds raise out of ``drain`` (and
    out of ``generate``); nothing takes the step's place.  The JAX
    session degrades the bucket instead (``tests/test_faults.py``)."""
    _, _, tm, tp = models[arch]
    s = ServeSession(tm, tp, compile_retries=2, compile_backoff_s=0.0,
                     faults=FaultInjector.from_strings(["compile@0x3"]))
    s.submit(_prompts([5])[0], 4, request_id="r0")
    with pytest.raises(InjectedFault, match="attempt 2"):
        s.drain()
    assert s.stats.compile_retries == 2 and s.exec_cache.compiles == 0
    assert [e.kind for e in s.stats.events] == ["compile_failure"]
    assert s.stats.events[0].what == "prefill[b1,p8]"
    # generate: the decode step's build fails after the prefill's
    s = ServeSession(tm, tp, compile_retries=1, compile_backoff_s=0.0,
                     faults=FaultInjector.from_strings(["compile@1x2"]))
    batch = {"tokens": np.ones((2, 8), np.int32)}
    with pytest.raises(InjectedFault):
        generate(tm, tp, batch, max_new_tokens=3, session=s)
    assert s.exec_cache.compiled_roles() == {"prefill": 1}
    assert s.stats.events[-1].what == "decode[b2,t11]"


def test_transient_build_failure_in_run_batch_keeps_the_tokens(models):
    _, _, tm, tp = models[PHI3]
    batch = {"tokens": np.asarray(_prompts([8, 8]))}
    want, _ = generate(tm, tp, batch, max_new_tokens=5)
    s = ServeSession(tm, tp, compile_retries=1,
                     faults=FaultInjector.from_strings(["compile@1"]))
    got, _ = generate(tm, tp, batch, max_new_tokens=5, session=s)
    assert np.array_equal(got, want) and s.stats.compile_retries == 1


def test_parse_fault_and_injector_match_jax():
    for spec in ("nan@3", "compile@0x3", "nan@2.1", "slow@5x2.1",
                 "alloc@0x2", "doublefree@4"):
        assert (dataclasses.asdict(parse_fault(spec))
                == dataclasses.asdict(jfaults.parse_fault(spec)))
    assert parse_fault("nan@2.1") == FaultSpec("nan", 2, row=1)
    assert tfaults.KINDS == jfaults.KINDS
    for bad, match in (("nan3", "cannot parse"),
                       ("frobnicate@3", "unknown fault kind")):
        with pytest.raises(ValueError, match=match):
            parse_fault(bad)
        with pytest.raises(ValueError, match=match):
            jfaults.parse_fault(bad)
    with pytest.raises(ValueError, match="invalid fault spec"):
        FaultSpec("nan", 1, times=0)
    specs = ["alloc@2x2", "nan@1.3", "slow@4", "doublefree@0x2",
             "compile@1"]
    fi = FaultInjector.from_strings(specs)
    jfi = jfaults.FaultInjector.from_strings(specs)
    for inj in (fi, jfi):
        got = [inj.alloc_blocked(i) for i in range(5)]
        assert got == [False, False, True, True, False]
        assert inj.nan_rows(1) == [3] and inj.nan_rows(2) == []
        assert inj.slow_extra_s(4) == 10.0 and inj.slow_extra_s(3) == 0.0
        assert [inj.double_free(i) for i in range(3)] == [True, True, False]
        inj.compile_fault("prefill[b1,p8]")
        err = InjectedFault if inj is fi else jfaults.InjectedFault
        with pytest.raises(err, match="attempt 1"):
            inj.compile_fault("decode[b1,t16]")
    assert _events(fi.fired) == _events(jfi.fired)
    assert [e.step for e in fi.fired if e.kind == "alloc"] == [2, 3]


def test_events_and_straggler_monitor_match_jax():
    args = [("poison_row", 3, "r1", None, {}),
            ("straggler", 7, None, 1.5, {"ratio": 4.0}),
            ("allocator", None, "r2", None, {"error": "double free"})]
    mine = [tevents.Event(k, s, r, t, d) for k, s, r, t, d in args]
    theirs = [jevents.Event(k, s, r, t, d) for k, s, r, t, d in args]
    assert [e.as_dict() for e in mine] == [e.as_dict() for e in theirs]
    assert mine[1].ratio == 4.0
    with pytest.raises(AttributeError):
        mine[0].ratio
    assert (tevents.summarize_events(mine)
            == jevents.summarize_events(theirs))
    assert (tevents.format_event_summary(mine)
            == jevents.format_event_summary(theirs))
    assert tevents.format_event_summary([]) == "faults: none"
    times = [0.01] * 8 + [0.5, 0.01, 0.011, 0.2, 0.01]
    ours, ref = StragglerMonitor(threshold=3.0), JaxMonitor(threshold=3.0)
    for i, t in enumerate(times):
        a, b = ours.record(i, t), ref.record(i, t)
        assert (a is None) == (b is None)
    assert [e.as_dict() for e in ours.events] == [e.as_dict()
                                                  for e in ref.events]
    assert [e.step for e in ours.events] == [8, 11]
    assert ours.ewma == pytest.approx(ref.ewma, rel=0, abs=0)


def test_stats_to_dict_is_json_ready(models, jax_runs):
    _, _, tm, tp = models[PHI3]
    fi = FaultInjector([parse_fault("nan@1.0")])
    s = ServeSession(tm, tp, kv_block_size=4, faults=fi)
    for i, p in enumerate(_prompts([5, 3])):
        s.submit(p, 4, request_id=f"r{i}")
    s.drain()
    d = s.stats.to_dict()
    json.dumps(d)
    for k in ("rejected", "timed_out", "cancelled", "failed", "shed",
              "poisoned_rows", "stragglers", "compile_retries", "events"):
        assert k in d
    assert [e["kind"] for e in d["events"]] == ["poison_row"]
    # the same keys as the JAX summary, but for its degrade ledger
    _, js, _, _ = jax_runs["nan_poison_row", PHI3]
    jkeys = set(js.stats.to_dict()) - {"fallbacks", "degraded",
                                        "degraded_buckets"}
    assert jkeys <= set(d)


def test_submit_validates_deadlines_and_cancel_of_unknown(models):
    _, _, tm, tp = models[PHI3]
    s = ServeSession(tm, tp, request_deadline_s=5.0)
    s.submit([1, 2, 3], 2, request_id="a")
    s.submit([1, 2, 3], 2, request_id="b", deadline_s=1.0)
    assert [r.deadline_s for r in s._queue] == [5.0, 1.0]
    assert not s.cancel("zzz") and s.cancel("a") and s.pending() == 1
    res = s.drain()
    assert [(r.request_id, r.state) for r in res] == [
        ("a", "CANCELLED"), ("b", "COMPLETED")]
    with pytest.raises(ValueError, match="compile_retries"):
        ServeSession(tm, tp, compile_retries=-1)
    # the port's default: a failed build raises at once
    s = ServeSession(tm, tp, faults=FaultInjector.from_strings(["compile@0"]))
    s.submit([1, 2, 3], 2)
    with pytest.raises(InjectedFault, match="attempt 0"):
        s.drain()
    assert s.compile_retries == 0 and s.stats.compile_retries == 0


def test_launch_serve_fault_flags(tmp_path, capsys):
    from repro_torch.launch import serve as serve_cli

    reqs = tmp_path / "requests.jsonl"
    reqs.write_text('{"prompt_len": 4, "new_tokens": 4}\n'
                    '{"prompt_len": 5, "new_tokens": 4}\n')
    serve_cli.main(["--arch", "phi3-mini-3.8b-smoke", "--device", "cpu",
                    "--session", "--requests-file", str(reqs),
                    "--batch-sizes", "1,2", "--request-deadline-s", "60",
                    "--max-queue-s", "60", "--cache-capacity", "8",
                    "--inject-fault", "nan@1.0"])
    out = capsys.readouterr().out
    assert "session: 2 requests" in out
    assert "FAILED" in out          # the poisoned request's terminal state
    assert "faults: poison_row=1" in out


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_a_session_is_freed_without_the_collector(models, arch):
    """No reference cycle holds a session, so its steps (on a card, its
    graphs) go when its last reference does: a cycle would leave them
    to the collector, which may free them in the middle of another
    step's capture and so invalidate it."""
    import gc
    import weakref
    _, _, tm, tp = models[arch]
    collecting = gc.isenabled()
    gc.disable()
    try:
        s = ServeSession(tm, tp, on_straggler=lambda ev: 2,
                         faults=FaultInjector.from_strings(["slow@1"]))
        s.submit(_prompts([5])[0], 4)
        s.drain()
        s.run_batch({"tokens": np.ones((1, 8), np.int32)}, max_new_tokens=3)
        ref = weakref.ref(s)
        step = weakref.ref(s.exec_cache.peek(s.exec_cache.compiled_log[0]))
        del s
        assert ref() is None and step() is None
    finally:
        if collecting:
            gc.enable()


# ----------------------------------------------- degrading a bucket (the
# tests/test_faults.py degradation scenarios on both packages).  The JAX
# session runs backend="pallas" with fallback_backend="reference", the
# port "cuda" with "eager" (a degraded bucket runs its cuda step
# uncaptured); on the CPU every step runs uncaptured and the cuda
# wrappers run their plain versions, so the build fault alone decides
# the path.

DEGRADE_COUNTERS = ("fallbacks", "degraded", "degraded_buckets",
                    "compile_retries", "requests", "steps", "failed",
                    "tokens_generated")
DEGRADES = {
    # test_persistent_compile_failure_degrades_pallas_bucket: every
    # attempt fails, so each bucket's uncaptured build fails too and the
    # same uncaptured step runs
    "persistent": (("compile@0x99",), dict(compile_retries=2)),
    # the card's [degrade] case: only the first build's first attempt
    # fails, so only that bucket degrades (its uncaptured build works)
    "first_bucket": (("compile@0x1",), dict(compile_retries=0)),
}


def _degrade_run(session):
    for i, p in enumerate(_prompts([5, 7, 3])):
        session.submit(p, [4, 6, 5][i], request_id=f"r{i}")
    return [(r.request_id, r.state, r.tokens.tolist(), r.reason)
            for r in session.drain()]


@pytest.fixture(scope="module")
def jax_degrades(models):
    jm, jp, _, _ = models[PHI3]
    out = {}
    for name, (faults, kw) in DEGRADES.items():
        fi = jfaults.FaultInjector.from_strings(faults)
        s = JaxSession(jm, jp, backend="pallas", kv_block_size=4,
                       faults=fi, fallback_backend="reference",
                       compile_backoff_s=0.0,
                       straggler_threshold=THRESHOLD, **kw)
        out[name] = (_degrade_run(s), s, fi)
    clean = JaxSession(jm, jp, backend="pallas", kv_block_size=4)
    out["clean"] = _degrade_run(clean)
    return out


@pytest.mark.parametrize("name", sorted(DEGRADES))
def test_degraded_bucket_matches_the_jax_session(models, jax_degrades,
                                                 name):
    _, _, tm, tp = models[PHI3]
    faults, kw = DEGRADES[name]
    fi = FaultInjector.from_strings(faults)
    s = ServeSession(tm, tp, kv_block_size=4, faults=fi,
                     fallback_backend="eager", compile_backoff_s=0.0,
                     straggler_threshold=THRESHOLD, **kw)
    built, build = [], s._build

    def spy(key, make):
        def noted(backend, capture):
            built.append((key.role, backend, capture))
            return make(backend, capture)
        return build(key, noted)
    s._build = spy
    run = _degrade_run(s)
    j_run, js, j_fi = jax_degrades[name]
    assert run == j_run
    # tokens survive the degradation (reference == pallas)
    assert run == jax_degrades["clean"]
    # every step is built on the session's backend: a degraded bucket
    # runs the port's kernels uncaptured, never the plain backend
    assert {be for _, be, _ in built} == {"cuda"}
    for k in DEGRADE_COUNTERS:
        assert getattr(s.stats, k) == getattr(js.stats, k), k
    assert _events(s.stats.events) == _events(js.stats.events)
    assert _events(fi.fired) == _events(j_fi.fired)
    assert s.stats.degraded and s.stats.to_dict()["degraded"] is True
    kinds = [e.kind for e in s.stats.events]
    if name == "persistent":
        # two buckets, each: failure, degraded, its eager build's failure
        assert kinds == ["compile_failure", "degraded",
                         "compile_failure"] * 2
        assert s.stats.degraded_buckets == 2 and s.stats.fallbacks == 4
        assert [e.what for e in s.stats.events][:3] == [
            "prefill[b1,p8]", "prefill[b1,p8]",
            "prefill[b1,p8] [degraded]"]
        # the attempts fail before building: only the last resorts build
        assert built == [("prefill", "cuda", False),
                         ("decode", "cuda", False)]
    else:
        assert kinds == ["compile_failure", "degraded"]
        assert s.stats.degraded_buckets == 1 == s.stats.fallbacks
        # the first bucket's uncaptured build, then the others' captures
        assert built[0] == ("prefill", "cuda", False)
        assert all(cap for _, _, cap in built[1:]) and len(built) > 1


def test_fallback_none_raises_where_jax_keeps_the_jit_step(models,
                                                           jax_degrades):
    """The recorded difference: with ``"none"`` (the port's default) a
    bucket that fails every attempt raises out of ``drain`` after its
    fallback is counted; the JAX session serves it with the un-lowered
    jit step.  Up to the raise both count the same."""
    jm, jp, tm, tp = models[PHI3]
    js = JaxSession(jm, jp, backend="pallas", kv_block_size=4,
                    compile_backoff_s=0.0, fallback_backend="none",
                    straggler_threshold=THRESHOLD,
                    faults=jfaults.FaultInjector.from_strings(
                        ["compile@0x99"]))
    j_run = _degrade_run(js)
    assert j_run == jax_degrades["clean"]
    assert js.stats.fallbacks >= 1 and not js.stats.degraded
    s = ServeSession(tm, tp, kv_block_size=4, compile_retries=2,
                     compile_backoff_s=0.0, straggler_threshold=THRESHOLD,
                     faults=FaultInjector.from_strings(["compile@0x99"]))
    assert s.fallback_backend == "none"
    with pytest.raises(InjectedFault, match="attempt 2"):
        _degrade_run(s)
    assert s.stats.fallbacks == 1 and s.stats.compile_retries == 2
    assert not s.stats.degraded and s.stats.degraded_buckets == 0
    assert _events(s.stats.events) == _events(js.stats.events)[:1]


def test_fallback_backend_validated(models):
    jm, jp, tm, tp = models[PHI3]
    for make, good in ((ServeSession, ("eager", "none")),
                       (JaxSession, ("reference", "none"))):
        m, p = (tm, tp) if make is ServeSession else (jm, jp)
        with pytest.raises(ValueError, match="fallback_backend"):
            make(m, p, fallback_backend="tpu")
        for name in good:
            assert make(m, p, fallback_backend=name).fallback_backend == name
    for name in ("reference", "plain"):
        with pytest.raises(ValueError, match="fallback_backend"):
            ServeSession(tm, tp, fallback_backend=name)


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_plain_session_falls_back_uncaptured_like_a_jax_reference_bucket(
        models, arch):
    """A plain session does not degrade: a build that fails every
    attempt runs the plain step uncaptured (a fallback, no
    degradation), as a JAX ``"reference"`` bucket runs its jit step."""
    jm, jp, tm, tp = models[arch]
    js = JaxSession(jm, jp, backend="reference", kv_block_size=4,
                    compile_retries=1, compile_backoff_s=0.0,
                    straggler_threshold=THRESHOLD,
                    faults=jfaults.FaultInjector.from_strings(
                        ["compile@0x99"]))
    s = ServeSession(tm, tp, backend="plain", kv_block_size=4,
                     compile_retries=1, compile_backoff_s=0.0,
                     fallback_backend="eager", straggler_threshold=THRESHOLD,
                     faults=FaultInjector.from_strings(["compile@0x99"]))
    assert _degrade_run(s) == _degrade_run(js)
    for k in DEGRADE_COUNTERS:
        assert getattr(s.stats, k) == getattr(js.stats, k), k
    assert s.stats.fallbacks == 2 and not s.stats.degraded
    assert _events(s.stats.events) == _events(js.stats.events)


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_degraded_run_batch_and_its_telemetry(models, arch, tmp_path):
    """``generate(session=)`` on a session whose every build fails
    serves the clean tokens through uncaptured steps; the degraded decode
    step holds the geometry's one state; ``serve.aot_fallbacks_total``
    counts the fallbacks and a recorder dumps the postmortems."""
    from repro_torch.obs import FlightRecorder, MetricsRegistry, Telemetry
    _, _, tm, tp = models[arch]
    batch = {"tokens": np.asarray(_prompts([8, 8]))}
    want, _ = generate(tm, tp, batch, max_new_tokens=4)
    tel = Telemetry(metrics=MetricsRegistry(),
                    recorder=FlightRecorder(out_dir=str(tmp_path)))
    s = ServeSession(tm, tp, fallback_backend="eager", telemetry=tel,
                     straggler_threshold=THRESHOLD,
                     faults=FaultInjector.from_strings(["compile@0x99"]))
    got, _ = generate(tm, tp, batch, max_new_tokens=4, session=s)
    assert np.array_equal(got, want)
    assert s.stats.fallbacks == 4 and s.stats.degraded_buckets == 2
    assert tel.metrics.counter("serve.aot_fallbacks_total").value == 4
    assert set(tel.recorder.dumps) == {"compile_failure", "degraded"}
    assert (tmp_path / "postmortem-degraded.json").exists()
    dec = [s.exec_cache.peek(k) for k in s.exec_cache.compiled_log
           if k.role == "decode"]
    assert len(dec) == 1 and dec[0].graph is None
    # a second call hits the degraded steps: nothing more is built
    got2, _ = generate(tm, tp, batch, max_new_tokens=4, session=s)
    assert np.array_equal(got2, want) and s.stats.fallbacks == 4


# ------------------------------------------------ containing a raise: the
# step callable raises once (after it ran, so a port step has written its
# state), wrapped in the test, on both packages


class _RaiseOnce:
    """Wraps what a session's executable cache returns for ``role`` so
    that its ``n``-th call (over all such steps) raises after running."""

    def __init__(self, role, n):
        self.role, self.n, self.calls = role, n, 0

    def hit(self):
        self.calls += 1
        if self.calls == self.n:
            raise RuntimeError(f"injected {self.role} failure")

    def install(self, session, port):
        cache = session.exec_cache
        get = cache.get

        def wrapped_get(key, builder):
            value, hit = get(key, builder)
            if key.role != self.role:
                return value, hit
            if port:
                if not getattr(value, "_wrapped", False):
                    replay = value.replay

                    def raising_replay():
                        out = replay()
                        self.hit()
                        return out
                    value.replay = raising_replay
                    value._wrapped = True
                return value, hit

            def raising_fn(*a, **kw):
                out = value(*a, **kw)
                self.hit()
                return out
            return raising_fn, hit

        cache.get = wrapped_get


CONTAIN = [(arch, role) for arch in (PHI3, MAMBA)
           for role in ("prefill", "decode")]
CONTAIN_LENS, CONTAIN_BUDGETS = [5, 7, 3, 6, 4], [6, 5, 6, 4, 6]


def _contain_run(session):
    for i, p in enumerate(_prompts(CONTAIN_LENS)):
        session.submit(p, CONTAIN_BUDGETS[i], request_id=f"r{i}")
    return [(r.request_id, r.state, r.tokens.tolist(), r.reason)
            for r in session.drain()]


@pytest.fixture(scope="module")
def jax_contained(models):
    out = {}
    for arch in (PHI3, MAMBA):
        jm, jp, _, _ = models[arch]
        kw = dict(batch_sizes=(2,), kv_block_size=4,
                  straggler_threshold=THRESHOLD)
        out[arch, None] = _contain_run(JaxSession(jm, jp, **kw))
        for role in ("prefill", "decode"):
            s = JaxSession(jm, jp, **kw)
            _RaiseOnce(role, 3 if role == "decode" else 2).install(s, False)
            out[arch, role] = (_contain_run(s), s)
    return out


@pytest.mark.parametrize("arch,role", CONTAIN,
                         ids=[f"{a.split('-')[0]}-{r}" for a, r in CONTAIN])
def test_contained_raise_matches_the_jax_session(models, jax_contained,
                                                 arch, role, tmp_path):
    """A prefill that raises fails its admission only; a decode step
    that raises fails the rows in flight (partial tokens), keeps the
    queue, and every request admitted later gets the clean run's
    tokens, though the port's step had already written its state."""
    from repro_torch.obs import FlightRecorder, MetricsRegistry, Telemetry
    _, _, tm, tp = models[arch]
    tel = Telemetry(metrics=MetricsRegistry(),
                    recorder=FlightRecorder(out_dir=str(tmp_path)))
    s = ServeSession(tm, tp, batch_sizes=(2,), kv_block_size=4,
                     straggler_threshold=THRESHOLD, telemetry=tel)
    _RaiseOnce(role, 3 if role == "decode" else 2).install(s, True)
    run = _contain_run(s)
    j_run, js = jax_contained[arch, role]
    assert run == j_run
    for k in COUNTERS:
        assert getattr(s.stats, k) == getattr(js.stats, k), k
    assert _events(s.stats.events) == _events(js.stats.events)
    clean = {rid: toks for rid, _, toks, _ in jax_contained[arch, None]}
    failed = [(rid, toks, why) for rid, st, toks, why in run
              if st == RequestState.FAILED]
    if role == "prefill":
        assert [(rid, why) for rid, _, why in failed] == [
            ("r1", "prefill raised: injected prefill failure")]
        assert [e.kind for e in s.stats.events] == ["admission_failure"]
        assert tel.recorder.dumps == {"admission_failure": 2}
    else:
        assert len(failed) == 2 and s.stats.failed == 2
        for rid, toks, why in failed:
            assert why == "decode step raised: injected decode failure"
            assert toks == clean[rid][:len(toks)] and len(toks) == 3
        ev, = s.stats.events
        assert ev.kind == "step_exception" and ev.step == 2
        assert ev.error == "injected decode failure"
        # dumped at the event and again at the activation's end
        assert tel.recorder.dumps == {"step_exception": 2}
    for rid, st, toks, _ in run:
        if st != RequestState.FAILED:
            assert st == RequestState.COMPLETED and toks == clean[rid]
    assert not s._running and s.pending() == 0


def test_run_batch_propagates_a_raise(models):
    """``run_batch`` catches nothing, as in the JAX package."""
    _, _, tm, tp = models[PHI3]
    s = ServeSession(tm, tp)
    _RaiseOnce("decode", 1).install(s, True)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        generate(tm, tp, {"tokens": np.ones((2, 8), np.int32)},
                 max_new_tokens=3, session=s)


def test_launch_serve_fallback_backend_and_moe(capsys):
    """``--fallback-backend eager`` reaches the session (every bucket
    degrades under ``compile@0x99`` and the summary names them), the
    default ``none`` raises, and a moe architecture serves."""
    from repro_torch.launch import serve as serve_cli

    base = ["--arch", "phi3-mini-3.8b-smoke", "--device", "cpu",
            "--session", "--num-requests", "2", "--batch-sizes", "1,2",
            "--inject-fault", "compile@0x99"]
    serve_cli.main(base + ["--fallback-backend", "eager"])
    out = capsys.readouterr().out
    assert "session: 2 requests" in out
    line = next(x for x in out.splitlines() if x.startswith("faults:"))
    counts, buckets = line.split(" | ")
    # the CLI has no straggler threshold: host jitter on the CPU may add
    # a straggler event beside the build faults asserted here
    assert (re.sub(r" straggler=\d+", "", counts)
            == "faults: compile_failure=6 degraded=3")
    assert buckets == ("degraded buckets: prefill[b1,p8], decode[b1,t48], "
                       "prefill[b1,p16]")
    with pytest.raises(InjectedFault):
        serve_cli.main(base)
    serve_cli.main(["--arch", "qwen2-moe-a2.7b-smoke", "--device", "cpu",
                    "--session", "--num-requests", "4",
                    "--batch-sizes", "1,2"])
    out = capsys.readouterr().out
    assert "arch qwen2-moe-a2.7b-smoke" in out
    assert "session: 4 requests" in out and "FAILED" not in out
