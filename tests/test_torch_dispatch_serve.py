"""The attention and scan dispatch families on the serving path, against
the JAX package, on the CPU.

The port registers the reference's six kernel families, keys its serving
steps by a :class:`ScheduleBundle` and rebuilds the decode step once when
the dispatch service commits another winner, as the JAX package's
``backend="pallas"`` path does.  On the CPU every kernel wrapper runs its
plain version (the launch parameters change nothing there), so these
tests hold the control flow: problems, keys, bundles, rebuilds and
switches, warm registries, and tokens equal to the JAX package's
``generate(..., dispatch=, backend="pallas")`` and its engine.  A
scripted service (the reference's ``_ScriptedService``) makes the commit
land on a chosen candidate.  Both packages get the same weights (the JAX
init, bridged); the smoke configs run in float32, so tokens must be
identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import schedule as jsch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime import dispatch as jdispatch  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro.serving import bucketing as jbucketing  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import schedule as sch  # noqa: E402
from repro_torch.core import tuner  # noqa: E402
from repro_torch.kernels import _geometry as geo  # noqa: E402
from repro_torch.kernels import _launches  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_dispatched, decode_attention_ref)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    paged_split_keys)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_dispatched, flash_attention_ref)
from repro_torch.kernels.ssm_scan import (ssm_scan_dispatched,  # noqa: E402
                                          ssm_scan_ref)
from repro_torch.models import (build_model, left_pad_prompts,  # noqa: E402
                                prompt_starts)
from repro_torch.runtime import dispatch as tdispatch  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime.dispatch import DispatchService  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402
from repro_torch.serving import bucketing as tbucketing  # noqa: E402
from repro_torch.serving.cache import ExecKey, ExecutableCache  # noqa: E402
from repro_torch.serving.captured import CapturedStep  # noqa: E402

PHI3, MAMBA = "phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke"
ARCHS = (PHI3, MAMBA)
DECODE_KIND = {PHI3: "decode_attention", MAMBA: "ssm_scan"}
# generate: 2 rows of 112 tokens + 16 new ones (a cache of 128 keys gives
# the decode tuner three splits to rank, as the reference's test has)
GEN_PROMPT, GEN_NEW = 112, 16
# the engine: six requests of one prompt bucket (64) at batch 2 and 16
# new tokens each, so the decode key's cache holds 80 keys
ENGINE_LENS = [40, 37, 51, 44, 33, 60]
ENGINE_NEW = 16


class _ScriptedService(DispatchService):
    """The reference's scripted service, on the CPU: until a slot
    commits, the target candidate's calls take 1e-4 s and every other's
    5e-4 s, so the commit lands on the target deterministically."""

    def __init__(self, registry, target_index=1, **kw):
        super().__init__(registry, device="cpu", **kw)
        self.target_index = target_index

    def observe(self, kind, problem, dt, elem_bytes=2):
        skey = self.resolve(kind, problem, elem_bytes)
        slot = self.selector._slots[skey]
        if slot.committed is None:
            fast = slot.next_candidate == self.target_index
            dt = 1e-4 if fast else 5e-4
        super().observe(kind, problem, dt, elem_bytes)


class _JaxScripted(jdispatch.DispatchService):
    """The same script over the JAX package's service."""

    def __init__(self, registry, target_index=1, **kw):
        super().__init__(registry, **kw)
        self.target_index = target_index

    def observe(self, kind, problem, dt, elem_bytes=2):
        skey = self.resolve(kind, problem, elem_bytes)
        slot = self.selector._slots[skey]
        if slot.committed is None:
            fast = slot.next_candidate == self.target_index
            dt = 1e-4 if fast else 5e-4
        super().observe(kind, problem, dt, elem_bytes)


def _models(arch):
    jm = jax_build_model(jax_get_config(arch))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(arch)), tp


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in ARCHS}


def _gen_batch(cfg):
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, (2, GEN_PROMPT)).astype(np.int32)


def _engine_prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(1, 256, size=n).astype(np.int32)
            for n in ENGINE_LENS]


def _drain(session):
    for i, p in enumerate(_engine_prompts()):
        session.submit(p, ENGINE_NEW, request_id=f"r{i}")
    res = session.drain()
    return {r.request_id: r.tokens.tolist() for r in res}, res


def _session(tm, tp, svc, **kw):
    return ServeSession(tm, tp, dispatch=svc, batch_sizes=(2,), **kw)


# --------------------------------------------------------- the families


def test_families_hold_the_reference_six():
    assert set(tdispatch.FAMILIES) == set(jdispatch.FAMILIES) == {
        "conv2d", "matmul", "flash_attention", "decode_attention",
        "ssm_scan", "sparse_conv"}
    for kind, fam in jdispatch.FAMILIES.items():
        assert tdispatch.FAMILIES[kind].dims == fam.dims, kind


SHAPES = [(1, 8, 16), (2, 32, 48), (4, 200, 232), (8, 512, 544)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}-p{}-t{}".format(
    *s))
@pytest.mark.parametrize("arch", sorted(REGISTRY) + [a + "-smoke"
                                                     for a in sorted(REGISTRY)])
def test_serve_dispatch_problems_equal_the_reference(arch, shape):
    assert (tserve.serve_dispatch_problems(get_config(arch), *shape)
            == jserve.serve_dispatch_problems(jax_get_config(arch), *shape))


SCHEDULES = {
    "flash_attention": (sch.FlashAttentionSchedule(128, 64),
                        jsch.FlashAttentionSchedule(128, 64)),
    "decode_attention": (sch.DecodeAttentionSchedule(96),
                         jsch.DecodeAttentionSchedule(96)),
    "ssm_scan": (sch.SSMScanSchedule(64), jsch.SSMScanSchedule(64)),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedules_round_trip_as_the_reference_serialises_them(kind):
    mine, theirs = SCHEDULES[kind]
    d = reg.schedule_to_dict(mine)
    assert d == jreg.schedule_to_dict(theirs) == mine.to_dict()
    assert reg.schedule_from_dict(d) == mine
    assert hash(reg.schedule_from_dict(d)) == hash(mine)


def test_bundle_round_trips_and_reports_as_the_reference():
    mine = sch.ScheduleBundle(**{k: v[0] for k, v in SCHEDULES.items()})
    theirs = jsch.ScheduleBundle(**{k: v[1] for k, v in SCHEDULES.items()})
    assert mine.to_dict() == theirs.to_dict()
    assert mine == sch.ScheduleBundle(**{
        k: reg.schedule_from_dict(v) for k, v in mine.to_dict().items()
        if v is not None})
    assert mine.get("ssm_scan") == sch.SSMScanSchedule(64)
    assert mine.get("matmul") is None
    other = mine.replace(ssm_scan=sch.SSMScanSchedule(32))
    assert other != mine and hash(other) != hash(mine)
    pf = sch.ScheduleBundle(ssm_scan=sch.SSMScanSchedule(32))
    dec = sch.ScheduleBundle(ssm_scan=sch.SSMScanSchedule(64))
    rep = tserve.resolve_bundle_report(pf, dec)
    jrep = jserve.resolve_bundle_report(
        jsch.ScheduleBundle(ssm_scan=jsch.SSMScanSchedule(32)),
        jsch.ScheduleBundle(ssm_scan=jsch.SSMScanSchedule(64)))
    assert rep == jrep and set(rep) == set(jrep)
    assert rep["ssm_scan"] == {"type": "ssm_scan", "block_d": 64}


# ------------------------------------------------------- the candidates


def _offered(arch, eb):
    """(kind, problem, schedules offered) at the arch's prefill and
    decode shapes: the engine's batch-1 prompt buckets and
    ``generate``'s batches."""
    cfg = get_config(arch)
    out = []
    for bsz, p_len, total in [(1, 32, 64), (1, 512, 544), (4, 512, 544),
                              (2, 16, 4096), (8, 64, 96)]:
        for kind, prob in tserve.serve_dispatch_problems(
                cfg, bsz, p_len, total).values():
            fam = tdispatch.FAMILIES[kind]
            ranked = fam.tune(prob, cm.H100Spec(), "m", eb, 99,
                              reg.TuningRegistry(None))
            out.append((kind, prob, [s for s, _ in ranked]))
    return out


@pytest.mark.parametrize("eb", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "falcon-mamba-7b", PHI3,
                                  MAMBA])
def test_every_offered_candidate_fits_its_body(arch, eb):
    """What the tuner offers at these shapes, the kernel takes
    (``_geometry``'s error is None), in the body the rule runs (flash's
    wgmma body in bf16 at the full configs' head dims); the paged
    decode's rounding to its pool block fits too."""
    for kind, p, offered in _offered(arch, eb):
        assert offered, (kind, p)
        for s in offered:
            if kind == "flash_attention":
                assert geo.flash_tile_error(p["d"], eb, s.block_q,
                                            s.block_kv) is None
                body = geo.flash_body(p["d"], eb)
                assert body == ("float32" if eb == 4 else "wgmma"
                                if p["d"] in geo.FLASH_WGMMA_D else "mma")
                if body == "wgmma":
                    assert geo.flash_wgmma_tile(p["d"],
                                                s.block_q).error is None
                want = ({(64, 64), (128, 64)} if eb == 2 else {(64, 32)})
                assert {(x.block_q, x.block_kv) for x in offered} == want
            elif kind == "decode_attention":
                plan = geo.decode_plan(p["b"], p["hq"], p["hkv"], p["d"],
                                       p["s"], 0, eb, s.block_kv)
                assert plan.error is None, (p, s, plan.error)
                for bs in (4, 16):
                    mb = -(-p["s"] // bs)
                    paged = geo.decode_plan(
                        p["b"], p["hq"], p["hkv"], p["d"], mb * bs, bs, eb,
                        paged_split_keys(s.block_kv, bs))
                    assert paged.error is None, (p, s, bs, paged.error)
            else:
                assert geo.scan_layout(s.block_d, p["n"], eb).error is None


# phi3-mini's prefill buckets and decode caches: flash [1, 32, S, 96] at
# every engine bucket and generate's [4, 32, 512, 96]; the decodes at the
# engine's rows over its pool and generate's [4, 32, 544, 96]
PHI3_FLASH = [(1, s) for s in (8, 16, 32, 64, 128, 256, 512)] + [(4, 512)]
PHI3_DECODE = [(1, 544, 16), (2, 544, 16), (4, 544, 16), (4, 544, 0)]


@pytest.mark.parametrize("b,s", PHI3_FLASH,
                         ids=[f"b{b}-s{s}" for b, s in PHI3_FLASH])
def test_every_offered_phi3_flash_schedule_fits_the_body_that_runs_it(b, s):
    """Each tile the tuner offers for phi3's prefills is one the wgmma
    body (the body that runs them) takes, and the model ranks both."""
    ranked = tuner.tune_flash_attention(b, 32, 32, s, 96, elem_bytes=2)
    assert {(x.block_q, x.block_kv) for x, _ in ranked} == {(64, 64),
                                                            (128, 64)}
    assert geo.flash_body(96, 2) == "wgmma"
    for x, cost in ranked:
        t = geo.flash_wgmma_tile(96, x.block_q)
        assert t.error is None and t.smem <= geo.SMEM_BYTES
        assert x.block_kv == geo.FLASH_KEYS and cost.time_s < 1.0


@pytest.mark.parametrize("b,s,bs", PHI3_DECODE,
                         ids=[f"b{c[0]}-{'paged' if c[2] else 'contig'}"
                              for c in PHI3_DECODE])
def test_every_offered_phi3_decode_schedule_fits_the_body_that_runs_it(b, s,
                                                                       bs):
    """Each split the tuner offers for phi3's decodes is one the chunked
    body (the rule's at MHA) takes, over the pool rounded to its block."""
    offered = [x.block_kv for x, _ in tuner.tune_decode_attention(
        b, 32, 32, s, 96, elem_bytes=2, top_k=99)]
    assert offered
    for k in offered:
        split = paged_split_keys(k, bs) if bs else k
        plan = geo.decode_plan(b, 32, 32, 96, s, bs, 2, split)
        assert plan.error is None, (k, plan.error)
        assert plan.body == geo.decode_body(32, 32, 96, 2) == "chunked"


def test_the_decode_candidates_hold_the_plan_s_own_split():
    own = geo.decode_plan(4, 32, 32, 96, 544, 0, 2).split_keys
    assert tuner.decode_splits(4, 32, 32, 544, 96, 2) == [own, 32, 128, 256,
                                                          512]
    assert tuner.decode_splits(2, 4, 2, 24, 16, 4) == [32]


def test_scan_cold_rank0_at_batch1_prefill_is_32_or_64():
    """Measured on the card (PERF.md row 4): at [1, 512, 8192] 32 and 64
    run within 3% of each other, 128 and 256 leave SMs idle."""
    ranked = tuner.tune_ssm_scan(1, 512, 8192, 16, elem_bytes=2)
    assert ranked[0][0].block_d in (32, 64)
    times = {s.block_d: c.time_s for s, c in ranked}
    assert times[128] > times[64] and times[256] > times[128]


@pytest.mark.parametrize("case", ["split16", "pool_block", "splits", "smem"])
def test_decode_plan_refuses_a_split_the_kernel_cannot_run(case):
    if case == "split16":
        err = geo.decode_plan(2, 4, 2, 16, 128, 0, 4, 40).error
        assert "multiple of 16 keys" in err
    elif case == "pool_block":
        err = geo.decode_plan(2, 4, 2, 16, 128, 32, 4, 48).error
        assert "pool block" in err
        assert paged_split_keys(48, 32) == 64
        assert geo.decode_plan(2, 4, 2, 16, 128, 32, 4, 64).error is None
    elif case == "splits":
        err = geo.decode_plan(1, 4, 4, 16, 16 * 300, 0, 2, 16).error
        assert f"> {geo.DEC_MAX_SPLITS}" in err
    else:
        err = geo.decode_plan(1, 4, 4, 16, 1 << 20, 1, 2, 1 << 16).error
        assert "shared memory" in err


def test_decode_plan_with_a_split_keeps_the_chunk_and_tile():
    base = geo.decode_plan(4, 32, 8, 128, 544, 0, 2)
    for k in (32, 64, 256):
        p = geo.decode_plan(4, 32, 8, 128, 544, 0, 2, k)
        assert (p.head_chunk, p.chunks, p.tile_keys) == (
            base.head_chunk, base.chunks, base.tile_keys)
        assert p.split_keys == k and p.splits == -(-544 // k)
    # a group of 4 in bf16 runs the packed body, whose layout holds the
    # split's table entries as the chunked body's does
    paged = geo.decode_plan(4, 32, 8, 128, 544, 16, 2, 64)
    assert paged.body == "packed"
    assert paged.smem == geo.dec_packed_smem(128, paged.tile_keys,
                                             paged.m_tiles, 64 // 16, 1)
    # and float32 the chunked body, whose layout holds them too
    paged = geo.decode_plan(4, 32, 8, 128, 544, 16, 4, 64)
    assert paged.body == "chunked"
    assert paged.smem == geo.dec_smem(128, 4, paged.tile_keys,
                                      paged.head_chunk, 64 // 16)


@pytest.mark.parametrize("d", [16, 96, 256])
def test_flash_layout_at_128_rows(d):
    t = geo.flash_mma_tile(d, 128)
    assert t.error is None and t.threads == 256
    assert t.smem == (128 + 4 * 64) * (t.dp + 8) * 2 <= geo.SMEM_BYTES
    assert "block_q" in geo.flash_mma_tile(d, 96).error
    assert geo.flash_tile_error(d, 2, 128, 64) is None
    assert "key tile" in geo.flash_tile_error(d, 2, 128, 32)
    assert "float32" in geo.flash_tile_error(d, 4, 128, 64)
    assert geo.flash_tile_error(d, 4, 64, 32) is None


# ------------------------------------------------------------ wrappers


def test_dispatched_wrappers_run_the_plain_versions_and_commit():
    """On the CPU the ``*_dispatched`` entries equal the plain versions
    whatever they propose, and their slots commit."""
    rng = np.random.default_rng(0)

    def rn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    svc = DispatchService(reg.TuningRegistry(None), device="cpu")
    q, k, v = rn(1, 4, 70, 16), rn(1, 2, 70, 16), rn(1, 2, 70, 16)
    dq, dk, dv = rn(2, 4, 1, 16), rn(2, 2, 96, 16), rn(2, 2, 96, 16)
    x, dt = rn(1, 12, 64), rn(1, 12, 64).abs()
    b, c, a, dd = rn(1, 12, 8), rn(1, 12, 8), -rn(64, 8).abs(), rn(64)
    for _ in range(20):
        assert torch.equal(flash_attention_dispatched(q, k, v, service=svc),
                           flash_attention_ref(q, k, v))
        assert torch.equal(
            decode_attention_dispatched(dq, dk, dv, 80, service=svc),
            decode_attention_ref(dq, dk, dv, 80))
        y, h = ssm_scan_dispatched(x, dt, b, c, a, dd, service=svc)
        ry, rh = ssm_scan_ref(x, dt, b, c, a, dd)
        assert torch.equal(y, ry) and torch.equal(h, rh)
    kinds = {e["kind"]: e["committed"] for e in svc.report().values()}
    assert set(kinds) == {"flash_attention", "decode_attention", "ssm_scan"}
    assert all(c is not None for c in kinds.values())


def test_launch_notes_are_kept_only_inside_a_recording():
    _launches.note("ssm_scan", block_d=32)          # outside: dropped
    with _launches.recording() as log:
        _launches.note("ssm_scan", block_d=32)
        _launches.note("ssm_scan", block_d=32)
        _launches.note("decode_attention", block_kv=None, split_keys=64,
                       splits=9)
    assert log == [{"kind": "ssm_scan", "block_d": 32},
                   {"kind": "decode_attention", "block_kv": None,
                    "split_keys": 64, "splits": 9}]
    step = CapturedStep(lambda: torch.zeros(1), torch.device("cpu"))
    assert step.launch_params == []                 # no capture here


def test_peek_geometry_ignores_the_bundle_and_hand_over_copies():
    cache = ExecutableCache()
    b0 = sch.ScheduleBundle(ssm_scan=sch.SSMScanSchedule(32))
    k0 = ExecKey("a", "decode", 2, 16, b0, "cuda")
    cache.get(k0, lambda: "step0")
    k1 = dataclasses.replace(k0, schedules=b0.replace(
        ssm_scan=sch.SSMScanSchedule(64)))
    before = cache.stats()
    assert cache.peek_geometry(k1) == "step0" and cache.peek(k1) is None
    assert cache.peek_geometry(dataclasses.replace(k0, batch=4)) is None
    assert cache.stats() == before
    shared = torch.arange(4.0)
    old = CapturedStep(lambda: None, torch.device("cpu"),
                       inputs={"tokens": torch.tensor([5, 6])},
                       state={"s": shared})
    same = CapturedStep(lambda: None, torch.device("cpu"),
                        inputs={"tokens": torch.zeros(2, dtype=torch.int64)},
                        state={"s": shared})
    other = CapturedStep(lambda: None, torch.device("cpu"),
                         inputs={"tokens": torch.zeros(2, dtype=torch.int64)},
                         state={"s": torch.zeros(4)})
    for new in (same, other):
        tserve.hand_over(old, new)
        assert new.inputs["tokens"].tolist() == [5, 6]
        assert new.state["s"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert same.state["s"] is shared and other.state["s"] is not shared


# ------------------------------------------------------------ bucketing


STEP_TIMES = {
    "none": lambda b: None,
    "flat": lambda b: 1e-3,
    "linear": lambda b: 1e-3 * b.batch,
    "sublinear": lambda b: 1e-3 * (1 + 0.2 * b.batch),
    "partial": lambda b: 1e-3 if b.batch == 2 else None,
    "zero": lambda b: 0.0,
}


@pytest.mark.parametrize("n_pending", [1, 3, 6, 9])
@pytest.mark.parametrize("timing", sorted(STEP_TIMES))
def test_pick_bucket_with_a_step_time_matches_the_reference(timing,
                                                            n_pending):
    budgets = [4 + 3 * i for i in range(n_pending)]
    step_time = STEP_TIMES[timing]
    mine = tbucketing.pick_bucket(
        tbucketing.candidate_buckets(budgets, 16, (1, 2, 4, 8)), step_time)
    theirs = jbucketing.pick_bucket(
        jbucketing.candidate_buckets(budgets, 16, (1, 2, 4, 8)),
        lambda b: step_time(tbucketing.Bucket(b.batch, b.prompt_len,
                                              b.total_len)))
    assert (mine[0].batch, mine[0].prompt_len, mine[0].total_len,
            mine[1]) == (theirs[0].batch, theirs[0].prompt_len,
                         theirs[0].total_len, theirs[1])


# ------------------------------------------------ generate and the engine


def _generate(tm, tp, svc=None, **kw):
    toks = _gen_batch(tm.cfg)
    return tserve.generate(tm, tp, {"tokens": toks},
                           max_new_tokens=GEN_NEW, dispatch=svc, **kw)


def _decode_problem(cfg, runner):
    if runner == "generate":
        return tserve.serve_dispatch_problems(
            cfg, 2, GEN_PROMPT, GEN_PROMPT + GEN_NEW)["decode"]
    cap = 80                        # prompt bucket 64 + new-token bucket 16
    return tserve.serve_dispatch_problems(cfg, 2, 64, cap)["decode"]


def _run(runner, tm, tp, svc, **kw):
    """(tokens, recompiles, final decode schedules, session or None)."""
    if runner == "generate":
        out, stats = _generate(tm, tp, svc, **kw)
        return out, stats.recompiles, stats.schedules, None
    s = _session(tm, tp, svc, **kw)
    tokens, res = _drain(s)
    return tokens, s.stats.recompiles, res[-1].stats.schedules, s


@pytest.mark.parametrize("runner", ["generate", "engine"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_commit_rebuilds_the_decode_step_exactly_once(models, arch,
                                                        runner):
    _, _, tm, tp = models[arch]
    kind, prob = _decode_problem(tm.cfg, runner)
    eb = tp["embed"].element_size()
    svc = _ScriptedService(reg.TuningRegistry(None), target_index=1)
    cands = svc.candidates(kind, prob, eb)
    assert len(cands) >= 2, "a rebuild needs two candidates"
    ref, _, _, _ = _run(runner, tm, tp, None)
    out, recompiles, scheds, s = _run(runner, tm, tp, svc)
    assert svc.committed(kind, prob, eb) == cands[1]
    assert recompiles == 1
    assert scheds[kind] == reg.schedule_to_dict(cands[1])
    assert np.array_equal(np.asarray(out), np.asarray(ref)) if \
        runner == "generate" else out == ref
    if s is not None:
        # the recapture was built over the live pool: the geometry's two
        # entries hold the same tensors
        decs = [s.exec_cache.peek(k) for k in s.exec_cache.compiled_log
                if k.role == "decode"]
        assert len(decs) == 2 and s.stats.commits_seen == 1
        assert all(decs[0].state[n] is decs[1].state[n]
                   for n in decs[0].state)
        bundles = [k.schedules.get(kind) for k in s.exec_cache.compiled_log
                   if k.role == "decode"]
        assert bundles == [cands[0], cands[1]]


@pytest.mark.parametrize("runner", ["generate", "engine"])
@pytest.mark.parametrize("arch", ARCHS)
def test_max_recompiles_zero_pins_the_step_to_rank0(models, arch, runner):
    _, _, tm, tp = models[arch]
    kind, prob = _decode_problem(tm.cfg, runner)
    eb = tp["embed"].element_size()
    svc = _ScriptedService(reg.TuningRegistry(None), target_index=1)
    cands = svc.candidates(kind, prob, eb)
    _, recompiles, scheds, s = _run(runner, tm, tp, svc, max_recompiles=0)
    assert svc.committed(kind, prob, eb) == cands[1]
    assert recompiles == 0
    assert scheds[kind] == reg.schedule_to_dict(cands[0])
    if s is not None:
        assert s.stats.commits_seen == 1 and s.stats.free_switches == 0
        assert s.exec_cache.compiled_roles()["decode"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_a_switch_to_a_cached_step_is_free(models, arch):
    """A second service that commits the same winner over a session
    whose cache already holds that bundle's step switches to it with no
    rebuild."""
    _, _, tm, tp = models[arch]
    first = _ScriptedService(reg.TuningRegistry(None), target_index=1)
    s = ServeSession(tm, tp, dispatch=first)
    toks = _gen_batch(tm.cfg)
    out1, st1 = tserve.generate(tm, tp, {"tokens": toks},
                                max_new_tokens=GEN_NEW, session=s)
    assert st1.recompiles == 1 and s.stats.free_switches == 0
    built = s.exec_cache.compiles
    s.dispatch = _ScriptedService(reg.TuningRegistry(None), target_index=1)
    out2, st2 = tserve.generate(tm, tp, {"tokens": toks},
                                max_new_tokens=GEN_NEW, session=s)
    assert st2.recompiles == 0 and s.stats.free_switches == 1
    assert s.stats.commits_seen == 2 and s.exec_cache.compiles == built
    assert st2.schedules == st1.schedules
    assert np.array_equal(out1, out2)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_generate_build_a_geometry_over_one_state(models, arch):
    """The engine stays pinned on rank-0 while the service commits
    rank-1; ``generate(session=)`` at the engine's geometry (2 rows, 80
    positions) then builds rank-1's step; the next drain runs that step.
    Every decode step of a geometry holds the same state, so the prompts
    the engine writes are the ones its step reads: both drains give the
    tokens of a drain without dispatch."""
    _, _, tm, tp = models[arch]
    ref, _ = _drain(_session(tm, tp, None))
    svc = _ScriptedService(reg.TuningRegistry(None), target_index=1)
    s = _session(tm, tp, svc, max_recompiles=0)
    first, _ = _drain(s)
    kind, prob = _decode_problem(tm.cfg, "engine")
    cands = svc.candidates(kind, prob, 4)
    assert svc.committed(kind, prob, 4) == cands[1]
    toks = np.random.default_rng(3).integers(
        1, tm.cfg.vocab_size, (2, 64)).astype(np.int32)
    _, gstats = tserve.generate(tm, tp, {"tokens": toks},
                                max_new_tokens=ENGINE_NEW, session=s)
    assert gstats.schedules[kind] == reg.schedule_to_dict(cands[1])
    second, res = _drain(s)
    assert res[-1].stats.schedules[kind] == reg.schedule_to_dict(cands[1])
    assert first == ref and second == ref
    by_geometry = {}
    for k in s.exec_cache.compiled_log:
        if k.role == "decode":
            by_geometry.setdefault(dataclasses.replace(k, schedules=None),
                                   []).append(s.exec_cache.peek(k))
    assert max(len(v) for v in by_geometry.values()) == 2
    for steps in by_geometry.values():
        assert all(st.state[n] is steps[0].state[n]
                   for st in steps for n in steps[0].state)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_engine_refuses_a_step_over_another_state(models, arch):
    """A cached entry of the geometry over another state than the step
    the activation runs: the engine raises before its first decode step
    rather than write its prompts where the step does not read."""
    _, _, tm, tp = models[arch]
    s = _session(tm, tp, None)
    _drain(s)
    (key, step), = [(k, s.exec_cache.peek(k))
                    for k in s.exec_cache.compiled_log if k.role == "decode"]
    other = dataclasses.replace(key, schedules=sch.ScheduleBundle())
    s.exec_cache._entries[other] = CapturedStep(
        lambda: None, torch.device("cpu"),
        state={n: t.clone() for n, t in step.state.items()})
    s.exec_cache._entries.move_to_end(other, last=False)
    with pytest.raises(RuntimeError, match="another state"):
        _drain(s)


@pytest.mark.parametrize("runner", ["generate", "engine"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_warm_registry_starts_on_the_persisted_winner(models, arch,
                                                        runner, tmp_path):
    _, _, tm, tp = models[arch]
    kind, prob = _decode_problem(tm.cfg, runner)
    eb = tp["embed"].element_size()
    path = str(tmp_path / "t.jsonl")
    svc = _ScriptedService(reg.TuningRegistry(path), target_index=1)
    _run(runner, tm, tp, svc)
    rec = svc.registry.get(svc.registry_key(kind, prob, eb))
    assert rec is not None and rec.measured is not None
    # scripted like the first, so its own commit (on the same candidate)
    # cannot move the step: what is checked is where it starts
    fresh = _ScriptedService(reg.TuningRegistry(path), target_index=1)
    before = cm.total_evals()
    _, recompiles, scheds, _ = _run(runner, tm, tp, fresh)
    assert cm.total_evals() == before
    assert recompiles == 0
    assert scheds[kind] == rec.measured["best"]


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_observes_and_builds_no_bundle(models, arch):
    _, _, tm, tp = models[arch]
    svc = DispatchService(reg.TuningRegistry(None), device="cpu")
    s = _session(tm, tp, svc, backend="plain")
    _drain(s)
    assert all(k.schedules is None for k in s.exec_cache.compiled_log)
    assert svc.observations > 0


# ------------------------------------------------ against the JAX package


@pytest.fixture(scope="module")
def jax_generate_tokens(models):
    out = {}
    for arch in ARCHS:
        jm, jp, tm, _ = models[arch]
        toks = jnp.asarray(_gen_batch(tm.cfg))
        svc = _JaxScripted(jreg.TuningRegistry(None), target_index=1)
        tokens, stats = jserve.generate(jm, jp, {"tokens": toks},
                                        max_new_tokens=GEN_NEW,
                                        dispatch=svc, backend="pallas")
        assert stats.recompiles == 1
        out[arch] = np.asarray(tokens)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_the_jax_pallas_path(models,
                                                   jax_generate_tokens,
                                                   arch):
    _, _, tm, tp = models[arch]
    svc = _ScriptedService(reg.TuningRegistry(None), target_index=1)
    out, stats = _generate(tm, tp, svc)
    alone, _ = _generate(tm, tp)
    assert stats.recompiles == 1
    assert np.array_equal(out, jax_generate_tokens[arch])
    assert np.array_equal(alone, out)


def _kinds(bundle):
    return (None if bundle is None else
            frozenset(k for k, v in bundle.to_dict().items()
                      if v is not None))


@pytest.fixture(scope="module")
def jax_engine_runs(models):
    out = {}
    for arch in ARCHS:
        jm, jp, _, _ = models[arch]
        svc = _JaxScripted(jreg.TuningRegistry(None), target_index=1)
        s = JaxSession(jm, jp, dispatch=svc, backend="pallas",
                       batch_sizes=(2,))
        tokens, _ = _drain(s)
        out[arch] = (tokens, [(k.role, k.batch, k.length, k.detail,
                               _kinds(k.schedules))
                              for k in s.exec_cache.compiled_log],
                     s.stats.recompiles)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_jax_engine_with_dispatch(models, jax_engine_runs,
                                                     arch):
    """Tokens equal the JAX engine's with ``dispatch`` and ``"pallas"``
    and the port's without dispatch; the keys equal the JAX session's in
    every field but the bundle, and the bundles name the same kinds."""
    _, _, tm, tp = models[arch]
    svc = _ScriptedService(reg.TuningRegistry(None), target_index=1)
    s = _session(tm, tp, svc)
    tokens, _ = _drain(s)
    plain_tokens, _ = _drain(ServeSession(tm, tp, batch_sizes=(2,)))
    j_tokens, j_keys, j_recompiles = jax_engine_runs[arch]
    assert tokens == j_tokens == plain_tokens
    assert [(k.role, k.batch, k.length, k.detail, _kinds(k.schedules))
            for k in s.exec_cache.compiled_log] == j_keys
    assert s.stats.recompiles == j_recompiles == 1
    assert all(k.backend == "cuda" for k in s.exec_cache.compiled_log)
