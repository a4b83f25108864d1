"""The port's executable cache and captured steps against the JAX
package, on the CPU.

On the CPU a :class:`CapturedStep` runs its step function directly into
its static buffers (no graph), so these tests hold the cache's keys,
counters and reuse, and the steps' tokens, to the JAX session's.  Both
packages get the same weights (the JAX init, bridged).  The engine's
keys are compared as ``(role, batch, length, detail)`` in build order
(the backend names differ: the JAX session runs ``"reference"``).
Tokens must be identical; the contiguous decode step with a device
``pos`` must equal its int form bit for bit and the JAX step to 1e-5
(float32 smoke weights).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.serve_loop import generate as jax_generate  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (build_model, left_pad_prompts,  # noqa: E402
                                prompt_starts)
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402
from repro_torch.serving.cache import ExecKey, ExecutableCache  # noqa: E402
from repro_torch.serving.captured import CapturedStep  # noqa: E402
from test_torch_serving import SCENARIOS, _prompts, _serve  # noqa: E402

PHI3, MAMBA = "phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke"
MAMBA_STREAM = ([5, 7, 3, 6, 12, 9], [6, 3, 8, 1, 5, 4], {}, None)
STREAMS = {**{(PHI3, k): v for k, v in SCENARIOS.items()},
           (MAMBA, "mixed_depths"): MAMBA_STREAM}


# ------------------------------------------------------------ the cache


def _hit_miss_counters():
    cache = ExecutableCache(capacity=4)
    key = ExecKey("arch", "decode", 2, 16, None, "cuda")
    built = []

    def builder():
        built.append(1)
        return "exe"

    exe, hit = cache.get(key, builder)
    assert exe == "exe" and not hit and len(built) == 1
    exe2, hit2 = cache.get(key, builder)
    assert exe2 == "exe" and hit2 and len(built) == 1
    assert cache.stats() == {"entries": 1, "capacity": 4, "hits": 1,
                             "misses": 1, "evictions": 0, "compiles": 1}
    assert cache.hit_rate == 0.5
    assert cache.compiled_roles() == {"decode": 1}


def _lru_eviction():
    cache = ExecutableCache(capacity=2)
    keys = [ExecKey("a", "decode", b, 16, None, "cuda") for b in (1, 2, 3)]
    for i, k in enumerate(keys):
        cache.get(k, lambda i=i: f"exe{i}")
    # capacity 2: key[0] (least recently used) was evicted
    assert cache.evictions == 1
    assert not cache.contains(keys[0])
    assert cache.contains(keys[1]) and cache.contains(keys[2])
    # touching key[1] promotes it; inserting a 4th evicts key[2]
    cache.get(keys[1], lambda: "never")
    cache.get(ExecKey("a", "decode", 9, 16, None, "cuda"), lambda: "exe9")
    assert cache.contains(keys[1]) and not cache.contains(keys[2])
    assert cache.evictions == 2


def _distinguishes_schedules_and_backends():
    cache = ExecutableCache()
    # any hashable stands for a committed bundle here
    for sched in (None, ("decode_attention", 16), ("decode_attention", 32)):
        for backend in ("plain", "cuda"):
            _, hit = cache.get(ExecKey("arch", "decode", 2, 16, sched,
                                       backend), lambda: object())
            assert not hit
    assert cache.compiles == 6
    with pytest.raises(ValueError):
        ExecutableCache(capacity=0)


def _peek_touches_nothing():
    cache = ExecutableCache(capacity=2)
    a, b, c = (ExecKey("a", "prefill", 1, n, None, "cuda")
               for n in (8, 16, 32))
    cache.get(a, lambda: "A")
    cache.get(b, lambda: "B")
    before = cache.stats()
    assert cache.peek(a) == "A" and cache.peek(c) is None
    assert cache.stats() == before
    cache.get(c, lambda: "C")           # a stays least recently used
    assert not cache.contains(a) and cache.contains(b)


CACHE_CASES = {"hit_miss_counters": _hit_miss_counters,
               "lru_eviction": _lru_eviction,
               "distinguishes_schedules_and_backends":
                   _distinguishes_schedules_and_backends,
               "peek_touches_nothing": _peek_touches_nothing}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_exec_cache_unit(case):
    CACHE_CASES[case]()


def test_captured_step_runs_directly_on_the_cpu():
    """No graph on the CPU: each replay runs the function into the same
    static buffers; feed converts host arrays to the inputs' dtype."""
    acc = torch.zeros(3, dtype=torch.int64)
    inputs = {"x": torch.zeros(3, dtype=torch.int64)}

    def fn():
        acc.add_(inputs["x"])
        return acc * 2

    step = CapturedStep(fn, torch.device("cpu"), inputs=inputs,
                        state={"acc": acc})
    assert step.graph is None and step.pool_bytes == 0
    step.feed(x=np.array([1, 2, 3], np.int32))
    assert step.replay().tolist() == [2, 4, 6]
    step.feed(x=np.array([1, 1, 1], np.int32))
    assert step.replay().tolist() == [4, 6, 8]
    assert step.replays == 2 and step.state["acc"] is acc


# ------------------------------------------------- sessions against JAX


def _models(arch):
    jm = jax_build_model(jax_get_config(arch))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(arch)), tp


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in (PHI3, MAMBA)}


def _key_view(cache):
    return [(k.role, k.batch, k.length, k.detail) for k in cache.compiled_log]


@pytest.fixture(scope="module")
def jax_runs(models):
    out = {}
    for (arch, name), (lens, budgets, kw, late) in STREAMS.items():
        jm, jp, _, _ = models[arch]
        s = JaxSession(jm, jp, backend="reference", **kw)
        tokens, order, _ = _serve(s, _prompts(lens), budgets, late)
        out[arch, name] = (tokens, order, _key_view(s.exec_cache),
                           s.exec_cache.compiled_roles(),
                           s.exec_cache.stats())
    return out


@pytest.mark.parametrize("backend", ["cuda", "plain"])
@pytest.mark.parametrize("stream", sorted(STREAMS),
                         ids=lambda s: f"{s[0]}-{s[1]}")
def test_session_builds_the_jax_keys_and_tokens(models, jax_runs, stream,
                                                backend):
    arch, _ = stream
    lens, budgets, kw, late = STREAMS[stream]
    _, _, tm, tp = models[arch]
    s = ServeSession(tm, tp, backend=backend, **kw)
    tokens, order, _ = _serve(s, _prompts(lens), budgets, late)
    j_tokens, j_order, j_keys, j_roles, j_stats = jax_runs[stream]
    assert tokens == j_tokens and order == j_order
    assert _key_view(s.exec_cache) == j_keys
    assert s.exec_cache.compiled_roles() == j_roles
    assert s.exec_cache.stats() == j_stats == s.stats.cache
    assert all(k.backend == backend and k.schedules is None
               for k in s.exec_cache.compiled_log)
    assert s.stats.graph_pool_bytes == 0
    assert all(s.exec_cache.peek(k).graph is None
               for k in s.exec_cache.compiled_log)
    summary = s.stats.to_dict()
    assert summary["cache"] == j_stats
    assert summary["cache_hit_rate"] == s.exec_cache.hit_rate


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_repeat_drain_and_generate_build_nothing(models, arch):
    _, _, tm, tp = models[arch]
    lens, budgets, kw, late = STREAMS[arch, "mixed_depths"]
    s = ServeSession(tm, tp, **kw)
    first, _, _ = _serve(s, _prompts(lens), budgets, late)
    built = s.exec_cache.compiles
    again, _, _ = _serve(s, _prompts(lens), budgets, late)
    assert again == first and s.exec_cache.compiles == built
    prompts = _prompts([3, 8, 6])
    batch = {"tokens": left_pad_prompts(prompts, 8)}
    starts = prompt_starts(prompts, 8)
    out1, _ = generate(tm, tp, batch, max_new_tokens=5, seq_starts=starts,
                       session=s)
    built = s.exec_cache.compiles
    hits = s.exec_cache.hits
    out2, _ = generate(tm, tp, batch, max_new_tokens=5, seq_starts=starts,
                       session=s)
    assert s.exec_cache.compiles == built and s.exec_cache.hits == hits + 2
    assert np.array_equal(out1, out2)


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_generate_with_a_session_matches_jax(models, arch):
    """Tokens equal JAX ``generate`` and the port's ``generate`` without a
    session; the keys equal those of JAX ``generate(session=)``; a call
    whose total length matches an earlier one reuses its decode step."""
    jm, jp, tm, tp = models[arch]
    prompts = _prompts([3, 8, 6])
    toks = left_pad_prompts(prompts, 8)
    starts = prompt_starts(prompts, 8)
    js = JaxSession(jm, jp, backend="reference")
    ref, _ = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)},
                          max_new_tokens=7, seq_starts=starts, session=js)
    s = ServeSession(tm, tp)
    out, stats = generate(tm, tp, {"tokens": toks}, max_new_tokens=7,
                          seq_starts=starts, session=s)
    alone, _ = generate(tm, tp, {"tokens": toks}, max_new_tokens=7,
                        seq_starts=starts)
    assert np.array_equal(out, np.asarray(ref))
    assert np.array_equal(alone, out) and stats.decode_tokens == 18
    assert _key_view(s.exec_cache) == _key_view(js.exec_cache)
    # another prompt length with the same total reuses the decode step
    toks10 = left_pad_prompts(prompts, 10)
    starts10 = prompt_starts(prompts, 10)
    ref10, _ = jax_generate(jm, jp, {"tokens": jnp.asarray(toks10)},
                            max_new_tokens=5, seq_starts=starts10,
                            session=js)
    out10, _ = generate(tm, tp, {"tokens": toks10}, max_new_tokens=5,
                        seq_starts=starts10, session=s)
    assert np.array_equal(out10, np.asarray(ref10))
    assert _key_view(s.exec_cache) == _key_view(js.exec_cache)
    assert s.exec_cache.compiled_roles() == {"prefill": 2, "decode": 1}


def test_twenty_request_stream_builds_fewer_steps(models):
    """The reference's acceptance: one session over a twenty-request
    stream builds fewer steps than twenty one-request sessions, with a
    hit rate of at least 0.5, and its tokens equal theirs."""
    _, _, tm, tp = models[PHI3]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, (5 + i % 4) if i % 2 == 0
                            else (11 + i % 5)).astype(np.int32)
               for i in range(20)]
    budgets = [2 + i % 2 for i in range(20)]
    s = ServeSession(tm, tp, batch_sizes=(1, 2, 4))
    for i, p in enumerate(prompts):
        s.submit(p, budgets[i], request_id=f"r{i}")
    res = {r.request_id: r.tokens.tolist() for r in s.drain()}
    independent = 0
    for i, p in enumerate(prompts):
        one = ServeSession(tm, tp)
        out, _ = generate(tm, tp, {"tokens": p[None, :]},
                          max_new_tokens=budgets[i], session=one)
        independent += one.exec_cache.compiles
        assert out[0].tolist() == res[f"r{i}"]
    assert s.exec_cache.compiles < independent
    assert s.exec_cache.hit_rate >= 0.5


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_contiguous_decode_step_takes_a_device_pos(models, backend):
    """``decode_step`` with ``pos`` as a device tensor (as a captured
    step passes it) equals the int form bit for bit, and the JAX step
    at the same positions to 1e-5."""
    jm, jp, tm, tp = models[PHI3]
    prompts = _prompts([5, 16, 11])
    toks = left_pad_prompts(prompts, 16)
    starts = prompt_starts(prompts, 16)
    s, total = 16, 20
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        seq_starts=jnp.asarray(starts))
    full = jm.init_cache(3, total)
    cj = {"layers": {n: full["layers"][n].at[..., :s, :].set(
        cj["layers"][n]) for n in ("k", "v")}}
    lt, pre = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                         backend=backend,
                         seq_starts=torch.from_numpy(starts))
    caches = []
    for _ in range(2):
        c = tm.init_cache(3, total, torch.device("cpu"))
        for n in ("k", "v"):
            c["layers"][n][..., :s, :].copy_(pre["layers"][n])
        caches.append(c)
    st = torch.from_numpy(starts).long()
    tt = torch.argmax(lt[:, -1], -1)
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    pos_t = torch.tensor(s)
    for i in range(3):
        l_int, _ = tm.decode_step(tp, caches[0], tt[:, None], s + i,
                                  backend=backend, seq_starts=st)
        l_dev, _ = tm.decode_step(tp, caches[1], tt[:, None], pos_t,
                                  backend=backend, seq_starts=st)
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(s + i),
                                seq_starts=jnp.asarray(starts))
        assert torch.equal(l_int, l_dev)
        for n in ("k", "v"):
            assert torch.equal(caches[0]["layers"][n],
                               caches[1]["layers"][n])
        np.testing.assert_allclose(l_dev.numpy(), np.asarray(lj),
                                   rtol=0, atol=1e-5)
        tt = torch.argmax(l_dev[:, -1], -1)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        assert tt.tolist() == np.asarray(tj).tolist()
        pos_t += 1


def test_generate_refuses_another_models_params(models):
    _, _, tm, tp = models[PHI3]
    _, _, mm, mp = models[MAMBA]
    s = ServeSession(tm, tp)
    batch = {"tokens": np.ones((1, 8), np.int32)}
    with pytest.raises(ValueError, match="own model/params"):
        generate(tm, mp, batch, max_new_tokens=2, session=s)
    with pytest.raises(ValueError, match="own model/params"):
        generate(mm, tp, batch, max_new_tokens=2, session=s)
    other = dict(tp)
    with pytest.raises(ValueError, match="own model/params"):
        generate(tm, other, batch, max_new_tokens=2, session=s)
    assert s.exec_cache.compiles == 0


@pytest.mark.parametrize("order", ["drain_first", "generate_first"])
def test_engine_and_generate_share_the_ssm_decode_step(models, order):
    """An ssm engine of 4 rows over prompts of bucket 8 with budget 8,
    and ``generate`` of a [4, 8] batch with 8 new tokens, key their
    decode steps alike (decode, 4, 16, no detail), as in JAX: one entry
    serves both, in either order, with the tokens of fresh sessions."""
    _, _, tm, tp = models[MAMBA]
    prompts = _prompts([5, 8, 3, 7])
    budgets = [8] * 4
    batch = {"tokens": left_pad_prompts(prompts, 8)}
    starts = prompt_starts(prompts, 8)

    def drain(s):
        return _serve(s, prompts, budgets, None)[0]

    def gen(s):
        return generate(tm, tp, batch, max_new_tokens=8, seq_starts=starts,
                        session=s)[0]

    want_d = drain(ServeSession(tm, tp, batch_sizes=(4,)))
    want_g = gen(ServeSession(tm, tp))
    s = ServeSession(tm, tp, batch_sizes=(4,))
    if order == "drain_first":
        got_d, got_g = drain(s), gen(s)
    else:
        got_g, got_d = gen(s), drain(s)
    assert got_d == want_d and np.array_equal(got_g, want_g)
    decode = [k for k in s.exec_cache.compiled_log if k.role == "decode"]
    assert decode == [ExecKey(MAMBA, "decode", 4, 16, None, "cuda")]
    assert s.exec_cache.hits >= 1
    # a second round in the other order builds nothing
    built = s.exec_cache.compiles
    assert np.array_equal(gen(s), want_g) and drain(s) == want_d
    assert s.exec_cache.compiles == built


def test_generate_with_a_session_refuses_other_backend_or_capture(models):
    """With ``session=``, ``backend`` and ``capture`` are the session's:
    naming the same values is allowed, other ones raise before any
    build."""
    _, _, tm, tp = models[PHI3]
    s = ServeSession(tm, tp, backend="plain", capture=False)
    batch = {"tokens": np.ones((1, 8), np.int32)}
    with pytest.raises(ValueError, match="session's backend 'plain'"):
        generate(tm, tp, batch, max_new_tokens=2, session=s, backend="cuda")
    with pytest.raises(ValueError, match="session's capture False"):
        generate(tm, tp, batch, max_new_tokens=2, session=s, capture=True)
    assert s.exec_cache.compiles == 0
    out, stats = generate(tm, tp, batch, max_new_tokens=2, session=s,
                          backend="plain", capture=False)
    assert out.shape == (1, 2) and stats.backend == "plain"
    assert {k.backend for k in s.exec_cache.compiled_log} == {"plain"}


# ------------------------------ the rest of the dense family and moe: the
# engine's and run_batch's drains against the JAX session (greedy tokens,
# order and keys); a moe step routes pad positions and idle rows too

MINITRON, QWEN2_MOE = "minitron-4b-smoke", "qwen2-moe-a2.7b-smoke"
# qwen2-moe's smoke config at capacity factor 0.5, so that prefills and
# decode steps drop slots and the pad positions' routing shows
DROPPING = QWEN2_MOE + "@0.5"
NEW_STREAMS = {(arch, name): SCENARIOS[name]
               for arch in (MINITRON, QWEN2_MOE, DROPPING)
               for name in ("mixed_depths", "compaction")}


def _moe_models(arch):
    import dataclasses
    name, factor = arch.split("@")
    jcfg = dataclasses.replace(jax_get_config(name),
                               capacity_factor=float(factor))
    jm = jax_build_model(jcfg)
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = dataclasses.replace(get_config(name), capacity_factor=float(factor))
    return jm, jp, build_model(tcfg), tp


@pytest.fixture(scope="module")
def new_models():
    return {arch: (_moe_models(arch) if "@" in arch else _models(arch))
            for arch in (MINITRON, QWEN2_MOE, DROPPING)}


@pytest.fixture(scope="module")
def jax_new_runs(new_models):
    out = {}
    for (arch, name), (lens, budgets, kw, late) in NEW_STREAMS.items():
        jm, jp, _, _ = new_models[arch]
        s = JaxSession(jm, jp, backend="reference", **kw)
        tokens, order, _ = _serve(s, _prompts(lens), budgets, late)
        prompts = _prompts([3, 8, 6])
        ref, _ = jax_generate(
            jm, jp, {"tokens": jnp.asarray(left_pad_prompts(prompts, 8))},
            max_new_tokens=6, seq_starts=prompt_starts(prompts, 8),
            session=s)
        out[arch, name] = (tokens, order, np.asarray(ref),
                           _key_view(s.exec_cache))
    return out


@pytest.mark.parametrize("backend", ["cuda", "plain"])
@pytest.mark.parametrize("stream", sorted(NEW_STREAMS),
                         ids=lambda s: f"{s[0].split('-')[0]}-{s[1]}")
def test_new_arch_drains_build_the_jax_keys_and_tokens(new_models,
                                                       jax_new_runs, stream,
                                                       backend):
    arch, _ = stream
    lens, budgets, kw, late = NEW_STREAMS[stream]
    from repro_torch.models.moe import drop_tally
    _, _, tm, tp = new_models[arch]
    s = ServeSession(tm, tp, backend=backend, **kw)
    prompts = _prompts([3, 8, 6])
    with drop_tally("cpu") as dropped:
        tokens, order, states = _serve(s, _prompts(lens), budgets, late)
        out, _ = generate(tm, tp, {"tokens": left_pad_prompts(prompts, 8)},
                          max_new_tokens=6,
                          seq_starts=prompt_starts(prompts, 8), session=s)
    assert (int(dropped) > 0) == (arch == DROPPING)
    j_tokens, j_order, j_out, j_keys = jax_new_runs[stream]
    assert tokens == j_tokens and order == j_order
    assert set(states) == {"COMPLETED"}
    assert np.array_equal(out, j_out)
    assert _key_view(s.exec_cache) == j_keys
    assert {k.role for k in s.exec_cache.compiled_log} == {"prefill",
                                                          "decode"}
