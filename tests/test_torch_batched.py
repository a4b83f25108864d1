"""The port's bucketed path (``_next_group``, ``_form_batch``,
``_drain_batched``, ``run_batch``) and sampled decoding against the JAX
session, on the CPU.

Both packages get the same weights (the JAX init, bridged) and serve
float32 smoke configs, so greedy tokens must be identical, and so must
the buckets each group is served in, the retirement order, the cache
keys and the session's counters.  Sampled tokens cannot equal the JAX
package's (another PRNG); the port's sampler is held to its
distribution instead: on fixed logits the frequencies of 20,000
Gumbel-max draws lie within 4 sigma of ``softmax(logits / T)``.  A
sampled step samples inside the step, so its key carries the detail
``SAMPLED``; greedy keys equal the JAX session's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.dispatch import DispatchService as JaxService  # noqa: E402
from repro.runtime.serve_loop import generate as jax_generate  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.models import (build_model, left_pad_prompts,  # noqa: E402
                                prompt_starts)
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.runtime.dispatch import DispatchService  # noqa: E402
from repro_torch.runtime.serve_loop import serve_dispatch_problems  # noqa: E402
from repro_torch.serving import Bucket, ServeSession  # noqa: E402
from repro_torch.serving.captured import SAMPLED, sample_pick  # noqa: E402

PHI3, MAMBA = "phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke"


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


def _stream(n, seed=0):
    """The reference's twenty-request stream (prompts 5-8 and 11-15
    tokens, budgets 2-3), cut to ``n``."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 256, (5 + i % 4) if i % 2 == 0
                            else (11 + i % 5)).astype(np.int32)
               for i in range(n)]
    return prompts, [2 + i % 2 for i in range(n)]


def _batched(session, prompts, budgets):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        session.submit(p, b, request_id=f"r{i}")
    res = session._drain_batched()
    return [(r.request_id, r.tokens.tolist(), r.bucket.batch,
             r.bucket.prompt_len, r.bucket.total_len, r.state) for r in res]


STREAMS = {(PHI3, "twenty"): (20, dict(batch_sizes=(1, 2, 4),
                                       bucket_lengths=(8, 16))),
           (MAMBA, "eight"): (8, dict(batch_sizes=(1, 2, 4))),
           (PHI3, "pad_rows"): (3, dict(batch_sizes=(4,)))}


@pytest.fixture(scope="module")
def jax_batched(models):
    out = {}
    for (arch, name), (n, kw) in STREAMS.items():
        jm, jp, _, _ = models[arch]
        s = JaxSession(jm, jp, backend="reference", **kw)
        prompts, budgets = _stream(n)
        out[arch, name] = (_batched(s, prompts, budgets), s)
    return out


@pytest.mark.parametrize("stream", sorted(STREAMS),
                         ids=lambda s: f"{s[0].split('-')[0]}-{s[1]}")
def test_drain_batched_matches_jax(models, jax_batched, stream):
    """Groups, buckets, tokens, order, keys and counters of the JAX
    session's ``_drain_batched``; a group smaller than its bucket (in
    ``pad_rows``, 2 and 1 requests in 4 rows) keeps its pad rows
    finite."""
    arch, name = stream
    n, kw = STREAMS[stream]
    _, _, tm, tp = models[arch]
    s = ServeSession(tm, tp, **kw)
    prompts, budgets = _stream(n)
    got = _batched(s, prompts, budgets)
    want, js = jax_batched[stream]
    assert got == want
    assert _key_view(s.exec_cache) == _key_view(js.exec_cache)
    assert s.exec_cache.stats() == js.exec_cache.stats()
    for k in ("requests", "batches", "tokens_generated"):
        assert getattr(s.stats, k) == getattr(js.stats, k), k
    assert ([dataclasses.astuple(b) for b in sorted(s.stats.per_bucket)]
            == [(b.batch, b.prompt_len, b.total_len)
                for b in sorted(js.stats.per_bucket)])
    assert s.stats.steps == 0           # no engine step ran
    assert s.stats.decode_tokens == sum(b - 1 for b in budgets)
    if name == "pad_rows":
        # groups of 2 (prompt bucket 8) and 1 (bucket 16) in 4 rows
        assert sorted(s.stats.per_bucket) == [Bucket(4, 8, 16),
                                              Bucket(4, 16, 24)]
        for k in s.exec_cache.compiled_log:
            flags = s.exec_cache.peek(k).outputs
            flags = flags[0] if k.role == "prefill" else flags
            assert flags[1].tolist() == [1, 1, 1, 1], k
    # a warm second pass builds nothing and gives the same tokens
    built = s.exec_cache.compiles
    again = _batched(s, prompts, budgets)
    assert [r[1] for r in again] == [r[1] for r in got]
    assert s.exec_cache.compiles == built


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_run_batch_padded_generation_equals_solo(models, arch):
    """``tests/test_masks.py``'s padded-vs-solo test through
    ``run_batch``: each left-padded row's tokens equal the row run alone
    and the JAX session's ``run_batch``."""
    jm, jp, tm, tp = models[arch]
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 256, size=n).astype(np.int32)
               for n in (3, 6, 8)]
    starts = prompt_starts(prompts, 8)
    toks = left_pad_prompts(prompts, 8)
    s = ServeSession(tm, tp)
    out, _ = s.run_batch({"tokens": toks}, max_new_tokens=5,
                         seq_starts=starts)
    ref, _ = JaxSession(jm, jp, backend="reference").run_batch(
        {"tokens": jnp.asarray(toks)}, max_new_tokens=5, seq_starts=starts)
    assert np.array_equal(out, np.asarray(ref))
    for i, p in enumerate(prompts):
        solo, _ = s.run_batch({"tokens": p[None]}, max_new_tokens=5)
        assert out[i].tolist() == solo[0].tolist(), i


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_run_batch_widened_capacity_matches_jax(models, arch):
    """``total_len`` widens the decode step's cache (the kernel then
    sees a capacity beyond the positions it reads); tokens equal the
    JAX session's, and the decode key carries the widened length."""
    jm, jp, tm, tp = models[arch]
    prompts, _ = _stream(4, seed=5)
    toks = left_pad_prompts(prompts, 16)
    starts = prompt_starts(prompts, 16)
    s = ServeSession(tm, tp)
    js = JaxSession(jm, jp, backend="reference")
    out, stats = s.run_batch({"tokens": toks}, max_new_tokens=5,
                             total_len=40, seq_starts=starts,
                             real_tokens=12)
    ref, _ = js.run_batch({"tokens": jnp.asarray(toks)}, max_new_tokens=5,
                          total_len=40, seq_starts=starts, real_tokens=12)
    assert np.array_equal(out, np.asarray(ref))
    assert _key_view(s.exec_cache) == _key_view(js.exec_cache)
    assert ("decode", 4, 40, None) in _key_view(s.exec_cache)
    assert s.stats.tokens_generated == js.stats.tokens_generated == 12
    assert stats.tokens_generated == 20
    with pytest.raises(ValueError, match="total_len"):
        s.run_batch({"tokens": toks}, max_new_tokens=5, total_len=20)


def test_bucket_selection_under_skewed_measured_times(models):
    """``tests/test_serving.py``'s test: measured decode times say batch
    2 is the best bucket; the engine serves the four requests in one
    activation of 2 rows, and ``_drain_batched`` in two groups of 2,
    in both packages."""
    jm, jp, tm, tp = models[PHI3]
    cfg = tm.cfg
    eb = tp["embed"].element_size()

    def skewed_service():
        svc = DispatchService(reg.TuningRegistry(None), device="cpu")
        for b in (1, 2, 4):
            kind, prob = serve_dispatch_problems(cfg, b, 8, 16)["decode"]
            svc.registry.record_measurement(
                svc.registry_key(kind, prob, eb),
                reg.schedule_to_dict(svc.candidates(kind, prob, eb)[0]),
                1e-6 if b == 2 else 10.0 * b)
        return svc

    def jax_skewed():
        svc = JaxService(jreg.TuningRegistry(None))
        for b in (1, 2, 4):
            kind, prob = serve_dispatch_problems(cfg, b, 8, 16)["decode"]
            from repro.runtime.dispatch import FAMILIES, canonical_problem
            rkey = FAMILIES[kind].key(canonical_problem(kind, **prob),
                                      svc.spec, 2)
            svc.registry.record_measurement(
                rkey, jreg.schedule_to_dict(svc.candidates(kind, prob)[0]),
                1e-6 if b == 2 else 10.0 * b)
        return svc

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 6) for _ in range(4)]
    for batched in (False, True):
        got = []
        for make, svc in ((ServeSession, skewed_service()),
                          (JaxSession, jax_skewed())):
            m, p = (tm, tp) if make is ServeSession else (jm, jp)
            kw = {} if make is ServeSession else {"backend": "reference"}
            s = make(m, p, dispatch=svc, batch_sizes=(1, 2, 4),
                     bucket_lengths=(8, 16), **kw)
            for i, pr in enumerate(prompts):
                s.submit(pr, 3, request_id=f"r{i}")
            res = s._drain_batched() if batched else s.drain()
            got.append(([(r.request_id, r.tokens.tolist(),
                          (r.bucket.batch, r.bucket.prompt_len,
                           r.bucket.total_len)) for r in res],
                        s.stats.batches, s.stats.inflight_admissions))
        assert got[0] == got[1]
        results, batches, admissions = got[0]
        assert {b for _, _, b in results} == {(2, 8, 16)}
        assert (batches, admissions) == ((2, 0) if batched else (1, 4))


def test_submit_rejects_invalid_requests(models):
    """Both packages refuse the same requests at submission, the queue
    unwedged; with ``bucket_lengths`` a prompt beyond the largest bucket
    is refused too."""
    jm, jp, tm, tp = models[PHI3]
    for s in (ServeSession(tm, tp, bucket_lengths=(8, 16)),
              JaxSession(jm, jp, backend="reference",
                         bucket_lengths=(8, 16))):
        for tokens, budget, match in (([], 4, "at least one token"),
                                      ([1, 2], 0, "max_new_tokens"),
                                      (list(range(1, 18)), 2, "largest")):
            with pytest.raises(ValueError, match=match):
                s.submit(tokens, max_new_tokens=budget)
        assert s.pending() == 0
        s.submit(list(range(1, 17)), 2)
        assert s.pending() == 1


def test_generate_defers_to_session_temperature(models):
    """A session at T=1.5 samples by default and ``temperature=0.0``
    overrides it back to greedy, which builds (then reuses) the greedy
    steps: their keys equal the JAX session's, the sampled ones carry
    ``SAMPLED``; the greedy tokens equal JAX ``generate``'s."""
    jm, jp, tm, tp = models[PHI3]
    toks = np.array(jax.random.randint(jax.random.key(1), (2, 8), 0,
                                       tm.cfg.vocab_size))
    s = ServeSession(tm, tp, temperature=1.5)
    sampled, _ = generate(tm, tp, {"tokens": toks}, max_new_tokens=8,
                          session=s,
                          generator=torch.Generator().manual_seed(3))
    greedy, _ = generate(tm, tp, {"tokens": toks}, max_new_tokens=8,
                         session=s, temperature=0.0)
    greedy2, _ = generate(tm, tp, {"tokens": toks}, max_new_tokens=8,
                          session=s, temperature=0.0)
    assert not np.array_equal(sampled, greedy)
    assert np.array_equal(greedy, greedy2)
    js = JaxSession(jm, jp, backend="reference", temperature=1.5)
    ref, _ = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)},
                          max_new_tokens=8, session=js, temperature=0.0)
    assert np.array_equal(greedy, np.asarray(ref))
    keys = _key_view(s.exec_cache)
    assert keys[:2] == [("prefill", 2, 8, SAMPLED),
                        ("decode", 2, 16, SAMPLED)]
    assert keys[2:] == _key_view(js.exec_cache)
    assert s.exec_cache.compiles == 4


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_sampled_tokens_follow_the_generator(models, arch):
    """The same seed gives the same tokens (a generator seeded 0 equals
    none), another seed other tokens, all inside the vocabulary; the
    session's sampled drain takes the bucketed path and builds only
    sampled steps."""
    _, _, tm, tp = models[arch]
    prompts, _ = _stream(4, seed=2)
    toks = left_pad_prompts(prompts, 16)
    starts = prompt_starts(prompts, 16)
    s = ServeSession(tm, tp)

    def run(seed):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return generate(tm, tp, {"tokens": toks}, max_new_tokens=10,
                        seq_starts=starts, temperature=0.8, generator=g,
                        session=s)[0]

    a, b, none, c = run(0), run(0), run(None), run(1)
    assert np.array_equal(a, b) and np.array_equal(a, none)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < tm.cfg.vocab_size
    assert s.exec_cache.compiles == 2   # one sampled prefill and decode
    d = ServeSession(tm, tp, temperature=0.8, batch_sizes=(4,))
    for i, p in enumerate(prompts):
        d.submit(p, 6, request_id=f"r{i}")
    res = d.drain()
    assert d.stats.steps == 0 and d.stats.batches == 2  # prompt buckets 8, 16
    assert [r.state for r in res] == ["COMPLETED"] * 4
    assert {k.detail for k in d.exec_cache.compiled_log} == {SAMPLED}


def test_gumbel_max_frequencies_match_the_softmax():
    """20,000 draws on fixed logits: every token's frequency lies within
    4 sigma of softmax(logits / T); non-finite logits clear the flag."""
    n, temp = 20000, 0.7
    logits = torch.tensor([1.0, 0.5, -0.3, 2.0, 0.0, -1.5])
    gen = torch.Generator().manual_seed(0)
    noise = torch.rand((n, logits.numel()), generator=gen)
    picked = sample_pick(logits.expand(n, -1), noise, torch.tensor(temp))
    assert picked[1].tolist() == [1] * n
    freq = torch.bincount(picked[0], minlength=logits.numel()).double() / n
    p = torch.softmax(logits.double() / temp, dim=-1)
    sigma = torch.sqrt(p * (1 - p) / n)
    assert torch.all((freq - p).abs() <= 4 * sigma), (freq, p)
    bad = logits.clone()
    bad[2] = float("nan")
    assert sample_pick(bad[None], noise[:1], torch.tensor(temp))[1].item() == 0


@pytest.mark.parametrize("arch", [PHI3, MAMBA])
def test_serve_decode_write_back_matches_jax(models, arch):
    """An activation and a ``run_batch`` call each write one
    ``serve_decode`` measurement under the problem the JAX session
    writes, filed under the port's runtime fingerprint of the CPU."""
    jm, jp, tm, tp = models[arch]
    prompts, budgets = _stream(4, seed=4)
    problems = []
    for make, registry in ((ServeSession, reg.TuningRegistry(None)),
                           (JaxSession, jreg.TuningRegistry(None))):
        m, p = (tm, tp) if make is ServeSession else (jm, jp)
        kw = {} if make is ServeSession else {"backend": "reference"}
        s = make(m, p, registry=registry, batch_sizes=(2,), **kw)
        for i, (pr, b) in enumerate(zip(prompts, budgets)):
            s.submit(pr, b, request_id=f"r{i}")
        s.drain()
        s.run_batch({"tokens": left_pad_prompts(prompts[:2], 16)},
                    max_new_tokens=3)
        keys = [r.key for r in registry._records.values()]
        assert {k.kind for k in keys} == {"serve_decode"}
        problems.append(sorted(sorted(k.problem) for k in keys))
        if make is ServeSession:
            assert {k.machine for k in keys} == {
                reg.runtime_fingerprint("cpu")}
            assert all(r.measured["time_s"] > 0
                       for r in registry._records.values())
    assert problems[0] == problems[1] and len(problems[0]) == 2
