"""The port's hybrid family (recurrentgemma: RG-LRU + local attention)
against the JAX package on the CPU, with the same weights (the JAX
init, bridged through :func:`repro_torch.bridge.params_from_numpy`) and
inputs from numpy seeds.

Tolerances: float32 atol/rtol 1e-4 for logits (as tests/
test_torch_model.py), 1e-5 for the log-depth scan and the attention
pieces (one float32 sum order against another); greedy tokens exact.
The smoke config has ``local_window=16``: prompts of 24 tokens run the
windowed prefill, and decode runs past the rolling buffer's wrap.  The
smoke config is one (rglru, rglru, attn) group; ``FIVE`` adds a tail of
two RG-LRU layers, as recurrentgemma-9b's 38 layers have.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro.runtime.serve_loop import generate as jax_generate  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model, ssm as tssm  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402
from repro_torch.serving.captured import (cache_state, cache_tree,  # noqa: E402
                                          fit_into)

ARCH = "recurrentgemma-9b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
FINE = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _cfgs(n_layers=None):
    jc, tc = jax_get_config(ARCH), get_config(ARCH)
    if n_layers:
        jc = dataclasses.replace(jc, n_layers=n_layers)
        tc = dataclasses.replace(tc, n_layers=n_layers)
    return jc, tc


def _models(n_layers=None):
    jc, tc = _cfgs(n_layers)
    jm = jax_build_model(jc)
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(tc), tp


@pytest.fixture(scope="module")
def models():
    return {3: _models(), 5: _models(5)}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: v})
    return out


def _jflat(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", ["recurrentgemma-9b", ARCH])
def test_config_copy_matches_jax(name):
    mine, theirs = get_config(name), jax_get_config(name)
    assert mine.__dict__ == theirs.__dict__
    assert mine.param_count() == theirs.param_count()
    assert mine.resolved_lru_width == theirs.resolved_lru_width


@pytest.mark.parametrize("n_layers", [3, 5, 38])
def test_hybrid_counts_match_jax(n_layers):
    from repro.models.transformer import _hybrid_counts
    jc, tc = _cfgs(n_layers)
    assert transformer.hybrid_counts(tc) == _hybrid_counts(jc)


@pytest.mark.parametrize("n_layers", [3, 5])
def test_init_paths_and_shapes_match_jax(models, n_layers):
    _, jp, tm, _ = models[n_layers]
    mine = _flat(tm.init(seed=0, device="cpu"))
    theirs = _jflat(jp)
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        assert tuple(v.shape) == theirs[k].shape, k
        sj = float(np.std(np.asarray(theirs[k])))
        assert abs(float(v.float().std()) - sj) <= 0.1 * sj + 1e-12, k


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_associative_scan_matches_jax_linear_scan(s):
    rng = np.random.RandomState(s)
    a = rng.uniform(0.05, 1.0, (3, s, 5)).astype(np.float32)
    b = rng.randn(3, s, 5).astype(np.float32)
    want = np.asarray(jssm.linear_scan(jnp.asarray(a), jnp.asarray(b)))
    got = tssm.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **FINE)
    # the inputs are not modified (the scan works on copies)
    assert np.array_equal(torch.from_numpy(a).numpy(), a)


def _rglru_params(models, layer=0):
    _, jp, _, tp = models[3]
    jlp = jax.tree.map(lambda t: t[layer], jp["groups"]["b0"]["rglru"])
    tlp = transformer.layer_params(tp["groups"]["b0"]["rglru"], layer)
    return jlp, tlp


def test_rglru_block_full_form_matches_jax(models):
    jlp, tlp = _rglru_params(models)
    x = np.random.RandomState(1).randn(2, 24, 64).astype(np.float32)
    yj, cj = jssm.rglru_block(jnp.asarray(x), jlp)
    yt, ct = tssm.rglru_block(torch.from_numpy(x), tlp)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FINE)
    for name in ("h", "conv"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   **FINE)


def test_rglru_block_cached_form_matches_jax(models):
    jlp, tlp = _rglru_params(models)
    rng = np.random.RandomState(2)
    cj = {"h": jnp.asarray(rng.randn(2, 64).astype(np.float32)),
          "conv": jnp.asarray(rng.randn(2, 3, 64).astype(np.float32))}
    ct = {n: torch.from_numpy(np.asarray(v).copy()) for n, v in cj.items()}
    for t in range(6):
        x = rng.randn(2, 1, 64).astype(np.float32)
        yj, cj = jssm.rglru_block(jnp.asarray(x), jlp, cache=cj)
        before = {n: v.clone() for n, v in ct.items()}
        yt, ct_new = tssm.rglru_block(torch.from_numpy(x), tlp, cache=ct)
        # the given cache is not modified
        assert all(torch.equal(before[n], ct[n]) for n in ct)
        ct = ct_new
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FINE)
        for name in ("h", "conv"):
            np.testing.assert_allclose(ct[name].numpy(),
                                       np.asarray(cj[name]), **FINE)


def test_rglru_cache_init_matches_jax():
    mine = tssm.rglru_cache_init(3, 16, 4, torch.float32, CPU)
    theirs = jssm.rglru_cache_init(3, 16, 4, jnp.float32)
    for n in ("h", "conv"):
        assert tuple(mine[n].shape) == theirs[n].shape
        assert not mine[n].any()


def _qkv(seed, b=2, hq=4, hkv=2, s=24, d=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32),
            rng.randn(b, hkv, s, d).astype(np.float32))


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
@pytest.mark.parametrize("window", [None, 5, 16])
def test_windowed_attention_matches_jax(backend, jax_backend, window):
    q, k, v = _qkv(3)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, backend=jax_backend)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window,
                          backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FINE)


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
@pytest.mark.parametrize("pos", [3, 15, 16, 23, 40])
def test_decode_attention_over_a_wrapped_rolling_cache(backend,
                                                       jax_backend, pos):
    """A rolling buffer of 16 slots: before the wrap (pos < 16) the
    slots up to pos are valid, after it every slot."""
    rng = np.random.RandomState(pos)
    q = rng.randn(2, 4, 1, 16).astype(np.float32)
    ck = rng.randn(2, 2, 16, 16).astype(np.float32)
    cv = rng.randn(2, 2, 16, 16).astype(np.float32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.int32(pos),
                                  window=16, backend=jax_backend)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                 torch.from_numpy(cv), pos, window=16,
                                 backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FINE)


@pytest.mark.parametrize("pos", [0, 9, 16, 37])
def test_update_kv_cache_writes_the_rolling_slot(pos):
    rng = np.random.RandomState(pos)
    ck = rng.randn(2, 2, 16, 8).astype(np.float32)
    cv = rng.randn(2, 2, 16, 8).astype(np.float32)
    k = rng.randn(2, 2, 1, 8).astype(np.float32)
    v = rng.randn(2, 2, 1, 8).astype(np.float32)
    wk, wv = jattn.update_kv_cache(jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(pos), window=16)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tattn.update_kv_cache(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                          torch.tensor(pos), window=16)
    assert np.array_equal(tk.numpy(), np.asarray(wk))
    assert np.array_equal(tv.numpy(), np.asarray(wv))


def _jfit(full, pre):
    def fit(dst, src):
        if dst.shape == src.shape:
            return src.astype(dst.dtype)
        return dst.at[tuple(slice(0, n) for n in src.shape)].set(src)
    return jax.tree.map(fit, full, pre)


def _tfit(full, pre):
    dst = cache_state(full)
    for name, t in cache_state(pre).items():
        fit_into(dst[name], t)
    return full


PAIRS = [("plain", "xla"), ("cuda", "xla"), ("cuda", "pallas")]


@pytest.mark.parametrize("n_layers", [3, 5])
@pytest.mark.parametrize("backend,jax_backend", PAIRS)
@pytest.mark.parametrize("s", [12, 24])
def test_prefill_and_decode_logits_match_jax(models, n_layers, backend,
                                             jax_backend, s):
    """A prompt of 12 (inside the window) or 24 tokens (past it: the
    windowed prefill, the cache rotated into rolling slots), then 14
    decode steps in a cache of s + 14 positions: past the wrap of the
    16-slot buffer.  Logits, caches and greedy tokens."""
    jm, jp, tm, tp = models[n_layers]
    toks = np.random.RandomState(s).randint(1, 256, (2, s)).astype(np.int32)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        backend=jax_backend)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend=backend)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    want = _jflat(cj)
    got = {k: v.numpy() for k, v in cache_state(ct).items()}
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL)
    steps = 14
    cj = _jfit(jm.init_cache(2, s + steps), cj)
    ct = _tfit(tm.init_cache(2, s + steps, CPU), ct)
    assert transformer.cache_window(tm.cfg, ct) == 16
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    for i in range(steps):
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(s + i),
                                backend=jax_backend)
        lt, ct = tm.decode_step(tp, ct, tt[:, None],
                                torch.tensor(s + i), backend=backend)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)
        assert np.array_equal(np.asarray(tj), tt.numpy()), i


def test_init_cache_tree_matches_jax(models):
    jm, _, tm, _ = models[5]
    for max_len in (8, 40):
        want = {k: v.shape for k, v in _jflat(jm.init_cache(3, max_len))
                .items()}
        got = {k: tuple(v.shape) for k, v in
               cache_state(tm.init_cache(3, max_len, CPU)).items()}
        assert got == want


def test_cache_state_round_trips(models):
    _, _, tm, _ = models[5]
    cache = tm.init_cache(2, 20, CPU)
    st = cache_state(cache)
    assert "groups/b2/k" in st and "tail/b1/h" in st
    back = cache_tree(st)
    assert all(a is b for a, b in zip(cache_state(back).values(),
                                      st.values()))
    dense = {"layers": {"k": torch.zeros(1), "v": torch.zeros(1)}}
    assert cache_state(dense) is dense["layers"]
    assert cache_tree(cache_state(dense)) == dense


def test_seq_starts_and_block_tables_raise(models):
    _, _, tm, tp = models[3]
    toks = torch.ones((1, 8), dtype=torch.int32)
    st = torch.zeros((1,), dtype=torch.int64)
    with pytest.raises(ValueError, match="seq_starts"):
        tm.prefill(tp, {"tokens": toks}, seq_starts=st)
    with pytest.raises(ValueError, match="seq_starts"):
        tm.forward(tp, {"tokens": toks}, seq_starts=st)
    cache = tm.init_cache(1, 8, CPU)
    with pytest.raises(ValueError, match="seq_starts"):
        tm.decode_step(tp, cache, toks[:, :1], 0, seq_starts=st)
    with pytest.raises(ValueError, match="block_tables"):
        tm.decode_step(tp, cache, toks[:, :1], st,
                       block_tables=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="seq_starts"):
        ServeSession(tm, tp).run_batch({"tokens": toks.numpy()},
                                       max_new_tokens=2, seq_starts=st)
    with pytest.raises(ValueError):
        tm.init_paged_cache(4, 4, CPU)


def _stream(n=7, seed=0):
    """Prompts of 5-30 tokens (buckets 8, 16 and 32: two of them past
    the window), budgets 3-12."""
    rng = np.random.default_rng(seed)
    lens = [5, 30, 13, 9, 21, 7, 17][:n]
    return ([rng.integers(1, 256, n_).astype(np.int32) for n_ in lens],
            [3 + (5 * i) % 10 for i in range(n)])


def _drain(session, prompts, budgets):
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        session.submit(p, b, request_id=f"r{i}")
    return [(r.request_id, r.tokens.tolist(), r.bucket.batch,
             r.bucket.prompt_len, r.bucket.total_len, r.state)
            for r in session.drain()]


@pytest.mark.parametrize("n_layers", [3, 5])
def test_drain_tokens_and_buckets_match_jax_session(models, n_layers):
    """``drain`` sends the hybrid family to ``_drain_batched`` (greedy
    too, as in JAX): groups, buckets, tokens, order and cache keys of
    the JAX session's."""
    jm, jp, tm, tp = models[n_layers]
    prompts, budgets = _stream()
    js = JaxSession(jm, jp, backend="reference", batch_sizes=(1, 2, 4))
    want = _drain(js, prompts, budgets)
    s = ServeSession(tm, tp, batch_sizes=(1, 2, 4))
    got = _drain(s, prompts, budgets)
    assert got == want
    assert s.stats.steps == 0 and s.stats.inflight_admissions == 0
    assert ([(k.role, k.batch, k.length, k.detail)
             for k in s.exec_cache.compiled_log]
            == [(k.role, k.batch, k.length, k.detail)
                for k in js.exec_cache.compiled_log])
    assert s.stats.tokens_generated == js.stats.tokens_generated
    assert s.stats.decode_tokens == sum(b - 1 for b in budgets)


def test_inflight_engine_refuses_the_hybrid_family(models):
    _, _, tm, tp = models[3]
    s = ServeSession(tm, tp)
    s.submit(np.arange(1, 6), 2)
    with pytest.raises(ValueError, match="bucketed path"):
        s._drain_inflight()


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_run_batch_and_generate_match_jax(models, backend):
    """A batch of 3 prompts of 20 tokens in a widened cache (total 40:
    the rolling buffer wraps at 16) through ``run_batch`` and
    ``generate``, against the JAX session's ``run_batch`` and
    ``generate``."""
    jm, jp, tm, tp = models[5]
    toks = np.random.RandomState(7).randint(1, 256, (3, 20)).astype(
        np.int32)
    js = JaxSession(jm, jp, backend="reference")
    want, _ = js.run_batch({"tokens": jnp.asarray(toks)}, max_new_tokens=12,
                           total_len=40)
    s = ServeSession(tm, tp, backend=backend)
    got, stats = s.run_batch({"tokens": toks}, max_new_tokens=12,
                             total_len=40)
    assert np.array_equal(got, np.asarray(want))
    assert stats.decode_tokens == 3 * 11
    jg, _ = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)},
                         max_new_tokens=12)
    tg, _ = generate(tm, tp, {"tokens": toks}, max_new_tokens=12,
                     backend=backend)
    assert np.array_equal(tg, np.asarray(jg))
