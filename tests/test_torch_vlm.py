"""The port's vlm family (paligemma: a gemma decoder whose input is the
image's patch embeddings, then the text) against the JAX package on the
CPU, with the same weights (the JAX init, bridged) and inputs from
numpy seeds.

Tolerances: float32 atol/rtol 1e-4 for logits (as tests/
test_torch_model.py); greedy tokens exact.  The session serves the
family through the bucketed path only, with each request's
``image_embeds`` stacked into its group's batch (zeros where a request
has none), and its cache holds the image tokens besides the text.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.serve_loop import generate as jax_generate  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402
from repro_torch.serving.captured import cache_state, fit_into  # noqa: E402


def _flat(tree, pre=""):
    """A nested dict's leaves under their ``/``-joined paths."""
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: v})
    return out

ARCH = "paligemma-3b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
N_IMG = 8                       # the smoke config's image tokens
D = 64


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(jax_get_config(ARCH))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(ARCH)), tp


def _img(b, seed):
    return np.random.RandomState(seed).randn(b, N_IMG, D).astype(np.float32)


@pytest.mark.parametrize("name", ["paligemma-3b", ARCH])
def test_config_copy_matches_jax(name):
    mine, theirs = get_config(name), jax_get_config(name)
    assert mine.__dict__ == theirs.__dict__
    assert mine.param_count() == theirs.param_count()


def test_init_paths_and_shapes_match_jax(models):
    _, jp, tm, _ = models
    theirs = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf
              in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {k: tuple(v.shape)
           for k, v in _flat(tm.init(seed=0, device="cpu")).items()}
    assert got == theirs


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", ["paligemma-3b", "whisper-large-v3",
                                  "phi3-mini-3.8b"])
def test_input_specs_match_jax(name, shape):
    sc = SHAPES[shape]
    want = jax_build_model(jax_get_config(name)).input_specs(sc)
    got = build_model(get_config(name)).input_specs(
        sc.global_batch, sc.seq_len, sc.kind)
    assert sorted(got) == sorted(want)
    for k, (shp, dt) in got.items():
        assert shp == want[k].shape, k
        assert str(dt).split(".")[-1] == str(want[k].dtype), k


def test_embed_inputs_puts_the_image_first(models):
    _, _, tm, tp = models
    toks = torch.tensor([[3, 4, 5]])
    img = torch.from_numpy(_img(1, 0))
    x = transformer.embed_inputs(tp, tm.cfg, {"tokens": toks,
                                              "image_embeds": img})
    assert x.shape == (1, N_IMG + 3, D)
    assert torch.equal(x[:, :N_IMG], img)
    assert torch.equal(x[:, N_IMG:], tp["embed"][toks])


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
def test_prefill_and_decode_logits_match_jax(models, backend, jax_backend):
    """A prompt of 12 text tokens behind 8 image tokens, then 10 decode
    steps from position 20 in a cache of 30 positions."""
    jm, jp, tm, tp = models
    toks = np.random.RandomState(1).randint(1, 256, (2, 12)).astype(
        np.int32)
    img = _img(2, 1)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "image_embeds": jnp.asarray(img)},
                        backend=jax_backend)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "image_embeds": torch.from_numpy(img)},
                        backend=backend)
    assert lt.shape == (2, N_IMG + 12, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct["layers"][n].numpy(),
                                   np.asarray(cj["layers"][n]), **TOL)
    pos0, steps = N_IMG + 12, 10
    full = jm.init_cache(2, pos0 + steps)
    cj = {"layers": {n: full["layers"][n].at[..., :pos0, :].set(
        cj["layers"][n]) for n in ("k", "v")}}
    tfull = tm.init_cache(2, pos0 + steps, CPU)
    for n, t in cache_state(ct).items():
        fit_into(cache_state(tfull)[n], t)
    ct = tfull
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    for i in range(steps):
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(pos0 + i),
                                backend=jax_backend)
        lt, ct = tm.decode_step(tp, ct, tt[:, None], pos0 + i,
                                backend=backend)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)
        assert np.array_equal(np.asarray(tj), tt.numpy()), i


def test_seq_starts_and_block_tables_raise(models):
    _, _, tm, tp = models
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "image_embeds": torch.zeros((1, N_IMG, D))}
    st = torch.zeros((1,), dtype=torch.int64)
    with pytest.raises(ValueError, match="seq_starts"):
        tm.prefill(tp, batch, seq_starts=st)
    cache = tm.init_cache(1, 24, CPU)
    with pytest.raises(ValueError, match="seq_starts"):
        tm.decode_step(tp, cache, batch["tokens"][:, :1], 16, seq_starts=st)
    with pytest.raises(ValueError, match="block_tables"):
        tm.decode_step(tp, cache, batch["tokens"][:, :1], st,
                       block_tables=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        tm.init_paged_cache(4, 4, CPU)
    with pytest.raises(ValueError, match="seq_starts"):
        ServeSession(tm, tp).run_batch(
            {k: v.numpy() for k, v in batch.items()}, max_new_tokens=2,
            seq_starts=st.numpy())


def _stream():
    """Six requests, prompts 4-20 tokens; every other one with its own
    image, the rest none (zero-filled, as in JAX)."""
    rng = np.random.default_rng(3)
    lens = [4, 20, 9, 6, 15, 11]
    reqs = []
    for i, n in enumerate(lens):
        extras = ({"image_embeds": _img(1, 10 + i)[0]} if i % 2 == 0
                  else None)
        reqs.append((rng.integers(1, 256, n).astype(np.int32),
                     4 + (3 * i) % 7, extras))
    return reqs


def _drain(session, reqs):
    for i, (p, b, extras) in enumerate(reqs):
        session.submit(p, b, request_id=f"r{i}", extras=extras)
    return [(r.request_id, r.tokens.tolist(), r.bucket.batch,
             r.bucket.prompt_len, r.bucket.total_len, r.state)
            for r in session.drain()]


def test_drain_with_extras_matches_jax_session(models):
    jm, jp, tm, tp = models
    reqs = _stream()
    js = JaxSession(jm, jp, backend="reference", batch_sizes=(1, 2, 4))
    want = _drain(js, reqs)
    s = ServeSession(tm, tp, batch_sizes=(1, 2, 4))
    got = _drain(s, reqs)
    assert got == want
    assert s.stats.steps == 0
    assert ([(k.role, k.batch, k.length, k.detail)
             for k in s.exec_cache.compiled_log]
            == [(k.role, k.batch, k.length, k.detail)
                for k in js.exec_cache.compiled_log])
    # the cache holds the image tokens: the per-bucket totals are JAX's
    assert (sorted((b.batch, b.prompt_len, b.total_len)
                   for b in s.stats.per_bucket)
            == sorted((b.batch, b.prompt_len, b.total_len)
                      for b in js.stats.per_bucket))


def test_image_changes_the_tokens(models):
    """The image reaches the decoder: another image, other tokens."""
    _, _, tm, tp = models
    toks = np.random.RandomState(4).randint(1, 256, (2, 8)).astype(np.int32)
    a, _ = generate(tm, tp, {"tokens": toks, "image_embeds": _img(2, 5)},
                    max_new_tokens=8, backend="plain")
    b, _ = generate(tm, tp, {"tokens": toks, "image_embeds": _img(2, 6)},
                    max_new_tokens=8, backend="plain")
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_run_batch_and_generate_match_jax(models, backend):
    jm, jp, tm, tp = models
    toks = np.random.RandomState(7).randint(1, 256, (3, 10)).astype(
        np.int32)
    batch = {"tokens": toks, "image_embeds": _img(3, 7)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js = JaxSession(jm, jp, backend="reference")
    want, _ = js.run_batch(jbatch, max_new_tokens=9, total_len=24)
    s = ServeSession(tm, tp, backend=backend)
    got, _ = s.run_batch(batch, max_new_tokens=9, total_len=24)
    assert np.array_equal(got, np.asarray(want))
    # the decode key's capacity counts the image tokens, as JAX's
    assert ([k.length for k in s.exec_cache.compiled_log]
            == [k.length for k in js.exec_cache.compiled_log]
            == [10, 24 + N_IMG])
    jg, _ = jax_generate(jm, jp, jbatch, max_new_tokens=9)
    tg, _ = generate(tm, tp, batch, max_new_tokens=9, backend=backend)
    assert np.array_equal(tg, np.asarray(jg))
