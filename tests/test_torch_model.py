"""The port's dense model against the JAX package on
``phi3-mini-3.8b-smoke`` with the same weights (the JAX init, converted
through :func:`repro_torch.bridge.params_from_numpy`).

Tolerances: logits atol 1e-4, rtol 1e-4 (float32 smoke model; two
layers of float32 GEMMs summed in another order differ by ~1e-6, so
1e-4 leaves room without hiding a wrong mask or rope); greedy tokens must
be identical.  Left-padded logits are compared at real positions only:
pad queries are fully masked and garbage by construction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ARCH = "phi3-mini-3.8b-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(jax_get_config(ARCH))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(ARCH)), tp


def _batch(seed=0, b=3, s=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, 256, size=(b, s)).astype(np.int32)
    starts = np.array([0, 5, 11][:b], np.int32)
    for i, st in enumerate(starts):
        toks[i, :st] = 0
    return toks, starts


def test_config_copy_matches_jax():
    for name in ("phi3-mini-3.8b", ARCH):
        assert get_config(name).__dict__ == jax_get_config(name).__dict__


def test_init_paths_and_shapes_match_jax(models):
    jm, jp, tm, _ = models
    ours = tm.init(seed=0, device="cpu")
    flat_j = {"/".join(str(k.key) for k in path): leaf for path, leaf in
              jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict)
                       else {pre + k: v})
        return out

    flat_t = flat(ours)
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        # same std rule: compare empirical stds of the normal leaves
        sj = float(np.std(np.asarray(flat_j[k])))
        assert abs(float(v.std()) - sj) <= 0.1 * sj + 1e-12, k


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
def test_left_padded_prefill_logits_match_jax(models, backend,
                                              jax_backend):
    jm, jp, tm, tp = models
    toks, starts = _batch()
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        backend=jax_backend,
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend=backend,
                        seq_starts=torch.from_numpy(starts))
    lj, lt = np.asarray(lj), lt.numpy()
    for i, st in enumerate(starts):
        np.testing.assert_allclose(lt[i, st:], lj[i, st:], **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                ct["layers"][name].numpy()[:, i, :, st:],
                np.asarray(cj["layers"][name])[:, i, :, st:], **TOL)


def _grow(full, pre, s):
    out = {"layers": {}}
    for name in ("k", "v"):
        buf = full["layers"][name]
        if isinstance(buf, torch.Tensor):
            buf[..., :s, :].copy_(pre["layers"][name])
        else:
            buf = buf.at[..., :s, :].set(pre["layers"][name])
        out["layers"][name] = buf
    return out


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_contiguous_decode_steps_match_jax(models, backend):
    jm, jp, tm, tp = models
    toks, starts = _batch(seed=1)
    b, s = toks.shape
    total = s + 4
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend=backend,
                        seq_starts=torch.from_numpy(starts))
    cj = _grow(jm.init_cache(b, total), cj, s)
    ct = _grow(tm.init_cache(b, total, torch.device("cpu")), ct, s)
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    for i in range(3):
        assert tt.tolist() == np.asarray(tj).tolist()
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(s + i),
                                seq_starts=jnp.asarray(starts))
        lt, ct = tm.decode_step(tp, ct, tt[:, None], s + i,
                                backend=backend,
                                seq_starts=torch.from_numpy(starts))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_paged_decode_steps_match_jax(models, backend):
    """Rows at different depths over shuffled pool blocks, with an idle
    row on the sink block 0."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.RandomState(3)
    nb, bs, mb, b = 10, 4, 3, 3
    shape = (cfg.n_layers, nb, cfg.n_kv_heads, bs, cfg.resolved_head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    tables[0] = [7, 2, 9]
    tables[1, :2] = [4, 1]
    pos = np.array([9, 5, 0], np.int32)
    toks = np.array([[3], [17], [0]], np.int32)
    cj = {"layers": {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}}
    ct = {"layers": {"k": torch.from_numpy(pk.copy()),
                     "v": torch.from_numpy(pv.copy())}}
    for step in range(3):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks),
                                jnp.asarray(pos),
                                block_tables=jnp.asarray(tables))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(toks),
                                torch.from_numpy(pos), backend=backend,
                                block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   **TOL)
        for name in ("k", "v"):
            # live blocks agree (the sink block 0 is garbage by design)
            np.testing.assert_allclose(
                ct["layers"][name].numpy()[:, 1:],
                np.asarray(cj["layers"][name])[:, 1:], **TOL)
        toks = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(
            np.int32)
        pos = pos + np.array([1, 1, 0], np.int32)


def test_greedy_tokens_identical_to_jax(models):
    jm, jp, tm, tp = models
    toks, starts = _batch(seed=2, b=2, s=8)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend="cuda",
                        seq_starts=torch.from_numpy(starts))
    cj = _grow(jm.init_cache(2, 20), cj, 8)
    ct = _grow(tm.init_cache(2, 20, torch.device("cpu")), ct, 8)
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    out_j, out_t = [np.asarray(tj)], [tt.numpy()]
    for i in range(11):
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(8 + i),
                                seq_starts=jnp.asarray(starts))
        lt, ct = tm.decode_step(tp, ct, tt[:, None], 8 + i,
                                backend="cuda",
                                seq_starts=torch.from_numpy(starts))
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)
        out_j.append(np.asarray(tj))
        out_t.append(tt.numpy())
    assert np.array_equal(np.stack(out_t), np.stack(out_j))


@pytest.mark.parametrize("family", ["hybrid"])
def test_non_dense_families_raise(family):
    """Families the port does not serve yet raise (dense, moe and ssm
    are served; ssm is tested in test_torch_ssm.py, moe below)."""
    import dataclasses
    cfg = dataclasses.replace(get_config(ARCH), family=family)
    with pytest.raises(NotImplementedError):
        build_model(cfg).init(seed=0, device="cpu")
    with pytest.raises(NotImplementedError):
        cfg.param_count()


# ------------------------------------------- the rest of the dense family,
# and moe: logits against backend="xla" to 1e-4 (float32 smoke), greedy
# tokens exact, through the bridged JAX init

NEW_ARCHS = ["qwen3-32b-smoke", "minitron-4b-smoke", "nemotron-4-15b-smoke",
             "qwen2-moe-a2.7b-smoke", "llama4-scout-17b-a16e-smoke"]


@pytest.fixture(scope="module")
def new_models():
    out = {}
    for arch in NEW_ARCHS:
        jm = jax_build_model(jax_get_config(arch))
        jp, _ = jm.init(jax.random.key(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        out[arch] = (jm, jp, build_model(get_config(arch)), tp)
    return out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_config_copies_match_jax(arch):
    full = arch[:-len("-smoke")]
    for name in (full, arch):
        assert get_config(name).__dict__ == jax_get_config(name).__dict__
        assert (get_config(name).param_count()
                == jax_get_config(name).param_count())


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_init_paths_and_shapes_match_jax(new_models, arch):
    jm, jp, tm, _ = new_models[arch]
    ours = tm.init(seed=0, device="cpu")
    flat_j = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf
              in jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(d, pre=""):
        out = {}
        for k, v in d.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict)
                       else {pre + k: tuple(v.shape)})
        return out

    assert flat(ours) == flat_j


@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_logits_and_tokens_match_jax(new_models, arch, backend):
    """Left-padded prefill logits at the real positions (a moe layer
    routes the pad positions too, so they must match as well for the
    real ones to), then contiguous decode steps' logits and greedy
    tokens."""
    jm, jp, tm, tp = new_models[arch]
    toks, starts = _batch(seed=4)
    b, s = toks.shape
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, backend="xla",
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend=backend,
                        seq_starts=torch.from_numpy(starts))
    for i, st in enumerate(starts):
        np.testing.assert_allclose(lt.numpy()[i, st:],
                                   np.asarray(lj)[i, st:], **TOL)
    total = s + 6
    cj = _grow(jm.init_cache(b, total), cj, s)
    ct = _grow(tm.init_cache(b, total, torch.device("cpu")), ct, s)
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    for i in range(5):
        assert tt.tolist() == np.asarray(tj).tolist()
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(s + i),
                                seq_starts=jnp.asarray(starts))
        lt, ct = tm.decode_step(tp, ct, tt[:, None], s + i,
                                backend=backend,
                                seq_starts=torch.from_numpy(starts))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
@pytest.mark.parametrize("arch", ["minitron-4b-smoke",
                                  "qwen2-moe-a2.7b-smoke"])
def test_new_arch_paged_decode_matches_jax(new_models, arch, backend):
    """The engine's paged step, idle row on the sink block included (a
    moe step routes it, as the JAX step does)."""
    jm, jp, tm, tp = new_models[arch]
    cfg = tm.cfg
    rng = np.random.RandomState(5)
    nb, bs, mb, b = 10, 4, 3, 3
    shape = (cfg.n_layers, nb, cfg.n_kv_heads, bs, cfg.resolved_head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    tables = np.zeros((b, mb), np.int32)
    tables[0] = [7, 2, 9]
    tables[1, :2] = [4, 1]
    pos = np.array([9, 5, 0], np.int32)
    toks = np.array([[3], [17], [0]], np.int32)
    cj = {"layers": {"k": jnp.asarray(pk), "v": jnp.asarray(pv)}}
    ct = {"layers": {"k": torch.from_numpy(pk.copy()),
                     "v": torch.from_numpy(pv.copy())}}
    for _ in range(3):
        lj, cj = jm.decode_step(jp, cj, jnp.asarray(toks), jnp.asarray(pos),
                                block_tables=jnp.asarray(tables))
        lt, ct = tm.decode_step(tp, ct, torch.from_numpy(toks),
                                torch.from_numpy(pos), backend=backend,
                                block_tables=torch.from_numpy(tables))
        np.testing.assert_allclose(lt.numpy()[:2], np.asarray(lj)[:2],
                                   **TOL)
        assert (np.argmax(lt.numpy()[:2, -1], -1).tolist()
                == np.argmax(np.asarray(lj)[:2, -1], -1).tolist())
        toks = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(
            np.int32)
        pos = pos + np.array([1, 1, 0], np.int32)


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp_kinds_match_jax(kind):
    """Each MLP flavour against the JAX ``mlp`` (gelu is the tanh
    approximation, ``jax.nn.gelu``'s default), float32 to 1e-5, and
    bf16 to 2 bf16 ulps of the JAX value; relu2 and gelu have no
    ``w3``."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    rng = np.random.RandomState(6)
    d, f = 32, 48
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"w1": rng.standard_normal((d, f)).astype(np.float32) / 6,
         "w2": rng.standard_normal((f, d)).astype(np.float32) / 7}
    if kind == "swiglu":
        p["w3"] = rng.standard_normal((d, f)).astype(np.float32) / 6
    want = np.asarray(jlayers.mlp(jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in p.items()},
                                  kind))
    got = tlayers.mlp(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in p.items()}, kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    wb = np.asarray(jlayers.mlp(
        jnp.asarray(x, jnp.bfloat16),
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
        kind)).astype(np.float32)
    gb = tlayers.mlp(torch.from_numpy(x).bfloat16(),
                     {k: torch.from_numpy(v).bfloat16()
                      for k, v in p.items()}, kind).float().numpy()
    ulp = np.abs(wb) * 2.0 ** -7
    assert np.all(np.abs(gb - wb) <= 2 * ulp + 1e-5)
    with pytest.raises(ValueError, match="mlp kind"):
        tlayers.mlp(torch.from_numpy(x), p, "swish")


def _recorded_draws(monkeypatch, arch):
    """The element counts :meth:`ParamInit.normal` draws for ``arch``
    at full size, without allocating them."""
    from repro_torch.models import layers as tlayers
    from repro_torch.models import transformer as ttransformer
    sizes = []

    class Recorder(tlayers.ParamInit):
        def normal(self, path, shape, fan_in=None, scale=1.0):
            sizes.append(int(np.prod(shape)))

        def zeros(self, path, shape):
            pass

        ones = zeros

        def const(self, path, value):
            pass

    monkeypatch.setattr(ttransformer, "ParamInit", Recorder)
    ttransformer.init_params(get_config(arch), 0, torch.device("cpu"))
    return sizes


def test_param_init_draws_large_tensors_a_layer_at_a_time(monkeypatch):
    """Above ``WHOLE_DRAW_LIMIT`` elements a tensor is drawn one slice
    of its layer axis at a time (other values, the same std rule);
    at or below it the draw is the whole tensor's, so the weights of
    phi3-mini-3.8b and falcon-mamba-7b stay as they were, and qwen3-32b's
    MLP matrices are sliced."""
    from repro_torch.models import layers as tlayers
    limit = tlayers.WHOLE_DRAW_LIMIT
    for arch in ("phi3-mini-3.8b", "falcon-mamba-7b"):
        assert max(_recorded_draws(monkeypatch, arch)) <= limit
    sizes = _recorded_draws(monkeypatch, "qwen3-32b")
    assert sum(n > limit for n in sizes) == 3       # w1, w3, w2
    monkeypatch.undo()

    monkeypatch.setattr(tlayers, "WHOLE_DRAW_LIMIT", 60)
    b = tlayers.ParamInit(3, torch.bfloat16, torch.device("cpu"))
    b.normal("small", [3, 4, 5], fan_in=4)          # 60: whole
    b.normal("big", [3, 4, 6], fan_in=4)            # 72: a layer at a time
    g = torch.Generator().manual_seed(3)
    small = torch.randn((3, 4, 5), generator=g).mul_(0.5).bfloat16()
    big = torch.stack([torch.randn((4, 6), generator=g).mul_(0.5)
                       for _ in range(3)]).bfloat16()
    assert torch.equal(b.params["small"], small)
    assert torch.equal(b.params["big"], big)
    assert b.params["big"].dtype == torch.bfloat16
