"""The port's single-device analysis paths against the JAX package's:
attention's ``chunked`` and ``stub`` backends, the shape cells
(``SHAPES``, ``shape_applicable``) and the analytic roofline.

Tolerances: ``attention_chunked`` 5e-3 absolute against JAX's
``attention_chunked`` on the same float32 inputs: both round each
probability to bf16 for P V, and where the two float32 exps differ in
their last bit a probability can round to the neighbouring bf16 value,
2**-8 of it apart, which moves an output by up to 2**-8 x |v|; and
JAX's own 5e-3 against the reference attention;
the model's logits and loss on ``"chunked"`` 1e-4 absolute against
JAX's on the same weights; the roofline counts (active parameters,
model flops, the flash cost) with tolerance 0, for every config at
every shape; ``RooflineTerms.mfu`` is JAX's times 197e12 / 989e12 (the
v5e's bf16 peak over the H100's) to 1e-12 relative.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shape_applicable as jax_applicable  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.attention import attention as jattention  # noqa: E402
from repro.models.attention import \
    attention_chunked as jchunked  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import (SHAPES, ShapeConfig, get_config,  # noqa: E402
                                 list_archs, shape_applicable)
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import (BACKENDS, attention,  # noqa: E402
                                          attention_chunked)

CHUNK_ATOL = 5e-3
REF_TOL = 5e-3
MODEL_ATOL = 1e-4


def _qkv(seed, b, hq, hkv, s, d):
    """float32 q, k, v from a numpy generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


def _pair(q, k, v, **kw):
    """(the port's chunked attention, JAX's) on the same inputs."""
    got = attention_chunked(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = jchunked(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("cq,ckv", [(8, 8), (16, 4), (32, 32), (5, 7)])
def test_chunked_matches_reference(cq, ckv):
    q, k, v = _qkv(11, 2, 4, 2, 32, 16)
    got, want = _pair(q, k, v, chunk_q=cq, chunk_kv=ckv)
    np.testing.assert_allclose(got, want, rtol=0, atol=CHUNK_ATOL)
    ref = attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got, ref.numpy(), rtol=REF_TOL,
                               atol=REF_TOL)


@given(st.sampled_from([16, 32, 64]), st.booleans(),
       st.sampled_from([None, 8, 24]))
@settings(max_examples=12, deadline=None)
def test_chunked_property(s, causal, window):
    q, k, v = _qkv(s + 2 * causal + (window or 0), 1, 2, 2, s, 8)
    got, want = _pair(q, k, v, causal=causal, window=window, chunk_q=16,
                      chunk_kv=16)
    np.testing.assert_allclose(got, want, rtol=0, atol=CHUNK_ATOL)
    ref = np.asarray(jattention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, window=window,
                                backend="xla"))
    np.testing.assert_allclose(got, ref, rtol=REF_TOL, atol=REF_TOL)


def _bridged(arch):
    """(port model, bridged params, JAX model, JAX params)."""
    jmodel = jax_build_model(jax_get_config(arch))
    jparams, _ = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return build_model(get_config(arch)), params, jmodel, jparams


def test_chunked_backend_in_model():
    """phi3-smoke's logits on ``"chunked"``: equal to JAX's chunked
    logits, and within JAX's 5e-3 of the plain path."""
    model, params, jmodel, jparams = _bridged("phi3-mini-3.8b-smoke")
    toks = np.asarray(jax.random.randint(jax.random.key(1), (2, 16), 0,
                                         model.cfg.vocab_size))
    a, _ = model.forward(params, {"tokens": torch.from_numpy(toks)})
    b, _ = model.forward(params, {"tokens": torch.from_numpy(toks)},
                         backend="chunked")
    jb, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                           backend="chunked")
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0,
                               atol=MODEL_ATOL)
    rel = float((a - b).abs().max()) / float(a.abs().max())
    assert rel < REF_TOL


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b-smoke",
                                  "qwen2-moe-a2.7b-smoke",
                                  "falcon-mamba-7b-smoke",
                                  "recurrentgemma-9b-smoke",
                                  "whisper-large-v3-smoke"])
def test_chunked_loss_equals_jax(arch):
    """``loss_fn(backend="chunked")`` (the backend ``TrainConfig``
    passes through) equals JAX's on every family; layers without a
    chunked path run their plain path, as JAX's run ``"xla"``."""
    model, params, jmodel, jparams = _bridged(arch)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32)}
    batch["labels"] = rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(2, cfg.encoder_seq,
                                           cfg.d_model)).astype(np.float32)
    loss, _ = model.loss_fn(params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()},
                            backend="chunked")
    jloss, _ = jmodel.loss_fn(jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              backend="chunked")
    assert abs(float(loss) - float(jloss)) <= MODEL_ATOL


def test_chunked_trains_and_stub_shapes():
    """A train step runs on ``"chunked"``; ``"stub"`` gives the right
    shape and dtype (v repeated over the group) and refuses nothing;
    chunked refuses left-pad ``starts`` as JAX does."""
    import functools
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime.train_loop import make_train_step
    assert BACKENDS == ("plain", "cuda", "chunked", "stub")
    model, params, _, _ = _bridged("phi3-mini-3.8b-smoke")
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3),
                           functools.partial(constant, peak_lr=1e-3),
                           backend="chunked")
    batch = {"tokens": torch.zeros(2, 16, dtype=torch.int32),
             "labels": torch.zeros(2, 16, dtype=torch.int32)}
    _, _, m = step(params, adamw.init(params), batch)
    assert np.isfinite(float(m["loss"]))
    for dt in (torch.float32, torch.bfloat16):
        q = torch.ones(2, 4, 8, 16, dtype=dt)
        kv = torch.arange(2 * 2 * 8 * 16, dtype=dt).reshape(2, 2, 8, 16)
        out = attention(q, kv, kv, backend="stub")
        assert out.shape == q.shape and out.dtype == dt
        assert torch.equal(out, kv.repeat_interleave(2, dim=1))
        jout = jattention(jnp.asarray(q.float().numpy()),
                          jnp.asarray(kv.float().numpy()),
                          jnp.asarray(kv.float().numpy()), backend="stub")
        assert jout.shape == tuple(out.shape)
    with pytest.raises(NotImplementedError, match="starts"):
        attention(q, kv, kv, backend="chunked",
                  starts=torch.zeros(2, dtype=torch.int64))


def test_shapes_equal_jax():
    """The four shape cells and the long_500k rule are JAX's."""
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert SHAPES["train_4k"] == ShapeConfig("train_4k", 4096, 256, "train")
    assert SHAPES["decode_32k"].is_decode
    for arch in list_archs():
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jax_applicable(jax_get_config(arch), JSHAPES[name])
    assert not shape_applicable(get_config("qwen3-32b"),
                                SHAPES["long_500k"])[0]
    assert shape_applicable(get_config("falcon-mamba-7b"),
                            SHAPES["long_500k"])[0]


@pytest.mark.parametrize("arch", list_archs())
def test_roofline_counts_equal_jax(arch):
    """``active_params``, ``model_flops`` and ``flash_attention_cost``
    equal JAX's at every shape, and at the smoke config (tolerance 0)."""
    for name in (arch, arch + "-smoke"):
        cfg, jcfg = get_config(name), jax_get_config(name)
        assert roofline.active_params(cfg) == jroof.active_params(jcfg)
        for s in SHAPES:
            assert roofline.model_flops(cfg, SHAPES[s]) == \
                jroof.model_flops(jcfg, JSHAPES[s])
            assert roofline.flash_attention_cost(cfg, SHAPES[s]) == \
                jroof.flash_attention_cost(jcfg, JSHAPES[s])


def test_flash_cost_monotonic():
    dense = get_config("qwen3-32b")
    c_train = roofline.flash_attention_cost(dense, SHAPES["train_4k"])
    c_pref = roofline.flash_attention_cost(dense, SHAPES["prefill_32k"])
    assert c_train["flops"] > 0 and c_train["bytes"] > 0
    assert c_pref["flops"] > 0
    c = roofline.flash_attention_cost(get_config("falcon-mamba-7b"),
                                      SHAPES["train_4k"])
    assert c["flops"] == 0 and c["bytes"] == 0
    c = roofline.flash_attention_cost(get_config("recurrentgemma-9b"),
                                      SHAPES["prefill_32k"])
    assert c["flops"] > 0


def test_flash_cost_window_reduces_flops():
    hyb = get_config("recurrentgemma-9b")
    wide = dataclasses.replace(hyb, local_window=32768)
    narrow = dataclasses.replace(hyb, local_window=1024)
    cw = roofline.flash_attention_cost(wide, SHAPES["prefill_32k"])
    cn = roofline.flash_attention_cost(narrow, SHAPES["prefill_32k"])
    assert cn["flops"] < cw["flops"]
    jw = jroof.flash_attention_cost(dataclasses.replace(
        jax_get_config("recurrentgemma-9b"), local_window=1024),
        JSHAPES["prefill_32k"])
    assert cn == jw


def test_terms_on_h100_peaks():
    """The port's terms read the H100's peaks: on equal inputs ``mfu``
    is JAX's times 197e12 / 989e12; the other derived terms and
    ``extrapolate`` are JAX's."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    kw = dict(arch="qwen3-32b", shape="train_4k", mesh="16x16", chips=256,
              hlo_flops=3.1e18, hlo_bytes=2.2e15, collective_bytes=4.4e11,
              model_flops=2.5e18, compute_s=12.5, memory_s=10.5,
              collective_s=8.8, bytes_per_device=3.3e10)
    got, want = roofline.RooflineTerms(**kw), jroof.RooflineTerms(**kw)
    assert got.mfu == pytest.approx(want.mfu * 197e12 / 989e12, rel=1e-12)
    d, jd = got.to_dict(), want.to_dict()
    assert d.pop("mfu") and jd.pop("mfu")
    assert d == jd
    for args in ((1.0, 3.0, 2, 4, 64), (5.5, 5.5, 1, 3, 40)):
        assert roofline.extrapolate(*args) == jroof.extrapolate(*args)
