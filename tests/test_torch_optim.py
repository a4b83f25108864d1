"""The port's optimizer, schedules, gradient compression and data
pipeline against the JAX package (``repro.optim``, ``repro.data``) on
the same numpy inputs.

Tolerances: the schedules to rtol 1e-6 (XLA's and torch's ``cos`` may
round the last bit apart, and ``1 + cos`` near the end of the decay
cancels, which scales that bit up to a few ulps of the result); one ``adamw.apply`` on
identical params, grads and state: float32 params, ``m`` and ``v`` to
rtol 1e-6 (the global norm's sum is taken in another order, so the clip
scale may differ in its last bit; ``pow`` of the bias corrections may
too), bf16 params to 2 bf16 ulps; ``grad_norm`` rtol 1e-6; the int8
quantisation exactly (values) and the scales to rtol 1e-7 (the max is
exact, one division); the pipeline's batches exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy,  # noqa: E402
                                params_from_numpy)
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

F32_RTOL = 1e-6
BF16_ULPS = 2


def bf16_ulps_apart(a, b):
    """Ulps between two bf16 arrays (numpy int16 bit views), elementwise,
    on a monotonic map of the bit patterns."""
    def mono(bits):
        u = bits.astype(np.int32) & 0xFFFF
        return np.where(u & 0x8000, -(u & 0x7FFF), u)
    return np.abs(mono(a) - mono(b))


def _bits(x):
    """int16 bits of a bf16 jax array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 20), (10, 100)])
def test_warmup_cosine_matches_jax(warmup, total):
    for step in range(0, total + 5):
        want = np.asarray(jsched.warmup_cosine(
            jnp.int32(step), peak_lr=3e-4, warmup_steps=warmup,
            total_steps=total))
        got = tsched.warmup_cosine(
            torch.tensor(step, dtype=torch.int32), peak_lr=3e-4,
            warmup_steps=warmup, total_steps=total)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_constant_matches_jax():
    got = tsched.constant(torch.tensor(5, dtype=torch.int32), peak_lr=1e-3)
    want = np.asarray(jsched.constant(jnp.int32(5), peak_lr=1e-3))
    assert got.dtype == torch.float32 and got.numpy() == want


# ---------------------------------------------------------------- adamw

def _tree(rng, dtype):
    """A small parameter-like tree of numpy arrays."""
    return {"emb": rng.standard_normal((64, 16)).astype(dtype),
            "layers": {"w": rng.standard_normal((3, 16, 24)).astype(dtype),
                       "ln": rng.standard_normal((3, 16)).astype(dtype)},
            "head": rng.standard_normal((16, 64)).astype(dtype)}


def _state(rng, like, step):
    """A non-trivial AdamW state beside ``like`` (v positive)."""
    m = jax.tree.map(lambda p: (0.01 * rng.standard_normal(p.shape))
                     .astype(np.float32), like)
    v = jax.tree.map(lambda p: (1e-4 * rng.random(p.shape))
                     .astype(np.float32), like)
    return jadamw.AdamWState(step=np.int32(step), m=m, v=v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 1e6], ids=["clipped", "unclipped"])
def test_apply_matches_jax(dtype, clip):
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p_np = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)),
                        _tree(rng, np.float32))
    g_np = jax.tree.map(lambda a: np.asarray(jnp.asarray(0.3 * a, jdt)),
                        _tree(rng, np.float32))
    st = _state(rng, p_np, step=3)
    cfg = jadamw.AdamWConfig(lr=2e-3, clip_norm=clip)
    lr = np.float32(1.5e-3)
    jp, jst, jm = jadamw.apply(cfg, jax.tree.map(jnp.asarray, p_np),
                               jax.tree.map(jnp.asarray, g_np),
                               jax.tree.map(jnp.asarray, st), jnp.asarray(lr))
    tp = params_from_numpy(p_np, device="cpu")
    tg = params_from_numpy(g_np, device="cpu")
    tst = opt_state_from_numpy(st, device="cpu")
    tcfg = tadamw.AdamWConfig(lr=2e-3, clip_norm=clip)
    tp2, tst2, tm = tadamw.apply(tcfg, tp, tg, tst, torch.tensor(lr))
    assert int(tst2.step) == int(jst.step) == 4
    assert tst2.step.dtype == torch.int32
    np.testing.assert_allclose(tm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), rtol=F32_RTOL)
    if clip < 1:
        assert float(tm["grad_norm"]) > clip       # the clip was on
    for a, b in zip(leaves(tst2.m) + leaves(tst2.v),
                    jax.tree.leaves(jst.m) + jax.tree.leaves(jst.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_RTOL,
                                   atol=1e-12)
    for a, b in zip(leaves(tp2), jax.tree.leaves(jp)):
        if dtype == "bfloat16":
            assert a.dtype == torch.bfloat16
            assert bf16_ulps_apart(_bits(a), _bits(b)).max() <= BF16_ULPS
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=F32_RTOL, atol=1e-9)


def test_apply_updates_in_place_a_chunk_at_a_time(monkeypatch):
    """A leaf larger than CHUNK is updated chunk by chunk to the same
    numbers (the update is elementwise), in place."""
    rng = np.random.default_rng(1)
    p_np = {"w": rng.standard_normal((5, 7)).astype(np.float32)}
    g_np = {"w": rng.standard_normal((5, 7)).astype(np.float32)}
    outs = []
    for chunk in (tadamw.CHUNK, 4):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        tp = params_from_numpy(p_np, device="cpu")
        ptr = tp["w"].data_ptr()
        st = tadamw.init(tp)
        tp2, st2, m = tadamw.apply(tadamw.AdamWConfig(), tp,
                                   params_from_numpy(g_np, device="cpu"), st)
        assert tp2["w"].data_ptr() == ptr
        outs.append((tp2["w"].clone(), st2.m["w"].clone(),
                     st2.v["w"].clone(), m["grad_norm"]))
    for x, y in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(x, y)
    np.testing.assert_allclose(outs[0][3].numpy(), outs[1][3].numpy(),
                               rtol=F32_RTOL)


def test_init_and_global_norm_match_jax():
    rng = np.random.default_rng(2)
    p_np = _tree(rng, np.float32)
    st = tadamw.init(params_from_numpy(p_np, device="cpu"))
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert all(t.dtype == torch.float32 and not t.any()
               for t in leaves(st.m) + leaves(st.v))
    want = np.asarray(jadamw.global_norm(jax.tree.map(jnp.asarray, p_np)))
    got = tadamw.global_norm(params_from_numpy(p_np, device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL)


# ------------------------------------------------------- grad compression

@pytest.mark.parametrize("seed", range(4))
def test_quantize_matches_jax(seed):
    g = np.random.default_rng(seed).normal(size=(257,)).astype(np.float32)
    jq, js = jgc.quantize(jnp.asarray(g))
    tq, ts = tgc.quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    back = tgc.dequantize(tq, ts)
    assert float((back - torch.from_numpy(g)).abs().max()) <= \
        float(ts) * 0.5 + 1e-7


def test_compress_tree_error_feedback_matches_jax():
    """50 rounds of error feedback (the JAX substrate test's loop) on both
    packages: the same int8 payloads each round, and the feedback beats
    plain quantisation on the accumulated sum."""
    rng = np.random.default_rng(0)
    g = {"a": (rng.normal(size=(256,)) * 1e-3).astype(np.float32),
         "b": {"c": (rng.normal(size=(8, 4)) * 1e-2).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, g)
    tg = params_from_numpy(g, device="cpu")
    jerr = terr = None
    total_ef = {k: 0 for k in ("a", "c")}
    total_plain = {k: 0 for k in ("a", "c")}
    for _ in range(50):
        jq, js, jerr = jgc.compress_tree(jg, jerr)
        tq, ts, terr = tgc.compress_tree(tg, terr)
        for a, b in zip(leaves(tq), jax.tree.leaves(jq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(leaves(terr), jax.tree.leaves(jerr)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
        back = tgc.decompress_tree(tq, ts)
        q2, s2, _ = tgc.compress_tree(tg, None)
        plain = tgc.decompress_tree(q2, s2)
        total_ef = {"a": total_ef["a"] + back["a"],
                    "c": total_ef["c"] + back["b"]["c"]}
        total_plain = {"a": total_plain["a"] + plain["a"],
                       "c": total_plain["c"] + plain["b"]["c"]}
    for k, true in (("a", tg["a"] * 50), ("c", tg["b"]["c"] * 50)):
        assert float((total_ef[k] - true).abs().mean()) <= \
            float((total_plain[k] - true).abs().mean()) + 1e-9


# ------------------------------------------------------------- pipeline

@pytest.mark.parametrize("step", [0, 1, 7, 123])
def test_global_batch_equals_jax(step):
    extra = {"image_embeds": ((3, 5), np.float32)}
    jcfg = jpipe.DataConfig(vocab_size=1000, seq_len=12, global_batch=8,
                            seed=3, extra=extra)
    tcfg = tpipe.DataConfig(vocab_size=1000, seq_len=12, global_batch=8,
                            seed=3, extra=extra)
    want = jpipe.global_batch(jcfg, step)
    got = tpipe.global_batch(tcfg, step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for n in (1, 2, 4, 8):
        for s in range(n):
            a = tpipe.shard_batch(got, s, n)
            b = jpipe.shard_batch(want, s, n)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        tpipe.shard_batch(got, 0, 3)


def test_pipeline_resume_equals_jax():
    """A pipeline restored at step 3 yields what both packages' fresh
    pipelines yield at steps 3, 4, 5."""
    tcfg = tpipe.DataConfig(vocab_size=50, seq_len=4, global_batch=2)
    jcfg = jpipe.DataConfig(vocab_size=50, seq_len=4, global_batch=2)
    p = tpipe.DataPipeline(tcfg, state=tpipe.PipelineState.from_dict(
        {"step": 3}), prefetch=2)
    try:
        got = [p.next() for _ in range(3)]
        assert p.state.to_dict() == {"step": 6}
    finally:
        p.close()
    assert not p._thread.is_alive()
    jp = jpipe.DataPipeline(jcfg, prefetch=2)
    try:
        want = [jp.next() for _ in range(6)][3:]
    finally:
        jp.close()
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
