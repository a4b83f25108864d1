"""The port's audio family (whisper: an encoder-decoder with
cross-attention, ``models/encdec.py``) against the JAX package on the
CPU, with the same weights (the JAX init, bridged) and inputs from
numpy seeds.

Tolerances: float32 atol/rtol 1e-4 for logits and the encoder output
(as tests/test_torch_model.py), 1e-5 for the attention pieces; greedy
tokens exact.  With ``backend="cuda"`` the encoder runs the flash
kernel non-causal (its plain version on the CPU) against JAX's Pallas
kernel in interpret mode; the cross-attention is the plain path in both
packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.layers import sinusoidal_positions as jsin  # noqa: E402
from repro.runtime.serve_loop import generate as jax_generate  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models.layers import sinusoidal_positions  # noqa: E402
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

ARCH = "whisper-large-v3-smoke"
TOL = dict(rtol=1e-4, atol=1e-4)
FINE = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
S_ENC, D = 24, 64               # the smoke config's frames


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(jax_get_config(ARCH))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(ARCH)), tp


def _frames(b, seed):
    return np.random.RandomState(seed).randn(b, S_ENC, D).astype(np.float32)


@pytest.mark.parametrize("name", ["whisper-large-v3", ARCH])
def test_config_copy_matches_jax(name):
    mine, theirs = get_config(name), jax_get_config(name)
    assert mine.__dict__ == theirs.__dict__
    assert mine.param_count() == theirs.param_count()


def test_init_paths_and_shapes_match_jax(models):
    _, jp, tm, _ = models
    theirs = {"/".join(str(k.key) for k in path): leaf for path, leaf
              in jax.tree_util.tree_flatten_with_path(jp)[0]}
    mine = _flat(tm.init(seed=0, device="cpu"))
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        assert tuple(v.shape) == theirs[k].shape, k
        sj = float(np.std(np.asarray(theirs[k])))
        assert abs(float(v.std()) - sj) <= 0.1 * sj + 1e-12, k


@pytest.mark.parametrize("seq,d", [(24, 64), (1500, 1280), (7, 16)])
def test_sinusoidal_positions_match_jax(seq, d):
    """Angles up to ``seq`` radians in float32: one ulp of the largest
    (``10000 ** x`` rounded another way) moves a sine by up to that ulp,
    1.2e-4 at whisper's 1500 frames."""
    ulp = 2.0 ** (np.floor(np.log2(seq)) - 23)
    np.testing.assert_allclose(sinusoidal_positions(seq, d).numpy(),
                               np.asarray(jsin(seq, d)), rtol=0,
                               atol=max(2e-5, 2 * ulp))


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
@pytest.mark.parametrize("s", [24, 13])
def test_non_causal_attention_matches_jax(backend, jax_backend, s):
    rng = np.random.RandomState(s)
    q, k, v = (rng.randn(2, 4, s, 16).astype(np.float32) for _ in range(3))
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=False, backend=jax_backend)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=False,
                          backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FINE)


@pytest.mark.parametrize("s_q", [1, 9])
def test_cross_attention_matches_jax(s_q):
    """The decoder's queries over a longer memory of encoder keys."""
    rng = np.random.RandomState(s_q)
    q = rng.randn(2, 4, s_q, 16).astype(np.float32)
    k, v = (rng.randn(2, 4, S_ENC, 16).astype(np.float32) for _ in range(2))
    want = jattn.cross_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    got = tattn.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FINE)


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
def test_encode_matches_jax(models, backend, jax_backend):
    _, jp, tm, tp = models
    fr = _frames(2, 0)
    want = jencdec.encode(jp, jax_get_config(ARCH), jnp.asarray(fr),
                          backend=jax_backend)
    got = encdec.encode(tp, tm.cfg, torch.from_numpy(fr), backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend,jax_backend", [("plain", "xla"),
                                                 ("cuda", "xla"),
                                                 ("cuda", "pallas")])
def test_prefill_and_decode_logits_match_jax(models, backend, jax_backend):
    """A prompt of 10 tokens over 24 frames, then 12 decode steps in a
    self cache of 22 positions; the cross cache keeps the encoder's
    K/V."""
    jm, jp, tm, tp = models
    toks = np.random.RandomState(1).randint(1, 256, (2, 10)).astype(
        np.int32)
    fr = _frames(2, 1)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "frames": jnp.asarray(fr)},
                        backend=jax_backend)
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "frames": torch.from_numpy(fr)},
                        backend=backend)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for part in ("self", "cross"):
        for n in ("k", "v"):
            np.testing.assert_allclose(ct[part][n].numpy(),
                                       np.asarray(cj[part][n]), **TOL)
    steps = 12
    full = jm.init_cache(2, 10 + steps)

    def fit(dst, src):
        if dst.shape == src.shape:
            return src
        return dst.at[tuple(slice(0, n) for n in src.shape)].set(src)

    cj = jax.tree.map(fit, full, cj)
    tfull = tm.init_cache(2, 10 + steps, CPU)
    assert ({k: tuple(v.shape) for k, v in cache_state(tfull).items()}
            == {f"{a}/{b}": full[a][b].shape for a in full
                for b in full[a]})
    for n, t in cache_state(ct).items():
        fit_into(cache_state(tfull)[n], t)
    ct = tfull
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    for i in range(steps):
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(10 + i),
                                backend=jax_backend)
        lt, ct = tm.decode_step(tp, ct, tt[:, None], torch.tensor(10 + i),
                                backend=backend)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)
        assert np.array_equal(np.asarray(tj), tt.numpy()), i


def test_seq_starts_and_block_tables_raise(models):
    _, _, tm, tp = models
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "frames": torch.zeros((1, S_ENC, D))}
    st = torch.zeros((1,), dtype=torch.int64)
    msg = "seq_starts/block_tables"
    with pytest.raises(ValueError, match=msg):
        tm.prefill(tp, batch, seq_starts=st)
    with pytest.raises(ValueError, match=msg):
        tm.forward(tp, batch, seq_starts=st)
    cache = tm.init_cache(1, 12, CPU)
    with pytest.raises(ValueError, match=msg):
        tm.decode_step(tp, cache, batch["tokens"][:, :1], 8, seq_starts=st)
    with pytest.raises(ValueError, match=msg):
        tm.decode_step(tp, cache, batch["tokens"][:, :1], st,
                       block_tables=torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="seq_starts"):
        ServeSession(tm, tp).run_batch(
            {k: v.numpy() for k, v in batch.items()}, max_new_tokens=2,
            seq_starts=st.numpy())


def test_prefill_takes_no_schedules(models):
    """As in JAX, the audio prefill launches at the kernels' defaults: a
    bundle passed to it changes nothing."""
    from repro_torch.core.schedule import (FlashAttentionSchedule,
                                           ScheduleBundle)
    _, _, tm, tp = models
    batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
             "frames": torch.from_numpy(_frames(1, 2))}
    bundle = ScheduleBundle(flash_attention=FlashAttentionSchedule(128, 64))
    a, _ = tm.prefill(tp, batch, backend="cuda", schedules=bundle)
    b, _ = tm.prefill(tp, batch, backend="cuda")
    assert torch.equal(a, b)


def _stream():
    """Six requests, prompts 3-14 tokens; every other one with its own
    frames, the rest none (zero-filled, as in JAX)."""
    rng = np.random.default_rng(5)
    lens = [3, 14, 8, 5, 11, 6]
    return [(rng.integers(1, 256, n).astype(np.int32), 3 + (4 * i) % 9,
             {"frames": _frames(1, 20 + i)[0]} if i % 2 == 0 else None)
            for i, n in enumerate(lens)]


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


def test_frames_change_the_tokens(models):
    _, _, tm, tp = models
    toks = np.random.RandomState(4).randint(1, 256, (2, 8)).astype(np.int32)
    a, _ = generate(tm, tp, {"tokens": toks, "frames": _frames(2, 5)},
                    max_new_tokens=8, backend="plain")
    b, _ = generate(tm, tp, {"tokens": toks, "frames": _frames(2, 6)},
                    max_new_tokens=8, backend="plain")
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("backend", ["plain", "cuda"])
def test_run_batch_and_generate_match_jax(models, backend):
    jm, jp, tm, tp = models
    toks = np.random.RandomState(7).randint(1, 256, (3, 9)).astype(np.int32)
    batch = {"tokens": toks, "frames": _frames(3, 7)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js = JaxSession(jm, jp, backend="reference")
    want, _ = js.run_batch(jbatch, max_new_tokens=10, total_len=24)
    s = ServeSession(tm, tp, backend=backend)
    got, _ = s.run_batch(batch, max_new_tokens=10, total_len=24)
    assert np.array_equal(got, np.asarray(want))
    jg, _ = jax_generate(jm, jp, jbatch, max_new_tokens=10)
    tg, _ = generate(tm, tp, batch, max_new_tokens=10, backend=backend)
    assert np.array_equal(tg, np.asarray(jg))


def test_cli_serves_the_audio_family():
    """``launch/serve`` draws random frames for the generate path and
    serves the session through the bucketed path."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parent.parent
    env = {"PYTHONPATH": str(repo / "src"), "PATH": "/usr/bin:/bin"}
    for extra in ([], ["--session", "--num-requests", "3",
                       "--batch-sizes", "1,2"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
             "--new-tokens", "4", *extra], capture_output=True, text=True,
            env=env, timeout=300, cwd=repo)
        assert out.returncode == 0, out.stderr
        assert ("generated (2, 4)" in out.stdout if not extra
                else "session: 3 requests" in out.stdout), out.stdout
