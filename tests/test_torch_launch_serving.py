"""The port's serving launchers (``repro_torch.launch.serve_lm``,
``serve_session``, ``serve_adaptive``) against the JAX package's
``examples/serve_lm.py``, ``serve_session.py`` and ``serve_adaptive.py``
on the CPU, with the same weights (the JAX init bridged in) and the same
inputs (the JAX examples' batches, or their numpy-seeded prompts).

The JAX examples' ``"reference"`` backend is the port's ``"plain"``; the
port's ``"cuda"`` (its launchers' default) runs each kernel's plain
version on the CPU.  Tokens must be equal exactly, on both; the report
fields compared are the ones the examples print: the request count,
each request's padded prompt and total length, re-AOTs and free
switches, the executable cache's counters (``serve_adaptive``) and the
dispatch report's kinds and problems; the session summary's other
fields must be there in both.  Timings are not compared, nor the rows a
session's engine takes (each package picks them with its own device's
step-time model).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.registry import TuningRegistry as JRegistry  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.runtime.dispatch import DispatchService as JDispatch  # noqa: E402
from repro.runtime.serve_loop import generate as jgenerate  # noqa: E402
from repro.serving import ServeSession as JSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve_adaptive, serve_lm, serve_session  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _jax_example_batch(cfg, batch, prompt_len):
    """The JAX examples' batch: tokens from key 1, extras from key 2."""
    out = {"tokens": jax.random.randint(jax.random.key(1),
                                        (batch, prompt_len), 0,
                                        cfg.vocab_size)}
    if cfg.family == "audio":
        out["frames"] = jax.random.normal(
            jax.random.key(2), (batch, cfg.encoder_seq, cfg.d_model),
            jnp.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = jax.random.normal(
            jax.random.key(2), (batch, cfg.num_image_tokens, cfg.d_model),
            jnp.float32)
    return out


def _bridged(arch):
    """(JAX model, JAX params, port model, bridged params)."""
    jmodel = jax_build_model(jax_get_config(arch))
    jparams, _ = jmodel.init(jax.random.key(0))
    return (jmodel, jparams, build_model(get_config(arch)),
            params_from_numpy(jax.tree.map(np.asarray, jparams),
                              device="cpu"))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b-smoke",
                                  "falcon-mamba-7b-smoke",
                                  "paligemma-3b-smoke",
                                  "whisper-large-v3-smoke"])
def test_serve_lm_tokens_equal_jax_example(arch, capsys):
    """``serve_lm.run`` on the JAX example's weights and batch (batch 4,
    prompt 16, 24 new tokens) gives its tokens on both backends and
    prints its three lines."""
    jmodel, jparams, model, params = _bridged(arch)
    jbatch = _jax_example_batch(jmodel.cfg, 4, 16)
    want, _ = jgenerate(jmodel, jparams, jbatch, max_new_tokens=24)
    batch = {k: np.asarray(v) for k, v in jbatch.items()}
    for backend in ("plain", "cuda"):
        got, stats = serve_lm.run(model, params, batch, 24, backend)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert stats.backend == backend
    out = capsys.readouterr().out
    assert f"arch={arch} generated (4, 24) tokens" in out
    assert "sample: " + str(np.asarray(want)[0][:16].tolist()) in out


def _jax_stream(arch, n_requests, params):
    """The JAX example's ``serve_stream`` on ``params`` with the
    reference backend: (results, stats dict)."""
    jmodel = jax_build_model(jax_get_config(arch))
    registry = JRegistry(None)
    session = JSession(jmodel, params, dispatch=JDispatch(registry),
                       backend="reference", registry=registry,
                       batch_sizes=(1, 2, 4), bucket_lengths=(8, 16, 32))
    for prompt, budget in serve_session.prompts(jmodel.cfg.vocab_size,
                                                n_requests):
        session.submit(prompt, max_new_tokens=budget)
    return session.drain(), session.stats.to_dict()


def _submission_order(results):
    """``{request id: its place in the stream}`` (ids are ``req-N``,
    N rising with each submission)."""
    ids = sorted((int(r.request_id.split("-")[1]), r.request_id)
                 for r in results)
    return {rid: i for i, (_, rid) in enumerate(ids)}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b-smoke",
                                  "falcon-mamba-7b-smoke"])
def test_serve_session_stream_equals_jax_example(arch, capsys):
    """The example's stream (16 requests, buckets (1, 2, 4) x (8, 16,
    32)): every request's tokens and padded lengths, and the summary's
    counts, equal to the JAX session's."""
    _, jparams, _, params = _bridged(arch)
    jres, js = _jax_stream(arch, 16, jparams)
    out = serve_session.serve_stream(arch, 16, "plain", params=params)
    res, s = out["results"], out["stats"]
    # request ids count sessions' submissions process-wide in both
    # packages: match requests by their place in this stream
    nth, jnth = _submission_order(res), _submission_order(jres)
    assert {nth[r.request_id]: list(r.tokens) for r in res} == {
        jnth[r.request_id]: list(np.asarray(r.tokens)) for r in jres}
    # the padded prompt and total lengths are the queue's; the rows a
    # bucket takes come from each package's step-time model (the H100's
    # here, the TPU's there), so they may differ
    assert {nth[r.request_id]: (r.bucket.prompt_len, r.bucket.total_len)
            for r in res} == {
        jnth[r.request_id]: (r.bucket.prompt_len, r.bucket.total_len)
        for r in jres}
    for k in ("requests", "recompiles", "free_switches"):
        assert s[k] == js[k], k
    for k in ("batches", "decode_tok_s", "cache_hit_rate", "cache",
              "queue_p50_s", "queue_p95_s", "buckets"):
        assert k in s and k in js, k
    text = capsys.readouterr().out
    assert f"== {arch} (" in text and "16 requests / " in text


def test_serve_adaptive_equals_jax_example(capsys):
    """The example's two ``generate`` calls through one session (batch
    2, prompt 16, 24 new tokens) and four dispatched matmuls: tokens of
    both calls equal to the JAX example's, the second call a pure cache
    hit, and the dispatch report's kinds and problems the same."""
    from repro.kernels.matmul import matmul_dispatched as jmatmul
    arch = "phi3-mini-3.8b-smoke"
    jmodel, jparams, model, params = _bridged(arch)
    jbatch = _jax_example_batch(jmodel.cfg, 2, 16)
    registry = JRegistry(None)
    service = JDispatch(registry)
    session = JSession(jmodel, jparams, dispatch=service,
                       backend="reference", registry=registry)
    want, _ = jgenerate(jmodel, jparams, jbatch, max_new_tokens=24,
                        session=session)
    want2, _ = jgenerate(jmodel, jparams, jbatch, max_new_tokens=24,
                         session=session)
    jcache = session.exec_cache.stats()
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(64, 32)).astype(np.float32))
    b = jnp.asarray(rng.normal(size=(32, 48)).astype(np.float32))
    for _ in range(4):
        jmatmul(a, b, service=service)
    jreport = service.report()

    got = serve_adaptive.run(model, params,
                             {k: np.asarray(v) for k, v in jbatch.items()},
                             24, backend="plain")
    np.testing.assert_array_equal(got["tokens"], np.asarray(want))
    np.testing.assert_array_equal(got["tokens_repeat"], np.asarray(want2))
    for k in ("hits", "misses", "compiles"):
        assert got["cache"][k] == jcache[k], k
    problems = lambda rep: sorted(
        (e["kind"], tuple(sorted(e["problem"].items())))
        for e in rep.values())
    assert problems(got["report"]) == problems(jreport)
    text = capsys.readouterr().out
    assert "repeat call:" in text and "per-shape dispatch report:" in text


@pytest.mark.parametrize("module,argv,marker", [
    ("serve_lm", ["--new-tokens", "4"], "generated (4, 4) tokens"),
    ("serve_session", ["--arch", "phi3-mini-3.8b-smoke",
                       "--num-requests", "4"], "4 requests / "),
    ("serve_adaptive", ["--new-tokens", "4"], "repeat call:")])
def test_serving_launchers_run_on_cpu_when_asked(module, argv, marker):
    """Each launcher's CLI with ``--device cpu`` (the default backend,
    ``cuda``, runs the kernels' plain versions there) exits 0 and prints
    its summary; without a card and without ``--device cpu`` it
    raises before any work."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", *argv,
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert marker in res.stdout


def test_serving_launchers_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (serve_lm, serve_session, serve_adaptive):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--arch", "phi3-mini-3.8b-smoke"])
