"""The port's SSM family (falcon-mamba) against the JAX package on the
CPU: the selective-scan kernel's plain version, ``mamba_block``, the
model's logits, the engine's and ``generate``'s tokens, the parameter
bridge and the CLI.

Inputs come from numpy seeds; both packages get the same weights (the
JAX init, bridged).  Backend pairs: the port's ``plain`` mirrors JAX
``xla`` (materialised scan, float32 ``y``); the port's ``cuda`` runs the
kernel wrapper, which on CPU tensors runs its plain version, and mirrors
JAX ``pallas`` (``ssm_scan_pallas`` in interpret mode, ``y`` rounded to
x's dtype).

Tolerances: float32 scan outputs and states 1e-5 absolute (the same
recurrence, float32 sums over N and over the scan taken in another
order); smoke logits 1e-4 (two float32 layers of GEMMs on top of that,
as in ``test_torch_model.py``); bf16 ``y`` two bf16 ulps of the
reference plus 1e-5 (both sides round one float32 value to bf16 once,
so they differ by at most the rounding of that step).  Tokens must be
identical; padded-vs-solo logits on the ``cuda`` path must be
bit-identical.
"""
import dataclasses
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
from repro.kernels.ssm_scan import (ssm_scan_pallas,  # noqa: E402
                                    ssm_scan_ref as jax_ssm_scan_ref)
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.runtime.serve_loop import generate as jax_generate  # noqa: E402
from repro.serving.session import ServeSession as JaxSession  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_ref  # noqa: E402
from repro_torch.models import (build_model, left_pad_prompts,  # noqa: E402
                                prompt_starts)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
ARCH = "falcon-mamba-7b-smoke"
F32_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BACKEND_PAIRS = [("plain", "xla"), ("cuda", "pallas")]


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, pre + k + "/") if isinstance(v, dict)
                   else {pre + k: v})
    return out


def _bf16_close(got, want):
    """Per element within two bf16 ulps of ``want`` plus 1e-5."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    allowed = 2 * np.exp2(np.floor(np.log2(mag)) - 7) + 1e-5
    assert (np.abs(got - want) <= allowed).all(), np.abs(got - want).max()


def _scan_inputs(seed, bt, s, di, n, dtype="float32", h0=False):
    """Realistic scan inputs as numpy: softplus'd dt, a = -(1..N)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bt, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, (bt, s, di)))).astype(
        np.float32)
    b = rng.normal(size=(bt, s, n)).astype(np.float32)
    c = rng.normal(size=(bt, s, n)).astype(np.float32)
    a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32),
                         (di, n)).copy() * rng.uniform(0.5, 1.5, (di, 1)
                                                       ).astype(np.float32)
    d = rng.normal(size=(di,)).astype(np.float32)
    hh = rng.normal(size=(bt, di, n)).astype(np.float32) if h0 else None
    return dict(x=x, dt=dt, b=b, c=c, a=a, d=d, h0=hh, dtype=dtype)


def _jax_args(inp):
    dt = jnp.bfloat16 if inp["dtype"] == "bfloat16" else jnp.float32
    return (jnp.asarray(inp["x"]).astype(dt), jnp.asarray(inp["dt"]),
            jnp.asarray(inp["b"]), jnp.asarray(inp["c"]),
            jnp.asarray(inp["a"]), jnp.asarray(inp["d"]).astype(dt))


def _torch_args(inp):
    dt = getattr(torch, inp["dtype"])
    t = {k: torch.from_numpy(v) for k, v in inp.items()
         if isinstance(v, np.ndarray)}
    # bf16 through float32: the same rounding as jnp's astype
    return (t["x"].to(dt), t["dt"], t["b"], t["c"], t["a"], t["d"].to(dt),
            t.get("h0"))


# ------------------------------------------------------------ the kernel


@pytest.mark.parametrize("h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 4, 8), (1, 12, 32, 8, 16),
                                   (3, 5, 48, 16, 16)],
                         ids=lambda s: "bt{}_s{}_di{}_n{}_bd{}".format(*s))
def test_ssm_scan_plain_matches_pallas_and_ref(shape, dtype, h0):
    bt, s, di, n, block_d = shape
    inp = _scan_inputs(sum(shape), bt, s, di, n, dtype, h0)
    y, h = ssm_scan(*_torch_args(inp))
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    assert y.shape == (bt, s, di) and h.shape == (bt, di, n)
    jh0 = None if inp["h0"] is None else jnp.asarray(inp["h0"])
    y_p, h_p = ssm_scan_pallas(*_jax_args(inp), h0=jh0, block_d=block_d,
                               interpret=True)
    refs = [y_p] + ([] if h0 else [jax_ssm_scan_ref(*_jax_args(inp))])
    for want in refs:
        if dtype == "bfloat16":
            _bf16_close(y.float().numpy(), np.asarray(want, np.float32))
        else:
            np.testing.assert_allclose(y.numpy(), np.asarray(want),
                                       **F32_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_p), **F32_TOL)


def test_ssm_scan_state_carry_two_halves_equal_the_whole():
    """The decode path is the S=1 case of this property (the JAX side's
    ``tests/test_backend_pallas.py`` state-carry test, on the port)."""
    inp = _scan_inputs(0, 2, 8, 16, 4)
    x, dt, b, c, a, d, _ = _torch_args(inp)
    y_full, h_full = ssm_scan(x, dt, b, c, a, d)
    y1, h1 = ssm_scan(x[:, :4], dt[:, :4], b[:, :4], c[:, :4], a, d)
    y2, h2 = ssm_scan(x[:, 4:], dt[:, 4:], b[:, 4:], c[:, 4:], a, d, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), **F32_TOL)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), **F32_TOL)
    _, h_p = ssm_scan_pallas(*_jax_args(inp), block_d=8, interpret=True)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(h_p), **F32_TOL)


def test_ssm_scan_masked_pads_keep_the_state_zero():
    """Steps whose x is 0 (masked pads) leave a zero state exactly 0,
    so a padded row's scan is bit-identical to the unpadded one."""
    inp = _scan_inputs(3, 1, 9, 16, 8)
    x, dt, b, c, a, d, _ = _torch_args(inp)
    x = x.clone()
    x[:, :4] = 0
    b = b.clone()
    b[:, :4] = 0
    y, h = ssm_scan_ref(x, dt, b, c, a, d)
    y_solo, h_solo = ssm_scan_ref(x[:, 4:], dt[:, 4:], b[:, 4:], c[:, 4:],
                                  a, d)
    assert torch.equal(y[:, :4], torch.zeros_like(y[:, :4]))
    assert torch.equal(y[:, 4:], y_solo) and torch.equal(h, h_solo)


# ------------------------------------------------------------ the block


@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(jax_get_config(ARCH))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(get_config(ARCH)), tp


def _layer0(tree):
    return jax.tree.map(lambda v: v[0], tree)


@pytest.mark.parametrize("case", ["prefill", "prefill_masked", "decode"])
@pytest.mark.parametrize("ours,theirs", BACKEND_PAIRS)
def test_mamba_block_matches_jax(models, ours, theirs, case):
    _, jp, _, tp = models
    cfg = get_config(ARCH)
    jl = _layer0(jp["layers"]["mamba"])
    tl = {k: v[0] for k, v in tp["layers"]["mamba"].items()}
    kw = dict(state=cfg.ssm_state, conv=cfg.ssm_conv,
              dt_rank=cfg.resolved_dt_rank)
    rng = np.random.default_rng(5)
    s = 1 if case == "decode" else 10
    x = rng.normal(size=(3, s, cfg.d_model)).astype(np.float32)
    jkw, tkw = {}, {}
    if case == "prefill_masked":
        valid = np.arange(s)[None, :] >= np.array([0, 3, 7])[:, None]
        jkw["seq_valid"] = jnp.asarray(valid)
        tkw["seq_valid"] = torch.from_numpy(valid)
    if case == "decode":
        cache = {"ssm": rng.normal(size=(3, cfg.d_inner, cfg.ssm_state)),
                 "conv": rng.normal(size=(3, cfg.ssm_conv - 1,
                                          cfg.d_inner))}
        cache = {k: v.astype(np.float32) for k, v in cache.items()}
        jkw["cache"] = {k: jnp.asarray(v) for k, v in cache.items()}
        tkw["cache"] = {k: torch.from_numpy(v) for k, v in cache.items()}
    yj, cj = jax_ssm.mamba_block(jnp.asarray(x), jl, backend=theirs, **kw,
                                 **jkw)
    yt, ct = ssm.mamba_block(torch.from_numpy(x), tl, backend=ours, **kw,
                             **tkw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)
    for k in ("ssm", "conv"):
        assert ct[k].shape == cj[k].shape and ct[k].dtype == torch.float32
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                   **F32_TOL)


def test_softplus_matches_jax_above_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0],
                 np.float32)
    np.testing.assert_array_equal(
        ssm.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))))


def test_linear_scan_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0.2, 0.9, (2, 7, 5)).astype(np.float32)
    b = rng.normal(size=(2, 7, 5)).astype(np.float32)
    h0 = rng.normal(size=(2, 5)).astype(np.float32)
    for kw_j, kw_t in (({}, {}), ({"h0": jnp.asarray(h0)},
                                  {"h0": torch.from_numpy(h0)})):
        np.testing.assert_allclose(
            ssm.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                            **kw_t).numpy(),
            np.asarray(jax_ssm.linear_scan(jnp.asarray(a), jnp.asarray(b),
                                           **kw_j)), **F32_TOL)


# ------------------------------------------------------------ the model


def _padded_batch(seed=0, b=3, s=16):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, 256, size=(b, s)).astype(np.int32)
    starts = np.array([0, 5, 11][:b], np.int32)
    for i, st in enumerate(starts):
        toks[i, :st] = 0
    return toks, starts


@pytest.mark.parametrize("ours,theirs", BACKEND_PAIRS)
def test_prefill_and_decode_logits_match_jax(models, ours, theirs):
    jm, jp, tm, tp = models
    toks, starts = _padded_batch()
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, backend=theirs,
                        seq_starts=jnp.asarray(starts))
    lt, ct = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        backend=ours, seq_starts=torch.from_numpy(starts))
    real = np.arange(toks.shape[1])[None, :] >= starts[:, None]
    np.testing.assert_allclose(lt.numpy()[real], np.asarray(lj)[real],
                               **LOGIT_TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(ct["layers"][k].numpy(),
                                   np.asarray(cj["layers"][k]), **F32_TOL)
    tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1], -1)
    for i in range(4):
        lj, cj = jm.decode_step(jp, cj, tj[:, None], jnp.int32(16 + i),
                                backend=theirs)
        lt, ct = tm.decode_step(tp, ct, tt[:, None], 16 + i, backend=ours)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        tj = jnp.argmax(lj[:, -1], -1).astype(jnp.int32)
        tt = torch.argmax(lt[:, -1], -1)
        assert np.array_equal(tt.numpy(), np.asarray(tj))


def test_padded_prefill_logits_bit_identical_to_solo_on_cuda_path(models):
    """As ``tests/test_masks.py`` holds the Pallas scan: the masked pads
    keep the state 0, so a left-padded row's last logits equal the row
    run alone, bit for bit."""
    _, _, tm, tp = models
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, size=n).astype(np.int32)
               for n in (3, 5, 8)]
    toks = torch.from_numpy(left_pad_prompts(prompts, 8))
    starts = torch.from_numpy(prompt_starts(prompts, 8))
    padded, _ = tm.prefill(tp, {"tokens": toks}, backend="cuda",
                           seq_starts=starts)
    for i, p in enumerate(prompts):
        solo, _ = tm.prefill(tp, {"tokens": torch.from_numpy(p[None])},
                             backend="cuda")
        assert torch.equal(padded[i, -1], solo[0, -1]), i


def test_ssm_rejects_paged_and_masked_decode(models):
    _, _, tm, tp = models
    cache = tm.init_cache(2, 16, torch.device("cpu"))
    assert cache["layers"]["ssm"].shape == (2, 2, 128, 8)
    assert cache["layers"]["conv"].shape == (2, 2, 3, 128)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        tm.init_paged_cache(8, 4, torch.device("cpu"))
    with pytest.raises(ValueError):
        tm.decode_step(tp, cache, tok, torch.tensor([3, 3]),
                       block_tables=torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        tm.decode_step(tp, cache, tok, 3, seq_starts=torch.tensor([0, 1]))


# ------------------------------------------------------- engine, generate


def _prompts(lengths, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=n).astype(np.int32) for n in lengths]


ENGINE_LENS, ENGINE_BUDGETS = [5, 7, 3, 6, 12], [6, 3, 8, 1, 5]


@pytest.fixture(scope="module")
def jax_engine(models):
    jm, jp, _, _ = models
    s = JaxSession(jm, jp, backend="reference")
    for i, (p, b) in enumerate(zip(_prompts(ENGINE_LENS), ENGINE_BUDGETS)):
        s.submit(p, b, request_id=f"r{i}")
    res = s.drain()
    return ({r.request_id: r.tokens.tolist() for r in res},
            [r.request_id for r in res], s.stats)


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_engine_tokens_match_jax_session(models, jax_engine, backend):
    _, _, tm, tp = models
    s = ServeSession(tm, tp, backend=backend)
    for i, (p, b) in enumerate(zip(_prompts(ENGINE_LENS), ENGINE_BUDGETS)):
        s.submit(p, b, request_id=f"r{i}")
    res = s.drain()
    j_tokens, j_order, j_stats = jax_engine
    assert {r.request_id: r.tokens.tolist() for r in res} == j_tokens
    assert [r.request_id for r in res] == j_order
    assert all(r.state == "COMPLETED" for r in res)
    for k in ("batches", "steps", "inflight_admissions"):
        assert getattr(s.stats, k) == getattr(j_stats, k), k
    assert s.stats.compactions == 0 and s.stats.rejected == 0


def test_engine_ignores_kv_pool_limits_for_ssm(models):
    """kv_blocks and the pool-size rejection apply to attention only: a
    pool of two 1-token blocks would reject every request of phi3."""
    _, _, tm, tp = models
    s = ServeSession(tm, tp, kv_block_size=1, kv_blocks=2)
    s.submit(_prompts([9])[0], 6, request_id="a")
    (r,) = s.drain()
    assert r.state == "COMPLETED" and len(r.tokens) == 6


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_generate_matches_jax_generate(models, backend):
    jm, jp, tm, tp = models
    prompts = _prompts([3, 8, 6])
    toks = left_pad_prompts(prompts, 8)
    starts = prompt_starts(prompts, 8)
    ref, _ = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)},
                          max_new_tokens=7, seq_starts=starts)
    out, stats = generate(tm, tp, {"tokens": toks}, max_new_tokens=7,
                          backend=backend, seq_starts=starts)
    assert out.shape == (3, 7) and stats.decode_tokens == 18
    assert np.array_equal(out, np.asarray(ref))


# ------------------------------------------------------- bridge, config


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_converts_the_ssm_tree(dtype):
    """Paths, shapes and dtypes of the bridged JAX tree equal the port's
    own init; ``A_log`` (log 1..N cast to the model dtype) and ``D``
    (ones) are equal in value."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    jp, _ = jax_build_model(jcfg).init(jax.random.key(0))
    ours = _flat(build_model(tcfg).init(seed=0, device="cpu"))
    theirs = _flat(params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu"))
    assert sorted(ours) == sorted(theirs)
    for k, v in ours.items():
        assert (v.shape, v.dtype) == (theirs[k].shape, theirs[k].dtype), k
    for k in ("layers/mamba/A_log", "layers/mamba/D"):
        assert torch.equal(ours[k], theirs[k]), k


def test_ssm_config_copy_matches_jax():
    for name in ("falcon-mamba-7b", ARCH):
        ours, theirs = get_config(name), jax_get_config(name)
        assert ours.__dict__ == theirs.__dict__
        assert (ours.d_inner, ours.resolved_dt_rank, ours.attention_free,
                ours.param_count()) == (
            theirs.d_inner, theirs.resolved_dt_rank, theirs.attention_free,
            theirs.param_count())
    full = get_config("falcon-mamba-7b")
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_state,
            full.resolved_dt_rank, full.vocab_size) == (64, 4096, 8192, 16,
                                                        256, 65024)
    assert 7.2e9 < full.param_count() < 7.3e9


@pytest.mark.parametrize("mode", [["--session", "--num-requests", "4",
                                   "--batch-sizes", "1,2"],
                                  ["--batch", "2", "--new-tokens", "4"]])
def test_cli_serves_falcon_mamba_on_cpu(mode):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         ARCH, "--prompt-len", "8", "--device", "cpu", *mode],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "device: cpu" in out.stdout and ARCH in out.stdout
    if "--session" in mode:
        assert out.stdout.count(" tokens via bucket(") == 4
        assert "session: 4 requests" in out.stdout
    else:
        assert "generated (2, 4)" in out.stdout
