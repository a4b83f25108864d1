"""The port's training path against the JAX package's XLA training on
float32 smoke configs, with the same weights (the JAX init through
:func:`repro_torch.bridge.params_from_numpy`) and the same batches (the
numpy data pipeline).

Tolerances (float32): ``softmax_xent`` rtol 1e-6; step-0 loss rtol 1e-5
and each leaf's gradient to 1e-5 of that leaf's largest |gradient| (the
two packages sum float32 products in other orders: the worst leaf of the
seven configs sits at ~1.2e-6 of its max); the remat policies give the
same loss and gradients bit for bit on the CPU (a recompute is the same
computation); the microbatched step holds the JAX test's 5e-3 against
the one-batch step, and its metrics rtol 1e-5 against JAX's
microbatched step, whose parameters it holds to 2 x lr (+1e-6): a
gradient element at noise level can flip the sign of AdamW's first
update, ``m / sqrt(v) ~ sign(g)``; the ``Trainer``'s 8 losses rtol 1e-4
against JAX's from a shared step-0 checkpoint (the same flips compound
over steps; losses, not parameters, are compared over a run); the
no-grad ``"cuda"`` loss (the flash kernel's plain version on the CPU)
rtol 1e-5 against plain and JAX's ``"pallas"`` loss.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.layers import softmax_xent as jax_xent  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import constant as jconstant  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, global_batch  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.models.transformer import (KernelGradError,  # noqa: E402
                                            REMAT_POLICIES)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import constant  # noqa: E402
from repro_torch.runtime import train_loop as tl  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5            # of each leaf's largest |gradient|
RUN_RTOL = 1e-4


def _variant(name):
    """(JAX config, port config) of ``name``; ``recurrentgemma-9b-smoke:5``
    is the hybrid smoke config at 5 layers (a group and a 2-layer tail)."""
    arch, _, layers = name.partition(":")
    jc, tc = jax_get_config(arch), get_config(arch)
    if layers:
        jc = dataclasses.replace(jc, n_layers=int(layers))
        tc = dataclasses.replace(tc, n_layers=int(layers))
    return jc, tc


def _batch(cfg, b=2, s=24):
    """Pipeline tokens and labels (seed 1, step 0); random image
    embeddings (vlm: their labels masked) or frames (audio)."""
    bt = global_batch(DataConfig(cfg.vocab_size, s, b, seed=1), 0)
    rng = np.random.default_rng(5)
    if cfg.family == "vlm":
        bt["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        bt["labels"] = np.concatenate(
            [np.full((b, cfg.num_image_tokens), -1, np.int32),
             bt["labels"]], axis=1)
    if cfg.family == "audio":
        bt["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return bt


def _tensors(bt):
    return {k: torch.from_numpy(v) for k, v in bt.items()}


def _jax_paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_grads(tm, tp, batch, **kw):
    flat = leaves(tp)
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = tm.loss_fn(tp, batch, **kw)
    grads = torch.autograd.grad(loss, flat)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


# ------------------------------------------------------------- the loss

def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, -2:] = -1
    labels[2, 0] = -1
    got, den = softmax_xent(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    want, jden = jax_xent(jnp.asarray(logits), jnp.asarray(labels))
    assert float(den) == float(jden) == 18.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    none, nden = softmax_xent(torch.from_numpy(logits),
                              torch.full((3, 7), -1, dtype=torch.int32))
    assert float(nden) == 1.0 and float(none) == 0.0


# ------------------------------------------- step-0 loss and gradients

ARCHS = ["phi3-mini-3.8b-smoke", "qwen2-moe-a2.7b-smoke",
         "falcon-mamba-7b-smoke", "recurrentgemma-9b-smoke",
         "recurrentgemma-9b-smoke:5", "paligemma-3b-smoke",
         "whisper-large-v3-smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    """Dense, moe (its aux loss in the loss), ssm, hybrid (the log-depth
    RG-LRU scan under autograd; windowed attention at 24 > 16 tokens),
    vlm and audio: ``jax.value_and_grad`` of the ``"xla"`` loss against
    the port's autograd of the plain loss."""
    jc, tc = _variant(arch)
    jm, tm = jax_build_model(jc), build_model(tc)
    jp, _ = jm.init(jax.random.key(0))
    bt = _batch(jc)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b), has_aux=True))(
            jp, jax.tree.map(jnp.asarray, bt))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tl_, tmet, tg = _port_grads(tm, tp, _tensors(bt))
    np.testing.assert_allclose(float(tl_), float(jl), rtol=LOSS_RTOL)
    assert sorted(tmet) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if jc.n_experts:
        assert float(tmet["moe_aux"]) > 0
    paths = [p for p, _ in flatten_with_paths(tp)]
    assert paths == _jax_paths(jg)
    for path, a, b in zip(paths, tg, jax.tree.leaves(jg)):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        assert scale > 0, path
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * scale, (path, err, scale)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b-smoke",
                                  "recurrentgemma-9b-smoke:5",
                                  "whisper-large-v3-smoke"])
def test_remat_policies_same_loss_and_grads(arch):
    _, tc = _variant(arch)
    tm = build_model(tc)
    tp = tm.init(seed=0, device="cpu")
    batch = _tensors(_batch(tc))
    ref = None
    for remat in REMAT_POLICIES:
        loss, _, grads = _port_grads(tm, tp, batch, remat=remat)
        if ref is None:
            ref = (loss, grads)
            continue
        assert torch.equal(loss, ref[0]), remat
        assert all(torch.equal(a, b) for a, b in zip(grads, ref[1])), remat
    with pytest.raises(ValueError):
        tm.loss_fn(tp, batch, remat="all")


# --------------------------------------------------------- microbatches

def test_microbatched_step_matches_single_and_jax():
    arch = "phi3-mini-3.8b-smoke"
    jm, tm = jax_build_model(jax_get_config(arch)), build_model(
        get_config(arch))
    jp, _ = jm.init(jax.random.key(0))
    rng = np.random.default_rng(1)
    bt = {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
          "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}
    lr = 1e-3
    jfour = jax.jit(jtl.make_train_step(
        jm, jadamw.AdamWConfig(lr=lr),
        lambda s: jconstant(s, peak_lr=lr), microbatches=4))
    jp4, _, jm4 = jfour(jp, jadamw.init(jp), jax.tree.map(jnp.asarray, bt))
    out = {}
    for n in (1, 4):
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        step = tl.make_train_step(tm, adamw.AdamWConfig(lr=lr),
                                  lambda s: constant(s, peak_lr=lr),
                                  microbatches=n)
        p2, o2, m = step(tp, adamw.init(tp), _tensors(bt))
        assert int(o2.step) == 1
        out[n] = (p2, m)
    assert abs(float(out[1][1]["xent"]) - float(out[4][1]["xent"])) < 5e-3
    for a, b in zip(leaves(out[1][0]), leaves(out[4][0])):
        assert float((a - b).detach().abs().max()) < 5e-3
    p4, m4 = out[4]
    for k in ("xent", "loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m4[k]), float(jm4[k]),
                                   rtol=LOSS_RTOL)
    for a, b in zip(leaves(p4), jax.tree.leaves(jp4)):
        assert float(np.abs(a.detach().numpy() - np.asarray(b)).max()) \
            <= 2 * lr + 1e-6


# ------------------------------------------------------------- trainer

def test_trainer_losses_match_jax_trainer(tmp_path):
    """Both trainers restore one step-0 checkpoint written by JAX's
    Checkpointer (so the checkpoint crosses packages) and train 8 steps
    on the same pipeline."""
    arch = "phi3-mini-3.8b-smoke"
    jm, tm = jax_build_model(jax_get_config(arch)), build_model(
        get_config(arch))
    jp, _ = jm.init(jax.random.key(3))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    JCheckpointer(str(jdir)).save(0, {"params": jp,
                                      "opt": jadamw.init(jp)})
    shutil.copytree(jdir, tdir)
    kw = dict(steps=8, ckpt_every=100, log_every=100, warmup_steps=2)
    jout = jtl.Trainer(jm, jtl.TrainConfig(
        ckpt_dir=str(jdir), opt=jadamw.AdamWConfig(lr=2e-3), **kw),
        JDataConfig(vocab_size=256, seq_len=32, global_batch=4)).run()
    tout = tl.Trainer(tm, tl.TrainConfig(
        ckpt_dir=str(tdir), opt=adamw.AdamWConfig(lr=2e-3), device="cpu",
        **kw), DataConfig(vocab_size=256, seq_len=32, global_batch=4)).run()
    jl = [h["loss"] for h in jout["history"]]
    tl_ = [h["loss"] for h in tout["history"]]
    assert [h["step"] for h in tout["history"]] == list(range(8))
    assert sorted(tout["history"][0]) == sorted(jout["history"][0])
    np.testing.assert_allclose(tl_, jl, rtol=RUN_RTOL)
    np.testing.assert_allclose([h["lr"] for h in tout["history"]],
                               [h["lr"] for h in jout["history"]],
                               rtol=1e-6)
    assert tl_[-1] < tl_[0]
    assert int(tout["opt_state"].step) == 8


def test_trainer_builds_schedule_bundle_for_cuda(tmp_path):
    """The counterpart of the JAX trainer's ``"pallas"`` bundle test."""
    cfg = get_config("phi3-mini-3.8b-smoke")
    model = build_model(cfg)
    dcfg = DataConfig(global_batch=2, seq_len=8, vocab_size=cfg.vocab_size)
    trainer = tl.Trainer(model, tl.TrainConfig(
        steps=1, backend="cuda", registry_path=str(tmp_path / "t.jsonl"),
        device="cpu"), dcfg)
    assert trainer.schedules is not None
    assert trainer.schedules.flash_attention is not None
    plain = tl.Trainer(model, tl.TrainConfig(
        steps=1, registry_path=str(tmp_path / "t2.jsonl"), device="cpu"),
        dcfg)
    assert plain.schedules is None
    before = launch_counts()
    with pytest.raises(KernelGradError):
        trainer.run()
    assert trainer.history == [] and launch_counts() == before


def test_cuda_loss_refuses_grad_and_matches_plain_without():
    """With grad on, ``backend="cuda"`` raises before any launch; under
    ``no_grad`` it is the forward-only loss through the kernels' entry
    points, equal to plain and to JAX's ``"pallas"`` loss."""
    arch = "phi3-mini-3.8b-smoke"
    jm, tm = jax_build_model(jax_get_config(arch)), build_model(
        get_config(arch))
    jp, _ = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    bt = _batch(tm.cfg, s=16)
    batch = _tensors(bt)
    for t in leaves(tp):
        t.requires_grad_(True)
    before = launch_counts()
    with pytest.raises(KernelGradError):
        tm.loss_fn(tp, batch, backend="cuda")
    assert launch_counts() == before
    with torch.no_grad():
        cuda, _ = tm.loss_fn(tp, batch, backend="cuda")
        plain, _ = tm.loss_fn(tp, batch)
    pallas, _ = jm.loss_fn(jp, jax.tree.map(jnp.asarray, bt),
                           backend="pallas")
    np.testing.assert_allclose(float(cuda), float(plain), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(cuda), float(pallas), rtol=LOSS_RTOL)


def test_launch_train_cli_writes_back_train_step(tmp_path, capsys):
    from repro_torch.launch import train as launch_train
    reg_path = tmp_path / "t.jsonl"
    out = launch_train.main(["--arch", "phi3-mini-3.8b-smoke", "--steps",
                             "3", "--seq", "16", "--batch", "2",
                             "--device", "cpu", "--registry",
                             str(reg_path)])
    text = capsys.readouterr().out
    assert "done: steps=3 first_loss=" in text and "stragglers=0" in text
    assert len(out["history"]) == 3
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tune", "--registry",
         str(reg_path), "inspect", "--kind", "train_step"],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    row = [ln for ln in res.stdout.splitlines()
           if ln.startswith("train_step")]
    assert len(row) == 1 and "measured=" in row[0]
    assert "arch=phi3-mini-3.8b-smoke" in row[0]
    assert "backend=plain" in row[0]
