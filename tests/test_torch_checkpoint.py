"""The port's checkpoints and restarts against the JAX package's format
(``repro.checkpoint``) and fault tolerance (``repro.runtime.ft``).

Tolerances: none.  A checkpoint written by either package restores in
the other bit for bit (bf16 included: its raw bits), the two packages
write byte-identical files for the same tree, and a restarted port run
reproduces an uninterrupted run's losses exactly on the CPU.
"""
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.checkpoint import save as jsave  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime.ft import run_with_restart as jrun_with_restart  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy,  # noqa: E402
                                params_from_numpy)
from repro_torch.checkpoint import Checkpointer, restore, save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWState, adamw  # noqa: E402
from repro_torch.runtime.ft import run_with_restart  # noqa: E402
from repro_torch.runtime.train_loop import TrainConfig, Trainer  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


def _jax_tree(seed=0):
    """A {"params", "opt"} tree of the JAX package: bf16 and float32
    leaves, an AdamWState with a nonzero step."""
    rng = np.random.default_rng(seed)
    params = {"embed": jnp.asarray(rng.standard_normal((8, 4)),
                                   jnp.bfloat16),
              "layers": {"w": jnp.asarray(rng.standard_normal((2, 4, 6)),
                                          jnp.float32),
                         "ln": jnp.asarray(rng.standard_normal((2, 4)),
                                           jnp.bfloat16)}}
    st = jadamw.init(params)
    st = jadamw.AdamWState(
        step=jnp.int32(5),
        m=jax.tree.map(lambda m: m + 0.25, st.m),
        v=jax.tree.map(lambda v: v + 0.5, st.v))
    return {"params": params, "opt": st}


def _port_tree(jtree):
    """The same tree as the port holds it."""
    np_tree = jax.tree.map(np.asarray, jtree)
    return {"params": params_from_numpy(np_tree["params"], device="cpu"),
            "opt": opt_state_from_numpy(np_tree["opt"], device="cpu")}


def _bits(x):
    """Comparable bytes of a tensor or array leaf (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(port_tree, jax_tree):
    flat = flatten_with_paths(port_tree)
    jflat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(jflat)
    for (path, a), (_, b) in zip(flat, jflat):
        assert str(_bits(a).dtype) == str(_bits(b).dtype), path
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)


def test_keys_are_jax_paths(tmp_path):
    jtree = _jax_tree()
    save(str(tmp_path / "ck"), _port_tree(jtree))
    man = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    paths = [e["path"] for e in man["leaves"]]
    assert paths[:2] == ["opt/.step", "opt/.m/embed"]
    assert "params/layers/w" in paths and "opt/.v/layers/ln" in paths
    dtypes = {e["path"]: e["dtype"] for e in man["leaves"]}
    assert dtypes["params/embed"] == "bfloat16"
    assert dtypes["opt/.step"] == "int32"


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree = _jax_tree()
    jsave(str(tmp_path / "ck"), jtree, extra={"data_step": 5})
    like = _port_tree(_jax_tree(seed=9))
    back, extra = restore(str(tmp_path / "ck"), like=like, device="cpu")
    assert extra == {"data_step": 5}
    assert isinstance(back["opt"], AdamWState)
    assert back["params"]["embed"].dtype == torch.bfloat16
    _assert_same(back, jtree)
    nested, _ = restore(str(tmp_path / "ck"), device="cpu")
    assert sorted(nested["opt"]) == [".m", ".step", ".v"]
    assert torch.equal(nested["params"]["layers"]["w"],
                       back["params"]["layers"]["w"])


def test_port_checkpoint_restores_in_jax_and_files_are_identical(tmp_path):
    jtree = _jax_tree()
    save(str(tmp_path / "port"), _port_tree(jtree), extra={"note": "x"})
    jsave(str(tmp_path / "jax"), jtree, extra={"note": "x"})
    for name in ("data.bin", "manifest.json"):
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name,
                           shallow=False), name
    back, extra = jrestore(str(tmp_path / "port"), like=_jax_tree(seed=9))
    assert extra == {"note": "x"}
    _assert_same(_port_tree(jtree), back)


def test_restore_checks_leaves(tmp_path):
    jtree = _jax_tree()
    save(str(tmp_path / "ck"), _port_tree(jtree))
    like = _port_tree(jtree)
    like["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError):
        restore(str(tmp_path / "ck"), like=like, device="cpu")
    like = _port_tree(jtree)
    like["params"]["embed"] = torch.zeros(3, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        restore(str(tmp_path / "ck"), like=like, device="cpu")


def test_checkpointer_retention_async_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.restore_latest(device="cpu") is None
    x = torch.ones(3)
    for step in (1, 2, 3, 4):
        ck.save(step, {"x": x * step}, blocking=step % 2 == 0)
    ck.wait()
    assert ck.all_steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    step, tree, _ = ck.restore_latest(device="cpu")
    assert step == 4 and torch.equal(tree["x"], x * 4)


def test_async_save_snapshots_in_the_callers_thread(tmp_path):
    """The leaves are copied before ``save`` returns: an in-place update
    right after does not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    w = torch.zeros(1 << 16)
    ck.save(1, {"w": w}, blocking=False)
    w.add_(1.0)
    ck.wait()
    _, tree, _ = ck.restore_latest(device="cpu")
    assert not tree["w"].any()


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    save(str(tmp_path / "ck"), {"x": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore(str(tmp_path / "ck"))


# ------------------------------------------------------- restart on the CPU

def _trainer(d, steps=12, **kw):
    cfg = get_config("minitron-4b-smoke")
    return Trainer(build_model(cfg), TrainConfig(
        steps=steps, ckpt_every=4, log_every=100, ckpt_dir=d,
        opt=adamw.AdamWConfig(lr=2e-3), warmup_steps=2, device="cpu", **kw),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4))


def test_restart_resumes_bit_exact(tmp_path):
    """8 steps with checkpoints every 4, then a fresh trainer resumes at
    step 8: steps 8-11 give the uninterrupted run's losses exactly, and
    the final parameters are equal."""
    whole = _trainer(None).run()
    first = _trainer(str(tmp_path)).run(steps=8)
    assert [h["step"] for h in first["history"]] == list(range(8))
    resumed = _trainer(str(tmp_path)).run()
    assert [h["step"] for h in resumed["history"]] == [8, 9, 10, 11]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][8:]]
    for (path, a), (_, b) in zip(flatten_with_paths(resumed["params"]),
                                 flatten_with_paths(whole["params"])):
        assert torch.equal(a, b), path


def test_run_with_restart_counts_like_jax():
    def attempts(impl):
        calls = {"n": 0}

        def make_state():
            return {"attempt": calls["n"]}

        def run(state):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("simulated node failure")

        return impl(make_state, run, max_restarts=5)

    assert attempts(run_with_restart) == attempts(jrun_with_restart) == 2
    with pytest.raises(RuntimeError):
        run_with_restart(dict, lambda s: (_ for _ in ()).throw(
            RuntimeError("always")), max_restarts=1)
    with pytest.raises(KeyError):
        run_with_restart(dict, lambda s: {}["missing"])


def test_run_with_restart_resumes_a_trainer(tmp_path):
    """A RuntimeError once, after the step-4 checkpoint: one restart, and
    the run ends at the full step count from the checkpoint."""
    fired = []

    def make_state():
        t = _trainer(str(tmp_path), steps=8)
        step_fn = t._step_fn

        def failing(params, opt_state, batch):
            if int(opt_state.step) == 6 and not fired:
                fired.append(6)
                raise RuntimeError("injected failure at step 6")
            return step_fn(params, opt_state, batch)

        t._step_fn = failing
        return {"trainer": t}

    outs = []
    restarts = run_with_restart(
        make_state, lambda s: outs.append(s["trainer"].run()))
    assert restarts == 1 and fired == [6]
    assert [h["step"] for h in outs[-1]["history"]] == [4, 5, 6, 7]
    assert int(outs[-1]["opt_state"].step) == 8
