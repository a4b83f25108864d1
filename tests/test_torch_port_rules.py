"""Rules of the port that no parity test covers: it imports neither JAX
nor the JAX package, its entry points never move to the CPU on their
own, its wrappers never fall back to a plain version for a tensor they
cannot launch on, and its CLI runs on the CPU when asked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the suite runs beside the JAX reference)

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import device_identity, resolve_device  # noqa: E402
from repro_torch.kernels import (conv2d, decode_attention,  # noqa: E402
                                 flash_attention, launch_counts, matmul,
                                 paged_decode_attention, sparse_conv2d,
                                 ssm_scan)
from repro_torch.models import build_model  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_files_found():
    assert len(PORT_FILES) >= 20
    assert (REPO / "chip_smoke.py").exists()
    assert sorted(p.name for p in (REPO / "src/repro_torch/kernels/csrc")
                  .glob("*.cu")) == ["conv2d.cu", "decode_attention.cu",
                                     "errors.cu", "flash_attention.cu",
                                     "matmul.cu",
                                     "paged_decode_attention.cu",
                                     "sparse_conv.cu", "ssm_scan.cu"]


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no card, the default device raises; only an explicit CPU
    request runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi3-mini-3.8b-smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_model(cfg).init(seed=0)
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": __import__("numpy").zeros(2)})
    with pytest.raises(RuntimeError):
        device_identity()
    assert resolve_device("cpu").type == "cpu"
    assert device_identity("cpu") == "cpu"
    params = build_model(cfg).init(seed=0, device="cpu")
    assert params["embed"].device.type == "cpu"


def test_quickstart_raises_without_a_card(monkeypatch):
    """The quickstart runs the conv kernel on the card; with no card it
    raises before any work, unless asked for the CPU."""
    from repro_torch.launch import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = launch_counts()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.run("cuda")
    assert quickstart.main(["--device", "cpu"])["device"] == "cpu"
    assert launch_counts() == before


def test_wrappers_never_fall_back_for_non_cpu_tensors():
    """A tensor that is not on the CPU reaches the kernel path or
    raises; it never silently runs the plain version."""
    q = torch.zeros(1, 2, 8, 16, device="meta")
    before = launch_counts()
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    qd = torch.zeros(1, 2, 1, 16, device="meta")
    with pytest.raises(ValueError):
        decode_attention(qd, q, q, 3)
    pool = torch.zeros(4, 2, 4, 16, device="meta")
    tables = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        paged_decode_attention(qd, pool, pool, tables,
                               torch.zeros(1, dtype=torch.int32,
                                           device="meta"))
    x = torch.zeros(1, 4, 32, device="meta")
    bc = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        ssm_scan(x, x, bc, bc, torch.zeros(32, 16, device="meta"),
                 torch.zeros(32, device="meta"))
    img = torch.zeros(1, 8, 10, 10, device="meta")
    wgt = torch.zeros(8, 8, 3, 3, device="meta")
    with pytest.raises(ValueError):
        conv2d(img, wgt)
    with pytest.raises(ValueError):
        sparse_conv2d(img, wgt, block={"oc": 4, "ic": 4})
    with pytest.raises(ValueError):
        matmul(torch.zeros(16, 8, device="meta"),
               torch.zeros(8, 16, device="meta"))
    assert launch_counts() == before


def test_same_seed_same_weights_on_cpu():
    cfg = get_config("phi3-mini-3.8b-smoke")
    a = build_model(cfg).init(seed=3, device="cpu")
    b = build_model(cfg).init(seed=3, device="cpu")
    c = build_model(cfg).init(seed=4, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["lm_head"], c["lm_head"])


def test_full_config_is_phi3_mini():
    cfg = get_config("phi3-mini-3.8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
            cfg.dtype) == (32, 3072, 32, 32, 96, 8192, 32064, "bfloat16")
    assert 3.8e9 < cfg.param_count() < 3.9e9


@pytest.mark.parametrize("mode", [["--session", "--num-requests", "4",
                                   "--batch-sizes", "1,2"],
                                  ["--batch", "2", "--new-tokens", "4"]])
def test_cli_runs_on_cpu_when_asked(mode):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "phi3-mini-3.8b-smoke", "--prompt-len", "8", "--device", "cpu",
         *mode], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "device: cpu" in out.stdout
    if "--session" in mode:
        assert out.stdout.count(" tokens via bucket(") == 4
        assert "session: 4 requests" in out.stdout
    else:
        assert "generated (2, 4)" in out.stdout


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The trainer, the checkpoint restore and the training launchers
    run on the card by default: with no card they raise before any work,
    unless asked for the CPU."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import DataConfig
    from repro_torch.launch import elastic_restart, train, train_lm
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi3-mini-3.8b-smoke")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    before = launch_counts()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(build_model(cfg), TrainConfig(steps=1), dcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", cfg.name, "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm.main(["--small", "--ckpt-dir", str(tmp_path / "lm")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic_restart.main([])
    save(str(tmp_path / "ck"), {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore(str(tmp_path / "ck"))
    assert not (tmp_path / "lm").exists()
    out = Trainer(build_model(cfg), TrainConfig(steps=1, device="cpu"),
                  dcfg).run()
    assert out["params"]["embed"].device.type == "cpu"
    assert launch_counts() == before


def test_training_launchers_run_on_cpu_when_asked(tmp_path, capsys):
    """``launch/train_lm --small`` and ``launch/elastic_restart`` (the
    counterparts of the JAX package's examples) on the CPU."""
    from repro_torch.launch import elastic_restart, train_lm
    out = train_lm.main(["--small", "--device", "cpu", "--ckpt-dir",
                         str(tmp_path / "lm")])
    text = capsys.readouterr().out
    assert "arch=lm-100m params~" in text and "tok/s" in text
    assert len(out["history"]) == 20 and out["tok_s"] > 0
    # checkpoints every 50 steps, as the JAX example: none in 20
    assert os.listdir(tmp_path / "lm") == []
    res = elastic_restart.run("cpu")
    assert res["phase2"]["history"][0]["step"] == 10
    assert len(res["phase2"]["history"]) == 5 and res["shards_equal"]
    assert "resumed at step 10 (expected 10)" in capsys.readouterr().out
