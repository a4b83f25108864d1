"""Training on the card: one train step, the forward-only loss through
the flash kernel, and the refusal of ``backend="cuda"`` under autograd.

These tests need an NVIDIA card with ``nvcc``; they carry the ``gpu``
marker and skip elsewhere.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_train.py

Tolerances: a bf16 step's loss rtol 2e-2 and grad norm rtol 5e-2
against the same bf16 step on the CPU (cuBLAS and the CPU round bf16
products' sums in other orders); float32 (TF32 off): the step's loss
and grad norm rtol 1e-5 against the CPU; the no-grad ``"cuda"`` loss
rtol 1e-5 against plain on the card (float32 smoke config).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, global_batch  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import KernelGradError  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedule import constant  # noqa: E402
from repro_torch.runtime.train_loop import make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "phi3-mini-3.8b-smoke"


@pytest.fixture
def cuda_device():
    """The card, with TF32 off; skips without one (decided here, never
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, dev, seq=32, rows=4):
    bt = global_batch(DataConfig(cfg.vocab_size, seq, rows, seed=0), 0)
    return {k: torch.from_numpy(v).to(dev) for k, v in bt.items()}


def _one_step(cfg, dev):
    """(params before, params after, metrics) of one step on ``dev``
    from seed-0 weights made on the CPU."""
    model = build_model(cfg)
    moved = _to(model.init(seed=0, device="cpu"), dev)
    before = [t.detach().clone() for t in leaves(moved)]
    step = make_train_step(model, adamw.AdamWConfig(lr=1e-3),
                           lambda s: constant(s, peak_lr=1e-3))
    p2, o2, m = step(moved, adamw.init(moved), _batch(cfg, dev))
    assert int(o2.step) == 1
    return before, leaves(p2), {k: float(v) for k, v in m.items()}


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, dtype):
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    before, after, m = _one_step(cfg, cuda_device)
    _, _, mc = _one_step(cfg, torch.device("cpu"))
    for k in ("loss", "xent", "grad_norm"):
        assert m[k] == m[k] and abs(m[k]) < float("inf"), k
    rtol = {"bfloat16": {"loss": 2e-2, "xent": 2e-2, "grad_norm": 5e-2},
            "float32": {"loss": 1e-5, "xent": 1e-5, "grad_norm": 1e-5}}
    for k, tol in rtol[dtype].items():
        assert abs(m[k] - mc[k]) <= tol * abs(mc[k]), (k, m[k], mc[k])
    for a, b in zip(before, after):
        assert a.dtype == b.dtype == getattr(torch, dtype)
        assert not torch.equal(a, b.detach())


@pytest.mark.gpu
def test_cuda_loss_runs_the_flash_kernel_without_grad(cuda_device):
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    batch = _batch(cfg, cuda_device)
    with torch.no_grad():
        plain, _ = model.loss_fn(params, batch)
        reset_launch_counts()
        cuda, _ = model.loss_fn(params, batch, backend="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert abs(float(cuda) - float(plain)) <= 1e-5 * abs(float(plain))


@pytest.mark.gpu
def test_cuda_loss_refuses_grad_before_any_launch(cuda_device):
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    for t in leaves(params):
        t.requires_grad_(True)
    reset_launch_counts()
    with pytest.raises(KernelGradError):
        model.loss_fn(params, _batch(cfg, cuda_device), backend="cuda")
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) == 0
