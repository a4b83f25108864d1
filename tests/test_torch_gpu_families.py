"""The hybrid, vlm and audio families' kernel cases and captured steps,
on the card.

These tests need an NVIDIA card with ``nvcc``; they carry the ``gpu``
marker and skip elsewhere.  The file imports no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_families.py

Tolerances as in tests/test_torch_gpu.py: bf16 two bf16 ulps of the
plain value plus 1e-5 per element, float32 1e-5; tokens exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention, flash_attention  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.models import attention as model_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402


@pytest.fixture
def cuda_device():
    """The card, with TF32 off; skips without one (decided here, never
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _share_of_tol(got, want):
    """Worst |got - want| as a share of each element's tolerance."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(2.0 ** -126)
        allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    else:
        allowed = torch.full_like(diff, 1e-5)
    return (diff / allowed).max().item()


def _rn(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lambda *shape: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16)


@pytest.mark.gpu
def test_cuda_flash_window_at_recurrentgemmas_long_bucket(cuda_device):
    """16 query heads on one KV head, head_dim 256, a bucket of 4096
    with the local window of 2048: causal and windowed."""
    rn = _rn(cuda_device, 1)
    q, k, v = rn(1, 16, 4096, 256), rn(1, 1, 4096, 256), rn(1, 1, 4096, 256)
    got = flash_attention(q, k, v, causal=True, window=2048)
    want = flash_attention_ref(q, k, v, causal=True, window=2048)
    assert _share_of_tol(got, want) <= 1.0


@pytest.mark.gpu
def test_cuda_flash_non_causal_at_whispers_encoder(cuda_device):
    """20 heads of 64 over 1500 frames, no mask: 1500 is no multiple of
    the body's 64-row query or key tiles."""
    rn = _rn(cuda_device, 2)
    q, k, v = (rn(4, 20, 1500, 64) for _ in range(3))
    got = flash_attention(q, k, v, causal=False)
    assert _share_of_tol(got, flash_attention_ref(q, k, v,
                                                  causal=False)) <= 1.0


@pytest.mark.gpu
def test_cuda_decode_over_a_wrapped_rolling_buffer(cuda_device):
    """The contiguous decode kernel over 2048 rolling slots at positions
    past them: every slot valid, the model's windowed plain rule."""
    rn = _rn(cuda_device, 3)
    q, k, v = rn(4, 16, 1, 256), rn(4, 1, 2048, 256), rn(4, 1, 2048, 256)
    pos = torch.tensor([2048, 2500, 3000, 4127], device=cuda_device)
    got = decode_attention(q, k, v, pos)
    assert _share_of_tol(got, decode_attention_ref(q, k, v, pos)) <= 1.0
    assert _share_of_tol(got, model_attention.decode_attention(
        q, k, v, pos, window=2048, backend="plain")) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b-smoke",
                                  "paligemma-3b-smoke",
                                  "whisper-large-v3-smoke"])
def test_captured_bucketed_steps_equal_uncaptured_and_plain(cuda_device,
                                                           arch):
    """float32 smoke configs: ``run_batch`` through captured graphs,
    through the same steps run eagerly and through the plain path gives
    the same tokens.  recurrentgemma's prompt of 12 tokens and 20 new
    ones cross its 16-slot rolling buffer's wrap inside the captured
    decode step (the slot ``pos % 16`` is a device op); each decode
    step launches the decode kernel once a layer that attends."""
    model = build_model(get_config(arch))
    params = model.init(seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, 256, (2, 12)).astype(np.int32)}
    for name, (shape, _) in model.modality_specs(2).items():
        batch[name] = rng.standard_normal(shape).astype(np.float32)
    out = {}
    for name, backend, capture in (("graphs", "cuda", True),
                                   ("eager", "cuda", False),
                                   ("plain", "plain", False)):
        s = ServeSession(model, params, backend=backend, capture=capture)
        kernels.reset_launch_counts()
        out[name], _ = s.run_batch(batch, max_new_tokens=20)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        if backend == "cuda":
            dec = s.exec_cache.peek(s.exec_cache.compiled_log[-1])
            assert (dec.graph is not None) == capture
            per_step = (1 if model.cfg.family == "hybrid"
                        else model.cfg.n_layers)
            assert counts["decode_attention"] == 19 * per_step
        else:
            assert counts == {}
    assert np.array_equal(out["graphs"], out["eager"])
    assert np.array_equal(out["graphs"], out["plain"])
