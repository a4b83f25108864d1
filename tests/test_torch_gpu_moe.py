"""The port's MoE layer on the card: the dropped-slot tally under a
captured graph, and the pad rows of a moe prefill on the cuda backend.

These tests need an NVIDIA card with ``nvcc``; they carry the ``gpu``
marker and skip elsewhere.  The file imports no JAX (the CPU tests hold
the plain versions to the JAX package), so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_moe.py -q

Tolerances: float32 outputs of one layer atol/rtol 1e-5 (same
arithmetic); float32 logits of a whole prefill atol 1e-4 (the flash
kernel sums in another order than the plain attention, layer on
layer); dropped slots exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, left_pad_prompts  # noqa: E402
from repro_torch.models import moe, prompt_starts  # noqa: E402

E, D, F, K = 6, 16, 24, 2


@pytest.fixture
def cuda_device():
    """The card, with TF32 off; skips without one (decided here, never
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(seed=0):
    """One layer's float32 weights (router, routed and shared experts)
    and [3, 40, D] tokens, which drop slots at capacity factor 0.5."""
    rng = np.random.RandomState(seed)
    shapes = {"router": (D, E), "w1": (E, D, F), "w3": (E, D, F),
              "w2": (E, F, D), "shared_w1": (D, F), "shared_w3": (D, F),
              "shared_w2": (F, D)}
    p = {k: torch.from_numpy(rng.standard_normal(v).astype(np.float32) / 4)
         for k, v in shapes.items()}
    x = torch.from_numpy(rng.standard_normal((3, 40, D)).astype(np.float32))
    return p, x


@pytest.mark.gpu
def test_cuda_graph_captured_under_a_tally_replays_after_it_closed(
        cuda_device):
    """A CUDA graph of ``moe_ffn`` captured while a tally was open keeps
    adding to the device's counter at every replay after the tally
    closed, into live memory (a buffer allocated after the close stays
    untouched), and a later tally yields that same counter, zeroed."""
    p, x = _layer()
    with moe.drop_tally("cpu") as cpu_tally:
        moe.moe_ffn(x, p, n_experts=E, top_k=K, capacity_factor=0.5)
        want = int(cpu_tally)
    assert want > 0
    dev = cuda_device
    p = {k: v.to(dev) for k, v in p.items()}
    x = x.to(dev)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with moe.drop_tally(dev) as tally:
        ptr = tally.data_ptr()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):          # the warm-up
            moe.moe_ffn(x, p, n_experts=E, top_k=K, capacity_factor=0.5)
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            out, _ = moe.moe_ffn(x, p, n_experts=E, top_k=K,
                                 capacity_factor=0.5)
        torch.cuda.synchronize()
        assert int(tally) == want                # the warm-up's alone
    del tally
    torch.cuda.empty_cache()
    fill = [torch.full((1 << 16,), 7, dtype=torch.int64, device=dev)
            for _ in range(16)]
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert all(bool((f == 7).all()) for f in fill)
    with moe.drop_tally(dev) as again:
        assert again.data_ptr() == ptr and int(again) == 0
        graph.replay()
        torch.cuda.synchronize()
        assert int(again) == want
    ref, _ = moe.moe_ffn(x, p, n_experts=E, top_k=K, capacity_factor=0.5)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_moe_prefill_pad_rows_take_the_reference_value(cuda_device,
                                                            monkeypatch):
    """A left-padded moe prefill at capacity factor 0.5 (slots drop) on
    the cuda backend gives the plain backend's logits, pad rows
    included: the flash kernel gives zeros where a row has no valid key
    (as the JAX Pallas kernel does), and ``mean_rows_before_start``
    restores the reference's value there, because pad positions are
    routed and take expert capacity.  Without it the pad rows differ."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b-smoke"),
                              capacity_factor=0.5)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11, 16)]
    tokens = torch.from_numpy(left_pad_prompts(prompts, 16)).to(cuda_device)
    starts = torch.as_tensor(prompt_starts(prompts, 16), device=cuda_device)

    def logits(backend):
        with moe.drop_tally(cuda_device) as dropped:
            lg, _ = model.prefill(params, {"tokens": tokens},
                                  backend=backend, seq_starts=starts)
            torch.cuda.synchronize()
            return lg.float().cpu().numpy(), int(dropped)

    plain, plain_drops = logits("plain")
    cuda, cuda_drops = logits("cuda")
    assert plain_drops > 0 and cuda_drops == plain_drops
    np.testing.assert_allclose(cuda, plain, rtol=0, atol=1e-4)
    assert (cuda.argmax(-1) == plain.argmax(-1)).all()
    monkeypatch.setattr(attn, "mean_rows_before_start",
                        lambda ctx, v, starts: ctx)
    zeros, _ = logits("cuda")
    pad = np.arange(16)[None, :] < starts.cpu().numpy()[:, None]
    assert np.abs(zeros[pad] - plain[pad]).max() > 1e-3
