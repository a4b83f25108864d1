"""The port's request lifecycle on the card: build retries after a real
capture failure, a bucket degraded to its uncaptured step after one, an
error that sticks to the CUDA context (raised, never contained), and
sampled steps.

These tests need an NVIDIA card with ``nvcc``; they carry the ``gpu``
marker and skip elsewhere.  The file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_lifecycle.py -q
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (build_model, left_pad_prompts,  # noqa: E402
                                prompt_starts)
from repro_torch.runtime import generate  # noqa: E402
from repro_torch.serving import ServeSession  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    """The card, with TF32 off; skips without one (decided here, never
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


RETRY_AFTER_CAPTURE_FAILURE = """
import os
import numpy as np
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model
from repro_torch.serving import ServeSession

model = build_model(get_config("phi3-mini-3.8b-smoke"))
params = model.init(seed=0)
prompt = np.arange(1, 6)
clean = ServeSession(model, params, batch_sizes=(1,))
clean.submit(prompt, 6)
want = clean.drain()[0].tokens.tolist()
real, calls = Model.decode_step, []

def reads_host_at_the_first_capture(self, *a, **k):
    calls.append(1)
    lg, c = real(self, *a, **k)
    if len(calls) == 2 and float(lg.abs().sum()) < 0:   # a host read
        raise AssertionError
    return lg, c

Model.decode_step = reads_host_at_the_first_capture
s = ServeSession(model, params, batch_sizes=(1,), compile_retries=1)
s.submit(prompt, 6)
got = s.drain()[0].tokens.tolist()
print("equal" if got == want else "differ", len(calls),
      s.stats.compile_retries, flush=True)
os._exit(0)
"""


@pytest.mark.gpu
def test_cuda_build_retry_after_a_capture_failure(cuda_device):
    """A decode step's first capture fails (a host read while capturing);
    with ``compile_retries=1`` the session builds it again into a new
    graph on a new capture stream, and the tokens equal a clean run's.
    In a child process: a failed capture may leave the CUDA context
    unusable."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(RETRY_AFTER_CAPTURE_FAILURE)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    # warm-up + failed capture, warm-up + capture; one retry
    assert out.stdout.split() == ["equal", "4", "1"], out.stdout


DEGRADE_AFTER_CAPTURE_FAILURE = """
import os
import numpy as np
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.models import Model, build_model
from repro_torch.serving import ServeSession

model = build_model(get_config("phi3-mini-3.8b-smoke"))
params = model.init(seed=0)
prompt = np.arange(1, 6)
clean = ServeSession(model, params, batch_sizes=(1,))
clean.submit(prompt, 6)
want = clean.drain()[0].tokens.tolist()
real, calls = Model.decode_step, []

def reads_host_at_the_first_capture(self, *a, **k):
    calls.append(k.get("backend"))
    lg, c = real(self, *a, **k)
    if len(calls) == 2 and float(lg.abs().sum()) < 0:   # a host read
        raise AssertionError
    return lg, c

Model.decode_step = reads_host_at_the_first_capture
s = ServeSession(model, params, batch_sizes=(1,), fallback_backend="eager")
s.submit(prompt, 6)
kernels.reset_launch_counts()
got = s.drain()[0].tokens.tolist()
dec = [s.exec_cache.peek(k) for k in s.exec_cache.compiled_log
       if k.role == "decode"][0]
steps = s.stats.steps
print("equal" if got == want else "differ", ",".join(calls[:2]),
      s.stats.fallbacks, s.stats.degraded_buckets,
      [e.kind for e in s.stats.events] == ["compile_failure", "degraded"],
      dec.graph is None, calls[2:] == ["cuda"] * steps,
      kernels.launch_counts()["paged_decode_attention"]
      == model.cfg.n_layers * steps, flush=True)
os._exit(0)
"""


@pytest.mark.gpu
def test_cuda_capture_failure_under_eager_degrades(cuda_device):
    """With ``fallback_backend="eager"`` a decode step whose capture fails
    (a host read while capturing) is built again uncaptured under the
    same key: the bucket is degraded, every step runs the cuda step
    eagerly and launches its kernels (paged decode, one a layer), and
    (float32) gives the clean run's tokens.  In a child process: a
    failed capture may leave the CUDA context unusable."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c",
                          textwrap.dedent(DEGRADE_AFTER_CAPTURE_FAILURE)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    # cuda warm-up + failed capture, then one eager cuda call a step
    assert out.stdout.split() == ["equal", "cuda,cuda", "1", "1",
                                  "True", "True", "True", "True"], out.stdout


STICKY_ERROR = """
import os
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import ServeSession
from repro_torch.serving.captured import CapturedStep

model = build_model(get_config("phi3-mini-3.8b-smoke"))
params = model.init(seed=0)
s = ServeSession(model, params, batch_sizes=(2,), fallback_backend="eager")
real = CapturedStep.replay

def asserts_on_the_device(self):
    if "tables" in self.inputs and s._step_count == 2:
        x = torch.zeros(4, device="cuda")
        x[torch.full((1,), 1 << 20, device="cuda")] += 1   # out of bounds
    return real(self)

CapturedStep.replay = asserts_on_the_device
for i in range(3):
    s.submit(np.arange(1, 6 + i), 6, request_id=f"r{i}")
try:
    res = s.drain()
except RuntimeError as e:
    print("raised", type(e.__cause__).__name__,
          [ev.kind for ev in s.stats.events], flush=True)
    print(str(e).strip().splitlines()[0], flush=True)
    os._exit(3)
print("contained", [r.state for r in res], flush=True)
"""


@pytest.mark.gpu
def test_cuda_sticky_error_is_not_contained(cuda_device):
    """A device-side assert in a decode step sticks to the CUDA context:
    the session's synchronisation after the catch raises, so the step's
    error propagates out of ``drain`` and no row is reported FAILED as
    contained.  In a child process, which the error leaves unusable."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(STICKY_ERROR)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 3, out.stdout + out.stderr[-4000:]
    assert "Assertion" in out.stderr, out.stderr[-4000:]
    # the step's error, chained to the synchronisation's (a RuntimeError,
    # torch.AcceleratorError where torch has it); no event recorded
    first, error = out.stdout.splitlines()[:2]
    said = first.split()
    assert said[0] == "raised" and said[-1] == "[]", out.stdout
    assert said[1] in ("RuntimeError", "AcceleratorError"), out.stdout
    assert "device-side assert" in error, out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b-smoke",
                                  "falcon-mamba-7b-smoke"])
def test_cuda_sampled_graphs_equal_eager(cuda_device, arch):
    """Sampled ``generate`` (T=0.8) through captured graphs equals the
    same steps run eagerly and the plain path on noise from one seed;
    another seed gives other tokens; the nan fault marks its row FAILED
    through the graph's own finite flag."""
    from repro_torch.serving import FaultInjector
    model = build_model(get_config(arch))
    params = model.init(seed=0, device=cuda_device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in (5, 9, 16)]
    batch = {"tokens": left_pad_prompts(prompts, 16)}
    starts = prompt_starts(prompts, 16)
    out = {}
    for name, backend, capture, seed in (("graphs", "cuda", True, 0),
                                         ("eager", "cuda", False, 0),
                                         ("plain", "plain", False, 0),
                                         ("seed1", "cuda", True, 1)):
        g = torch.Generator(device=cuda_device).manual_seed(seed)
        out[name], _ = generate(model, params, batch, max_new_tokens=12,
                                seq_starts=starts, temperature=0.8,
                                generator=g, backend=backend,
                                capture=capture)
    assert np.array_equal(out["graphs"], out["eager"])
    assert np.array_equal(out["graphs"], out["plain"])
    assert not np.array_equal(out["graphs"], out["seed1"])
    s = ServeSession(model, params, batch_sizes=(4,),
                     faults=FaultInjector.from_strings(["nan@2.1"]))
    for i, p in enumerate(prompts):
        s.submit(p, 6, request_id=f"r{i}")
    res = {r.request_id: r for r in s.drain()}
    assert res["r1"].state == "FAILED" and s.stats.poisoned_rows == 1
    assert [res[k].state for k in ("r0", "r2")] == ["COMPLETED"] * 2
