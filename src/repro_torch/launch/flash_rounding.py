"""What splitting p buys the bf16 flash kernel: its worst share of the
bf16 tolerance with p = p_hi + p_lo (the kernel as built) beside a
scratch build of the same source that rounds p to bf16 once (the two
p_lo MMAs taken out), at the shapes of ``chip_smoke.py``'s bf16 flash
checks.

    PYTHONPATH=src python -m repro_torch.launch.flash_rounding

Needs a CUDA card and ``nvcc``.  The scratch source and library go to
``build/flash_rounding/`` (the kernel library itself is not changed).
Inputs are seeded normal tensors on the card; the tolerance is
``chip_smoke.py``'s: per element two bf16 ulps of the plain value plus
1e-5.  Prints one JSON line per shape and the card's name and power
limit.
"""
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build, flash_attention
from repro_torch.kernels._checks import q_scale
from repro_torch.kernels._geometry import FLASH_KEYS, FLASH_ROWS
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import bucket_length

# the P V MMAs of the lo part, as flash_attention.cu writes them
LO_MMAS = ("hw::mma_16816(o_acc[2 * dp], pl, vf[0], vf[1]);",
           "hw::mma_16816(o_acc[2 * dp + 1], pl, vf[2], vf[3]);")
# chip_smoke.py's engine prompts (each at its bucket, left-padded) and
# generate's batch of four prompts padded to 512
ENGINE_PROMPTS = [200, 17, 300, 150, 45, 260, 130, 77]
GENERATE_STARTS = [472, 412, 262, 212]


def share_of_tol(got, want):
    """Worst |got - want| as a share of 2 bf16 ulps of |want| + 1e-5."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(2.0 ** -126)
    allowed = 2 * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5
    return (diff / allowed).max().item()


def build_rounded_once():
    """The flash source without its lo MMAs, built alone; its entry."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for line in LO_MMAS:
        if src.count(line) != 1:
            raise SystemExit(f"flash_rounding: {line!r} not found once in "
                             f"flash_attention.cu")
        src = src.replace(line, "")
    out = _build.BUILD_DIR.parent / "flash_rounding"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "flash_once.cu", out / "libflash_once.so"
    cu.write_text(src)
    res = subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                          "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                          str(_build.CSRC), str(cu), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit("flash_rounding: nvcc failed\n" + res.stdout
                         + res.stderr)
    fn = ctypes.CDLL(str(so)).flash_attention_fwd
    fn.argtypes = _build.SIGNATURES["flash_attention_fwd"]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    """Both variants at every shape; one JSON line each."""
    if not torch.cuda.is_available():
        raise SystemExit("flash_rounding needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    once = build_rounded_once()
    gen = torch.Generator(device=dev).manual_seed(1234)
    shapes = [(1, bucket_length(p), [bucket_length(p) - p])
              for p in sorted(set(ENGINE_PROMPTS))]
    shapes.append((4, 512, GENERATE_STARTS))
    worst = {"split": 0.0, "rounded_once": 0.0}
    for b, s, starts in shapes:
        q, k, v = (torch.randn((b, 32, s, 96), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        want = flash_attention_ref(q, k, v, starts=st)
        split = flash_attention(q, k, v, starts=st)
        out = torch.empty_like(q)
        _build.check(once(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), st.data_ptr(), b,
                          32, 32, s, 96, 1, 0, q_scale(q), 1, FLASH_ROWS,
                          FLASH_KEYS, _build.stream_handle(dev)),
                      "flash_once")
        torch.cuda.synchronize()
        line = {"shape": [b, 32, s, 96], "starts": starts,
                "split": share_of_tol(split, want),
                "rounded_once": share_of_tol(out, want), "card": smi}
        for key in worst:
            worst[key] = max(worst[key], line[key])
        print(json.dumps(line), flush=True)
    print(json.dumps({"worst_share_of_tol": worst, "card": smi}))


if __name__ == "__main__":
    main()
