#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``; exits non-zero
without a card, or when run without the rest of the repository.  Phases,
one line each (any failure exits non-zero and prints no ``ok`` line):

1. device: name, count, power limit, torch and CUDA versions;
2. build: the seven kernels from ``src/repro_torch/kernels/csrc``, one
   nvcc per source in parallel, and ptxas' registers, spills and shared
   memory for each main-path instantiation; ``[sass]``: the tensor-core
   instructions (HGMMA for wgmma, HMMA for mma.sync) in ``cuobjdump
   -sass`` of the bf16 matmul, conv2d, block-sparse conv and flash
   attention entry functions (none may be 0) and of their float32
   bodies (which stay on the CUDA cores: none may hold one);
3. kernels: each kernel against its plain PyTorch version at every
   shape the main paths give it in bf16 (per element, two bf16 ulps of
   the plain value plus 1e-5), at the main geometry in float32 (1e-5)
   and at smoke shapes in float32 (1e-5): the three attention kernels
   (MHA, head_dim 96; smoke GQA group 2; and in both dtypes head_dim
   256 with 16 and 8 query heads on one KV head, group 5, windows inside
   one decode split) and the selective scan (Di 8192, N 16; smoke Di
   128, N 8), with kernel, plain and library times from CUDA events (L2
   flushed before each timed launch), each decode kernel's split plan
   and the scan's launch (states a lane, threads, warps an SM) beside
   its ``[time]`` (the scan at the largest engine prefill, generate's
   [4, 512] prefill and the decode step, each also at block_d 32-256 in
   ``[time_block_d]``), ``[time_wide]`` for the head_dim 256
   instances, and flash's time at every engine prompt bucket
   (``[time_bucket]``);
4. engine: ``ServeSession`` on full-width, full-depth phi3-mini-3.8b in
   bf16 with random weights from a seed, 8 requests of mixed prompt
   lengths, 32 new tokens each, drained twice through one session
   (cold: every prefill and decode step is built; warm: none may be)
   in each of two modes in this call: ``graphs`` (the default: each
   step a captured CUDA graph, replayed) and ``eager``
   (``capture=False``: the same steps, one launch per op); every
   request must complete with finite logits, through the flash and
   paged-decode kernels; in graphs mode every step that ran must be a
   replay of a captured graph; tokens and launch counts of every run
   must equal the graphs mode's cold run (``[engine]`` lines carry the
   builds per role and bucket, capture seconds, cache hits/misses/
   compiles, the graphs' pool memory, tok/s, TTFT and peak memory);
5. generate: a left-padded batch of 4 on the same weights through
   ``generate(session=)``, twice per mode, through the contiguous
   decode kernel, held to the same rules; then a short engine drain
   under ``torch.profiler`` in each mode, after a first drain built
   its steps (device busy share of the window and of its decode
   steps alone, device time by kernel group);
6. the same engine, ``generate`` and profile phases on full-width,
   full-depth falcon-mamba-7b in bf16 (phi3's weights are freed first),
   through the selective-scan kernel: 64 launches per admission and per
   engine step;
7. exact tokens: on phi3-mini-3.8b-smoke and falcon-mamba-7b-smoke in
   float32, the engine's and ``generate``'s tokens through captured
   graphs, through the kernels run eagerly and through the plain
   PyTorch path must all be equal;
8. the thesis path (run after phase 3): conv2d, matmul and the
   block-sparse conv at the widths of thesis Table 4.1 (batch 1 and 32),
   the GEMM form of its 1x1 layers, phi3-mini's QKV projection and the
   Fig 6.2 layer at block densities 0-1, each against its plain version
   in bf16 and float32 (``[check]``; exact launch counts per call; the
   bf16 matmul's lines name the staging route of A and B), the blocks
   the tensor-core layouts pad (phi3's QKV at 128 x 128 and 128 x 256
   tiles, a 1x1 GEMM form with bn 13, conv-final with 40 output channels
   on 13 x 13 pixels, fire3 with 8 input channels read-modify-write), then
   ``[time]`` lines (kernel, plain, bound, library: ``F.conv2d``,
   ``torch.matmul``), the dense-vs-sparse ``[crossover]``, the 24 grid
   orders of initial-conf and the 6 of phi3's QKV GEMM (``[orders]``),
   and the main path: every
   shape through its ``*_dispatched`` entry point until the dispatch
   service commits (``[dispatch]``: candidates with predicted and
   measured medians, calls until commit, the committed schedule and the
   card's registry key it was written back under), with the launches
   the probed schedules make counted exactly.

The line before the last is the kernels' JSON summary, the last line
``{"ok": true, "device": {...}}``.
"""
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12                         # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per dtype
# exp on the special-function units: 16 a clock per SM, 132 SMs at the
# 1.98 GHz boost clock (the selective scan's exps bind it, not FMAs)
PEAK_EXP_PER_S = 132 * 16 * 1.98e9
# Kernel-vs-plain tolerance per element.  bf16: both sides accumulate in
# float32 and round once to bf16, so they may differ by the rounding of
# that last step; two bf16 ulps of |plain| (2**(floor(log2|x|) - 7))
# plus a float32-level floor for outputs near zero.  float32: absolute.
TOL = {"bfloat16": "2 ulp(|plain|) + 1e-5", "float32": 1e-5}
BF16_ULPS, BF16_FLOOR = 2, 1e-5
PHI3 = "phi3-mini-3.8b"
MAMBA = "falcon-mamba-7b"
NEW_TOKENS = 32
ENGINE_PROMPTS = [200, 17, 300, 150, 45, 260, 130, 77]
GENERATE_PROMPTS = [40, 100, 250, 300]
# engine and generate run with captured CUDA graphs (the default) and
# eagerly (capture=False), in this order, in every serve phase
MODES = ("graphs", "eager")


def fail(msg):
    """Stop the run: message on stderr, exit code 1, no result line."""
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def phase(tag, /, **fields):
    """Print one phase line, ending in the seconds since the start."""
    fields["at_s"] = f"{time.perf_counter() - T_START:.1f}"
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line():
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time in ms of one call, from CUDA events.

    Before each timed call the 50 MB L2 cache is flushed (a decode step
    finds the KV cache cold: 32 layers of it do not fit in L2; pass
    ``flush=False`` for a call whose inputs the kernels before it just
    wrote) and the stream is kept busy with a ~0.5 ms spin, so the host
    has enqueued the call before the start event fires: the events
    measure the device time of everything the call launches, not the
    host's Python around it."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch, device):
        """Allocate the flush buffer on ``device``."""
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.int32,
                                 device=device)

    def __call__(self, fn, iters=25, warmup=3, flush=True):
        """Median ms of ``fn()`` over ``iters`` calls."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            if flush:
                self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        ms = sorted(s.elapsed_time(e) for s, e in pairs)
        return ms[len(ms) // 2]


# Mangled-name patterns of the instantiations the bf16 main path runs
# (head_dim 96, MHA): flash's tensor-core body at D 96, the split decode
# body over the pool and over the contiguous cache.
MAIN_PATH_INSTANCES = {
    "flash_attention": r"flash_mma_kernelILi96E",
    "paged_decode_attention":
        r"decode_split_kernelI13__nv_bfloat16NS_7PagedKV",
    "decode_attention":
        r"decode_split_kernelI13__nv_bfloat16NS_8ContigKV",
    "ssm_scan": r"ssm_scan_kernelI13__nv_bfloat16Li16E",
    # the thesis kernels' bf16 bodies: the conv's implicit GEMM (dense,
    # and over the nonzero blocks), the matmul's wgmma at two warpgroups
    # and the widest wgmma (QKV's tile)
    "conv2d": r"conv2d_cu[^']*conv_mma_kernelILb0E",
    "sparse_conv2d": r"sparse_conv_cu[^']*conv_mma_kernelILb1E",
    "matmul": r"matmul_mma_kernelILi2ELi256E",
}
# The head_dim 256 instances (paligemma-3b, recurrentgemma-9b): flash's
# bf16 body with Q re-read from shared memory, its float32 body at 64
# dims a thread, the float32 split decode.
WIDE_INSTANCES = {
    "flash_attention_d256": r"flash_mma_kernelILi256E",
    "flash_attention_d224": r"flash_mma_kernelILi224E",
    "flash_attention_float32_d256": r"flash_fwd_kernelILi64E",
    "decode_attention_float32": r"decode_split_kernelIfNS_8ContigKV",
    "paged_decode_attention_float32": r"decode_split_kernelIfNS_7PagedKV",
}
# Entry functions whose SASS must (bf16) or must not (float32) hold
# tensor-core instructions, by name pattern.
SASS_BODIES = {
    "matmul_bf16": (r"matmul_mma_kernel", "HGMMA"),
    "conv2d_bf16": (r"conv2d_cu.*conv_mma_kernel", "HMMA"),
    "sparse_conv2d_bf16": (r"sparse_conv_cu.*conv_mma_kernel", "HMMA"),
    "flash_attention_bf16": (r"flash_mma_kernel", "HMMA"),
    "matmul_float32": (r"matmul_kernelIfLi", None),
    "conv2d_float32": (r"conv2d_cu.*conv_tile_kernelILi", None),
    "sparse_conv2d_float32": (r"sparse_conv_cu.*conv_tile_kernelILi", None),
    "flash_attention_float32": (r"flash_fwd_kernelILi", None),
}


def sass_counts(lib_path):
    """Per body of SASS_BODIES: entry functions, and the HGMMA, HMMA and
    FFMA instructions in their ``cuobjdump -sass``."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass: {out.stderr.strip()[:500]}")
    funcs = {}
    name = None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if re.search(r"\b" + op + r"\b", line):
                    funcs[name][op] += 1
    res = {}
    for body, (pattern, _) in SASS_BODIES.items():
        hit = [c for f, c in funcs.items() if re.search(pattern, f)]
        res[body] = {"functions": len(hit),
                     **{op: sum(c[op] for c in hit)
                        for op in ("HGMMA", "HMMA", "FFMA")},
                     "min_per_function": {
                         op: min((c[op] for c in hit), default=0)
                         for op in ("HGMMA", "HMMA")}}
    return res


def ptxas_stats(log, pattern):
    """Registers, spill stores and shared memory ptxas reported for the
    entry function matching ``pattern``."""
    m = re.search(r"Compiling entry function '[^']*" + pattern
                  + r"[^']*'.*?Used (\d+) registers", log, re.DOTALL)
    if not m:
        return {"registers": "not found"}
    tail = log[m.start():m.end() + 200]
    spill = re.search(r"(\d+) bytes spill stores", tail)
    smem = re.search(r"(\d+) bytes smem", tail)
    return {"registers": int(m.group(1)),
            "spill_store_bytes": int(spill.group(1)) if spill else 0,
            "smem_bytes": int(smem.group(1)) if smem else 0}


def tolerance_share(torch, got, want, peak=None):
    """(max abs error, worst error as a share of the element's
    tolerance ``TOL``); the check passes when the share is <= 1.  With
    ``peak`` (a read-modify-write schedule of the thesis kernels) the bf16
    ulps are those of the largest magnitude the element takes at any
    rounding point: a float32 sum in another order may round the other
    way at an intermediate point, and that step stays in the result."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = (want.float().abs() if peak is None else peak
               ).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        allowed = BF16_ULPS * ulp + BF16_FLOOR
    else:
        allowed = torch.full_like(diff, TOL["float32"])
    return diff.max().item(), (diff / allowed).max().item()


def bound(n_bytes, n_ops, dtype):
    """Least time (ms) for the work, and what bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


# (HQ, HKV, head_dim) beyond the main geometry: recurrentgemma-9b's 16
# query heads on one KV head and paligemma-3b's 8 at head_dim 256, and
# llama4-scout's group 5 at 128
WIDE_HEADS = ((16, 1, 256), (8, 1, 256), (40, 8, 128))


def plan_text(plan):
    """One decode plan as its launch shape."""
    return (f"splits={plan.splits} split_keys={plan.split_keys} "
            f"tile_keys={plan.tile_keys} head_chunk={plan.head_chunk} "
            f"chunks={plan.chunks} blocks={plan.blocks} smem={plan.smem}")


def wide_times(torch, dev, timer, rn):
    """``[time_wide]``: the three attention kernels at head_dim 256 with
    16 query heads on one KV head, bf16, beside their bound and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     paged_decode_attention)
    from repro_torch.kernels._geometry import decode_plan
    bf16, s, d, hq = torch.bfloat16, 544, 256, 16
    starts = [512 - n for n in GENERATE_PROMPTS]
    st = torch.tensor(starts, device=dev)
    q = rn((4, hq, 1, d), bf16)
    k, v = rn((4, 1, s, d), bf16), rn((4, 1, s, d), bf16)
    kpos = torch.arange(s, device=dev)[None, :]
    mask = ((kpos <= 512) & (kpos >= st[:, None]))[:, None, None, :]
    ctx = sum(512 - a + 1 for a in starts)
    b_ms, b_by = bound(2 * 4 * hq * d * 2 + ctx * d * 2 * 2 + 32,
                       4 * d * hq * ctx, "bfloat16")
    ms = timer(lambda: decode_attention(q, k, v, 512, starts=st))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    phase("time_wide", kernel="decode_attention",
          shape=f"q [4,{hq},1,{d}], k/v [4,1,{s},{d}] bf16, pos 512",
          ms=f"{ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
          library_ms=f"{lib_ms:.4f}",
          plan=repr(plan_text(decode_plan(4, hq, 1, d, s, 0, 2))))
    bs, mb = 16, 34
    nb = 1 + 4 * mb
    kp, vp = rn((nb, 1, bs, d), bf16), rn((nb, 1, bs, d), bf16)
    perm = torch.randperm(nb - 1, generator=torch.Generator()
                          .manual_seed(7)) + 1
    tables = perm.reshape(4, mb).to(torch.int32).to(dev)
    pos = torch.tensor([17, 100, 300, 511], dtype=torch.int32, device=dev)
    ctx = sum(p + 1 for p in pos.tolist())
    b_ms, b_by = bound(2 * 4 * hq * d * 2 + ctx * d * 2 * 2 + 4 * mb * 4,
                       4 * d * hq * ctx, "bfloat16")
    ms = timer(lambda: paged_decode_attention(q, kp, vp, tables, pos))
    phase("time_wide", kernel="paged_decode_attention",
          shape=f"q [4,{hq},1,{d}], pools [{nb},1,{bs},{d}] bf16, "
                f"pos={pos.tolist()}",
          ms=f"{ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
          library_ms="null",
          plan=repr(plan_text(decode_plan(4, hq, 1, d, mb * bs, bs, 2))))
    s, real = 512, 300
    qf = rn((1, hq, s, d), bf16)
    kf, vf = rn((1, 1, s, d), bf16), rn((1, 1, s, d), bf16)
    stf = torch.tensor([s - real], device=dev)
    fmask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    fmask = fmask & (torch.arange(s, device=dev)[None, :] >= s - real)
    # Q, K and V rows from the start, every O row
    b_ms, b_by = bound((real * (hq + 2) + s * hq) * d * 2 + 4,
                       4 * d * hq * real * (real + 1) // 2, "bfloat16")
    ms = timer(lambda: flash_attention(qf, kf, vf, starts=stf))
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        qf, kf, vf, attn_mask=fmask, enable_gqa=True))
    phase("time_wide", kernel="flash_attention",
          shape=f"q [1,{hq},{s},{d}], k/v [1,1,{s},{d}] bf16, starts "
                f"[{s - real}]",
          ms=f"{ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
          library_ms=f"{lib_ms:.4f}")


def kernel_checks(torch, dev, timer):
    """Phase 3: each kernel against its plain version; returns the
    per-kernel summary entries (launches filled in later)."""
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     paged_decode_attention, ssm_scan)
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels._geometry import decode_plan, scan_layout
    from repro_torch.kernels.ssm_scan import DEFAULT_BLOCK_D, ssm_scan_ref
    from repro_torch.models import bucket_length

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rn(shape, dtype):
        """Seeded normal tensor on the card."""
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    worst = {}          # kernel -> max abs error of its bf16 checks

    def check(name, got, want, shape):
        """Hold ``got`` against ``want`` at the dtype's tolerance, print
        one check line, fail on any element outside it."""
        dtype = str(want.dtype).replace("torch.", "")
        e, share = tolerance_share(torch, got, want)
        phase("check", kernel=name, dtype=dtype, shape=shape,
              max_abs_err=f"{e:.3g}", tol=repr(TOL[dtype]),
              worst_share_of_tol=f"{share:.3g}", ok=share <= 1.0)
        if share > 1.0:
            fail(f"{name} {dtype} {shape} disagrees with its plain "
                 f"version: max abs err {e}, {share:.3g}x the tolerance "
                 f"{TOL[dtype]}")
        if dtype == "bfloat16":
            worst[name] = max(worst.get(name, 0.0), e)

    summary = {}
    bf16, f32 = torch.bfloat16, torch.float32

    # ---- flash prefill: each engine admission is a batch-1 left-padded
    # prefill at its prompt's bucket; generate prefills [4, 512] with
    # the four prompts' starts.  bf16 at those shapes, float32 at the
    # main geometry (MHA, D 96) and at smoke shapes with GQA group 2.
    def flash_case(dtype, b, hq, hkv, s, d, starts=None, **kw):
        """Check flash against its plain version on fresh inputs."""
        q = rn((b, hq, s, d), dtype)
        k, v = rn((b, hkv, s, d), dtype), rn((b, hkv, s, d), dtype)
        if starts is not None:
            kw["starts"] = torch.as_tensor(starts, device=dev)
        check("flash_attention", flash_attention(q, k, v, **kw),
              flash_attention_ref(q, k, v, **kw),
              f"[{b},{hq},{s},{d}]/{hkv}kv " + " ".join(
                  f"{n}={x.tolist() if torch.is_tensor(x) else x}"
                  for n, x in kw.items()))

    for p in sorted(set(ENGINE_PROMPTS)):
        s = bucket_length(p)
        flash_case(bf16, 1, 32, 32, s, 96, starts=[s - p])
    # the engine's admissions at each prompt bucket (the longest prompt
    # of the bucket), kernel against SDPA
    for s in sorted({bucket_length(p) for p in ENGINE_PROMPTS}):
        real = max(p for p in ENGINE_PROMPTS if bucket_length(p) == s)
        q = rn((1, 32, s, 96), bf16)
        k, v = rn((1, 32, s, 96), bf16), rn((1, 32, s, 96), bf16)
        st = torch.tensor([s - real], device=dev)
        mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        mask = mask & (torch.arange(s, device=dev)[None, :] >= s - real)
        n_bytes = (3 * real + s) * 32 * 96 * 2 + 4
        b_ms, _ = bound(n_bytes, 4 * 96 * 32 * real * (real + 1) // 2,
                        "bfloat16")
        ms = timer(lambda: flash_attention(q, k, v, starts=st))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        phase("time_bucket", kernel="flash_attention",
              shape=f"[1,32,{s},96]", real_tokens=real, ms=f"{ms:.4f}",
              library_ms=f"{lib_ms:.4f}", bound_ms=f"{b_ms:.4f}")
    gstarts = [512 - n for n in GENERATE_PROMPTS]
    flash_case(bf16, 4, 32, 32, 512, 96, starts=gstarts)
    flash_case(f32, 1, 32, 32, 512, 96, starts=[212])
    flash_case(f32, 4, 32, 32, 512, 96, starts=gstarts)
    for s in (24, 64):
        flash_case(f32, 2, 4, 2, s, 16, starts=[0, s // 3])
        flash_case(f32, 2, 4, 2, s, 16, window=9)
    # head_dim 256 with 8 and 16 query heads on one KV head (paligemma-3b,
    # recurrentgemma-9b)
    for dtype in (bf16, f32):
        for hq in (8, 16):
            flash_case(dtype, 1, hq, 1, 512, 256, starts=[212])
    # timed at the largest engine prefill: [1, 32, 512, 96], 300 real
    s, real = 512, 300
    q = rn((1, 32, s, 96), bf16)
    k, v = rn((1, 32, s, 96), bf16), rn((1, 32, s, 96), bf16)
    st = torch.tensor([s - real], device=dev)
    mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    mask = mask & (torch.arange(s, device=dev)[None, :] >= s - real)
    # what the data needs: Q/K/V rows from the start, every O row
    n_bytes = (3 * real + s) * 32 * 96 * 2 + 4
    n_ops = 4 * 96 * 32 * real * (real + 1) // 2
    b_ms, b_by = bound(n_bytes, n_ops, "bfloat16")
    summary["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:155",
        launches=0, max_abs_err=worst["flash_attention"],
        ms=timer(lambda: flash_attention(q, k, v, starts=st)),
        plain_ms=timer(lambda: flash_attention_ref(q, k, v, starts=st)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask)),
        shape="q,k,v [1,32,512,96] bf16, causal, starts=[212]")

    # ---- paged decode: the engine's pool geometry (bs 16, 34 blocks a
    # row, 1 + rows * 34 blocks) at its row counts 1, 2 and 4, mixed
    # depths, shuffled tables.
    bs, mb = 16, 34

    def paged_inputs(dtype, hq, hkv, d, pos_list):
        """q, pools, shuffled tables and positions, one row per pos."""
        rows = len(pos_list)
        nb = 1 + rows * mb
        qd = rn((rows, hq, 1, d), dtype)
        kp, vp = rn((nb, hkv, bs, d), dtype), rn((nb, hkv, bs, d), dtype)
        perm = torch.randperm(nb - 1, generator=torch.Generator()
                              .manual_seed(7)) + 1
        tables = perm.reshape(rows, mb).to(torch.int32).to(dev)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        return qd, kp, vp, tables, pos

    def paged_case(dtype, hq, hkv, d, pos_list):
        """Check paged decode against its plain version; returns the
        inputs."""
        args = paged_inputs(dtype, hq, hkv, d, pos_list)
        check("paged_decode_attention", paged_decode_attention(*args),
              paged_decode_attention_ref(*args),
              f"[{len(pos_list)},{hq},1,{d}]/{hkv}kv pos={pos_list}")
        return args

    pos_list = [17, 100, 300, 511]
    for pl in ([300], [17, 511]):
        paged_case(bf16, 32, 32, 96, pl)
    pargs = paged_case(bf16, 32, 32, 96, pos_list)
    paged_case(f32, 32, 32, 96, pos_list)
    for pl in ([300], [17, 511]):
        paged_case(f32, 32, 32, 96, pl)
    paged_case(f32, 4, 2, 16, [0, 15, 16, 200])
    # head_dim 256 with 16 and 8 query heads on one KV head, and group 5
    # (llama4-scout: 40 on 8, head_dim 128)
    for dtype in (bf16, f32):
        for hq, hkv, d in WIDE_HEADS:
            paged_case(dtype, hq, hkv, d, [17, 300, 511, 0])
    ctx = sum(p + 1 for p in pos_list)
    n_bytes = (2 * 4 * 32 * 96 * 2 + ctx * 32 * 96 * 2 * 2
               + 4 * mb * 4 + 4 * 4)
    b_ms, b_by = bound(n_bytes, 4 * 96 * 32 * ctx, "bfloat16")
    summary["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:178",
        launches=0, max_abs_err=worst["paged_decode_attention"],
        ms=timer(lambda: paged_decode_attention(*pargs)),
        plain_ms=timer(lambda: paged_decode_attention_ref(*pargs)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape="q [4,32,1,96], pools [137,32,16,96] bf16, "
              "pos=[17,100,300,511]",
        plan=plan_text(decode_plan(4, 32, 32, 96, mb * bs, bs, 2)))

    # ---- contiguous decode: generate's cache [4, 32, 544, 96] at its
    # first decode step (pos 512) with the left-pad starts.
    s = 512 + NEW_TOKENS
    starts = [512 - n for n in GENERATE_PROMPTS]
    qd = rn((4, 32, 1, 96), bf16)
    kc, vc = rn((4, 32, s, 96), bf16), rn((4, 32, s, 96), bf16)
    st = torch.tensor(starts, device=dev)
    for p in (512, 530, s - 1):
        check("decode_attention", decode_attention(qd, kc, vc, p, starts=st),
              decode_attention_ref(qd, kc, vc, p, starts=st),
              f"[4,32,1,96] k/v [4,32,{s},96] pos={p} starts={starts}")
    q32, k32, v32 = (t.float() for t in (qd, kc, vc))
    check("decode_attention", decode_attention(q32, k32, v32, 512,
                                               starts=st),
          decode_attention_ref(q32, k32, v32, 512, starts=st),
          f"[4,32,1,96] k/v [4,32,{s},96] pos=512 starts={starts}")
    # each row's window inside one split of the plan (64 keys)
    pos_in = torch.tensor([510, 300, 40, 543], device=dev)
    st_in = torch.tensor([500, 260, 33, 530], device=dev)
    for dtype in (bf16, f32):
        q_, k_, v_ = (t.to(dtype) for t in (qd, kc, vc))
        check("decode_attention",
              decode_attention(q_, k_, v_, pos_in, starts=st_in),
              decode_attention_ref(q_, k_, v_, pos_in, starts=st_in),
              f"[4,32,1,96] k/v [4,32,{s},96] pos={pos_in.tolist()} "
              f"starts={st_in.tolist()}")
        for hq, hkv, d in WIDE_HEADS:
            qw = rn((4, hq, 1, d), dtype)
            kw_, vw = rn((4, hkv, s, d), dtype), rn((4, hkv, s, d), dtype)
            check("decode_attention",
                  decode_attention(qw, kw_, vw, 512, starts=st),
                  decode_attention_ref(qw, kw_, vw, 512, starts=st),
                  f"[4,{hq},1,{d}]/{hkv}kv k/v [4,{hkv},{s},{d}] pos=512 "
                  f"starts={starts}")
    qf = rn((3, 4, 1, 16), f32)
    kf, vf = rn((3, 2, 40, 16), f32), rn((3, 2, 40, 16), f32)
    posf = torch.tensor([5, 20, 39], device=dev)
    stf = torch.tensor([0, 11, 30], device=dev)
    check("decode_attention", decode_attention(qf, kf, vf, posf, starts=stf),
          decode_attention_ref(qf, kf, vf, posf, starts=stf),
          "[3,4,1,16]/2kv k/v [3,2,40,16] pos=[5,20,39] starts=[0,11,30]")
    p = 512
    ctx = sum(p - a + 1 for a in starts)
    kpos = torch.arange(s, device=dev)[None, :]
    dmask = ((kpos <= p) & (kpos >= st[:, None]))[:, None, None, :]
    n_bytes = 2 * 4 * 32 * 96 * 2 + ctx * 32 * 96 * 2 * 2 + 4 * 4 * 2
    b_ms, b_by = bound(n_bytes, 4 * 96 * 32 * ctx, "bfloat16")
    summary["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:69",
        launches=0, max_abs_err=worst["decode_attention"],
        ms=timer(lambda: decode_attention(qd, kc, vc, p, starts=st)),
        plain_ms=timer(lambda: decode_attention_ref(qd, kc, vc, p,
                                                    starts=st)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qd, kc, vc, attn_mask=dmask)),
        shape="q [4,32,1,96], k/v [4,32,544,96] bf16, pos 512, "
              "starts=[472,412,262,212]",
        plan=plan_text(decode_plan(4, 32, 32, 96, s, 0, 2)))
    wide_times(torch, dev, timer, rn)

    # ---- selective scan: each engine admission scans its prompt's
    # bucket at batch 1 (the pad prefix masked to x = 0 and b = 0, as the
    # model masks it), each engine step scans one token of every row
    # from its state (1, 2 or 4 rows), generate scans [4, 512] and then
    # 4 rows.  bf16 y at those shapes (the state is float32: 1e-5), then
    # float32 at the main geometry and at smoke shapes (Di 128, N 8).
    def scan_inputs(dtype, bt, s, di, n, real=None, h0=False):
        """x, dt, b, c, a, d, h0 as the model feeds the scan; ``real``
        (one per row) leaves that many real steps after a zero pad."""
        x = rn((bt, s, di), dtype)
        dt = F.softplus(rn((bt, s, di), f32) * 0.5 - 1.0)
        b, c = rn((bt, s, n), f32), rn((bt, s, n), f32)
        for i, r in enumerate(real or []):
            x[i, :s - r] = 0
            b[i, :s - r] = 0
        a = -torch.arange(1, n + 1, dtype=f32, device=dev).repeat(di, 1)
        d = rn((di,), dtype)
        # the engine's cache holds the state in the model dtype
        hh = rn((bt, di, n), dtype).float() if h0 else None
        return x, dt, b, c, a, d, hh

    def scan_case(dtype, bt, s, di, n, real=None, h0=False,
                  block_d=DEFAULT_BLOCK_D):
        """Check y and the final state against the plain version;
        returns the inputs."""
        args = scan_inputs(dtype, bt, s, di, n, real, h0)
        y, h = ssm_scan(*args, block_d=block_d)
        y_ref, h_ref = ssm_scan_ref(*args)
        shape = (f"[{bt},{s},{di}] N={n} h0={h0} block_d={block_d}"
                 + (f" real={real}" if real else ""))
        check("ssm_scan", y, y_ref, "y " + shape)
        check("ssm_scan", h, h_ref, "state " + shape)
        return args

    di, n = 8192, 16
    for p in sorted(set(ENGINE_PROMPTS)):
        scan_case(bf16, 1, bucket_length(p), di, n, real=[p])
    for rows in (1, 2, 4):
        dargs = scan_case(bf16, rows, 1, di, n, h0=True)
    scan_case(bf16, 4, 512, di, n, real=GENERATE_PROMPTS)
    scan_case(f32, 1, 512, di, n, real=[300])
    scan_case(f32, 4, 1, di, n, h0=True)
    scan_case(f32, 2, 24, 128, 8, real=[24, 10], block_d=32)
    scan_case(f32, 4, 1, 128, 8, h0=True, block_d=32)
    scan_case(f32, 2, 37, 100, 8, block_d=64)      # ragged tile and block

    def scan_bound(bt, s, di, n, x_bytes, real_steps, h0):
        """(ms, by) for one scan: x and dt of the real steps read, y
        written whole, a, d, b, c and the states; exps and float32
        operations of the real steps (a pad step's state stays 0)."""
        n_bytes = (real_steps * di * (x_bytes + 4) + bt * s * di * x_bytes
                   + real_steps * n * 8 + di * n * 4 + di * x_bytes
                   + bt * di * n * 4 * (2 if h0 else 1))
        work = real_steps * di * n
        t = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "exp": work / PEAK_EXP_PER_S,
             "float32": 6 * work / PEAK_OPS["float32"]}
        by = max(t, key=t.get)
        return t[by] * 1e3, "bytes" if by == "bytes" else "operations"

    def scan_plan(bt, block_d=DEFAULT_BLOCK_D):
        """The scan's launch at [bt, ., 8192], N 16, bf16: states a
        lane, threads a block, blocks, and the warps an SM holds when
        the grid is spread over the 132 SMs."""
        lay = scan_layout(block_d, n, 2)
        blocks = bt * -(-di // block_d)
        return (f"states_per_lane={lay.states_per_lane} "
                f"lanes={lay.lanes} threads={lay.threads} blocks={blocks} "
                f"warps_per_sm={blocks * lay.threads / 32 / 132:.2f} "
                f"smem={lay.smem}")

    # timed at the largest engine prefill: [1, 512, 8192], 300 real steps
    sargs = scan_inputs(bf16, 1, 512, di, n, real=[300])
    b_ms, b_by = scan_bound(1, 512, di, n, 2, 300, False)
    d_ms, _ = scan_bound(4, 1, di, n, 2, 4, True)
    # generate's prefill: [4, 512, 8192] with its four prompts
    gargs = scan_inputs(bf16, 4, 512, di, n, real=GENERATE_PROMPTS)
    g_ms, g_by = scan_bound(4, 512, di, n, 2, sum(GENERATE_PROMPTS), False)
    summary["ssm_scan"] = dict(
        name="ssm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan/kernel.py:59",
        launches=0, max_abs_err=worst["ssm_scan"],
        ms=timer(lambda: ssm_scan(*sargs)),
        # in the model, x and dt were just written by the kernels before
        # the scan (25 MB, within the 50 MB L2)
        ms_l2_warm=timer(lambda: ssm_scan(*sargs), flush=False),
        plain_ms=timer(lambda: ssm_scan_ref(*sargs), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bound_peak=f"max(bytes / 3.35 TB/s, exps / {PEAK_EXP_PER_S:.3g} "
                   f"a second on the SFUs, 6 float32 ops a state-step / "
                   f"67 TFLOP/s)",
        shape=f"x [1,512,8192] bf16, 300 real steps, N 16, block_d "
              f"{DEFAULT_BLOCK_D}",
        plan=scan_plan(1),
        decode_shape="x [4,1,8192] bf16, h0 [4,8192,16], N 16",
        decode_ms=timer(lambda: ssm_scan(*dargs)),
        decode_plain_ms=timer(lambda: ssm_scan_ref(*dargs)),
        decode_bound_ms=d_ms,
        generate_shape=f"x [4,512,8192] bf16, real steps "
                       f"{GENERATE_PROMPTS}, N 16",
        generate_ms=timer(lambda: ssm_scan(*gargs)),
        generate_plain_ms=timer(lambda: ssm_scan_ref(*gargs), iters=5),
        generate_bound_ms=g_ms, generate_bound_by=g_by)
    for e in summary.values():
        phase("time", kernel=e["name"], ms=f"{e['ms']:.4f}",
              plain_ms=f"{e['plain_ms']:.4f}",
              bound_ms=f"{e['bound_ms']:.4f}", bound_by=e["bound_by"],
              library_ms=("null" if e["library_ms"] is None
                          else f"{e['library_ms']:.4f}"),
              **({"plan": repr(e["plan"])} if "plan" in e else {}))
    e = summary["ssm_scan"]
    # block_d is the kernel's launch parameter: the two prefills and the
    # decode step at each
    for tag, args in (("prefill", sargs), ("generate", gargs),
                      ("decode", dargs)):
        by_bd = {}
        for bd in (32, 64, 128, 256):
            ms = timer(lambda: ssm_scan(*args, block_d=bd))
            by_bd[f"block_d_{bd}_ms"] = f"{ms:.4f}"
        phase("time_block_d", kernel=f"ssm_scan_{tag}", **by_bd)
    phase("time_l2_warm", kernel="ssm_scan", shape=repr(e["shape"]),
          ms=f"{e['ms_l2_warm']:.4f}")
    phase("time", kernel="ssm_scan_generate",
          shape=repr(e["generate_shape"]), ms=f"{e['generate_ms']:.4f}",
          plain_ms=f"{e['generate_plain_ms']:.4f}",
          bound_ms=f"{e['generate_bound_ms']:.4f}",
          bound_by=e["generate_bound_by"], library_ms="null",
          plan=repr(scan_plan(4)))
    phase("time", kernel="ssm_scan_decode", ms=f"{e['decode_ms']:.4f}",
          plain_ms=f"{e['decode_plain_ms']:.4f}",
          bound_ms=f"{e['decode_bound_ms']:.4f}", bound_by="bytes",
          library_ms="null", plan=repr(scan_plan(4)))
    return summary


# ---------------------------------------------------------------------------
# The thesis path: conv2d, matmul and the block-sparse conv, ranked by the
# H100 cost model and committed by the port's dispatch service
# ---------------------------------------------------------------------------

THESIS_BATCHES = (1, 32)
# phi3-mini's QKV projection at the engine's largest prefill bucket
QKV = (512, 9216, 3072)                  # m, n, k
SPARSE_DENSITIES = (0.0, 0.25, 0.5, 1.0)
DISPATCH_DENSITIES = (0.25, 1.0)
SPARSE_ZERO_BLOCK = {"oc": 16, "ic": 16}  # granularity the weights are zeroed at


def thesis_data(torch, dev):
    """Table 4.1 images [32, IC, H+KH-1, W+KW-1] and weights [OC, IC, KH,
    KW] from numpy seed 0 (weights scaled by 1/sqrt(IC KH KW), as a
    layer's init scales them, so outputs are O(1)); the QKV operands;
    the block-sparse layers' images.  Float32 on the card."""
    import numpy as np
    from repro_torch.configs.squeezenet_layers import TABLE_4_1
    from repro_torch.core.loopnest import ConvLayer
    rng = np.random.default_rng(0)

    def rn(shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                * np.float32(scale)).to(dev)

    conv = {}
    for name, l in TABLE_4_1.items():
        img = rn((max(THESIS_BATCHES), l.ic, l.h + l.kh - 1, l.w + l.kw - 1))
        wgt = rn((l.oc, l.ic, l.kh, l.kw), (l.ic * l.kh * l.kw) ** -0.5)
        conv[name] = (l, img, wgt)
    m, n, k = QKV
    qkv = (rn((m, k)), rn((k, n), k ** -0.5))
    sparse = {"fig6.2-128x128-25x25": ConvLayer(128, 128, 25, 25, 3, 3),
              "fire9-conv3x3-2": TABLE_4_1["fire9-conv3x3-2"]}
    simg = {name: rn((max(THESIS_BATCHES), l.ic, l.h + l.kh - 1,
                      l.w + l.kw - 1)) for name, l in sparse.items()}
    sw = {}
    for name, l in sparse.items():
        for d in SPARSE_DENSITIES:
            # zeroed as benchmarks/bench_sparsity.py zeroes them: a block
            # is dropped where a uniform draw is >= the density
            w = rng.standard_normal((l.oc, l.ic, l.kh, l.kw),
                                    dtype=np.float32) / np.float32(
                (l.ic * l.kh * l.kw) ** 0.5)
            boc, bic = SPARSE_ZERO_BLOCK["oc"], SPARSE_ZERO_BLOCK["ic"]
            drop = rng.random((l.oc // boc, l.ic // bic)) >= d
            for o, i in zip(*np.nonzero(drop)):
                w[o * boc:(o + 1) * boc, i * bic:(i + 1) * bic] = 0.0
            sw[(name, d)] = torch.from_numpy(w).to(dev)
    return {"conv": conv, "qkv": qkv, "sparse": sparse, "simg": simg,
            "sw": sw}


def gemm_shapes(data):
    """(label, a, b): the GEMM form of the four 1x1 Table 4.1 layers at
    batch 1 (a = weights [oc, ic], b = image [ic, h w]) and phi3-mini's
    QKV projection."""
    out = []
    for name, (l, img, wgt) in data["conv"].items():
        if l.kh == 1:
            out.append((name, wgt[:, :, 0, 0].contiguous(),
                        img[0].reshape(l.ic, -1).contiguous()))
    out.append(("phi3-qkv", *data["qkv"]))
    return out


def conv_bound(l, n, dtype, density=1.0):
    """(ms, by): image and output once, the nonzero weights once; 2 MACs
    of the nonzero blocks (tensor-core peak in bf16, CUDA-core in f32)."""
    eb = 2 if dtype == "bfloat16" else 4
    n_bytes = (n * l.ic * (l.h + l.kh - 1) * (l.w + l.kw - 1)
               + l.oc * l.ic * l.kh * l.kw * density
               + n * l.oc * l.h * l.w) * eb
    return bound(n_bytes, 2 * n * l.macs * density, dtype)


def thesis_checks(torch, dev, timer, data):
    """Each thesis kernel against its plain version at every shape of the
    path, in bf16 and float32: conv2d at the tuner's rank-0 schedule and
    one read-modify-write order (ic outermost) for every Table 4.1 layer
    at batch 1 and 32; matmul at rank-0, an RMW order and resident RHS
    on and off for the GEMM shapes; the block-sparse conv at densities
    0 to 1.  Launch counts exact per call.  Then the [time] lines, the
    [orders] sweep and the measured dense-vs-sparse crossover; returns
    the kernels' summary entries (launches filled in later)."""
    import torch.nn.functional as F
    from repro_torch.core import sparsity, tuner
    from repro_torch.kernels import _geometry as geo
    from repro_torch.kernels import conv2d, matmul, sparse_conv2d
    from repro_torch.kernels.conv2d import conv2d_plain, uses_scratch
    from repro_torch.kernels.matmul import matmul_plain, staging_route
    from repro_torch.kernels.matmul import uses_scratch as mm_scratch
    from repro_torch.kernels.sparse_conv import (analyze_weights,
                                                 sparse_conv_plain)

    worst = {}

    def check(name, got, want, shape, peak=None, launched=None, want_n=None):
        """One [check] line; fail outside the tolerance or on a launch
        count other than the schedule's."""
        dtype = str(want.dtype).replace("torch.", "")
        e, share = tolerance_share(torch, got, want, peak)
        fields = dict(kernel=name, dtype=dtype, shape=repr(shape),
                      max_abs_err=f"{e:.3g}", tol=repr(TOL[dtype]),
                      worst_share_of_tol=f"{share:.3g}")
        if peak is not None and dtype == "bfloat16":
            fields["share_of_final_value_tol"] = \
                f"{tolerance_share(torch, got, want)[1]:.3g}"
        if launched is not None:
            fields["launches"] = launched
        phase("check", **fields, ok=share <= 1.0)
        if share > 1.0:
            fail(f"{name} {dtype} {shape} disagrees with its plain version: "
                 f"max abs err {e}, {share:.3g}x the tolerance")
        if launched is not None and launched != want_n:
            fail(f"{name} {shape}: {launched} launches, want {want_n}")
        worst[name] = max(worst.get(name, 0.0), e)

    def counted(fn, wrapper):
        """fn() and the launches its wrapper counted."""
        before = wrapper.launches
        out = fn()
        torch.cuda.synchronize()
        return out, wrapper.launches - before

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    # ---- conv2d
    for name, (l, img32, wgt32) in data["conv"].items():
        for dname, dt in dtypes.items():
            eb = 2 if dname == "bfloat16" else 4
            for n in THESIS_BATCHES:
                rank0 = tuner.tune_conv(l, elem_bytes=eb, top_k=1,
                                        batch=n)[0][0]
                blk = rank0.block_dict()
                if blk["ic"] == l.ic:    # give the RMW order >= 2 passes
                    blk = dict(blk, ic=max(
                        d for d in range(1, l.ic) if l.ic % d == 0
                        and geo.conv_layout(blk["oc"], d, blk["y"], blk["x"],
                                            l.kh, l.kw, eb).error is None))
                scheds = [(rank0.grid_order, rank0.block_dict(), "rank0"),
                          (("ic", "oc", "y", "x"), blk, "rmw")]
                img, wgt = img32[:n].to(dt), wgt32.to(dt)
                for order, block, tag in scheds:
                    got, k = counted(lambda: conv2d(
                        img, wgt, block=block, grid_order=order), conv2d)
                    want, peak = conv2d_plain(img, wgt, block=block,
                                              grid_order=order,
                                              with_peak=True)
                    check("conv2d", got, want,
                          f"{name} N={n} {tag} {''.join(a[0] for a in order)}"
                          f" {block}", peak, k,
                          1 if uses_scratch(order) else l.ic // block["ic"])
    # ---- matmul
    for label, a32, b32 in gemm_shapes(data):
        m, k_ = a32.shape
        n = b32.shape[1]
        for dname, dt in dtypes.items():
            eb = 2 if dname == "bfloat16" else 4
            a, b = a32.to(dt), b32.to(dt)
            r0 = tuner.tune_matmul(m, n, k_, elem_bytes=eb, top_k=1)[0][0]
            blk = r0.block_dict()
            if blk["k"] == k_:
                blk = dict(blk, k=max(d for d in range(1, k_)
                                      if k_ % d == 0 and d <= 64))
            cases = [(r0.grid_order, r0.block_dict(), r0.resident_rhs,
                      "rank0"), (("k", "m", "n"), blk, False, "rmw")]
            for res in (False, True):
                cases.append((("m", "n", "k"), r0.block_dict(), res,
                              f"resident={res}"))
            for order, block, res, tag in cases:
                tile = geo.matmul_layout(block["m"], block["n"], block["k"],
                                         k_, eb, res)
                shape = (f"{label} [{m},{k_}]x[{k_},{n}] {tag} "
                         f"{''.join(order)} {block}")
                if tile.error is not None:
                    try:
                        matmul(a, b, block=block, grid_order=order,
                               resident_rhs=res)
                    except ValueError as e:
                        phase("check", kernel="matmul", dtype=dname,
                              shape=repr(shape), raises=repr(str(e)),
                              ok=True)
                        continue
                    fail(f"matmul {shape}: accepted a tile the kernel "
                         f"cannot take ({tile.error})")
                got, launched = counted(lambda: matmul(
                    a, b, block=block, grid_order=order, resident_rhs=res),
                    matmul)
                want, peak = matmul_plain(a, b, block=block,
                                          grid_order=order, resident_rhs=res,
                                          with_peak=True)
                if dname == "bfloat16":
                    ra, rb = staging_route(a, b)
                    shape += f" staging A:{ra} B:{rb}"
                check("matmul", got, want, shape, peak, launched,
                      1 if mm_scratch(order, res) else k_ // block["k"])
    # ---- bf16 edges the tensor-core layouts pad
    bf16 = torch.bfloat16
    gemms = {g[0]: g for g in gemm_shapes(data)}
    for label, block, order in (
            ("phi3-qkv", {"m": 128, "n": 128, "k": 64}, ("m", "n", "k")),
            ("phi3-qkv", {"m": 128, "n": 256, "k": 64}, ("n", "m", "k")),
            ("conv-final", {"m": 125, "n": 13, "k": 64}, ("m", "n", "k")),
            ("conv-final", {"m": 125, "n": 13, "k": 128}, ("k", "m", "n"))):
        _, a32, b32 = gemms[label]
        a, b = a32.to(bf16), b32.to(bf16)
        m, k_ = a.shape
        got, launched = counted(lambda: matmul(a, b, block=block,
                                               grid_order=order), matmul)
        want, peak = matmul_plain(a, b, block=block, grid_order=order,
                                  with_peak=True)
        tile = geo.matmul_mma_tile(block["m"], block["n"], block["k"], k_,
                                   False)
        ra, rb = staging_route(a, b)
        check("matmul", got, want,
              f"edge {label} [{m},{k_}]x[{k_},{b.shape[1]}] "
              f"{''.join(order)} {block} padded to {tile.bm_pad}x"
              f"{tile.bn_pad}, ks {tile.ks}, {tile.stages} stages, staging "
              f"A:{ra} B:{rb}", peak, launched,
              1 if mm_scratch(order, False) else k_ // block["k"])
    for name, block, order in (
            ("conv-final", {"oc": 40, "ic": 64, "y": 13, "x": 13},
             ("oc", "y", "x", "ic")),
            ("conv-final", {"oc": 40, "ic": 64, "y": 13, "x": 13},
             ("ic", "oc", "y", "x")),
            ("fire3-conv3x3-2", {"oc": 64, "ic": 8, "y": 5, "x": 11},
             ("ic", "oc", "y", "x"))):
        l, img32, wgt32 = data["conv"][name]
        tile = geo.conv_mma_tile(block["oc"], block["ic"], block["y"],
                                 block["x"], l.kh, l.kw)
        for n in THESIS_BATCHES:
            img, wgt = img32[:n].to(bf16), wgt32.to(bf16)
            got, k = counted(lambda: conv2d(img, wgt, block=block,
                                            grid_order=order), conv2d)
            want, peak = conv2d_plain(img, wgt, block=block,
                                      grid_order=order, with_peak=True)
            check("conv2d", got, want,
                  f"edge {name} N={n} {''.join(a[0] for a in order)} {block}"
                  f" padded to {tile.p16} pixels x {tile.boc16} oc x "
                  f"{tile.bic_pad} ic, {tile.warps} warps x {tile.rounds} "
                  f"rounds", peak, k,
                  1 if uses_scratch(order) else l.ic // block["ic"])

    # ---- block-sparse conv
    for name, l in data["sparse"].items():
        for d in SPARSE_DENSITIES:
            for dname, dt in dtypes.items():
                eb = 2 if dname == "bfloat16" else 4
                wgt = data["sw"][(name, d)].to(dt)
                for n in THESIS_BATCHES:
                    block = tuner.tune_sparse_conv(
                        l, d, elem_bytes=eb, top_k=1,
                        batch=n)[0][0].block_dict()
                    sp = analyze_weights(wgt, block)
                    img = data["simg"][name][:n].to(dt)
                    got, k = counted(lambda: sparse_conv2d(
                        img, wgt, block=block, sparsity=sp), sparse_conv2d)
                    check("sparse_conv2d", got,
                          sparse_conv_plain(img, wgt, sp.idx, sp.counts,
                                            block),
                          f"{name} N={n} density={d} block_density="
                          f"{sp.density:.3f} {block}", None, k, 1)

    # ---- [time]: every Table 4.1 layer at batch 32 and 1, bf16, rank-0
    summary = {}
    conv_ms = {}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    bound_share = {"bytes": 0.0, "operations": 0.0}
    for n in THESIS_BATCHES:
        for name, (l, img32, wgt32) in data["conv"].items():
            img, wgt = img32[:n].to(torch.bfloat16), wgt32.to(torch.bfloat16)
            s = tuner.tune_conv(l, elem_bytes=2, top_k=1, batch=n)[0][0]
            blk, order = s.block_dict(), s.grid_order
            t = dict(ms=timer(lambda: conv2d(img, wgt, block=blk,
                                             grid_order=order)),
                     plain_ms=timer(lambda: conv2d_plain(
                         img, wgt, block=blk, grid_order=order), iters=9),
                     library_ms=timer(lambda: F.conv2d(img, wgt)))
            t["bound_ms"], by = conv_bound(l, n, "bfloat16")
            conv_ms[(name, n)] = t["ms"]
            phase("time", kernel="conv2d", layer=name, batch=n,
                  dtype="bfloat16", schedule=repr(f"{''.join(a[0] for a in order)} {blk}"),
                  **{k: f"{v:.4f}" for k, v in t.items()}, bound_by=by)
            if n == max(THESIS_BATCHES):
                for k in tot:
                    tot[k] += t[k]
                bound_share[by] += t["bound_ms"]
    summary["conv2d"] = dict(
        name="conv2d", route="cuda",
        source="src/repro_torch/kernels/csrc/conv2d.cu",
        replaces="src/repro/kernels/conv2d/kernel.py:96", launches=0,
        max_abs_err=worst["conv2d"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"],
        bound_by=max(bound_share, key=bound_share.get),
        library_ms=tot["library_ms"],
        shape="sum over the 8 Table 4.1 layers at batch 32, bf16, each at "
              "the tuner's rank-0 schedule for batch 32; library F.conv2d "
              "(cuDNN)")
    for label, a32, b32 in gemm_shapes(data):
        m, k_ = a32.shape
        n = b32.shape[1]
        a, b = a32.to(torch.bfloat16), b32.to(torch.bfloat16)
        s = tuner.tune_matmul(m, n, k_, elem_bytes=2, top_k=1)[0][0]
        b_ms, b_by = bound((m * k_ + k_ * n + m * n) * 2, 2 * m * n * k_,
                           "bfloat16")
        t = dict(ms=timer(lambda: s.run(a, b)),
                 plain_ms=timer(lambda: matmul_plain(
                     a, b, block=s.block_dict(), grid_order=s.grid_order,
                     resident_rhs=s.resident_rhs)),
                 library_ms=timer(lambda: torch.matmul(a, b)))
        phase("time", kernel="matmul", shape=label, mnk=f"{m}x{n}x{k_}",
              dtype="bfloat16", schedule=repr(reg_dict(s)),
              **{k: f"{v:.4f}" for k, v in t.items()},
              bound_ms=f"{b_ms:.4f}", bound_by=b_by)
        if label == "phi3-qkv":
            summary["matmul"] = dict(
                name="matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/matmul.cu",
                replaces="src/repro/kernels/matmul/kernel.py:78", launches=0,
                max_abs_err=worst["matmul"], **t, bound_ms=b_ms,
                bound_by=b_by,
                shape=f"phi3-mini QKV [{m},{k_}]x[{k_},{n}] bf16, rank-0 "
                      f"{reg_dict(s)}; library torch.matmul (cuBLAS)")
    sparse_ms = {}
    for name, l in data["sparse"].items():
        for d in SPARSE_DENSITIES:
            img = data["simg"][name].to(torch.bfloat16)
            s = tuner.tune_sparse_conv(l, d, elem_bytes=2, top_k=1,
                                       batch=img.shape[0])[0][0]
            block = s.block_dict()
            wgt = data["sw"][(name, d)].to(torch.bfloat16)
            sp = analyze_weights(wgt, block)
            b_ms, b_by = conv_bound(l, img.shape[0], "bfloat16", sp.density)
            t = dict(ms=timer(lambda: sparse_conv2d(img, wgt, block=block,
                                                     sparsity=sp)),
                     plain_ms=timer(lambda: sparse_conv_plain(
                         img, wgt, sp.idx, sp.counts, block), iters=9),
                     library_ms=timer(lambda: F.conv2d(img, wgt)))
            sparse_ms[(name, d)] = (t["ms"], sp.density)
            phase("time", kernel="sparse_conv2d", layer=name,
                  batch=img.shape[0], dtype="bfloat16", density=d,
                  block_density=f"{sp.density:.3f}", block=repr(block),
                  **{k: f"{v:.4f}" for k, v in t.items()},
                  bound_ms=f"{b_ms:.4f}", bound_by=b_by)
            if name.startswith("fig6.2") and d == 0.25:
                summary["sparse_conv2d"] = dict(
                    name="sparse_conv2d", route="cuda",
                    source="src/repro_torch/kernels/csrc/sparse_conv.cu",
                    replaces="src/repro/kernels/sparse_conv/kernel.py:77",
                    launches=0, max_abs_err=worst["sparse_conv2d"], **t,
                    bound_ms=b_ms, bound_by=b_by,
                    shape=f"thesis Fig 6.2 layer (128x128, 25x25, 3x3) at "
                          f"batch 32, bf16, block density {sp.density:.3f}, "
                          f"block {block}; library F.conv2d on the zeroed "
                          f"weights")
        # the dense conv of the same layer, rank-0, for the crossover
        img = data["simg"][name].to(torch.bfloat16)
        wgt = data["sw"][(name, 1.0)].to(torch.bfloat16)
        s = tuner.tune_conv(l, elem_bytes=2, top_k=1,
                            batch=img.shape[0])[0][0]
        dense_ms = timer(lambda: s.run(img, wgt))
        # (block density, ms) of the sparse kernel; where it crosses the
        # dense kernel's time, linearly between the measured densities
        pts = sorted((v[1], v[0]) for k, v in sparse_ms.items()
                     if k[0] == name)
        measured = None
        for (d0, t0), (d1, t1) in zip(pts, pts[1:]):
            if d1 > d0 and t1 != t0 and (t0 - dense_ms) * (t1 - dense_ms) <= 0:
                measured = d0 + (dense_ms - t0) * (d1 - d0) / (t1 - t0)
                break
        if measured is None:
            measured = ("none: sparse never crosses dense"
                        if pts[0][1] > dense_ms else
                        "none: sparse below dense at every density")
        else:
            measured = f"{measured:.3f}"
        predicted = sparsity.crossover_density(
            l, tuner.tune_sparse_conv(l, 0.5, top_k=1,
                                      batch=img.shape[0])[0][0].block_dict(),
            batch=img.shape[0])
        phase("crossover", layer=name, batch=img.shape[0],
              dense_rank0_ms=f"{dense_ms:.4f}",
              sparse_ms=repr({f"{v[1]:.3f}": round(v[0], 4)
                              for k, v in sparse_ms.items()
                              if k[0] == name}),
              predicted_density=f"{predicted:.3f}",
              measured_density=measured)

    # ---- [orders]: all 24 grid orders of initial-conf at batch 32, bf16,
    # rank-0 blocks (thesis Fig 4.3 on the card)
    import itertools
    l, img32, wgt32 = data["conv"]["initial-conf"]
    img, wgt = img32.to(torch.bfloat16), wgt32.to(torch.bfloat16)
    blk = tuner.tune_conv(l, elem_bytes=2, top_k=1,
                          batch=32)[0][0].block_dict()
    by_order = {}
    for order in itertools.permutations(("oc", "ic", "y", "x")):
        by_order["".join(a[0] if a != "oc" else "o" for a in order)] = \
            timer(lambda: conv2d(img, wgt, block=blk, grid_order=order))
    best, worst_o = min(by_order.values()), max(by_order.values())
    phase("orders", layer="initial-conf", batch=32, dtype="bfloat16",
          block=repr(blk), n_ic=l.ic // blk["ic"],
          worst_over_best=f"{worst_o / best:.3f}",
          best=min(by_order, key=by_order.get),
          worst=max(by_order, key=by_order.get),
          ms=json.dumps({k: round(v, 4) for k, v in by_order.items()}))
    # the six grid orders of phi3's QKV GEMM at its rank-0 block: B
    # (56 MB) exceeds the 50 MB L2, so which tiles run together matters
    a, b = (x.to(torch.bfloat16) for x in data["qkv"])
    r0 = tuner.tune_matmul(*QKV, elem_bytes=2, top_k=1)[0][0]
    blk = r0.block_dict()
    mm_orders = {"".join(o): timer(lambda: matmul(a, b, block=blk,
                                                  grid_order=o))
                 for o in itertools.permutations(("m", "n", "k"))}
    phase("orders", kernel="matmul", shape="phi3-qkv", dtype="bfloat16",
          block=repr(blk), n_k=QKV[2] // blk["k"],
          worst_over_best=f"{max(mm_orders.values()) / min(mm_orders.values()):.3f}",
          best=min(mm_orders, key=mm_orders.get),
          worst=max(mm_orders, key=mm_orders.get),
          ms=json.dumps({k: round(v, 4) for k, v in mm_orders.items()}))
    return summary


def reg_dict(sched):
    """A schedule as its registry dict."""
    from repro_torch.core.registry import schedule_to_dict
    return schedule_to_dict(sched)


def thesis_dispatch(torch, dev, timer, data):
    """The thesis path's main path: every (layer, batch) through
    ``conv2d_dispatched`` in bf16 until its slot commits (the conv slot's
    problem holds the batch), each batch size with its own service and
    in-memory registry; the GEMM shapes through ``matmul_dispatched``; the sparse
    layers at densities 0.25 and 1.0 through ``sparse_conv2d_dispatched``.
    Launch counts are set to 0 just before and read just after, and must
    equal what the probed schedules launch.  Returns the counts."""
    from repro_torch import kernels
    from repro_torch.core import registry as reg
    from repro_torch.kernels.conv2d import conv2d_dispatched, uses_scratch
    from repro_torch.kernels.matmul import matmul_dispatched
    from repro_torch.kernels.matmul import uses_scratch as mm_scratch
    from repro_torch.kernels.sparse_conv import sparse_conv2d_dispatched
    from repro_torch.runtime.dispatch import DispatchService

    bf16 = torch.bfloat16
    calls = []           # (service, kind, problem, calls until commit)

    def drive(svc, kind, problem, call, label):
        """Call until the slot commits (at most 40 calls)."""
        n = 0
        while svc.committed(kind, problem, 2) is None:
            call()
            n += 1
            if n > 40:
                fail(f"dispatch {label}: no commit after 40 calls")
        calls.append((svc, kind, problem, n, label))

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    services = []
    for nb in THESIS_BATCHES:
        svc = DispatchService(reg.TuningRegistry(None), device=dev)
        services.append(svc)
        for name, (l, img32, wgt32) in data["conv"].items():
            img, wgt = img32[:nb].to(bf16), wgt32.to(bf16)
            problem = {"oc": l.oc, "ic": l.ic, "h": l.h, "w": l.w,
                       "kh": l.kh, "kw": l.kw, "n": nb}
            drive(svc, "conv2d", problem,
                  lambda: conv2d_dispatched(img, wgt, service=svc),
                  f"conv2d {name} N={nb}")
    svc = DispatchService(reg.TuningRegistry(None), device=dev)
    services.append(svc)
    for label, a32, b32 in gemm_shapes(data):
        a, b = a32.to(bf16), b32.to(bf16)
        problem = {"m": a.shape[0], "n": b.shape[1], "k": a.shape[1]}
        drive(svc, "matmul", problem,
              lambda: matmul_dispatched(a, b, service=svc),
              f"matmul {label}")
    for nb in THESIS_BATCHES:
        svc = DispatchService(reg.TuningRegistry(None), device=dev)
        services.append(svc)
        for name, l in data["sparse"].items():
            img = data["simg"][name][:nb].to(bf16)
            for d in DISPATCH_DENSITIES:
                wgt = data["sw"][(name, d)].to(bf16)
                dens = float((wgt != 0).float().mean())
                problem = {"oc": l.oc, "ic": l.ic, "h": l.h, "w": l.w,
                           "kh": l.kh, "kw": l.kw,
                           "density_16": reg.quantize_density(dens),
                           "n": nb}
                drive(svc, "sparse_conv", problem,
                      lambda: sparse_conv2d_dispatched(img, wgt,
                                                       service=svc),
                      f"sparse_conv {name} N={nb} density={d}")
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0

    card = reg.machine_key(services[0].spec, dev)
    cpu = reg.machine_key(services[0].spec, "cpu")
    want = {"conv2d": 0, "matmul": 0, "sparse_conv2d": 0}
    for svc, kind, problem, n, label in calls:
        key = svc.registry_key(kind, problem, 2)
        entry = svc.report()[key.canonical()]
        cands = svc.candidates(kind, problem, 2)
        for i, cnt in entry["samples"].items():
            c = cands[i]
            if kind == "conv2d":
                per = 1 if uses_scratch(c.grid_order) else \
                    problem["ic"] // c.block_dict()["ic"]
                want["conv2d"] += cnt * per
            elif kind == "matmul":
                per = 1 if mm_scratch(c.grid_order, c.resident_rhs) else \
                    problem["k"] // c.block_dict()["k"]
                want["matmul"] += cnt * per
            else:
                want["sparse_conv2d"] += cnt
        rec = svc.registry.get(key)
        written = (rec is not None and rec.measured is not None
                   and key.machine == card != cpu)
        if not written:
            fail(f"dispatch {label}: no measurement written back under "
                 f"the card's key {card}")
        med = entry["measured_median_s"]
        phase("dispatch", slot=repr(label), calls_until_commit=n,
              committed=repr(entry["committed"]),
              committed_is_rank0=entry["committed_rank"] == 0,
              candidates=json.dumps([
                  {"schedule": entry["candidates"][i],
                   "predicted_us": round(entry["predicted_s"][i] * 1e6, 3),
                   "measured_median_us": (None if med[i] is None
                                          else round(med[i] * 1e6, 3))}
                  for i in range(len(cands))]),
              written_back_under=card)
    for k, v in want.items():
        if counts[k] != v:
            fail(f"dispatch phase: {counts[k]} {k} launches, the probed "
                 f"schedules launch {v}")
        if counts[k] < 1:
            fail(f"dispatch phase launched no {k} kernel")
    others = {k: v for k, v in counts.items() if k not in want and v}
    if others:
        fail(f"dispatch phase launched other kernels: {others}")
    phase("thesis_path", slots=len(calls), seconds=f"{wall:.1f}",
          commits=sum(s.commits for s in services),
          launches=json.dumps({k: counts[k] for k in want}),
          launches_expected=json.dumps(want),
          card_key=card, cpu_key=cpu)
    # after the counts were read: device time of the committed schedule
    # against the cost model's rank-0, batch-32 conv slots and the GEMMs
    for svc, kind, problem, n, label in calls:
        if kind == "sparse_conv" or (kind == "conv2d" and "N=32" not in label):
            continue
        cands = svc.candidates(kind, problem, 2)
        committed = svc.committed(kind, problem, 2)
        if kind == "conv2d":
            name = label.split()[1]
            _, img32, wgt32 = data["conv"][name]
            args = (img32.to(bf16), wgt32.to(bf16))
        else:
            lab = label.split()[1]
            _, a32, b32 = next(g for g in gemm_shapes(data) if g[0] == lab)
            args = (a32.to(bf16), b32.to(bf16))
        r0 = timer(lambda: cands[0].run(*args))
        cm_ = timer(lambda: committed.run(*args))
        phase("dispatch_gain", slot=repr(label), rank0_ms=f"{r0:.4f}",
              committed_ms=f"{cm_:.4f}", rank0_over_committed=f"{r0 / cm_:.3f}")
    return {k: counts[k] for k in want}


def free_card(torch):
    """Drop what the last phase left and give the allocator's cache back,
    so the next phase's peak memory is its own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def step_report(session, mode, want, label):
    """Check that every step of ``session`` ran as ``mode`` says (in
    graphs mode each cached step holds a graph, none without) and that
    its steps' replays per role equal ``want``; returns (builds as
    ``role[bB,tL]``, captures, graph pool GiB, cache ``hits/misses/
    compiles``)."""
    cache = session.exec_cache
    replays = {"prefill": 0, "decode": 0}
    builds, captures = [], 0
    for k in cache.compiled_log:
        step = cache.peek(k)
        if step is None:
            fail(f"{label}: step {k} was evicted (cache capacity "
                 f"{cache.capacity})")
        if (step.graph is not None) != (mode == "graphs"):
            fail(f"{label}: step {k} has graph={step.graph is not None} "
                 f"in {mode} mode")
        captures += step.graph is not None
        replays[k.role] += step.replays
        builds.append(f"{k.role}[b{k.batch},t{k.length}]")
    if replays != want:
        fail(f"{label}: steps replayed {replays}, want {want}")
    pool = sum(cache.peek(k).pool_bytes for k in cache.compiled_log)
    return (builds, captures, f"{pool / 2 ** 30:.3f}",
            f"{cache.hits}/{cache.misses}/{cache.compiles}")


def profile_engine(torch, model, params, prompts, mode):
    """One short engine drain (4 requests, 16 new tokens) under
    ``torch.profiler``, after a first drain of the same requests has
    built (in graphs mode captured) every step outside the window: the
    device's busy share of the wall time and the kernels that take the
    device time (launches here are not counted as the main path's: the
    counts were read before).  The four requests are admitted at the
    first step boundary, so the trace from the end of decode step 1 to
    the end of step 15 (``decode_window``, a ``record_function`` range
    opened and closed by ``on_step``) holds decode steps only: the
    kernels' device time inside it over its length is the decode
    steps' busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.serving import ServeSession

    free_card(torch)
    session = ServeSession(model, params, backend="cuda", batch_sizes=(4,),
                           capture=mode == "graphs")
    window = {}

    def on_step(info):
        """Open the decode window after step 1, close it after 15."""
        if info["step"] == 1:
            window["range"] = record_function("decode_window")
            window["range"].__enter__()
        elif info["step"] == 15:
            window.pop("range").__exit__(None, None, None)

    def serve(mark=False):
        """Submit the four requests and drain them."""
        for i, p in enumerate(prompts):
            session.submit(p, 16, request_id=f"p{i}")
        session.drain(on_step=on_step if mark else None)
        torch.cuda.synchronize()

    serve()
    steps0 = session.stats.steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(mark=True)
        wall_us = (time.perf_counter() - t0) * 1e6
    if window:
        fail(f"{model.cfg.name} profile ({mode}): the drain ended before "
             f"decode step 15")

    def dev_us(e):
        """Self device time of one averaged event, in us."""
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # the range's own device-side annotation is no kernel
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0
            and e.key != "decode_window"]
    total = sum(dev_us(e) for e in kern)
    if not kern:
        phase("profile", arch=model.cfg.name, mode=mode, device_events=0,
              note="the profiler recorded no device time")
        return
    groups = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kern:
        n = e.key.lower()
        if any(t in n for t in ("flash_mma_kernel", "flash_fwd_kernel",
                                "decode_split_kernel", "ssm_scan_kernel")):
            groups["port_kernels"] += dev_us(e)
        elif any(t in n for t in ("gemm", "gemv", "nvjet", "cutlass")):
            groups["gemm"] += dev_us(e)
        else:
            groups["other"] += dev_us(e)
    steps = session.stats.steps - steps0
    phase("profile", arch=model.cfg.name, mode=mode,
          window="4_requests_x_16_tokens", wall_ms=f"{wall_us / 1e3:.1f}",
          device_ms=f"{total / 1e3:.1f}",
          device_busy_share=f"{total / wall_us:.3f}",
          **decode_window_busy(prof, DeviceType),
          steps=steps, kernels_launched=sum(e.count for e in kern),
          **{f"{g}_ms": f"{t / 1e3:.2f}" for g, t in groups.items()})
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        phase("profile_top", mode=mode, kernel=repr(e.key[:70]),
              calls=e.count, device_ms=f"{dev_us(e) / 1e3:.3f}",
              share=f"{dev_us(e) / total:.3f}")


def decode_window_busy(prof, DeviceType):
    """Fields of the trace's ``decode_window`` range: its length, the
    device time of the kernels inside it (each clipped to the range;
    the range's own device-side annotation, which spans them, is left
    out) and their ratio, the decode steps' busy share (14 steps)."""
    spans = [e.time_range for e in prof.events()
             if e.name == "decode_window"
             and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        return {"decode_window": f"{len(spans)}_ranges_in_the_trace"}
    lo, hi = spans[0].start, spans[0].end
    busy = sum(max(0.0, min(e.time_range.end, hi)
                   - max(e.time_range.start, lo))
               for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name != "decode_window")
    return {"decode_window_ms": f"{(hi - lo) / 1e3:.2f}",
            "decode_window_device_ms": f"{busy / 1e3:.2f}",
            "decode_window_busy_share": f"{busy / (hi - lo):.3f}"}


def prompts_of(lengths, vocab, seed):
    """Random prompts of the given lengths (numpy, from ``seed``)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def engine_run(torch, model, params, prompts, backend, capture, **kw):
    """Serve ``prompts`` through a fresh ServeSession; returns
    (results by id, session)."""
    from repro_torch.serving import ServeSession
    session = ServeSession(model, params, backend=backend,
                           batch_sizes=(1, 2, 4), capture=capture, **kw)
    for i, p in enumerate(prompts):
        session.submit(p, NEW_TOKENS, request_id=f"r{i}")
    res = {r.request_id: r for r in session.drain()}
    torch.cuda.synchronize()
    return res, session


def main():
    """Run every phase on the card; exit non-zero on the first failure."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    phase("device", kind=repr(name), count=count, smi=repr(smi),
          torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    _build.load()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          sources=len(_build.sources()))
    for kernel, pattern in {**MAIN_PATH_INSTANCES,
                            **WIDE_INSTANCES}.items():
        phase("ptxas", kernel=kernel, **ptxas_stats(_build.build_log,
                                                     pattern))
    for body, c in sass_counts(_build.lib_path).items():
        phase("sass", body=body, functions=c["functions"],
              hgmma=c["HGMMA"], hmma=c["HMMA"], ffma=c["FFMA"],
              min_per_function=json.dumps(c["min_per_function"]))
        op = SASS_BODIES[body][1]
        if c["functions"] < 1:
            fail(f"[sass] no entry function of {body} in the library")
        if op is not None and c["min_per_function"][op] < 1:
            fail(f"[sass] an entry function of {body} has no {op}: the "
                 f"tensor cores do not carry it")
        if op is None and c["HGMMA"] + c["HMMA"]:
            fail(f"[sass] the {body} body holds tensor-core instructions")
    dev = torch.device("cuda")
    t_run = time.perf_counter()
    summary = run(torch, dev, Timer(torch, dev), smi)
    phase("done", seconds=f"{time.perf_counter() - t0:.1f}",
          phases_seconds=f"{time.perf_counter() - t_run:.1f}")
    print(json.dumps({"kernels": list(summary.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}))


def engine_phase(torch, model, params, prompts, mode, smi):
    """Serve ``prompts`` twice through one session in ``mode``: the first
    (cold) drain builds every step, captured as CUDA graphs in graphs
    mode, the second (warm) must build nothing.  Each drain's launch
    counts are set to 0 just before it and read just after; one
    ``[engine]`` line each.  Returns {drain: tokens, counts, stats}."""
    from repro_torch import kernels
    from repro_torch.serving import ServeSession, SessionStats

    arch = model.cfg.name
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    session = ServeSession(model, params, backend="cuda",
                           batch_sizes=(1, 2, 4), capture=mode == "graphs")
    want = {"prefill": 0, "decode": 0}
    out = {}
    for drain in ("cold", "warm"):
        session.stats = SessionStats()          # this drain's numbers
        built = session.exec_cache.compiles
        for i, p in enumerate(prompts):
            session.submit(p, NEW_TOKENS, request_id=f"r{i}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = {r.request_id: r for r in session.drain()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        bad = [r for r in res.values()
               if r.state != "COMPLETED" or len(r.tokens) != NEW_TOKENS]
        if len(res) != len(prompts) or bad:
            fail(f"{arch} engine ({mode}, {drain}): {len(res)} results, "
                 f"not completed: "
                 f"{[(r.request_id, r.state, r.reason) for r in bad]}")
        if drain == "warm" and session.exec_cache.compiles != built:
            fail(f"{arch} engine ({mode}): the warm drain built "
                 f"{session.exec_cache.compiles - built} steps")
        st = session.stats.to_dict()
        want["prefill"] += st["inflight_admissions"]
        want["decode"] += st["steps"]
        builds, captures, pool_gib, cache = step_report(
            session, mode, want, f"{arch} engine ({mode}, {drain})")
        step_ms = 1e3 * st["decode_s"] / max(st["steps"], 1)
        phase("engine", arch=arch, mode=mode, drain=drain, card=repr(smi),
              requests=st["requests"], steps=st["steps"],
              admissions=st["inflight_admissions"],
              activations=st["batches"],
              ttft_p50_s=f"{st['ttft_p50_s']:.4f}",
              ttft_p95_s=f"{st['ttft_p95_s']:.4f}",
              decode_tok_s=f"{st['decode_tok_s']:.1f}",
              prefill_s=f"{st['prefill_s']:.3f}",
              decode_s=f"{st['decode_s']:.3f}",
              step_ms=f"{step_ms:.2f}",
              wall_s=f"{wall:.2f}",
              e2e_tok_s=f"{st['tokens_generated'] / wall:.1f}",
              captures=captures, builds=json.dumps(builds),
              capture_s=f"{st['capture_s']:.2f}",
              cache_hits_misses_compiles=cache, graph_pool_gib=pool_gib,
              peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}",
              peak_reserved_gib=f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f}",
              launches=json.dumps(counts))
        out[drain] = {"tokens": {k: v.tokens.tolist()
                                 for k, v in res.items()},
                      "counts": counts, "stats": st}
    del session, res
    return out


def generate_phase(torch, model, params, mode, smi):
    """A left-padded batch of 4 through ``generate(session=)`` twice in
    ``mode`` (cold: builds both steps; warm: must build nothing); counts
    set to 0 just before each call and read just after; one
    ``[generate]`` line each.  Returns {call: tokens, counts}."""
    from repro_torch import kernels
    from repro_torch.models import left_pad_prompts, prompt_starts
    from repro_torch.runtime import generate
    from repro_torch.serving import ServeSession

    cfg = model.cfg
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    session = ServeSession(model, params, backend="cuda",
                           capture=mode == "graphs")
    gp = prompts_of(GENERATE_PROMPTS, cfg.vocab_size, seed=2)
    toks = left_pad_prompts(gp, 512)
    starts = prompt_starts(gp, 512)
    out = {}
    for n, call in enumerate(("cold", "warm"), start=1):
        built = session.exec_cache.compiles
        capture_s = session.stats.capture_s
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tokens, gstats = generate(model, params, {"tokens": toks},
                                  max_new_tokens=NEW_TOKENS,
                                  seq_starts=starts, session=session)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        if tokens.shape != (4, NEW_TOKENS) or tokens.min() < 0 \
                or tokens.max() >= cfg.vocab_size:
            fail(f"{cfg.name} generate ({mode}): bad tokens {tokens.shape} "
                 f"{tokens.min()}..{tokens.max()}")
        if call == "warm" and session.exec_cache.compiles != built:
            fail(f"{cfg.name} generate ({mode}): the warm call built a step")
        builds, captures, pool_gib, cache = step_report(
            session, mode, {"prefill": n, "decode": n * (NEW_TOKENS - 1)},
            f"{cfg.name} generate ({mode}, {call})")
        phase("generate", arch=cfg.name, mode=mode, call=call, batch=4,
              prompt_len=512, new_tokens=NEW_TOKENS, card=repr(smi),
              prefill_s=f"{gstats.prefill_s:.3f}",
              decode_tok_s=f"{gstats.decode_tok_s:.1f}",
              step_ms=f"{1e3 * gstats.decode_s / (NEW_TOKENS - 1):.2f}",
              wall_s=f"{wall:.2f}",
              e2e_tok_s=f"{gstats.tokens_generated / wall:.1f}",
              captures=captures, builds=json.dumps(builds),
              capture_s=f"{session.stats.capture_s - capture_s:.2f}",
              cache_hits_misses_compiles=cache, graph_pool_gib=pool_gib,
              peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}",
              peak_reserved_gib=f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f}",
              launches=json.dumps(counts))
        out[call] = {"tokens": tokens, "counts": counts}
    del session
    return out


def same_runs(arch, what, runs):
    """Fail unless every mode and drain of ``runs`` ({mode: {drain:
    {"tokens", "counts"}}}) gave the tokens and the launch counts of the
    graphs mode's cold run, request for request and path for path."""
    import numpy as np
    ref = runs["graphs"]["cold"]
    for mode, by_drain in runs.items():
        for drain, r in by_drain.items():
            if isinstance(ref["tokens"], dict):
                same = r["tokens"] == ref["tokens"]
            else:
                same = np.array_equal(r["tokens"], ref["tokens"])
            if not same:
                fail(f"{arch} {what}: {mode} {drain} tokens differ from "
                     f"the graphs' cold run")
            if r["counts"] != ref["counts"]:
                fail(f"{arch} {what}: {mode} {drain} launches "
                     f"{r['counts']} differ from the graphs' cold run "
                     f"{ref['counts']}")
    phase("same_tokens_and_launches", arch=arch, path=what,
          runs=sum(len(v) for v in runs.values()), equal=True)


def serve_phases(torch, dev, smi, arch):
    """Engine, generate and profile phases on full-size ``arch`` in its
    own dtype with random weights from seed 0, each in graphs mode
    (captured steps, the default) and eager mode (``capture=False``) in
    this call: tokens and launch counts must agree between them.
    Returns the graphs mode's cold counts with its engine stats (the
    weights are freed on return)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    phase("init", arch=cfg.name, params=n_params,
          gib=f"{torch.cuda.memory_allocated() / 2 ** 30:.2f}",
          seconds=f"{time.perf_counter() - t0:.1f}")
    prompts = prompts_of(ENGINE_PROMPTS, cfg.vocab_size, seed=1)
    engine = {m: engine_phase(torch, model, params, prompts, m, smi)
              for m in MODES}
    same_runs(cfg.name, "engine", engine)
    gen = {m: generate_phase(torch, model, params, m, smi) for m in MODES}
    same_runs(cfg.name, "generate", gen)
    for m in MODES:
        profile_engine(torch, model, params, prompts[:4], m)
    cold = engine["graphs"]["cold"]
    return {"engine": cold["counts"],
            "generate": gen["graphs"]["cold"]["counts"],
            "stats": cold["stats"]}


def exact_tokens(torch, dev, arch):
    """Smoke config in float32: the engine's and generate's tokens
    through captured graphs, through the kernels run eagerly and through
    the plain PyTorch path must all be equal."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import (build_model, left_pad_prompts,
                                    prompt_starts)
    from repro_torch.runtime import generate

    scfg = get_config(arch)
    smodel = build_model(scfg)
    sparams = smodel.init(seed=0, device=dev)
    sprompts = prompts_of([5, 7, 3, 6, 12, 9], scfg.vocab_size, seed=3)
    stoks = left_pad_prompts(sprompts[:4], 8)
    sst = prompt_starts(sprompts[:4], 8)
    paths = {"graphs": ("cuda", True), "eager": ("cuda", False),
             "plain": ("plain", False)}
    streams, g = {}, {}
    kernels.reset_launch_counts()
    for name, (backend, capture) in paths.items():
        r, session = engine_run(torch, smodel, sparams, sprompts, backend,
                                capture, kv_block_size=4)
        streams[name] = {k: v.tokens.tolist() for k, v in r.items()}
        graphs = [session.exec_cache.peek(k).graph is not None
                  for k in session.exec_cache.compiled_log]
        if graphs != [capture] * len(graphs) or not graphs:
            fail(f"{arch} {name}: steps captured {graphs}")
        g[name] = generate(smodel, sparams, {"tokens": stoks},
                           max_new_tokens=12, backend=backend,
                           seq_starts=sst, capture=capture)[0]
    for name in paths:
        if streams[name] != streams["plain"]:
            fail(f"{arch} engine tokens through {name} differ from the "
                 f"plain path")
        if not (g[name] == g["plain"]).all():
            fail(f"{arch} generate tokens through {name} differ from the "
                 f"plain path")
    used = {k: v for k, v in kernels.launch_counts().items() if v}
    if not used:
        fail(f"{arch}: the cuda backend launched no kernel")
    phase("exact_tokens", arch=scfg.name, dtype="float32",
          paths=json.dumps(list(paths)), engine_requests=len(sprompts),
          generate_rows=4, equal=True, kernels=json.dumps(used))


def run(torch, dev, timer, smi):
    """Phases 3-7 on ``dev``; returns the kernels' summary entries."""
    from repro_torch.configs import get_config

    summary = kernel_checks(torch, dev, timer)

    # ---- the thesis path: checks and times first (they build and warm
    # every kernel), then the dispatched main path with its counts
    data = thesis_data(torch, dev)
    summary.update(thesis_checks(torch, dev, timer, data))
    thesis = thesis_dispatch(torch, dev, timer, data)
    for k, v in thesis.items():
        summary[k]["launches"] = v
    del data
    free_card(torch)

    # ---- phi3-mini-3.8b: flash prefill, paged and contiguous decode
    phi3 = serve_phases(torch, dev, smi, PHI3)
    ec, gen, st = phi3["engine"], phi3["generate"], phi3["stats"]
    for k in ("flash_attention", "paged_decode_attention"):
        if ec[k] < 1:
            fail(f"{PHI3} engine ran no {k} kernel: {ec}")
    if gen["decode_attention"] < 1 or gen["flash_attention"] < 1:
        fail(f"{PHI3} generate ran no decode/flash kernel: {gen}")
    for k in ("flash_attention", "paged_decode_attention",
              "decode_attention"):
        summary[k]["launches"] = ec[k] + gen[k]
    phase("launches_per_engine_step", arch=PHI3,
          paged_decode_attention=ec["paged_decode_attention"]
          / max(st["steps"], 1),
          flash_attention_per_admission=ec["flash_attention"]
          / max(st["inflight_admissions"], 1))
    free_card(torch)

    # ---- falcon-mamba-7b: the selective scan at every layer of every
    # admission, engine step and generate step
    n_layers = get_config(MAMBA).n_layers
    mamba = serve_phases(torch, dev, smi, MAMBA)
    ec, gen, st = mamba["engine"], mamba["generate"], mamba["stats"]
    want = n_layers * (st["inflight_admissions"] + st["steps"])
    if ec["ssm_scan"] != want:
        fail(f"{MAMBA} engine: {ec['ssm_scan']} ssm_scan launches, want "
             f"{n_layers} x ({st['inflight_admissions']} admissions + "
             f"{st['steps']} steps) = {want}")
    if gen["ssm_scan"] != n_layers * NEW_TOKENS:
        fail(f"{MAMBA} generate: {gen['ssm_scan']} ssm_scan launches, want "
             f"{n_layers} x {NEW_TOKENS}")
    summary["ssm_scan"]["launches"] = ec["ssm_scan"] + gen["ssm_scan"]
    phase("launches_per_engine_step", arch=MAMBA,
          ssm_scan=(ec["ssm_scan"] - n_layers * st["inflight_admissions"])
          / max(st["steps"], 1), ssm_scan_per_admission=n_layers,
          engine_total=ec["ssm_scan"], generate_total=gen["ssm_scan"])
    free_card(torch)

    for arch in (PHI3 + "-smoke", MAMBA + "-smoke"):
        exact_tokens(torch, dev, arch)
    return summary


def _leaves(tree):
    """Tensors of a nested parameter dict."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
