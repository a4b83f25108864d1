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
   (``[time_bucket]``, at 64 and at 128 query rows a block); then every
   schedule the tuner offers at the main-path shapes (flash's row
   blocks, both decode kernels' splits, the scan's block_d) against the
   plain version, and ``[time_schedule]``: each candidate's kernel ms
   beside the cost model's predicted ms;
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
   decode kernel, held to the same rules; then ``[faults]``: on fresh
   sessions with graphs over the engine's 8 requests, ``nan@5.1`` (one
   request FAILED with partial tokens, its row's device finite flag 0),
   a cancel of a running request at step 3 and of a queued one, a
   deadline blown mid-decode (a fake session clock), ``max_queue_s``
   shedding the requests still queued, for phi3 ``alloc@31x3`` and
   ``doublefree@31`` (31: the first boundary where a row frees),
   ``slow@8`` (one straggler, admission held for two boundaries),
   ``compile@0`` (one retry) and ``compile@0x3`` with two retries
   (``drain`` must raise ``InjectedFault``); every untouched request
   keeps the engine phase's tokens, a retired one a prefix of them,
   and each scenario launches one kernel a layer per admission and per
   step; ``[lifecycle_overhead]``: warm drains with and without
   ``request_deadline_s=3600`` and an empty injector, in turns (step
   ms, not gated); ``[batched]``: the 8 requests through
   ``_drain_batched`` at batch sizes (1, 2, 4), greedy and sampled at
   T=0.8, cold then warm (the warm drain builds nothing), each greedy
   request equal to ``generate`` on its group, the pad rows of a group
   smaller than its bucket finite, two sampled drains equal and a
   generator seeded 1 other tokens; tok/s, TTFT and steps beside the
   engine's warm drain; then a short engine drain
   under ``torch.profiler`` in each mode, after a first drain built
   its steps (device busy share of the window and of its decode
   steps alone, device time by kernel group); then ``[dispatch_serve]``:
   the engine's 8 requests drained with graphs and a
   ``DispatchService`` on a temporary registry file (batch size 4
   only), gated: the decode slot commits, recaptures <= commits seen
   and <= max_recompiles, the launch parameters every captured step
   recorded are its bundle's (the decode step's the committed
   schedule), a second drain builds nothing, and a fresh service over
   the file makes no cost-model evaluation and starts its first decode
   graph on the persisted winner; per slot the candidates, predicted
   and host-measured medians, calls until commit, the committed
   schedule and its ``[time_schedule]`` ms; tok/s and step ms beside
   the graphs run without dispatch, whose tokens it is compared with
   (reported, not gated: another split may round bf16 differently);
   then the engine phase's batch sizes (1, 2, 4), where the
   dispatch-aware bucket choice weighs its candidates: a session on
   the warm service and one without dispatch drain cold then warm, and
   the buckets each picked, steps, tok/s and token agreement are
   reported; then ``[telemetry_overhead]``: warm drains of the 8
   requests in turns on one session, telemetry off / on / on / off at
   batch sizes (1, 2, 4), then on a session with a ``DispatchService``
   at batch size 4 the watchdog and flight recorder unbound / bound /
   bound / unbound over telemetry; every
   drain's decode-step and boundary medians printed, the smaller of
   the two pairs' on / off ratios gated at <= 1.05, the healthy drains
   gated at 0 drifts, 0 SLO pages, 0 postmortems and equal tokens,
   and two more drains with ``perf_counter`` around the watchdog's and
   the recorder's taps (bound, then unbound), each tap's µs per step
   and median and largest call, and the collector's passes, printed;
   ``[trace_artifacts]``: one drain's trace, Prometheus text and
   lifecycle JSON, accepted by ``tools/check_trace.py`` in a
   subprocess (span and event counts printed); ``[watchdog_drift]``: a
   dispatched engine at batch size 4 drains once clean (the step the
   decode slot commits at, ``c``), then on a fresh service with
   ``slow@(c+8)x4``, a watchdog (ratio 3, patience 2) and a recorder:
   the drift alarm within patience steps of the fault, the reopen, the
   re-commit and ``postmortem-drift.json`` naming the slot and both
   schedules are gated, the recaptures and the token agreement with
   the clean run printed;
6. the same engine, ``generate``, profile, ``[dispatch_serve]`` and
   observability phases on full-width,
   full-depth falcon-mamba-7b in bf16 (phi3's weights are freed first),
   through the selective-scan kernel: 64 launches per admission and per
   engine step;
7. exact tokens: on phi3-mini-3.8b-smoke and falcon-mamba-7b-smoke in
   float32, the engine's and ``generate``'s tokens through captured
   graphs, through the kernels run eagerly and through the plain
   PyTorch path must all be equal; then with a dispatch service
   scripted to commit a candidate other than rank-0 (one recapture,
   whose graph must record the committed launch parameters), the
   engine's and ``generate``'s tokens must equal those without dispatch
   and the plain path's; and one session shared by both (the engine
   pinned by ``max_recompiles=0`` while the service commits, then
   ``generate(session=)`` at the engine's geometry, then a second
   drain on the committed step) must give the plain path's tokens in
   both drains; and (``[exact_lifecycle]``) ``nan@3.1``, a cancel of a
   running and a queued request, greedy and sampled ``_drain_batched``
   must give equal states and tokens through graphs, eagerly and
   through the plain path; and (``[watchdog_drift]``) the drift loop of
   phase 5 on 6 requests of 24 new tokens at batch size 2, with every
   gate of phase 5, must give the plain path's tokens;
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
import contextlib
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
ENGINE_BATCH_SIZES = (1, 2, 4)
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
# (head_dim 96, MHA): flash's tensor-core body at D 96 (64 and 128 query
# rows a block), the split decode body over the pool and over the
# contiguous cache.
MAIN_PATH_INSTANCES = {
    "flash_attention": r"flash_mma_kernelILi96ELi64E",
    "flash_attention_rows128": r"flash_mma_kernelILi96ELi128E",
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
    "flash_attention_d256": r"flash_mma_kernelILi256ELi64E",
    "flash_attention_d256_rows128": r"flash_mma_kernelILi256ELi128E",
    "flash_attention_d224": r"flash_mma_kernelILi224ELi64E",
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
                           batch_sizes=ENGINE_BATCH_SIZES, capture=capture,
                           **kw)
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
                           batch_sizes=ENGINE_BATCH_SIZES,
                           capture=mode == "graphs")
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
                      "counts": counts, "stats": st, "wall": wall}
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


def serve_phases(torch, dev, smi, arch, sched_times):
    """Engine, generate and profile phases on full-size ``arch`` in its
    own dtype with random weights from seed 0, each in graphs mode
    (captured steps, the default) and eager mode (``capture=False``) in
    this call: tokens and launch counts must agree between them; then
    ``[dispatch_serve]`` on the same weights.  Returns the graphs mode's
    cold counts with its engine stats (the weights are freed on
    return)."""
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
    # the lifecycle and the bucketed path, on the engine's requests
    cold, warm = engine["graphs"]["cold"], engine["graphs"]["warm"]
    want = engine_launches(cfg, cold["stats"]["inflight_admissions"],
                           cold["stats"]["steps"])
    if {k: v for k, v in cold["counts"].items() if v} != want:
        fail(f"{cfg.name} engine: launches {cold['counts']} are not one a "
             f"layer per admission and per step ({want})")
    faults_phase(torch, model, params, prompts, smi, cold["tokens"])
    st = warm["stats"]
    batched_phase(torch, model, params, prompts, smi, {
        "steps": st["steps"], "decode_tok_s": st["decode_tok_s"],
        "e2e_tok_s": f"{st['tokens_generated'] / warm['wall']:.1f}",
        "ttft_p50_s": st["ttft_p50_s"], "ttft_p95_s": st["ttft_p95_s"]})
    # before the profiles: no profiler has run in the process yet when
    # the dispatched steps are timed, as when the engine phase ran
    dispatch_serve(torch, model, params, prompts, smi, sched_times)
    # before the profiles too: observability's taps in turns, the drift
    telemetry_overhead(torch, model, params, prompts, smi, cold["tokens"])
    watchdog_drift(torch, model, params, prompts, smi)
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
    sched_times = schedule_checks(torch, dev, timer)

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
    phi3 = serve_phases(torch, dev, smi, PHI3, sched_times)
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
    mamba = serve_phases(torch, dev, smi, MAMBA, sched_times)
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
        exact_tokens_dispatch(torch, dev, arch)
        exact_lifecycle(torch, dev, arch)
        exact_watchdog_drift(torch, dev, arch)
    return summary


# ---------------------------------------------------------------------------
# Schedules: the attention and scan dispatch families
# ---------------------------------------------------------------------------

def schedule_checks(torch, dev, timer):
    """Phase 3, continued: each attention and scan kernel at every
    schedule the tuner offers at the main-path shapes, against its plain
    version at the existing tolerances; flash at 128 query rows a block
    at every engine prompt bucket (``[time_bucket]``, beside 64) and at
    head_dim 96 and 256; ``[time_schedule]``: each candidate's kernel ms
    beside the cost model's predicted ms.  Returns {(kernel, schedule
    json): ms} of the timed shapes."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core import registry as reg
    from repro_torch.core import tuner
    from repro_torch.core.schedule import (DecodeAttentionSchedule,
                                           FlashAttentionSchedule,
                                           SSMScanSchedule)
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     paged_decode_attention, ssm_scan)
    from repro_torch.kernels.decode_attention import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.kernels.decode_attention.ops import paged_split_keys
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.ssm_scan import ssm_scan_ref
    from repro_torch.models import bucket_length
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32

    def rn(shape, dtype):
        """Seeded normal tensor on the card."""
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(name, sched, got, want, shape):
        """One ``[check]`` line per schedule; fail outside tolerance."""
        dtype = str(want.dtype).replace("torch.", "")
        e, share = tolerance_share(torch, got, want)
        phase("check", kernel=name, dtype=dtype, shape=shape,
              schedule=json.dumps(reg.schedule_to_dict(sched)),
              max_abs_err=f"{e:.3g}", tol=repr(TOL[dtype]),
              worst_share_of_tol=f"{share:.3g}", ok=share <= 1.0)
        if share > 1.0:
            fail(f"{name} {dtype} {shape} at {sched} disagrees with its "
                 f"plain version: {share:.3g}x the tolerance")

    times = {}

    def timed(name, shape, sched, fn, predicted_s):
        """Time one candidate; one ``[time_schedule]`` line."""
        ms = timer(fn)
        key = json.dumps(reg.schedule_to_dict(sched))
        times[name, key] = ms
        phase("time_schedule", kernel=name, shape=repr(shape),
              schedule=key, ms=f"{ms:.4f}",
              predicted_ms=f"{predicted_s * 1e3:.4f}")

    # ---- flash: the engine's batch-1 prefills at every prompt bucket,
    # generate's [4, 512], and head_dim 256 (bf16, every row block); the
    # float32 body's one tile at the main geometry
    tiles = [FlashAttentionSchedule(*t)
             for t in tuner.flash_attention_tiles(96, 2)]
    for p in sorted(set(ENGINE_PROMPTS)):
        s = bucket_length(p)
        q = rn((1, 32, s, 96), bf16)
        k, v = rn((1, 32, s, 96), bf16), rn((1, 32, s, 96), bf16)
        st = torch.tensor([s - p], device=dev)
        want = flash_attention_ref(q, k, v, starts=st)
        for t in tiles:
            check("flash_attention", t, t.run(q, k, v, starts=st), want,
                  f"[1,32,{s},96] starts=[{s - p}]")
    for s in sorted({bucket_length(p) for p in ENGINE_PROMPTS}):
        real = max(p for p in ENGINE_PROMPTS if bucket_length(p) == s)
        q = rn((1, 32, s, 96), bf16)
        k, v = rn((1, 32, s, 96), bf16), rn((1, 32, s, 96), bf16)
        st = torch.tensor([s - real], device=dev)
        by_rows = {f"block_q_{t.block_q}_ms": f"{timer(lambda: t.run(q, k, v, starts=st)):.4f}"
                   for t in tiles}
        phase("time_bucket", kernel="flash_attention",
              shape=f"[1,32,{s},96]", real_tokens=real, **by_rows)
    gstarts = torch.tensor([512 - n for n in GENERATE_PROMPTS], device=dev)
    for shape, st in (((4, 32, 32, 512, 96), gstarts),
                      ((1, 16, 1, 512, 256), torch.tensor([212], device=dev))):
        b, hq, hkv, s, d = shape
        q = rn((b, hq, s, d), bf16)
        k, v = rn((b, hkv, s, d), bf16), rn((b, hkv, s, d), bf16)
        want = flash_attention_ref(q, k, v, starts=st)
        for t in [FlashAttentionSchedule(*x)
                  for x in tuner.flash_attention_tiles(d, 2)]:
            check("flash_attention", t, t.run(q, k, v, starts=st), want,
                  f"[{b},{hq},{s},{d}]/{hkv}kv starts={st.tolist()}")
    for (rows, keys) in tuner.flash_attention_tiles(96, 4):
        t = FlashAttentionSchedule(rows, keys)
        q = rn((1, 32, 512, 96), f32)
        k, v = rn((1, 32, 512, 96), f32), rn((1, 32, 512, 96), f32)
        st = torch.tensor([212], device=dev)
        check("flash_attention", t, t.run(q, k, v, starts=st),
              flash_attention_ref(q, k, v, starts=st),
              "[1,32,512,96] starts=[212]")
    q = rn((1, 32, 512, 96), bf16)
    k, v = rn((1, 32, 512, 96), bf16), rn((1, 32, 512, 96), bf16)
    st = torch.tensor([212], device=dev)
    pred = cm.flash_attention_schedule_cost_batch(
        1, 32, 32, 512, 96, [(t.block_q, t.block_kv) for t in tiles])
    for i, t in enumerate(tiles):
        timed("flash_attention", "[1,32,512,96] starts=[212]", t,
              lambda: t.run(q, k, v, starts=st), pred.time_s[i])

    # ---- contiguous decode: generate's [4, 32, 544, 96] cache, every
    # split offered (bf16 and float32)
    s = 512 + NEW_TOKENS
    starts = torch.tensor([512 - n for n in GENERATE_PROMPTS], device=dev)
    for dtype in (bf16, f32):
        qd = rn((4, 32, 1, 96), dtype)
        kc, vc = rn((4, 32, s, 96), dtype), rn((4, 32, s, 96), dtype)
        splits = tuner.decode_splits(4, 32, 32, s, 96, qd.element_size())
        for p in (512, s - 1):
            want = decode_attention_ref(qd, kc, vc, p, starts=starts)
            for bkv in splits:
                sc = DecodeAttentionSchedule(bkv)
                check("decode_attention", sc,
                      sc.run(qd, kc, vc, p, starts=starts), want,
                      f"[4,32,1,96] k/v [4,32,{s},96] pos={p}")
        if dtype == bf16:
            pred = cm.decode_attention_schedule_cost_batch(4, 32, 32, s, 96,
                                                           splits)
            for i, bkv in enumerate(splits):
                sc = DecodeAttentionSchedule(bkv)
                timed("decode_attention", f"[4,32,1,96] k/v [4,32,{s},96] "
                      f"pos=512", sc,
                      lambda: sc.run(qd, kc, vc, 512, starts=starts),
                      pred.time_s[i])

    # ---- paged decode: the engine's pool geometry (bs 16, 34 blocks a
    # row) at 1, 2 and 4 rows, every split offered (rounded to the pool
    # block), timed at 4 rows
    bs, mb = 16, 34
    for pos_list in ([300], [17, 511], [17, 100, 300, 511]):
        rows = len(pos_list)
        nb = 1 + rows * mb
        qd = rn((rows, 32, 1, 96), bf16)
        kp, vp = rn((nb, 32, bs, 96), bf16), rn((nb, 32, bs, 96), bf16)
        perm = torch.randperm(nb - 1, generator=torch.Generator()
                              .manual_seed(7)) + 1
        tables = perm.reshape(rows, mb).to(torch.int32).to(dev)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        want = paged_decode_attention_ref(qd, kp, vp, tables, pos)
        splits = tuner.decode_splits(rows, 32, 32, mb * bs, 96, 2)
        for bkv in splits:
            check("paged_decode_attention", DecodeAttentionSchedule(bkv),
                  paged_decode_attention(qd, kp, vp, tables, pos,
                                         block_kv=bkv), want,
                  f"[{rows},32,1,96] pools [{nb},32,{bs},96] "
                  f"pos={pos_list} split_keys={paged_split_keys(bkv, bs)}")
    pred = cm.decode_attention_schedule_cost_batch(4, 32, 32, mb * bs, 96,
                                                   splits)
    for i, bkv in enumerate(splits):
        timed("paged_decode_attention",
              f"[4,32,1,96] pools [137,32,16,96] pos={pos_list}",
              DecodeAttentionSchedule(bkv),
              lambda: paged_decode_attention(qd, kp, vp, tables, pos,
                                             block_kv=bkv), pred.time_s[i])

    # ---- the scan: every engine admission's bucket at batch 1,
    # generate's [4, 512] and the decode step at 1, 2 and 4 rows, at
    # every block_d offered; timed at [1, 512], [4, 512] and [4, 1]
    di, n = 8192, 16
    blocks = [SSMScanSchedule(bd) for bd in tuner.scan_blocks(n, 2)]

    def scan_args(bt, s, real=None, h0=False):
        """x, dt, b, c, a, d, h0 as the model feeds the scan."""
        x = rn((bt, s, di), bf16)
        dt = F.softplus(rn((bt, s, di), f32) * 0.5 - 1.0)
        b, c = rn((bt, s, n), f32), rn((bt, s, n), f32)
        for i, r in enumerate(real or []):
            x[i, :s - r] = 0
            b[i, :s - r] = 0
        a = -torch.arange(1, n + 1, dtype=f32, device=dev).repeat(di, 1)
        return (x, dt, b, c, a, rn((di,), bf16),
                rn((bt, di, n), bf16).float() if h0 else None)

    shapes = ([(1, bucket_length(p), [p], False)
               for p in sorted(set(ENGINE_PROMPTS))]
              + [(4, 512, GENERATE_PROMPTS, False)]
              + [(rows, 1, None, True) for rows in (1, 2, 4)])
    timed_args = {}
    for bt, s, real, h0 in shapes:
        args = scan_args(bt, s, real, h0)
        y_ref, h_ref = ssm_scan_ref(*args)
        label = f"[{bt},{s},{di}] N={n} h0={h0}"
        for sc in blocks:
            y, h = sc.run(*args)
            check("ssm_scan", sc, y, y_ref, "y " + label)
            check("ssm_scan", sc, h, h_ref, "state " + label)
        timed_args[bt, s] = args
    for name, (bt, s) in (("ssm_scan_prefill", (1, 512)),
                          ("ssm_scan_generate", (4, 512)),
                          ("ssm_scan_decode", (4, 1))):
        args = timed_args[bt, s]
        pred = cm.ssm_scan_schedule_cost_batch(bt, s, di, n,
                                               [b.block_d for b in blocks])
        for i, sc in enumerate(blocks):
            timed(name, f"[{bt},{s},{di}] N={n}", sc,
                  lambda: sc.run(*args), pred.time_s[i])
    return times


def _scripted_service(registry, device, target_index=1):
    """A dispatch service whose observations are scripted until a slot
    commits (the JAX package's ``_ScriptedService``): the candidate of
    rank ``target_index`` fast, the others slow, so the commit lands on
    it."""
    from repro_torch.runtime.dispatch import DispatchService

    class Scripted(DispatchService):
        def observe(self, kind, problem, dt, elem_bytes=2):
            slot = self.selector._slots[self.resolve(kind, problem,
                                                     elem_bytes)]
            if slot.committed is None:
                dt = 1e-4 if slot.next_candidate == target_index else 5e-4
            super().observe(kind, problem, dt, elem_bytes)

    return Scripted(registry, device=device)


def recorded_launches(step, kind, sched, label):
    """Fail unless every launch of ``kind`` (flash, the paged decode or
    the scan) the captured ``step`` recorded ran ``sched`` (its split
    rounded to the pool block for the paged kernel) and at least one
    did."""
    from repro_torch.kernels.decode_attention.ops import paged_split_keys
    noted = [p for p in step.launch_params if p["kind"] == kind]
    if not noted:
        fail(f"{label}: the captured step recorded no {kind} launch "
             f"({step.launch_params})")
    for p in noted:
        if kind == "ssm_scan":
            ok = p["block_d"] == sched.block_d
        elif kind == "flash_attention":
            ok = (p["block_q"], p["block_kv"]) == (sched.block_q,
                                                   sched.block_kv)
        else:
            bs = step.state["k"].shape[3]
            ok = (p["block_kv"] == sched.block_kv and p["split_keys"]
                  == paged_split_keys(sched.block_kv, bs))
        if not ok:
            fail(f"{label}: the captured step launched {p}, its bundle "
                 f"says {sched}")


def check_steps_run_their_bundles(session, decode_kind, label):
    """Every captured step of ``session`` recorded its key's schedules."""
    kernel = {"flash_attention": "flash_attention",
              "ssm_scan": "ssm_scan",
              "decode_attention": "paged_decode_attention"}
    for k in session.exec_cache.compiled_log:
        step = session.exec_cache.peek(k)
        kind = decode_kind if k.role == "decode" else (
            "ssm_scan" if decode_kind == "ssm_scan" else "flash_attention")
        recorded_launches(step, kernel[kind], k.schedules.get(kind),
                          f"{label} {k.role}[b{k.batch},t{k.length}]")


def dispatch_serve(torch, model, params, prompts, smi, sched_times):
    """``[dispatch_serve]``: the engine's 8 requests with captured steps
    and a DispatchService on a temporary registry file, drained twice
    (cold, warm), then once more by a fresh service over the same file;
    batch size 4 only (the rows the graphs run without dispatch used).
    A session without dispatch drains the same requests before and
    after the dispatched ones (cold, warm | dispatched | warm), so the
    two step times are compared in turns in one call.  Then at the
    engine phase's batch sizes a session without dispatch and one on
    the fresh service drain cold then warm: the buckets the
    dispatch-aware choice picks, reported.  See the module docstring
    for the gates."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.core import cost_model as cm
    from repro_torch.core import registry as reg
    from repro_torch.runtime.dispatch import DispatchService
    from repro_torch.runtime.serve_loop import serve_dispatch_problems
    from repro_torch.serving import ServeSession, SessionStats

    cfg = model.cfg
    arch, dev = cfg.name, params["embed"].device
    eb = params["embed"].element_size()
    free_card(torch)
    kind, prob = serve_dispatch_problems(cfg, 4, 0, 512 + NEW_TOKENS)[
        "decode"]
    pf_kind, pf_prob = serve_dispatch_problems(cfg, 1, 512, 0)["prefill"]
    # the slots printed, and the [time_schedule] kernel of each: the
    # engine's decode step and its prefill at the 512-token bucket
    shown = {(kind, json.dumps(prob, sort_keys=True)):
             {"decode_attention": "paged_decode_attention",
              "ssm_scan": "ssm_scan_decode"}[kind],
             (pf_kind, json.dumps(pf_prob, sort_keys=True)):
             {"flash_attention": "flash_attention",
              "ssm_scan": "ssm_scan_prefill"}[pf_kind]}
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = str(Path(tmp) / "dispatch.jsonl")
        svc = DispatchService(reg.TuningRegistry(path), device=dev)
        session = ServeSession(model, params, backend="cuda",
                               batch_sizes=(4,), dispatch=svc)

        def drain(sess, tag):
            """Serve the 8 requests once; the drain's stats and tokens."""
            sess.stats = SessionStats()
            for i, p in enumerate(prompts):
                sess.submit(p, NEW_TOKENS, request_id=f"r{i}")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = {r.request_id: r for r in sess.drain()}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            bad = [r.request_id for r in res.values()
                   if r.state != "COMPLETED" or len(r.tokens) != NEW_TOKENS]
            if len(res) != len(prompts) or bad:
                fail(f"{arch} dispatch_serve {tag}: not completed: {bad}")
            st = sess.stats.to_dict()
            return st, {k: v.tokens.tolist() for k, v in res.items()}, \
                wall, counts

        plain_session = ServeSession(model, params, backend="cuda",
                                     batch_sizes=(4,))
        drain(plain_session, "no dispatch, cold")
        st_a, tokens_a, _, _ = drain(plain_session, "no dispatch, warm")
        st, tokens, wall, counts = drain(session, "cold")
        committed = svc.committed(kind, prob, eb)
        if committed is None:
            fail(f"{arch} dispatch_serve: the decode slot {prob} did not "
                 f"commit within the drain ({st['steps']} steps)")
        if not st["recompiles"] <= st["commits_seen"] <= 1 \
                or st["recompiles"] > session.max_recompiles:
            fail(f"{arch} dispatch_serve: {st['recompiles']} recaptures for "
                 f"{st['commits_seen']} commits (max_recompiles "
                 f"{session.max_recompiles})")
        check_steps_run_their_bundles(session, kind,
                                      f"{arch} dispatch_serve")
        final = [k for k in session.exec_cache.compiled_log
                 if k.role == "decode" and k.schedules.get(kind) == committed]
        if not final:
            fail(f"{arch} dispatch_serve: no captured decode step runs the "
                 f"committed {committed}")
        built = session.exec_cache.compiles
        st_w, tokens_w, wall_w, _ = drain(session, "warm")
        st_b, _, _, _ = drain(plain_session, "no dispatch, warm again")
        del plain_session
        if session.exec_cache.compiles != built:
            fail(f"{arch} dispatch_serve: the warm drain built "
                 f"{session.exec_cache.compiles - built} steps")
        rec = svc.registry.get(svc.registry_key(kind, prob, eb))
        persisted = reg.schedule_from_dict(rec.measured["best"])
        fresh = DispatchService(reg.TuningRegistry(path), device=dev)
        fsession = ServeSession(model, params, backend="cuda",
                                batch_sizes=(4,), dispatch=fresh)
        evals = cm.total_evals()
        st_f, tokens_f, _, _ = drain(fsession, "fresh")
        if cm.total_evals() != evals:
            fail(f"{arch} dispatch_serve: the fresh service made "
                 f"{cm.total_evals() - evals} cost-model evaluations")
        first = next(k for k in fsession.exec_cache.compiled_log
                     if k.role == "decode")
        if first.schedules.get(kind) != persisted:
            fail(f"{arch} dispatch_serve: the fresh service's first decode "
                 f"step runs {first.schedules.get(kind)}, the registry "
                 f"persisted {persisted}")
        check_steps_run_their_bundles(fsession, kind,
                                      f"{arch} dispatch_serve fresh")
        f_commit = fresh.committed(kind, prob, eb)
        if f_commit == persisted and st_f["recompiles"]:
            fail(f"{arch} dispatch_serve: the fresh service recommitted "
                 f"the persisted winner and still recaptured")
        report = svc.report()
        # the engine phase's batch sizes, where the dispatch-aware
        # bucket choice has candidates to weigh: a session on the warm
        # service and one without dispatch, cold then warm each
        multi = {}
        for tag, msvc in (("no_dispatch", None), ("dispatch", fresh)):
            msession = ServeSession(model, params, backend="cuda",
                                    batch_sizes=ENGINE_BATCH_SIZES,
                                    dispatch=msvc)
            picks = []
            for drain_tag in ("cold", "warm"):
                st_m, tok_m, _, _ = drain(msession, f"{tag} b1,2,4 "
                                                    f"{drain_tag}")
                picks.append(sorted(st_m["buckets"]))
            multi[tag] = (st_m, tok_m, picks)
            del msession
            free_card(torch)
    for entry in report.values():
        timed_kernel = shown.get((entry["kind"], json.dumps(
            entry["problem"], sort_keys=True)))
        if timed_kernel is None:
            continue
        c = entry["committed"]
        phase("dispatch_serve", arch=arch, slot=repr(entry["problem"]),
              kind=entry["kind"],
              candidates=json.dumps(entry["candidates"]),
              predicted_ms=json.dumps([round(x * 1e3, 4)
                                       for x in entry["predicted_s"]]),
              measured_median_ms=json.dumps(
                  [None if x is None else round(x * 1e3, 4)
                   for x in entry["measured_median_s"]]),
              observations=entry["observations"],
              calls_until_commit=(sum(entry["samples"].values())
                                  if c else None),
              committed=json.dumps(c), committed_rank=entry["committed_rank"],
              time_schedule_ms=(sched_times.get((timed_kernel,
                                                 json.dumps(c)))
                                if c else None))
    flat = [(r, i) for r in sorted(tokens_a) for i in range(NEW_TOKENS)]
    same = [tokens[r][i] == tokens_a[r][i] for r, i in flat]
    diverge = next(((r, i) for (r, i), ok in zip(flat, same) if not ok),
                   None)

    def step_ms(x):
        """Mean decode step of a drain, ms."""
        return f"{1e3 * x['decode_s'] / max(x['steps'], 1):.2f}"
    phase("dispatch_serve", arch=arch, card=repr(smi),
          committed=json.dumps(reg.schedule_to_dict(committed)),
          recompiles=st["recompiles"], commits_seen=st["commits_seen"],
          free_switches=st["free_switches"], builds_cold=built,
          warm_builds=0, fresh_evals=0,
          fresh_first_decode=json.dumps(reg.schedule_to_dict(persisted)),
          fresh_committed=json.dumps(None if f_commit is None
                                     else reg.schedule_to_dict(f_commit)),
          fresh_recompiles=st_f["recompiles"],
          decode_tok_s=f"{st_w['decode_tok_s']:.1f}",
          step_ms=step_ms(st_w), cold_step_ms=step_ms(st),
          no_dispatch_decode_tok_s=(f"{st_a['decode_tok_s']:.1f},"
                                    f"{st_b['decode_tok_s']:.1f}"),
          no_dispatch_step_ms=f"{step_ms(st_a)},{step_ms(st_b)}",
          cold_decode_tok_s=f"{st['decode_tok_s']:.1f}",
          wall_s=f"{wall:.2f}", warm_wall_s=f"{wall_w:.2f}",
          token_agreement=f"{sum(same) / len(same):.4f}",
          first_divergence=repr(diverge),
          warm_tokens_equal_cold=tokens_w == tokens,
          launches=json.dumps(counts))
    (st_n, tok_n, picks_n), (st_d, tok_d, picks_d) = (multi["no_dispatch"],
                                                      multi["dispatch"])
    flat = [(r, i) for r in sorted(tok_n) for i in range(NEW_TOKENS)]
    agree = sum(tok_d[r][i] == tok_n[r][i] for r, i in flat) / len(flat)
    phase("dispatch_serve", arch=arch, card=repr(smi),
          batch_sizes=json.dumps(ENGINE_BATCH_SIZES),
          buckets_cold_warm=json.dumps(picks_d),
          no_dispatch_buckets_cold_warm=json.dumps(picks_n),
          steps=st_d["steps"], no_dispatch_steps=st_n["steps"],
          decode_tok_s=f"{st_d['decode_tok_s']:.1f}",
          no_dispatch_decode_tok_s=f"{st_n['decode_tok_s']:.1f}",
          step_ms=step_ms(st_d), no_dispatch_step_ms=step_ms(st_n),
          token_agreement=f"{agree:.4f}")


def exact_tokens_dispatch(torch, dev, arch):
    """Smoke config in float32 with a dispatch service scripted to
    commit the rank-1 candidate of the decode slot: the engine's (6
    requests of prompt bucket 64 at batch 2, 16 new tokens) and
    ``generate``'s ([2, 112] + 16) tokens through captured graphs must
    equal those without dispatch and the plain path's; each recaptures
    its decode step once, and the new graph records the committed
    launch parameters."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import registry as reg
    from repro_torch.models import build_model
    from repro_torch.runtime import generate
    from repro_torch.runtime.serve_loop import serve_dispatch_problems
    from repro_torch.serving import ServeSession

    scfg = get_config(arch)
    smodel = build_model(scfg)
    sparams = smodel.init(seed=0, device=dev)
    prompts = prompts_of([40, 37, 51, 44, 33, 60], scfg.vocab_size, seed=4)
    gtoks = np.stack(prompts_of([112, 112], scfg.vocab_size, seed=5))
    decode_kind = "ssm_scan" if scfg.attention_free else "decode_attention"
    out = {}
    for name, backend, scripted in (("graphs", "cuda", False),
                                    ("plain", "plain", False),
                                    ("graphs_dispatch", "cuda", True)):
        # one service each for the engine and generate: an ssm engine of
        # 2 rows and generate of 2 rows share their decode slot
        svc, gsvc = ((_scripted_service(reg.TuningRegistry(None), dev),
                      _scripted_service(reg.TuningRegistry(None), dev))
                     if scripted else (None, None))
        s = ServeSession(smodel, sparams, backend=backend, batch_sizes=(2,),
                         dispatch=svc)
        for i, p in enumerate(prompts):
            s.submit(p, 16, request_id=f"r{i}")
        eng = {r.request_id: r.tokens.tolist() for r in s.drain()}
        gen, gstats = generate(smodel, sparams, {"tokens": gtoks},
                               max_new_tokens=16, backend=backend,
                               dispatch=gsvc)
        torch.cuda.synchronize()
        out[name] = (eng, gen)
        if scripted:
            if s.stats.recompiles != 1 or gstats.recompiles != 1:
                fail(f"{arch} dispatch: recaptures engine "
                     f"{s.stats.recompiles}, generate {gstats.recompiles}; "
                     f"the scripted commit of rank 1 wants one each")
            check_steps_run_their_bundles(s, decode_kind,
                                          f"{arch} dispatch smoke")
            kind, prob = serve_dispatch_problems(scfg, 2, 112, 128)["decode"]
            committed = gsvc.committed(kind, prob, 4)
            if committed is None or committed != gsvc.candidates(
                    kind, prob, 4)[1] or gstats.schedules[kind] != \
                    reg.schedule_to_dict(committed):
                fail(f"{arch} dispatch: generate ran {gstats.schedules}, "
                     f"committed {committed}")
    for name in out:
        if out[name][0] != out["plain"][0] or not np.array_equal(
                out[name][1], out["plain"][1]):
            fail(f"{arch} dispatch: {name} tokens differ from the plain "
                 f"path's")
    # one session for the engine and generate: the engine stays pinned
    # on rank 0 (max_recompiles 0) while the service commits rank 1,
    # generate then captures rank 1's step at the engine's geometry (2
    # rows, 80 positions), and the next drain runs that graph: it must
    # read the pool the drain writes the prompts into
    svc = _scripted_service(reg.TuningRegistry(None), dev)
    s = ServeSession(smodel, sparams, backend="cuda", batch_sizes=(2,),
                     dispatch=svc, max_recompiles=0)
    drains = []
    for n in range(2):
        for i, p in enumerate(prompts):
            s.submit(p, 16, request_id=f"r{i}")
        res = s.drain()
        drains.append({r.request_id: r.tokens.tolist() for r in res})
        if n == 0:
            generate(smodel, sparams, {"tokens": gtoks[:, :64]},
                     max_new_tokens=16, session=s)
    torch.cuda.synchronize()
    kind, prob = serve_dispatch_problems(scfg, 2, 64, 80)["decode"]
    ran = res[-1].stats.schedules[kind]
    if ran != reg.schedule_to_dict(svc.candidates(kind, prob, 4)[1]):
        fail(f"{arch} dispatch: the drain after generate ran {ran}, not "
             f"the committed rank 1")
    if any(d != out["plain"][0] for d in drains):
        fail(f"{arch} dispatch: a drain around generate(session=) gave "
             f"other tokens than the plain path's")
    phase("exact_tokens", arch=scfg.name, dtype="float32",
          paths=json.dumps(list(out) + ["shared_session"]),
          dispatch="scripted rank 1", engine_requests=len(prompts),
          generate_rows=2, equal=True)


# ---------------------------------------------------------------------------
# The request lifecycle, fault injection and the bucketed path
# ---------------------------------------------------------------------------

def engine_launches(cfg, admissions, steps):
    """The port kernels an engine run launches: one flash (or scan)
    prefill a layer for each admission and one paged decode (or scan) a
    layer for each step, as the engine phase's counts show."""
    n = cfg.n_layers
    if cfg.attention_free:
        return {"ssm_scan": n * (admissions + steps)}
    return {"flash_attention": n * admissions,
            "paged_decode_attention": n * steps}


def drive(torch, session, prompts, on_step=None, deadlines=None):
    """Submit the engine phase's requests (``r0``...), drain once, then
    once more to flush what finished outside it (a queued request's
    cancellation).  Counts are set to 0 just before and read just
    after.  Returns (results by id, launch counts)."""
    from repro_torch import kernels
    for i, p in enumerate(prompts):
        session.submit(p, NEW_TOKENS, request_id=f"r{i}",
                       deadline_s=(deadlines or {}).get(f"r{i}"))
    kernels.reset_launch_counts()
    res = session.drain(on_step=on_step)
    res += session.drain()
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    return {r.request_id: r for r in res}, counts


def faults_phase(torch, model, params, prompts, smi, clean):
    """``[faults]``: each scenario on a fresh session with graphs at the
    engine phase's batch sizes, over its 8 requests; ``clean`` is the
    engine phase's cold graphs tokens.  A request a scenario did not
    touch must keep its clean tokens; a retired one's partial tokens
    are a prefix of them; the port kernels launched must be the engine
    phase's per admission and per step.  Then ``[lifecycle_overhead]``:
    warm drains of a session without the lifecycle knobs and of one with
    ``request_deadline_s=3600`` and an empty injector, in turns."""
    from repro_torch.serving import (FaultInjector, InjectedFault,
                                     ServeSession, SessionStats)

    cfg = model.cfg
    arch = cfg.name
    rows = max(ENGINE_BATCH_SIZES)
    last = NEW_TOKENS - 1           # the boundary the first rows retire at

    def session(**kw):
        return ServeSession(model, params, backend="cuda",
                            batch_sizes=ENGINE_BATCH_SIZES, **kw)

    def check(name, s, res, counts, touched, want_states):
        """The scenario's common gates; one [faults] line."""
        st = s.stats
        if set(res) != set(clean):
            fail(f"{arch} [faults] {name}: results for {sorted(res)}")
        for rid, r in res.items():
            want = want_states.get(rid, "COMPLETED")
            if r.state != want:
                fail(f"{arch} [faults] {name}: {rid} ended {r.state} "
                     f"({r.reason}), want {want}")
            toks = r.tokens.tolist()
            if rid not in touched and toks != clean[rid]:
                fail(f"{arch} [faults] {name}: untouched {rid}'s tokens "
                     f"differ from the engine phase's")
            if toks != clean[rid][:len(toks)]:
                fail(f"{arch} [faults] {name}: {rid}'s tokens are no "
                     f"prefix of its clean tokens")
        want = engine_launches(cfg, st.inflight_admissions, st.steps)
        if counts != want:
            fail(f"{arch} [faults] {name}: launches {counts}, want {want} "
                 f"for {st.inflight_admissions} admissions and {st.steps} "
                 f"steps")
        phase("faults", arch=arch, scenario=name, card=repr(smi),
              states=json.dumps({k: r.state for k, r in sorted(res.items())
                                 if r.state != "COMPLETED"}),
              partial_tokens=json.dumps({k: len(res[k].tokens)
                                         for k in sorted(touched)}),
              steps=st.steps, admissions=st.inflight_admissions,
              failed=st.failed, poisoned_rows=st.poisoned_rows,
              cancelled=st.cancelled, timed_out=st.timed_out, shed=st.shed,
              stragglers=st.stragglers, compile_retries=st.compile_retries,
              events=json.dumps(sorted({e.kind for e in st.events})),
              launches=json.dumps(counts))

    # nan@5.1: the step's own finite flag reads 0 for row 1
    free_card(torch)
    s = session(faults=FaultInjector.from_strings(["nan@5.1"]))
    flags = {}

    def read_flags(info):
        if s._step_count - 1 == 5:
            dec = [s.exec_cache.peek(k) for k in s.exec_cache.compiled_log
                   if k.role == "decode"][0]
            flags["row1"] = int(dec.outputs[1][1].item())
    res, counts = drive(torch, s, prompts, on_step=read_flags)
    failed = [k for k, r in res.items() if r.state == "FAILED"]
    if len(failed) != 1 or s.stats.poisoned_rows != 1 or flags != {
            "row1": 0}:
        fail(f"{arch} [faults] nan@5.1: failed {failed}, poisoned rows "
             f"{s.stats.poisoned_rows}, device flag {flags}")
    check("nan@5.1", s, res, counts, set(failed),
          {failed[0]: "FAILED"})

    # cancel one running request at step 3 and one queued request
    free_card(torch)
    s = session()
    done = []

    def cancel(info):
        if info["step"] == 3 and not done:
            done.extend([s.cancel("r0"), s.cancel(f"r{len(prompts) - 1}")])
    res, counts = drive(torch, s, prompts, on_step=cancel)
    queued = f"r{len(prompts) - 1}"
    if done != [True, True] or len(res["r0"].tokens) == 0 \
            or len(res[queued].tokens) != 0 or s.stats.cancelled != 2:
        fail(f"{arch} [faults] cancel: {done}, r0 {len(res['r0'].tokens)} "
             f"tokens, {queued} {len(res[queued].tokens)}")
    check("cancel", s, res, counts, {"r0", queued},
          {"r0": "CANCELLED", queued: "CANCELLED"})

    # a deadline blown mid-decode, on a fake session clock
    free_card(torch)
    s = session()
    fake = [0.0]
    s._clock = lambda: fake[0]

    def late(info):
        if info["step"] == 3:
            fake[0] = 1.0
    res, counts = drive(torch, s, prompts, on_step=late,
                        deadlines={"r2": 0.5})
    if not 0 < len(res["r2"].tokens) < NEW_TOKENS or s.stats.timed_out != 1:
        fail(f"{arch} [faults] deadline: r2 {res['r2'].state} with "
             f"{len(res['r2'].tokens)} tokens")
    check("deadline", s, res, counts, {"r2"}, {"r2": "TIMED_OUT"})

    # max_queue_s: the requests still queued when the clock passes it
    free_card(torch)
    s = session(max_queue_s=1.0)
    fake = [0.0]
    s._clock = lambda: fake[0]
    res, counts = drive(torch, s, prompts, on_step=lambda info: (
        fake.__setitem__(0, 2.0) if info["step"] == 3 else None))
    shed = {f"r{i}" for i in range(rows, len(prompts))}
    if s.stats.shed != len(shed) or s.stats.timed_out != len(shed):
        fail(f"{arch} [faults] shed: shed {s.stats.shed}, timed out "
             f"{s.stats.timed_out}, want {len(shed)}")
    check("max_queue_s", s, res, counts, shed,
          {k: "TIMED_OUT" for k in shed})

    if not cfg.attention_free:
        # the allocator reports exhaustion at the boundaries where the
        # first rows retire (the first free row is at step 31): the next
        # four wait three boundaries, counted though no step runs
        free_card(torch)
        spec = f"alloc@{last}x3"
        s = session(faults=FaultInjector.from_strings([spec]))
        res, counts = drive(torch, s, prompts)
        n = sum(e.kind == "alloc_exhausted" for e in s.stats.events)
        if n != 3 or s._step_count != s.stats.steps + 3:
            fail(f"{arch} [faults] {spec}: {n} alloc_exhausted events, "
                 f"{s._step_count} boundaries for {s.stats.steps} steps")
        check(spec, s, res, counts, set(), {})

        # a double free of the rows that retire at that boundary
        free_card(torch)
        spec = f"doublefree@{last}"
        s = session(faults=FaultInjector.from_strings([spec]))
        res, counts = drive(torch, s, prompts)
        n = sum(e.kind == "allocator" for e in s.stats.events)
        if n != rows:
            fail(f"{arch} [faults] {spec}: {n} allocator events, want one "
                 f"for each of the {rows} rows retiring at step {last}")
        check(spec, s, res, counts, set(), {})

    # slow@8 (a simulated 10 s step): one straggler, admission held for
    # the next two boundaries
    free_card(torch)
    hooks, holds = [], []
    s = session(faults=FaultInjector.from_strings(["slow@8"]),
                straggler_threshold=20.0,
                on_straggler=lambda ev: hooks.append(ev) or 2)

    def hold(info):
        if 8 <= s._step_count - 1 <= 10:
            holds.append(s._admission_hold)
    res, counts = drive(torch, s, prompts, on_step=hold)
    if s.stats.stragglers != 1 or len(hooks) != 1 or holds != [2, 1, 0]:
        fail(f"{arch} [faults] slow@8: {s.stats.stragglers} stragglers, "
             f"admission hold after steps 8-10 {holds}, want [2, 1, 0]")
    check("slow@8", s, res, counts, set(), {})

    # compile@0: the first build fails once and is retried
    free_card(torch)
    s = session(faults=FaultInjector.from_strings(["compile@0"]),
                compile_retries=2)
    res, counts = drive(torch, s, prompts)
    if s.stats.compile_retries != 1:
        fail(f"{arch} [faults] compile@0: {s.stats.compile_retries} "
             f"retries")
    check("compile@0", s, res, counts, set(), {})

    # compile@0x3 with 2 retries: the build failure raises out of drain
    free_card(torch)
    s = session(faults=FaultInjector.from_strings(["compile@0x3"]),
                compile_retries=2)
    try:
        drive(torch, s, prompts)
    except InjectedFault as e:
        raised = str(e)
    else:
        fail(f"{arch} [faults] compile@0x3: drain did not raise")
    if s.stats.compile_retries != 2 or s.exec_cache.compiles != 0:
        fail(f"{arch} [faults] compile@0x3: {s.stats.compile_retries} "
             f"retries, {s.exec_cache.compiles} steps built")
    phase("faults", arch=arch, scenario="compile@0x3", card=repr(smi),
          raised=repr(raised), compile_retries=s.stats.compile_retries,
          events=json.dumps([e.kind for e in s.stats.events]))
    del s, res

    # the host cost of the lifecycle checks: warm drains in turns
    free_card(torch)
    base = session()
    life = session(request_deadline_s=3600.0, faults=FaultInjector([]))
    ms = {"base": [], "lifecycle": []}
    turns = [("base", base), ("lifecycle", life)] + [
        (n, base if n == "base" else life)
        for n in "lifecycle base base lifecycle lifecycle base base "
                 "lifecycle".split()]
    for name, sess in turns:
        cold = sess.stats.steps == 0
        sess.stats = SessionStats()
        res, _ = drive(torch, sess, prompts)
        if any(r.state != "COMPLETED" or r.tokens.tolist() != clean[k]
               for k, r in res.items()):
            fail(f"{arch} [lifecycle_overhead] {name}: other tokens")
        if not cold:
            ms[name].append(1e3 * sess.stats.decode_s / sess.stats.steps)
    phase("lifecycle_overhead", arch=arch, card=repr(smi),
          order=" ".join(n for n, _ in turns) + " (the first of each "
                "cold, not timed)",
          base_step_ms=json.dumps([round(x, 4) for x in ms["base"]]),
          lifecycle_step_ms=json.dumps([round(x, 4)
                                        for x in ms["lifecycle"]]),
          ratio=f"{sum(ms['lifecycle']) / sum(ms['base']):.4f}")
    del base, life


def batched_phase(torch, model, params, prompts, smi, engine):
    """``[batched]``: the engine phase's 8 requests through
    ``_drain_batched`` with graphs at its batch sizes, cold then warm
    (the warm drain may build nothing), each request's tokens equal to
    ``generate`` on its group (the same bucket and starts, on a session
    of its own); the pad rows of a group smaller than its bucket stay
    finite; tok/s, TTFT and steps beside the in-flight engine's warm
    drain (``engine``: its stats).  Then sampled at T=0.8: two drains
    give equal tokens inside the vocabulary, and a group's generator
    seeded 1 other tokens than the default seed 0.  Counts are set to 0
    just before each drain and read just after.  Then the sampler is held
    to the softmax (:func:`sampler_vs_softmax`) and every kernel call of
    a greedy drain to its plain version (:func:`batched_vs_plain`)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.runtime import generate
    from repro_torch.serving import Request, ServeSession, SessionStats

    cfg = model.cfg
    arch, dev = cfg.name, params["embed"].device
    path = (("ssm_scan",) if cfg.attention_free
            else ("flash_attention", "decode_attention"))
    free_card(torch)
    out = {}
    for temperature in (0.0, 0.8):
        s = ServeSession(model, params, backend="cuda",
                         batch_sizes=ENGINE_BATCH_SIZES,
                         temperature=temperature)
        mode = "sampled" if temperature else "greedy"
        for drain in ("cold", "warm"):
            s.stats = SessionStats()
            built = s.exec_cache.compiles
            for i, p in enumerate(prompts):
                s.submit(p, NEW_TOKENS, request_id=f"r{i}")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = s._drain_batched()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            toks = {r.request_id: r.tokens.tolist() for r in res}
            bad = [r.request_id for r in res if r.state != "COMPLETED"
                   or len(r.tokens) != NEW_TOKENS or r.tokens.min() < 0
                   or r.tokens.max() >= cfg.vocab_size]
            if len(res) != len(prompts) or bad:
                fail(f"{arch} [batched] {mode} {drain}: bad results {bad}")
            if drain == "warm" and s.exec_cache.compiles != built:
                fail(f"{arch} [batched] {mode}: the warm drain built "
                     f"{s.exec_cache.compiles - built} steps")
            if any(counts.get(k, 0) < 1 for k in path):
                fail(f"{arch} [batched] {mode}: the path launched {counts}")
            st = s.stats.to_dict()
            groups = {}
            for r in res:
                groups.setdefault(r.bucket, []).append(r.request_id)
            steps = len(groups) * (NEW_TOKENS - 1)
            phase("batched", arch=arch, mode=mode, drain=drain,
                  card=repr(smi),
                  groups=json.dumps({f"b{b.batch}xp{b.prompt_len}"
                                     f"xt{b.total_len}": ids
                                     for b, ids in groups.items()}),
                  steps=steps, engine_steps=engine["steps"],
                  decode_tok_s=f"{st['decode_tok_s']:.1f}",
                  engine_decode_tok_s=f"{engine['decode_tok_s']:.1f}",
                  e2e_tok_s=f"{st['tokens_generated'] / wall:.1f}",
                  engine_e2e_tok_s=engine["e2e_tok_s"],
                  ttft_p50_s=f"{st['ttft_p50_s']:.4f}",
                  ttft_p95_s=f"{st['ttft_p95_s']:.4f}",
                  engine_ttft_p50_s=f"{engine['ttft_p50_s']:.4f}",
                  engine_ttft_p95_s=f"{engine['ttft_p95_s']:.4f}",
                  step_ms=f"{1e3 * st['decode_s'] / steps:.3f}",
                  wall_s=f"{wall:.2f}",
                  cache_hits_misses_compiles=f"{s.exec_cache.hits}/"
                  f"{s.exec_cache.misses}/{s.exec_cache.compiles}",
                  launches=json.dumps(counts))
            if drain == "warm" and toks != out.get((mode, "cold"), toks):
                fail(f"{arch} [batched] {mode}: the warm drain's tokens "
                     f"differ from the cold drain's")
            out[mode, drain] = toks
            out[mode, "step_ms"] = 1e3 * st["decode_s"] / steps
        by_id = {f"r{i}": p for i, p in enumerate(prompts)}
        for bucket, ids in groups.items():
            toks_b, starts = s._form_batch(
                [Request(by_id[rid], NEW_TOKENS, rid, 0.0) for rid in ids], bucket)
            if bucket.total_len != bucket.prompt_len + NEW_TOKENS:
                fail(f"{arch} [batched]: bucket {bucket} is wider than "
                     f"generate's total")
            if temperature == 0.0:
                ref, _ = generate(model, params, toks_b,
                                  max_new_tokens=NEW_TOKENS,
                                  seq_starts=starts)
                for i, rid in enumerate(ids):
                    if ref[i].tolist() != out[mode, "warm"][rid]:
                        fail(f"{arch} [batched]: {rid} differs from "
                             f"generate on its group {bucket}")
            if len(ids) < bucket.batch:
                for k in s.exec_cache.compiled_log:
                    if k.batch != bucket.batch or k.length not in (
                            bucket.prompt_len, bucket.total_len):
                        continue
                    o = s.exec_cache.peek(k).outputs
                    o = o[0] if k.role == "prefill" else o
                    if o[1].tolist() != [1] * bucket.batch:
                        fail(f"{arch} [batched] {mode}: {k} finite flags "
                             f"{o[1].tolist()} with pad rows")
                phase("batched_pad_rows", arch=arch, mode=mode,
                      bucket=f"b{bucket.batch}xp{bucket.prompt_len}"
                             f"xt{bucket.total_len}",
                      real_rows=len(ids), finite=True)
        if temperature:
            bucket, ids = next(iter(groups.items()))
            toks_b, starts = s._form_batch(
                [Request(by_id[rid], NEW_TOKENS, rid, 0.0) for rid in ids], bucket)
            seeded = {}
            for seed in (0, 1):
                g = torch.Generator(device=dev).manual_seed(seed)
                seeded[seed], _ = generate(
                    model, params, toks_b, max_new_tokens=NEW_TOKENS,
                    seq_starts=starts, generator=g, session=s)
            same0 = all(seeded[0][i].tolist() == out[mode, "warm"][rid]
                        for i, rid in enumerate(ids))
            if not same0 or np.array_equal(seeded[0], seeded[1]):
                fail(f"{arch} [batched] sampled: seed 0 equal to the drain "
                     f"{same0}, seed 1 equal to seed 0 "
                     f"{np.array_equal(seeded[0], seeded[1])}")
        del s
        free_card(torch)
    agree = np.mean([a == b for k in out[("greedy", "warm")]
                     for a, b in zip(out["greedy", "warm"][k],
                                     out["sampled", "warm"][k])])
    phase("batched_sampled", arch=arch, card=repr(smi), temperature=0.8,
          two_runs_equal=True, seed1_differs=True,
          greedy_step_ms=f"{out['greedy', 'step_ms']:.3f}",
          sampled_step_ms=f"{out['sampled', 'step_ms']:.3f}",
          token_agreement_with_greedy=f"{agree:.4f}")
    sampler_vs_softmax(torch, model, params, prompts, smi)
    batched_vs_plain(torch, model, params, prompts, smi,
                     out["greedy", "warm"])



# [batched_vs_plain]: the 512 bucket's two requests (prompts 300 and 260)
# take 20 and 12 new tokens, so their group decodes 20 steps in a cache of
# 512 + 32 slots (the budget bucket of 20), wider than it fills
CHECK_BUDGETS = [NEW_TOKENS, NEW_TOKENS, 20, NEW_TOKENS, NEW_TOKENS, 12,
                 NEW_TOKENS, NEW_TOKENS]


@contextlib.contextmanager
def held_to_plain(torch):
    """While open, every call the model makes to the flash, contiguous
    decode and scan kernels runs the kernel, then its plain version on
    the same inputs, and is held to it at phase 3's tolerance; yields
    ``{(kernel, shape): [calls, max abs err, worst share of tol]}``
    (scan: y and the final state)."""
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.ssm_scan import ssm_scan_ref
    from repro_torch.models import attention, ssm

    seen = {}

    def hold(key, pairs):
        """Fold one call's (got, want) pairs into ``seen[key]``."""
        row = seen.setdefault(key, [0, 0.0, 0.0])
        row[0] += 1
        for got, want in pairs:
            e, share = tolerance_share(torch, got, want)
            row[1], row[2] = max(row[1], e), max(row[2], share)

    def dims(t):
        return ",".join(map(str, t.shape))

    flash0, decode0, scan0 = (attention.flash_attention_scheduled,
                              attention.decode_kernel,
                              ssm.ssm_scan_scheduled)

    def flash(q, k, v, *, schedule=None, causal=True, window=None,
              starts=None):
        out = flash0(q, k, v, schedule=schedule, causal=causal,
                     window=window, starts=starts)
        st = None if starts is None else starts.tolist()
        hold(("flash_attention", f"q[{dims(q)}] kv[{dims(k)}] "
              f"starts={st}"),
             [(out, flash_attention_ref(q, k, v, causal=causal,
                                        window=window, starts=starts))])
        return out

    def decode(q, k, v, pos, *, starts=None, schedule=None):
        out = decode0(q, k, v, pos, starts=starts, schedule=schedule)
        st = None if starts is None else torch.as_tensor(starts).tolist()
        hold(("decode_attention", f"q[{dims(q)}] kv[{dims(k)}] "
              f"starts={st}"),
             [(out, decode_attention_ref(q, k, v, pos, starts=starts))])
        return out

    def scan(x, dt, b, c, a, d, h0=None, *, schedule=None):
        y, h = scan0(x, dt, b, c, a, d, h0, schedule=schedule)
        hold(("ssm_scan", f"x[{dims(x)}] h0={h0 is not None}"),
             zip((y, h), ssm_scan_ref(x, dt, b, c, a, d, h0)))
        return y, h

    attention.flash_attention_scheduled = flash
    attention.decode_kernel = decode
    ssm.ssm_scan_scheduled = scan
    try:
        yield seen
    finally:
        attention.flash_attention_scheduled = flash0
        attention.decode_kernel = decode0
        ssm.ssm_scan_scheduled = scan0


def batched_vs_plain(torch, model, params, prompts, smi, greedy):
    """``[batched_vs_plain]``: the engine phase's requests through greedy
    ``_drain_batched`` at (1, 2, 4) with ``CHECK_BUDGETS`` (one group
    decodes in a widened cache), steps run eagerly so that every kernel
    call of the drain, pad rows included, is held to its plain version
    (:func:`held_to_plain`); each request's tokens must be the first of
    its tokens in the graphs' greedy drain (``greedy``)."""
    from repro_torch import kernels
    from repro_torch.serving import ServeSession

    cfg = model.cfg
    arch = cfg.name
    path = (("ssm_scan",) if cfg.attention_free
            else ("flash_attention", "decode_attention"))
    free_card(torch)
    s = ServeSession(model, params, backend="cuda", capture=False,
                     batch_sizes=ENGINE_BATCH_SIZES)
    for i, p in enumerate(prompts):
        s.submit(p, CHECK_BUDGETS[i], request_id=f"r{i}")
    kernels.reset_launch_counts()
    with held_to_plain(torch) as seen:
        res = s._drain_batched()
        torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    widened = [f"b{r.bucket.batch}xp{r.bucket.prompt_len}"
               f"xt{r.bucket.total_len}" for r in res
               if r.bucket.total_len > r.bucket.prompt_len
               + max(CHECK_BUDGETS[int(q.request_id[1:])] for q in res
                     if q.bucket == r.bucket)]
    padded = sorted({f"b{r.bucket.batch}xp{r.bucket.prompt_len}"
                     for r in res if sum(q.bucket == r.bucket
                                         for q in res) < r.bucket.batch})
    for (kernel, shape), (calls, e, share) in sorted(seen.items()):
        phase("batched_vs_plain", arch=arch, card=repr(smi), kernel=kernel,
              shape=repr(shape), calls=calls, max_abs_err=f"{e:.3g}",
              tol=repr(TOL),
              worst_share_of_tol=f"{share:.3g}", ok=share <= 1.0)
    bad = {k: v for k, v in seen.items() if v[2] > 1.0}
    if bad:
        fail(f"{arch} [batched_vs_plain]: kernels disagree with their "
             f"plain versions: {bad}")
    checked = {}
    for (kernel, _), (calls, _, _) in seen.items():
        checked[kernel] = checked.get(kernel, 0) + calls
    if any(checked.get(k, 0) < counts.get(k, 0) or counts.get(k, 0) < 1
           for k in path):
        fail(f"{arch} [batched_vs_plain]: checked calls {checked}, "
             f"launches {counts}")
    if not widened or not padded:
        fail(f"{arch} [batched_vs_plain]: no widened group ({widened}) or "
             f"no group smaller than its bucket ({padded})")
    for r in res:
        want = greedy[r.request_id][:CHECK_BUDGETS[int(r.request_id[1:])]]
        if r.state != "COMPLETED" or r.tokens.tolist() != want:
            fail(f"{arch} [batched_vs_plain]: {r.request_id} {r.state} "
                 f"{r.tokens.tolist()} differs from the graphs' greedy "
                 f"drain {want}")
    phase("batched_vs_plain_summary", arch=arch, checked=json.dumps(checked),
          launches=json.dumps(counts), widened=json.dumps(sorted(set(
              widened))), padded=json.dumps(padded), tokens_equal=True)
    del s
    free_card(torch)


def sampler_vs_softmax(torch, model, params, prompts, smi):
    """``[sampler]``: 20,000 draws of the sampled steps' pick
    (``captured.step_pick`` with noise from a generator seeded 0, as a
    step is fed) on one row of logits from a full-width prefill of
    ``prompts[0]``, standardised and scaled by 3 so that a few tokens
    hold most of the mass at T=0.8.  Each token of probability >= 0.005
    and the rest together must lie within 4 sigma of ``softmax(logits /
    T)`` in float32; the same gate must refuse draws that ignore the
    logits."""
    from repro_torch.serving.captured import step_inputs, step_pick

    dev, vocab, temp, n, chunk = params["embed"].device, \
        model.cfg.vocab_size, 0.8, 20000, 2500
    tokens = torch.as_tensor(prompts[0], device=dev)[None]
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": tokens},
                                  backend="cuda")
    z = logits[0, -1].float()
    z = (z - z.mean()) / z.std() * 3.0
    p = torch.softmax(z.double() / temp, dim=-1)
    cats = torch.nonzero(p >= 0.005).flatten()
    pc = torch.cat([p[cats], (1.0 - p[cats].sum())[None]])
    sigma = torch.sqrt(pc * (1 - pc) / n)

    def freqs(last):
        """Category frequencies of ``n`` picks of ``last`` [V]."""
        gen = torch.Generator(device=dev).manual_seed(0)
        inputs = step_inputs(chunk, vocab, dev, sampled=True)
        inputs["temperature"].fill_(temp)
        hits = torch.zeros(vocab, dtype=torch.float64, device=dev)
        for _ in range(n // chunk):
            torch.rand(inputs["noise"].shape, generator=gen,
                       out=inputs["noise"])
            picked = step_pick(last.expand(chunk, -1), inputs)
            if picked[1].min().item() != 1:
                fail(f"{model.cfg.name} [sampler]: finite logits flagged")
            hits += torch.bincount(picked[0], minlength=vocab).double()
        f = hits / n
        return torch.cat([f[cats], (1.0 - f[cats].sum())[None]])

    got = freqs(z)
    worst = ((got - pc).abs() / sigma).max().item()
    flat = ((freqs(torch.zeros_like(z)) - pc).abs() / sigma).max().item()
    phase("sampler", arch=model.cfg.name, card=repr(smi), temperature=temp,
          draws=n, categories=len(pc), top_p=f"{pc[:-1].max().item():.4f}",
          rest_p=f"{pc[-1].item():.4f}",
          worst_sigmas=f"{worst:.3f}", logits_ignored_sigmas=f"{flat:.1f}",
          ok=worst <= 4.0 < flat)
    if worst > 4.0 or flat <= 4.0:
        fail(f"{model.cfg.name} [sampler]: frequencies {worst:.3f} sigma "
             f"from softmax(logits / T) (limit 4); draws that ignore the "
             f"logits {flat:.1f} sigma (must exceed 4)")


def exact_lifecycle(torch, dev, arch):
    """Smoke config in float32, through captured graphs, the kernels run
    eagerly and the plain path: the results of ``nan@3.1`` (row 1 fails,
    the others survive), of a cancel of a running and a queued request
    at step 2, of greedy ``_drain_batched`` and of sampled
    ``_drain_batched`` (T=0.8: the same noise on every path) must be
    equal on all three (states and tokens, request for request)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import FaultInjector, ServeSession

    scfg = get_config(arch)
    smodel = build_model(scfg)
    sparams = smodel.init(seed=0, device=dev)
    sprompts = prompts_of([5, 7, 3, 6, 12, 9], scfg.vocab_size, seed=3)
    budgets = [8, 3, 8, 1, 5, 4]
    paths = {"graphs": ("cuda", True), "eager": ("cuda", False),
             "plain": ("plain", False)}
    got = {}
    for name, (backend, capture) in paths.items():
        def session(**kw):
            return ServeSession(smodel, sparams, backend=backend,
                                capture=capture, kv_block_size=4,
                                batch_sizes=ENGINE_BATCH_SIZES, **kw)

        def serve(s, on_step=None, batched=False):
            for i, p in enumerate(sprompts):
                s.submit(p, budgets[i] if batched else 8,
                         request_id=f"r{i}")
            res = (s._drain_batched() if batched
                   else s.drain(on_step=on_step) + s.drain())
            return [(r.request_id, r.state, r.tokens.tolist()) for r in res]

        runs = {"nan": serve(session(
            faults=FaultInjector.from_strings(["nan@3.1"])))}
        s = session()
        runs["cancel"] = serve(s, on_step=lambda info: (
            s.cancel("r0"), s.cancel("r5")) if info["step"] == 2 else None)
        runs["batched"] = serve(session(), batched=True)
        # sampled (T=0.8, each group's noise seeded 0 on the card)
        runs["sampled"] = serve(session(temperature=0.8), batched=True)
        torch.cuda.synchronize()
        got[name] = runs
    for name in paths:
        if got[name] != got["plain"]:
            fail(f"{arch} lifecycle: {name} results differ from the plain "
                 f"path's: {got[name]} vs {got['plain']}")
    states = {k: sorted(st for _, st, _ in v)
              for k, v in got["plain"].items()}
    if states["nan"].count("FAILED") != 1 \
            or states["cancel"].count("CANCELLED") != 2:
        fail(f"{arch} lifecycle: states {states}")
    phase("exact_lifecycle", arch=scfg.name, dtype="float32",
          paths=json.dumps(list(paths)),
          scenarios=json.dumps(list(got["plain"])), equal=True,
          states=json.dumps({k: {s: v.count(s) for s in set(v)}
                             for k, v in states.items()}))


# ---------------------------------------------------------------------------
# Observability: telemetry, the performance watchdog, the flight recorder
# ---------------------------------------------------------------------------

def timed_drain(torch, session, prompts, label, new_tokens=NEW_TOKENS):
    """Serve ``prompts`` (ids ``r0``...) through ``session`` once.
    Returns (tokens by id, each decode step's seconds, each boundary's
    seconds): a step is the growth of ``stats.decode_s`` between two
    ``on_step`` calls (the timed replay and its copy to the host), a
    boundary the host's wall time between them (the whole loop: retire,
    admit, the step and every tap after it)."""
    steps, bounds = [], []
    last = {"decode_s": session.stats.decode_s, "t": None}

    def on_step(info):
        """One step's and one boundary's time."""
        now = time.perf_counter()
        steps.append(session.stats.decode_s - last["decode_s"])
        last["decode_s"] = session.stats.decode_s
        if last["t"] is not None:
            bounds.append(now - last["t"])
        last["t"] = now

    for i, p in enumerate(prompts):
        session.submit(p, new_tokens, request_id=f"r{i}")
    res = {r.request_id: r for r in session.drain(on_step=on_step)}
    torch.cuda.synchronize()
    bad = [r.request_id for r in res.values()
           if r.state != "COMPLETED" or len(r.tokens) != new_tokens]
    if len(res) != len(prompts) or bad:
        fail(f"{label}: not completed: {bad}")
    return {k: v.tokens.tolist() for k, v in res.items()}, steps, bounds


def median_ms(xs):
    """Median of seconds, in ms."""
    import statistics
    return 1e3 * statistics.median(xs)


def in_turns(torch, session, modes, order, prompts, label, want=None):
    """Warm drains of ``session`` (already drained once, cold) in
    ``order``, each after ``modes[name]()`` switched it to that mode;
    every drain's tokens must equal ``want`` (default: the first
    drain's).  Returns ({name: {"step": [median ms a drain],
    "boundary": [...]}}, the tokens)."""
    out = {n: {"step": [], "boundary": []} for n in modes}
    for name in order:
        modes[name]()
        tokens, steps, bounds = timed_drain(torch, session, prompts,
                                            f"{label} {name}")
        want = tokens if want is None else want
        if tokens != want:
            fail(f"{label} {name}: other tokens than the run it is held to")
        out[name]["step"].append(median_ms(steps))
        out[name]["boundary"].append(median_ms(bounds))
    return out, want


def min_ratio(ms, on, off, key):
    """The smaller of the pairs' on / off ratios (noise only inflates
    one: the cost of a tap is never negative)."""
    return min(a / b for a, b in zip(ms[on][key], ms[off][key]))


def tap_times(torch, session, svc, wd, rec, prompts, label, want):
    """The watchdog's and the recorder's host time, timed at the taps:
    one more warm drain with both bound and ``perf_counter`` around each
    of their methods the session calls (and around the service's
    ``baseline_time``, which ``observe_slot`` calls, and ``resolve``,
    which the engine calls once more for ``observe_slot``'s slot); then
    one with both unbound, for the resolves the step makes anyway.  Not
    part of the ratios: the wrappers cost a call each.  Both drains'
    tokens must equal ``want``.  Returns the phase fields: for each
    method, µs per decode step, calls, and the median and largest call
    in µs; and the collector's passes and ms in each drain (a pass
    inside a tap lands in that tap's largest call)."""
    taps = {wd: ("observe_slot", "note_step", "tick", "note_ttft",
                 "note_queue", "note_terminal"),
            rec: ("record_span", "record_metric", "note_allocator"),
            svc: ("baseline_time", "resolve")}
    calls = {}
    collector = {"n": 0, "s": 0.0, "t0": 0.0}

    def timed(obj, name):
        """Shadow ``obj.name`` with a wrapper that logs each call's
        seconds."""
        fn = getattr(obj, name)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                calls.setdefault(name, []).append(time.perf_counter() - t0)
        setattr(obj, name, wrapped)

    def on_gc(stage, info):
        """The collector's passes and time."""
        if stage == "start":
            collector["t0"] = time.perf_counter()
        else:
            collector["n"] += 1
            collector["s"] += time.perf_counter() - collector["t0"]

    for obj, names in taps.items():
        for name in names:
            timed(obj, name)
    gc.callbacks.append(on_gc)
    out = {}
    try:
        for on in (True, False):
            side = "on" if on else "off"
            session._watchdog, session._recorder = (wd, rec) if on else (
                None, None)
            calls.clear()
            collector.update(n=0, s=0.0)
            tokens, steps, _ = timed_drain(torch, session, prompts,
                                           f"{label} taps timed")
            if tokens != want:
                fail(f"{label} taps timed: other tokens than the turns'")
            out["taps_" + side] = json.dumps({
                k: {"us_per_step": round(1e6 * sum(v) / len(steps), 3),
                    "calls": len(v),
                    "median_us": round(1e6 * sorted(v)[len(v) // 2], 3),
                    "max_us": round(1e6 * max(v), 3)}
                for k, v in sorted(calls.items())})
            out["taps_steps_" + side] = len(steps)
            out["gc_passes_" + side] = collector["n"]
            out["gc_ms_" + side] = round(1e3 * collector["s"], 3)
    finally:
        gc.callbacks.remove(on_gc)
        for obj, names in taps.items():
            for name in names:
                delattr(obj, name)
        session._watchdog, session._recorder = wd, rec
    return out


def telemetry_overhead(torch, model, params, prompts, smi, clean):
    """``[telemetry_overhead]``: the engine phase's 8 requests, warm, in
    turns off / on / on / off on one session with graphs (drained once
    cold first, not timed), so that both sides replay the same graphs
    over the same pool.  First telemetry (spans, lifecycle, histograms,
    gauges: a fresh bundle swapped in for each on turn, the shared
    disabled one for each off turn; batch sizes (1, 2, 4), no
    dispatch; tokens equal to the engine phase's).  Then the watchdog
    (SLOs ``ttft_p95<=10``, ``queue_p95<=10``, ``error_rate<=0.5``, the
    decode slot's drift watch) and the flight recorder, unbound for the
    off turns, over telemetry, on a session with a ``DispatchService``
    at batch size 4 (as ``[dispatch_serve]``: the service's bucket
    choice would move falcon-mamba to other rows); its committed
    schedule runs in every timed drain.  Gated: the smaller ratio of
    the two pairs' median decode step and median boundary <= 1.05;
    the healthy drains fire no drift, page no SLO and dump nothing.
    ``[trace_artifacts]``: the last telemetry turn's trace, Prometheus
    text and lifecycle JSON, which ``tools/check_trace.py`` (a
    subprocess; it imports neither package) must accept."""
    import tempfile
    from repro_torch.core import registry as reg
    from repro_torch.obs import (NULL_TELEMETRY, FlightRecorder,
                                 MetricsRegistry, PerformanceWatchdog,
                                 Telemetry)
    from repro_torch.runtime.dispatch import DispatchService
    from repro_torch.serving import ServeSession

    arch = model.cfg.name
    free_card(torch)
    label = f"{arch} [telemetry_overhead]"
    sess = ServeSession(model, params, backend="cuda",
                        batch_sizes=ENGINE_BATCH_SIZES)
    if timed_drain(torch, sess, prompts, f"{label} cold")[0] != clean:
        fail(f"{label} cold: other tokens than the engine phase's")

    last = {}

    def telemetry_on():
        """A fresh bundle for this drain (the last is the artifacts')."""
        sess.telemetry = last["bundle"] = Telemetry(
            metrics=MetricsRegistry())
        sess._register_instruments()

    def telemetry_off():
        sess.telemetry = NULL_TELEMETRY

    tel_ms, _ = in_turns(torch, sess, {"off": telemetry_off,
                                       "telemetry": telemetry_on},
                         ["off", "telemetry", "telemetry", "off"],
                         prompts, label, clean)

    # [trace_artifacts]: the last telemetry drain's bundle
    tel = last["bundle"]
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        trace, prom, life = (Path(tmp) / "trace.json",
                             Path(tmp) / "metrics.prom",
                             Path(tmp) / "lifecycle.json")
        tel.tracer.write(str(trace))
        tel.metrics.write_prometheus(str(prom))
        life.write_text(json.dumps(tel.lifecycle.as_dicts()))
        checked = subprocess.run(
            [sys.executable, str(REPO / "tools" / "check_trace.py"),
             "--trace", str(trace), "--metrics", str(prom),
             "--lifecycle", str(life),
             "--require", "serve_ttft_seconds",
             "--require", "serve_decode_step_seconds",
             "--require", "serve_requests_completed_total",
             "--require", "serve_exec_cache_hits_total"],
            capture_output=True, text=True, timeout=120)
        sizes = {p.name: p.stat().st_size for p in (trace, prom, life)}
    if checked.returncode != 0:
        fail(f"{arch} [trace_artifacts]: check_trace.py refused the "
             f"artifacts: {checked.stdout.strip()} {checked.stderr.strip()}")
    events = tel.tracer.to_chrome()["traceEvents"]
    names = {}
    for e in events:
        if e["ph"] == "X":
            names[e["name"]] = names.get(e["name"], 0) + 1
    recs = tel.lifecycle.as_dicts()
    if len(recs) != len(prompts) or any(
            r["state"] != "COMPLETED" or not r["ttft_s"] for r in recs):
        fail(f"{arch} [trace_artifacts]: lifecycle records {recs}")
    phase("trace_artifacts", arch=arch, card=repr(smi),
          check_trace=repr(checked.stdout.strip()),
          trace_events=len(events),
          spans=sum(names.values()), span_counts=json.dumps(names),
          instants=sum(e["ph"] == "i" for e in events),
          request_tracks=sum(e["ph"] == "b" for e in events),
          lifecycle_records=len(recs),
          metric_families=len(tel.metrics.names()),
          ttft_count=tel.metrics.histogram("serve.ttft_seconds").count,
          decode_step_count=tel.metrics.histogram(
              "serve.decode_step_seconds").count,
          bytes=json.dumps(sizes))
    del sess
    free_card(torch)

    # the watchdog and the recorder over telemetry, on a dispatched
    # session: bound at construction, unbound for the off turns
    svc = DispatchService(reg.TuningRegistry(None), device=params[
        "embed"].device, metrics=MetricsRegistry())
    wd = PerformanceWatchdog(("ttft_p95<=10", "queue_p95<=10",
                              "error_rate<=0.5"))
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        rec = FlightRecorder(out_dir=str(Path(tmp) / "postmortems"))
        sess = ServeSession(
            model, params, backend="cuda", batch_sizes=(4,), dispatch=svc,
            telemetry=Telemetry(metrics=MetricsRegistry()), watchdog=wd,
            recorder=rec)
        timed_drain(torch, sess, prompts, f"{label} dispatched cold")

        def watchdog(on):
            """Bind or unbind the watchdog and the recorder."""
            def switch():
                sess._watchdog, sess._recorder = (wd, rec) if on else (
                    None, None)
            return switch

        steps0 = sess.stats.steps
        wd_ms, wd_tokens = in_turns(torch, sess, {"telemetry": watchdog(False),
                                          "watchdog": watchdog(True)},
                            ["telemetry", "watchdog", "watchdog",
                             "telemetry"], prompts, label)
        steps = sess.stats.steps - steps0
        taps = tap_times(torch, sess, svc, wd, rec, prompts, label,
                         wd_tokens)
        report = wd.report()
        pages = sum(int(v["pages"]) for v in report["slo"].values())
        events = [e.kind for e in sess.stats.events]
        dumps = dict(rec.dumps)
    if report["drifts"] or pages or dumps or events:
        fail(f"{label}: a healthy drain drifted {report['drifts']}, paged "
             f"{pages}, dumped {dumps}, events {events}")
    if not report["slots"] or not svc.is_committed(next(iter(
            report["slots"]))):
        fail(f"{label}: the watchdog watched no committed slot "
             f"({report['slots']})")
    ratios = {"telemetry_step": min_ratio(tel_ms, "telemetry", "off",
                                          "step"),
              "telemetry_boundary": min_ratio(tel_ms, "telemetry", "off",
                                              "boundary"),
              "watchdog_step": min_ratio(wd_ms, "watchdog", "telemetry",
                                         "step"),
              "watchdog_boundary": min_ratio(wd_ms, "watchdog", "telemetry",
                                             "boundary")}

    def ms(x):
        """Medians in ms, as a JSON list."""
        return json.dumps([round(v, 4) for v in x])
    phase("telemetry_overhead", arch=arch, card=repr(smi),
          order="off telemetry telemetry off | telemetry watchdog watchdog "
                "telemetry (one session each, drained cold first, not "
                "timed)",
          off_step_ms=ms(tel_ms["off"]["step"]),
          telemetry_step_ms=ms(tel_ms["telemetry"]["step"]),
          off_boundary_ms=ms(tel_ms["off"]["boundary"]),
          telemetry_boundary_ms=ms(tel_ms["telemetry"]["boundary"]),
          wd_control_step_ms=ms(wd_ms["telemetry"]["step"]),
          watchdog_step_ms=ms(wd_ms["watchdog"]["step"]),
          wd_control_boundary_ms=ms(wd_ms["telemetry"]["boundary"]),
          watchdog_boundary_ms=ms(wd_ms["watchdog"]["boundary"]),
          **{f"min_ratio_{k}": f"{v:.4f}" for k, v in ratios.items()},
          **taps,
          drifts=report["drifts"], slo_pages=pages, dumps=len(dumps),
          slots_watched=len(report["slots"]), timed_steps=steps,
          tokens_equal=True)
    worst = max(ratios.values())
    if worst > 1.05:
        fail(f"{label}: min on/off ratio {worst:.4f} > 1.05 ({ratios})")
    del sess, svc, wd, rec
    free_card(torch)


def drift_loop(torch, model, params, prompts, new_tokens, batch, label):
    """``tests/test_watchdog.py``'s loop on the card: a dispatched engine
    (graphs, a ``DispatchService`` on an in-memory registry and a private
    metrics registry, ``max_recompiles=3``) drains ``prompts`` once
    without a fault, which gives the step at which the decode slot
    commits (``c``), then on a fresh service with ``slow@S x4``, S = c +
    8 (past the two rounds of extra probes a later commit may take), a
    watchdog (ratio 3, patience 2) and a flight recorder.  Gated: the
    slot commits before S, the drift alarm fires within patience steps
    of S, reopens the slot, which commits again by the drain's end, and
    ``postmortem-drift.json`` names the slot, its old schedule and the
    new one.  Returns the fields of its phase line and both runs'
    tokens."""
    import tempfile
    from repro_torch.core import registry as reg
    from repro_torch.obs import (FlightRecorder, MetricsRegistry,
                                 PerformanceWatchdog, Telemetry)
    from repro_torch.runtime.dispatch import DispatchService
    from repro_torch.serving import FaultInjector, ServeSession

    dev = params["embed"].device
    kind = "ssm_scan" if model.cfg.attention_free else "decode_attention"

    def decode_slot(svc):
        """The engine's decode slot: of its kind, one token a row (the
        scan), its rows, observed."""
        for key, e in svc.measured_table().items():
            p = e["problem"]
            if (e["kind"] == kind and e["observations"]
                    and p.get("b", p.get("bt")) == batch
                    and p.get("seq", 1) == 1):
                return key, p
        return None, None

    def run(spec=None, out_dir=None):
        svc = DispatchService(reg.TuningRegistry(None), device=dev,
                              metrics=MetricsRegistry())
        wd = rec = None
        if spec is not None:
            wd = PerformanceWatchdog(ratio=3.0, patience=2)
            rec = FlightRecorder(out_dir=out_dir)
        s = ServeSession(
            model, params, backend="cuda", batch_sizes=(batch,),
            dispatch=svc, max_recompiles=3, straggler_threshold=1e9,
            faults=(FaultInjector.from_strings([spec])
                    if spec is not None else None),
            telemetry=Telemetry(metrics=MetricsRegistry()), watchdog=wd,
            recorder=rec)
        trail = []          # (step, committed) whenever it changes
        found = {}

        def on_step(info):
            """Note the decode slot's commit state after each step."""
            if not found:
                key, prob = decode_slot(svc)
                if key is None:
                    return
                found.update(slot=key, problem=prob)
            c = svc.is_committed(found["slot"])
            if not trail or trail[-1][1] != c:
                trail.append((s._step_count - 1, c))

        for i, p in enumerate(prompts):
            s.submit(p, new_tokens, request_id=f"r{i}")
        res = {r.request_id: r for r in s.drain(on_step=on_step)}
        torch.cuda.synchronize()
        bad = [r.request_id for r in res.values()
               if r.state != "COMPLETED" or len(r.tokens) != new_tokens]
        if len(res) != len(prompts) or bad or not found:
            fail(f"{label}: not completed: {bad}, decode slot {found}")
        return (svc, found["slot"], found["problem"], wd, rec, s, trail,
                {k: v.tokens.tolist() for k, v in res.items()})

    _, _, prob, _, _, s0, trail0, clean = run()
    commits0 = [st for st, c in trail0 if c]
    if not commits0:
        fail(f"{label}: the decode slot {prob} did not commit in "
             f"{s0.stats.steps} steps")
    start = commits0[0] + 8
    spec = f"slow@{start}x4"
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        svc, slot, prob, wd, rec, s, trail, tokens = run(spec, tmp)
        path = Path(tmp) / "postmortem-drift.json"
        bundle = json.loads(path.read_text()) if path.exists() else None
    drifts = [e for e in s.stats.events if e.kind == "drift"]
    commits = [st for st, c in trail if c]
    if not commits or commits[0] >= start:
        fail(f"{label}: the decode slot committed at {commits[:1]}, not "
             f"before the fault at step {start} (trail {trail})")
    if not drifts or not start <= drifts[0].step <= start + wd.patience:
        fail(f"{label}: drift events at "
             f"{[e.step for e in drifts]}, want one in "
             f"[{start}, {start + wd.patience}] ({wd.report()})")
    ev = drifts[0]
    reopened = [st for st, c in trail if not c and st >= ev.step]
    if not ev.data["reopened"] or not reopened \
            or svc.metrics.counter("dispatch.reopens_total").value < 1:
        fail(f"{label}: the drift alarm did not reopen the slot "
             f"({ev.as_dict()}, trail {trail})")
    recommits = [st for st, c in trail if c and st > reopened[0]]
    new = svc.committed_schedule(slot)
    if not recommits or new is None:
        fail(f"{label}: the reopened slot did not commit again "
             f"(trail {trail})")
    old = ev.data["old_schedule"]
    bev = None if bundle is None else next(
        (e for e in bundle["timeline"] if e.get("kind") == "drift"), None)
    if (bev is None or bev["slot"] != slot or bev["old_schedule"] != old
            or old is None
            or bundle["schedules"][slot]["committed"] != new):
        fail(f"{label}: postmortem-drift.json does not name the slot, "
             f"the old schedule {old} and the new {new}: {bundle}")
    flat = [(r, i) for r in sorted(clean) for i in range(new_tokens)]
    agree = sum(tokens[r][i] == clean[r][i] for r, i in flat) / len(flat)
    st = s.stats
    fields = dict(
        slot=repr(prob), kind=kind, fault=spec, commit_step=commits[0],
        clean_commit_step=commits0[0], drift_step=ev.step,
        drift_ratio=f"{ev.data['ratio']:.1f}",
        baseline_ms=f"{1e3 * ev.data['baseline_s']:.4f}",
        reopen_step=reopened[0], recommit_step=recommits[0],
        old_schedule=json.dumps(old), new_schedule=json.dumps(new),
        recaptures=st.recompiles, free_switches=st.free_switches,
        commits_seen=st.commits_seen,
        commits_total=int(svc.metrics.counter(
            "dispatch.commits_total").value),
        drifts=len(drifts), dumps=json.dumps(dict(rec.dumps)),
        events=json.dumps([e.kind for e in st.events]),
        steps=st.steps, token_agreement_with_clean=f"{agree:.4f}")
    return fields, tokens, clean


def watchdog_drift(torch, model, params, prompts, smi):
    """``[watchdog_drift]``: :func:`drift_loop` on the full-size model at
    batch size 4 over the engine phase's 8 requests; the tokens of the
    faulted run beside the clean run's are reported, not gated (another
    schedule sums bf16 in another order)."""
    free_card(torch)
    fields, _, _ = drift_loop(torch, model, params, prompts, NEW_TOKENS, 4,
                              f"{model.cfg.name} [watchdog_drift]")
    phase("watchdog_drift", arch=model.cfg.name, card=repr(smi), **fields)
    free_card(torch)


def exact_watchdog_drift(torch, dev, arch):
    """Smoke config in float32: :func:`drift_loop` (6 requests, 24 new
    tokens, batch size 2) must give the plain path's tokens, with the
    drift, the reopen and the re-commit on the way."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServeSession

    scfg = get_config(arch)
    smodel = build_model(scfg)
    sparams = smodel.init(seed=0, device=dev)
    prompts = prompts_of([40, 37, 51, 44, 33, 60], scfg.vocab_size, seed=6)
    fields, tokens, clean = drift_loop(torch, smodel, sparams, prompts, 24, 2,
                                       f"{arch} [watchdog_drift]")
    plain = ServeSession(smodel, sparams, backend="plain", batch_sizes=(2,))
    for i, p in enumerate(prompts):
        plain.submit(p, 24, request_id=f"r{i}")
    want = {r.request_id: r.tokens.tolist() for r in plain.drain()}
    if tokens != want or clean != want:
        fail(f"{arch} [watchdog_drift]: tokens differ from the plain "
             f"path's")
    phase("watchdog_drift", arch=scfg.name, dtype="float32",
          equal_to_plain=True, **fields)


def _leaves(tree):
    """Tensors of a nested parameter dict."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
