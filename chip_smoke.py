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
   step; ``[degrade]`` (``fallback_backend="eager"``): ``compile@0x999``
   degrades every bucket (its uncaptured rebuild fails too, so the
   same uncaptured step runs): every admission and step still launches
   its kernels, one a layer, and the tokens equal the engine phase's;
   ``compile@0x1`` without retries degrades only the first bucket built
   (its uncaptured build succeeds), the other buckets are captured, and
   every request keeps its tokens;
   the degraded and non-degraded decode step ms and tok/s ratio are
   printed; no bucket of any other phase may degrade (a log handler
   fails the run at the next phase line); ``[step_exception]``: a
   decode step that raises once at step 5, after it ran, fails the
   rows in flight with a prefix of their tokens, the queue drains,
   the requests admitted later keep their tokens, one
   ``step_exception`` event and its postmortem; a prefill that raises
   once fails only its request; ``[lifecycle_overhead]``: warm drains
   with and without ``request_deadline_s=3600`` and an empty injector,
   in turns (step
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
7a. the rest of the dense family and moe at full width and depth in
   bf16 (random weights, seed 0): ``[dense_family]`` minitron-4b,
   nemotron-4-15b and qwen3-32b (GQA groups 3, 6 and 8, squared-ReLU
   MLPs, qk-norm; qwen3-32b's 65.5 GB drawn a layer at a time where a
   tensor passes 2**32 elements) and ``[moe]`` qwen2-moe-a2.7b, each
   the engine phase's 8 requests with graphs, one cold drain (moe: a
   warm one too), with one flash launch a layer per admission and one
   paged decode launch a layer per step (moe: each bucket's capacity
   and each drain's dropped slots, the warm drain's being one drain's
   replays alone, and ``[moe_rounding]``: layer 0's FFN with its
   expert products rounded to bf16, the port's, against the same in
   float32, the JAX arithmetic; printed, not gated); exact tokens
   (graphs, eager, plain) on the float32
   smoke configs of all five new architectures, llama4-scout-17b-a16e
   included (its ~215 GB of bf16 do not fit one card); and
   ``[sticky_error]``: a child process whose decode step first runs an
   out-of-bounds index on the card (a device-side assert) must see
   ``drain`` raise the step's error and exit non-zero, the session
   recording no ``step_exception``;
7b. the hybrid, vlm and audio families (after phase 7a), served as in
   JAX through the bucketed path only: ``[hybrid]`` recurrentgemma-9b
   (12 groups of RG-LRU, RG-LRU, local attention and two RG-LRU
   layers; 16 query heads on one KV head, head_dim 256), ``[vlm]``
   paligemma-3b (256 image tokens before the text) and ``[audio]``
   whisper-large-v3 (32 encoder layers over 1500 frames, 32 decoder
   layers with cross-attention), each at full width and depth in bf16
   with random weights from seed 0 and ``image_embeds`` / ``frames``
   from a generator seeded 2: the 8 engine requests, greedy, 32 new
   tokens, one cold drain with graphs at batch sizes (1, 2, 4), its
   launches gated at one flash launch a prefill per attention layer
   (12, 18, and 64: whisper's 32 encoder layers run the non-causal
   body) and one contiguous decode launch a step per self-attention
   layer (12, 18, 32); recurrentgemma also serves one request of 2,100
   tokens (``[hybrid_long]``: bucket 4096, the prefill's flash windowed
   at 2048, every decode step in the wrapped rolling buffer);
   ``[family_profile]``: the widest captured decode step replayed 10
   times under ``torch.profiler`` (device ms a step by kernel group,
   busy share, top kernels); then ``[family_vs_plain]``: the same requests eagerly, every kernel call
   held to its plain version, tokens equal to the graphs drain's; and
   exact tokens (graphs, eager, plain) of ``drain`` and ``generate``
   with extras on the three float32 smoke configs, whose prompts pass
   their local window of 16.  Phase 3 holds the three families' new
   kernel shapes (``[time_family]``): the windowed flash at
   [1, 16, 4096, 256], the non-causal flash at [4, 20, 1500, 64] and
   the contiguous decode over a wrapped buffer of 2048 slots;
7c. training (after phase 7b; the card freed first): ``[train]``
   ``Trainer`` on full-width, full-depth phi3-mini-3.8b in bf16
   (``backend="plain"``: neither package has a kernel backward), random
   weights from seed 0, the port's ``DataPipeline`` (seed 0), batch 4 x
   512 tokens, 8 steps, lr 3e-5 with 2 warmup steps, remat "full": each
   step's loss and grad norm, the step ms (median of steps 2-7, host
   clock, synchronised), tokens/s, TFLOP/s at 6 N tokens (remat's
   recompute not counted), peak allocated and reserved GiB; gated:
   every loss and grad norm finite, the last loss below the first,
   every leaf moved (against a re-init from the seed); then
   ``[train_eval]``: on the trained weights and step 0's batch, under
   ``no_grad``, ``loss_fn(backend="cuda")`` against plain
   (:data:`TRAIN_EVAL_RTOL`), gated at one flash launch a layer (32);
   ``[train_refuses]``: with grad on, ``backend="cuda"`` raises
   ``KernelGradError`` and no kernel launches; ``[train_profile]``: one
   more step under ``torch.profiler`` (device ms by kernel group, busy
   share, top kernels); ``[train_apply]``: one
   ``adamw.apply`` on the full state (CUDA events, median of 3) beside
   its byte bound; ``[train_exact]``: 4 steps of the float32 smoke
   configs of minitron-4b, qwen2-moe-a2.7b, falcon-mamba-7b,
   recurrentgemma-9b, paligemma-3b and whisper-large-v3 on the card and
   on the CPU in this process, losses within :data:`TRAIN_EXACT_RTOL`;
   ``[train_restart]``: ``launch/elastic_restart`` on the card (resumed
   at step 10, shard layouts equal), then minitron-4b-smoke trained to
   step 10 of 15 with checkpoints every 5 and resumed by a fresh
   trainer: the restored tensors byte-equal to the ones saved, steps
   10-14's losses equal to an uninterrupted 15-step run's; and
   ``run_with_restart`` with a ``RuntimeError`` injected once after the
   step-5 checkpoint: one restart, the run ends at step 10;
   ``[train_lm]``: ``launch/train_lm`` (lm-100m, float32, 100 steps of
   8 x 256 tokens, checkpoints at 50 and 100 in a temporary directory,
   removed after): tokens/s, first and final loss; every training
   phase prints its seconds;
7d. after the training phases: ``[chunked]`` the ``Trainer`` on full
   phi3-mini-3.8b (bf16, ``[train]``'s optimizer and seed, 5 steps)
   with ``backend="chunked"`` beside ``"plain"`` at ``[train]``'s 4 x
   512 and at train_4k's 4096 tokens x 1: step ms (median of steps
   2-4), peak allocated GiB, losses within :data:`CHUNKED_RTOL` of
   plain's (a run out of memory is printed, not shrunk);
   ``[roofline]`` the analytic terms of every config at the four
   ``SHAPES`` on the H100's peaks (989e12 FLOP/s, 3.35e12 B/s; skipped
   cells named); ``[mesh]`` a one-process NCCL group (``HashStore``)
   and a (1, 1) ``(data, model)`` mesh: the meshed ``Trainer`` takes
   ``[train]``'s 8 steps with DTensor parameters and moments (losses
   within :data:`MESH_RTOL` of ``[train]``'s, step ms beside
   ``[train]``'s), ``allreduce_compressed`` over the group against
   ``compress_tree``'s round trip (:data:`ALLREDUCE_ATOL`), and
   ``[mesh_family]`` six float32 smoke configs (every family) meshed
   against unmeshed; the group is destroyed after; ``[dryrun]``
   ``launch/dryrun`` on a fake process group (host work, no card):
   full qwen3-32b x train_4k, qwen2-moe-a2.7b x prefill_32k and
   falcon-mamba-7b x decode_32k on 16 x 16 with the two-point
   calibration, qwen3-32b x train_4k on 2 x 16 x 16 (status, seconds,
   GiB a device, flops, collective bytes by kind, dominant term, mfu;
   gated: ok, finite terms, the calibration's extension equal to the
   full count); ``[dryrun_vs_card]`` the ``[train]`` cell dry-run on a
   (1, 1) fake mesh beside one real step on the card under the same
   counter (flops equal exactly; the dry-run's bytes a device over
   ``[train]``'s peak allocated within :data:`DRYRUN_MEMORY_RATIO`;
   the roofline step ms beside ``[train]``'s);
   ``[launch_serving]`` ``launch/serve_lm`` on full phi3-mini-3.8b
   (batch 4, prompt 16, 24 new tokens), ``serve_session`` and
   ``serve_adaptive`` at their smoke defaults, each to its summary
   line;
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
   the probed schedules make counted exactly;
9. the thesis' design-space tools (after phase 8): ``[loki]``
   ``launch/tune_conv`` (the 720-permutation Loki sweeps of Table 4.1,
   static candidates, top pair, sampling bounds, both permutohedron
   searches) on a temporary registry, cold then warm (the warm sweeps
   must make 0 cost-model evaluations, and both runs print the same
   sections), and ``python -m repro_torch.tune ecm --config
   squeezenet_layers`` in a child process (its exact consultation
   rate); host seconds on the card's machine, no device work;
   ``[quickstart]``: ``launch/quickstart`` on the card (Loki sweep, the
   H100 model's top two float32 conv schedules, each run through the
   hand-written conv2d body and held to its plain version at 1e-5,
   micro-profiled with CUDA events, the committed index): the conv
   launch count must rise;
10. ``[tune_cli]`` (after phase 6): the measured records the card wrote
   (phase 8's dispatch services and both ``[dispatch_serve]`` engines,
   their slots and ``serve_decode``, each on a temporary registry file)
   and phase 9's Loki and ECM records, merged into one file ``P``;
   ``python -m repro_torch.tune --registry P`` in child processes runs
   ``stats``, ``serve-report``, ``doctor --ratio 3``, ``export``,
   ``merge`` into an empty file and then ``invalidate --kind
   conv_sweep``: every command must exit 0, ``serve-report`` must find
   every measured record written back, the merged file must hold the
   source's records and ``invalidate`` must drop exactly the sweeps;
   one line per kind with its measured records and, for the thesis
   kinds (conv, matmul, sparse conv), those ``doctor`` flags outside
   [1/3, 3] (an observation, not a gate) and the median
   measured/predicted ratio; the serving kinds' lines say "not
   comparable" (their median is a host-timed step of every layer, the
   prediction one kernel call).

The line before the last is the kernels' JSON summary, the last line
``{"ok": true, "device": {...}}``.
"""
import contextlib
import gc
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


class DegradeWatch(logging.Handler):
    """Every session's ``degrading <bucket> ...`` warning: one that comes
    while ``allowed`` is False (any phase but ``[degrade]``, which
    injects the build faults) fails the run at the next phase line."""

    def __init__(self):
        """Start with no degradation allowed."""
        super().__init__(logging.WARNING)
        self.allowed = False
        self.unexpected = []

    def emit(self, record):
        """Note an unexpected degradation."""
        msg = record.getMessage()
        if msg.startswith("degrading ") and not self.allowed:
            self.unexpected.append(msg)


DEGRADE_WATCH = DegradeWatch()


def phase(tag, /, **fields):
    """Print one phase line, ending in the seconds since the start; fail
    if a bucket degraded where no build fault was injected."""
    if DEGRADE_WATCH.unexpected:
        fail(f"a bucket degraded without an injected fault before "
             f"[{tag}]: {DEGRADE_WATCH.unexpected}")
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
    family_kernel_cases(torch, dev, timer, rn, check, summary)
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


def family_kernel_cases(torch, dev, timer, rn, check, summary):
    """Phase 3, the hybrid, vlm and audio families' shapes (bf16): the
    windowed flash prefill of recurrentgemma-9b's long bucket (16 query
    heads on one KV head, head_dim 256, causal, window 2048), the
    non-causal flash of whisper-large-v3's encoder ([4, 20, 1500, 64])
    and the contiguous decode over recurrentgemma's wrapped rolling
    buffer (2048 slots, pos past it).  Each is held to its plain version
    (the decode also to the model's windowed plain path), timed with
    CUDA events beside its bound and SDPA on the same inputs, printed as
    ``[time_family]`` and added to its kernel's summary entry
    (``family_shapes``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels.decode_attention import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import attention as model_attention

    bf16 = torch.bfloat16

    def record(kernel, shape, ms, plain_ms, n_bytes, n_ops, lib_ms, err):
        """One ``[time_family]`` line and its summary record."""
        b_ms, b_by = bound(n_bytes, n_ops, "bfloat16")
        row = dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, max_abs_err=err)
        summary[kernel].setdefault("family_shapes", []).append(row)
        phase("time_family", kernel=kernel, shape=repr(shape),
              ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              bound_ms=f"{b_ms:.4f}", bound_by=b_by,
              library_ms=f"{lib_ms:.4f}", max_abs_err=f"{err:.3g}")

    def err_of(got, want):
        """Max abs error of ``got`` against ``want``."""
        return (got.float() - want.float()).abs().max().item()

    # recurrentgemma-9b: the 2,100-token prompt's bucket of 4096 with the
    # local window of 2048
    s, d, hq, win = 4096, 256, 16, 2048
    q = rn((1, hq, s, d), bf16)
    k, v = rn((1, 1, s, d), bf16), rn((1, 1, s, d), bf16)
    got = flash_attention(q, k, v, causal=True, window=win)
    want = flash_attention_ref(q, k, v, causal=True, window=win)
    shape = f"q [1,{hq},{s},{d}], k/v [1,1,{s},{d}] bf16, causal, window {win}"
    check("flash_attention", got, want, shape)
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(s, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - win)
    pairs = int(mask.sum().item())          # (query, key) pairs computed
    record("flash_attention", shape,
           timer(lambda: flash_attention(q, k, v, causal=True, window=win)),
           timer(lambda: flash_attention_ref(q, k, v, causal=True,
                                             window=win), iters=5),
           (2 * hq + 2) * s * d * 2, 4 * d * hq * pairs,
           timer(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, enable_gqa=True)),
           err_of(got, want))
    del q, k, v, got, want, mask
    # whisper-large-v3's encoder: 1500 frames, 20 heads of 64, no mask
    b, hq, s, d = 4, 20, 1500, 64
    q = rn((b, hq, s, d), bf16)
    k, v = rn((b, hq, s, d), bf16), rn((b, hq, s, d), bf16)
    got = flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    shape = f"q,k,v [{b},{hq},{s},{d}] bf16, non-causal"
    check("flash_attention", got, want, shape)
    record("flash_attention", shape,
           timer(lambda: flash_attention(q, k, v, causal=False)),
           timer(lambda: flash_attention_ref(q, k, v, causal=False),
                 iters=5),
           4 * b * hq * s * d * 2, 4 * d * b * hq * s * s,
           timer(lambda: F.scaled_dot_product_attention(q, k, v)),
           err_of(got, want))
    del q, k, v, got, want
    # recurrentgemma-9b's decode over its wrapped rolling buffer: every
    # slot valid at each of these positions
    b, hq, s, d = 4, 16, 2048, 256
    pos = torch.tensor([2048, 2500, 3000, 4127], device=dev)
    q = rn((b, hq, 1, d), bf16)
    k, v = rn((b, 1, s, d), bf16), rn((b, 1, s, d), bf16)
    got = decode_attention(q, k, v, pos)
    want = decode_attention_ref(q, k, v, pos)
    shape = (f"q [{b},{hq},1,{d}], rolling k/v [{b},1,{s},{d}] bf16, "
             f"pos {pos.tolist()}")
    check("decode_attention", got, want, shape)
    check("decode_attention", got, model_attention.decode_attention(
        q, k, v, pos, window=s, backend="plain"), shape + " (model, window)")
    record("decode_attention", shape,
           timer(lambda: decode_attention(q, k, v, pos)),
           timer(lambda: decode_attention_ref(q, k, v, pos)),
           2 * b * hq * d * 2 + 2 * b * s * d * 2 + b * 8,
           4 * d * hq * b * s,
           timer(lambda: F.scaled_dot_product_attention(
               q, k, v, enable_gqa=True)),
           err_of(got, want))


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


def card_registry(records, name):
    """The registry file ``<name>.jsonl`` in ``records``, which
    ``[tune_cli]`` reads after the phases that measure."""
    from repro_torch.core import registry as reg
    return reg.TuningRegistry(str(records / f"{name}.jsonl"))


def thesis_dispatch(torch, dev, timer, data, records):
    """The thesis path's main path: every (layer, batch) through
    ``conv2d_dispatched`` in bf16 until its slot commits (the conv slot's
    problem holds the batch), each batch size with its own service and
    registry (a file in ``records``); the GEMM shapes through ``matmul_dispatched``; the sparse
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
        svc = DispatchService(card_registry(records, f"thesis_conv_n{nb}"),
                              device=dev)
        services.append(svc)
        for name, (l, img32, wgt32) in data["conv"].items():
            img, wgt = img32[:nb].to(bf16), wgt32.to(bf16)
            problem = {"oc": l.oc, "ic": l.ic, "h": l.h, "w": l.w,
                       "kh": l.kh, "kw": l.kw, "n": nb}
            drive(svc, "conv2d", problem,
                  lambda: conv2d_dispatched(img, wgt, service=svc),
                  f"conv2d {name} N={nb}")
    svc = DispatchService(card_registry(records, "thesis_matmul"),
                          device=dev)
    services.append(svc)
    for label, a32, b32 in gemm_shapes(data):
        a, b = a32.to(bf16), b32.to(bf16)
        problem = {"m": a.shape[0], "n": b.shape[1], "k": a.shape[1]}
        drive(svc, "matmul", problem,
              lambda: matmul_dispatched(a, b, service=svc),
              f"matmul {label}")
    for nb in THESIS_BATCHES:
        svc = DispatchService(card_registry(records, f"thesis_sparse_n{nb}"),
                              device=dev)
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


# ---------------------------------------------------------------------------
# The thesis' design-space tools, the quickstart and the tune CLI
# ---------------------------------------------------------------------------

def tune_cli(records, *argv):
    """Start ``python -m repro_torch.tune`` in a child process."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.tune",
                             *argv], cwd=records, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish(proc, what, timeout=300):
    """Wait for a child started by :func:`tune_cli`; its stdout, or fail
    with its stderr when it exits with another code than 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"[tune_cli] {what}: no exit within {timeout} s")
    if proc.returncode != 0:
        fail(f"[tune_cli] {what} exited {proc.returncode}: {err[-2000:]}")
    return out


def loki_phase(smi, records):
    """``[loki]``: ``launch/tune_conv`` cold then warm on a registry file
    in ``records``, and the three-tier ``ecm`` sweep of Table 4.1 in a
    child process over the same file.  Host work only: the seconds are
    the card machine's host clock."""
    import io
    from repro_torch.core.registry import TuningRegistry
    from repro_torch.launch import tune_conv

    path = records / "loki.jsonl"
    runs = {}
    for tag in ("cold", "warm"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = tune_conv.main(TuningRegistry(str(path)))
        runs[tag] = (res, buf.getvalue().splitlines())
    (cold, cold_lines), (warm, warm_lines) = runs["cold"], runs["warm"]
    if warm["sweep_evals"] != 0:
        fail(f"[loki] the warm sweeps made {warm['sweep_evals']} cost-model "
             f"evaluations")
    if cold["sweep_evals"] != 8 * 720 or warm_lines[1:] != cold_lines[1:] \
            or len(cold_lines) != 22:
        fail(f"[loki] tune_conv: {cold['sweep_evals']} cold evaluations, "
             f"warm output equal: {warm_lines[1:] == cold_lines[1:]}")
    t0 = time.perf_counter()
    out = finish(tune_cli(records, "--registry", str(path), "ecm",
                          "--config", "squeezenet_layers"), "ecm")
    ecm_s = time.perf_counter() - t0
    m = re.search(r"scored in ([0-9.]+)s; exact consultation rate "
                  r"([0-9.]+)% \(([0-9]+) traces / ([0-9]+) candidates\)",
                  out)
    if m is None or out.count(" tier=") != 8:
        fail(f"[loki] ecm printed no summary for 8 layers: {out[-500:]}")
    pair = next(line for line in cold_lines
                if " + " in line).strip()
    phase("loki", clock="host (no device work)",
          tune_conv_cold_s=f"{cold['seconds']:.3f}",
          tune_conv_warm_s=f"{warm['seconds']:.3f}",
          sweeps_cold_ms=f"{cold['sweep_s'] * 1e3:.1f}",
          sweeps_warm_ms=f"{warm['sweep_s'] * 1e3:.1f}",
          sweep_evals_cold=cold["sweep_evals"], sweep_evals_warm=0,
          search_evals=warm["evals"], top_pair=repr(pair),
          ecm_scored_s=m.group(1), ecm_child_s=f"{ecm_s:.2f}",
          ecm_consultation_rate=f"{m.group(2)}%",
          ecm_traces=m.group(3), ecm_candidates=m.group(4),
          card=repr(smi))


def quickstart_phase(dev, timer, smi):
    """``[quickstart]``: ``launch/quickstart`` on the card; the conv
    kernel must run (its launch count rises) and both schedules hold to
    the plain version at the float32 contract.  After the counts are
    read, both schedules are timed again by :class:`Timer` (L2 kept: the
    quickstart's calls find their inputs there), beside its CUDA-event
    medians."""
    import io
    from repro_torch.kernels import conv2d
    from repro_torch.launch import quickstart

    before = conv2d.launches
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = quickstart.run(dev)
    wall = time.perf_counter() - t0
    if conv2d.launches <= before or res["launches"] < 1:
        fail(f"[quickstart] the conv2d kernel did not run "
             f"({res['launches']} launches)")
    if len(res["max_abs_err"]) != 2 or \
            not max(res["max_abs_err"]) <= quickstart.TOL:
        fail(f"[quickstart] schedules vs plain: {res['max_abs_err']}")
    img, wgt = quickstart.inputs(dev)
    timer_ms = [timer(lambda: s.run(img, wgt), flush=False)
                for s in res["schedules"]]
    phase("quickstart", rank0=json.dumps(reg_dict(res["schedules"][0])),
          rank1=json.dumps(reg_dict(res["schedules"][1])),
          predicted_us=json.dumps([round(t * 1e6, 3)
                                   for t in res["predicted_s"]]),
          max_abs_err=json.dumps(res["max_abs_err"]), tol=quickstart.TOL,
          cuda_event_median_us=json.dumps([round(t * 1e6, 3)
                                           for t in res["medians_s"]]),
          committed_index=res["best_index"], launches=res["launches"],
          timer_ms=json.dumps([round(t, 4) for t in timer_ms]),
          seconds=f"{wall:.2f}", card=repr(smi))


def doctor_rows(out):
    """(kind, batch, measured, ratio, verdict) of each row of
    ``doctor``'s output: the batch is a conv problem's ``n`` ("-" read
    as None)."""
    rows = []
    for line in out.splitlines()[1:]:
        cols = line.split()
        if not cols or line.startswith("--"):
            continue
        n = (re.search(r"(?:^|,)n=(\d+)", cols[1])
             if cols[0] in ("conv_schedule", "sparse_conv_schedule")
             else None)
        meas, ratio = (None if c == "-" else float(c) for c in cols[3:5])
        rows.append((cols[0], n and int(n.group(1)), meas, ratio, cols[5]))
    return rows


# The kinds whose measured median and prediction both time one kernel
# call: the thesis dispatch's slots.  A serving slot's median is a
# host-timed step of every layer, so its ratio is no audit of the model.
THESIS_KINDS = ("conv_schedule", "matmul_schedule", "sparse_conv_schedule")


def tune_cli_phase(smi, records):
    """``[tune_cli]``: the card's registry files merged into ``P``, then
    ``python -m repro_torch.tune --registry P`` in child processes (the
    read-only commands side by side, ``invalidate`` last).  See the
    module docstring for the gates."""
    import statistics
    from repro_torch.core import registry as reg

    sources = sorted(records.glob("*.jsonl"))
    path = records / "P.jsonl"
    merged = reg.TuningRegistry(str(path))
    for f in sources:
        merged.merge(reg.TuningRegistry(str(f)), persist=False)
    merged.compact()
    kinds = ("conv_schedule", "matmul_schedule", "flash_attention_schedule",
             "decode_attention_schedule", "ssm_scan_schedule",
             "sparse_conv_schedule", "serve_decode")
    written = len({rec.key.canonical() for f in sources
                   for rec in reg.TuningRegistry(str(f)).records()
                   if rec.key.kind in kinds and rec.measured is not None})
    n_sweeps = sum(rec.key.kind == "conv_sweep" for rec in merged.records())
    if not written or not n_sweeps:
        fail(f"[tune_cli] no measured records ({written}) or no sweeps "
             f"({n_sweeps}) in {[f.name for f in sources]}")
    empty = records / "merged_into_empty.jsonl"
    exported = records / "export.json"
    base = ("--registry", str(path))
    t0 = time.perf_counter()
    procs = {"stats": tune_cli(records, *base, "stats"),
             "serve-report": tune_cli(records, *base, "serve-report"),
             "doctor": tune_cli(records, *base, "doctor", "--ratio", "3"),
             "export": tune_cli(records, *base, "export", "--out",
                                str(exported)),
             "merge": tune_cli(records, "--registry", str(empty), "merge",
                               str(path))}
    outs = {k: finish(p, k) for k, p in procs.items()}
    outs["invalidate"] = finish(tune_cli(records, *base, "invalidate",
                                         "--kind", "conv_sweep"),
                                "invalidate")
    wall = time.perf_counter() - t0
    stats = json.loads(outs["stats"])
    if stats["records"] != len(merged):
        fail(f"[tune_cli] stats counts {stats['records']} records, the "
             f"file holds {len(merged)}")
    m = re.search(r"-- (\d+) serving-path records, (\d+) with run-time",
                  outs["serve-report"])
    if m is None or int(m.group(2)) < written:
        fail(f"[tune_cli] serve-report found {m and m.group(2)} measured "
             f"records, the phases wrote back {written}")
    if [r.to_dict() for r in reg.TuningRegistry(str(empty)).records()] != \
            [r.to_dict() for r in merged.records()]:
        fail("[tune_cli] the merged file's records differ from the "
             "source's")
    if len(json.loads(exported.read_text())) != len(merged):
        fail("[tune_cli] export wrote another number of records")
    if f"invalidated {n_sweeps} records" not in outs["invalidate"] or any(
            k.kind == "conv_sweep" for k in reg.TuningRegistry(
                str(path)).keys()):
        fail(f"[tune_cli] invalidate: {outs['invalidate'].strip()}")
    drows = doctor_rows(outs["doctor"])
    thesis = [v for kind, _, meas, _, v in drows
              if kind in THESIS_KINDS and meas is not None]
    phase("tune_cli", commands=json.dumps(sorted(outs)), exit_codes="all 0",
          records=len(merged), by_kind=json.dumps(stats["by_kind"]),
          by_tier=json.dumps(stats["by_tier"]), written_back=written,
          serve_report_measured=int(m.group(2)),
          doctor_summary=repr(outs["doctor"].splitlines()[-1].split(
              " (")[0]), thesis_drifted=repr(
              f"{thesis.count('DRIFT')} of {len(thesis)} measured"),
          merged_equal=True, invalidated_sweeps=n_sweeps,
          children_s=f"{wall:.2f}", card=repr(smi))
    by_kind = {}
    for kind, n, meas, ratio, verdict in drows:
        by_kind.setdefault((kind, n), []).append((meas, ratio, verdict))
    for (kind, n), rows in sorted(by_kind.items(),
                                  key=lambda kv: (kv[0][0], kv[0][1] or 0)):
        measured = sum(meas is not None for meas, _, _ in rows)
        if kind not in THESIS_KINDS:
            phase("tune_cli", kind=kind, batch=n, records=len(rows),
                  measured=measured, audit=repr(
                      "no prediction" if kind == "serve_decode" else
                      "not comparable: a host-timed step of every layer "
                      "against one kernel call's prediction"),
                  card=repr(smi))
            continue
        ratios = [r for _, r, _ in rows if r is not None]
        phase("tune_cli", kind=kind, batch=n, records=len(rows),
              measured=measured,
              drifted=sum(v == "DRIFT" for _, _, v in rows),
              median_ratio=(f"{statistics.median(ratios):.3f}"
                            if ratios else None),
              min_ratio=f"{min(ratios):.3f}" if ratios else None,
              max_ratio=f"{max(ratios):.3f}" if ratios else None,
              band="[0.333, 3]", card=repr(smi))


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
    logging.getLogger("repro_torch.serving").addHandler(DEGRADE_WATCH)
    t_run = time.perf_counter()
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="card_records_",
                                     dir=REPO / "build") as records:
        summary = run(torch, dev, Timer(torch, dev), smi, Path(records))
    phase("done", seconds=f"{time.perf_counter() - t0:.1f}",
          phases_seconds=f"{time.perf_counter() - t_run:.1f}")
    print(json.dumps({"kernels": list(summary.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}))


def engine_phase(torch, model, params, prompts, mode, smi, tally=None,
                 drains=("cold", "warm")):
    """Serve ``prompts`` twice through one session in ``mode``: the first
    (cold) drain builds every step, captured as CUDA graphs in graphs
    mode, the second (warm) must build nothing.  Each drain's launch
    counts are set to 0 just before it and read just after; one
    ``[engine]`` line each.  ``tally`` (a moe model's open
    ``drop_tally`` counter) is zeroed before each drain and read after
    it (``dropped``).  Returns {drain: tokens, counts, stats}."""
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
    for drain in drains:
        session.stats = SessionStats()          # this drain's numbers
        built = session.exec_cache.compiles
        for i, p in enumerate(prompts):
            session.submit(p, NEW_TOKENS, request_id=f"r{i}")
        if tally is not None:
            tally.zero_()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = {r.request_id: r for r in session.drain()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        dropped = None if tally is None else int(tally)
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
              degraded_buckets=st["degraded_buckets"],
              **({} if dropped is None else {"dropped_slots": dropped}),
              launches=json.dumps(counts))
        out[drain] = {"tokens": {k: v.tokens.tolist()
                                 for k, v in res.items()},
                      "counts": counts, "stats": st, "wall": wall,
                      "dropped": dropped,
                      "reserved": torch.cuda.max_memory_reserved()}
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


def serve_phases(torch, dev, smi, arch, sched_times, records):
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
    dispatch_serve(torch, model, params, prompts, smi, sched_times, records)
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


def run(torch, dev, timer, smi, records):
    """Phases 3-10 on ``dev``; returns the kernels' summary entries.
    ``records`` is the directory of the card's registry files."""
    from repro_torch.configs import get_config

    summary = kernel_checks(torch, dev, timer)
    sched_times = schedule_checks(torch, dev, timer)

    # ---- the thesis path: checks and times first (they build and warm
    # every kernel), then the dispatched main path with its counts
    data = thesis_data(torch, dev)
    summary.update(thesis_checks(torch, dev, timer, data))
    thesis = thesis_dispatch(torch, dev, timer, data, records)
    for k, v in thesis.items():
        summary[k]["launches"] = v
    del data
    free_card(torch)
    # ---- the thesis' design-space tools and the quickstart
    loki_phase(smi, records)
    quickstart_phase(dev, timer, smi)

    # ---- phi3-mini-3.8b: flash prefill, paged and contiguous decode
    phi3 = serve_phases(torch, dev, smi, PHI3, sched_times, records)
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
    mamba = serve_phases(torch, dev, smi, MAMBA, sched_times, records)
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
    tune_cli_phase(smi, records)

    # ---- the rest of the dense family (GQA groups 3, 6, 8; squared-ReLU
    # MLPs; qk-norm) and moe, at full size: the same two kernels
    for arch in DENSE_FAMILY + (MOE,):
        family_phase(torch, dev, smi, arch)

    for arch in (PHI3 + "-smoke", MAMBA + "-smoke"):
        exact_tokens(torch, dev, arch)
        exact_tokens_dispatch(torch, dev, arch)
        exact_lifecycle(torch, dev, arch)
        exact_watchdog_drift(torch, dev, arch)
    # llama4-scout-17b-a16e is held here only: its ~215 GB of bf16 do not
    # fit one card
    for arch in DENSE_FAMILY + (MOE, "llama4-scout-17b-a16e"):
        exact_tokens(torch, dev, arch + "-smoke")
    sticky_error_phase(torch, smi)

    # ---- the hybrid, vlm and audio families at full size, through the
    # bucketed path (the engine serves dense, moe and ssm only, as in JAX)
    for arch in FAMILY_ARCHS:
        for k, v in family_phase_new(torch, dev, smi, arch).items():
            summary[k]["launches"] += v
    for arch in FAMILY_ARCHS:
        exact_tokens_bucketed(torch, dev, arch + "-smoke")

    # ---- training: full phi3 on the plain backend (no kernel has a
    # backward), the forward-only loss through the flash kernel
    summary["flash_attention"]["launches"] += train_phases(
        torch, dev, timer, smi)

    # ---- the chunked attention backend, the analytic roofline, a
    # meshed trainer on one card and the serving launchers
    slice_phases(torch, dev, smi)
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


def dispatch_serve(torch, model, params, prompts, smi, sched_times,
                   records):
    """``[dispatch_serve]``: the engine's 8 requests with captured steps
    and a DispatchService on a temporary registry file, drained twice
    (cold, warm), then once more by a fresh service over the same file;
    batch size 4 only (the rows the graphs run without dispatch used).
    A session without dispatch drains the same requests before and
    after the dispatched ones (cold, warm | dispatched | warm), so the
    two step times are compared in turns in one call.  Then at the
    engine phase's batch sizes a session without dispatch and one on
    the fresh service drain cold then warm: the buckets the
    dispatch-aware choice picks, reported.  The dispatched sessions
    also write ``serve_decode`` back; the registry file is copied to
    ``records`` for ``[tune_cli]``.  See the module docstring for the
    gates."""
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
                               batch_sizes=(4,), dispatch=svc,
                               registry=svc.registry)

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
                                batch_sizes=(4,), dispatch=fresh,
                                registry=fresh.registry)
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
        shutil.copyfile(path, records / f"serve_{arch}.jsonl")
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

    # the rest of the failure contract: a degraded bucket, a step that
    # raises
    degrade_phase(torch, model, params, prompts, smi, clean)
    step_exception_phase(torch, model, params, prompts, smi, clean)

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


def prefill_bucket_of(prompt):
    """The prompt bucket the engine phase's sessions (default bucket
    lengths) prefill ``prompt`` at."""
    from repro_torch.models import bucket_length
    return bucket_length(len(prompt))


def degrade_phase(torch, model, params, prompts, smi, clean):
    """``[degrade]``: the engine's 8 requests with
    ``fallback_backend="eager"``.  ``compile@0x999``: every build and its
    uncaptured rebuild fail, so every bucket degrades and runs its cuda
    step uncaptured: every admission and step still launches its
    kernels (one a layer), and the tokens equal the engine phase's
    (whose eager drains gave the graphs' tokens, ``[same_tokens_and_
    launches]``).  ``compile@0x1`` with no retries: only the first
    bucket built (r0's prefill) degrades, its uncaptured build
    succeeds; the other buckets are captured, and every request keeps
    its clean tokens.  The decode step ms of the degraded and the
    non-degraded run (their decode tok/s ratio is ``bench_faults``'
    ``degraded_tok_s_ratio``) are printed, not gated."""
    from repro_torch.serving import FaultInjector, ServeSession

    cfg = model.cfg
    arch = cfg.name
    t0 = time.perf_counter()
    runs = {}
    for spec, retries in (("compile@0x999", 0), ("compile@0x1", 0)):
        free_card(torch)
        DEGRADE_WATCH.allowed = True
        try:
            s = ServeSession(model, params, backend="cuda",
                             batch_sizes=ENGINE_BATCH_SIZES,
                             fallback_backend="eager",
                             compile_retries=retries,
                             faults=FaultInjector.from_strings([spec]))
            res, counts = drive(torch, s, prompts)
        finally:
            DEGRADE_WATCH.allowed = False
        st = s.stats
        bad = [(k, r.state) for k, r in res.items() if r.state != "COMPLETED"]
        if len(res) != len(prompts) or bad:
            fail(f"{arch} [degrade] {spec}: not completed {bad}")
        degraded = [e.what for e in st.events if e.kind == "degraded"]
        steps = {k: s.exec_cache.peek(k) for k in s.exec_cache.compiled_log}
        uncaptured = sorted(
            f"{k.role}[b{k.batch},{'p' if k.role == 'prefill' else 't'}"
            f"{k.length}]" for k, step in steps.items() if step.graph is None)
        tokens = {k: r.tokens.tolist() for k, r in res.items()}
        want = engine_launches(cfg, st.inflight_admissions, st.steps)
        if counts != want:
            fail(f"{arch} [degrade] {spec}: launches {counts}, want {want} "
                 f"(a degraded bucket launches its kernels uncaptured)")
        if tokens != clean:
            fail(f"{arch} [degrade] {spec}: tokens differ from the engine "
                 f"phase's")
        if spec == "compile@0x999":
            if (st.degraded_buckets != len(steps) or len(uncaptured)
                    != len(steps) or st.fallbacks != 2 * len(steps)):
                fail(f"{arch} [degrade] {spec}: {st.degraded_buckets} "
                     f"degraded, {st.fallbacks} fallbacks, "
                     f"{len(uncaptured)} of {len(steps)} steps uncaptured")
        else:
            first = f"prefill[b1,p{prefill_bucket_of(prompts[0])}]"
            if (degraded != [first] or st.fallbacks != 1
                    or uncaptured != [first]):
                fail(f"{arch} [degrade] {spec}: degraded {degraded} (want "
                     f"[{first}]), {st.fallbacks} fallbacks, uncaptured "
                     f"{uncaptured}")
        step_ms = 1e3 * st.decode_s / max(st.steps, 1)
        runs[spec] = st
        phase("degrade", arch=arch, scenario=spec, card=repr(smi),
              compile_retries=st.compile_retries, fallbacks=st.fallbacks,
              degraded_buckets=st.degraded_buckets,
              degraded=json.dumps(degraded),
              uncaptured=json.dumps(uncaptured),
              events=json.dumps([e.kind for e in st.events]),
              launches=json.dumps(counts), steps=st.steps,
              step_ms=f"{step_ms:.3f}",
              decode_tok_s=f"{st.decode_tokens / max(st.decode_s, 1e-9):.1f}")
        del s, res
    deg, ok = runs["compile@0x999"], runs["compile@0x1"]
    ratio = ((deg.decode_tokens / deg.decode_s)
             / (ok.decode_tokens / ok.decode_s))
    phase("degrade", arch=arch, summary="step ms degraded (every bucket, "
          "uncaptured) / not degraded (compile@0x1's decode)",
          degraded_step_ms=f"{1e3 * deg.decode_s / max(deg.steps, 1):.3f}",
          step_ms=f"{1e3 * ok.decode_s / max(ok.steps, 1):.3f}",
          degraded_tok_s_ratio=f"{ratio:.4f}",
          seconds=f"{time.perf_counter() - t0:.1f}")


class RaiseOnce:
    """Wraps the replay of the steps ``session``'s cache returns for
    ``role`` so that its ``n``-th call (over all of them) raises a
    RuntimeError after the step ran: its kernels launched and its state
    was written, its outputs never reach the engine."""

    def __init__(self, session, role, n):
        """Install the wrapper on ``session``'s executable cache."""
        self.role, self.n, self.calls = role, n, 0
        self.message = f"injected {role} failure"
        cache = session.exec_cache
        get = cache.get

        def wrapped_get(key, builder):
            step, hit = get(key, builder)
            if key.role == role and not hasattr(step, "_raise_once"):
                replay = step.replay

                def raising_replay():
                    out = replay()
                    self.calls += 1
                    if self.calls == self.n:
                        raise RuntimeError(self.message)
                    return out
                step.replay = raising_replay
                step._raise_once = True
            return step, hit

        cache.get = wrapped_get


def step_exception_phase(torch, model, params, prompts, smi, clean):
    """``[step_exception]``: the engine's 8 requests with graphs while a
    decode step raises once, at step 5, after it ran: the rows in flight
    end FAILED (``decode step raised: ...``) with a prefix of their clean
    tokens, the queue drains, every request admitted after the
    exception gets its clean tokens, one ``step_exception`` event is
    recorded and the flight recorder dumps its postmortem; then a
    prefill that raises once (the third admission): only that request
    fails.  The launches are one a layer per admission and per step,
    the raising ones included."""
    import tempfile
    from repro_torch.obs import FlightRecorder
    from repro_torch.serving import ServeSession

    cfg = model.cfg
    arch = cfg.name
    t0 = time.perf_counter()
    for role, n in (("decode", 6), ("prefill", 3)):
        free_card(torch)
        with tempfile.TemporaryDirectory() as out_dir:
            rec = FlightRecorder(out_dir=out_dir)
            s = ServeSession(model, params, backend="cuda",
                             batch_sizes=ENGINE_BATCH_SIZES, recorder=rec)
            raiser = RaiseOnce(s, role, n)
            first_seen = {}

            def on_step(info):
                for rid in info["active"]:
                    first_seen.setdefault(rid, info["step"])
            res, counts = drive(torch, s, prompts, on_step=on_step)
            dumped = sorted(os.listdir(out_dir))
        st = s.stats
        reason = f"{role} step raised: {raiser.message}" if role == "decode" \
            else f"prefill raised: {raiser.message}"
        failed = {k for k, r in res.items() if r.state == "FAILED"}
        kinds = [e.kind for e in st.events]
        if len(res) != len(prompts) or not failed or raiser.calls < n:
            fail(f"{arch} [step_exception] {role}: {len(res)} results, "
                 f"failed {sorted(failed)}, {raiser.calls} calls")
        for k, r in res.items():
            toks = r.tokens.tolist()
            if k in failed:
                if r.reason != reason or toks != clean[k][:len(toks)]:
                    fail(f"{arch} [step_exception] {role}: {k} failed "
                         f"with {r.reason!r} and {len(toks)} tokens that "
                         f"are no prefix of its clean ones")
            elif r.state != "COMPLETED" or toks != clean[k]:
                fail(f"{arch} [step_exception] {role}: {k} ended "
                     f"{r.state} with other tokens than the clean run's")
        if role == "decode":
            exc = [e for e in st.events if e.kind == "step_exception"]
            after = sorted(k for k, at in first_seen.items() if at > 5)
            if (len(exc) != 1 or exc[0].step != 5 or not after
                    or "postmortem-step_exception.json" not in dumped
                    or kinds != ["step_exception"]):
                fail(f"{arch} [step_exception] decode: events {kinds}, "
                     f"admitted after {after}, dumped {dumped}")
            want = engine_launches(cfg, st.inflight_admissions,
                                   st.steps + 1)
        else:
            after = []
            if len(failed) != 1 or kinds != ["admission_failure"]:
                fail(f"{arch} [step_exception] prefill: failed "
                     f"{sorted(failed)}, events {kinds}")
            want = engine_launches(cfg, st.inflight_admissions + 1,
                                   st.steps)
        if counts != want:
            fail(f"{arch} [step_exception] {role}: launches {counts}, "
                 f"want {want}")
        phase("step_exception", arch=arch, role=role, raise_at_call=n,
              card=repr(smi), failed=json.dumps(sorted(failed)),
              partial_tokens=json.dumps({k: len(res[k].tokens)
                                         for k in sorted(failed)}),
              admitted_after=json.dumps(after), steps=st.steps,
              admissions=st.inflight_admissions, events=json.dumps(kinds),
              postmortems=json.dumps(dumped), launches=json.dumps(counts),
              seconds=f"{time.perf_counter() - t0:.1f}")
        del s, res


STICKY_CHILD = """
import os
import sys
import numpy as np
import torch
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import ServeSession
from repro_torch.serving.captured import CapturedStep

torch.backends.cuda.matmul.allow_tf32 = False
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
    s.submit(np.arange(1, 6 + i), 6, request_id=f"r{{i}}")
try:
    res = s.drain()
except Exception as e:
    print("raised", type(e).__name__, "from",
          type(e.__cause__).__name__, "events",
          [ev.kind for ev in s.stats.events], "|",
          str(e).strip().splitlines()[0], flush=True)
    os._exit(3)
print("contained", [r.state for r in res], flush=True)
"""


def sticky_error_phase(torch, smi):
    """``[sticky_error]``: a child process serves the float32 phi3 smoke
    config while its decode step first runs an out-of-bounds index on
    the card, a device-side assert that sticks to the CUDA context.  The
    session must not contain it: the child exits non-zero with the
    assert in its stderr and never reports its rows."""
    t0 = time.perf_counter()
    free_card(torch)
    out = subprocess.run(
        [sys.executable, "-c", STICKY_CHILD.format(src=str(REPO / "src"))],
        capture_output=True, text=True, timeout=300)
    # the kernel's assertion on stderr, the step's CUDA error in drain's
    asserted = "Assertion" in out.stderr
    raised = [ln for ln in out.stdout.splitlines()
              if ln.startswith("raised")]
    if (out.returncode != 3 or not asserted or not raised
            or "device-side assert" not in raised[0]
            or "step_exception" in raised[0]
            or "contained" in out.stdout):
        fail(f"[sticky_error] child exited {out.returncode}, assert in "
             f"stderr {asserted}, stdout {out.stdout[-500:]!r}, stderr "
             f"{out.stderr[-2000:]!r}")
    phase("sticky_error", arch="phi3-mini-3.8b-smoke", dtype="float32",
          card=repr(smi), returncode=out.returncode, assert_seen=asserted,
          drain=repr(raised[0]), contained=False,
          seconds=f"{time.perf_counter() - t0:.1f}")


def moe_rounding(torch, dev, params, cfg, smi):
    """``[moe_rounding]``: the size of the port's one numerical
    difference in the moe FFN.  Its batched expert products return bf16
    in a bf16 model, where the JAX einsums keep ``h1``, ``h3`` and ``y``
    in float32; layer 0's ``moe_ffn`` on N(0, 1) bf16 inputs at the
    engine's largest prefill (512 tokens) and at a 4-row decode step,
    against the same call with its products in float32 (``torch.bmm``
    on float32 operands for that call), which is the JAX arithmetic.
    Printed: the largest difference, the largest reference value, the
    share of output elements that differ and the worst difference in
    bf16 ulps of the largest reference value; not gated."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import layer_params

    lp = layer_params(params["layers"], 0)["moe"]
    g = torch.Generator(device=dev).manual_seed(5)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
              capacity_factor=cfg.capacity_factor)
    real_bmm = torch.bmm
    for rows, seq in ((1, 512), (4, 1)):
        x = torch.randn((rows, seq, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)
        got, _ = moe_mod.moe_ffn(x, lp, **kw)
        torch.bmm = lambda a, b: real_bmm(a.float(), b.float())
        try:
            want, _ = moe_mod.moe_ffn(x, lp, **kw)
        finally:
            torch.bmm = real_bmm
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        peak = float(want.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(peak)) - 7)
        phase("moe_rounding", arch=cfg.name, card=repr(smi),
              shape=json.dumps([rows, seq, cfg.d_model]),
              max_abs_diff=f"{float(diff.max()):.6g}",
              max_abs_ref=f"{peak:.6g}",
              differing_share=f"{float((diff > 0).float().mean()):.4f}",
              worst_in_ulps_of_max=f"{float(diff.max()) / ulp:.2f}")
    del lp


DENSE_FAMILY = ("minitron-4b", "nemotron-4-15b", "qwen3-32b")
MOE = "qwen2-moe-a2.7b"
# the new full-size configs drain once, cold (builds included; the
# decode steps are replays either way): their warm drain was dropped to
# keep the whole run near 600 s.  The moe config keeps it: its dropped
# slots are read from the warm drain, whose steps are all replays (a
# cold drain's count holds its builds' warm-up calls too)
NEW_DRAINS = ("cold",)
MOE_DRAINS = ("cold", "warm")


def family_phase(torch, dev, smi, arch):
    """``[dense_family]`` / ``[moe]``: full-size ``arch`` in bf16 with
    random weights from seed 0, the engine phase's 8 requests in graphs
    mode (``NEW_DRAINS``, moe ``MOE_DRAINS``); flash launches n_layers
    per admission and paged decode n_layers per step.  For moe, the
    capacity of every bucket the drains used and the dropped slots of
    each drain."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity, drop_tally

    cfg = get_config(arch)
    model = build_model(cfg)
    tag = "moe" if cfg.n_experts else "dense_family"
    t0 = time.perf_counter()
    free_card(torch)
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    gib = torch.cuda.memory_allocated() / 2 ** 30
    init_s = time.perf_counter() - t0
    prompts = prompts_of(ENGINE_PROMPTS, cfg.vocab_size, seed=1)
    tally = (drop_tally(dev) if cfg.n_experts
             else contextlib.nullcontext(None))
    drains = MOE_DRAINS if cfg.n_experts else NEW_DRAINS
    with tally as dropped:
        runs = engine_phase(torch, model, params, prompts, "graphs", smi,
                            tally=dropped, drains=drains)
    for drain, r in runs.items():
        st = r["stats"]
        want = engine_launches(cfg, st["inflight_admissions"], st["steps"])
        if {k: v for k, v in r["counts"].items() if v} != want:
            fail(f"{arch} [{tag}] {drain}: launches {r['counts']}, want "
                 f"{want}")
    last = runs[drains[-1]]
    st = last["stats"]
    extra = {}
    if cfg.n_experts:
        buckets = sorted({int(b.split("xp")[1].split("xt")[0])
                          for b in st["buckets"]} | {
                              prefill_bucket_of(p) for p in prompts})
        rows = sorted({int(b[1:].split("xp")[0]) for b in st["buckets"]})
        e, k, f = cfg.n_experts, cfg.experts_per_token, cfg.capacity_factor
        extra = dict(
            capacity_prefill=json.dumps({p: capacity(p, e, k, f)
                                         for p in buckets}),
            capacity_decode=json.dumps({b: capacity(b, e, k, f)
                                        for b in rows}),
            # the warm drain's count is one drain's; the cold one's holds
            # its builds' warm-up calls too
            dropped_slots=json.dumps({d: r["dropped"]
                                      for d, r in runs.items()}))
    phase(tag, arch=arch, card=repr(smi), params=n_params,
          weights_gib=f"{gib:.2f}", init_s=f"{init_s:.1f}",
          gqa_group=cfg.n_heads // cfg.n_kv_heads,
          head_dim=cfg.resolved_head_dim, mlp=cfg.mlp_type,
          drain=drains[-1], steps=st["steps"],
          step_ms=f"{1e3 * st['decode_s'] / max(st['steps'], 1):.2f}",
          decode_tok_s=f"{st['decode_tok_s']:.1f}",
          ttft_p50_s=f"{st['ttft_p50_s']:.4f}",
          ttft_p95_s=f"{st['ttft_p95_s']:.4f}",
          peak_reserved_gib=f"{last['reserved'] / 2 ** 30:.2f}",
          launches_per_admission=json.dumps({
              kk: v / max(st["inflight_admissions"], 1)
              for kk, v in last["counts"].items()
              if kk == "flash_attention"}),
          launches_per_step=json.dumps({
              kk: v / max(st["steps"], 1)
              for kk, v in last["counts"].items()
              if kk == "paged_decode_attention"}),
          **extra, seconds=f"{time.perf_counter() - t0:.1f}")
    if cfg.n_experts:
        moe_rounding(torch, dev, params, cfg, smi)
    del params, model, runs
    free_card(torch)


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


# ---------------------------------------------------------------------------
# The hybrid, vlm and audio families: the bucketed path only, as in JAX
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("recurrentgemma-9b", "paligemma-3b", "whisper-large-v3")
# recurrentgemma's long request: bucketed to 4096, past its window of
# 2048, so the prefill runs the windowed flash kernel and every decode
# step writes and reads the wrapped rolling buffer
LONG_PROMPT = 2100
EXTRAS_SEED = 2


def family_launches(cfg):
    """(flash launches a prefill, contiguous decode launches a decode
    step) of ``cfg``: one a layer that attends; audio's encoder adds one
    non-causal launch a layer to its prefill."""
    from repro_torch.models.transformer import hybrid_counts
    if cfg.family == "hybrid":
        n_groups, tail = hybrid_counts(cfg)
        n = n_groups * cfg.block_pattern.count("attn") + tail.count("attn")
        return n, n
    if cfg.family == "audio":
        return cfg.encoder_layers + cfg.n_layers, cfg.n_layers
    return cfg.n_layers, cfg.n_layers


def family_extras(model, n):
    """``n`` requests' modality extras (float32 numpy rows of the
    family's ``image_embeds`` or ``frames``) from a torch generator
    seeded ``EXTRAS_SEED``; None each for a family without one."""
    import torch
    specs = model.modality_specs(1)
    gen = torch.Generator().manual_seed(EXTRAS_SEED)
    return [{name: torch.randn(shape[1:], generator=gen).numpy()
             for name, (shape, _) in specs.items()} or None
            for _ in range(n)]


def family_drain(torch, model, params, prompts, extras, capture, label,
                 new_tokens=NEW_TOKENS):
    """One greedy drain of ``prompts`` (with ``extras``) on a fresh
    session at ``ENGINE_BATCH_SIZES``: ``drain`` serves these families
    through ``_drain_batched``.  The launch counts are set to 0 just
    before and read just after.  Returns (tokens by id, session, wall
    seconds, launches, peak reserved bytes)."""
    from repro_torch import kernels
    from repro_torch.serving import ServeSession
    s = ServeSession(model, params, backend="cuda", capture=capture,
                     batch_sizes=ENGINE_BATCH_SIZES)
    for i, (p, e) in enumerate(zip(prompts, extras)):
        s.submit(p, new_tokens, request_id=f"r{i}", extras=e)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = {r.request_id: r for r in s.drain()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    bad = [k for k, r in res.items()
           if r.state != "COMPLETED" or len(r.tokens) != new_tokens]
    if len(res) != len(prompts) or bad:
        fail(f"{label}: not completed: {bad}")
    if s.stats.steps or s.stats.inflight_admissions:
        fail(f"{label}: the in-flight engine ran ({s.stats.steps} steps)")
    return ({k: r.tokens.tolist() for k, r in res.items()}, s, wall, counts,
            torch.cuda.max_memory_reserved())


def family_gate(cfg, session, counts, label, new_tokens=NEW_TOKENS):
    """The launches of a drain: exactly the family's flash launches a
    prefill (one prefill a batch) and contiguous decode launches a decode
    step (``new_tokens - 1`` a batch), and no other kernel."""
    fpp, dps = family_launches(cfg)
    batches = session.stats.batches
    want = {"flash_attention": fpp * batches,
            "decode_attention": dps * batches * (new_tokens - 1)}
    if counts != want:
        fail(f"{label}: launches {counts}, want {want} ({fpp} flash a "
             f"prefill, {dps} decode a step, {batches} batches)")
    return batches * (new_tokens - 1)


def family_vs_plain(torch, model, params, prompts, extras, smi, want):
    """``[family_vs_plain]``: the same requests as the graphs drain,
    eagerly, every flash and contiguous decode call held to its plain
    version (:func:`held_to_plain`); every token equal to the graphs
    drain's (``want``)."""
    cfg = model.cfg
    with held_to_plain(torch) as seen:
        toks, s, _, counts, _ = family_drain(
            torch, model, params, prompts, extras, False,
            f"{cfg.name} [family_vs_plain]")
    family_gate(cfg, s, counts, f"{cfg.name} [family_vs_plain]")
    for (kernel, shape), (calls, e, share) in sorted(seen.items()):
        phase("family_vs_plain", arch=cfg.name, card=repr(smi),
              kernel=kernel, shape=repr(shape), calls=calls,
              max_abs_err=f"{e:.3g}", tol=repr(TOL),
              worst_share_of_tol=f"{share:.3g}", ok=share <= 1.0)
    bad = {k: v for k, v in seen.items() if v[2] > 1.0}
    if bad:
        fail(f"{cfg.name} [family_vs_plain]: kernels disagree with their "
             f"plain versions: {bad}")
    checked = {}
    for (kernel, _), (calls, _, _) in seen.items():
        checked[kernel] = checked.get(kernel, 0) + calls
    if checked != counts:
        fail(f"{cfg.name} [family_vs_plain]: checked calls {checked}, "
             f"launches {counts}")
    if toks != want:
        fail(f"{cfg.name} [family_vs_plain]: eager tokens differ from the "
             f"graphs drain's")
    phase("family_vs_plain_summary", arch=cfg.name,
          checked=json.dumps(checked), tokens_equal=True)
    del s
    free_card(torch)


def family_profile(torch, session, cfg, smi, steps=10):
    """``[family_profile]``: the drain's widest captured decode step
    replayed ``steps`` times under ``torch.profiler`` from its first
    decode position (its cache holds the drain's last group, so every
    position stays inside it): device ms a step by kernel group (the
    port's kernels, cuBLAS, the rest), the busy share of the replays'
    wall time, and the top kernels (``[family_profile_top]``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    key = max((k for k in session.exec_cache.compiled_log
               if k.role == "decode"), key=lambda k: k.batch)
    step = session.exec_cache.peek(key)
    pos0 = key.length - NEW_TOKENS
    step.inputs["pos"].fill_(pos0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step.replay()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        """Self device time of one averaged event, in us."""
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kern:
        phase("family_profile", arch=cfg.name, device_events=0,
              note="the profiler recorded no device time")
        return
    total = sum(dev_us(e) for e in kern)
    groups = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kern:
        n = e.key.lower()
        if any(t in n for t in ("flash_mma_kernel", "flash_fwd_kernel",
                                "decode_split_kernel")):
            groups["port_kernels"] += dev_us(e)
        elif any(t in n for t in ("gemm", "gemv", "nvjet", "cutlass")):
            groups["gemm"] += dev_us(e)
        else:
            groups["other"] += dev_us(e)
    phase("family_profile", arch=cfg.name, card=repr(smi),
          step=f"decode[b{key.batch},t{key.length}]", replays=steps,
          wall_ms_a_step=f"{wall_us / steps / 1e3:.3f}",
          device_ms_a_step=f"{total / steps / 1e3:.3f}",
          busy_share=f"{total / wall_us:.3f}",
          kernels_a_step=sum(e.count for e in kern) // steps,
          **{f"{g}_ms_a_step": f"{t / steps / 1e3:.3f}"
             for g, t in groups.items()})
    for e in sorted(kern, key=dev_us, reverse=True)[:6]:
        phase("family_profile_top", arch=cfg.name, kernel=repr(e.key[:70]),
              calls_a_step=e.count // steps,
              device_ms_a_step=f"{dev_us(e) / steps / 1e3:.3f}",
              share=f"{dev_us(e) / total:.3f}")


def family_phase_new(torch, dev, smi, arch):
    """``[hybrid]`` / ``[vlm]`` / ``[audio]``: full-size ``arch`` in bf16
    with random weights from seed 0 and extras from seed 2; one cold
    greedy drain of the 8 engine requests through ``_drain_batched``
    with graphs (launches gated: :func:`family_gate`); recurrentgemma
    also serves one request of ``LONG_PROMPT`` tokens (``[hybrid_long]``:
    the windowed prefill, decode in the wrapped buffer); then
    :func:`family_vs_plain` on the same requests.  The profile
    (:func:`family_profile`) runs after the launches were read.  Returns
    the graphs drains' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, bucket_length

    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    free_card(torch)
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    gib = torch.cuda.memory_allocated() / 2 ** 30
    init_s = time.perf_counter() - t0
    prompts = prompts_of(ENGINE_PROMPTS, cfg.vocab_size, seed=1)
    extras = family_extras(model, len(prompts) + 1)
    toks, s, wall, counts, reserved = family_drain(
        torch, model, params, prompts, extras, True, f"{arch} cold")
    steps = family_gate(cfg, s, counts, f"{arch} cold")
    st = s.stats.to_dict()
    fpp, dps = family_launches(cfg)
    phase(cfg.family, arch=arch, card=repr(smi), params=n_params,
          weights_gib=f"{gib:.2f}", init_s=f"{init_s:.1f}", drain="cold",
          mode="graphs", path="_drain_batched", batches=st["batches"],
          steps=steps, step_ms=f"{1e3 * s.stats.decode_s / steps:.2f}",
          decode_tok_s=f"{st['decode_tok_s']:.1f}",
          e2e_tok_s=f"{st['tokens_generated'] / wall:.1f}",
          ttft_p50_s=f"{st['ttft_p50_s']:.4f}",
          ttft_p95_s=f"{st['ttft_p95_s']:.4f}",
          peak_reserved_gib=f"{reserved / 2 ** 30:.2f}",
          launches=json.dumps(counts), flash_per_prefill=fpp,
          decode_per_step=dps, buckets=json.dumps(sorted(st["buckets"])),
          seconds=f"{time.perf_counter() - t0:.1f}")
    total = dict(counts)
    family_profile(torch, s, cfg, smi)
    del s
    check_prompts, check_extras = prompts, extras[:len(prompts)]
    want = {**toks}
    if cfg.family == "hybrid":
        (long_p,) = prompts_of([LONG_PROMPT], cfg.vocab_size, seed=4)
        ltoks, ls, lwall, lcounts, lres = family_drain(
            torch, model, params, [long_p], [extras[-1]], True,
            f"{arch} long")
        lsteps = family_gate(cfg, ls, lcounts, f"{arch} long")
        (bucket,) = ls.stats.per_bucket
        win = min(cfg.local_window, bucket.total_len)
        if bucket.prompt_len != bucket_length(LONG_PROMPT) or (
                bucket.prompt_len <= cfg.local_window):
            fail(f"{arch} long: bucket {bucket} is not past the window")
        phase("hybrid_long", arch=arch, card=repr(smi), prompt=LONG_PROMPT,
              bucket=bucket.prompt_len, total=bucket.total_len,
              local_window=cfg.local_window, rolling_slots=win,
              decode_pos=f"{bucket.prompt_len}..."
                         f"{bucket.prompt_len + NEW_TOKENS - 2}",
              prefill_s=f"{ls.stats.prefill_s:.4f}",
              step_ms=f"{1e3 * ls.stats.decode_s / lsteps:.2f}",
              peak_reserved_gib=f"{lres / 2 ** 30:.2f}",
              launches=json.dumps(lcounts), seconds=f"{lwall:.1f}")
        for k, v in lcounts.items():
            total[k] = total.get(k, 0) + v
        check_prompts = prompts + [long_p]
        check_extras = extras
        want[f"r{len(prompts)}"] = ltoks["r0"]
        del ls
    family_vs_plain(torch, model, params, check_prompts, check_extras, smi,
                    want)
    del params, model
    free_card(torch)
    return total


def exact_tokens_bucketed(torch, dev, arch):
    """Smoke config in float32, the bucketed path: ``drain`` (which
    serves these families through ``_drain_batched``) and ``generate``
    with extras, through captured graphs, through the kernels run
    eagerly and through the plain PyTorch path, must give equal tokens.
    The prompts pass the smoke config's ``local_window`` of 16 and the
    decode wraps its rolling buffer."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, left_pad_prompts
    from repro_torch.runtime import generate
    from repro_torch.serving import ServeSession

    scfg = get_config(arch)
    smodel = build_model(scfg)
    sparams = smodel.init(seed=0, device=dev)
    sprompts = prompts_of([5, 20, 3, 17, 12, 9], scfg.vocab_size, seed=3)
    sextras = family_extras(smodel, len(sprompts))
    stoks = left_pad_prompts(sprompts[:4], 24)
    gbatch = {"tokens": stoks}
    for name in smodel.modality_specs(4):
        gbatch[name] = np.stack([e[name] for e in sextras[:4]])
    paths = {"graphs": ("cuda", True), "eager": ("cuda", False),
             "plain": ("plain", False)}
    streams, g = {}, {}
    kernels.reset_launch_counts()
    for name, (backend, capture) in paths.items():
        s = ServeSession(smodel, sparams, backend=backend, capture=capture,
                         batch_sizes=ENGINE_BATCH_SIZES)
        for i, (p, e) in enumerate(zip(sprompts, sextras)):
            s.submit(p, 12, request_id=f"r{i}", extras=e)
        streams[name] = {r.request_id: (r.state, r.tokens.tolist())
                         for r in s.drain()}
        graphs = [s.exec_cache.peek(k).graph is not None
                  for k in s.exec_cache.compiled_log]
        if graphs != [capture] * len(graphs) or not graphs:
            fail(f"{arch} {name}: steps captured {graphs}")
        g[name] = generate(smodel, sparams, gbatch, max_new_tokens=12,
                           backend=backend, capture=capture)[0]
    for name in paths:
        if streams[name] != streams["plain"]:
            fail(f"{arch} drain tokens through {name} differ from the "
                 f"plain path")
        if not (g[name] == g["plain"]).all():
            fail(f"{arch} generate tokens through {name} differ from the "
                 f"plain path")
    used = {k: v for k, v in kernels.launch_counts().items() if v}
    if set(used) != {"flash_attention", "decode_attention"}:
        fail(f"{arch}: the cuda backend launched {used}")
    phase("exact_tokens", arch=scfg.name, dtype="float32",
          path="_drain_batched", paths=json.dumps(list(paths)),
          drain_requests=len(sprompts), generate_rows=4, equal=True,
          kernels=json.dumps(used))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 8
# from random weights a sign-like first AdamW step moves every weight
# by lr in the gradient's sign: at 3e-4 and 1e-4 the loss rose within 8
# steps on an H100 (grad norm 7.3 -> 486 and 48), at 3e-5 it falls
TRAIN_LR, TRAIN_WARMUP = 3e-5, 2
# the flash kernel and the plain path round each layer's attention to
# bf16 at different points; over 32 layers the mean loss of 2,044 tokens
# moved by 4e-5 relative on an H100
TRAIN_EVAL_RTOL = 1e-3
TRAIN_EXACT_ARCHS = ("minitron-4b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                     "recurrentgemma-9b", "paligemma-3b",
                     "whisper-large-v3")
# float32 (TF32 off): cuBLAS and the CPU sum products in other orders;
# over 4 AdamW steps a noise-level gradient element may flip its first
# update's sign (m / sqrt(v) ~ sign(g)), which moves the loss by ~1e-6
TRAIN_EXACT_RTOL = 1e-4
TRAIN_EXACT_STEPS = 4
# bytes a parameter's AdamW update must move at least: read p (bf16),
# g (bf16), m and v (float32), write p, m and v
ADAMW_BYTES_PER_BF16_PARAM = 2 + 2 + 4 + 4 + 2 + 4 + 4
# [train]'s losses and median step seconds, for [mesh] to hold to
TRAIN_CELL = {}


def train_batch(cfg, step, rows=4, seq=32):
    """Step ``step`` of the port's pipeline (seed 0) for ``cfg``, with the
    modality stub from the pipeline's ``extra`` (vlm: its image tokens'
    labels masked; audio: the frames)."""
    import numpy as np
    from repro_torch.data import DataConfig, global_batch
    extra = {}
    if cfg.family == "vlm":
        extra["image_embeds"] = ((cfg.num_image_tokens, cfg.d_model),
                                 np.float32)
    if cfg.family == "audio":
        extra["frames"] = ((cfg.encoder_seq, cfg.d_model), np.float32)
    bt = global_batch(DataConfig(cfg.vocab_size, seq, rows, seed=0,
                                 extra=extra), step)
    if cfg.family == "vlm":
        bt["labels"] = np.concatenate(
            [np.full((rows, cfg.num_image_tokens), -1, np.int32),
             bt["labels"]], axis=1)
    return bt


def train_phases(torch, dev, timer, smi):
    """Phase 7c; returns the flash launches of ``[train_eval]``."""
    free_card(torch)
    flash = train_full(torch, dev, timer, smi)
    free_card(torch)
    train_exact(torch, dev, smi)
    train_restart(torch, dev, smi)
    free_card(torch)
    train_lm_phase(torch, dev, smi)
    free_card(torch)
    return flash


def train_full(torch, dev, timer, smi):
    """``[train]``, ``[train_eval]``, ``[train_refuses]`` and
    ``[train_apply]`` on full phi3-mini-3.8b; returns the flash launches
    of ``[train_eval]``."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, global_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import build_model
    from repro_torch.models.transformer import KernelGradError
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    from repro_torch.tree import flatten_with_paths, leaves

    t0 = time.perf_counter()
    cfg = get_config(PHI3)
    model = build_model(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    tcfg = TrainConfig(steps=TRAIN_STEPS, log_every=1,
                       opt=adamw.AdamWConfig(lr=TRAIN_LR),
                       warmup_steps=TRAIN_WARMUP, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, tcfg, dcfg)
    out = trainer.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    hist = out["history"]
    params, opt_state = out["params"], out["opt_state"]
    n_params = sum(t.numel() for t in leaves(params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for h in hist:
        phase("train_step", arch=PHI3, step=h["step"],
              loss=f"{h['loss']:.6f}", grad_norm=f"{h['grad_norm']:.6f}",
              lr=f"{h['lr']:.3e}", ms=f"{1e3 * h['dt']:.1f}")
        if not (math.isfinite(h["loss"])
                and math.isfinite(h["grad_norm"])):
            fail(f"[train] step {h['step']}: loss {h['loss']} grad norm "
                 f"{h['grad_norm']}")
    if len(hist) != TRAIN_STEPS or not hist[-1]["loss"] < hist[0]["loss"]:
        fail(f"[train] {len(hist)} steps, loss {hist[0]['loss']} -> "
             f"{hist[-1]['loss']}: did not go down")
    step_s = sorted(h["dt"] for h in hist[2:])[len(hist[2:]) // 2]
    TRAIN_CELL.update(losses=[h["loss"] for h in hist], step_s=step_s,
                      peak_bytes=torch.cuda.max_memory_allocated())
    init = model.init(seed=0, device=dev)
    still = [path for (path, a), b in zip(flatten_with_paths(params),
                                          leaves(init))
             if torch.equal(a.detach(), b)]
    del init
    if still:
        fail(f"[train] leaves that did not move: {still}")
    phase("train", arch=PHI3, card=repr(smi), dtype=cfg.dtype,
          backend="plain", remat="full", params=n_params, batch=TRAIN_BATCH,
          seq=TRAIN_SEQ, steps=len(hist), first_loss=f"{hist[0]['loss']:.6f}",
          final_loss=f"{hist[-1]['loss']:.6f}",
          first_step_ms=f"{1e3 * hist[0]['dt']:.1f}",
          step_ms=f"{1e3 * step_s:.1f} (median of steps 2-7)",
          tok_s=f"{tokens / step_s:.1f}",
          tflop_s=f"{6 * n_params * tokens / step_s / 1e12:.2f} "
                  f"(6 N tokens; remat's recompute not counted)",
          peak_allocated_gib=f"{peak:.2f}",
          peak_reserved_gib=f"{reserved:.2f}",
          leaves_moved=len(leaves(params)),
          stragglers=len(out["stragglers"]),
          wall_s=f"{out['wall_time']:.1f}")
    del out

    # forward-only loss through the flash kernel, on the same weights
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in global_batch(dcfg, 0).items()}
    with torch.no_grad():
        plain, _ = model.loss_fn(params, batch)
        reset_launch_counts()
        cuda, _ = model.loss_fn(params, batch, backend="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
    rel = abs(float(cuda) - float(plain)) / abs(float(plain))
    phase("train_eval", arch=PHI3, card=repr(smi),
          loss_cuda=f"{float(cuda):.6f}",
          loss_plain=f"{float(plain):.6f}", rel_diff=f"{rel:.3e}",
          tol=f"rtol {TRAIN_EVAL_RTOL}", launches=json.dumps(counts))
    if counts["flash_attention"] != cfg.n_layers:
        fail(f"[train_eval] {counts['flash_attention']} flash launches, "
             f"want {cfg.n_layers}")
    if not rel <= TRAIN_EVAL_RTOL:
        fail(f"[train_eval] cuda loss {float(cuda)} vs plain {float(plain)}")
    flash = counts["flash_attention"]

    reset_launch_counts()
    try:
        model.loss_fn(params, batch, backend="cuda")
    except KernelGradError as e:
        refused = type(e).__name__
    else:
        fail("[train_refuses] backend='cuda' under autograd did not raise")
    torch.cuda.synchronize()
    launched = sum(launch_counts().values())
    phase("train_refuses", arch=PHI3, raised=refused, launches=launched)
    if launched:
        fail(f"[train_refuses] {launched} kernel launches before the "
             f"refusal")
    train_profile(torch, trainer, params, opt_state, batch, smi)

    # one update alone: the trained weights stand in for the gradients
    grads = {}
    for path, p in flatten_with_paths(params):
        node = grads
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = p.detach().clone()
    lr = torch.tensor(TRAIN_LR, dtype=torch.float32, device=dev)
    ms = timer(lambda: adamw.apply(tcfg.opt, params, grads, opt_state, lr),
               iters=3, warmup=1, flush=False)
    n_bytes = n_params * ADAMW_BYTES_PER_BF16_PARAM
    phase("train_apply", arch=PHI3, card=repr(smi), ms=f"{ms:.2f}",
          bound_ms=f"{1e3 * n_bytes / HBM_BYTES_PER_S:.2f} (bytes: "
                   f"{n_bytes / 1e9:.1f} GB)",
          chunk=adamw.CHUNK, seconds=f"{time.perf_counter() - t0:.1f}")
    del grads, params, opt_state, batch
    return flash


def train_profile(torch, trainer, params, opt_state, batch, smi):
    """``[train_profile]``: one more train step under ``torch.profiler``:
    wall and device ms, the busy share, device ms by kernel group (cuBLAS
    GEMMs, elementwise, reductions, copies and indexing, the rest) and
    the top kernels (``[train_profile_top]``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        """Self device time of one averaged event, in us."""
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    if not kern:
        phase("train_profile", arch=PHI3, device_events=0,
              note="the profiler recorded no device time")
        return
    total = sum(dev_us(e) for e in kern)
    groups = {"gemm": 0.0, "elementwise": 0.0, "reduce": 0.0,
              "copy_index": 0.0, "other": 0.0}
    for e in kern:
        n = e.key.lower()
        if any(t in n for t in ("gemm", "gemv", "nvjet", "cutlass")):
            g = "gemm"
        elif "elementwise" in n or "vectorized" in n:
            g = "elementwise"
        elif "reduce" in n or "softmax" in n:
            g = "reduce"
        elif any(t in n for t in ("copy", "cat", "index", "scatter",
                                  "gather", "stack")):
            g = "copy_index"
        else:
            g = "other"
        groups[g] += dev_us(e)
    phase("train_profile", arch=PHI3, card=repr(smi),
          wall_ms=f"{wall_us / 1e3:.1f}", device_ms=f"{total / 1e3:.1f}",
          busy_share=f"{total / wall_us:.3f}",
          kernels=sum(e.count for e in kern),
          **{f"{g}_ms": f"{t / 1e3:.1f}" for g, t in groups.items()})
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        phase("train_profile_top", arch=PHI3, kernel=repr(e.key[:70]),
              calls=e.count, device_ms=f"{dev_us(e) / 1e3:.2f}",
              share=f"{dev_us(e) / total:.3f}")


def train_exact(torch, dev, smi):
    """``[train_exact]``: 4 steps of each float32 smoke config on the card
    and on the CPU from the same CPU-drawn weights."""
    import functools
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.runtime.train_loop import make_train_step
    from repro_torch.tree import map_tree

    for arch in TRAIN_EXACT_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch + "-smoke")
        model = build_model(cfg)
        base = model.init(seed=0, device="cpu")
        batches = [train_batch(cfg, i) for i in range(TRAIN_EXACT_STEPS)]

        def losses(d):
            """The 4 steps' losses on device ``d``."""
            params = map_tree(lambda t: t.to(d, copy=True), base)
            step = make_train_step(model, adamw.AdamWConfig(lr=1e-3),
                                   functools.partial(
                                       warmup_cosine, peak_lr=1e-3,
                                       warmup_steps=1,
                                       total_steps=TRAIN_EXACT_STEPS))
            opt = adamw.init(params)
            got = []
            for b in batches:
                params, opt, m = step(params, opt, {
                    k: torch.from_numpy(v).to(d) for k, v in b.items()})
                got.append(float(m["loss"]))
            return got

        card, cpu = losses(dev), losses(torch.device("cpu"))
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        phase("train_exact", arch=cfg.name, dtype=cfg.dtype,
              card_losses=json.dumps([round(x, 6) for x in card]),
              cpu_losses=json.dumps([round(x, 6) for x in cpu]),
              max_rel_diff=f"{rel:.3e}", tol=f"rtol {TRAIN_EXACT_RTOL}",
              seconds=f"{time.perf_counter() - t0:.1f}")
        if not all(math.isfinite(x) for x in card) or \
                not rel <= TRAIN_EXACT_RTOL:
            fail(f"[train_exact] {cfg.name}: card {card} vs cpu {cpu}")


def train_restart(torch, dev, smi):
    """``[train_restart]``: the elastic-restart launcher on the card, a
    resumed run against an uninterrupted one, and ``run_with_restart``
    around an injected failure."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch import elastic_restart
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.ft import run_with_restart
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    from repro_torch.tree import flatten_with_paths

    t0 = time.perf_counter()
    res = elastic_restart.run(dev)
    resumed_at = res["phase2"]["history"][0]["step"]
    if resumed_at != 10 or not res["shards_equal"]:
        fail(f"[train_restart] elastic_restart resumed at {resumed_at}")
    cfg = get_config(elastic_restart.ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)

    def trainer(d, steps=15):
        """minitron-4b-smoke on the card, checkpoints every 5 in ``d``."""
        return Trainer(build_model(cfg), TrainConfig(
            steps=steps, ckpt_every=5, log_every=100, ckpt_dir=d,
            opt=adamw.AdamWConfig(lr=1e-3), device=dev), dcfg)

    with tempfile.TemporaryDirectory(prefix="train_restart_",
                                     dir=REPO / "build") as d:
        whole = trainer(None).run()
        first = trainer(d).run(steps=10)
        _, saved, _ = Checkpointer(d).restore_latest(
            like={"params": first["params"], "opt": first["opt_state"]},
            device=dev)
        live = {"params": first["params"], "opt": first["opt_state"]}
        unequal = [path for (path, a), (_, b) in zip(
            flatten_with_paths(saved), flatten_with_paths(live))
            if not torch.equal(a, b.detach())]
        if unequal:
            fail(f"[train_restart] restored leaves differ from the saved "
                 f"ones: {unequal}")
        resumed = trainer(d).run()
    got = [h["loss"] for h in resumed["history"]]
    want = [h["loss"] for h in whole["history"][10:]]
    if [h["step"] for h in resumed["history"]] != list(range(10, 15)):
        fail(f"[train_restart] resumed steps "
             f"{[h['step'] for h in resumed['history']]}")
    diff = max(abs(a - b) for a, b in zip(got, want))
    if diff != 0.0:
        fail(f"[train_restart] resumed losses {got} vs uninterrupted "
             f"{want}")

    fired = []
    with tempfile.TemporaryDirectory(prefix="train_ft_",
                                     dir=REPO / "build") as d:
        def make_state():
            """A fresh trainer whose step 7 raises once."""
            t = trainer(d, steps=10)
            step_fn = t._step_fn

            def failing(params, opt_state, batch):
                """The step, raising once at step 7."""
                if int(opt_state.step) == 7 and not fired:
                    fired.append(7)
                    raise RuntimeError("injected failure at step 7")
                return step_fn(params, opt_state, batch)

            t._step_fn = failing
            return {"trainer": t}

        outs = []
        restarts = run_with_restart(
            make_state, lambda st: outs.append(st["trainer"].run()))
    last = outs[-1]["history"]
    if restarts != 1 or fired != [7] or last[-1]["step"] != 9 or \
            last[0]["step"] != 5:
        fail(f"[train_restart] run_with_restart: {restarts} restarts, "
             f"steps {[h['step'] for h in last]}")
    phase("train_restart", arch=cfg.name, card=repr(smi),
          elastic_resumed_at=resumed_at, shards_equal=res["shards_equal"],
          restored_equal_saved=True, resumed_steps="10-14",
          max_loss_diff_vs_uninterrupted=diff,
          run_with_restart=f"restarts={restarts} resumed_at=5 "
                           f"final_step={last[-1]['step']}",
          seconds=f"{time.perf_counter() - t0:.1f}")


def train_lm_phase(torch, dev, smi):
    """``[train_lm]``: ``launch/train_lm`` at lm-100m on the card."""
    from repro_torch.launch import train_lm

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_lm_",
                                     dir=REPO / "build") as d:
        out = train_lm.main(["--steps", "100", "--device", str(dev),
                             "--ckpt-dir", d])
        ckpts = sorted(os.listdir(d))
    hist = out["history"]
    first, final = hist[0]["loss"], hist[-1]["loss"]
    phase("train_lm", arch="lm-100m", card=repr(smi), dtype="float32",
          steps=len(hist), seq=256, batch=8, tok_s=f"{out['tok_s']:.1f}",
          first_loss=f"{first:.4f}", final_loss=f"{final:.4f}",
          checkpoints=json.dumps(ckpts),
          seconds=f"{time.perf_counter() - t0:.1f}")
    if len(hist) != 100 or not (math.isfinite(final) and final < first):
        fail(f"[train_lm] {len(hist)} steps, loss {first} -> {final}")
    if ckpts != ["step_00000050", "step_00000100"]:
        fail(f"[train_lm] checkpoints {ckpts}")


# ---------------------------------------------------------------------------
# The chunked backend, the roofline, a meshed trainer, serving launchers
# ---------------------------------------------------------------------------

# (batch, seq): [train]'s cell, and train_4k's sequence at batch 1
CHUNKED_SHAPES = ((TRAIN_BATCH, TRAIN_SEQ), (1, 4096))
CHUNKED_STEPS = 5
# chunked rounds each probability block to bf16 for P V (as JAX's
# attention_chunked); the plain path keeps float32 probabilities
CHUNKED_RTOL = 1e-2
# a one-card mesh holds the same values as the unmeshed run; the CPU
# test's tolerance for a meshed run against an unmeshed one (RUN_RTOL)
MESH_RTOL = 1e-4
# the compressed all-reduce over a group of one is the quantise /
# dequantise round trip, to float32 rounding
ALLREDUCE_ATOL = 1e-6
MESH_FAMILY_ARCHS = ("minitron-4b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                     "recurrentgemma-9b", "paligemma-3b",
                     "whisper-large-v3")
SERVE_LM_ARGS = ["--arch", PHI3, "--batch", "4", "--prompt-len", "16",
                 "--new-tokens", "24"]


def slice_phases(torch, dev, smi):
    """``[chunked]``, ``[roofline]``, ``[mesh]``, ``[dryrun]``,
    ``[dryrun_vs_card]`` and ``[launch_serving]``, the card freed
    between them."""
    free_card(torch)
    chunked_phase(torch, dev, smi)
    free_card(torch)
    roofline_phase(smi)
    mesh_phase(torch, dev, smi)
    free_card(torch)
    dryrun_phase(smi)
    dryrun_vs_card_phase(torch, dev, smi)
    free_card(torch)
    launch_serving_phase(torch, dev, smi)
    free_card(torch)


def _train_run(torch, dev, backend, batch, seq, steps, mesh=None):
    """``Trainer`` on full phi3-mini-3.8b (the ``[train]`` cell's
    optimizer, schedule and seed): (losses, median step seconds of steps
    2 on, peak allocated GiB, the run's output)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = get_config(PHI3)
    torch.cuda.reset_peak_memory_stats()
    out = Trainer(build_model(cfg), TrainConfig(
        steps=steps, log_every=100, opt=adamw.AdamWConfig(lr=TRAIN_LR),
        warmup_steps=TRAIN_WARMUP, seed=0, device=dev, backend=backend),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                   global_batch=batch, seed=0), mesh=mesh).run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = out["history"]
    step_s = sorted(h["dt"] for h in hist[2:])[len(hist[2:]) // 2]
    return [h["loss"] for h in hist], step_s, peak, out


def chunked_phase(torch, dev, smi):
    """``[chunked]``: the trainer on full phi3 with ``backend="chunked"``
    beside ``"plain"`` at the ``[train]`` cell and at 4096 x 1: step ms,
    peak GiB, the largest loss difference.  A run out of memory is
    printed as the finding; chunked must run and agree with plain
    within :data:`CHUNKED_RTOL` wherever plain ran."""
    for batch, seq in CHUNKED_SHAPES:
        t0 = time.perf_counter()
        got = {}
        for backend in ("plain", "chunked"):
            free_card(torch)
            try:
                losses, step_s, peak, out = _train_run(
                    torch, dev, backend, batch, seq, CHUNKED_STEPS)
                del out
                got[backend] = (losses, step_s, peak)
            except torch.OutOfMemoryError as e:
                got[backend] = None
                phase("chunked_oom", arch=PHI3, backend=backend,
                      batch=batch, seq=seq, error=repr(str(e)[:160]))
            free_card(torch)
        if got["chunked"] is None:
            fail(f"[chunked] backend='chunked' ran out of memory at "
                 f"{batch} x {seq}")
        fields = {}
        for backend, res in got.items():
            if res is None:
                fields[f"{backend}_step_ms"] = "out of memory"
                continue
            losses, step_s, peak = res
            if not all(math.isfinite(x) for x in losses):
                fail(f"[chunked] {backend} losses {losses}")
            fields[f"{backend}_step_ms"] = f"{1e3 * step_s:.1f}"
            fields[f"{backend}_peak_gib"] = f"{peak:.2f}"
            fields[f"{backend}_losses"] = json.dumps(
                [round(x, 6) for x in losses])
        diff = None
        if got["plain"] is not None:
            diff = max(abs(a - b) / abs(b) for a, b in
                       zip(got["chunked"][0], got["plain"][0]))
        phase("chunked", arch=PHI3, card=repr(smi), dtype="bfloat16",
              batch=batch, seq=seq, steps=CHUNKED_STEPS,
              step_ms_of="median of steps 2-4",
              max_loss_rel_diff="plain out of memory" if diff is None
              else f"{diff:.3e}", tol=f"rtol {CHUNKED_RTOL}", **fields,
              seconds=f"{time.perf_counter() - t0:.1f}")
        if diff is not None and not diff <= CHUNKED_RTOL:
            fail(f"[chunked] {batch} x {seq}: chunked vs plain losses "
                 f"differ by {diff}")


def roofline_phase(smi):
    """``[roofline]``: the analytic terms of every config at the four
    ``SHAPES`` on the H100's peaks (arithmetic, the same on any
    machine); the skipped cells named with their reason."""
    from repro_torch.configs import REGISTRY, SHAPES, shape_applicable
    from repro_torch.launch import roofline

    if (roofline.PEAK_FLOPS, roofline.HBM_BW) != (989e12, 3.35e12):
        fail(f"[roofline] peaks {roofline.PEAK_FLOPS} "
             f"{roofline.HBM_BW} are not the H100's")
    for arch in sorted(REGISTRY):
        cfg = REGISTRY[arch]
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            if not ok:
                phase("roofline", arch=arch, shape=shape.name,
                      skipped=repr(why))
                continue
            mf = roofline.model_flops(cfg, shape)
            fc = roofline.flash_attention_cost(cfg, shape)
            phase("roofline", arch=arch, shape=shape.name, card=repr(smi),
                  active_params=roofline.active_params(cfg),
                  model_flops=f"{mf:.4e}",
                  model_flops_s=f"{mf / roofline.PEAK_FLOPS:.4e}",
                  flash_flops=f"{fc['flops']:.4e}",
                  flash_bytes=f"{fc['bytes']:.4e}",
                  flash_compute_s=f"{fc['flops'] / roofline.PEAK_FLOPS:.4e}",
                  flash_memory_s=f"{fc['bytes'] / roofline.HBM_BW:.4e}")


def mesh_phase(torch, dev, smi):
    """``[mesh]``: a one-process NCCL group (``HashStore``) and a
    ``(1, 1)`` ``(data, model)`` mesh on the card; the meshed trainer
    takes ``[train]``'s steps (its losses within :data:`MESH_RTOL` of
    ``[train]``'s, every leaf a DTensor), and ``allreduce_compressed``
    over the group equals ``compress_tree``'s round trip; then
    ``[mesh_family]``: six float32 smoke configs (every family) 3 steps
    meshed against unmeshed, within :data:`MESH_RTOL`; the group is
    destroyed after."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import close_group, init_group, make_mesh
    from repro_torch.optim import grad_compress
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    init_group("nccl", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        losses, step_s, peak, out = _train_run(
            torch, dev, "plain", TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
            mesh=mesh)
        plain_leaves = [p for p in leaves(out["params"])
                        if not isinstance(p, DTensor)]
        del out
        free_card(torch)
        want = TRAIN_CELL["losses"]
        diff = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        gen = torch.Generator(device=dev).manual_seed(0)
        grads = {"a": torch.randn(3072, 8192, generator=gen, device=dev,
                                  dtype=torch.bfloat16),
                 "b": torch.randn(32064, generator=gen, device=dev)}
        err = {k: 1e-3 * torch.randn(v.shape, generator=gen, device=dev)
               for k, v in grads.items()}
        mean, new_err = grad_compress.allreduce_compressed(grads, err)
        q, s, want_err = grad_compress.compress_tree(grads, err)
        round_trip = grad_compress.decompress_tree(q, s)
        ar = max(float((mean[k] - round_trip[k]).abs().max())
                 for k in grads)
        ae = max(float((new_err[k] - want_err[k]).abs().max())
                 for k in grads)
        del grads, err, mean, new_err, q, s, want_err, round_trip
        free_card(torch)
        families = {arch: mesh_family_losses(torch, dev, arch, mesh)
                    for arch in MESH_FAMILY_ARCHS}
    finally:
        close_group()
    phase("mesh", arch=PHI3, card=repr(smi), mesh="(1, 1) data x model",
          backend="nccl", store="HashStore", world=1, batch=TRAIN_BATCH,
          seq=TRAIN_SEQ, steps=len(losses),
          losses=json.dumps([round(x, 6) for x in losses]),
          train_losses=json.dumps([round(x, 6) for x in want]),
          max_loss_rel_diff=f"{diff:.3e}", tol=f"rtol {MESH_RTOL}",
          step_ms=f"{1e3 * step_s:.1f} (median of steps 2-7)",
          train_step_ms=f"{1e3 * TRAIN_CELL['step_s']:.1f}",
          peak_allocated_gib=f"{peak:.2f}",
          allreduce_vs_round_trip=f"{ar:.3e}",
          error_vs_round_trip=f"{ae:.3e}", atol=ALLREDUCE_ATOL,
          seconds=f"{time.perf_counter() - t0:.1f}")
    for arch, (got, want) in families.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        phase("mesh_family", arch=arch + "-smoke", dtype="float32",
              mesh="(1, 1)", steps=len(got),
              losses=json.dumps([round(x, 6) for x in got]),
              unmeshed=json.dumps([round(x, 6) for x in want]),
              max_loss_rel_diff=f"{rel:.3e}", tol=f"rtol {MESH_RTOL}")
        if not rel <= MESH_RTOL:
            fail(f"[mesh_family] {arch}-smoke meshed {got} vs {want}")
    if plain_leaves:
        fail(f"[mesh] {len(plain_leaves)} parameter leaves are not "
             f"DTensors")
    if not diff <= MESH_RTOL:
        fail(f"[mesh] meshed losses {losses} vs [train]'s {want}")
    if not (ar <= ALLREDUCE_ATOL and ae <= ALLREDUCE_ATOL):
        fail(f"[mesh] allreduce_compressed vs the round trip: mean {ar}, "
             f"error {ae}")


# (arch, shape, multi_pod, calibrate): the dry-run cells run here at full
# size on the production meshes (host work: fake tensors, no card)
DRYRUN_CELLS = (("qwen3-32b", "train_4k", False, True),
                ("qwen2-moe-a2.7b", "prefill_32k", False, True),
                ("falcon-mamba-7b", "decode_32k", False, True),
                ("qwen3-32b", "train_4k", True, False))
# the dry-run's bytes a device over [train]'s max_memory_allocated
DRYRUN_MEMORY_RATIO = (0.5, 2.0)


def dryrun_phase(smi):
    """``[dryrun]``: ``launch/dryrun.run_cell`` on the cells of
    :data:`DRYRUN_CELLS` (full configs, the 16 x 16 and 2 x 16 x 16
    fake meshes; the card's torch, whose DTensor differs from the CPU
    tests'): status, seconds, bytes a device, flops, collective bytes by
    kind, the roofline's dominant term and mfu.  Gated: status ok,
    finite terms, and the calibration's extension equal to the full
    count."""
    from repro_torch.launch import dryrun

    for arch, shape, multi_pod, calibrate in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                              calibrate=calibrate)
        secs = time.perf_counter() - t0
        if rec["status"] != "ok":
            fail(f"[dryrun] {arch} {shape} {rec['mesh']}: "
                 f"{rec['status']} {rec.get('error')}")
        full, roof = rec["full"], rec["roofline"]
        phase("dryrun", arch=arch, shape=shape, mesh=rec["mesh"],
              card=repr(smi), status=rec["status"], seconds=f"{secs:.1f}",
              place_s=f"{full['lower_s']:.1f}",
              run_s=f"{full['compile_s']:.1f}",
              gib_per_device=f"{full['bytes_per_device'] / 2 ** 30:.2f}",
              memory=json.dumps(full["memory"]),
              flops_per_device=f"{full['flops_per_device']:.4e}",
              bytes_accessed_per_device=(
                  f"{full['bytes_per_device_accessed']:.4e}"),
              collective_bytes=json.dumps(
                  {k: f"{v:.4e}" for k, v in
                   sorted(full["collectives_by_kind"].items())}),
              collective_counts=json.dumps(full["collective_counts"]),
              dominant=roof["dominant"],
              terms_s=json.dumps({k: f"{roof[k]:.4e}" for k in (
                  "compute_s", "memory_s", "collective_s")}),
              mfu=f"{roof['mfu']:.4f}",
              extrapolation=(("ok" if rec["extrapolation"]["ok"]
                              else "FAILED") if calibrate
                             else "not calibrated"))
        terms = [roof[k] for k in ("compute_s", "memory_s",
                                   "collective_s", "mfu")]
        if not all(math.isfinite(t) for t in terms):
            fail(f"[dryrun] {arch} {shape}: terms {terms}")
        if calibrate and not rec["extrapolation"]["ok"]:
            fail(f"[dryrun] {arch} {shape}: the calibration's extension "
                 f"differs from the full count: {rec['extrapolation']}")


def dryrun_vs_card_phase(torch, dev, smi):
    """``[dryrun_vs_card]``: the ``[train]`` cell (full phi3-mini-3.8b,
    4 x 512, remat "full", plain, bf16) dry-run on a (1, 1) fake mesh
    beside one real step of the same cell on the card under the same
    counter: flops equal exactly (the fake run dispatches the real run's
    ops), the dry-run's bytes a device beside ``[train]``'s
    max_memory_allocated (ratio gated within
    :data:`DRYRUN_MEMORY_RATIO`) and its roofline step time beside
    ``[train]``'s step ms."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    t0 = time.perf_counter()
    cfg = get_config(PHI3)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = dryrun.run_cell(PHI3, "train", mesh_shape=(1, 1), cfg=cfg,
                          shape=shape, calibrate=False)
    fake_s = time.perf_counter() - t0
    if rec["status"] != "ok":
        fail(f"[dryrun_vs_card] fake run: {rec.get('error')}")
    full = rec["full"]
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = adamw.init(params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             train_batch(cfg, 0, rows=TRAIN_BATCH, seq=TRAIN_SEQ).items()}
    step = dryrun.cell_train_step(model, remat="full")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    real = dryrun.count_step(step, (params, opt, batch))
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t1
    real_peak = torch.cuda.max_memory_allocated()
    del params, opt, batch, step
    train_peak = TRAIN_CELL["peak_bytes"]
    ratio = full["bytes_per_device"] / train_peak
    roof = rec["roofline"]
    phase("dryrun_vs_card", arch=PHI3, card=repr(smi), dtype=cfg.dtype,
          mesh="(1, 1) fake", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
          remat="full", fake_flops=f"{full['flops_per_device']:.0f}",
          card_flops=f"{real['flops_per_device']:.0f}",
          fake_bytes_accessed=f"{full['bytes_per_device_accessed']:.0f}",
          card_bytes_accessed=f"{real['bytes_per_device_accessed']:.0f}",
          fake_gib_per_device=f"{full['bytes_per_device'] / 2 ** 30:.2f}",
          fake_memory=json.dumps(full["memory"]),
          card_counted_gib=f"{real['bytes_per_device'] / 2 ** 30:.2f}",
          card_step_peak_allocated_gib=f"{real_peak / 2 ** 30:.2f}",
          train_peak_allocated_gib=f"{train_peak / 2 ** 30:.2f}",
          fake_over_train_peak=f"{ratio:.4f}",
          ratio_gate=json.dumps(DRYRUN_MEMORY_RATIO),
          roofline_step_ms=f"{1e3 * roof['step_time_s']:.1f}",
          roofline_dominant=roof["dominant"],
          train_step_ms=f"{1e3 * TRAIN_CELL['step_s']:.1f}",
          fake_s=f"{fake_s:.1f}", card_step_s=f"{real_s:.1f}",
          seconds=f"{time.perf_counter() - t0:.1f}")
    if full["flops_per_device"] != real["flops_per_device"]:
        fail(f"[dryrun_vs_card] fake flops {full['flops_per_device']} != "
             f"the card step's {real['flops_per_device']}")
    lo, hi = DRYRUN_MEMORY_RATIO
    if not lo <= ratio <= hi:
        fail(f"[dryrun_vs_card] bytes a device over [train]'s peak: "
             f"{ratio}")


def mesh_family_losses(torch, dev, arch, mesh):
    """3 steps of ``arch``'s float32 smoke config (the ``[train_exact]``
    batches, lr 1e-3) unmeshed and on ``mesh``: (meshed losses,
    unmeshed losses).  Every family's DTensor path, the explicitly
    redistributed layers (moe, RG-LRU, attention, the embedding)
    included."""
    import functools
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import identity_shard
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import constant
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train_loop import make_train_step
    from repro_torch.tree import leaves

    cfg = get_config(arch + "-smoke")
    model = build_model(cfg)
    rules = shd.ShardingRules()
    batches = [train_batch(cfg, i) for i in range(3)]

    def losses(on):
        """The 3 losses, on ``mesh`` when ``on``."""
        params = model.init(seed=0, device=dev)
        shard_fn = identity_shard
        if on:
            params = shd.distribute_tree(params, shd.tree_specs(
                model.axes_tree(), params, mesh, rules), mesh)
            shard_fn = shd.make_activation_shard_fn(mesh, rules)
        for p in leaves(params):
            p.requires_grad_(True)
        step = make_train_step(model, adamw.AdamWConfig(lr=1e-3),
                               functools.partial(constant, peak_lr=1e-3),
                               shard_fn=shard_fn)
        opt = adamw.init(params)
        out = []
        for b in batches:
            b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            if on:
                specs = shd.batch_specs(b, mesh, rules)
                b = {k: shd.distribute(v, specs[k], mesh)
                     for k, v in b.items()}
            params, opt, m = step(params, opt, b)
            out.append(float(m["loss"]))
        return out

    return losses(True), losses(False)


def launch_serving_phase(torch, dev, smi):
    """``[launch_serving]``: ``launch/serve_lm`` on full phi3-mini-3.8b
    (batch 4, prompt 16, 24 new tokens), ``launch/serve_session`` and
    ``launch/serve_adaptive`` at their defaults (smoke configs), on the
    card; each must return and print its summary line."""
    import io
    from repro_torch.launch import serve_adaptive, serve_lm, serve_session

    runs = {"serve_lm": (serve_lm, SERVE_LM_ARGS, "generated (4, 24)"),
            "serve_session": (serve_session, [], "requests / "),
            "serve_adaptive": (serve_adaptive, [], "repeat call:")}
    for name, (mod, argv, marker) in runs.items():
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = mod.main(argv)
        text = buf.getvalue()
        fields = {}
        if name == "serve_lm":
            toks, stats = res
            fields = {"tokens": repr(toks.shape),
                      "decode_tok_s": f"{stats.decode_tok_s:.1f}",
                      "prefill_ms": f"{1e3 * stats.prefill_s:.1f}"}
        elif name == "serve_session":
            fields = {"requests": json.dumps(
                [r["stats"]["requests"] for r in res]),
                "decode_tok_s": json.dumps(
                    [round(r["stats"]["decode_tok_s"], 1) for r in res])}
        else:
            fields = {"cache": json.dumps(res["cache"]),
                      "report_kinds": json.dumps(sorted(
                          e["kind"] for e in res["report"].values()))}
        lines = [l for l in text.splitlines() if marker in l]
        phase("launch_serving", launcher=name, card=repr(smi),
              args=repr(" ".join(argv)), summary=repr(lines[:2]),
              **fields, seconds=f"{time.perf_counter() - t0:.1f}")
        if not lines:
            fail(f"[launch_serving] {name} printed no {marker!r} line")
        free_card(torch)


def _leaves(tree):
    """Tensors of a nested parameter dict."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
