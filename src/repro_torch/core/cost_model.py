"""The H100 cost model of the port's kernels: the thesis kernels (conv,
matmul, sparse conv) and the serving kernels (flash attention, the split
decode, the selective scan); and, beside it, the thesis' Loki machine
model (``CacheLevel``, ``MachineModel``, ``HIERARCHIES``, ``simulate``,
``sweep_permutations``, ``simulate_batch``), defined in
:mod:`repro_torch.core.loki` and re-exported here, as the JAX package
keeps both machines in one module.  Both count into :data:`EVAL_COUNTS`.

It keeps the JAX package's structure (``repro.core.cost_model``, the
TPU model) and changes its machine.  What does not depend on the
machine is kept as it is: the block-fetch arithmetic
(:func:`_batch_refetch`) and the ``hbm_bytes`` and ``grid_steps`` counts
equal the JAX package's for the same (layer, order, block).  What does
is the port's own:

- :class:`H100Spec` replaces ``TPUSpec``: 3.35 TB/s, 132 SMs, 227 KB of
  shared memory a block in place of the VMEM budget, the fp32 FMA rate
  of the CUDA cores (67 TFLOP/s) and the bf16 tensor-core peak (989
  TFLOP/s).
- Compute follows the body the dtype runs (in ``kernels/_geometry.py``
  ``tensor_cores`` picks the body and the layouts describe it):
  - bf16 conv2d, the block-sparse conv and matmul run on the tensor
    cores.  A schedule is
    timed as its padded MMA work (pixels, oc and ic padded to 16 for the
    conv's mma.sync; rows to 64 a warpgroup, columns to the wgmma width
    and k to the stage depth for the matmul's wgmma) at the tensor-core
    peak or at the shared-memory rate its fragment reads need, whichever
    is slower, plus its staging: the conv's cp.async units
    (``CHUNK_CYCLES`` each) and channels-last units (``UNIT_CYCLES``)
    of the operands a step streams, ``STEP_CYCLES`` a step and
    ``EPI_CYCLES`` a 32-byte output sector.  A conv step's round trip
    (``LOAD_LATENCY_S``) is hidden over its ring's stages - 1 steps,
    and every first stage waits for it.  A conv block walks the
    layout's tiles: the operand they share (the weights, or the halo
    when oc is the last output axis) is staged once, in the walk's first
    steps, and only the other streams.  Launches run in whole waves of
    SMs x resident blocks plus a tail; blocks resident together share
    an SM's throughput and overlap their latency.  The persistent
    matmul body (``_matmul_mma_seconds``) is timed as the walk of its
    most loaded block under ``_geometry.matmul_plan``: a ring chunk
    takes the longest of its wgmmas, its shared-memory reads and the
    bytes its SM's ring receives, or a stage's round trip over the
    stages its consumers do not hold, or the producer's register-route
    fills; each tile adds its epilogue and each split part its partial
    and ticket (``MatmulBodyConsts``).  The constants are fitted to
    ``launch/calibrate_thesis.py``'s timings.
    The block-sparse conv runs the dense conv's body over the expected
    nonzero channel blocks of each oc block (block density x ic blocks;
    given the weights, each skip block's own density, and its busiest
    oc block's excess over the mean on one SM), at the dense model's
    pixel tile for its skip block (``sparsity.sparse_pixel_tile``), after
    one round trip for its index row; a tile with none writes zeros.  A call costs ``SPARSE_CALL_S``
    more than its launch, fitted to its calibration lines.
  - float32 runs on the CUDA cores: an issue-rate model.  An SM issues
    4 warp FMAs and 1 shared-memory wavefront a clock, so a conv tap
    costs a warp max(J / 4, 1 + the wavefronts of its J weights) cycles
    and a matmul k step max(MI MJ / 4, MI + MJ); staging costs
    ``stage_instr`` instructions an element; and each staged step waits
    ``step_latency_s`` for its loads and barriers, hidden by the other
    blocks resident on the SM.  The float32 block-sparse body is timed
    as the longer of that and its blocks' sequential work
    (``SPARSE_CHANNEL_S`` an input channel of a step, in waves), plus
    ``SPARSE_CALL_S`` a call: the channel constant was fitted to this
    CUDA-core body's calibration lines when bf16 ran it too, where the
    issue-rate model alone was 6-10x optimistic.
- A block runs on one SM, so a launch with fewer tiles than SMs leaves
  SMs idle: compute time is divided by min(1, tiles / SMs).
- Each launch costs ``launch_s``, and every read-modify-write pass is a
  launch of its own.
- Memory.  On the TPU a block fetch is a DMA from HBM, so the JAX
  model charges the grid order's refetches to HBM.  On the H100 those
  fetches hit the 50 MB L2, which holds every operand of these layers:
  device memory sees each input once and the output once
  (``dram_bytes``).  What the order cannot avoid is the staging: every
  block copies its weight and image tiles (A and B chunks) from L2 into
  shared memory at each grid step, and a read-modify-write pass also
  reads and writes its output tile (``staged_bytes``).  The memory term
  is the larger of dram_bytes over 3.35 TB/s and staged_bytes over
  ``l2_bw``; ``hbm_bytes`` keeps the JAX count for comparison.
- A schedule the kernel refuses (shared memory, threads, channels a
  thread) keeps the feasibility penalty of +1e3 s, so it ranks last.

The serving kernels are latency-bound at the engine's shapes, so their
models count what a block waits on, not the TPU formulas of the JAX
package (its ``flash_attention_schedule_cost_batch`` and kin), with
compulsory bytes at 3.35 TB/s as the memory term:

- flash attention: the key tiles each query tile can reach under the
  causal mask; a block costs ``FLASH_BLOCK_S`` (Q in, O out) plus, for
  its most loaded wave, ``FLASH_TILE_S`` a reachable tile (the cp.async
  round trip and two barriers), plus the tiles' work (MMAs, exps on the
  SFUs and staging from L2, at their peak rates, times
  ``FLASH_WORK_EFF``) spread over the SMs in use.  The body is the
  one the wrapper runs (``_geometry.flash_body``: by dtype and head dim,
  so a windowed call too).  The wgmma body, which every model's head
  dim runs, has its own three: ``FLASH_WGMMA_BLOCK_S`` a block,
  ``FLASH_WGMMA_TILE_S`` a reachable tile of its most loaded wave (its
  producer's TMA ring hides most of a tile's round trip) and its tiles'
  work times ``FLASH_WGMMA_WORK_EFF``, with its MMAs at
  ``FLASH_WGMMA_MMA_SHARE`` of the mma.sync body's time; a tile whose
  registers exceed the launch bounds' budget (``FlashWgmmaTile.spills``)
  runs its MMAs at the mma.sync rate and its softmax and staging after
  them, as ptxas serializes them;
- the split decode: per wave of (row, split) blocks ``DEC_BLOCK_S`` plus
  ``DEC_TILE_S`` a staged tile of its split, plus ``DEC_MERGE_S`` an L2
  round trip of the merge (4 splits' partials each) when a row has more
  than one split.  The packed body (``_geometry.decode_body``) has one
  block a (row, KV head, split), so K and V are staged once a KV head,
  and it combines in clusters: one round of distributed shared memory,
  and one more through L2 for a row of more than one cluster;
- the selective scan: per wave ``SCAN_BLOCK_S`` plus ``SCAN_STEP_S`` a
  step of the recurrence, plus ``SCAN_EXP_S`` an exp of the most loaded
  SM (its resident blocks share its SFUs: the bound of PERF.md's row 4).

Blocks resident on an SM come from threads and shared memory, as for the
thesis bodies.  ``launch/calibrate_thesis.py --score`` fits each
family's constants on timed candidates, by least squares and by a
coordinate search of the mean squared log error (the fit flash's wgmma
terms and the decode's constants keep).

Its version string is its own (``h100-9`` times the bf16 conv body on
wgmma: 64-row tiles of the halo's rows, the products overlapping the
next step's pass, refitted constants; ``h100-8`` scores flash's one bf16 body
at the models' head dims with its own block and tile terms, and refits
the decode; ``h100-7`` times the persistent bf16 matmul body: its walk,
tail split and epilogue; ``h100-6`` the
redesigned bf16 conv body: cp.async ring, walks with a resident operand;
``h100-5``
adds the second bodies of flash attention and of the decode;
``h100-4`` the serving kernels; ``h100-3`` timed the thesis kernels
before that, ``h100-2`` the block-sparse conv on the CUDA cores in both
dtypes, ``h100-1`` every body): no TPU constant and no TPU-measured
record is reused.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.loki import (  # noqa: F401  (the Loki model)
    EVAL_COUNTS, HIERARCHIES, LOKI_MODEL_VERSION, BatchSimResult,
    CacheLevel, CacheSimResult, MachineModel, simulate, simulate_batch,
    sweep_permutations)
from repro_torch.core.loopnest import ConvLayer
from repro_torch.kernels import _geometry as geo

# Bump whenever a change below alters predicted costs: the registry keys
# cached rankings on it, so stale predictions self-invalidate.
COST_MODEL_VERSION = "h100-9"

# Cost-model queries in this process, one per candidate scored: a warm
# registry hit performs zero (asserted in tests/test_torch_thesis.py).
# The dict is the Loki model's (its sweeps, ECM batches and traces count
# there too), so total_evals sums both machines.
EVAL_COUNTS.update({"conv_schedule_cost": 0,
                    "conv_schedule_cost_batch": 0,
                    "matmul_schedule_cost_batch": 0,
                    "sparse_conv_schedule_cost_batch": 0,
                    "flash_attention_schedule_cost_batch": 0,
                    "decode_attention_schedule_cost_batch": 0,
                    "ssm_scan_schedule_cost_batch": 0})

INFEASIBLE_S = 1e3

# Constants of the bodies' timing, fitted to ``launch/calibrate_thesis.py``
# timings on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; ``--score``
# reports the fit).  The bf16 conv body's six: the coordinate search of
# ``--score`` on the wgmma body's 376 conv and sparse conv lines (the
# search kept the mma.sync body's fixed cost of a step; it takes most of
# the time the channels-last units once charged; it drove LATE_SHARE to
# its floor, the single-slot layouts' lines being timed faster than a
# step's wgmmas and pass in turn):
UNIT_CYCLES = 2.258       # SM cycles to write one channels-last unit (8
#                           channels of a pixel or an oc row: eight
#                           2-byte shared-memory reads, one 16-byte store)
CHUNK_CYCLES = 1.314      # SM cycles to issue one 16-byte cp.async unit
STEP_CYCLES = 4754.0      # a conv step's fixed cycles (its wait and
#                           barrier, the MMA pipeline's refill)
EPI_CYCLES = 18.48        # SM cycles an output sector of the epilogue
#                           (32 bytes of a channel's run)
LOAD_LATENCY_S = 2.554e-6  # round trip of a conv ring step's loads (hidden
#                           over stages - 1 steps of work)
LATE_SHARE = 0.01562      # share of the shorter of a step's wgmmas and its
#                           pass that a single-slot (late) layout runs in
#                           turn with the longer


@dataclasses.dataclass(frozen=True)
class ConvBodyConsts:
    """The bf16 conv body's six constants as one value.  A spec whose
    ``conv_body`` is None times the body with the module's constants
    above (:meth:`fitted`, read at each call); ``calibrate_thesis``'s fit
    passes its trial values in a spec of its own."""
    unit_cycles: float
    chunk_cycles: float
    step_cycles: float
    epi_cycles: float
    load_latency_s: float
    late_share: float

    @classmethod
    def fitted(cls) -> "ConvBodyConsts":
        """The module's constants."""
        return cls(UNIT_CYCLES, CHUNK_CYCLES, STEP_CYCLES, EPI_CYCLES,
                   LOAD_LATENCY_S, LATE_SHARE)


# The persistent bf16 matmul body's seven (``MatmulBodyConsts``), from the
# coordinate search of ``calibrate_thesis --score`` on its 128 matmul
# lines (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
MM_MMA_EFF = 0.6854       # share of the tensor-core peak a ring chunk's
#                           wgmmas reach
MM_CHUNK_S = 2.399e-7     # a chunk's fixed cost to its consumers (the
#                           wait, the fence, the issue, the release)
MM_SM_IN_BW = 1.123e11    # bytes/s one SM's ring receives (TMA or the
#                           producer's fills)
MM_RING_LATENCY_S = 2.074e-6  # round trip of a ring stage, hidden over
#                           the stages the consumers do not hold (stages
#                           - 2)
MM_TILE_S = 8.078e-7      # a tile's epilogue (its stores)
MM_PART_S = 2.769e-6      # a split part's partial, fence and ticket
MM_FILL_LATENCY_S = 1.714e-6  # round trip of a register-route fill batch
# The block-sparse conv: a call's fixed time beyond its launch (both
# bodies; least squares on the bf16 tensor-core body's 120 sparse_conv
# lines before its redesign, kept for the float32 body)
SPARSE_CALL_S = 1.005e-5
# The float32 (CUDA-core) block-sparse body: one input channel of one
# staged step of a block (its taps run channel by channel), fitted to
# 120 lines of this body when it ran bf16 too; registers a thread (ptxas)
SPARSE_CHANNEL_S = 2.371e-6
SPARSE_REGS = 64
# The serving kernels: least squares of ``calibrate_thesis --kinds
# flash_attention decode_attention ssm_scan`` (67 lines: every offered
# candidate at 6 flash, 6 decode and 6 scan shapes, bf16) on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md); flash's wgmma terms and the decode
# refitted since, below.  Flash's mma.sync body (now only at head dims
# outside FLASH_WGMMA_D, which no model has, so these stay as fitted
# then): a block's Q load and epilogue, a reachable key tile's round
# trip, and the multiple of the peak rates' time its tile work takes.
FLASH_BLOCK_S = 6.802e-6
FLASH_TILE_S = 1.209e-6
FLASH_WORK_EFF = 3.132
# The wgmma flash body's time for a tile's work as a share of the
# mma.sync body's: the geometric mean of the two bodies' ratios at 4096
# keys in the sweep of both bodies that chip_smoke.py ran before flash
# had one bf16 body at these head dims (0.267 at D 256 causal, 0.427 at
# D 64; NVIDIA H100 80GB HBM3, 700 W; PERF.md).
FLASH_WGMMA_MMA_SHARE = 0.34
# The multiple of its tiles' work that the wgmma body takes: the least
# squares of ``calibrate_thesis --score`` on its 6 lines (3 shapes past
# 512 keys at 64 and 128 rows; NVIDIA H100 80GB HBM3, 700 W; PERF.md).
FLASH_WGMMA_WORK_EFF = 1.631
# A wgmma block's fixed latency (Q by TMA, the first K/V tiles, the
# epilogue) and a reachable key tile's round trip, which the ring mostly
# hides: the prefills of the engine's buckets hold few tiles a block.
# ``calibrate_thesis --score``'s coordinate fit of the mean squared log
# error on its 22 flash lines (11 shapes at 64 and 128 rows, phi3's
# buckets 16-512 among them), FLASH_WGMMA_WORK_EFF kept; NVIDIA H100
# 80GB HBM3, 700 W; PERF.md.
FLASH_WGMMA_BLOCK_S = 5.782e-6
FLASH_WGMMA_TILE_S = 1.4e-7
# The split decode: a block's fixed latency (q, pos and starts, the
# partial's publication), a staged tile, a merge batch of 4 splits; the
# coordinate fit of ``calibrate_thesis --score`` on its 47 decode lines
# (chunked at MHA, packed at three grouped shapes; NVIDIA H100 80GB
# HBM3, 700 W; PERF.md).
DEC_BLOCK_S = 9.463e-6
DEC_TILE_S = 2.582e-6
DEC_MERGE_S = 1.917e-6
# The selective scan: a wave's fixed latency, a step of the recurrence,
# an exp on the most loaded SM.
SCAN_BLOCK_S = 5.564e-6
SCAN_STEP_S = 1.718e-8
SCAN_EXP_S = 5.988e-11
# exps an SM's special-function units issue a clock (4 in each of its
# quadrants), at the clock implied by the CUDA-core peak
SFU_PER_CLOCK = 16


def reset_eval_counts() -> None:
    """Zero every counter in :data:`EVAL_COUNTS` (test and bench setup)."""
    for k in EVAL_COUNTS:
        EVAL_COUNTS[k] = 0


def total_evals() -> int:
    """Total cost-model queries so far, summed across every entry point."""
    return sum(EVAL_COUNTS.values())


@dataclasses.dataclass(frozen=True)
class H100Spec:
    """One NVIDIA H100 SXM (data sheet), as the port's kernels use it."""
    compute_unit: str = "fp32 FMA on the CUDA cores"
    peak_flops: float = 67e12         # of compute_unit, FLOP/s
    tc_peak_flops: float = 989e12     # bf16 tensor cores, dense, FLOP/s
    smem_read_bytes: int = 128        # shared memory an SM reads a clock
    regs_per_sm: int = 65536
    hbm_bw: float = 3.35e12           # bytes/s
    sms: int = 132
    smem_bytes: int = geo.SMEM_BYTES  # shared memory a block can use
    max_threads: int = geo.MAX_THREADS
    lane_pad: int = geo.WARP          # threads run in warps of 32 lanes
    launch_s: float = 3e-6            # one kernel launch, host to device
    l2_bw: float = 5.5e12             # L2 to shared memory, bytes/s (an
    #                                   estimate, not measured here)
    fma_issue: int = 4                # warp FMAs an SM issues a clock
    lds_issue: int = 1                # shared-memory wavefronts a clock
    stage_instr: int = 8              # instructions to stage one element
    step_latency_s: float = 1e-6      # loads + two barriers of one step
    threads_per_sm: int = 2048
    blocks_per_sm: int = 32
    smem_per_sm: int = 233472
    # links between cards, data-sheet values, not measured (the card
    # machine has one H100): NVLink 4 is 18 links of 25 GB/s a direction
    # each, 450 GB/s a direction a card, among the 8 cards of one HGX
    # H100 node; a mesh past one node crosses one 400 Gb/s NDR
    # InfiniBand NIC a card, 50 GB/s a direction
    nvlink_bw: float = 450e9          # bytes/s a direction, a card
    nvlink_domain: int = 8            # cards one NVLink domain joins
    net_bw: float = 50e9              # bytes/s a direction, a card
    # the bf16 conv and matmul bodies' constants; None: the module's
    # fitted ones
    conv_body: Optional[ConvBodyConsts] = None
    mm_body: Optional["MatmulBodyConsts"] = None


@dataclasses.dataclass(frozen=True)
class MatmulBodyConsts:
    """The persistent bf16 matmul body's seven constants as one value, as
    ``ConvBodyConsts`` for the conv: a spec whose ``mm_body`` is None
    times the body with the module's constants (:meth:`fitted`)."""
    mma_eff: float
    chunk_s: float
    sm_in_bw: float
    ring_latency_s: float
    tile_s: float
    part_s: float
    fill_latency_s: float

    @classmethod
    def fitted(cls) -> "MatmulBodyConsts":
        """The module's constants."""
        return cls(MM_MMA_EFF, MM_CHUNK_S, MM_SM_IN_BW, MM_RING_LATENCY_S,
                   MM_TILE_S, MM_PART_S, MM_FILL_LATENCY_S)


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Roofline terms for one schedule candidate."""

    flops: float          # useful work of the call
    hbm_bytes: float      # the JAX model's block-fetch bytes
    dram_bytes: float     # each input read once, the output written once
    staged_bytes: float   # L2 -> shared memory (and RMW output) traffic
    smem_peak: float      # shared memory a block needs, bytes
    grid_steps: int
    launches: int
    compute_s: float
    memory_s: float
    overhead_s: float

    @property
    def time_s(self) -> float:
        """Predicted time: max(compute, memory) + launch overheads."""
        return max(self.compute_s, self.memory_s) + self.overhead_s


@dataclasses.dataclass
class BatchKernelCost:
    """Roofline terms for a whole schedule enumeration at once: float64
    arrays of one shape (grid-order axis first; [n_orders, n_blocks] for
    conv, [n_orders, n_blocks, 2] for matmul with the trailing axis =
    resident_rhs False/True, [n_blocks] for sparse conv)."""
    flops: np.ndarray
    hbm_bytes: np.ndarray
    dram_bytes: np.ndarray
    staged_bytes: np.ndarray
    smem_peak: np.ndarray
    grid_steps: np.ndarray
    launches: np.ndarray
    compute_s: np.ndarray
    memory_s: np.ndarray
    overhead_s: np.ndarray

    @property
    def time_s(self) -> np.ndarray:
        """Predicted time per candidate (same formula as the scalar)."""
        return np.maximum(self.compute_s, self.memory_s) + self.overhead_s

    @property
    def feasible(self) -> np.ndarray:
        """True where the kernel accepts the candidate."""
        return self.overhead_s < INFEASIBLE_S

    def cost(self, idx) -> KernelCost:
        """Scalar :class:`KernelCost` for one candidate (tuple index)."""
        return KernelCost(
            flops=float(self.flops[idx]),
            hbm_bytes=float(self.hbm_bytes[idx]),
            dram_bytes=float(self.dram_bytes[idx]),
            staged_bytes=float(self.staged_bytes[idx]),
            smem_peak=float(self.smem_peak[idx]),
            grid_steps=int(self.grid_steps[idx]),
            launches=int(self.launches[idx]),
            compute_s=float(self.compute_s[idx]),
            memory_s=float(self.memory_s[idx]),
            overhead_s=float(self.overhead_s[idx]))


def _round_up(a, m):
    """Round ``a`` up to the next multiple of ``m``."""
    return -(-a // m) * m


def _batch_refetch(orders: Sequence[Sequence[str]], dep: frozenset,
                   trips: Dict[str, np.ndarray]) -> np.ndarray:
    """``refetch[o]`` per block candidate for each grid order: the product
    of trips over non-dependent axes that have a dependent axis deeper in
    the order (outermost to innermost; the JAX package's walk)."""
    nblk = next(iter(trips.values())).shape[0]
    out = np.empty((len(orders), nblk))
    for o, order in enumerate(orders):
        refetch = np.ones(nblk)
        for i, a in enumerate(order):
            if a in dep:
                continue
            if any(b in dep for b in list(order)[i + 1:]):
                refetch = refetch * trips[a]
        out[o] = refetch
    return out


def _fetches(orders, dep, trips, n_b) -> np.ndarray:
    """Block fetches of one operand over the [orders, blocks] grid."""
    distinct = np.ones(n_b, dtype=np.int64)
    for a in sorted(dep):
        distinct = distinct * trips[a]
    return distinct * _batch_refetch(orders, dep, trips)


def _scratch_orders(orders, reduction: str, out_axes) -> np.ndarray:
    """[O] bool: the order sums in one launch (no output axis inside the
    reduction axis), else one read-modify-write launch per block."""
    return np.array([not [a for a in list(o)[list(o).index(reduction) + 1:]
                          if a in out_axes] for o in orders])


def _occupancy(threads, smem, spec: H100Spec) -> np.ndarray:
    """Blocks resident on an SM (threads, shared memory, block limit)."""
    warps_threads = _round_up(threads, spec.lane_pad)
    return np.maximum(1, np.minimum.reduce([
        np.full_like(threads, spec.blocks_per_sm),
        spec.threads_per_sm // np.maximum(warps_threads, 1),
        spec.smem_per_sm // np.maximum(smem, 1)]))


def _step_seconds(cycles, staged_elems, threads, smem, spec: H100Spec):
    """Time one SM spends on one grid step of one block: issue cycles
    (compute + staging), or the step's latency shared by the blocks
    resident on the SM, whichever is longer."""
    stage = staged_elems * spec.stage_instr / (spec.fma_issue * spec.lane_pad)
    # peak_flops = SMs x fma_issue warps x 32 lanes x 2 FLOP x clock
    clock_hz = spec.peak_flops / (spec.sms * spec.fma_issue
                                  * spec.lane_pad * 2)
    busy = (cycles + stage) / clock_hz
    return np.maximum(busy, spec.step_latency_s
                      / _occupancy(threads, smem, spec))


def _conv_terms(layer: ConvLayer, by, bx, boc, bic, elem_bytes: int,
                spec: H100Spec):
    """Per block: (SM seconds of one tile step, smem bytes, feasible)
    under the conv kernel's thread layout."""
    tiles = [geo.conv_tile(int(o), int(i), int(y), int(x), layer.kh,
                           layer.kw, elem_bytes)
             for o, i, y, x in zip(boc, bic, by, bx)]
    threads = np.array([t.threads for t in tiles], dtype=np.int64)
    per = np.array([t.per_thread for t in tiles], dtype=np.int64)
    groups = np.array([t.groups for t in tiles], dtype=np.int64)
    smem = np.array([t.smem for t in tiles], dtype=np.int64)
    ok = (threads <= spec.max_threads) & (smem <= spec.smem_bytes)
    # a tap: one image wavefront plus the J weights (16-byte vectors
    # where J fills them, else one load each), against J FMAs
    vec = (per * elem_bytes) % 16 == 0
    w_loads = np.where(vec, per * elem_bytes // 16, per)
    tap = np.maximum(per / spec.fma_issue, (1 + w_loads) / spec.lds_issue)
    warps = -(-threads // spec.lane_pad)
    taps = layer.kh * layer.kw
    cycles = warps * bic * taps * tap
    staged = (groups * per * bic * taps
              + bic * (by + layer.kh - 1) * (bx + layer.kw - 1))
    return _step_seconds(cycles, staged, threads, smem, spec), smem, ok


def _clock_hz(spec: H100Spec) -> float:
    """SM clock implied by the CUDA-core peak: SMs x fma_issue warps x 32
    lanes x 2 FLOP a clock."""
    return spec.peak_flops / (spec.sms * spec.fma_issue * spec.lane_pad * 2)


def _wave_seconds(tiles, occ, thr_s, lat_s, spec: H100Spec):
    """Time of a launch of ``tiles`` blocks, ``occ`` resident on an SM:
    full waves of SMs x occ blocks, then a tail wave; blocks resident
    together share the SM's throughput and overlap their latency; fewer
    tiles than SMs leave SMs idle."""
    slots = spec.sms * occ
    full = np.floor(tiles / slots)
    tail = tiles - full * slots
    per_full = np.maximum(occ * thr_s, lat_s)
    per_tail = np.where(tail > 0, np.maximum(np.ceil(tail / spec.sms)
                                             * thr_s, lat_s), 0.0)
    return full * per_full + per_tail


def _resident_blocks(threads, smem, regs, spec: H100Spec) -> np.ndarray:
    """Blocks resident on an SM (threads, shared memory, registers)."""
    return np.maximum(1, np.minimum.reduce([
        np.full_like(threads, spec.blocks_per_sm),
        spec.threads_per_sm // threads,
        spec.smem_per_sm // np.maximum(smem, 1),
        spec.regs_per_sm // (threads * regs)]))


def _conv_mma_launch_s(layer: ConvLayer, boc: int, bic: int, by: int,
                       bx: int, batch: int, order: Tuple[str, ...],
                       n_fixed: int, extra: int, nb: float, rmw: bool,
                       spec: H100Spec, one_block: bool = False
                       ) -> Tuple[float, int, bool]:
    """(seconds, smem bytes, feasible) of one launch of the bf16 implicit
    GEMM (``_geometry.conv_mma_tile``) whose tiles sum ``nb`` channel
    blocks (the block-sparse body's expected nonzero count may be
    fractional), with the output axes in ``order``, under the spec's
    conv body constants; memoised together with them.  ``one_block``:
    the seconds of one block of the launch instead (on an SM shared as
    the launch's first wave shares it)."""
    return _conv_mma_launch_cached(
        layer, boc, bic, by, bx, batch, order, n_fixed, extra, nb, rmw, spec,
        spec.conv_body or ConvBodyConsts.fitted(), one_block)


@functools.lru_cache(maxsize=1 << 16)
def _conv_mma_launch_cached(layer, boc, bic, by, bx, batch, order, n_fixed,
                            extra, nb, rmw, spec, consts: ConvBodyConsts,
                            one_block=False):
    """:func:`_conv_mma_launch_s` for one value of the constants."""
    unit_c, chunk_c, step_c = (consts.unit_cycles, consts.chunk_cycles,
                               consts.step_cycles)
    epi_c, load_s = consts.epi_cycles, consts.load_latency_s
    t = geo.conv_mma_tile(boc, bic, by, bx, layer.kh, layer.kw, oc=layer.oc,
                          ic=layer.ic, h=layer.h, w=layer.w, batch=batch,
                          order=order, n_fixed=n_fixed, extra=extra)
    if t.error is not None:
        return 0.0, t.smem, False
    clk = _clock_hz(spec)
    taps = layer.kh * layer.kw
    # one tile's channel block over all its rounds: the padded wgmmas at
    # the tensor-core peak or at the rate their shared-memory reads need
    # (each 64 x nt wgmma reads its 64-row A, 2 KB, and nt rows of B, 32
    # bytes each, a tap and 16 channels)
    flop = t.m_pad * t.boc_pad * t.bic_pad * taps * 2
    reads = (t.m_pad / 64 * t.boc_pad / t.nt * (2048 + 32 * t.nt) * taps
             * t.bic_pad / 16)
    mma_cyc = max(flop / (spec.tc_peak_flops / spec.sms / clk),
                  reads / spec.smem_read_bytes)
    # a step's staging: cp.async units issued, channels-last units
    # written, for each operand it streams
    halo_cyc = t.halo_chunks * chunk_c + t.halo_units * unit_c
    wgt_cyc = t.wgt_chunks * chunk_c + t.wgt_units * unit_c
    if t.resident:
        fixed_cyc, stream_cyc = ((halo_cyc, wgt_cyc) if t.fixed_halo
                                 else (wgt_cyc, halo_cyc))
    else:
        fixed_cyc, stream_cyc = 0.0, halo_cyc + wgt_cyc
    pre = nb if t.resident else 0.0
    # the epilogue: the 32-byte sectors its stores (and a read-modify-
    # write pass's reads) touch: a channel's tile is one run of by bx
    # values when the tile spans the output's width, else a run of bx a
    # row; a run starts anywhere in a sector
    span = bx == layer.w
    runs, run = boc * (1 if span else by), by * bx if span else bx
    epi_cyc = runs * (2 * run + 31) / 32 * epi_c * (2 if rmw else 1)
    walk = t.tiles / t.blocks        # tiles a block walks, on average
    # a tile of one channel block runs its rounds in one step (its
    # operands stream once); otherwise each round re-streams them
    inner = nb <= 1
    reps = 1 if inner else t.rounds
    steps = pre + walk * reps * nb
    # the wgmmas of a step's (last) round run while the warps write the
    # next step's operands, unless those take the single slot the wgmmas
    # read (late)
    per_round = mma_cyc / t.rounds
    step_cyc = max(per_round, stream_cyc) + step_c
    if t.late:
        step_cyc += consts.late_share * min(per_round, stream_cyc)
    if inner:
        step_cyc += mma_cyc - per_round
    # a block zeroes its padding once: 16-byte stores at the rate shared
    # memory serves an SM
    busy = (t.zero_units * 16 / spec.smem_read_bytes
            + pre * (fixed_cyc + step_c)
            + walk * (nb * reps * step_cyc + epi_cyc))
    thr_s = busy / clk
    # latency: the first stage's round trip, then each step waits for its
    # loads unless stages - 1 steps of work hid them; the sparse body's
    # index row is one more round trip before the first stage, and a
    # read-modify-write epilogue one a tile (it reads the output first)
    step_s = busy / max(steps, 1.0) / clk
    lat_s = (load_s * ((2 if extra else 1) + (walk if rmw else 0))
             + steps * max(step_s, load_s / (t.stages - 1)))
    # blocks an SM holds (threads, shared memory, 128 registers a
    # thread), and the launch's waves (:func:`_wave_seconds`, in scalars)
    occ = max(1, min(spec.blocks_per_sm, spec.threads_per_sm // t.threads,
                     spec.smem_per_sm // max(t.smem, 1),
                     spec.regs_per_sm // (t.threads * 128)))
    if nb <= 0:                  # the sparse body's zero tiles
        thr_s, lat_s = epi_cyc * walk / clk, load_s
    if one_block:
        share = min(occ, -(-t.blocks // spec.sms))
        return max(share * thr_s, lat_s), t.smem, True
    full, tail = divmod(t.blocks, spec.sms * occ)
    per_tail = max(-(-tail // spec.sms) * thr_s, lat_s) if tail else 0.0
    return full * max(occ * thr_s, lat_s) + per_tail, t.smem, True


def _conv_mma_seconds(layer: ConvLayer, by, bx, boc, bic, spec: H100Spec,
                      batch: int = 1, steps=None,
                      order: Tuple[str, ...] = ("oc", "y", "x"),
                      busiest=None):
    """Per block: (seconds of the scratch launch, seconds of all the
    read-modify-write launches, smem bytes, feasible) of the bf16
    implicit GEMM (``_geometry.conv_mma_tile``) over ``batch`` images
    with the output axes in ``order``.  ``steps`` (per block): the
    block-sparse body's expected nonzero channel blocks of an oc block;
    its layout keeps every ic block's weights resident and the index row
    (``_geometry.sparse_layout`` before the structure is known), it has
    no read-modify-write launch, and its index row is one more round
    trip.  ``busiest`` (per block, where the structure is known): the
    busiest oc block's nonzero count, which sizes the layout (the
    kernel's max_nnz) and adds its excess over the mean to the launch."""
    n = len(boc)
    scr, rmw = np.zeros(n), np.zeros(n)
    smem, ok = np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)
    order = tuple(order)
    for j in range(n):
        o, i, y, x = int(boc[j]), int(bic[j]), int(by[j]), int(bx[j])
        n_ic = -(-layer.ic // i)
        if steps is None:
            scr[j], smem[j], ok[j] = _conv_mma_launch_s(
                layer, o, i, y, x, batch, order, n_ic, 0, float(n_ic), False,
                spec)
            t1, _, ok1 = _conv_mma_launch_s(layer, o, i, y, x, batch, order,
                                            n_ic, 0, 1.0, True, spec)
            rmw[j] = n_ic * t1
            ok[j] = ok[j] and ok1
        else:
            n_fix = n_ic if busiest is None else max(1, int(busiest[j]))
            args = (layer, o, i, y, x, batch, ("oc", "y", "x"), n_fix,
                    _round_up(4 * n_fix, 16))
            scr[j], smem[j], ok[j] = _conv_mma_launch_s(
                *args, float(steps[j]), False, spec)
            if busiest is not None:
                # the busiest block's excess over a block of the mean
                # count lands on one SM (a greedy schedule's makespan is
                # at most the mean load plus one block)
                one = [_conv_mma_launch_s(*args, nb, False, spec, True)[0]
                       for nb in (float(busiest[j]), float(steps[j]))]
                scr[j] += max(0.0, one[0] - one[1])
    return scr, rmw, smem, ok


def _matmul_mma_seconds(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                        resident: bool, spec: H100Spec):
    """(seconds of the scratch launch, of all the read-modify-write
    launches, smem bytes, feasible) of the persistent bf16 wgmma body for
    one block (``_geometry.matmul_mma_tile``), less the launches
    themselves.  A ring chunk on an SM takes the
    longest of its wgmmas (at ``mma_eff`` of the peak), its operand reads
    from shared memory and the bytes its ring receives at ``sm_in_bw``
    (blocks resident together share all three) plus ``chunk_s``, or a
    stage's round trip
    over the stages the consumers do not hold, and the producer's
    register-route fills; a launch is the walk of its most loaded block
    (``_geometry.matmul_plan`` at MMA_SMS): its whole tiles, an epilogue
    each (``tile_s`` and the tile's bytes out), then its parts of split
    tiles (``part_s`` and the partial's bytes each), and the last part's
    read of every partial."""
    t = geo.matmul_mma_tile(bm, bn, bk, k, resident)
    if t.error is not None:
        return 0.0, 0.0, float(t.smem), False
    c = spec.mm_body or MatmulBodyConsts.fitted()
    clk = _clock_hz(spec)
    wg = t.bm_pad // 64
    a_tma, b_tma = geo.matmul_mma_route(k, n)
    per_sm = geo.matmul_blocks_per_sm(t)
    flop = t.bm_pad * t.bn_pad * t.ks * 2
    smem_rd = (t.ks // 16) * wg * (64 * 16 * 2 + 16 * t.bn_pad * 2)
    a_el, b_el = t.bm_pad * t.ks, 0 if resident else t.bn_pad * t.ks
    regs_el = (0 if a_tma else a_el) + (0 if b_tma else b_el)
    thr = per_sm * max(flop / (spec.tc_peak_flops / spec.sms) / c.mma_eff,
                       smem_rd / spec.smem_read_bytes / clk,
                       2 * (a_el + b_el) / c.sm_in_bw) + c.chunk_s
    # a register fill is the producer's own sequence of round trips (128
    # threads, 8 loads in flight each), which no other stage hides
    fill = regs_el / 16 / clk + -(-regs_el // (128 * 8)) * c.fill_latency_s
    chunk_s = max(thr, c.ring_latency_s / max(1, t.stages - 2), fill)
    tile_bytes = bm * bn * 2
    partial_s = per_sm * t.bm_pad * t.bn_pad * 4 / c.sm_in_bw
    panel_s = 0.0
    if resident:
        panel_el = t.bn_pad * -(-k // 64) * 64
        panel_s = (c.ring_latency_s + 2 * panel_el / c.sm_in_bw if b_tma
                   else -(-panel_el // (128 * 8)) * c.fill_latency_s
                   + panel_el / 16 / clk)

    def launch(count: int, accumulate: bool) -> float:
        p = geo.matmul_plan(m, n, k, bm, bn, bk, k_count=count,
                            resident_rhs=resident)
        if p.error is not None:
            return INFEASIBLE_S
        epi = c.tile_s + per_sm * tile_bytes * (2 if accumulate else 1) \
            / c.sm_in_bw
        whole = -(-p.full_tiles // p.grid)
        s = c.ring_latency_s + whole * (p.chunks * chunk_s + epi)
        if p.splits > 1:
            parts = -(-(p.tail_tiles * p.splits) // p.grid)
            part_chunks = -(-p.chunks // p.splits)
            s += (parts * (part_chunks * chunk_s + c.part_s + partial_s)
                  + p.splits * partial_s + epi)
        if resident:      # a column's panel once, as the walk meets it
            s += (-(-whole // (m // bm)) + 1) * panel_s
        return s

    return (launch(k, False), (k // bk) * launch(bk, True), float(t.smem),
            True)


def _conv_batch(layer: ConvLayer, orders, blocks, spec: H100Spec,
                elem_bytes: int, batch: int = 1) -> BatchKernelCost:
    """The conv scorer (uncounted; see the public entry points).  Time,
    device and staged bytes are those of ``batch`` images; hbm_bytes and
    grid_steps stay the JAX model's per-image counts."""
    n_o, n_b = len(orders), len(blocks)
    for order in orders:
        if sorted(order) != ["ic", "oc", "x", "y"]:
            raise ValueError(f"bad grid order {list(order)}")
    boc = np.array([b["oc"] for b in blocks], dtype=np.int64)
    bic = np.array([b["ic"] for b in blocks], dtype=np.int64)
    by = np.array([b["y"] for b in blocks], dtype=np.int64)
    bx = np.array([b["x"] for b in blocks], dtype=np.int64)
    trips = {"oc": -(-layer.oc // boc), "ic": -(-layer.ic // bic),
             "y": -(-layer.h // by), "x": -(-layer.w // bx)}
    grid_steps = trips["oc"] * trips["ic"] * trips["y"] * trips["x"]

    out_blk = boc * by * bx
    wgt_blk = boc * bic * layer.kh * layer.kw
    img_blk = bic * (by + layer.kh - 1) * (bx + layer.kw - 1)
    dep = {"out": frozenset({"oc", "y", "x"}),
           "wgt": frozenset({"oc", "ic"}),
           "img": frozenset({"ic", "y", "x"})}
    hbm = _fetches(orders, dep["wgt"], trips, n_b) * wgt_blk * elem_bytes
    hbm = hbm + _fetches(orders, dep["img"], trips, n_b) * img_blk \
        * elem_bytes
    out_distinct = trips["oc"] * trips["y"] * trips["x"]
    out_visits = _fetches(orders, dep["out"], trips, n_b)
    hbm = hbm + np.where(out_visits <= out_distinct,
                         (out_distinct * out_blk * elem_bytes
                          ).astype(np.float64),
                         (2 * out_visits - out_distinct)
                         * out_blk * elem_bytes)

    scratch = _scratch_orders(orders, "ic", ("oc", "y", "x"))
    if geo.tensor_cores(elem_bytes):
        # the body's layout follows the output axes' order (which operand
        # a block's walk shares)
        compute_s = np.zeros((n_o, n_b))
        by_out = {}
        for o, order in enumerate(orders):
            out = tuple(a for a in order if a != "ic")
            if out not in by_out:
                by_out[out] = _conv_mma_seconds(layer, by, bx, boc, bic,
                                                spec, batch, order=out)
            t_scr, t_rmw, smem, ok = by_out[out]
            compute_s[o] = t_scr if scratch[o] else t_rmw
        ok = np.logical_and.reduce([v[3] for v in by_out.values()])
    else:                     # the CUDA-core tile kernel
        step_s, smem, ok = _conv_terms(layer, by, bx, boc, bic, elem_bytes,
                                       spec)
        util = np.minimum(1.0, batch * out_distinct / spec.sms)
        compute_s = step_s * batch * grid_steps / (spec.sms * util)
    # staged per grid step: the weight and image tiles, plus the output
    # tile read and written by every read-modify-write pass
    staged = grid_steps * (wgt_blk + img_blk) * elem_bytes \
        + np.where(scratch[:, None], 0, 2 * grid_steps * out_blk
                   * elem_bytes)                               # [O, B]
    arrays = layer.array_bytes()
    dram = (batch * (arrays["img"] + arrays["out"]) + arrays["wgt"]) \
        / layer.elem_bytes * elem_bytes
    staged = staged * batch
    memory_s = np.maximum(dram / spec.hbm_bw, staged / spec.l2_bw)
    launches = np.where(scratch[:, None], 1, trips["ic"][None, :])
    overhead_s = (spec.launch_s * launches
                  + np.where(ok, 0.0, INFEASIBLE_S)[None, :])
    shape = (n_o, n_b)
    bc = lambda a: np.broadcast_to(a, shape)  # noqa: E731
    return BatchKernelCost(
        flops=bc(np.float64(2.0 * layer.macs)), hbm_bytes=hbm,
        dram_bytes=bc(np.float64(dram)), staged_bytes=staged * 1.0,
        smem_peak=bc(smem.astype(np.float64)), grid_steps=bc(grid_steps),
        launches=launches, compute_s=bc(compute_s) * 1.0,
        memory_s=memory_s, overhead_s=overhead_s)


def conv_schedule_cost_batch(layer: ConvLayer,
                             orders: Sequence[Sequence[str]],
                             blocks: Sequence[Dict[str, int]],
                             spec: H100Spec = H100Spec(),
                             elem_bytes: int = 2,
                             batch: int = 1) -> BatchKernelCost:
    """Score the full ``orders`` x ``blocks`` conv-schedule grid at once
    ([n_orders, n_blocks] arrays) for ``batch`` images (the tuner ranks
    for the caller's batch, which the registry key holds); one
    evaluation counted per candidate."""
    EVAL_COUNTS["conv_schedule_cost_batch"] += len(orders) * len(blocks)
    return _conv_batch(layer, orders, blocks, spec, elem_bytes, batch)


def conv_schedule_cost(layer: ConvLayer, grid_order: Sequence[str],
                       block: Dict[str, int], spec: H100Spec = H100Spec(),
                       elem_bytes: int = 2, batch: int = 1) -> KernelCost:
    """Cost of one (grid order, block) conv schedule for ``batch`` images
    (the scalar form the dense-vs-sparse policy calls)."""
    EVAL_COUNTS["conv_schedule_cost"] += 1
    return _conv_batch(layer, [tuple(grid_order)], [block], spec,
                       elem_bytes, batch).cost((0, 0))


def matmul_schedule_cost_batch(m: int, n: int, k: int,
                               blocks: Sequence[Tuple[int, int, int]],
                               orders: Sequence[Sequence[str]] = None,
                               spec: H100Spec = H100Spec(),
                               elem_bytes: int = 2) -> BatchKernelCost:
    """Score matmul schedules for every (order, block, resident_rhs) at
    once: [n_orders, n_blocks, 2] arrays, trailing axis resident_rhs
    False/True."""
    if orders is None:
        orders = list(itertools.permutations(("m", "n", "k")))
    for order in orders:
        if sorted(order) != ["k", "m", "n"]:
            raise ValueError(f"bad grid order {list(order)}")
    n_o, n_b = len(orders), len(blocks)
    EVAL_COUNTS["matmul_schedule_cost_batch"] += n_o * n_b * 2
    bm = np.array([b[0] for b in blocks], dtype=np.int64)
    bn = np.array([b[1] for b in blocks], dtype=np.int64)
    bk = np.array([b[2] for b in blocks], dtype=np.int64)
    trips = {"m": -(-m // bm), "n": -(-n // bn), "k": -(-k // bk)}
    grid_steps = trips["m"] * trips["n"] * trips["k"]
    dep = {"A": frozenset({"m", "k"}), "B": frozenset({"k", "n"}),
           "C": frozenset({"m", "n"})}
    blk = {"A": bm * bk, "B": bk * bn, "C": bm * bn}

    hbm_a = _fetches(orders, dep["A"], trips, n_b) * blk["A"] * elem_bytes
    c_distinct = trips["m"] * trips["n"]
    c_visits = _fetches(orders, dep["C"], trips, n_b)
    hbm_c = np.where(c_visits <= c_distinct,
                     (c_distinct * blk["C"] * elem_bytes).astype(np.float64),
                     (2 * c_visits - c_distinct) * blk["C"] * elem_bytes)
    hbm = np.stack([hbm_a + _fetches(orders, dep["B"], trips, n_b)
                    * blk["B"] * elem_bytes + hbm_c,
                    hbm_a + np.float64(n * k * elem_bytes) + hbm_c],
                   axis=-1)

    scratch = _scratch_orders(orders, "k", ("m", "n"))
    smem = np.zeros((n_b, 2))
    ok = np.zeros((n_b, 2), dtype=bool)
    mma = geo.tensor_cores(elem_bytes)
    if mma:                   # the wgmma body: [O, B, 2]
        t_scr = np.zeros((n_b, 2))
        t_rmw = np.zeros((n_b, 2))
        for i in range(n_b):
            for r in (0, 1):
                t_scr[i, r], t_rmw[i, r], smem[i, r], ok[i, r] = \
                    _matmul_mma_seconds(m, n, k, int(bm[i]), int(bn[i]),
                                        int(bk[i]), bool(r), spec)
        # a resident RHS sums every k block in one launch
        compute_s = np.stack(
            [np.where(scratch[:, None], t_scr[None, :, 0],
                      t_rmw[None, :, 0]),
             np.broadcast_to(t_scr[None, :, 1], (n_o, n_b))], axis=-1)
    else:                     # the CUDA-core body
        step_s = np.zeros((n_b, 2))
        for i in range(n_b):
            for r in (0, 1):
                t = geo.matmul_tile(int(bm[i]), int(bn[i]), int(bk[i]), k,
                                    elem_bytes, bool(r))
                smem[i, r] = t.smem
                ok[i, r] = t.error is None and t.smem <= spec.smem_bytes
                mi = t.mi or geo.MM_MICRO[-1]
                mj = t.mj or geo.MM_MICRO[-1]
                # a k step: MI x MJ FMAs against MI + MJ shared-memory
                # loads
                kstep = max(mi * mj / spec.fma_issue,
                            (mi + mj) / spec.lds_issue)
                cycles = -(-t.threads // spec.lane_pad) * int(bk[i]) * kstep
                # staged a step: the A chunk, and the B chunk (the
                # resident panel once per tile, spread over its k steps)
                staged = int(bk[i]) * 16 * (mi + mj) if not r else \
                    int(bk[i]) * 16 * mi + k * 16 * mj / (k // int(bk[i]))
                step_s[i, r] = _step_seconds(np.array([cycles]),
                                             np.array([staged]),
                                             np.array([t.threads]),
                                             np.array([t.smem]), spec)[0]
        util = np.minimum(1.0, c_distinct / spec.sms)
        compute_s = step_s * grid_steps[:, None] / (spec.sms
                                                    * util[:, None])  # [B, 2]
    # staged from L2: A and B chunks per grid step (the resident panel
    # once per output tile); RMW passes also read and write the C tile
    staged = np.stack([grid_steps * (blk["A"] + blk["B"]),
                       grid_steps * blk["A"] + c_distinct * k * bn],
                      axis=-1) * elem_bytes                  # [B, 2]
    rmw_c = np.where(scratch[:, None], 0, 2 * grid_steps * blk["C"]
                     * elem_bytes)                           # [O, B]
    staged = staged[None, :, :] + np.stack([rmw_c, np.zeros_like(rmw_c)],
                                           axis=-1)           # [O, B, 2]
    dram = np.float64((m * k + k * n + m * n) * elem_bytes)
    launches = np.stack(
        [np.where(scratch[:, None], 1, trips["k"][None, :]),
         np.ones((n_o, n_b), dtype=np.int64)], axis=-1)
    overhead_s = (spec.launch_s * launches
                  + np.where(ok, 0.0, INFEASIBLE_S)[None, :, :])
    shape = (n_o, n_b, 2)
    bc = lambda a: np.broadcast_to(a, shape)  # noqa: E731
    # the wgmma body's ring traffic from L2 is in its compute term (the
    # bytes an SM's ring receives); the CUDA-core body's at the L2 rate
    memory_s = (np.broadcast_to(dram / spec.hbm_bw, shape) if mma
                else np.maximum(dram / spec.hbm_bw, staged / spec.l2_bw))
    return BatchKernelCost(
        flops=bc(np.float64(2.0 * m * n * k)), hbm_bytes=hbm,
        dram_bytes=bc(dram), staged_bytes=staged * 1.0,
        smem_peak=bc(smem), grid_steps=bc(grid_steps[:, None]),
        launches=launches, compute_s=bc(compute_s),
        memory_s=memory_s, overhead_s=overhead_s)


def sparse_channel_waves(layer: ConvLayer,
                         blocks: Sequence[Dict[str, int]], density,
                         batch: int = 1, spec: H100Spec = H100Spec(),
                         elem_bytes: int = 4) -> np.ndarray:
    """Per skip block: the float32 sparse body's sequential work, the
    input channels of each block's expected nonzero steps times the waves
    its (image, oc block, spatial tile) blocks run in (SMs x resident
    blocks): the CUDA-core body's time tracks these, not its FLOPs
    (``density``: a scalar or one per block)."""
    by, bx = geo.sparse_tile(layer.h, layer.w)
    n_sp = -(-layer.h // by) * -(-layer.w // bx)
    dens = np.broadcast_to(np.asarray(density, dtype=np.float64),
                           (len(blocks),))
    out = np.empty(len(blocks))
    for j, blk in enumerate(blocks):
        density = dens[j]
        t = geo.conv_tile(blk["oc"], blk["ic"], by, bx, layer.kh, layer.kw,
                          elem_bytes)
        occ = _resident_blocks(np.array([t.threads]), np.array([t.smem]),
                               SPARSE_REGS, spec)[0]
        nnz = max(np.ceil(density * -(-layer.ic // blk["ic"])), 1.0)
        tiles = batch * -(-layer.oc // blk["oc"]) * n_sp
        out[j] = nnz * blk["ic"] * np.ceil(tiles / (spec.sms * occ))
    return out


def _sparse_mma_terms(layer: ConvLayer, blocks, density,
                      batch: int, spec: H100Spec, busiest=None):
    """Per skip block of the bf16 sparse body: (seconds, smem bytes,
    feasible, by, bx) -- the dense implicit GEMM's scratch launch at the
    skip block's pixel tile over density x ic blocks a tile (``density``
    a scalar or one per block; ``busiest``: :func:`_conv_mma_seconds`)."""
    from repro_torch.core.sparsity import sparse_pixel_tile
    n_b = len(blocks)
    boc = np.array([b["oc"] for b in blocks], dtype=np.int64)
    bic = np.array([b["ic"] for b in blocks], dtype=np.int64)
    by = np.ones(n_b, dtype=np.int64)
    bx = np.ones(n_b, dtype=np.int64)
    ok = np.zeros(n_b, dtype=bool)
    for j, blk in enumerate(blocks):
        pix = sparse_pixel_tile(layer, blk["oc"], blk["ic"], batch, spec)
        if pix is not None:
            (by[j], bx[j]), ok[j] = pix, True
    n_ic = -(-layer.ic // bic)
    t_scr, _, smem, ok_mma = _conv_mma_seconds(
        layer, by, bx, boc, bic, spec, batch, steps=density * n_ic,
        busiest=busiest)
    return t_scr, smem, ok & ok_mma, by, bx


def sparse_conv_schedule_cost_batch(
        layer: ConvLayer, blocks: Sequence[Dict[str, int]],
        density=1.0, batch: int = 1,
        spec: H100Spec = H100Spec(),
        elem_bytes: int = 2, busiest=None) -> BatchKernelCost:
    """Score (oc, ic) skip blocks for the block-sparse conv kernel at a
    block ``density`` for ``batch`` images ([n_blocks] arrays).  Steps
    and bytes are the JAX package's counts (expected nonzero steps scale
    with density; the image slab is counted per step); compute follows
    the dtype's body: bf16 the dense implicit GEMM over the expected
    nonzero blocks at the dense model's pixel tile; float32 the issue-rate
    model at the spatial tile, or the blocks' sequential work
    (``sparse_channel_waves`` x ``SPARSE_CHANNEL_S``), whichever is
    longer.  A call costs ``SPARSE_CALL_S`` more than its launch.
    Where the weights are known, ``density`` may give each block its own
    block density and ``busiest`` each block's busiest oc block's
    nonzero count (bf16: its excess over the mean count lands on one
    SM)."""
    EVAL_COUNTS["sparse_conv_schedule_cost_batch"] += len(blocks)
    density = np.asarray(density, dtype=np.float64)
    boc = np.array([blk["oc"] for blk in blocks], dtype=np.int64)
    bic = np.array([blk["ic"] for blk in blocks], dtype=np.int64)
    n_oc = -(-layer.oc // boc)
    n_ic = -(-layer.ic // bic)
    nnz = np.maximum(np.ceil(density * n_ic), 1.0)    # steps per oc block
    steps = batch * n_oc * nnz

    h2, w2 = layer.h + layer.kh - 1, layer.w + layer.kw - 1
    hbm = (steps * bic * h2 * w2 * elem_bytes
           + steps * boc * bic * layer.kh * layer.kw * elem_bytes
           + batch * layer.oc * layer.h * layer.w * elem_bytes)
    if geo.tensor_cores(elem_bytes):
        compute_s, smem, ok, by, bx = _sparse_mma_terms(
            layer, blocks, density, batch, spec, busiest)
        n_sp = -(-layer.h // by) * -(-layer.w // bx)
    else:
        by, bx = geo.sparse_tile(layer.h, layer.w)
        n_sp = -(-layer.h // by) * -(-layer.w // bx)
        step_s, smem, ok = _conv_terms(layer, np.full(len(blocks), by),
                                       np.full(len(blocks), bx), boc, bic,
                                       elem_bytes, spec)
        util = np.minimum(1.0, batch * n_oc * n_sp / spec.sms)
        compute_s = np.maximum(
            steps * n_sp * step_s / (spec.sms * util),
            SPARSE_CHANNEL_S * sparse_channel_waves(layer, blocks, density,
                                                    batch, spec, elem_bytes))
    staged = steps * n_sp * (boc * bic * layer.kh * layer.kw + bic
                             * (by + layer.kh - 1) * (bx + layer.kw - 1)) \
        * elem_bytes
    taps = layer.kh * layer.kw
    dram = (batch * layer.ic * h2 * w2 + n_oc * nnz * boc * bic * taps
            + batch * layer.oc * layer.h * layer.w) * elem_bytes
    overhead_s = spec.launch_s + SPARSE_CALL_S + np.where(ok, 0.0,
                                                          INFEASIBLE_S)
    return BatchKernelCost(
        flops=np.full(len(blocks), 2.0 * batch * layer.macs * density),
        hbm_bytes=hbm, dram_bytes=dram * 1.0, staged_bytes=staged * 1.0,
        smem_peak=smem.astype(np.float64), grid_steps=steps,
        launches=np.ones(len(blocks), dtype=np.int64), compute_s=compute_s,
        memory_s=np.maximum(dram / spec.hbm_bw, staged / spec.l2_bw),
        overhead_s=overhead_s)


def _serving_cost(n: int, compute_s, dram, smem, ok,
                  spec: H100Spec) -> BatchKernelCost:
    """A serving kernel's [n] candidates: one launch each, compute from
    its latency model, memory its compulsory bytes, infeasible ones
    last."""
    zeros = np.zeros(n)
    dram = np.broadcast_to(np.float64(dram), (n,)) * 1.0
    return BatchKernelCost(
        flops=zeros, hbm_bytes=dram, dram_bytes=dram, staged_bytes=zeros,
        smem_peak=np.asarray(smem, dtype=np.float64),
        grid_steps=np.zeros(n, dtype=np.int64),
        launches=np.ones(n, dtype=np.int64),
        compute_s=np.asarray(compute_s, dtype=np.float64),
        memory_s=dram / spec.hbm_bw,
        overhead_s=spec.launch_s + np.where(ok, 0.0, INFEASIBLE_S))


def flash_attention_features(b: int, hq: int, hkv: int, s: int, d: int,
                             blocks: Sequence[Tuple[int, int]],
                             causal: bool = True,
                             spec: H100Spec = H100Spec(),
                             elem_bytes: int = 2):
    """Per (block_q, block_kv): (features [n, 6], smem, feasible), the
    features multiplying (FLASH_BLOCK_S, FLASH_TILE_S, FLASH_WORK_EFF,
    FLASH_WGMMA_WORK_EFF, FLASH_WGMMA_BLOCK_S, FLASH_WGMMA_TILE_S).  The
    body is ``_geometry.flash_body``'s, the one the wrapper runs at this
    dtype and head dim, windowed or not.  The mma.sync and CUDA-core
    bodies have the first three: waves of blocks (blocks over SMs x
    resident blocks, at least 1); waves x the most key tiles a block
    reaches; the tiles' work at peak rates (MMAs or FMAs, exps, L2
    staging) spread over the SMs in use.  A wgmma tile has the last
    three: its tiles' work, its MMAs at ``FLASH_WGMMA_MMA_SHARE`` of the
    mma.sync body's time, or, where its registers spill, at the mma.sync
    rate and in series with the softmax and the staging; its waves (at
    ``FlashWgmmaTile.blocks_per_sm``) and waves x the most key tiles a
    block reaches, which hold the engine's short prefills."""
    mma = geo.tensor_cores(elem_bytes)
    clock = _clock_hz(spec)
    feats = np.zeros((len(blocks), 6))
    smem = np.zeros(len(blocks))
    ok = np.zeros(len(blocks), dtype=bool)
    for j, (bq, bkv) in enumerate(blocks):
        ok[j] = geo.flash_tile_error(d, elem_bytes, bq, bkv) is None
        n_qt = -(-s // bq)
        reach = np.minimum(s, (np.arange(n_qt) + 1) * bq) if causal \
            else np.full(n_qt, s)
        tiles = -(-reach // bkv)                       # per query tile
        exp_s = bq * bkv / (SFU_PER_CLOCK * clock)
        stage_s = 2.0 * bkv * d * elem_bytes / (spec.l2_bw / spec.sms)
        n_blocks = b * hq * n_qt
        if geo.flash_body(d, elem_bytes) == "wgmma":
            t = geo.flash_wgmma_tile(d, bq)
            ok[j] = ok[j] and t.error is None
            smem[j] = t.smem
            # Q K^T and P V with p split in two: 6 rows x keys x d
            mma_s = 6.0 * bq * bkv * d / (spec.tc_peak_flops / spec.sms)
            work = (mma_s + exp_s + stage_s if t.spills else
                    max(mma_s * FLASH_WGMMA_MMA_SHARE + exp_s, stage_s))
            waves = max(1.0, n_blocks / (spec.sms * t.blocks_per_sm))
            feats[j, 3:] = (b * hq * tiles.sum() * work
                            / min(spec.sms, n_blocks), waves,
                            waves * tiles.max())
            continue
        if mma:
            t = geo.flash_mma_tile(d, bq)
            threads, smem[j], dp = t.threads, t.smem, t.dp
            # Q K^T and P V with p split in two: 6 rows x keys x dp
            mma_s = 6.0 * bq * bkv * dp / (spec.tc_peak_flops / spec.sms)
        else:
            threads, dp = 256, _round_up(d, 4)
            smem[j] = 2 * bkv * dp * 4
            mma_s = 4.0 * bq * bkv * dp / (spec.peak_flops / spec.sms)
        work = np.maximum(mma_s + exp_s, stage_s)      # a tile of a block
        occ = _occupancy(np.array([threads]), np.array([smem[j]]),
                         spec)[0]
        waves = max(1.0, n_blocks / (spec.sms * occ))
        feats[j, :3] = (waves, waves * tiles.max(),
                        b * hq * tiles.sum() * work
                        / min(spec.sms, n_blocks))
    return feats, smem, ok


def flash_attention_schedule_cost_batch(
        b: int, hq: int, hkv: int, s: int, d: int,
        blocks: Sequence[Tuple[int, int]], causal: bool = True,
        spec: H100Spec = H100Spec(), elem_bytes: int = 2
        ) -> BatchKernelCost:
    """Score (block_q, block_kv) tiles of the flash body of the dtype
    ([n_blocks] arrays; see :func:`flash_attention_features`)."""
    EVAL_COUNTS["flash_attention_schedule_cost_batch"] += len(blocks)
    feats, smem, ok = flash_attention_features(b, hq, hkv, s, d, blocks,
                                               causal, spec, elem_bytes)
    compute_s = feats @ np.array([FLASH_BLOCK_S, FLASH_TILE_S,
                                  FLASH_WORK_EFF, FLASH_WGMMA_WORK_EFF,
                                  FLASH_WGMMA_BLOCK_S, FLASH_WGMMA_TILE_S])
    dram = (2 * b * hq + 2 * b * hkv) * s * d * elem_bytes
    return _serving_cost(len(blocks), compute_s, dram, smem, ok, spec)


def decode_attention_features(b: int, hq: int, hkv: int, s: int, d: int,
                              block_kvs: Sequence[int],
                              spec: H100Spec = H100Spec(),
                              elem_bytes: int = 2, block_size: int = 0):
    """Per split (``block_kv`` keys a block; None: the plan's own):
    (features [n, 3], smem, feasible, plans), the features multiplying
    (DEC_BLOCK_S, DEC_TILE_S, DEC_MERGE_S): waves of (row, split)
    blocks; waves x the staged tiles of a split; the merge's L2 round
    trips (4 splits each) when a row has more than one split.  The plan
    names the body (``_geometry.decode_body``): a packed plan's blocks
    are (row, KV head, split), one staging of K and V a KV head, and its
    combine is a round in the cluster plus one through L2 for a row of
    more than one cluster."""
    feats = np.zeros((len(block_kvs), 3))
    smem = np.zeros(len(block_kvs))
    ok = np.zeros(len(block_kvs), dtype=bool)
    plans = []
    for j, bkv in enumerate(block_kvs):
        plan = geo.decode_plan(b, hq, hkv, d, s, block_size, elem_bytes,
                               bkv)
        plans.append(plan)
        ok[j] = plan.error is None
        smem[j] = plan.smem
        occ = _occupancy(np.array([128]), np.array([plan.smem]), spec)[0]
        waves = max(1.0, plan.blocks / (spec.sms * occ))
        tiles = -(-min(plan.split_keys, s) // plan.tile_keys)
        merges = -(-plan.splits // 4) if plan.splits > 1 else 0
        if plan.body == "packed":
            merges = 1 + (plan.grid_splits > plan.cluster)
        feats[j] = (waves, waves * tiles, merges)
    return feats, smem, ok, plans


def decode_attention_schedule_cost_batch(
        b: int, hq: int, hkv: int, s: int, d: int,
        block_kvs: Sequence[int], spec: H100Spec = H100Spec(),
        elem_bytes: int = 2) -> BatchKernelCost:
    """Score splits of the contiguous split decode over a cache of ``s``
    keys ([n] arrays; see :func:`decode_attention_features`); the bytes
    are every key's K and V (``pos`` is a device value: the model counts
    the full cache), q and the output."""
    EVAL_COUNTS["decode_attention_schedule_cost_batch"] += len(block_kvs)
    feats, smem, ok, _ = decode_attention_features(b, hq, hkv, s, d,
                                                   block_kvs, spec,
                                                   elem_bytes)
    compute_s = feats @ np.array([DEC_BLOCK_S, DEC_TILE_S, DEC_MERGE_S])
    dram = (2 * b * hkv * s * d + 2 * b * hq * d) * elem_bytes
    return _serving_cost(len(block_kvs), compute_s, dram, smem, ok, spec)


def ssm_scan_features(bt: int, seq: int, di: int, n: int,
                      block_ds: Sequence[int], spec: H100Spec = H100Spec(),
                      elem_bytes: int = 2):
    """Per ``block_d``: (features [n, 3], smem, feasible), the features
    multiplying (SCAN_BLOCK_S, SCAN_STEP_S, SCAN_EXP_S): waves of
    blocks; waves x the steps; the exps of the most loaded SM (its
    blocks' seq x block_d x N, whose SFUs they share)."""
    feats = np.zeros((len(block_ds), 3))
    smem = np.zeros(len(block_ds))
    ok = np.zeros(len(block_ds), dtype=bool)
    for j, bd in enumerate(block_ds):
        lay = geo.scan_layout(bd, n, elem_bytes)
        ok[j] = lay.error is None
        smem[j] = lay.smem
        n_blocks = bt * -(-di // bd)
        occ = _occupancy(np.array([lay.threads]), np.array([lay.smem]),
                         spec)[0]
        waves = max(1.0, n_blocks / (spec.sms * occ))
        per_sm = -(-n_blocks // spec.sms)
        feats[j] = (waves, waves * seq, per_sm * seq * bd * n)
    return feats, smem, ok


def ssm_scan_schedule_cost_batch(bt: int, seq: int, di: int, n: int,
                                 block_ds: Sequence[int],
                                 spec: H100Spec = H100Spec(),
                                 elem_bytes: int = 2) -> BatchKernelCost:
    """Score channel blocks of the selective scan ([n] arrays; see
    :func:`ssm_scan_features`); the bytes are x and y in the model dtype,
    dt, b and c in float32, and the float32 state read and written."""
    EVAL_COUNTS["ssm_scan_schedule_cost_batch"] += len(block_ds)
    feats, smem, ok = ssm_scan_features(bt, seq, di, n, block_ds, spec,
                                        elem_bytes)
    compute_s = feats @ np.array([SCAN_BLOCK_S, SCAN_STEP_S, SCAN_EXP_S])
    dram = (bt * seq * di * (2 * elem_bytes + 4) + 2 * bt * seq * n * 4
            + 2 * bt * di * n * 4)
    return _serving_cost(len(block_ds), compute_s, dram, smem, ok, spec)


__all__ = ["COST_MODEL_VERSION", "EVAL_COUNTS", "H100Spec", "KernelCost",
           "LOKI_MODEL_VERSION", "CacheLevel", "MachineModel", "HIERARCHIES",
           "CacheSimResult", "simulate", "sweep_permutations",
           "BatchSimResult", "simulate_batch", "reset_eval_counts",
           "LOAD_LATENCY_S", "MatmulBodyConsts",
           "SPARSE_CALL_S", "SPARSE_CHANNEL_S", "STEP_CYCLES", "UNIT_CYCLES",
           "CHUNK_CYCLES", "EPI_CYCLES", "ConvBodyConsts",
           "BatchKernelCost", "conv_schedule_cost",
           "conv_schedule_cost_batch", "matmul_schedule_cost_batch",
           "sparse_conv_schedule_cost_batch", "sparse_channel_waves",
           "flash_attention_schedule_cost_batch",
           "decode_attention_schedule_cost_batch",
           "ssm_scan_schedule_cost_batch", "flash_attention_features",
           "decode_attention_features", "ssm_scan_features",
           "total_evals"]
