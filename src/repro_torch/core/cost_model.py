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
    is slower, plus its staging: the conv's halo and weight units
    (``UNIT_CYCLES`` issue cycles each, ``STEP_CYCLES`` a channel block)
    and the matmul's register-route
    operands (a warp instruction per 32 elements loaded and stored, and
    one round trip per 8 loads of each producer thread, which nothing
    hides),
    TMA stages at the L2-to-SM rate.  A ring stage's round trip
    (``RING_LATENCY_S``) is hidden over the matmul's stages - 1 chunks
    in flight; a conv step's (``LOAD_LATENCY_S``) by its register
    prefetch of ``CONV_MMA_UNITS`` units a thread, while the units past
    those, and every first stage, wait for it.  Launches run in whole
    waves of SMs x resident blocks plus a tail; blocks resident together
    share an SM's throughput and overlap their latency.  The four
    constants are fitted to ``launch/calibrate_thesis.py``'s timings.
    The block-sparse conv runs the dense conv's body over the expected
    nonzero channel blocks of each oc block (block density x ic blocks),
    at the dense model's pixel tile for its skip block
    (``sparsity.sparse_pixel_tile``), after one round trip for its index
    row; a tile with none writes zeros.  A call costs ``SPARSE_CALL_S``
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
  ``FLASH_WORK_EFF``) spread over the SMs in use;
- the split decode: per wave of (row, split) blocks ``DEC_BLOCK_S`` plus
  ``DEC_TILE_S`` a staged tile of its split, plus ``DEC_MERGE_S`` an L2
  round trip of the merge (4 splits' partials each) when a row has more
  than one split;
- the selective scan: per wave ``SCAN_BLOCK_S`` plus ``SCAN_STEP_S`` a
  step of the recurrence, plus ``SCAN_EXP_S`` an exp of the most loaded
  SM (its resident blocks share its SFUs: the bound of PERF.md's row 4).

Blocks resident on an SM come from threads and shared memory, as for the
thesis bodies.  ``launch/calibrate_thesis.py --score`` fits each
family's three constants by least squares on timed candidates.

Its version string is its own (``h100-4`` adds the serving kernels;
``h100-3`` timed the thesis kernels as now, ``h100-2`` the block-sparse
conv on the CUDA cores in both dtypes, ``h100-1`` every body): no TPU
constant and no TPU-measured record is reused.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.loki import (  # noqa: F401  (the Loki model)
    EVAL_COUNTS, HIERARCHIES, LOKI_MODEL_VERSION, BatchSimResult,
    CacheLevel, CacheSimResult, MachineModel, simulate, simulate_batch,
    sweep_permutations)
from repro_torch.core.loopnest import ConvLayer
from repro_torch.kernels import _geometry as geo

# Bump whenever a change below alters predicted costs: the registry keys
# cached rankings on it, so stale predictions self-invalidate.
COST_MODEL_VERSION = "h100-4"

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
# reports the fit).  The tensor-core bodies (conv lines of two
# calibration runs, matmul lines):
UNIT_CYCLES = 6.0         # SM issue cycles to stage one conv unit (8
#                           channels: 8 gathered 2-byte loads, a 16-byte
#                           store)
STEP_CYCLES = 500.0       # a conv step's fixed cycles (its barrier, the
#                           MMA pipeline's refill)
LOAD_LATENCY_S = 1.0e-6   # round trip of a conv staging step (loads and
#                           the barrier after them); also a matmul
#                           register fill's round trip
RING_LATENCY_S = 1.5e-6   # round trip of a matmul ring stage (TMA or
#                           register fill, mbarrier, release)
# The block-sparse conv: a call's fixed time beyond its launch (both
# bodies; least squares on the bf16 tensor-core body's 120 sparse_conv
# lines)
SPARSE_CALL_S = 1.005e-5
# The float32 (CUDA-core) block-sparse body: one input channel of one
# staged step of a block (its taps run channel by channel), fitted to
# 120 lines of this body when it ran bf16 too; registers a thread (ptxas)
SPARSE_CHANNEL_S = 2.371e-6
SPARSE_REGS = 64
# The serving kernels: least squares of ``calibrate_thesis --kinds
# flash_attention decode_attention ssm_scan`` (67 lines: every offered
# candidate at 6 flash, 6 decode and 6 scan shapes, bf16) on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md).  Flash: a block's Q load and
# epilogue, a reachable key tile's round trip, and the multiple of the
# peak rates' time its tile work takes.
FLASH_BLOCK_S = 6.802e-6
FLASH_TILE_S = 1.209e-6
FLASH_WORK_EFF = 3.132
# The split decode: a block's fixed latency (q, pos and starts, the
# partial's publication), a staged tile, a merge batch of 4 splits.
DEC_BLOCK_S = 4.694e-6
DEC_TILE_S = 5.105e-6
DEC_MERGE_S = 1.611e-6
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


def _conv_mma_seconds(layer: ConvLayer, by, bx, boc, bic, spec: H100Spec,
                      batch: int = 1, steps=None):
    """Per block: (seconds of the scratch launch, seconds of all the
    read-modify-write launches, smem bytes, feasible) of the bf16
    implicit GEMM (``_geometry.conv_mma_tile``) over ``batch`` images.
    ``steps`` (per block) are the channel blocks a tile sums in the
    scratch launch when they are not the dense range's ceil(ic / bic):
    the block-sparse body's expected nonzero blocks of an oc block."""
    tiles = [geo.conv_mma_tile(int(o), int(i), int(y), int(x), layer.kh,
                               layer.kw)
             for o, i, y, x in zip(boc, bic, by, bx)]
    p16 = np.array([t.p16 for t in tiles], dtype=np.float64)
    boc16 = np.array([t.boc16 for t in tiles], dtype=np.float64)
    bic_pad = np.array([t.bic_pad for t in tiles], dtype=np.float64)
    threads = np.array([t.threads for t in tiles], dtype=np.int64)
    rounds = np.array([t.rounds for t in tiles], dtype=np.float64)
    units = np.array([t.units for t in tiles], dtype=np.float64)
    smem = np.array([t.smem for t in tiles], dtype=np.int64)
    ok = np.array([t.error is None for t in tiles])
    clk = _clock_hz(spec)
    taps = layer.kh * layer.kw
    # one channel block, every round: the padded MMAs at the tensor-core
    # peak or at the rate their ldmatrix reads need (16 FLOP a byte for
    # a 32 x 32 warp tile), and the staging units' issue cycles
    flop = p16 * boc16 * bic_pad * taps * 2
    tc_clk = spec.tc_peak_flops / spec.sms / clk
    # ldmatrix bytes: each warp tile (32 x 32) loads its 16-row A and
    # 16-channel B fragments (512 bytes each) a tap and 16 channels
    wt_m, wt_n = np.ceil(p16 / 32), np.ceil(boc16 / 32)
    frag = 512 * (p16 / 16 * wt_n + boc16 / 16 * wt_m) * taps * bic_pad / 16
    mma_cyc = np.maximum(flop / tc_clk, frag / spec.smem_read_bytes)
    # zeroing both stages once a block (16-byte stores, a warp a clock)
    zero_cyc = smem / 16 / spec.lane_pad
    thr_s = (mma_cyc + rounds * (units * UNIT_CYCLES
                                 + STEP_CYCLES)) / clk   # a channel block
    # latency a round-step: the prefetched loads, then one round trip
    # per unit a thread stages past CONV_MMA_UNITS
    rest = np.ceil(np.maximum(0.0, units - geo.CONV_MMA_UNITS * threads)
                   / threads)
    step_lat = LOAD_LATENCY_S * (1 + rest)
    first_lat = LOAD_LATENCY_S * np.ceil(units / threads)
    occ = _resident_blocks(threads, smem, 128, spec)
    out_tiles = batch * (-(-layer.oc // boc)) * (-(-layer.h // by)) \
        * (-(-layer.w // bx))
    n_ic = -(-layer.ic // bic)
    zero_s = zero_cyc / clk
    if steps is None:
        # rounds x n_ic steps; the first stage is staged before any MMA
        scratch = _wave_seconds(out_tiles, occ, n_ic * thr_s + zero_s,
                                first_lat + (rounds * n_ic - 1) * step_lat,
                                spec)
    else:
        # the block-sparse body: its index row is one round trip before
        # the first stage; a tile with no nonzero block writes zeros
        busy = steps > 0
        scratch = _wave_seconds(
            out_tiles, occ, np.where(busy, steps * thr_s + zero_s, 0.0),
            np.where(busy, LOAD_LATENCY_S + first_lat
                     + (rounds * steps - 1) * step_lat, LOAD_LATENCY_S), spec)
    # one launch a channel block, each with its own first stage, and an
    # epilogue that reads the output tile
    rmw = n_ic * _wave_seconds(out_tiles, occ, thr_s + zero_s,
                               first_lat + (rounds - 1) * step_lat
                               + LOAD_LATENCY_S, spec)
    return scratch, rmw, smem, ok


def _matmul_mma_seconds(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                        resident: bool, spec: H100Spec):
    """(seconds of the scratch launch, of all the read-modify-write
    launches, smem bytes, feasible) of the bf16 wgmma body for one
    block (``_geometry.matmul_mma_tile``)."""
    t = geo.matmul_mma_tile(bm, bn, bk, k, resident)
    if t.error is not None:
        return 0.0, 0.0, float(t.smem), False
    clk = _clock_hz(spec)
    wg = t.bm_pad // 64
    a_tma, b_tma = geo.matmul_mma_route(k, n)
    tiles = (m // bm) * (n // bn)
    # one ring chunk: the padded wgmma work against its operand reads
    # from shared memory, the producer's register-route loads and stores
    # (a warp instruction per 32 elements each), TMA bytes at the L2-to-SM
    # rate
    flop = t.bm_pad * t.bn_pad * t.ks * 2
    smem_rd = (t.ks // 16) * wg * (64 * 16 * 2 + 16 * t.bn_pad * 2)
    a_el, b_el = t.bm_pad * t.ks, 0 if resident else t.bn_pad * t.ks
    regs_el = (0 if a_tma else a_el) + (0 if b_tma else b_el)
    tma_bytes = 2 * ((a_el if a_tma else 0) + (b_el if b_tma else 0))
    l2_clk = spec.l2_bw / spec.sms / clk
    chunk_cyc = max(flop / (spec.tc_peak_flops / spec.sms / clk),
                    smem_rd / spec.smem_read_bytes,
                    regs_el / 16, tma_bytes / l2_clk)
    # the ring hides a stage's round trip over stages - 1 chunks, but a
    # register fill is the producer's own sequence of round trips (128
    # threads, 8 loads in flight each), which no other stage hides
    fill_trips = -(-regs_el // (128 * 8))
    chunk_lat = max(RING_LATENCY_S / max(1, t.stages - 1),
                    fill_trips * LOAD_LATENCY_S)
    panel_s = 0.0
    if resident:
        panel_el = t.bn_pad * -(-k // 64) * 64
        panel_s = (RING_LATENCY_S + 2 * panel_el / l2_clk / clk
                   if b_tma else -(-panel_el // (128 * 8))
                   * LOAD_LATENCY_S + panel_el / 16 / clk)
    # registers a thread, from ptxas: 60 at BN 16, 72-80 at 64, 95 at
    # 128, 157-159 at 256
    regs = 56 + 0.4 * t.bn_pad
    occ = _resident_blocks(np.array([t.threads]), np.array([t.smem]), regs,
                           spec)[0]

    def launch(count: int) -> float:
        chunks = -(-count // t.ks)
        thr = chunks * chunk_cyc / clk + panel_s
        lat = RING_LATENCY_S + chunks * chunk_lat + panel_s
        return float(_wave_seconds(tiles, occ, thr, lat, spec))

    return launch(k), (k // bk) * launch(bk), float(t.smem), True


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
        t_scr, t_rmw, smem, ok = _conv_mma_seconds(layer, by, bx, boc, bic,
                                                   spec, batch)
        compute_s = np.where(scratch[:, None], t_scr[None, :],
                             t_rmw[None, :])                    # [O, B]
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
    if geo.tensor_cores(elem_bytes):      # the wgmma body: [O, B, 2]
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
    return BatchKernelCost(
        flops=bc(np.float64(2.0 * m * n * k)), hbm_bytes=hbm,
        dram_bytes=bc(dram), staged_bytes=staged * 1.0,
        smem_peak=bc(smem), grid_steps=bc(grid_steps[:, None]),
        launches=launches, compute_s=bc(compute_s),
        memory_s=np.maximum(dram / spec.hbm_bw, staged / spec.l2_bw),
        overhead_s=overhead_s)


def sparse_channel_waves(layer: ConvLayer,
                         blocks: Sequence[Dict[str, int]], density: float,
                         batch: int = 1, spec: H100Spec = H100Spec(),
                         elem_bytes: int = 4) -> np.ndarray:
    """Per skip block: the float32 sparse body's sequential work, the
    input channels of each block's expected nonzero steps times the waves
    its (image, oc block, spatial tile) blocks run in (SMs x resident
    blocks): the CUDA-core body's time tracks these, not its FLOPs."""
    by, bx = geo.sparse_tile(layer.h, layer.w)
    n_sp = -(-layer.h // by) * -(-layer.w // bx)
    out = np.empty(len(blocks))
    for j, blk in enumerate(blocks):
        t = geo.conv_tile(blk["oc"], blk["ic"], by, bx, layer.kh, layer.kw,
                          elem_bytes)
        occ = _resident_blocks(np.array([t.threads]), np.array([t.smem]),
                               SPARSE_REGS, spec)[0]
        nnz = max(np.ceil(density * -(-layer.ic // blk["ic"])), 1.0)
        tiles = batch * -(-layer.oc // blk["oc"]) * n_sp
        out[j] = nnz * blk["ic"] * np.ceil(tiles / (spec.sms * occ))
    return out


def _sparse_mma_terms(layer: ConvLayer, blocks, density: float,
                      batch: int, spec: H100Spec):
    """Per skip block of the bf16 sparse body: (seconds, smem bytes,
    feasible, by, bx) -- the dense implicit GEMM's scratch launch at the
    skip block's pixel tile over density x ic blocks a tile."""
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
        layer, by, bx, boc, bic, spec, batch, steps=density * n_ic)
    smem = smem + _round_up(4 * n_ic, 16)       # the index row
    return t_scr, smem, ok & ok_mma, by, bx


def sparse_conv_schedule_cost_batch(
        layer: ConvLayer, blocks: Sequence[Dict[str, int]],
        density: float = 1.0, batch: int = 1,
        spec: H100Spec = H100Spec(),
        elem_bytes: int = 2) -> BatchKernelCost:
    """Score (oc, ic) skip blocks for the block-sparse conv kernel at a
    block ``density`` for ``batch`` images ([n_blocks] arrays).  Steps
    and bytes are the JAX package's counts (expected nonzero steps scale
    with density; the image slab is counted per step); compute follows
    the dtype's body: bf16 the dense implicit GEMM over the expected
    nonzero blocks at the dense model's pixel tile; float32 the issue-rate
    model at the spatial tile, or the blocks' sequential work
    (``sparse_channel_waves`` x ``SPARSE_CHANNEL_S``), whichever is
    longer.  A call costs ``SPARSE_CALL_S`` more than its launch."""
    EVAL_COUNTS["sparse_conv_schedule_cost_batch"] += len(blocks)
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
        compute_s, smem, ok, by, bx = _sparse_mma_terms(layer, blocks,
                                                        density, batch, spec)
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
    """Per (block_q, block_kv): (features [n, 3], smem, feasible), the
    features multiplying (FLASH_BLOCK_S, FLASH_TILE_S, FLASH_WORK_EFF):
    waves of blocks (blocks over SMs x resident blocks, at least 1); waves x the most key tiles a block reaches; the
    tiles' work at peak rates (MMAs or FMAs, exps, L2 staging) spread
    over the SMs in use."""
    mma = geo.tensor_cores(elem_bytes)
    clock = _clock_hz(spec)
    feats = np.zeros((len(blocks), 3))
    smem = np.zeros(len(blocks))
    ok = np.zeros(len(blocks), dtype=bool)
    for j, (bq, bkv) in enumerate(blocks):
        ok[j] = geo.flash_tile_error(d, elem_bytes, bq, bkv) is None
        n_qt = -(-s // bq)
        reach = np.minimum(s, (np.arange(n_qt) + 1) * bq) if causal \
            else np.full(n_qt, s)
        tiles = -(-reach // bkv)                       # per query tile
        if mma:
            t = geo.flash_mma_tile(d, bq)
            threads, smem[j], dp = t.threads, t.smem, t.dp
            # Q K^T and P V with p split in two: 6 rows x keys x dp
            mma_s = 6.0 * bq * bkv * dp / (spec.tc_peak_flops / spec.sms)
        else:
            threads, dp = 256, _round_up(d, 4)
            smem[j] = 2 * bkv * dp * 4
            mma_s = 4.0 * bq * bkv * dp / (spec.peak_flops / spec.sms)
        exp_s = bq * bkv / (SFU_PER_CLOCK * clock)
        stage_s = 2.0 * bkv * d * elem_bytes / (spec.l2_bw / spec.sms)
        work = np.maximum(mma_s + exp_s, stage_s)      # a tile of a block
        n_blocks = b * hq * n_qt
        occ = _occupancy(np.array([threads]), np.array([smem[j]]),
                         spec)[0]
        waves = max(1.0, n_blocks / (spec.sms * occ))
        feats[j] = (waves, waves * tiles.max(),
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
                                  FLASH_WORK_EFF])
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
    trips (4 splits each) when a row has more than one split."""
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
           "LOAD_LATENCY_S", "RING_LATENCY_S", "SPARSE_CALL_S",
           "SPARSE_CHANNEL_S", "STEP_CYCLES", "UNIT_CYCLES",
           "BatchKernelCost", "conv_schedule_cost",
           "conv_schedule_cost_batch", "matmul_schedule_cost_batch",
           "sparse_conv_schedule_cost_batch", "sparse_channel_waves",
           "flash_attention_schedule_cost_batch",
           "decode_attention_schedule_cost_batch",
           "ssm_scan_schedule_cost_batch", "flash_attention_features",
           "decode_attention_features", "ssm_scan_features",
           "total_evals"]
