"""The H100 cost model of the thesis kernels (conv, matmul, sparse conv).

It keeps the JAX package's structure (``repro.core.cost_model``, the
TPU model) and changes its machine.  What does not depend on the
machine is kept as it is: the block-fetch arithmetic
(:func:`_batch_refetch`) and the ``hbm_bytes`` and ``grid_steps`` counts
equal the JAX package's for the same (layer, order, block).  What does
is the port's own:

- :class:`H100Spec` replaces ``TPUSpec``: 3.35 TB/s, 132 SMs, 227 KB of
  shared memory a block in place of the VMEM budget, and the compute
  rate of the unit the port's kernels run on (fp32 FMA on the CUDA
  cores, 67 TFLOP/s; the 989 TFLOP/s bf16 tensor-core peak is not what
  these kernels use).
- Compute is an issue-rate model of the port's kernels
  (``kernels/_geometry.py`` gives their thread layout): an SM issues 4
  warp FMAs and 1 shared-memory wavefront a clock, so a conv tap costs a
  warp max(J / 4, 1 + the wavefronts of its J weights) cycles and a
  matmul k step max(MI MJ / 4, MI + MJ); staging costs
  ``stage_instr`` instructions an element; and each staged step waits
  ``step_latency_s`` for its loads and barriers, hidden by the other
  blocks resident on the SM.  Threads run in warps of 32 lanes.
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
  ``l2_bw``; ``hbm_bytes`` keeps the JAX count for comparison.  So the
  order changes the predicted time only through the read-modify-write
  passes, as the port's kernels behave.
- A schedule the kernel refuses (shared memory, threads, channels a
  thread) keeps the feasibility penalty of +1e3 s, so it ranks last.

Its version string is its own (``h100-1``): no TPU constant and no
TPU-measured record is reused.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.loopnest import ConvLayer
from repro_torch.kernels import _geometry as geo

# Bump whenever a change below alters predicted costs: the registry keys
# cached rankings on it, so stale predictions self-invalidate.
COST_MODEL_VERSION = "h100-1"

# Cost-model queries in this process, one per candidate scored: a warm
# registry hit performs zero (asserted in tests/test_torch_thesis.py).
EVAL_COUNTS: Dict[str, int] = {"conv_schedule_cost": 0,
                               "conv_schedule_cost_batch": 0,
                               "matmul_schedule_cost_batch": 0,
                               "sparse_conv_schedule_cost_batch": 0}

INFEASIBLE_S = 1e3


def total_evals() -> int:
    """Total cost-model queries so far, summed across every entry point."""
    return sum(EVAL_COUNTS.values())


@dataclasses.dataclass(frozen=True)
class H100Spec:
    """One NVIDIA H100 SXM (data sheet), as the port's kernels use it."""
    compute_unit: str = "fp32 FMA on the CUDA cores"
    peak_flops: float = 67e12         # of compute_unit, FLOP/s
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


def _conv_batch(layer: ConvLayer, orders, blocks, spec: H100Spec,
                elem_bytes: int) -> BatchKernelCost:
    """The conv scorer (uncounted; see the public entry points)."""
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

    step_s, smem, ok = _conv_terms(layer, by, bx, boc, bic, elem_bytes,
                                   spec)
    util = np.minimum(1.0, out_distinct / spec.sms)
    compute_s = step_s * grid_steps / (spec.sms * util)
    scratch = _scratch_orders(orders, "ic", ("oc", "y", "x"))
    # staged per grid step: the weight and image tiles, plus the output
    # tile read and written by every read-modify-write pass
    staged = grid_steps * (wgt_blk + img_blk) * elem_bytes \
        + np.where(scratch[:, None], 0, 2 * grid_steps * out_blk
                   * elem_bytes)                               # [O, B]
    dram = float(sum(layer.array_bytes().values())) / layer.elem_bytes \
        * elem_bytes
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
        launches=launches, compute_s=bc(compute_s), memory_s=memory_s,
        overhead_s=overhead_s)


def conv_schedule_cost_batch(layer: ConvLayer,
                             orders: Sequence[Sequence[str]],
                             blocks: Sequence[Dict[str, int]],
                             spec: H100Spec = H100Spec(),
                             elem_bytes: int = 2) -> BatchKernelCost:
    """Score the full ``orders`` x ``blocks`` conv-schedule grid at once
    ([n_orders, n_blocks] arrays); one evaluation counted per
    candidate."""
    EVAL_COUNTS["conv_schedule_cost_batch"] += len(orders) * len(blocks)
    return _conv_batch(layer, orders, blocks, spec, elem_bytes)


def conv_schedule_cost(layer: ConvLayer, grid_order: Sequence[str],
                       block: Dict[str, int], spec: H100Spec = H100Spec(),
                       elem_bytes: int = 2) -> KernelCost:
    """Cost of one (grid order, block) conv schedule (the scalar form
    the dense-vs-sparse policy calls)."""
    EVAL_COUNTS["conv_schedule_cost"] += 1
    return _conv_batch(layer, [tuple(grid_order)], [block], spec,
                       elem_bytes).cost((0, 0))


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

    step_s = np.zeros((n_b, 2))
    smem = np.zeros((n_b, 2))
    ok = np.zeros((n_b, 2), dtype=bool)
    for i in range(n_b):
        for r in (0, 1):
            t = geo.matmul_tile(int(bm[i]), int(bn[i]), int(bk[i]), k,
                                elem_bytes, bool(r))
            smem[i, r] = t.smem
            ok[i, r] = t.error is None and t.smem <= spec.smem_bytes
            mi = t.mi or geo.MM_MICRO[-1]
            mj = t.mj or geo.MM_MICRO[-1]
            # a k step: MI x MJ FMAs against MI + MJ shared-memory loads
            kstep = max(mi * mj / spec.fma_issue, (mi + mj) / spec.lds_issue)
            cycles = -(-t.threads // spec.lane_pad) * int(bk[i]) * kstep
            # staged a step: the A chunk, and the B chunk (the resident
            # panel once per tile, spread over its k steps)
            staged = int(bk[i]) * 16 * (mi + mj) if not r else \
                int(bk[i]) * 16 * mi + k * 16 * mj / (k // int(bk[i]))
            step_s[i, r] = _step_seconds(np.array([cycles]),
                                         np.array([staged]),
                                         np.array([t.threads]),
                                         np.array([t.smem]), spec)[0]
    util = np.minimum(1.0, c_distinct / spec.sms)
    compute_s = step_s * grid_steps[:, None] / (spec.sms
                                                * util[:, None])  # [B, 2]
    scratch = _scratch_orders(orders, "k", ("m", "n"))
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


def sparse_conv_schedule_cost_batch(
        layer: ConvLayer, blocks: Sequence[Dict[str, int]],
        density: float = 1.0, batch: int = 1,
        spec: H100Spec = H100Spec(),
        elem_bytes: int = 2) -> BatchKernelCost:
    """Score (oc, ic) skip blocks for the block-sparse conv kernel at a
    block ``density`` ([n_blocks] arrays).  Steps and bytes are the JAX
    package's counts (expected nonzero steps scale with density; the
    image slab is counted per step); compute follows the kernel's
    spatial tiling and thread layout."""
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
    by, bx = geo.sparse_tile(layer.h, layer.w)
    n_sp = -(-layer.h // by) * -(-layer.w // bx)
    step_s, smem, ok = _conv_terms(layer, np.full(len(blocks), by),
                                   np.full(len(blocks), bx), boc, bic,
                                   elem_bytes, spec)
    util = np.minimum(1.0, batch * n_oc * n_sp / spec.sms)
    compute_s = steps * n_sp * step_s / (spec.sms * util)
    staged = steps * n_sp * (boc * bic * layer.kh * layer.kw + bic
                             * (by + layer.kh - 1) * (bx + layer.kw - 1)) \
        * elem_bytes
    taps = layer.kh * layer.kw
    dram = (batch * layer.ic * h2 * w2 + n_oc * nnz * boc * bic * taps
            + batch * layer.oc * layer.h * layer.w) * elem_bytes
    overhead_s = spec.launch_s + np.where(ok, 0.0, INFEASIBLE_S)
    return BatchKernelCost(
        flops=np.full(len(blocks), 2.0 * batch * layer.macs * density),
        hbm_bytes=hbm, dram_bytes=dram * 1.0, staged_bytes=staged * 1.0,
        smem_peak=smem.astype(np.float64), grid_steps=steps,
        launches=np.ones(len(blocks), dtype=np.int64), compute_s=compute_s,
        memory_s=np.maximum(dram / spec.hbm_bw, staged / spec.l2_bw),
        overhead_s=overhead_s)


__all__ = ["COST_MODEL_VERSION", "EVAL_COUNTS", "H100Spec", "KernelCost",
           "BatchKernelCost", "conv_schedule_cost",
           "conv_schedule_cost_batch", "matmul_schedule_cost_batch",
           "sparse_conv_schedule_cost_batch", "total_evals"]
