"""Launch geometry and limits of the port's kernels on an H100.

One place answers "how does the CUDA kernel lay out this block, and does
it fit?" for the direct conv, the block-sparse conv, the tiled matmul,
flash attention, the split decode (``decode_plan``) and the selective
scan (``scan_layout``), per dtype: bf16 runs on the tensor cores
(``conv_mma_tile``, also the block-sparse conv's with its index row,
``matmul_mma_tile``, ``flash_mma_tile``, ``flash_wgmma_tile``), float32
on the CUDA cores (``conv_tile``, ``matmul_tile``);
``tensor_cores`` is the one rule that picks by element size, and
``conv_layout``, ``sparse_layout`` and ``matmul_layout`` follow it.
The attention kernels pick their body by a rule on the dtype, the head
dim and the KV group (never ``pos``, ``starts`` or the length, so a
captured graph's launch is fixed): ``flash_body`` (one bf16 body at the
models' head dims, wgmma + TMA; mma.sync at other head dims) and
``decode_body`` (the whole KV group packed as the rows of tensor-core
tiles; head chunks on the CUDA cores for MHA, float32 and the rest).
The wrappers use it to launch (and to raise on a block the kernel
cannot take), the H100 cost model uses it for its padding and
feasibility terms, and the tuner uses it to offer only blocks the
kernel accepts, so a ranked schedule never raises on the card.  Pure Python: nothing here
touches a device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

# A Hopper block: at most 1024 threads and 227 KB of (dynamic) shared
# memory (232,448 bytes; above 48 KB after cudaFuncSetAttribute).
MAX_THREADS = 1024
SMEM_BYTES = 232448
WARP = 32

# Direct conv: a thread owns one output pixel of the tile and J <=
# CONV_MAX_OC contiguous output channels of it, so the tile is G channel
# groups x (by * bx) pixels.
CONV_TARGET_THREADS = 256
CONV_MAX_OC = 16

# Matmul: 16 x 16 threads; a thread owns an MI x MJ micro-tile (rows
# ty + 16 i, columns tx + 16 j) with MI, MJ in {2, 4, 8}, so the block's
# tile is padded to 16 MI x 16 MJ.
MM_THREADS_X = 16
MM_THREADS_Y = 16
MM_MICRO = (2, 4, 8)

# bf16 conv2d (implicit GEMM, wgmma.m64nNk16, both operands from shared
# memory): the M rows are the halo's pixels, (by - 1) (bx + kw - 1) + bx
# of them (the columns past bx are junk rows, computed and never stored,
# so that every tap reads the halo at a constant shift), padded to 64 mt
# (a warpgroup tile: mt 64-row tiles); oc pads to the wgmma's N (16, 32
# or 64: the one whose wgmmas read the fewest bytes, conv_mma_nt), ic to
# 16.  A block has 2 to 4 warpgroups and covers a larger tile in rounds.
# Shared memory: the halo [ic / 8][halo pixels][8] (plus the rows the
# last M tile's junk rows read at the largest shift) and the weights [kh
# kw][ic / 8][oc_pad][8] (wgmma's K-major layout without swizzle), two
# slots of the streamed operand and one a channel block of the resident
# one, a ring of 2-3 slots of raw runs (cp.async lands 16-byte units of
# each run's aligned cover), each warpgroup's epilogue staging and,
# where a launch can sum more than one accumulator part, each thread's
# f32 part slots.  A block walks up to
# CONV_MMA_MAX_WALK tiles sharing one operand: the walk whose launch
# takes the fewest tile times on an SM (its waves of CONV_MMA_SMS SMs x
# the blocks an SM holds, times the walk), the longest among equals (its
# tiles after the first load while the one before multiplies).
CONV_MMA_MAX_WARPS = 16
CONV_MMA_ROWS = 64            # a warpgroup's M rows
CONV_MMA_NT = (16, 32, 64)    # the wgmma's N
# each warpgroup's epilogue staging: per warp, f32 values of 8 channels
# x its 16 rows, rows of 20 floats (conv_mma.cuh kEpiBytes)
CONV_MMA_EPI_BYTES = 4 * 8 * (16 + 4) * 4
# a block has at least this many warps (two warpgroups): those past its
# tiles only load and write the channels-last pass
CONV_MMA_MIN_WARPS = 8
CONV_MMA_MAX_WALK = 8
CONV_MMA_SMS = 132
# warps an SM holds at the body's 128 registers a thread (65,536 / 4,096)
CONV_MMA_SM_WARPS = 16
# an SM's shared memory (228 KB) and what CUDA reserves a block:
# how many blocks' layouts fit on one SM
SM_SMEM_BYTES = 233472
SMEM_RESERVED = 1024

# bf16 matmul (wgmma): 64 rows a consumer warpgroup (one or two), the
# wgmma width BN from MMA_BN, a stage depth of 16, 32 or 64 k elements,
# 2-8 ring stages, a producer warpgroup; a persistent grid of the blocks
# the card holds at once, each walking tiles, the last partial wave's
# tiles split along k in up to MMA_MAX_SPLITS parts (``matmul_plan``).
MMA_BN = (16, 32, 64, 96, 128, 192, 256)
MMA_MAX_STAGES = 8
MMA_MIN_STAGES = 2
MMA_BARRIER_BYTES = 256
MMA_MAX_SPLITS = 4
# k values one part of a unit sums on the tensor cores: their f32
# accumulation over 8192 (512 wgmma k-steps into one accumulator) drifts
# past 2 bf16 ulps of values near zero at phi3's down projection, as
# cuBLAS's does (launch/matmul_timeline.py --precision), so a longer k
# is split and its parts added in IEEE f32.  The bf16 conv holds its
# sums (channels x taps) to the same part length (conv_mma.cuh
# kMmaPartK): 10,890 terms in one accumulator missed the contract at
# 1.53 of the tolerance against float64.
MMA_PART_K = 4096
# an H100 SXM's SMs: the cost model's assumption (the wrapper asks the
# card how many blocks it holds)
MMA_SMS = 132

# Block-sparse conv, float32: the spatial tile is the port's own choice
# (the Pallas kernel kept the whole image in VMEM): up to 8 x 16 pixels,
# ragged edges masked.  (bf16 takes the dense conv model's pixel tile:
# core/sparsity.py, sparse_pixel_tile.)
SPARSE_TILE_Y = 8
SPARSE_TILE_X = 16

# bf16 flash attention on mma.sync.m16n8k16 (the body of the head dims
# outside FLASH_WGMMA_D): 16 query rows a warp, 64 or 128 rows a block
# (4 or 8 warps; the block's rows are a template parameter), 64-key K/V
# tiles; D pads to 16 up to FLASH_Q_REGS_D (Q kept in registers), to 32
# above it up to FLASH_MAX_D (Q re-read from shared memory for each KV
# tile).  The float32 body takes the same head dims in its single tile
# of FLASH_F32_TILE (query rows, keys).
FLASH_ROWS = 64               # the default rows of a bf16 block
FLASH_ROW_CHOICES = (64, 128)
FLASH_KEYS = 64
FLASH_Q_REGS_D = 128
FLASH_MAX_D = 256
FLASH_F32_TILE = (64, 32)

# bf16 flash attention at the models' head dims, every length
# (csrc/flash_wgmma.cu): wgmma + TMA, one or two consumer warpgroups (64
# or 128 query rows, the same FLASH_ROW_CHOICES) and a producer warp; Q
# and a ring of two stages of K and V (FLASH_KEYS keys each) in shared
# memory as [D / W][rows][W] swizzled tiles, W = 64 elements (32 at D
# 96), 1024-byte aligned.
FLASH_WGMMA_D = (64, 96, 128, 256)
FLASH_WGMMA_STAGES = 2
FLASH_WGMMA_BARRIER_BYTES = 256
# Registers a consumer thread of the wgmma body needs beside O (D / 2
# f32), S (32) and P's bf16 hi and lo (16 each): ptxas fits D 64's 96 in
# 128 with 40 to spare under three blocks an SM, and spills at D 256 with
# two warpgroups, where 32 are left (chip_smoke.py's [ptxas] lines).
FLASH_WGMMA_REG_SPARE = 33

# Split decode (csrc/decode_common.cuh): 128-thread blocks, each one
# (row, KV head, head chunk) x one split of the key range; K and V staged
# a tile of keys at a time in rows of an odd number of 16-byte units.
DEC_MAX_D = 256
DEC_MAX_HEADS = 8             # query heads a block serves (head chunk)
DEC_CHUNK_OUTPUTS = 512       # outputs (head x dim) a chunk aims at
DEC_TILE_KEYS = 64            # at most, keys a staged tile holds
DEC_TILE_BYTES = 48 * 1024    # at most, K and V of one tile
DEC_MIN_SPLIT_KEYS = 32
DEC_MAX_SPLITS = 256
# about a full wave of blocks: 132 SMs x 8 resident 128-thread blocks
DEC_TARGET_BLOCKS = 132 * 8
DEC_STATS_BYTES = (3 * DEC_MAX_HEADS + 4) * 4   # m, l, alpha + flag

# The packed decode body (csrc/decode_common.cuh, decode_packed_kernel):
# bf16 with a KV group of 2 to 64 query heads at a head dim of
# DEC_PACKED_D.  A block serves one (row, KV head, split) for all of the
# group's heads, which are the rows of mma.sync tiles (16 a tile, zero
# rows past the group; 1, 2 or 4 tiles), so K and V cross memory once a
# KV head; 64-key tiles double-buffered.  The splits of a row run in
# thread-block clusters of up to DEC_PACKED_CLUSTER, which combine their
# partials through distributed shared memory, each block a slice of the
# outputs; a row of more than one cluster combines the clusters'
# partials through the workspace.
DEC_PACKED_D = (64, 96, 128, 256)
DEC_PACKED_TILES = (1, 2, 4)
DEC_PACKED_TILE_KEYS = 64
DEC_PACKED_CLUSTER = 8        # the portable cluster size
# about one block an SM: one SM streams K/V at a small share of the
# card's rate, so a row's keys spread over many; at head_dim 256 a
# block's two K/V stages take 135 KB
DEC_PACKED_TARGET_BLOCKS = 132

# Selective scan (csrc/ssm_scan.cu, kP and kTile): a channel's N states
# are split across N / SCAN_STATES_PER_LANE lanes of a warp; x, dt, b and
# c are staged SCAN_TILE_STEPS steps at a time in two stages of shared
# memory.
SCAN_STATES = (8, 16)
SCAN_STATES_PER_LANE = 4
SCAN_TILE_STEPS = 32


def _pow2_at_least(n: int, choices) -> Optional[int]:
    """Smallest entry of ``choices`` that is >= n (None if none is)."""
    for c in choices:
        if c >= n:
            return c
    return None


@dataclasses.dataclass(frozen=True)
class ConvTile:
    """How the conv kernel lays out one (boc, by, bx) output tile."""
    groups: int          # G: channel groups, threads = G * by * bx
    per_thread: int      # J: output channels a thread owns, 1/2/4/8/16
    threads: int
    smem: int            # bytes: weight tile (padded to G J) + image halo

    @property
    def error(self) -> Optional[str]:
        """Why the kernel refuses this tile, or None when it fits."""
        if self.threads > MAX_THREADS:
            return f"{self.threads} threads > {MAX_THREADS}"
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def conv_tile(boc: int, bic: int, by: int, bx: int, kh: int, kw: int,
              elem_bytes: int) -> ConvTile:
    """Layout of a conv tile: thread (g, p) owns pixel p and the J
    contiguous channels g J .. g J + J - 1, with J the power of two (at
    most CONV_MAX_OC) that gives about CONV_TARGET_THREADS threads and G
    = ceil(boc / J).  Shared memory holds the weight tile transposed to
    [bic, kh, kw, G J] (a thread's J weights of a tap are contiguous, so
    they load as 16-byte vectors) and the [bic, by+kh-1, bx+kw-1] image
    halo."""
    pixels = by * bx
    want = -(-boc * pixels // CONV_TARGET_THREADS)
    per = _pow2_at_least(min(want, CONV_MAX_OC), (1, 2, 4, 8, 16))
    groups = -(-boc // per)
    smem = (groups * per * bic * kh * kw
            + bic * (by + kh - 1) * (bx + kw - 1)) * elem_bytes
    return ConvTile(groups, per, groups * pixels, smem)


def sparse_tile(h: int, w: int):
    """(by, bx) spatial tile of the float32 block-sparse kernel for an
    h x w output (ragged edges are masked, so it need not divide)."""
    return min(h, SPARSE_TILE_Y), min(w, SPARSE_TILE_X)


@dataclasses.dataclass(frozen=True)
class MatmulTile:
    """How the matmul kernel lays out one (bm, bn) output tile."""
    mi: Optional[int]    # rows a thread owns (None: bm too large)
    mj: Optional[int]    # columns a thread owns
    threads: int
    smem: int            # bytes: A chunk + B chunk (or the whole B panel)

    @property
    def bm_pad(self) -> int:
        """Rows of the padded tile (16 MI)."""
        return MM_THREADS_Y * (self.mi or 0)

    @property
    def bn_pad(self) -> int:
        """Columns of the padded tile (16 MJ)."""
        return MM_THREADS_X * (self.mj or 0)

    @property
    def error(self) -> Optional[str]:
        """Why the kernel refuses this tile, or None when it fits."""
        if self.mi is None or self.mj is None:
            return (f"tile rows/columns above "
                    f"{MM_THREADS_Y * MM_MICRO[-1]}")
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def matmul_tile(bm: int, bn: int, bk: int, k: int, elem_bytes: int,
                resident_rhs: bool) -> MatmulTile:
    """Layout of a matmul tile: the A chunk [16 MI, bk + 1] (rows padded
    by one element) and the B chunk [bk, 16 MJ] in shared memory, or with
    ``resident_rhs`` the whole [k, 16 MJ] B panel loaded once beside the
    A chunk."""
    mi = _pow2_at_least(-(-bm // MM_THREADS_Y), MM_MICRO)
    mj = _pow2_at_least(-(-bn // MM_THREADS_X), MM_MICRO)
    bm_pad = MM_THREADS_Y * (mi or MM_MICRO[-1])
    bn_pad = MM_THREADS_X * (mj or MM_MICRO[-1])
    b_rows = k if resident_rhs else bk
    smem = ((bk + 1) * bm_pad + b_rows * bn_pad) * elem_bytes
    return MatmulTile(mi, mj, MM_THREADS_X * MM_THREADS_Y, smem)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ConvMmaTile:
    """How the bf16 tensor-core conv lays out one (boc, bic, by, bx)
    tile of a problem (``csrc/conv_mma.cuh``, conv_mma_layout)."""
    rows: int            # M rows: the halo's pixels up to the last stored
    #                      one, (by - 1) (bx + kw - 1) + bx
    m_pad: int           # rows padded to a warpgroup tile's 64 mt
    nt: int              # the wgmma's N (16, 32 or 64)
    mt: int              # 64-row tiles a warpgroup tile holds (1-3; 2 at
    #                      nt 64): the fewest that take one round where
    #                      tiles sum several channel blocks, else 1
    boc_pad: int         # output channels padded to nt
    bic_pad: int         # input channels padded to the MMA's K (16)
    warps: int           # warps of the block: 2 to 4 warpgroups, each a
    #                      64 mt x nt tile (past the tiles, ones that
    #                      multiply the last tile again and store nothing)
    rounds: int          # passes over the tile's warpgroup tiles
    walk: int            # tiles a block walks (> 1: one operand resident)
    stages: int          # ring slots of raw runs
    late: bool           # streamed operands in one slot, written after
    #                      the previous step's MMAs
    fixed_halo: bool     # the halo (not the weights) is the shared operand
    group: int           # consecutive tiles that share it
    tiles: int           # output tiles of the launch
    blocks: int          # blocks of the launch
    halo_units: int      # 16-byte channels-last units of a halo block
    wgt_units: int       # ... of a weight block
    halo_chunks: int     # 16-byte cp.async units of a halo block's runs
    wgt_chunks: int      # ... of a weight block's runs
    zero_units: int      # 16-byte units a block zeroes once (padding)
    smem: int            # bytes: transposed slots, the ring, the
    #                      epilogue staging, the part buffer, `extra`
    block_ksteps: int = 1  # k16 steps a channel block: taps x bic_pad / 16
    part_k: int = MMA_PART_K // 16   # k16 steps an accumulator part sums
    #                                  at most (whole channel blocks)

    @property
    def threads(self) -> int:
        return self.warps * WARP

    @property
    def resident(self) -> bool:
        return self.walk > 1

    @property
    def wg_tiles(self) -> Tuple[int, int]:
        """Warpgroup tiles along the rows and along oc."""
        return (self.m_pad // (CONV_MMA_ROWS * self.mt),
                self.boc_pad // self.nt)

    def parts(self, blocks: int) -> Tuple[int, ...]:
        """The k16 steps each accumulator part of a tile sums when the
        launch sums ``blocks`` channel blocks: whole blocks in order, as
        many as fit in ``part_k`` k16 steps."""
        per = self.part_k // self.block_ksteps
        whole, rest = divmod(blocks, per)
        return ((per * self.block_ksteps,) * whole
                + ((rest * self.block_ksteps,) if rest else ()))

    @property
    def error(self) -> Optional[str]:
        """Why the kernel refuses this tile, or None when it fits."""
        if self.block_ksteps > self.part_k:
            return (f"{self.block_ksteps} k16 steps a channel block > "
                    f"{self.part_k} (an accumulator part)")
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def _blocks_an_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes that fit an SM's shared memory."""
    return SM_SMEM_BYTES // (smem + SMEM_RESERVED)


def conv_mma_nt(boc: int) -> Tuple[int, int]:
    """(the wgmma's N, oc padded to it): of CONV_MMA_NT, the one whose
    wgmmas read the fewest shared-memory bytes a k step -- oc_pad / N
    tiles, each reading A's 64 rows (2 KB) and B's N rows (32 bytes
    each), so oc_pad (2048 / N + 32) -- the widest among equals."""
    _, neg, pad = min((_round_up(boc, n) * (2048 // n + 32), -n,
                       _round_up(boc, n)) for n in CONV_MMA_NT)
    return -neg, pad


@functools.lru_cache(maxsize=1 << 16)
def conv_mma_tile(boc: int, bic: int, by: int, bx: int, kh: int, kw: int,
                  *, oc: Optional[int] = None, ic: Optional[int] = None,
                  h: Optional[int] = None, w: Optional[int] = None,
                  batch: int = 1, order: Tuple[str, ...] = ("oc", "y", "x"),
                  n_fixed: Optional[int] = None, extra: int = 0
                  ) -> ConvMmaTile:
    """Layout of a bf16 conv tile on the tensor cores for the problem
    (``batch`` images of ``ic`` x ``h`` x ``w``, ``oc`` outputs; each
    defaults to the tile's own, a problem of one tile) and the output
    axes' ``order`` (outer first; "ic" is ignored): the halo's rows up to
    the last stored pixel padded to 64 mt, oc to the wgmma's N, ic to 16;
    warpgroup tiles of mt x 64 rows x N channels run by 2 to 4
    warpgroups (in rounds past 4).  ``n_fixed``: the slots a resident
    operand takes, ic / bic (every launch of a read-modify-write schedule
    takes the scratch launch's layout), or the sparse conv's max_nnz;
    ``extra``: bytes after the epilogue staging (the sparse index row).
    The walk, the ring's depth and the slots are this function's rule,
    which the kernel checks: one slot of each streamed operand (written
    after a step's MMAs) where two do not fit; the walk up to
    CONV_MMA_MAX_WALK (and the group) whose waves, at the blocks an SM
    holds by shared memory and registers, times the walk are fewest, the
    longest among equals; three ring slots where they cost no block an
    SM, else two."""
    oc = boc if oc is None else oc
    ic = bic if ic is None else ic
    h = by if h is None else h
    w = bx if w is None else w
    n_fixed = ic // bic if n_fixed is None else n_fixed
    hh, ww = by + kh - 1, bx + kw - 1
    rows = (by - 1) * ww + bx
    nt, boc_pad = conv_mma_nt(boc)
    wg_n = boc_pad // nt
    # 64-row tiles a warpgroup holds (its accumulators, mt nt / 2 floats
    # a thread, at most 64): where the tiles sum more than one channel
    # block, the fewest that cover the tile in one round of
    # CONV_MMA_MAX_WARPS / 4 warpgroups, else the most (each further round
    # re-streams the blocks); one where they sum one block (a step then
    # runs every round)
    m_tiles = -(-rows // CONV_MMA_ROWS)
    mt_max = 1 if n_fixed == 1 else 2 if nt == 64 else 3
    mt = 1
    while mt < mt_max and -(-m_tiles // mt) * wg_n > CONV_MMA_MAX_WARPS // 4:
        mt += 1
    m_pad = -(-m_tiles // mt) * mt * CONV_MMA_ROWS
    bic_pad = _round_up(bic, 16)
    nkc = bic_pad // 8
    wt = -(-m_tiles // mt) * wg_n
    wgs = min(CONV_MMA_MAX_WARPS // 4, max(wt, CONV_MMA_MIN_WARPS // 4))
    warps = 4 * wgs
    taps = kh * kw
    noct = -(-bic // 8)
    trips = {"oc": -(-oc // boc), "y": -(-h // by), "x": -(-w // bx)}
    out = [a for a in order if a != "ic"]
    fixed_halo = out[-1] == "oc"
    if fixed_halo:
        group = trips["oc"]
    else:
        group = 1
        for a in out[out.index("oc") + 1:]:
            group *= trips[a]
    tiles = batch * trips["oc"] * trips["y"] * trips["x"]
    # raw runs: a channel's rows when the tile spans the width, else each
    # row; an oc row's bic kh kw weights in an odd number of units
    row_runs = ww != w + kw - 1
    h_runs = bic * (hh if row_runs else 1)
    h_slot = ((ww if row_runs else hh * (w + kw - 1)) + 14) // 8
    w_slot = ((bic * taps + 14) // 8) | 1
    raw_h, raw_w = h_runs * h_slot * 16, boc * w_slot * 16
    # a halo slot: its planes and the rows past the last one that the
    # last M tile's junk rows read at the largest shift
    reach = m_pad + (kh - 1) * ww + kw - 1
    th = (nkc * hh * ww + max(0, reach - hh * ww)) * 16
    tw = taps * nkc * boc_pad * 16
    epi = wgs * CONV_MMA_EPI_BYTES
    # the part buffer (each thread's own f32 slots), where a launch can
    # sum more than one accumulator part
    part_k = MMA_PART_K // 16
    block_ksteps = taps * bic_pad // 16
    parts = n_fixed * block_ksteps > part_k
    part_bytes = 4 * warps * WARP * mt * (nt // 2) if parts else 0

    def slots(walk: int, late: bool) -> Tuple[int, int]:
        """Transposed halo and weight slots: the resident operand's
        n_fixed, the streamed ones' two (one, late)."""
        res = walk > 1
        return (n_fixed if res and fixed_halo else 2 - late,
                n_fixed if res and not fixed_halo else 2 - late)

    def smem(walk: int, stages: int, late: bool) -> int:
        """Bytes of the layout."""
        raw = max(raw_h, raw_w) if walk > 1 else raw_h + raw_w
        h_slots, w_slots = slots(walk, late)
        return (h_slots * th + w_slots * tw + stages * raw + epi
                + part_bytes + extra)

    def blocks(walk: int) -> int:
        return tiles // group * -(-group // walk)

    # two slots of each streamed operand, else one
    late = smem(1, 2, False) > SMEM_BYTES

    def held(walk: int, stages: int) -> int:
        """Blocks an SM holds: its shared memory and its registers."""
        return min(_blocks_an_sm(smem(walk, stages, late)),
                   CONV_MMA_SM_WARPS // warps)

    # each walk: its ring (three slots where they cost no block an SM)
    # and its tile times; a walk past 1 only where streaming fits
    options = []
    for k in range(1, min(group, CONV_MMA_MAX_WALK) + 1):
        two, three = held(k, 2), held(k, 3)
        st, per_sm = (3, three) if three >= two else (2, two)
        if per_sm >= 1 or k == 1:
            waves = -(-blocks(k) // (CONV_MMA_SMS * max(1, per_sm)))
            options.append((waves * k, -k, st))
        if two < 1:
            break
    _, neg_walk, stages = min(options)
    walk = -neg_walk
    h_slots, w_slots = slots(walk, late)
    zero = (h_slots * hh * ww + w_slots * taps * boc_pad
            if noct < nkc else 0)
    return ConvMmaTile(rows, m_pad, nt, mt, boc_pad, bic_pad, warps,
                       -(-wt // wgs), walk, stages, late, fixed_halo, group,
                       tiles, blocks(walk), hh * ww * noct, taps * boc * noct,
                       h_runs * h_slot, boc * w_slot, zero,
                       smem(walk, stages, late), block_ksteps, part_k)


def tensor_cores(elem_bytes: int) -> bool:
    """Whether the kernels run their tensor-core bodies for this element
    size: bf16 does (conv2d, the block-sparse conv, matmul and flash
    attention), float32 keeps the CUDA-core bodies (the tensor cores do
    only TF32 on float32, which would break the port's 1e-5 float32
    contract)."""
    return elem_bytes == 2


def conv_layout(boc: int, bic: int, by: int, bx: int, kh: int, kw: int,
                elem_bytes: int, **problem):
    """The dense conv's layout for its dtype: the tensor-core tile for
    bf16 (``problem``: :func:`conv_mma_tile`'s keywords), the CUDA-core
    tile for float32 (which does not depend on them)."""
    if tensor_cores(elem_bytes):
        return conv_mma_tile(boc, bic, by, bx, kh, kw, **problem)
    return conv_tile(boc, bic, by, bx, kh, kw, elem_bytes)


def sparse_layout(boc: int, bic: int, by: int, bx: int, kh: int, kw: int,
                  n_ic: int, elem_bytes: int, *,
                  max_nnz: Optional[int] = None, **problem):
    """The block-sparse conv's layout for its dtype: bf16 the dense
    conv's tensor-core tile in the schedule order (oc, y, x), its
    resident weights ``max_nnz`` channel blocks (default ``n_ic``, every
    block, as before the structure is known) and the oc block's index row
    (``max_nnz`` ints, 16-byte aligned) after the ring; float32 the
    CUDA-core tile (which does not depend on them)."""
    if tensor_cores(elem_bytes):
        nnz = n_ic if max_nnz is None else max_nnz
        return conv_mma_tile(boc, bic, by, bx, kh, kw, order=("oc", "y", "x"),
                             n_fixed=nnz, extra=_round_up(4 * nnz, 16),
                             **problem)
    return conv_tile(boc, bic, by, bx, kh, kw, elem_bytes)


@dataclasses.dataclass(frozen=True)
class FlashMmaTile:
    """How the bf16 flash attention lays out a head dim and a block of
    query rows (``csrc/flash_attention.cu``, flash_mma_kernel<DP, ROWS>)."""
    d: int
    dp: int              # D padded to the MMA's k (16)
    staging: str         # "cp.async" (16-byte rows) or "registers"
    smem: int            # bytes: the Q/O tile and two K and V stages
    rows: int = FLASH_ROWS

    @property
    def threads(self) -> int:
        """One warp per 16 query rows."""
        return self.rows // 16 * WARP

    @property
    def error(self) -> Optional[str]:
        """Why the kernel refuses this tile, or None when it fits."""
        if not 1 <= self.d <= FLASH_MAX_D:
            return f"head_dim {self.d} not in [1, {FLASH_MAX_D}]"
        if self.rows not in FLASH_ROW_CHOICES:
            return (f"block_q {self.rows} not in {FLASH_ROW_CHOICES} (the "
                    f"bf16 body's rows)")
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def flash_mma_tile(d: int, rows: int = FLASH_ROWS) -> FlashMmaTile:
    """Layout of the bf16 flash body for head dim ``d`` and ``rows``
    query rows a block: D padded to 16 (to 32 above FLASH_Q_REGS_D, where
    the kernel has one instance per 32 columns); rows of 16-byte
    multiples (d % 8 == 0) staged by cp.async, others through registers
    into the same tiles of row stride dp + 8 (the kernel also takes the
    register route for bases that are not 16-byte aligned); shared
    memory for the Q (later O) tile of ``rows`` rows and two stages of K
    and V of FLASH_KEYS rows each."""
    dp = _round_up(max(d, 1), 16 if d <= FLASH_Q_REGS_D else 32)
    smem = (rows + 4 * FLASH_KEYS) * (dp + 8) * 2
    return FlashMmaTile(d, dp, "cp.async" if d % 8 == 0 else "registers",
                        smem, rows)


def flash_tile_error(d: int, elem_bytes: int, block_q: int,
                     block_kv: int) -> Optional[str]:
    """Why the flash body that runs at this dtype and head dim
    (:func:`flash_body`) refuses (block_q, block_kv), or None: both bf16
    bodies take FLASH_ROW_CHOICES rows at FLASH_KEYS keys, float32 only
    its FLASH_F32_TILE."""
    if tensor_cores(elem_bytes):
        if block_kv != FLASH_KEYS:
            return (f"block_kv {block_kv} is not the bf16 body's key tile "
                    f"{FLASH_KEYS}")
        if flash_body(d, elem_bytes) == "wgmma":
            return flash_wgmma_tile(d, block_q).error
        return flash_mma_tile(d, block_q).error
    if (block_q, block_kv) != FLASH_F32_TILE:
        return (f"(block_q, block_kv) ({block_q}, {block_kv}) is not the "
                f"float32 body's tile {FLASH_F32_TILE}")
    return flash_mma_tile(d).error        # the same head dims


def flash_default_tile(elem_bytes: int) -> Tuple[int, int]:
    """(block_q, block_kv) the flash wrapper launches with no schedule."""
    return ((FLASH_ROWS, FLASH_KEYS) if tensor_cores(elem_bytes)
            else FLASH_F32_TILE)


@dataclasses.dataclass(frozen=True)
class FlashWgmmaTile:
    """How the wgmma bf16 flash body lays out a head dim and a
    block of query rows (``csrc/flash_wgmma.cu``,
    flash_wgmma_kernel<DP, WG>)."""
    d: int
    rows: int
    atom: int            # W: elements of a swizzle row (64, or 32)
    smem: int            # bytes: alignment pad, Q, the ring, barriers

    @property
    def threads(self) -> int:
        """A consumer warpgroup per 64 rows and one producer warp."""
        return 128 * (self.rows // 64) + WARP

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by the launch bounds' register budget
        (``min_blocks`` in the source): one warpgroup 3 at D 64, 2 up to
        D 128, 1 at D 256; two warpgroups 1."""
        if self.rows > 64:
            return 1
        return 3 if self.d <= 64 else 2 if self.d <= 128 else 1

    @property
    def spills(self) -> bool:
        """Whether a consumer thread's registers exceed its budget (65536
        over the block's threads and blocks an SM, at most 255, in steps
        of 8): ptxas then spills and serializes the body's wgmmas."""
        budget = min(255, 65536 // (self.threads * self.blocks_per_sm)
                     // 8 * 8)
        return self.d // 2 + 64 + FLASH_WGMMA_REG_SPARE > budget

    @property
    def error(self) -> Optional[str]:
        """Why the body refuses this tile, or None when it fits."""
        if self.d not in FLASH_WGMMA_D:
            return f"head_dim {self.d} not in {FLASH_WGMMA_D} (the wgmma body)"
        if self.rows not in FLASH_ROW_CHOICES:
            return (f"block_q {self.rows} not in {FLASH_ROW_CHOICES} (the "
                    f"bf16 body's rows)")
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def flash_wgmma_tile(d: int, rows: int = FLASH_ROWS) -> FlashWgmmaTile:
    """Layout of the wgmma flash body (``smem_of`` in the source computes
    the same): a 1024-byte alignment pad, the Q tile [rows][d], the
    FLASH_WGMMA_STAGES stages of K and V ([FLASH_KEYS][d] each) and the
    barriers."""
    q = rows * d * 2
    stage = 2 * FLASH_KEYS * d * 2
    smem = (1024 + q + FLASH_WGMMA_STAGES * stage
            + FLASH_WGMMA_BARRIER_BYTES)
    return FlashWgmmaTile(d, rows, 64 if d % 64 == 0 else 32, smem)


def flash_body(d: int, elem_bytes: int) -> str:
    """The flash body a call runs, from its dtype and head dim only:
    "float32" (the CUDA-core body) for float32; for bf16 "wgmma"
    (``flash_wgmma.cu``, wgmma + TMA) at a head dim of FLASH_WGMMA_D,
    whatever the length, else "mma" (``flash_mma_kernel``, mma.sync),
    the one bf16 body that takes the other head dims."""
    if not tensor_cores(elem_bytes):
        return "float32"
    return "wgmma" if d in FLASH_WGMMA_D else "mma"


def dec_units(d: int, elem_bytes: int) -> int:
    """16-byte units of a staged K/V row of the split decode: the row
    rounded up to 16 bytes, then to an odd count, so the eight rows a
    quarter-warp reads with 16-byte loads fall on distinct banks."""
    return (-(-d * elem_bytes // 16)) | 1


def dec_smem(d: int, elem_bytes: int, tile_keys: int, head_chunk: int,
             table_entries: int) -> int:
    """Shared memory of a split-decode block (``dec_layout`` in
    ``csrc/decode_common.cuh`` computes the same): K and V tiles, q of
    the head chunk as f32, the tile's scores, the softmax state and the
    split's block-table entries."""
    units = dec_units(d, elem_bytes)
    kv = tile_keys * units * 16
    q = head_chunk * units * 16 // elem_bytes * 4
    p = _round_up(head_chunk * tile_keys * 4, 16)
    return (2 * kv + q + p + DEC_STATS_BYTES
            + _round_up(4 * table_entries, 16))


def _packed_tiles(group: int) -> int:
    """16-row tiles the packed body gives a group: the first of
    DEC_PACKED_TILES that holds it (the kernel's MT)."""
    need = -(-group // 16)
    return next((t for t in DEC_PACKED_TILES if t >= need), need)


def dec_packed_stages(split_keys: int) -> int:
    """K/V stages of a packed-decode block: one when a split holds at
    most one tile (``dec_packed_stages`` in the source), else two."""
    return 1 if split_keys <= DEC_PACKED_TILE_KEYS else 2


def dec_packed_smem(d: int, tile_keys: int, m_tiles: int,
                    table_entries: int, stages: int = 2) -> int:
    """Shared memory of a packed-decode block (``dec_packed_layout`` in
    ``csrc/decode_common.cuh`` computes the same): ``stages`` stages of K
    and V tiles in rows of d + 8 bf16, q of the group's 16 x m_tiles
    rows, p's bf16 hi and lo parts, the warps' row maxima and sums, a
    flag and the split's block-table entries."""
    row = (d + 8) * 2
    rows = 16 * m_tiles
    return (2 * stages * tile_keys * row + rows * row
            + 2 * rows * (tile_keys + 8) * 2 + 4 * rows * 4 + 16
            + _round_up(4 * table_entries, 16))


def decode_body(hq: int, hkv: int, d: int, elem_bytes: int) -> str:
    """The decode body a call runs, from static shapes only: "packed"
    (the KV group's heads as tensor-core rows, K and V read once a KV
    head) for bf16 with a group of 2 to 16 x DEC_PACKED_TILES[-1] heads
    at a head dim of DEC_PACKED_D; "chunked" (head chunks of at most
    DEC_MAX_HEADS on the CUDA cores) otherwise: float32, other head
    dims, larger groups, and MHA.  At a group of one the packed body has
    nothing to share: a 16-row tile holds one real row, and a block
    walks its split's tiles in series with a cluster's combine after
    them, where the chunked body spreads the keys over ~4x the blocks of
    one tile each; it lost at phi3-mini's decodes (32 heads of 96, 1-4
    rows) on an H100 (PERF.md, ``launch/decode_timeline.py``)."""
    group = hq // hkv if hkv >= 1 and hq % hkv == 0 else 1
    if (elem_bytes == 2 and d in DEC_PACKED_D
            and 1 < group <= 16 * DEC_PACKED_TILES[-1]):
        return "packed"
    return "chunked"


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the split decode runs one call (``csrc/decode_common.cuh``,
    decode_split_kernel): the grid is (B x HKV x chunks, splits); split
    ``i`` owns keys ``[i * split_keys, (i + 1) * split_keys)`` and walks
    them in tiles of ``tile_keys``.  Fixed by static values only (the
    shapes, and a schedule's split): it never sees ``pos`` or
    ``starts``."""
    b: int
    hq: int
    hkv: int
    d: int
    limit: int           # keys a row can address: S, or MB x bs
    block_size: int      # pool block (0: contiguous cache)
    elem_bytes: int
    head_chunk: int      # query heads a block serves
    chunks: int          # head chunks of a KV group
    tile_keys: int
    split_keys: int
    splits: int
    smem: int
    body: str = "chunked"   # decode_body's choice

    @property
    def cluster(self) -> int:
        """Splits (blocks) a thread-block cluster holds: the packed body's
        as even as at most DEC_PACKED_CLUSTER allows (9 splits: two of
        5), 1 for the chunked body."""
        if self.body != "packed":
            return 1
        clusters = -(-self.splits // DEC_PACKED_CLUSTER)
        return -(-self.splits // clusters)

    @property
    def grid_splits(self) -> int:
        """The grid's y: the splits padded to whole clusters (the padding
        blocks hold no key)."""
        return -(-self.splits // self.cluster) * self.cluster

    @property
    def m_tiles(self) -> int:
        """The packed body's 16-row tiles of the group (0 when chunked)."""
        return _packed_tiles(self.head_chunk) if self.body == "packed" else 0

    @property
    def rows(self) -> int:
        """(row, KV head, head chunk) triples: the grid's x."""
        return self.b * self.hkv * self.chunks

    @property
    def blocks(self) -> int:
        return self.rows * self.grid_splits

    @property
    def tickets(self) -> int:
        """Ticket counters the merge needs, one per grid row."""
        return self.rows

    @property
    def part_floats(self) -> int:
        """f32 of one split's partial: m, l and acc of each head
        (packed: acc first, then m and l padded to 16 bytes, so the merge
        reads acc as float4)."""
        if self.body == "packed":
            return (self.head_chunk * self.d
                    + _round_up(2 * self.head_chunk, 4))
        return self.head_chunk * (self.d + 2)

    @property
    def workspace_floats(self) -> int:
        """f32 partials: the chunked body's of every split, the packed
        body's of every cluster; none where one block (chunked) or one
        cluster (packed) holds the row."""
        if self.body == "packed":
            clusters = self.grid_splits // self.cluster
            return 0 if clusters == 1 else (self.rows * clusters
                                            * self.part_floats)
        if self.splits == 1:
            return 0
        return self.blocks * self.part_floats

    def split_range(self, i: int) -> Tuple[int, int]:
        """Keys ``[lo, hi)`` that split ``i`` owns."""
        return (i * self.split_keys,
                min(self.limit, (i + 1) * self.split_keys))

    @property
    def error(self) -> Optional[str]:
        """Why the kernel refuses this call, or None when it runs."""
        if not 1 <= self.d <= DEC_MAX_D:
            return f"head_dim {self.d} not in [1, {DEC_MAX_D}]"
        if self.hkv < 1 or self.hq < 1 or self.hq % self.hkv:
            return (f"HQ={self.hq} is not a multiple of HKV={self.hkv}")
        if self.elem_bytes not in (2, 4):
            return f"element size {self.elem_bytes} is not bf16 or float32"
        if self.limit < 1 or self.b < 1:
            return "no keys or no rows"
        gran = self.block_size if self.block_size > 0 else 16
        if self.split_keys < 1 or self.split_keys % gran:
            what = ("the pool block" if self.block_size > 0
                    else "16 keys")
            return (f"split of {self.split_keys} keys is not a multiple of "
                    f"{what} ({gran})")
        if self.grid_splits > DEC_MAX_SPLITS:
            return f"{self.grid_splits} splits > {DEC_MAX_SPLITS}"
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def decode_plan(b: int, hq: int, hkv: int, d: int, limit: int,
                block_size: int, elem_bytes: int,
                split_keys: Optional[int] = None) -> DecodePlan:
    """The split plan of a decode call from static shapes, on the body
    :func:`decode_body` gives it: ``limit`` is the cache's S
    (contiguous, ``block_size`` 0) or MB x bs (paged).  ``split_keys``
    (a :class:`DecodeAttentionSchedule`'s ``block_kv``) replaces the
    split below and keeps the head chunk and the tile.  The plan's
    ``error`` says when the kernel refuses it (not a multiple of 16
    keys, or of the pool block; more than DEC_MAX_SPLITS splits; shared
    memory over SMEM_BYTES).

    Chunked (``decode_split_kernel``):

    - head chunk: a KV group's query heads in equal chunks of at most
      DEC_MAX_HEADS heads and, where the group allows, at most
      DEC_CHUNK_OUTPUTS outputs (4 a thread), so wide heads spread over
      more blocks (each chunk re-reads its split's K/V, from L2);
    - tile: up to DEC_TILE_KEYS keys whose K and V rows fit
      DEC_TILE_BYTES, a multiple of 16;
    - splits: enough for about DEC_TARGET_BLOCKS blocks, at least
      DEC_MIN_SPLIT_KEYS keys each and at most DEC_MAX_SPLITS.

    Packed (``decode_packed_kernel``): the head chunk is the whole group
    (``chunks`` 1), the tile DEC_PACKED_TILE_KEYS keys, and the split
    enough for about DEC_PACKED_TARGET_BLOCKS blocks but at least a tile:
    the partials stay in shared memory, combined within a cluster of up
    to DEC_PACKED_CLUSTER splits a slice a block, so more splits cost a
    little combining and stream K and V from more SMs.

    Either way the split is a multiple of 16 keys (contiguous) or of the
    pool block (paged, so split boundaries fall on pool blocks)."""
    body = decode_body(hq, hkv, d, elem_bytes)
    group = hq // hkv if hkv >= 1 and hq % hkv == 0 else 1
    limit = max(limit, 1)
    gran = block_size if block_size > 0 else 16
    if body == "packed":
        chunks, head_chunk, tile = 1, group, DEC_PACKED_TILE_KEYS
        target, least = DEC_PACKED_TARGET_BLOCKS, DEC_PACKED_TILE_KEYS
    else:
        per_chunk = max(1, min(DEC_MAX_HEADS,
                               DEC_CHUNK_OUTPUTS // max(d, 1)))
        chunks = -(-group // per_chunk)
        head_chunk = -(-group // chunks)
        units = dec_units(max(d, 1), elem_bytes)
        tile = DEC_TILE_BYTES // (2 * units * 16) // 16 * 16
        tile = max(16, min(DEC_TILE_KEYS, tile))
        target, least = DEC_TARGET_BLOCKS, DEC_MIN_SPLIT_KEYS
    rows = max(b, 1) * max(hkv, 1) * chunks
    want = max(1, -(-target // rows))
    if split_keys is None:
        keys = max(-(-limit // want), least, -(-limit // DEC_MAX_SPLITS))
        split_keys = min(_round_up(keys, gran), _round_up(limit, gran))
    split_keys = int(split_keys)
    splits = -(-limit // max(split_keys, 1))
    table = -(-split_keys // block_size) if block_size > 0 else 0
    if body == "packed":
        smem = dec_packed_smem(max(d, 1), tile, _packed_tiles(group), table,
                               dec_packed_stages(split_keys))
    else:
        smem = dec_smem(max(d, 1), elem_bytes, tile, head_chunk, table)
    return DecodePlan(b, hq, hkv, d, limit, block_size, elem_bytes,
                      head_chunk, chunks, tile, split_keys, splits, smem,
                      body)


@dataclasses.dataclass(frozen=True)
class MatmulMmaTile:
    """How the bf16 wgmma matmul lays out one (bm, bn, bk) tile
    (``csrc/matmul.cu``, matmul_mma_kernel; ``mma_smem`` there computes
    the same bytes)."""
    bm_pad: int          # 64 a consumer warpgroup (0: bm too large)
    bn_pad: int          # the wgmma width (0: bn too large)
    ks: int              # ring stage depth in k: 16, 32 or 64
    stages: int          # ring stages that fit, at most 8
    smem: int            # bytes: ring (+ resident B panel) + barriers
    resident: bool

    @property
    def threads(self) -> int:
        """Consumer warpgroups plus the producer warpgroup."""
        return 128 * (self.bm_pad // 64 + 1)

    @property
    def error(self) -> Optional[str]:
        """Why the kernel refuses this tile, or None when it fits."""
        if not self.bm_pad:
            return "tile rows above 128 (two consumer warpgroups)"
        if not self.bn_pad:
            return f"tile columns above {MMA_BN[-1]} (the widest wgmma)"
        if self.stages < MMA_MIN_STAGES:
            what = "the resident B panel and " if self.resident else ""
            return (f"{what}{MMA_MIN_STAGES} ring stages need more than "
                    f"{SMEM_BYTES} bytes of shared memory")
        return None


def matmul_mma_tile(bm: int, bn: int, bk: int, k: int,
                    resident_rhs: bool) -> MatmulMmaTile:
    """Layout of a bf16 matmul tile: bm padded to 64 or 128 rows, bn to
    the next wgmma width of MMA_BN, the stage depth ks from bk (16, 32,
    64), as many ring stages of A [bm_pad, ks] and B [ks, bn_pad] (1024-
    byte aligned) as fit up to 8 (and no more than k's chunks, at least
    2); with ``resident_rhs`` the [k, bn_pad] B panel (k rounded up to
    64) sits beside a ring of A only."""
    bm_pad = 64 if bm <= 64 else 128 if bm <= 128 else 0
    bn_pad = next((w for w in MMA_BN if w >= bn), 0)
    ks = 16 if bk <= 16 else 32 if bk <= 32 else 64
    a_bytes = _round_up(max(bm_pad, 64) * ks * 2, 1024)
    bn_any = bn_pad or MMA_BN[-1]
    b_bytes = 0 if resident_rhs else _round_up(bn_any * ks * 2, 1024)
    span = 128 if (bn_any * 2) % 128 == 0 else 64 if (bn_any * 2) % 64 == 0 \
        else 32
    panel_rows = _round_up(k, 64) if resident_rhs else 0
    panel = _round_up(bn_any * panel_rows * 2, 1024)
    free = SMEM_BYTES - 1024 - panel - MMA_BARRIER_BYTES
    stages = min(MMA_MAX_STAGES, max(0, free // (a_bytes + b_bytes)),
                 max(MMA_MIN_STAGES, -(-k // ks)))   # no idle stage
    if resident_rhs and panel_rows * span // 16 > 16383:
        stages = 0        # the descriptor's 14-bit atom stride
    smem = 1024 + stages * (a_bytes + b_bytes) + panel + MMA_BARRIER_BYTES
    return MatmulMmaTile(bm_pad, bn_pad, ks, stages, smem, resident_rhs)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """How one launch of the bf16 matmul covers its tiles
    (``matmul_plan``).  The grid is ``grid`` blocks, each walking units
    (every grid-th, or with a resident RHS a contiguous run); a unit is
    a tile or a part of one: the first ``full_tiles`` tiles sum the
    pass's whole k range, the last ``tail_tiles`` are split into
    ``splits`` parts of its ``chunks`` k chunks each."""
    grid: int
    tiles: int
    full_tiles: int
    tail_tiles: int
    splits: int
    chunks: int
    resident: bool
    tile_floats: int      # f32 values of a tile's partial (BM x BN)
    error: Optional[str] = None

    @property
    def units(self) -> int:
        """Units of work the blocks walk."""
        return self.full_tiles + self.tail_tiles * self.splits

    @property
    def tickets(self) -> int:
        """Ticket counters of the split tiles, one a tile."""
        return self.tail_tiles if self.splits > 1 else 0

    @property
    def workspace_floats(self) -> int:
        """f32 partials of the split tiles: one a part."""
        return self.tickets * self.splits * self.tile_floats

    def split_range(self, i: int) -> Tuple[int, int]:
        """The k chunks [c0, c1) of part ``i`` of a split tile."""
        return (i * self.chunks // self.splits,
                (i + 1) * self.chunks // self.splits)

    def walk(self, b: int) -> range:
        """The units block ``b`` walks, in order (``walk_of`` in the
        source)."""
        if self.resident:
            q, rem = divmod(self.units, self.grid)
            first = b * q + min(b, rem)
            return range(first, first + q + (b < rem))
        return range(b, self.units, self.grid)

    def unit(self, u: int) -> Tuple[int, int, int, int]:
        """(tile, first chunk, end chunk, part or -1) of unit ``u``
        (``unit_at`` in the source)."""
        if u < self.full_tiles:
            return u, 0, self.chunks, -1
        v = u - self.full_tiles
        part = v % self.splits
        return (self.full_tiles + v // self.splits,
                *self.split_range(part), part)


# registers a thread of the bf16 matmul body at one consumer warpgroup,
# by wgmma width (ptxas, sm_90a; at 16 and 32 the launch bounds hold it
# to three blocks an SM); two warpgroups launch at 168, which fills an SM
MMA_WG1_REGS = {16: 80, 32: 80, 64: 142, 96: 160, 128: 172, 192: 204,
                256: 236}


def matmul_blocks_per_sm(tile: MatmulMmaTile) -> int:
    """Blocks of this layout an SM holds: by shared memory, threads and
    registers."""
    regs = 168 if tile.bm_pad > 64 else MMA_WG1_REGS[tile.bn_pad]
    return max(1, min(SM_SMEM_BYTES // (tile.smem + SMEM_RESERVED),
                      2048 // tile.threads,
                      int(65536 // (tile.threads * regs))))


def matmul_plan(m: int, n: int, k: int, bm: int, bn: int, bk: int, *,
                k_count: Optional[int] = None, resident_rhs: bool = False,
                resident_blocks: Optional[int] = None) -> MatmulPlan:
    """The launch plan of one pass of the bf16 matmul (``k_count`` k
    values, the whole k by default): the grid the blocks that can be
    resident at once, ``resident_blocks`` (the card's count from the
    wrapper; MMA_SMS x the blocks an SM holds when None), never more
    than there are units; and the tail split: when the tiles do not fill
    the last wave, its tiles' k chunks are split over the blocks it
    would leave idle, in up to MMA_MAX_SPLITS parts of at least one
    chunk (none with a resident RHS, whose panel holds the whole k); a
    pass of more than MMA_PART_K k values splits every tile into parts
    of at most that.  ``error`` says why the kernel cannot take it."""
    tile = matmul_mma_tile(bm, bn, bk, k, resident_rhs)
    k_count = k if k_count is None else k_count
    chunks = -(-k_count // max(tile.ks, 1))
    tiles = (m // bm) * (n // bn)
    floats = max(tile.bm_pad, 64) * (tile.bn_pad or MMA_BN[-1])

    def refuse(why: str) -> MatmulPlan:
        return MatmulPlan(0, tiles, 0, 0, 1, chunks, resident_rhs, floats,
                          why)

    if tile.error is not None:
        return refuse(tile.error)
    if m % bm or n % bn or k % bk or k_count % bk or k_count < bk:
        return refuse(f"blocks {bm} x {bn} x {bk} must divide m={m} n={n} "
                      f"k={k} and the pass's {k_count}")
    rb = (MMA_SMS * matmul_blocks_per_sm(tile) if resident_blocks is None
          else int(resident_blocks))
    if rb < 1:
        return refuse(f"no block of {tile.smem} bytes fits on the card")
    need = -(-k_count // MMA_PART_K)
    if need > 1 and resident_rhs:
        return refuse(f"a resident RHS sums its k in one part: k_count "
                      f"{k_count} > {MMA_PART_K}")
    grid = min(rb, tiles)
    full, tail, splits = tiles, 0, 1
    waves, rem = divmod(tiles, grid)
    if need > 1:
        # every tile in parts of at most MMA_PART_K k values, more where
        # that fills idle blocks
        splits = min(chunks, max(need, min(rb // tiles, MMA_MAX_SPLITS)))
        full, tail = 0, tiles
        grid = min(rb, tiles * splits)
    elif rem and not resident_rhs:
        splits = min(grid // rem, chunks, MMA_MAX_SPLITS)
        if splits >= 2:
            full, tail = tiles - rem, rem
        else:
            splits = 1
    elif not rem and waves == 1 and not resident_rhs and tiles < rb:
        # fewer tiles than resident blocks: split every tile
        splits = min(rb // tiles, chunks, MMA_MAX_SPLITS)
        if splits >= 2:
            full, tail = 0, tiles
            grid = min(rb, tiles * splits)
        else:
            splits = 1
    return MatmulPlan(grid, tiles, full, tail, splits, chunks, resident_rhs,
                      floats)


def matmul_mma_route(k: int, n: int) -> Tuple[bool, bool]:
    """(A by TMA, B by TMA): the shape rule of the bf16 matmul's staging.
    TMA needs rows that are multiples of 16 bytes (k % 8 for A [m, k],
    n % 8 for B [k, n]); other operands are loaded through the producer's
    registers into the same swizzled stage."""
    return k % 8 == 0, n % 8 == 0


def matmul_layout(bm: int, bn: int, bk: int, k: int, elem_bytes: int,
                  resident_rhs: bool):
    """The matmul's layout for its dtype: the wgmma tile for bf16, the
    CUDA-core tile for float32."""
    if tensor_cores(elem_bytes):
        return matmul_mma_tile(bm, bn, bk, k, resident_rhs)
    return matmul_tile(bm, bn, bk, k, elem_bytes, resident_rhs)


@dataclasses.dataclass(frozen=True)
class ScanLayout:
    """How the selective scan lays out a block of channels
    (``csrc/ssm_scan.cu``): ``lanes`` threads a channel, each holding
    ``states_per_lane`` consecutive states; ``error`` says why the kernel
    cannot take it (None when it can)."""
    states_per_lane: int
    lanes: int
    threads: int
    smem: int             # two stages of dt, b, c and x
    error: Optional[str]


def scan_layout(block_d: int, n: int, elem_bytes: int) -> ScanLayout:
    """The scan's block for ``block_d`` channels of ``n`` states with x
    of ``elem_bytes`` bytes (``scan_stage_bytes`` in the source computes
    the same stage)."""
    states_per_lane = SCAN_STATES_PER_LANE
    lanes = max(n // states_per_lane, 1)
    threads = block_d * lanes
    stage = SCAN_TILE_STEPS * (block_d * (4 + elem_bytes) + 2 * n * 4)
    error = None
    if n not in SCAN_STATES:
        error = f"state size {n} not in {SCAN_STATES}"
    elif block_d < WARP or block_d % WARP:
        error = f"block_d {block_d} must be a positive multiple of {WARP}"
    elif threads > MAX_THREADS:
        error = (f"block_d {block_d} x {lanes} lanes a channel = {threads} "
                 f"threads > {MAX_THREADS}")
    elif 2 * stage > SMEM_BYTES:
        error = (f"block_d {block_d}: {2 * stage} bytes of shared memory > "
                 f"{SMEM_BYTES}")
    return ScanLayout(states_per_lane, lanes, threads, 2 * stage, error)


__all__ = ["ScanLayout", "scan_layout", "ConvTile", "MatmulTile",
           "ConvMmaTile", "MatmulMmaTile", "FlashMmaTile", "FlashWgmmaTile",
           "DecodePlan", "decode_plan", "decode_body",
           "dec_packed_smem",
           "dec_packed_stages",
           "flash_wgmma_tile", "flash_body", "conv_tile", "matmul_tile", "conv_mma_tile",
           "matmul_mma_tile", "MatmulPlan", "matmul_plan",
           "matmul_blocks_per_sm",
           "flash_mma_tile", "flash_tile_error",
           "flash_default_tile", "conv_layout", "sparse_layout",
           "matmul_layout", "matmul_mma_route", "tensor_cores", "sparse_tile",
           "MMA_BN", "MAX_THREADS", "SMEM_BYTES", "WARP"]
