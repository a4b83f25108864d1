"""Launch geometry and limits of the port's kernels on an H100.

One place answers "how does the CUDA kernel lay out this block, and does
it fit?" for the direct conv, the block-sparse conv, the tiled matmul,
flash attention, the split decode (``decode_plan``) and the selective
scan (``scan_layout``), per dtype: bf16 runs on the tensor cores
(``conv_mma_tile``, also the block-sparse conv's with its index row,
``matmul_mma_tile``, ``flash_mma_tile``), float32 on the CUDA cores
(``conv_tile``, ``matmul_tile``);
``tensor_cores`` is the one rule that picks by element size, and
``conv_layout``, ``sparse_layout`` and ``matmul_layout`` follow it. The
wrappers use it to launch (and to raise on a block the kernel cannot
take), the H100 cost model uses it for its padding and feasibility
terms, and the tuner uses it to offer only blocks the kernel accepts, so
a ranked schedule never raises on the card.  Pure Python: nothing here
touches a device.
"""
from __future__ import annotations

import dataclasses
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

# bf16 conv2d (implicit GEMM, mma.sync.m16n8k16): pixels pad to 16, oc
# to 16 (ldmatrix.x4 loads two n8 fragments), ic to 16; a warp owns a
# 32 x 32 (pixel x oc) tile, a block has at most 16 warps and covers a
# larger tile in rounds.  Shared memory: two stages of the halo
# [by+kh-1][bx+kw-1][ic_pad+8] and the weights [kh kw][oc_pad][ic_pad+8]
# (bf16), and a 32 x 36 f32 epilogue tile a warp.
CONV_MMA_MAX_WARPS = 16
CONV_MMA_WARP_TILE = 32
CONV_MMA_UNITS = 4          # staging units (8 channels) a thread prefetches
CONV_MMA_EPI_BYTES = 32 * 36 * 4

# bf16 matmul (wgmma): 64 rows a consumer warpgroup (one or two), the
# wgmma width BN from MMA_BN, a stage depth of 16, 32 or 64 k elements,
# 2-4 ring stages, a producer warpgroup.
MMA_BN = (16, 32, 64, 96, 128, 192, 256)
MMA_MAX_STAGES = 4
MMA_MIN_STAGES = 2
MMA_BARRIER_BYTES = (2 * MMA_MAX_STAGES + 1) * 8

# Block-sparse conv, float32: the spatial tile is the port's own choice
# (the Pallas kernel kept the whole image in VMEM): up to 8 x 16 pixels,
# ragged edges masked.  (bf16 takes the dense conv model's pixel tile:
# core/sparsity.py, sparse_pixel_tile.)
SPARSE_TILE_Y = 8
SPARSE_TILE_X = 16

# bf16 flash attention (mma.sync.m16n8k16): 16 query rows a warp, 64 or
# 128 rows a block (4 or 8 warps; the block's rows are a template
# parameter), 64-key K/V tiles; D pads to 16 up to FLASH_Q_REGS_D (Q kept
# in registers), to 32 above it up to FLASH_MAX_D (Q re-read from shared
# memory for each KV tile).  The float32 body takes the same head dims in
# its single tile of FLASH_F32_TILE (query rows, keys).
FLASH_ROWS = 64               # the default rows of a bf16 block
FLASH_ROW_CHOICES = (64, 128)
FLASH_KEYS = 64
FLASH_Q_REGS_D = 128
FLASH_MAX_D = 256
FLASH_F32_TILE = (64, 32)

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
    tile (``csrc/conv2d.cu``, conv_mma_kernel)."""
    p16: int             # pixels padded to the MMA's M (16)
    boc16: int           # output channels padded to 16
    bic_pad: int         # input channels padded to the MMA's K (16)
    warps: int           # warps of the block (each a 32 x 32 tile)
    rounds: int          # passes over the tile's warp tiles
    units: int           # staging units (8 channels) a channel block
    smem: int            # bytes: two stages + the warps' epilogue tiles

    @property
    def threads(self) -> int:
        return self.warps * WARP

    @property
    def error(self) -> Optional[str]:
        """Why the kernel refuses this tile, or None when it fits."""
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def conv_mma_tile(boc: int, bic: int, by: int, bx: int, kh: int,
                  kw: int) -> ConvMmaTile:
    """Layout of a bf16 conv tile on the tensor cores: pixels, oc and ic
    padded to 16; ceil(p16 / 32) x ceil(boc16 / 32) warp tiles run by
    up to 16 warps (in rounds past that); shared memory holds two stages
    of the channels-last halo and the [taps][boc16][bic_pad] weights
    (rows padded by 8 elements) and each warp's f32 epilogue tile."""
    p16 = _round_up(by * bx, 16)
    boc16 = _round_up(boc, 16)
    bic_pad = _round_up(bic, 16)
    cstr = bic_pad + 8
    tiles = (-(-p16 // CONV_MMA_WARP_TILE)) * (-(-boc16 // CONV_MMA_WARP_TILE))
    warps = min(CONV_MMA_MAX_WARPS, tiles)
    halo = (by + kh - 1) * (bx + kw - 1) * cstr * 2
    stage = halo + kh * kw * boc16 * cstr * 2
    units = ((by + kh - 1) * (bx + kw - 1) + kh * kw * boc) * (-(-bic // 8))
    return ConvMmaTile(p16, boc16, bic_pad, warps, -(-tiles // warps), units,
                       2 * stage + warps * CONV_MMA_EPI_BYTES)


def tensor_cores(elem_bytes: int) -> bool:
    """Whether the kernels run their tensor-core bodies for this element
    size: bf16 does (conv2d, the block-sparse conv, matmul and flash
    attention), float32 keeps the CUDA-core bodies (the tensor cores do
    only TF32 on float32, which would break the port's 1e-5 float32
    contract)."""
    return elem_bytes == 2


def conv_layout(boc: int, bic: int, by: int, bx: int, kh: int, kw: int,
                elem_bytes: int):
    """The dense conv's layout for its dtype: the tensor-core tile for
    bf16, the CUDA-core tile for float32."""
    if tensor_cores(elem_bytes):
        return conv_mma_tile(boc, bic, by, bx, kh, kw)
    return conv_tile(boc, bic, by, bx, kh, kw, elem_bytes)


def sparse_layout(boc: int, bic: int, by: int, bx: int, kh: int, kw: int,
                  n_ic: int, elem_bytes: int):
    """The block-sparse conv's layout for its dtype: bf16 the dense
    conv's tensor-core tile plus the oc block's index row (``n_ic`` ints,
    16-byte aligned) in shared memory, float32 the CUDA-core tile."""
    if tensor_cores(elem_bytes):
        t = conv_mma_tile(boc, bic, by, bx, kh, kw)
        return dataclasses.replace(t, smem=t.smem + _round_up(4 * n_ic, 16))
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
    """Why the flash body of the dtype refuses (block_q, block_kv) at
    head dim ``d``, or None: bf16 takes FLASH_ROW_CHOICES rows at
    FLASH_KEYS keys, float32 only its FLASH_F32_TILE."""
    if tensor_cores(elem_bytes):
        if block_kv != FLASH_KEYS:
            return (f"block_kv {block_kv} is not the bf16 body's key tile "
                    f"{FLASH_KEYS}")
        return flash_mma_tile(d, block_q).error
    if (block_q, block_kv) != FLASH_F32_TILE:
        return (f"(block_q, block_kv) ({block_q}, {block_kv}) is not the "
                f"float32 body's tile {FLASH_F32_TILE}")
    return flash_mma_tile(d).error        # the same head dims


def flash_default_tile(elem_bytes: int) -> Tuple[int, int]:
    """(block_q, block_kv) the flash wrapper launches with no schedule."""
    return ((FLASH_ROWS, FLASH_KEYS) if tensor_cores(elem_bytes)
            else FLASH_F32_TILE)


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

    @property
    def rows(self) -> int:
        """(row, KV head, head chunk) triples: the grid's x."""
        return self.b * self.hkv * self.chunks

    @property
    def blocks(self) -> int:
        return self.rows * self.splits

    @property
    def tickets(self) -> int:
        """Ticket counters the merge needs, one per grid row."""
        return self.rows

    @property
    def workspace_floats(self) -> int:
        """f32 partials (m, l and acc of each head) of every split; none
        with one split (the block writes the output itself)."""
        if self.splits == 1:
            return 0
        return self.blocks * self.head_chunk * (self.d + 2)

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
        if self.splits > DEC_MAX_SPLITS:
            return f"{self.splits} splits > {DEC_MAX_SPLITS}"
        if self.smem > SMEM_BYTES:
            return f"{self.smem} bytes of shared memory > {SMEM_BYTES}"
        return None


def decode_plan(b: int, hq: int, hkv: int, d: int, limit: int,
                block_size: int, elem_bytes: int,
                split_keys: Optional[int] = None) -> DecodePlan:
    """The split plan of a decode call from static shapes: ``limit`` is
    the cache's S (contiguous, ``block_size`` 0) or MB x bs (paged).
    ``split_keys`` (a :class:`DecodeAttentionSchedule`'s ``block_kv``)
    replaces the split below and keeps the head chunk and the tile; the
    plan's ``error`` says when the kernel refuses it (not a multiple of
    16 keys, or of the pool block; more than DEC_MAX_SPLITS splits;
    shared memory over SMEM_BYTES).

    - head chunk: a KV group's query heads in equal chunks of at most
      DEC_MAX_HEADS heads and, where the group allows, at most
      DEC_CHUNK_OUTPUTS outputs (4 a thread), so wide heads spread over
      more blocks (each chunk re-reads its split's K/V, from L2);
    - tile: up to DEC_TILE_KEYS keys whose K and V rows fit
      DEC_TILE_BYTES, a multiple of 16;
    - splits: enough for about DEC_TARGET_BLOCKS blocks, at least
      DEC_MIN_SPLIT_KEYS keys each and at most DEC_MAX_SPLITS, the split
      a multiple of 16 keys (contiguous) or of the pool block (paged, so
      split boundaries fall on pool blocks)."""
    group = hq // hkv if hkv >= 1 and hq % hkv == 0 else 1
    per_chunk = max(1, min(DEC_MAX_HEADS, DEC_CHUNK_OUTPUTS // max(d, 1)))
    chunks = -(-group // per_chunk)
    head_chunk = -(-group // chunks)
    units = dec_units(max(d, 1), elem_bytes)
    tile = DEC_TILE_BYTES // (2 * units * 16) // 16 * 16
    tile = max(16, min(DEC_TILE_KEYS, tile))
    limit = max(limit, 1)
    gran = block_size if block_size > 0 else 16
    rows = max(b, 1) * max(hkv, 1) * chunks
    want = max(1, -(-DEC_TARGET_BLOCKS // rows))
    if split_keys is None:
        keys = max(-(-limit // want), DEC_MIN_SPLIT_KEYS,
                   -(-limit // DEC_MAX_SPLITS))
        split_keys = min(_round_up(keys, gran), _round_up(limit, gran))
    split_keys = int(split_keys)
    splits = -(-limit // max(split_keys, 1))
    table = -(-split_keys // block_size) if block_size > 0 else 0
    smem = dec_smem(max(d, 1), elem_bytes, tile, head_chunk, table)
    return DecodePlan(b, hq, hkv, d, limit, block_size, elem_bytes,
                      head_chunk, chunks, tile, split_keys, splits, smem)


@dataclasses.dataclass(frozen=True)
class MatmulMmaTile:
    """How the bf16 wgmma matmul lays out one (bm, bn, bk) tile
    (``csrc/matmul.cu``, matmul_mma_kernel)."""
    bm_pad: int          # 64 a consumer warpgroup (0: bm too large)
    bn_pad: int          # the wgmma width (0: bn too large)
    ks: int              # ring stage depth in k: 16, 32 or 64
    stages: int          # ring stages that fit, at most 4
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
    byte aligned) as fit up to 4; with ``resident_rhs`` the [k, bn_pad]
    B panel (k rounded up to 64) sits beside a ring of A only."""
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
    stages = min(MMA_MAX_STAGES, max(0, free // (a_bytes + b_bytes)))
    if resident_rhs and panel_rows * span // 16 > 16383:
        stages = 0        # the descriptor's 14-bit atom stride
    smem = 1024 + stages * (a_bytes + b_bytes) + panel + MMA_BARRIER_BYTES
    return MatmulMmaTile(bm_pad, bn_pad, ks, stages, smem, resident_rhs)


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
           "ConvMmaTile", "MatmulMmaTile", "FlashMmaTile", "DecodePlan",
           "decode_plan", "conv_tile", "matmul_tile", "conv_mma_tile",
           "matmul_mma_tile", "flash_mma_tile", "flash_tile_error",
           "flash_default_tile", "conv_layout", "sparse_layout",
           "matmul_layout", "matmul_mma_route", "tensor_cores", "sparse_tile",
           "MMA_BN", "MAX_THREADS", "SMEM_BYTES", "WARP"]
