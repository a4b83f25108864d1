"""Launch geometry and limits of the thesis kernels on an H100.

One place answers "how does the CUDA kernel lay out this block, and does
it fit?" for the direct conv, the block-sparse conv and the tiled
matmul.  The wrappers use it to launch (and to raise on a block the
kernel cannot take), the H100 cost model uses it for its padding and
feasibility terms, and the tuner uses it to offer only blocks the kernel
accepts, so a ranked schedule never raises on the card.  Pure Python:
nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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

# Block-sparse conv: the spatial tile is the port's own choice (the
# Pallas kernel kept the whole image in VMEM): up to 8 x 16 pixels,
# ragged edges masked.
SPARSE_TILE_Y = 8
SPARSE_TILE_X = 16


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
    """(by, bx) spatial tile of the block-sparse kernel for an h x w
    output (ragged edges are masked, so it need not divide)."""
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


__all__ = ["ConvTile", "MatmulTile", "conv_tile", "matmul_tile",
           "sparse_tile", "MAX_THREADS", "SMEM_BYTES", "WARP"]
