"""Block-paged KV cache management for in-flight continuous batching.

The monolithic per-bucket cache tensor ties a row's KV capacity to the
batch-wide maximum: admitting a long request forces every row to carry
its padding, and a finished row's memory cannot be reused until the
whole batch retires.  Paging breaks that coupling — the thesis' lesson
that explicit control over memory layout beats fixed pipelines, applied
to the serving cache:

* the device holds one shared **pool** of ``n_blocks`` fixed-size blocks
  per layer (see :func:`repro_torch.models.transformer.init_paged_cache`);
* each sequence owns an ordered list of pool blocks, recorded in a
  per-row **block table**; logical position ``p`` of a row lives in pool
  block ``table[p // block_size]`` at offset ``p % block_size``;
* admission is a host-side allocation (:meth:`BlockAllocator.alloc`),
  retirement frees the blocks for the next request immediately.

Block 0 is **reserved as a garbage sink**: the allocator never hands it
out, and idle engine rows keep all-zero tables with ``pos = 0`` so their
(unavoidable, shape-static) decode writes land in block 0 and can never
corrupt a live sequence.

Everything in this module is host-side bookkeeping over numpy arrays;
the device-side write/attend primitives live in
:mod:`repro_torch.models.attention` (``paged_update_kv`` /
``paged_decode_attention``) and
:mod:`repro_torch.kernels.decode_attention` (the block-table-aware CUDA
kernel).  This is the port's own copy of ``repro.serving.paged_kv``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

RESERVED_BLOCK = 0


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Pool blocks required to store ``n_tokens`` cache entries
    (at least one — even an empty row owns its first block on
    admission so a budget-1 request never writes to the sink)."""
    return max(1, -(-int(n_tokens) // int(block_size)))


@dataclasses.dataclass
class BlockAllocator:
    """Free-list allocator over a pool of ``n_blocks`` KV blocks.

    Pure host-side state: block ids are ints, the free list is kept
    sorted so allocation order is deterministic (lowest ids first),
    which keeps engine runs reproducible.  Block 0 is reserved (see
    module docstring) and is never allocated or freeable.
    """

    n_blocks: int
    block_size: int

    def __post_init__(self):
        """Validate geometry and build the free list (block 0 reserved)."""
        if self.n_blocks < 2:
            raise ValueError(
                "BlockAllocator needs >= 2 blocks (block 0 is reserved)")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self._free: List[int] = list(range(1, self.n_blocks))
        self._live: set = set()

    @property
    def num_free(self) -> int:
        """Blocks currently available for allocation."""
        return len(self._free)

    @property
    def num_live(self) -> int:
        """Blocks currently owned by sequences."""
        return len(self._live)

    def can_fit(self, n_tokens: int) -> bool:
        """Whether a sequence needing ``n_tokens`` cache slots fits."""
        return blocks_needed(n_tokens, self.block_size) <= self.num_free

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks from the free list (lowest ids first), or
        None if fewer than ``n`` are free — admission backpressure is
        the caller's reaction to that None."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = self._free[:n]
        del self._free[:n]
        self._live.update(blocks)
        return blocks

    def free(self, blocks) -> None:
        """Return a retired sequence's blocks to the free list."""
        for b in blocks:
            b = int(b)
            if b == RESERVED_BLOCK:
                raise ValueError("block 0 is reserved and never owned")
            if b not in self._live:
                raise ValueError(f"double free of block {b}")
            self._live.remove(b)
            self._free.append(b)
        self._free.sort()

    def fragmentation(self) -> float:
        """How scattered the live blocks are: 1 - live/(span of live
        ids).  0.0 means live blocks are packed at the bottom of the
        pool (or none are live); values near 1 mean retirements left
        the pool full of holes and a :func:`compact_tables` pass would
        re-pack it."""
        if not self._live:
            return 0.0
        span = max(self._live)  # ids 1..max
        return 1.0 - len(self._live) / span

    def compact_tables(self, tables: np.ndarray,
                       row_blocks: List[List[int]]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Re-pack live blocks to the lowest pool ids.

        ``tables`` is the [R, MB] block-table array and ``row_blocks``
        the per-row ownership lists (both rewritten in place).  Returns
        ``(perm, moved)``: ``perm`` is an [n_blocks] int32 gather map —
        the device pool must be permuted as ``pool = pool[:, perm]``
        (new block ``i`` takes old block ``perm[i]``'s contents) — and
        ``moved`` the number of blocks that changed id.  The allocator's
        free list becomes the contiguous tail."""
        live_sorted = sorted(self._live)
        mapping = {old: new for new, old in
                   enumerate(live_sorted, start=1)}
        perm = np.arange(self.n_blocks, dtype=np.int32)
        for old, new in mapping.items():
            perm[new] = old
        # Free slots above the live span keep identity; slots vacated
        # by moves may alias, which is fine — their contents are dead.
        moved = sum(1 for old, new in mapping.items() if old != new)
        if moved:
            remap = np.vectorize(
                lambda b: mapping.get(int(b), int(b)))
            tables[...] = np.where(tables > 0, remap(tables), 0)
            for blocks in row_blocks:
                blocks[:] = [mapping[int(b)] for b in blocks]
        self._live = set(mapping.values())
        self._free = list(range(len(self._live) + 1, self.n_blocks))
        return perm, moved


__all__ = ["RESERVED_BLOCK", "BlockAllocator", "blocks_needed"]
