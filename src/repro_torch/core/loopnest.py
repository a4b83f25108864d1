"""The six-loop direct-convolution nest (thesis §2.2, Fig 3.1/3.2).

The thesis studies the nest::

    for oc in range(OC):                  # output channels
      for ic in range(IC):                # input channels
        for y in range(H):                # image height
          for x in range(W):              # image width
            for ky in range(KH):          # kernel height
              for kx in range(KW):        # kernel width
                out[oc,y,x] += wgt[oc,ic,ky,kx] * img[ic,y+ky,x+kx]

under all 720 orderings of the six loops.  This module gives the symbolic
machinery the cost models need: per-array *footprints* (distinct elements /
cache blocks touched by the loops below a given depth), trip counts, and the
output-index dependence set that decides which parallelisations are
"atomic-free" (thesis §3.4).

Everything is exact combinatorics, numpy only, so a footprint query costs
microseconds and the 720-permutation sweeps of Ch. 4/5 are cheap.  The
functions are the JAX package's (``repro.core.loopnest``), copied: the
tables and footprints they give are equal, value for value.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np

# Canonical loop order (permutation identity): matches thesis Fig 3.1.
LOOPS: Tuple[str, ...] = ("oc", "ic", "y", "x", "ky", "kx")
LOOP_INDEX: Dict[str, int] = {name: i for i, name in enumerate(LOOPS)}

# Loops whose value appears in the *output* index (thesis §3.4: parallelising
# any of these partitions out[] across threads => no atomics needed).
OUTPUT_LOOPS = frozenset({"oc", "y", "x"})
# Reduction loops (their iterations accumulate into the same out element).
REDUCTION_LOOPS = frozenset({"ic", "ky", "kx"})


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolutional layer's parameters (thesis Table 4.1 columns)."""

    oc: int          # output channels
    ic: int          # input channels
    h: int           # image height (output height; 'same' indexing as thesis)
    w: int           # image width
    kh: int          # kernel height
    kw: int          # kernel width
    elem_bytes: int = 4   # thesis uses 32-bit words

    def trips(self) -> Dict[str, int]:
        """Trip count per loop name (the six extents, keyed by LOOPS)."""
        return {"oc": self.oc, "ic": self.ic, "y": self.h, "x": self.w,
                "ky": self.kh, "kx": self.kw}

    @property
    def iterations(self) -> int:
        """Total inner-body iterations (thesis §2.2: product of all six)."""
        return self.oc * self.ic * self.h * self.w * self.kh * self.kw

    @property
    def macs(self) -> int:
        """Multiply-accumulates: one per inner-body iteration."""
        return self.iterations

    def array_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Logical shapes of the three arrays (out / wgt / img)."""
        return {
            "out": (self.oc, self.h, self.w),
            "wgt": (self.oc, self.ic, self.kh, self.kw),
            "img": (self.ic, self.h + self.kh - 1, self.w + self.kw - 1),
        }

    def array_bytes(self) -> Dict[str, int]:
        """Total bytes of each array at ``elem_bytes`` per element."""
        return {k: math.prod(v) * self.elem_bytes
                for k, v in self.array_shapes().items()}


# Array access functions: each array dimension is driven by a *group* of
# loops.  A group of more than one loop means the index is the sum of those
# loop variables (the sliding window: y+ky, x+kx).
ARRAY_DIMS: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "out": (("oc",), ("y",), ("x",)),
    "wgt": (("oc",), ("ic",), ("ky",), ("kx",)),
    "img": (("ic",), ("y", "ky"), ("x", "kx")),
}

# Loops that appear anywhere in an array's index (its "dependence set" S_A).
ARRAY_LOOPS: Dict[str, frozenset] = {
    name: frozenset(l for grp in dims for l in grp)
    for name, dims in ARRAY_DIMS.items()
}


def dim_extent(layer: ConvLayer, group: Tuple[str, ...],
               inner: frozenset) -> int:
    """Distinct index values of one array dimension when only the loops in
    ``inner`` vary (others pinned).  For a coupled dimension (y+ky) the
    distinct values of a sum of independent ranges [0,a)+[0,b) number
    a+b-1 — this is the sliding-window halo arithmetic."""
    trips = layer.trips()
    total = 0
    active = 0
    for l in group:
        if l in inner:
            total += trips[l]
            active += 1
    if active == 0:
        return 1
    return total - (active - 1)


def footprint_elems(layer: ConvLayer, array: str, inner: frozenset) -> int:
    """Distinct elements of ``array`` touched while loops in ``inner`` run a
    full pass (outer loops pinned)."""
    return math.prod(dim_extent(layer, g, inner) for g in ARRAY_DIMS[array])


def footprint_blocks(layer: ConvLayer, array: str, inner: frozenset,
                     block_bytes: int) -> int:
    """Distinct cache blocks touched.  The last array dimension is
    contiguous in memory (thesis §3.1 linearisation); trailing dimensions
    that are spanned *fully* merge into one contiguous run."""
    dims = ARRAY_DIMS[array]
    shape = _array_shape(layer, array)
    extents = [dim_extent(layer, g, inner) for g in dims]
    blk_elems = max(1, block_bytes // layer.elem_bytes)

    # Merge trailing fully-covered dims into a single contiguous extent.
    contig = extents[-1]
    d = len(dims) - 1
    while d > 0 and extents[d] == shape[d]:
        contig = extents[d - 1] * math.prod(shape[d:])
        d -= 1
    other = math.prod(extents[:d]) if d > 0 else 1
    # A run of `contig` elements straddles ceil(contig/blk) blocks (+1 for
    # misalignment on average; we take the aligned count, as the thesis'
    # arrays are malloc'd block-aligned in the simulator).
    return other * math.ceil(contig / blk_elems)


def _array_shape(layer: ConvLayer, array: str) -> Tuple[int, ...]:
    """Shape of one named array of ``layer``."""
    return ConvLayer.array_shapes(layer)[array]


def inner_set(perm: Sequence[int], depth: int) -> frozenset:
    """Loops strictly below ``depth`` in permutation ``perm`` (depth d means
    loops at positions d..5 are 'inner').  ``perm`` maps position->loop id
    (position 0 = outermost)."""
    return frozenset(LOOPS[perm[i]] for i in range(depth, len(perm)))


def perm_loops(perm: Sequence[int]) -> Tuple[str, ...]:
    """Loop names outermost->innermost for a permutation of range(6)."""
    return tuple(LOOPS[i] for i in perm)


def loops_to_perm(names: Sequence[str]) -> Tuple[int, ...]:
    """Inverse of :func:`perm_loops`: loop names -> loop-id permutation."""
    return tuple(LOOP_INDEX[n] for n in names)


def accesses_per_iteration(partial_sums: bool) -> Dict[str, float]:
    """Memory references issued by one inner-body iteration.

    Without the partial-sums optimisation (thesis §3.3) the body reads and
    writes ``out`` every iteration (2 refs) plus one read each of wgt/img.
    With partial sums, the accumulator lives in a register and ``out`` is
    only touched when the innermost *reduction-dependent* run finishes;
    CacheCostModel accounts for that separately, so here out's per-iteration
    cost is 0 and the model adds the boundary writes.
    """
    if partial_sums:
        return {"img": 1.0, "wgt": 1.0, "out": 0.0}
    return {"img": 1.0, "wgt": 1.0, "out": 2.0}


# ---------------------------------------------------------------------------
# Precomputed tables for the vectorized batch sweep engine
# ---------------------------------------------------------------------------
#
# A footprint only depends on the *set* of inner loops, never their order,
# so the whole recursive model collapses onto 2^6 = 64 subset values per
# array.  The batch engine (cost_model.simulate_batch) gathers from these
# tables with integer masks and replaces the per-permutation Python
# recursion with six rounds of array ops over the full candidate space.

SUBSET_COUNT = 1 << len(LOOPS)
FULL_MASK = SUBSET_COUNT - 1


def subset_loops(mask: int) -> frozenset:
    """The loop-name set encoded by a 6-bit mask (bit i = LOOPS[i])."""
    return frozenset(LOOPS[i] for i in range(len(LOOPS)) if mask >> i & 1)


@functools.lru_cache(maxsize=512)
def footprint_block_table(layer: ConvLayer, block_bytes: int,
                          ) -> Dict[str, np.ndarray]:
    """``tab[array][mask]`` = :func:`footprint_blocks` over every one of the
    64 inner-loop subsets (float64; the values are exact integers)."""
    return {
        array: np.array([
            footprint_blocks(layer, array, subset_loops(m), block_bytes)
            for m in range(SUBSET_COUNT)], dtype=np.float64)
        for array in ARRAY_DIMS
    }


def stacked_footprint_tables(layers: Sequence[ConvLayer],
                             block_bytes: int) -> Dict[str, np.ndarray]:
    """Per-layer 64-subset footprint tables stacked into one
    ``tab[array][l, mask]`` float64 ``[L, 64]`` array.

    This is the multi-layer gather surface the ECM tier scores whole
    design spaces through: one ``tab[array][:, masks]`` fancy-index turns
    the 216-layer x 720-permutation Table 4.2/4.3 spaces into a single
    ``[L, P, 7]`` array computation with no per-layer Python loop at
    scoring time.  Rows reuse the per-layer
    :func:`footprint_block_table` lru_cache, so repeated sweeps over
    overlapping layer sets pay the combinatorics once."""
    return {
        array: np.stack([footprint_block_table(layer, block_bytes)[array]
                         for layer in layers])
        for array in ARRAY_DIMS
    }


def perms_array(perms: Sequence[Sequence[int]]) -> np.ndarray:
    """Candidate permutations as an int64 [P, 6] array."""
    arr = np.asarray(perms, dtype=np.int64)
    if arr.ndim != 2 or arr.shape[1] != len(LOOPS):
        raise ValueError(f"expected [P, {len(LOOPS)}] perms, "
                         f"got shape {arr.shape}")
    return arr


def perm_inner_masks(parr: np.ndarray) -> np.ndarray:
    """``masks[p, d]`` = bitmask of the loops at positions d..5 of perm p
    (so column 0 is FULL_MASK and column 6 is 0) — the vectorized analogue
    of :func:`inner_set` for every depth at once."""
    n = parr.shape[1]
    masks = np.zeros((parr.shape[0], n + 1), dtype=np.int64)
    for d in range(n - 1, -1, -1):
        masks[:, d] = masks[:, d + 1] | np.left_shift(1, parr[:, d])
    return masks


def trips_vector(layer: ConvLayer) -> np.ndarray:
    """Trip counts indexed by loop id (int64 [6])."""
    trips = layer.trips()
    return np.array([trips[name] for name in LOOPS], dtype=np.int64)


# Bool [6] masks by loop id, for vectorized membership tests.
REDUCTION_MASK = np.array([name in REDUCTION_LOOPS for name in LOOPS])
OUTPUT_MASK = np.array([name in OUTPUT_LOOPS for name in LOOPS])
ARRAY_LOOP_MASKS: Dict[str, np.ndarray] = {
    array: np.array([name in ARRAY_LOOPS[array] for name in LOOPS])
    for array in ARRAY_DIMS
}


def out_writes_with_partial_sums_batch(layer: ConvLayer,
                                       parr: np.ndarray) -> np.ndarray:
    """Vectorized :func:`out_writes_with_partial_sums`: int64 [P]."""
    trips = trips_vector(layer)
    run = np.ones(parr.shape[0], dtype=np.int64)
    alive = np.ones(parr.shape[0], dtype=bool)
    for pos in range(parr.shape[1] - 1, -1, -1):
        ids = parr[:, pos]
        alive &= REDUCTION_MASK[ids]
        run = np.where(alive, run * trips[ids], run)
    return layer.iterations // run


def out_writes_with_partial_sums(layer: ConvLayer,
                                 perm: Sequence[int]) -> int:
    """Number of out[] memory writes when a register accumulator is used
    (thesis Fig 3.4): one write (plus one read, except on first visit) per
    *maximal innermost run of reduction loops*.  If the innermost k loops
    are all reduction loops with trip product R, out is touched
    iterations/R times; the accumulator covers the run."""
    trips = {"oc": layer.oc, "ic": layer.ic, "y": layer.h, "x": layer.w,
             "ky": layer.kh, "kx": layer.kw}
    run = 1
    for pos in range(len(perm) - 1, -1, -1):
        name = LOOPS[perm[pos]]
        if name in REDUCTION_LOOPS:
            run *= trips[name]
        else:
            break
    return layer.iterations // run
