"""Dense-vs-sparse algorithm policy (thesis §3.6 + §6.2, Fig 6.2), on
the H100 cost model.

The thesis' finding: the sparse algorithm wins only below a density
crossover, and dense regions concentrated on one core become
stragglers.  The two sides run different kernels on the card: the
dense conv and the block-sparse conv over the nonzero (oc, ic) blocks
(in bf16 both the implicit GEMM on the tensor cores, the sparse one at
the dense model's pixel tile for its skip block, ``sparse_pixel_tile``;
in float32 both on the CUDA cores).  So each side is timed by its own
kernel's model: the dense side by ``conv_schedule_cost``, the sparse
side by ``sparse_conv_schedule_cost_batch`` at the block density (its
nonzero steps scale with it), stretched by the nonzero imbalance
across output-channel blocks.  ``choose_algorithm`` makes the static pick;
``crossover_density`` is the break-even point the thesis plots (0 when
the sparse kernel never wins, 1 when it always does).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import cost_model as cm
from repro_torch.core.loopnest import ConvLayer
from repro_torch.kernels import _geometry as geo


@dataclasses.dataclass(frozen=True)
class SparsityDecision:
    """Dense-vs-sparse verdict with both predicted times."""

    algorithm: str              # "dense" | "sparse"
    dense_time_s: float
    sparse_time_s: float
    density: float
    imbalance: float


def sparse_time_estimate(sparse: cm.KernelCost, imbalance: float) -> float:
    """Expected sparse-kernel time from its own model at the block
    density: imbalance stretches the critical path (the busiest
    output-channel block), the launch does not stretch."""
    busy = max(sparse.compute_s, sparse.memory_s)
    return busy * imbalance + sparse.overhead_s


def _dense_block(layer: ConvLayer, block: Dict[str, int], grid_order,
                 spec: cm.H100Spec, elem_bytes: int,
                 batch: int = 1) -> Dict[str, int]:
    """The dense schedule's blocks: the given (oc, ic) and, where no
    pixel blocks are given, the dense kernel's cheapest pixel tile for
    them among the tuner's candidates (the whole image, as the JAX
    policy uses, does not fit a Hopper block), else the port's default
    pixel blocks."""
    from repro_torch.core.tuner import conv_blocks
    from repro_torch.kernels.conv2d.ops import default_block
    if "y" in block and "x" in block:
        return dict(block)
    cands = [b for b in conv_blocks(layer, elem_bytes)
             if (b["oc"], b["ic"]) == (block["oc"], block["ic"])]
    if cands:
        t = cm.conv_schedule_cost_batch(layer, [tuple(grid_order)], cands,
                                        spec, elem_bytes, batch).time_s[0]
        return cands[int(t.argmin())]
    dflt = default_block(layer.oc, layer.ic, layer.h, layer.w)
    return {"oc": block["oc"], "ic": block["ic"], "y": dflt["y"],
            "x": dflt["x"]}


def sparse_pixel_tile(layer: ConvLayer, boc: int, bic: int, batch: int = 1,
                      spec: cm.H100Spec = cm.H100Spec()
                      ) -> Optional[Tuple[int, int]]:
    """(by, bx) of the bf16 block-sparse body for skip block (boc, bic)
    at ``batch`` images: the dense conv model's cheapest pixel tile for
    that (oc, ic) (:func:`_dense_block`, which divides H and W, as the
    tensor-core body needs), or None when no pixel tile of it fits the
    sparse layout (the dense tile plus the oc block's index row)."""
    blk = _dense_block(layer, {"oc": boc, "ic": bic}, ("oc", "y", "x", "ic"),
                       spec, 2, batch)
    tile = geo.sparse_layout(boc, bic, blk["y"], blk["x"], layer.kh,
                             layer.kw, layer.ic // bic, 2)
    return (blk["y"], blk["x"]) if tile.error is None else None


def choose_algorithm(layer: ConvLayer, block: Dict[str, int],
                     density: float, imbalance: float = 1.0,
                     spec: cm.H100Spec = cm.H100Spec(),
                     grid_order=("oc", "y", "x", "ic"),
                     elem_bytes: int = 2, batch: int = 1) -> SparsityDecision:
    """Pick dense vs block-sparse conv by predicted time at ``density``
    for ``batch`` images."""
    dblock = _dense_block(layer, block, grid_order, spec, elem_bytes, batch)
    dense = cm.conv_schedule_cost(layer, grid_order, dblock, spec,
                                  elem_bytes, batch)
    skip = {"oc": block["oc"], "ic": block["ic"]}
    sparse = sparse_time_estimate(
        cm.sparse_conv_schedule_cost_batch(layer, [skip], density, batch,
                                           spec, elem_bytes).cost(0),
        imbalance)
    algo = "sparse" if sparse < dense.time_s else "dense"
    return SparsityDecision(algorithm=algo, dense_time_s=dense.time_s,
                            sparse_time_s=sparse, density=density,
                            imbalance=imbalance)


def crossover_density(layer: ConvLayer, block: Dict[str, int],
                      imbalance: float = 1.0,
                      spec: cm.H100Spec = cm.H100Spec(),
                      elem_bytes: int = 2, tol: float = 1e-3,
                      batch: int = 1) -> float:
    """Density at which sparse and dense predicted times cross
    (bisection; the thesis' Fig 6.2 break-even point): 0.0 when the
    sparse kernel is predicted slower even with no nonzero block, 1.0
    when it is predicted faster even at full density."""
    def sparse_wins(d):
        return choose_algorithm(layer, block, d, imbalance, spec,
                                elem_bytes=elem_bytes,
                                batch=batch).algorithm == "sparse"

    if not sparse_wins(0.0):
        return 0.0
    if sparse_wins(1.0):
        return 1.0
    lo, hi = 0.0, 1.0
    while hi - lo > tol:
        mid = (lo + hi) / 2
        if sparse_wins(mid):
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


__all__ = ["SparsityDecision", "choose_algorithm", "crossover_density",
           "sparse_pixel_tile", "sparse_time_estimate"]
