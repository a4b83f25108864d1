"""Dense-vs-sparse algorithm policy (thesis §3.6 + §6.2, Fig 6.2), on
the H100 cost model.

The thesis' finding: the sparse algorithm wins only below a density
crossover, and dense regions concentrated on one core become
stragglers.  The port's sparse kernel skips whole (oc, ic) blocks, so
its expected time scales with block density and with the nonzero
imbalance across output-channel blocks.  ``choose_algorithm`` makes the
static pick from the cost model; ``crossover_density`` is the
break-even point the thesis plots.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import cost_model as cm
from repro_torch.core.loopnest import ConvLayer


@dataclasses.dataclass(frozen=True)
class SparsityDecision:
    """Dense-vs-sparse verdict with both predicted times."""

    algorithm: str              # "dense" | "sparse"
    dense_time_s: float
    sparse_time_s: float
    density: float
    imbalance: float


def sparse_time_estimate(dense: cm.KernelCost, density: float,
                         imbalance: float,
                         check_overhead: float = 0.05) -> float:
    """Expected sparse-kernel time: compute and bytes scale with block
    density, the per-block bookkeeping adds a small overhead, and
    imbalance stretches the critical path."""
    busy = max(dense.compute_s, dense.memory_s)
    return busy * density * imbalance + dense.overhead_s * (1.0
                                                            + check_overhead)


def _dense_block(layer: ConvLayer, block: Dict[str, int]) -> Dict[str, int]:
    """The dense schedule's blocks: the given (oc, ic) and the port's
    default pixel blocks where none are given (the whole image, as the
    JAX policy uses, does not fit a Hopper block)."""
    from repro_torch.kernels.conv2d.ops import default_block
    dflt = default_block(layer.oc, layer.ic, layer.h, layer.w)
    return {"oc": block["oc"], "ic": block["ic"],
            "y": block.get("y", dflt["y"]), "x": block.get("x", dflt["x"])}


def choose_algorithm(layer: ConvLayer, block: Dict[str, int],
                     density: float, imbalance: float = 1.0,
                     spec: cm.H100Spec = cm.H100Spec(),
                     grid_order=("oc", "y", "x", "ic"),
                     elem_bytes: int = 2) -> SparsityDecision:
    """Pick dense vs block-sparse conv by predicted time at ``density``."""
    dense = cm.conv_schedule_cost(layer, grid_order,
                                  _dense_block(layer, block), spec,
                                  elem_bytes)
    sparse = sparse_time_estimate(dense, density, imbalance)
    algo = "sparse" if sparse < dense.time_s else "dense"
    return SparsityDecision(algorithm=algo, dense_time_s=dense.time_s,
                            sparse_time_s=sparse, density=density,
                            imbalance=imbalance)


def crossover_density(layer: ConvLayer, block: Dict[str, int],
                      imbalance: float = 1.0,
                      spec: cm.H100Spec = cm.H100Spec(),
                      elem_bytes: int = 2, tol: float = 1e-3) -> float:
    """Density at which sparse and dense predicted times cross
    (bisection; the thesis' Fig 6.2 break-even point)."""
    lo, hi = 0.0, 1.0
    while hi - lo > tol:
        mid = (lo + hi) / 2
        d = choose_algorithm(layer, block, mid, imbalance, spec,
                             elem_bytes=elem_bytes)
        if d.algorithm == "sparse":
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


__all__ = ["SparsityDecision", "choose_algorithm", "crossover_density",
           "sparse_time_estimate"]
