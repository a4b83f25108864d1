"""Design-space exploration, the thesis' Ch. 4/5 study in one command:
Table 4.1 layers, 720-permutation Loki sweeps, static candidates, top
pairs, random-sampling bounds, and locality-aware neighbour-swap search.

The port's counterpart of the JAX package's ``examples/tune_conv.py``,
printing the same sections.  Sweeps go through the port's tuning
registry (``~/.cache/repro_torch/tuning.jsonl`` or
``$REPRO_TORCH_TUNE_REGISTRY``): the first run computes them, every
later run, or ``python -m repro_torch.tune warm``, starts from cache.
Everything here is numpy on the host; no device is used.

Run:  PYTHONPATH=src python -m repro_torch.launch.tune_conv
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.squeezenet_layers import TABLE_4_1
from repro_torch.core import cost_model as cm
from repro_torch.core import tuner
from repro_torch.core.loopnest import LOOPS
from repro_torch.core.registry import TuningRegistry


def pname(p) -> str:
    """A permutation as its loop names, outermost first."""
    return "/".join(LOOPS[i] for i in p)


def main(registry: Optional[TuningRegistry] = None) -> Dict[str, float]:
    """Print the five sections; ``registry`` defaults to the port's
    default registry.  Returns the sweeps' host seconds and cost-model
    evaluations (0 on a warm registry) and the whole run's."""
    layers = dict(TABLE_4_1)
    registry = registry if registry is not None else \
        TuningRegistry.default()
    evals0 = cm.total_evals()
    t0 = time.perf_counter()
    sweeps = [tuner.cached_sweep_layer(l, registry=registry)
              for l in layers.values()]
    sweep_s = time.perf_counter() - t0
    sweep_evals = cm.total_evals() - evals0
    print(f"== {len(sweeps)} sweeps in {sweep_s * 1e3:.0f}ms "
          f"(registry: {len(registry)} records at {registry.path}) ==")

    print("== per-layer best permutations (Fig 4.3) ==")
    for (name, layer), sweep in zip(layers.items(), sweeps):
        b = int(np.argmin(sweep.cycles))
        w = int(np.argmax(sweep.cycles))
        print(f"  {name:18s} best={pname(tuner.ALL_PERMS[b]):22s} "
              f"worst/best={sweep.cycles[w]/sweep.cycles[b]:.2f}x")

    print("== static candidates (Fig 4.8) ==")
    for key, c in tuner.static_candidates(sweeps).items():
        print(f"  {key:15s} {pname(c.perm):22s} avg={c.avg_speedup:.3f} "
              f"worst={c.worst_speedup:.3f}")

    print("== top pair (Fig 5.3) ==")
    (a, b, avg, worst) = tuner.top_pairs(sweeps, n_best=1)[0]
    print(f"  {pname(a)} + {pname(b)}: avg={avg:.3f} worst={worst:.3f}")

    print("== random sampling (Fig 5.4) ==")
    for conf, label in ((0.683, "1-sigma"), (0.954, "2-sigma")):
        k = tuner.sample_size_for_confidence(sweeps, 0.9, conf)
        print(f"  {label}: {k} random perms for a >=0.9-optimal pick")

    print("== neighbour-swap search vs exhaustive (§7.2) ==")
    layer = layers["initial-conf"]
    score_batch = tuner.batch_perm_scorer(layer)
    exhaustive = float(cm.simulate_batch(layer, tuner.ALL_PERMS)
                       .cycles.min())
    p, s, evals = tuner.neighbor_swap_search(None, (0, 1, 2, 3, 4, 5),
                                             score_batch=score_batch)
    p2, s2, evals2 = tuner.bfs_search(None, (0, 1, 2, 3, 4, 5), budget=80,
                                      score_batch=score_batch)
    print(f"  greedy:   {pname(p):22s} {s/exhaustive:.3f}x-opt "
          f"in {evals} evals (vs 720)")
    print(f"  best-first: {pname(p2):20s} {s2/exhaustive:.3f}x-opt "
          f"in {evals2} evals")
    return {"sweep_s": sweep_s, "sweep_evals": sweep_evals,
            "seconds": time.perf_counter() - t0,
            "evals": cm.total_evals() - evals0}


if __name__ == "__main__":
    main()
