"""Fault tolerance: crash mid-training, restart from the atomic
checkpoint and continue, also with another data-shard layout (elastic
resume), which holds because the pipeline's global batch for step i is a
pure function of (seed, i).  The port's counterpart of the JAX package's
``examples/elastic_restart.py``.

Run:  PYTHONPATH=src python -m repro_torch.launch.elastic_restart [--device cpu]

Trains on the CUDA card unless ``--device cpu``; with no card it
raises.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, global_batch, shard_batch
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import TrainConfig, Trainer

ARCH = "minitron-4b-smoke"


def run(device=None) -> Dict[str, Any]:
    """Phase 1 trains 10 steps with checkpoints every 5 in a temporary
    directory, then "crashes"; phase 2, a fresh trainer, restores step
    10 and continues to 15; then the global batch is rebuilt from 2 and
    4 shards.  Returns both phases' outputs and the shard layouts'
    verdict."""
    dev = resolve_device(device)
    cfg = get_config(ARCH)
    model = build_model(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                      global_batch=8)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    try:
        t1 = Trainer(model, TrainConfig(
            steps=10, ckpt_every=5, log_every=5, ckpt_dir=ckpt_dir,
            opt=AdamWConfig(lr=1e-3), device=dev), dcfg)
        out1 = t1.run()
        print(f"phase 1: trained to step 10, "
              f"loss={out1['history'][-1]['loss']:.4f}  *** CRASH ***")

        t2 = Trainer(model, TrainConfig(
            steps=15, ckpt_every=5, log_every=5, ckpt_dir=ckpt_dir,
            opt=AdamWConfig(lr=1e-3), device=dev), dcfg)
        out2 = t2.run()
        first = out2["history"][0]
        print(f"phase 2: resumed at step {first['step']} "
              f"(expected 10), final loss "
              f"{out2['history'][-1]['loss']:.4f}")

        full = global_batch(dcfg, step=3)["tokens"]
        two = np.concatenate([shard_batch(
            {"tokens": full}, s, 2)["tokens"] for s in (0, 1)])
        four = np.concatenate([shard_batch(
            {"tokens": full}, s, 4)["tokens"] for s in range(4)])
        shards_equal = bool((two == full).all() and (four == full).all())
        if not shards_equal:
            raise RuntimeError("the global batch differs across shard "
                               "layouts")
        print("elastic sharding: global batch identical across "
              "1/2/4-shard layouts")
        return {"phase1": out1, "phase2": out2,
                "shards_equal": shards_equal}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse ``--device`` and :func:`run`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' trains on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
