"""End-to-end training: a ~100M-parameter LM for a few hundred steps on
the synthetic pipeline, with checkpoints and the straggler monitor (the
port's counterpart of the JAX package's ``examples/train_lm.py``).

Run:  PYTHONPATH=src python -m repro_torch.launch.train_lm   # 100M, 300 steps
      PYTHONPATH=src python -m repro_torch.launch.train_lm --small --device cpu
      PYTHONPATH=src python -m repro_torch.launch.train_lm --arch phi3-mini-3.8b-smoke

Trains on the CUDA card unless ``--device cpu``; with no card it
raises.  ``--ckpt-dir`` defaults to a ``repro_train_lm`` directory under
the system's temporary directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
from typing import Any, Dict, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import TrainConfig, Trainer

LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab_size=8192, dtype="float32",
    max_seq_len=1024)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train and print the parameter count and the final line; returns
    the trainer's output with ``tok_s`` (tokens over the mean step time
    but the first) added."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--small", action="store_true",
                    help="tiny model + few steps (CI)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--device", default=None,
                    help="'cpu' trains on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    if args.small:
        cfg = dataclasses.replace(LM_100M, n_layers=2, d_model=128,
                                  n_heads=4, n_kv_heads=4, d_ff=512,
                                  vocab_size=1024)
        args.steps, args.seq, args.batch = 20, 64, 4
    elif args.arch == "lm-100m":
        cfg = LM_100M
    else:
        cfg = get_config(args.arch)
    model = build_model(cfg)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M")

    tcfg = TrainConfig(steps=args.steps, ckpt_every=50,
                       log_every=10, ckpt_dir=args.ckpt_dir,
                       opt=AdamWConfig(lr=3e-4), warmup_steps=20,
                       device=args.device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    out = Trainer(model, tcfg, dcfg).run()
    hist = out["history"]
    toks = args.seq * args.batch
    avg_dt = sum(h["dt"] for h in hist[1:]) / max(len(hist) - 1, 1)
    out["tok_s"] = toks / avg_dt
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(first {hist[0]['loss']:.4f}); "
          f"{out['tok_s']:.0f} tok/s; stragglers={len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
