"""Training launcher of the port (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b-smoke --steps 50 --seq 128 --batch 8 \\
        --ckpt-dir /tmp/run1 [--device cpu]

Trains on the CUDA card unless ``--device cpu``; with no card it
raises.  A restart resumes from the latest checkpoint in ``--ckpt-dir``
automatically.  ``--registry`` receives the ``train_step`` measurement
(``python -m repro_torch.tune --registry FILE inspect --kind
train_step`` shows it).  The JAX launcher's ``--devices`` and
``--mesh`` come with the port's sharding.
"""
from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse the flags, train, print the ``done:`` line; returns the
    trainer's output."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--registry", default=None,
                    help="tuning-registry path: measured step times are "
                         "written back for later runs/inspection")
    ap.add_argument("--device", default=None,
                    help="'cpu' trains on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = get_config(args.arch)
    model = build_model(cfg)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       opt=AdamWConfig(lr=args.lr), seed=args.seed,
                       registry_path=args.registry, device=args.device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    out = Trainer(model, tcfg, dcfg).run()
    h = out["history"]
    print(f"done: steps={len(h)} first_loss={h[0]['loss']:.4f} "
          f"final_loss={h[-1]['loss']:.4f} "
          f"stragglers={len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
