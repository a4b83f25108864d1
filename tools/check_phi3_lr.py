"""Does full-width phi3-mini-3.8b train at lr 3e-4 in both packages?

Both packages' ``Trainer`` run phi3-mini-3.8b at full width (d_model
3072, 32 heads, d_ff 8192, vocab 32064) cut to 2 layers, in float32, at
lr 3e-4 (warmup 2, the chip cell's schedule) on the same data (batch 4,
seq 512, seed 0), from one step-0 checkpoint that the JAX package
writes (its init and a fresh AdamW state) and both restore.  Each
package runs in a process of its own, one after the other, so the
memory of only one is held at a time (about 10 GB).  The losses are
held to each other within ``RUN_RTOL`` relative; the verdict says
whether both, one or neither diverges (a final loss above the first).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/check_phi3_lr.py \\
        [--steps 8] [--out DIR]

Prints one JSON line per package and a verdict line; exits 1 when the
losses disagree.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

RUN_RTOL = 1e-4
LAYERS, LR, WARMUP, BATCH, SEQ = 2, 3e-4, 2, 4, 512


def _cfg(pkg):
    """The cut config from package ``pkg``'s registry."""
    import dataclasses
    return dataclasses.replace(pkg.get_config("phi3-mini-3.8b"),
                               n_layers=LAYERS, dtype="float32")


def run_jax(ckpt: str, steps: int) -> list:
    """Write the step-0 checkpoint (first call) and train with JAX."""
    import jax
    from repro import configs
    from repro.checkpoint import Checkpointer
    from repro.data import DataConfig
    from repro.models import build_model
    from repro.optim import adamw
    from repro.runtime.train_loop import TrainConfig, Trainer

    cfg = _cfg(configs)
    model = build_model(cfg)
    if not os.listdir(ckpt):
        params, _ = model.init(jax.random.key(0))
        Checkpointer(ckpt).save(0, {"params": params,
                                    "opt": adamw.init(params)})
    tcfg = TrainConfig(steps=steps, ckpt_every=10 ** 6, log_every=1,
                       ckpt_dir=ckpt, opt=adamw.AdamWConfig(lr=LR),
                       warmup_steps=WARMUP)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=0)
    return [h["loss"] for h in Trainer(model, tcfg, dcfg).run()["history"]]


def run_torch(ckpt: str, steps: int) -> list:
    """Train with the port on the CPU from the same checkpoint."""
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = _cfg(configs)
    tcfg = TrainConfig(steps=steps, ckpt_every=10 ** 6, log_every=1,
                       ckpt_dir=ckpt, opt=adamw.AdamWConfig(lr=LR),
                       warmup_steps=WARMUP, device="cpu")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      global_batch=BATCH, seed=0)
    out = Trainer(build_model(cfg), tcfg, dcfg).run()
    return [h["loss"] for h in out["history"]]


def main() -> int:
    """Run both packages in child processes and compare."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", choices=("jax", "torch"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.only:
        fn = run_jax if args.only == "jax" else run_torch
        print(json.dumps({"package": args.only,
                          "losses": fn(args.ckpt, args.steps)}))
        return 0
    out_dir = args.out or tempfile.mkdtemp(prefix="phi3_lr_")
    ckpt = os.path.join(out_dir, "ckpt")
    os.makedirs(ckpt, exist_ok=True)
    losses = {}
    for pkg in ("jax", "torch"):
        proc = subprocess.run(
            [sys.executable, __file__, "--only", pkg, "--ckpt", ckpt,
             "--steps", str(args.steps)], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        losses[pkg] = line["losses"]
        print(json.dumps(line))
    j, t = losses["jax"], losses["torch"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(j, t))
    diverges = {k: v[-1] > v[0] for k, v in losses.items()}
    print(json.dumps({"max_rel_diff": rel, "rtol": RUN_RTOL,
                      "diverges": diverges, "layers": LAYERS, "lr": LR,
                      "batch": BATCH, "seq": SEQ, "dtype": "float32"}))
    return 0 if rel <= RUN_RTOL else 1


if __name__ == "__main__":
    sys.exit(main())
