"""Training launcher of the port (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b-smoke --steps 50 --seq 128 --batch 8 \\
        --ckpt-dir /tmp/run1 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi3-mini-3.8b-smoke --steps 4 --seq 32 --batch 4 \\
        --devices 4 --mesh 2x2 --device cpu

Trains on the CUDA card unless ``--device cpu``; with no card it
raises.  A restart resumes from the latest checkpoint in ``--ckpt-dir``
automatically.  ``--registry`` receives the ``train_step`` measurement
(``python -m repro_torch.tune --registry FILE inspect --kind
train_step`` shows it).

``--mesh DxM`` trains on a ``(data, model)`` mesh of D x M devices
(:class:`~repro_torch.runtime.train_loop.Trainer` with ``mesh=``): over
NCCL on the cards (rank r on ``cuda:r``; ``1x1`` on one card), or over
``gloo`` on the CPU with ``--device cpu``.  ``--devices N`` is the
counterpart of JAX's host placeholder devices: N CPU processes over
``gloo`` (it implies the CPU), of which the mesh takes the first D x M;
without ``--mesh`` the run is unmeshed, as in JAX.  A world of one runs
in this process; a larger one starts one process a rank, which share a
``FileStore`` in a temporary directory, and rank 0 prints the ``done:``
line.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import os
import tempfile
from typing import Any, Dict, Optional, Sequence, Tuple


def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    """The launcher's flags."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--devices", type=int, default=0,
                    help="N CPU processes over gloo (0 = real devices)")
    ap.add_argument("--mesh", default=None, help="e.g. 2x2 (data x model)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--registry", default=None,
                    help="tuning-registry path: measured step times are "
                         "written back for later runs/inspection")
    ap.add_argument("--device", default=None,
                    help="'cpu' trains on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)
    if args.devices:
        if args.device not in (None, "cpu"):
            ap.error("--devices runs CPU processes; it takes no "
                     f"--device {args.device}")
        args.device = "cpu"
    return args


def _mesh_shape(args: argparse.Namespace) -> Optional[Tuple[int, ...]]:
    """The ``--mesh`` shape, checked against ``--devices``."""
    if not args.mesh:
        return None
    shape = tuple(int(x) for x in args.mesh.split("x"))
    if args.devices and math.prod(shape) > args.devices:
        raise ValueError(f"mesh {args.mesh} needs {math.prod(shape)} "
                         f"devices, --devices gives {args.devices}")
    return shape


def _train(args: argparse.Namespace, mesh=None) -> Dict[str, Any]:
    """Build the trainer (on ``mesh`` when given) and run it."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = get_config(args.arch)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       opt=AdamWConfig(lr=args.lr), seed=args.seed,
                       registry_path=args.registry, device=args.device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    return Trainer(build_model(cfg), tcfg, dcfg, mesh=mesh).run()


def _report(out: Dict[str, Any]) -> None:
    """Print the ``done:`` line."""
    h = out["history"]
    print(f"done: steps={len(h)} first_loss={h[0]['loss']:.4f} "
          f"final_loss={h[-1]['loss']:.4f} "
          f"stragglers={len(out['stragglers'])}", flush=True)


def _meshed(rank: int, world: int, args: argparse.Namespace,
            shape: Tuple[int, ...], store: Optional[str],
            result: Optional[str]) -> Optional[Dict[str, Any]]:
    """One rank of a meshed run: start the group, train, report (rank
    0), close the group."""
    from repro_torch.launch.mesh import close_group, init_group, make_mesh
    from repro_torch.device import resolve_device

    backend = "gloo" if resolve_device(args.device).type == "cpu" \
        else "nccl"
    init_group(backend, rank=rank, world_size=world, store_path=store)
    try:
        out = _train(args, make_mesh(shape, ("data", "model")))
        if rank == 0:
            _report(out)
            if result is not None:
                with open(result, "w") as f:
                    json.dump({"history": out["history"],
                               "stragglers": out["stragglers"]}, f)
        return out
    finally:
        close_group()


def _rank_main(rank: int, world: int, args: argparse.Namespace,
               shape: Tuple[int, ...], store: str, result: str) -> None:
    """Entry of a started rank process."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    _meshed(rank, world, args, shape, store, result)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse the flags, train, print the ``done:`` line; returns the
    trainer's output (of rank 0 when ranks run in processes of their
    own: its history and straggler events)."""
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    shape = _mesh_shape(args)
    if shape is None:
        out = _train(args)
        _report(out)
        return out
    world = math.prod(shape)
    if world == 1:
        return _meshed(0, 1, args, shape, None, None)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_train_") as d:
        result = os.path.join(d, "rank0.json")
        mp.start_processes(_rank_main, args=(world, args, shape,
                                             os.path.join(d, "store"),
                                             result),
                           nprocs=world, join=True, start_method="spawn")
        with open(result) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
