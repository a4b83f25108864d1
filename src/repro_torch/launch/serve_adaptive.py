"""Adaptive serving: a small model end to end through the dispatch
service on the ServeSession API (the port's counterpart of the JAX
package's ``examples/serve_adaptive.py``).

Every prefill and decode step is timed and fed to the per-shape
scheduler (tune -> select -> observe); with ``--backend cuda`` the
steps run its committed kernel schedules.  The two ``generate`` calls
share one :class:`~repro_torch.serving.ServeSession`, so the second
reuses the first's steps (watch the cache's hits).  A direct
``matmul_dispatched`` call shares the same service.  At the end the
per-shape report shows what the traffic taught the registry.  The batch
is :func:`repro_torch.launch.serve_lm.make_batch`'s, the weights
``Model.init(seed=0)``'s.  Runs on the CUDA card unless ``--device
cpu``; with no card it raises.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_adaptive [--device cpu]
      PYTHONPATH=src python -m repro_torch.launch.serve_adaptive \\
          --arch falcon-mamba-7b-smoke --registry /tmp/tuning.jsonl
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.registry import TuningRegistry
from repro_torch.device import resolve_device
from repro_torch.kernels.matmul import matmul_dispatched
from repro_torch.launch.serve_lm import make_batch
from repro_torch.models import build_model
from repro_torch.runtime.dispatch import DispatchService
from repro_torch.runtime.serve_loop import generate
from repro_torch.serving import ServeSession


def run(model, params, batch: Dict[str, Any], new_tokens: int,
        backend: str = "cuda", registry_path: Optional[str] = None
        ) -> Dict[str, Any]:
    """The example on ``params`` (their device is the run's) and
    ``batch``: two ``generate`` calls through one session, four
    dispatched matmuls, the report.  Returns the tokens of both calls,
    their stats, the session cache's counters, the service's report and
    the registry's stats."""
    dev = params["embed"].device
    registry = TuningRegistry(registry_path)   # None: in memory
    service = DispatchService(registry, device=dev)
    session = ServeSession(model, params, dispatch=service,
                           backend=backend, registry=registry)

    out, stats = generate(model, params, batch, max_new_tokens=new_tokens,
                          session=session)
    print(f"arch={model.cfg.name} generated {out.shape}; "
          f"prefill {stats.prefill_s*1e3:.1f}ms, decode "
          f"{stats.decode_tok_s:.0f} tok/s; backend={stats.backend} "
          f"recompiles={stats.recompiles}")
    if stats.schedules is not None:
        live = {k: v for k, v in stats.schedules.items() if v is not None}
        print(f"compiled-step schedules: {json.dumps(live)}")

    out2, stats2 = generate(model, params, batch,
                            max_new_tokens=new_tokens, session=session)
    cache = session.exec_cache.stats()
    print(f"repeat call: {stats2.decode_tok_s:.0f} tok/s; session cache "
          f"hits={cache['hits']} misses={cache['misses']} "
          f"compiles={cache['compiles']}")

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(32, 48)).astype(np.float32))
    for _ in range(4):
        matmul_dispatched(a.to(dev), b.to(dev), service=service)

    report = service.report()
    print("\nper-shape dispatch report:")
    for entry in report.values():
        problem = ",".join(f"{k}={v}"
                           for k, v in sorted(entry["problem"].items()))
        committed = entry["committed"]
        status = (json.dumps(committed) if committed is not None
                  else f"probing ({entry['observations']} obs)")
        print(f"  {entry['kind']:18s} {problem:46s} -> {status}")
    reg_stats = registry.stats()
    print(f"\nregistry: {json.dumps(reg_stats, sort_keys=True)}",
          flush=True)
    return {"tokens": out, "tokens_repeat": out2, "stats": stats,
            "stats_repeat": stats2, "cache": cache, "report": report,
            "registry": reg_stats}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse the flags, build the model on the device, run the example."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b-smoke")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--registry", default=None,
                    help="persist what this run learns (default: "
                         "in-memory)")
    ap.add_argument("--backend", default="cuda", choices=("plain", "cuda"),
                    help="cuda: the steps run the committed schedules "
                         "(rebuilt on a commit)")
    ap.add_argument("--device", default=None,
                    help="'cpu' serves on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(seed=0, device=resolve_device(args.device))
    return run(model, params, make_batch(cfg, args.batch, args.prompt_len),
               args.new_tokens, args.backend, args.registry)


if __name__ == "__main__":
    main()
