"""ServeSession end to end: a mixed-shape request stream through the
persistent serving engine, for both model families (the port's
counterpart of the JAX package's ``examples/serve_session.py``).

Prompts and token budgets of mixed lengths are submitted to one
session; it serves them through its in-flight engine (dense, moe, ssm)
or its buckets, its cross-request executable cache (captured steps on
the card) and, with ``--backend cuda``, the dispatch service's
committed kernel schedules.  The prompts come from numpy (seed 0), the
weights from ``Model.init(seed=0)``.  Runs on the CUDA card unless
``--device cpu``; with no card it raises.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_session [--device cpu]
      PYTHONPATH=src python -m repro_torch.launch.serve_session \\
          --arch falcon-mamba-7b-smoke --num-requests 12 --device cpu
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.registry import TuningRegistry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.dispatch import DispatchService
from repro_torch.serving import ServeSession


def prompts(vocab: int, n_requests: int) -> List[tuple]:
    """``(prompt, max_new_tokens)`` of the stream: short and long
    prompts in turn, budgets 3 to 5 (numpy seed 0, as the JAX
    example)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n_requests):
        plen = (4 + i % 5) if i % 2 == 0 else (10 + i % 7)
        out.append((rng.integers(0, vocab, plen), 3 + i % 3))
    return out


def serve_stream(arch: str, n_requests: int, backend: str,
                 registry_path: Optional[str] = None, params=None,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Serve the stream on one session and print the example's summary;
    ``params`` (default: ``Model.init(seed=0)`` on ``device``) fixes the
    weights.  Returns ``{"results": ..., "stats": the stats dict}``."""
    cfg = get_config(arch)
    model = build_model(cfg)
    if params is None:
        params = model.init(seed=0, device=resolve_device(device))
    registry = TuningRegistry(registry_path)   # None: in memory
    service = DispatchService(registry, device=params["embed"].device)
    session = ServeSession(model, params, dispatch=service,
                           backend=backend, registry=registry,
                           batch_sizes=(1, 2, 4),
                           bucket_lengths=(8, 16, 32))
    for prompt, budget in prompts(cfg.vocab_size, n_requests):
        session.submit(prompt, max_new_tokens=budget)
    results = session.drain()

    print(f"== {arch} ({cfg.family}) ==")
    for r in results[:4]:
        print(f"  {r.request_id}: {len(r.tokens)} tokens via bucket "
              f"(b={r.bucket.batch}, p={r.bucket.prompt_len}, "
              f"t={r.bucket.total_len}), queued {r.queue_s*1e3:.0f}ms")
    if len(results) > 4:
        print(f"  ... {len(results) - 4} more")
    s = session.stats.to_dict()
    print(f"  {s['requests']} requests / {s['batches']} batches; "
          f"{s['decode_tok_s']:.0f} tok/s; "
          f"cache hit rate {s['cache_hit_rate']:.2f} "
          f"({s['cache']['compiles']} compiles); "
          f"re-AOTs {s['recompiles']} (+{s['free_switches']} free "
          f"switches); queue p50/p95 "
          f"{s['queue_p50_s']*1e3:.0f}/{s['queue_p95_s']*1e3:.0f}ms")
    print("  buckets: " + json.dumps(
        {k: round(v["tok_s"]) for k, v in s["buckets"].items()}),
        flush=True)
    return {"results": results, "stats": s}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    """Serve the stream for ``--arch``, or for a transformer and an SSM."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="serve one architecture (default: a "
                         "transformer AND an SSM, to show both "
                         "families)")
    ap.add_argument("--num-requests", type=int, default=16)
    ap.add_argument("--backend", default="cuda", choices=("plain", "cuda"))
    ap.add_argument("--registry", default=None,
                    help="persist what the stream learns (default: "
                         "in-memory)")
    ap.add_argument("--device", default=None,
                    help="'cpu' serves on the CPU; default: the CUDA card")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch
             else ["phi3-mini-3.8b-smoke", "falcon-mamba-7b-smoke"])
    return [serve_stream(arch, args.num_requests, args.backend,
                         args.registry, device=args.device)
            for arch in archs]


if __name__ == "__main__":
    main()
