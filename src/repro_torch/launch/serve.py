"""Serving launcher of the port: batched prefill + greedy decode, or the
in-flight engine with ``--session``.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b-smoke --batch 4 --prompt-len 16 \\
        --new-tokens 32 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b-smoke --session --num-requests 6 \\
        --batch-sizes 1,2,4 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b-smoke --session --num-requests 6 \\
        --batch-sizes 1,2,4 [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b-smoke --session --dispatch \\
        --registry /tmp/x/t.jsonl [--device cpu]

Both families run in both modes: ``phi3-mini-3.8b[-smoke]`` (dense, the
attention kernels) and ``falcon-mamba-7b[-smoke]`` (ssm, the
selective-scan kernel; the paged-KV flags do not apply to it).

``--dispatch`` runs the port's dispatch service (on ``--registry PATH``,
else the port's default registry): it observes every prefill and decode
step and, with ``--backend cuda``, its committed schedules key and
launch the captured steps, with at most one recapture a run.  The run then prints the schedules its last steps ran with
(``compiled-step schedules:``, the decode entry winning a kind both
roles share) and one ``dispatch`` line per slot with its committed
winner.

Weights are random, drawn from ``--seed``.  The run is on the CUDA card
unless ``--device cpu`` is given; without a card it fails.  Output lines
follow the JAX CLI's format for the flags the port keeps.
"""
import argparse


def _requests(n, prompt_len, new_tokens, vocab, rng):
    """The JAX CLI's synthetic mixed-shape stream around the shape args."""
    lens = [max(2, prompt_len // 2), prompt_len,
            max(3, (3 * prompt_len) // 4), prompt_len * 2]
    return [(rng.integers(0, vocab, lens[i % len(lens)]).tolist(),
             max(1, new_tokens // (1 + i % 2))) for i in range(n)]


def main(argv=None) -> None:
    """Parse the flags, build the model and serve."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch path on the CPU; "
                         "default: the CUDA card")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "plain"),
                    help="'cuda' runs the hand-written kernels (their "
                         "plain versions on the CPU); 'plain' the PyTorch "
                         "reference path")
    ap.add_argument("--session", action="store_true",
                    help="serve through the in-flight engine "
                         "(ServeSession)")
    ap.add_argument("--num-requests", type=int, default=12,
                    help="size of the synthetic --session stream")
    ap.add_argument("--batch-sizes", default="1,2,4,8",
                    help="allowed engine row counts (--session)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="token slots per paged-KV pool block (--session, "
                         "attention families)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged-KV pool size in blocks (--session, "
                         "attention families)")
    ap.add_argument("--dispatch", action="store_true",
                    help="observe every step through the port's dispatch "
                         "service; with --backend cuda its committed "
                         "schedules run in the captured steps")
    ap.add_argument("--registry", default=None, metavar="PATH",
                    help="tuning registry of --dispatch (default: the "
                         "port's default registry)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import device_identity, resolve_device
    from repro_torch.models import build_model
    from repro_torch.runtime import generate

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    params = model.init(seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    print(f"device: {device_identity(dev)}; arch {cfg.name}; "
          f"backend={args.backend}")
    dispatch = None
    if args.dispatch:
        from repro_torch.core.registry import TuningRegistry
        from repro_torch.runtime.dispatch import DispatchService
        dispatch = DispatchService(
            TuningRegistry(args.registry) if args.registry
            else TuningRegistry.default(), device=dev)

    def report(schedules) -> None:
        """The last steps' schedules and the service's slots."""
        if schedules is not None:
            live = {k: v for k, v in schedules.items() if v is not None}
            print(f"compiled-step schedules: {live}")
        if dispatch is not None:
            for entry in dispatch.report().values():
                committed = entry["committed"]
                print(f"dispatch {entry['kind']} {entry['problem']}: "
                      f"obs={entry['observations']} committed="
                      f"{committed if committed else '(probing)'}")

    if args.session:
        from repro_torch.serving import ServeSession
        session = ServeSession(
            model, params, backend=args.backend,
            batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")
                              if b.strip()),
            kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
            dispatch=dispatch)
        for toks, budget in _requests(args.num_requests, args.prompt_len,
                                      args.new_tokens, cfg.vocab_size,
                                      rng):
            session.submit(toks, max_new_tokens=budget)
        results = session.drain()
        for r in results:
            tail = "" if r.state == "COMPLETED" else (
                f" [{r.state}: {r.reason}]")
            print(f"{r.request_id}: {len(r.tokens)} tokens via "
                  f"bucket(b={r.bucket.batch}, p={r.bucket.prompt_len}, "
                  f"t={r.bucket.total_len}); queued {r.queue_s*1e3:.1f}ms"
                  f"{tail}")
        summary = session.stats.to_dict()
        if summary["steps"]:
            print(f"\nengine: {summary['steps']} decode steps, "
                  f"{summary['inflight_admissions']} in-flight "
                  f"admissions, {summary['compactions']} pool "
                  f"compactions")
        print(f"\nsession: {summary['requests']} requests in "
              f"{summary['batches']} batches; "
              f"{summary['decode_tok_s']:.0f} tok/s; cache hit rate "
              f"{summary['cache_hit_rate']:.2f} "
              f"({summary['cache']['compiles']} builds, "
              f"{summary['cache']['evictions']} evictions, "
              f"{summary['capture_s']:.2f}s building); recaptures "
              f"{summary['recompiles']}, free switches "
              f"{summary['free_switches']}; queue p50/p95 "
              f"{summary['queue_p50_s']*1e3:.1f}/"
              f"{summary['queue_p95_s']*1e3:.1f}ms; ttft p50/p95 "
              f"{summary['ttft_p50_s']*1e3:.1f}/"
              f"{summary['ttft_p95_s']*1e3:.1f}ms")
        for name, b in summary["buckets"].items():
            print(f"  bucket {name}: {b['tok_s']:.0f} tok/s over "
                  f"{int(b['batches'])} batches")
        # the last activation's steps (results come in completion order)
        last = next((r.stats for r in reversed(results)
                     if r.stats is not None), None)
        report(None if last is None else last.schedules)
        return

    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    out, stats = generate(model, params, {"tokens": tokens},
                          max_new_tokens=args.new_tokens,
                          backend=args.backend, dispatch=dispatch)
    print(f"generated {out.shape}; prefill {stats.prefill_s*1e3:.1f}ms; "
          f"decode {stats.decode_tok_s:.0f} tok/s; "
          f"backend={stats.backend} recompiles={stats.recompiles}")
    report(stats.schedules)


if __name__ == "__main__":
    main()
