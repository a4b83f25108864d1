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

``--session`` takes the JAX CLI's request and fault flags:
``--requests-file`` (JSON lines, ``{"prompt_len": N, "new_tokens": M}``
or ``{"tokens": [...], "new_tokens": M}``), ``--temperature`` (above 0
the session serves through the bucketed path, sampled),
``--cache-capacity``, ``--max-recompiles``, ``--request-deadline-s``,
``--max-queue-s`` and ``--inject-fault kind@step[xTIMES][.ROW]``
(repeatable; kinds compile, nan, alloc, slow, doublefree).  Each request
prints its terminal state and reason when it did not complete, and a
``faults:`` line sums the session's events.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b-smoke --session --inject-fault nan@1.0 \\
        --request-deadline-s 30 [--device cpu]

Observability (the JAX CLI's flags): ``--trace-out PATH`` writes a
Chrome trace-event / Perfetto JSON of the run (engine spans, one async
track per request), ``--metrics-out PATH`` the metrics in Prometheus
text; with ``--session``, ``--watchdog`` turns on drift detection over
the dispatch slots and ``--slo SPEC`` (repeatable, implies
``--watchdog``; ``ttft_p95<=S``, ``queue_p95<=S``, ``tok_s>=R``,
``error_rate<=F``) burn-rate SLOs, which print a ``watchdog:`` line, and
``--postmortem-dir DIR`` a flight recorder that dumps
``postmortem-<reason>.json`` bundles there on faults, SLO pages and
drift alarms (a ``postmortems:`` line names them).  Both artifacts pass
``tools/check_trace.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch phi3-mini-3.8b-smoke --session --dispatch \\
        --registry /tmp/x/t.jsonl --trace-out /tmp/x/trace.json \\
        --metrics-out /tmp/x/metrics.prom --slo 'ttft_p95<=10' \\
        --postmortem-dir /tmp/x/pm [--device cpu]

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
import json


def _requests(path, n, prompt_len, new_tokens, vocab, rng):
    """The requests of ``path`` (JSON lines), else the JAX CLI's
    synthetic mixed-shape stream around the shape args."""
    if path:
        reqs = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                toks = (d["tokens"] if "tokens" in d else
                        rng.integers(0, vocab, int(d["prompt_len"])).tolist())
                reqs.append((toks, int(d.get("new_tokens", new_tokens))))
        return reqs
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
                    help="seed of the random weights, prompts and "
                         "sampling noise")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="above 0: sample each token from softmax(logits "
                         "/ T) (with --session, through the bucketed "
                         "path)")
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
    ap.add_argument("--requests-file", default=None,
                    help="JSON-lines request stream for --session (one "
                         "{'prompt_len'|'tokens', 'new_tokens'} per "
                         "line); default: a synthetic mixed stream")
    ap.add_argument("--num-requests", type=int, default=12,
                    help="size of the synthetic --session stream")
    ap.add_argument("--batch-sizes", default="1,2,4,8",
                    help="allowed engine row counts (--session)")
    ap.add_argument("--cache-capacity", type=int, default=16,
                    help="LRU bound on cached (captured) steps "
                         "(--session)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="token slots per paged-KV pool block (--session, "
                         "attention families)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged-KV pool size in blocks (--session, "
                         "attention families)")
    ap.add_argument("--request-deadline-s", type=float, default=None,
                    help="per-request budget from submit; a blown one "
                         "finishes TIMED_OUT with partial tokens "
                         "(--session)")
    ap.add_argument("--max-queue-s", type=float, default=None,
                    help="load shedding: requests queued longer are shed "
                         "(TIMED_OUT) before admission (--session)")
    ap.add_argument("--inject-fault", action="append", default=None,
                    metavar="KIND@STEP",
                    help="deterministic fault injection, for tests "
                         "(kind@step[xTIMES][.ROW]; kinds: compile, nan, "
                         "alloc, slow, doublefree); repeatable (--session)")
    ap.add_argument("--max-recompiles", type=int, default=1,
                    help="decode recaptures a run may spend on dispatch "
                         "commits")
    ap.add_argument("--dispatch", action="store_true",
                    help="observe every step through the port's dispatch "
                         "service; with --backend cuda its committed "
                         "schedules run in the captured steps")
    ap.add_argument("--registry", default=None, metavar="PATH",
                    help="tuning registry: the serve_decode write-back, "
                         "and --dispatch's (default for --dispatch: the "
                         "port's default registry)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event / Perfetto JSON of "
                         "the run (engine spans + per-request tracks) "
                         "to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry in Prometheus text "
                         "exposition format to PATH")
    ap.add_argument("--watchdog", action="store_true",
                    help="enable the performance watchdog: online drift "
                         "detection over the dispatch slots (sustained "
                         "breaches reopen the slot for re-tuning) plus "
                         "SLO burn tracking (--session)")
    ap.add_argument("--slo", action="append", default=None,
                    metavar="SPEC",
                    help="declarative SLO, repeatable (implies "
                         "--watchdog): ttft_p95<=S, queue_p95<=S, "
                         "tok_s>=R, error_rate<=F (--session)")
    ap.add_argument("--postmortem-dir", default=None, metavar="DIR",
                    help="enable the flight recorder: faults, SLO "
                         "pages, and drift alarms dump a deterministic "
                         "postmortem-<reason>.json bundle into DIR "
                         "(--session)")
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
    from repro_torch.core.registry import TuningRegistry
    registry = TuningRegistry(args.registry) if args.registry else None
    telemetry = None
    if args.trace_out or args.metrics_out:
        from repro_torch.obs import Telemetry
        telemetry = Telemetry()
    dispatch = None
    if args.dispatch:
        from repro_torch.runtime.dispatch import DispatchService
        dispatch = DispatchService(
            registry if registry is not None
            else TuningRegistry.default(), device=dev,
            **({"metrics": telemetry.metrics, "tracer": telemetry.tracer}
               if telemetry is not None else {}))

    def write_telemetry() -> None:
        """The trace and the metrics, where the flags asked."""
        if telemetry is None:
            return
        if args.trace_out:
            telemetry.tracer.write(args.trace_out)
            print(f"trace written to {args.trace_out} "
                  f"(load in Perfetto or chrome://tracing)")
        if args.metrics_out:
            telemetry.metrics.write_prometheus(args.metrics_out)
            print(f"metrics written to {args.metrics_out}")

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
        from repro_torch.obs.events import format_event_summary
        from repro_torch.serving import FaultInjector, ServeSession
        watchdog = None
        if args.watchdog or args.slo:
            from repro_torch.obs import PerformanceWatchdog
            watchdog = PerformanceWatchdog(args.slo or ())
        recorder = None
        if args.postmortem_dir:
            from repro_torch.obs import FlightRecorder
            recorder = FlightRecorder(out_dir=args.postmortem_dir)
        session = ServeSession(
            model, params, backend=args.backend, registry=registry,
            batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")
                              if b.strip()),
            temperature=args.temperature,
            cache_capacity=args.cache_capacity,
            kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
            dispatch=dispatch, max_recompiles=args.max_recompiles,
            request_deadline_s=args.request_deadline_s,
            max_queue_s=args.max_queue_s,
            faults=(FaultInjector.from_strings(args.inject_fault)
                    if args.inject_fault else None),
            telemetry=telemetry, watchdog=watchdog, recorder=recorder)
        for toks, budget in _requests(args.requests_file,
                                      args.num_requests, args.prompt_len,
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
        if session.stats.events:
            print(format_event_summary(session.stats.events))
        # the last activation's steps (results come in completion order)
        last = next((r.stats for r in reversed(results)
                     if r.stats is not None), None)
        report(None if last is None else last.schedules)
        if watchdog is not None:
            wrep = watchdog.report()
            pages = sum(int(s["pages"]) for s in wrep["slo"].values())
            line = (f"watchdog: drift={wrep['drifts']} "
                    f"reopens={wrep['reopens']}/{wrep['retune_budget']} "
                    f"slo_pages={pages}")
            for name, s in sorted(wrep["slo"].items()):
                line += (f" | {s['spec']}: burn "
                         f"{s['burn_short']:.2f}/{s['burn_long']:.2f}"
                         f"{' PAGED' if s['paged'] else ''}")
            print(line)
        if recorder is not None and recorder.dumps:
            print("postmortems: " + ", ".join(
                f"{reason} x{n}"
                for reason, n in sorted(recorder.dumps.items()))
                + f" (in {recorder.out_dir}/)")
        write_telemetry()
        return

    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    out, stats = generate(
        model, params, {"tokens": tokens}, max_new_tokens=args.new_tokens,
        temperature=args.temperature,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        backend=args.backend, dispatch=dispatch, registry=registry,
        max_recompiles=args.max_recompiles)
    print(f"generated {out.shape}; prefill {stats.prefill_s*1e3:.1f}ms; "
          f"decode {stats.decode_tok_s:.0f} tok/s; "
          f"backend={stats.backend} recompiles={stats.recompiles}")
    report(stats.schedules)
    write_telemetry()


if __name__ == "__main__":
    main()
