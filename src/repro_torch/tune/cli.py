"""Implementation of the ``python -m repro_torch.tune`` registry CLI.

The JAX package's ``repro.tune`` commands over the port's registry
(``$REPRO_TORCH_TUNE_REGISTRY``): ``warm`` fills it with Loki sweeps and
H100 conv schedules, ``ecm`` runs the three-tier sweep, ``serve-report``
and ``doctor`` read the measured-against-predicted ratio of every
schedule record the port's dispatch service and the ``serve_decode``
and ``train_step`` write-backs leave, ``merge``/``sync`` are the fleet union.  Only ``sync``
touches a device (the runtime fingerprint it stamps): on the card unless
``--device cpu``."""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.core import cost_model as cm
from repro_torch.core import registry as reg
from repro_torch.core import tuner

CONFIG_SETS = {
    "squeezenet_layers": "TABLE_4_1 (thesis Table 4.1: SqueezeNet + "
                         "TinyDarknet layers)",
    "synthetic": "Table 4.2 synthetic design space (216 layers)",
    "synthetic_mt": "Table 4.3 multi-thread design space (36 layers)",
}


def _load_layers(name: str):
    from repro_torch.configs import squeezenet_layers as sq
    if name == "squeezenet_layers":
        return list(sq.TABLE_4_1.values())
    if name == "synthetic":
        return sq.synthetic_design_space()
    if name == "synthetic_mt":
        return sq.synthetic_design_space_mt()
    raise SystemExit(
        f"unknown --config {name!r}; choose from {sorted(CONFIG_SETS)}")


def _registry(args) -> reg.TuningRegistry:
    if args.registry:
        return reg.TuningRegistry(args.registry)
    return reg.TuningRegistry.default()


def _fmt_problem(p: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(p.items()))


def cmd_warm(args) -> int:
    import time
    registry = _registry(args)
    layers = _load_layers(args.config)
    kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
    evals_before = cm.total_evals()
    t0 = time.perf_counter()
    done = tuner.warm_registry(
        layers, registry, threads=args.threads, top_k=args.top_k,
        elem_bytes=args.elem_bytes, kinds=kinds, refresh=args.refresh)
    dt = time.perf_counter() - t0
    evals = cm.total_evals() - evals_before
    print(f"warmed {args.config}: "
          + ", ".join(f"{k}={v}" for k, v in done.items())
          + f"; registry now has {len(registry)} records"
          + (f" at {registry.path}" if registry.path else " (in memory)"))
    print(f"batch engine: {evals} cost-model evals in {dt:.3f}s "
          f"({evals / max(dt, 1e-9):,.0f} evals/s)")
    return 0


def cmd_inspect(args) -> int:
    registry = _registry(args)
    rows = 0
    for rec in registry.records():
        if args.kind and rec.key.kind != args.kind:
            continue
        meas = ""
        if rec.measured is not None:
            meas = f" measured={rec.measured.get('time_s', float('nan')):.3e}s"
        pred = ""
        costs = rec.value.get("costs")
        if costs:
            c = reg.cost_from_dict(costs[0])
            pred = f" predicted={c.time_s:.3e}s"
        print(f"{rec.key.kind:16s} {_fmt_problem(rec.key.problem_dict()):48s}"
              f" machine={rec.key.machine} cm={rec.key.cost_model}"
              f" src={rec.source}{pred}{meas}")
        rows += 1
    print(f"-- {rows} records"
          + (f" ({registry.path})" if registry.path else ""))
    return 0


def cmd_stats(args) -> int:
    """Summary counts, including per-cost-model-tier provenance
    (``by_tier``: roofline / ecm / exact / other)."""
    registry = _registry(args)
    print(json.dumps(registry.stats(), indent=2, sort_keys=True))
    return 0


def cmd_ecm(args) -> int:
    """Run (and inspect) the three-tier ECM sweep over a layer set.

    Tier 1 (batch roofline) and tier 2 (ECM layer conditions) score the
    whole space; the exact trace simulator is consulted only for layers
    where the two disagree beyond ``--tolerance`` on the union of their
    top-``--top-k`` short-lists — and then only on those candidates.
    Winners are persisted under ``ecm_sweep`` keys with their deciding
    tier stamped, so ``stats`` shows the provenance split."""
    import time
    from repro_torch.core.loopnest import LOOPS

    registry = _registry(args)
    layers = _load_layers(args.config)
    if args.limit:
        layers = layers[:args.limit]
    if args.hierarchy:
        try:
            machine = cm.HIERARCHIES[args.hierarchy]
        except KeyError:
            raise SystemExit(f"unknown --hierarchy {args.hierarchy!r}; "
                             f"choose from {sorted(cm.HIERARCHIES)}")
    else:
        machine = cm.MachineModel()

    from repro_torch.core import ecm as ecm_model
    correction = ecm_model.load_correction(machine, registry)
    cm.reset_eval_counts()
    t0 = time.perf_counter()
    result = tuner.ecm_sweep(
        layers, machine, threads=args.threads, top_k=args.top_k,
        tolerance=args.tolerance, correction=correction,
        max_exact_iters=args.max_exact_iters, workers=args.workers,
        consult=not args.no_exact, registry=registry)
    dt = time.perf_counter() - t0

    for layer, (perm, cycles), tier, cons in zip(
            result.layers, result.best, result.tiers, result.consulted):
        order = ">".join(LOOPS[i] for i in perm)
        extra = f" (exact on {len(cons)} candidates)" if cons else ""
        print(f"{_fmt_problem(reg.loki_problem(layer)):48s}"
              f" best={order:17s} tier={tier:5s}"
              f" cycles={cycles:.3e}{extra}")
    n_scored = len(result.layers) * len(result.perms)
    n_traced = sum(len(c) for c in result.consulted)
    print(f"-- {len(result.layers)} layers x {len(result.perms)} perms "
          f"scored in {dt:.3f}s; exact consultation rate "
          f"{result.consultation_rate:.2%} "
          f"({n_traced} traces / {n_scored} candidates)"
          + (f"; correction={correction.n_samples}-sample fit"
             if correction else "; no learned correction in registry"))
    return 0


def cmd_export(args) -> int:
    registry = _registry(args)
    if args.out == "-":
        recs = [r.to_dict() for r in registry.records()]
        json.dump(recs, sys.stdout, indent=2, sort_keys=True)
        print()
        n = len(recs)
    else:
        n = registry.export_json(args.out)
        print(f"exported {n} records to {args.out}")
    return 0


def _stamp_and_evict(registry: reg.TuningRegistry,
                     arriving_machines, now,
                     evict_days: Optional[int],
                     extra_dates=None) -> int:
    """Shared merge/sync bookkeeping: stamp last-seen dates for machine
    fingerprints (arriving ones at ``now``; ``extra_dates`` — e.g.
    sidecars travelling with sync snapshots — merged by max date;
    resident ones grandfathered to ``now`` if the sidecar predates
    them) and evict records whose machine has not been seen for
    ``evict_days`` days.  Compacts."""
    import datetime
    seen = reg.load_machine_seen(registry.path)
    for fp, d in (extra_dates or {}).items():
        prev = seen.get(fp)
        seen[fp] = max(prev, d) if prev else d
    for fp in arriving_machines:
        prev = seen.get(fp)
        seen[fp] = max(prev, now.isoformat()) if prev else now.isoformat()
    for fp in registry.machines():
        seen.setdefault(fp, now.isoformat())

    evicted = 0
    if evict_days is not None:
        cutoff = (now - datetime.timedelta(days=evict_days)).isoformat()
        doomed = sorted(fp for fp, d in seen.items() if d < cutoff)
        for fp in doomed:
            evicted += registry.invalidate(machine=fp, persist=False)
            del seen[fp]
    reg.save_machine_seen(registry.path, seen)
    registry.compact()
    return evicted


def cmd_merge(args) -> int:
    """Content-addressed union with another registry + staleness
    eviction (the fleet-sync story: hosts export their JSONL, any host
    merges them in; records whose machine fingerprint has not been seen
    for ``--evict-days`` days are dropped)."""
    import datetime
    registry = _registry(args)
    if registry.path is None:
        raise SystemExit("merge needs an on-disk registry (--registry)")
    other = reg.TuningRegistry(args.other)
    stats = registry.merge(other)

    now = (datetime.date.fromisoformat(args.now) if args.now
           else datetime.date.today())
    # Fingerprints arriving in the merged-in registry were just seen on
    # its host; fingerprints already here keep their stamp (defaulting
    # to today so pre-sidecar registries are grandfathered, not purged).
    evicted = _stamp_and_evict(registry, other.machines(), now,
                               args.evict_days)
    print(f"merged {args.other}: "
          + ", ".join(f"{k}={v}" for k, v in sorted(stats.items()))
          + f"; evicted {evicted} stale records"
          + f"; registry now has {len(registry)} records")
    return 0


def cmd_sync(args) -> int:
    """Fleet sync transport (ROADMAP item): one rsync/object-store
    -friendly round built on the ``merge`` union policy.

    ``--import-dir`` merges every ``*.jsonl`` snapshot found in a shared
    directory into this registry (content-addressed union, deterministic
    conflict rule, optional ``--evict-days``); ``--export-dir`` then
    writes this registry's canonical bytes as
    ``host-<fingerprint>.jsonl`` — each host owns exactly one
    deterministic file name, so `rsync`/object-store sync of the
    directory converges the fleet without coordination.

    Staleness propagates correctly through union snapshots: each host
    stamps only its OWN live fingerprints at sync time and ships its
    last-seen sidecar next to the snapshot; importers merge sidecars by
    max date.  A dead host therefore stops advancing its dates
    fleet-wide (even though its records keep riding along inside other
    hosts' union snapshots) and ``--evict-days`` eventually drops it
    everywhere.  A typical cron/daemon tick is a single command::

        python -m repro_torch.tune sync --import-dir /mnt/fleet \\
            --export-dir /mnt/fleet --evict-days 30
    """
    import datetime
    import glob
    import shutil

    registry = _registry(args)
    if registry.path is None:
        raise SystemExit("sync needs an on-disk registry (--registry)")
    if not (args.export_dir or args.import_dir):
        raise SystemExit("sync needs --export-dir and/or --import-dir")
    now = (datetime.date.fromisoformat(args.now) if args.now
           else datetime.date.today())

    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    own_name = (args.snapshot_name
                or f"host-{reg.runtime_fingerprint(device)}.jsonl")
    merged = {"added": 0, "replaced": 0, "kept": 0, "identical": 0}
    sidecar_dates: dict = {}
    imported = 0
    if args.import_dir:
        same_dir = (args.export_dir is not None
                    and os.path.abspath(args.export_dir)
                    == os.path.abspath(args.import_dir))
        own = (os.path.abspath(os.path.join(args.import_dir, own_name))
               if same_dir else None)
        for path in sorted(glob.glob(os.path.join(args.import_dir,
                                                  "*.jsonl"))):
            if own and os.path.abspath(path) == own:
                continue  # this host's own snapshot: nothing to learn
            other = reg.TuningRegistry(path)
            stats = registry.merge(other)
            for k, v in stats.items():
                merged[k] = merged.get(k, 0) + v
            for fp, d in reg.load_machine_seen(path).items():
                prev = sidecar_dates.get(fp)
                sidecar_dates[fp] = max(prev, d) if prev else d
            imported += 1
    # Stamp only fingerprints this host IS (runtime, current spec, and the
    # two together, which its measured records carry) — blanket-stamping
    # every fingerprint inside a union snapshot would keep dead hosts
    # alive forever.
    own_fps = {reg.runtime_fingerprint(device),
               reg.fingerprint(cm.H100Spec()),
               reg.machine_key(cm.H100Spec(), device)}
    evicted = _stamp_and_evict(registry, sorted(own_fps), now,
                               args.evict_days,
                               extra_dates=sidecar_dates)
    if imported or args.evict_days is not None:
        print(f"imported {imported} snapshot(s): "
              + ", ".join(f"{k}={v}" for k, v in sorted(merged.items()))
              + f"; evicted {evicted} stale records"
              + f"; registry now has {len(registry)} records")

    if args.export_dir:
        os.makedirs(args.export_dir, exist_ok=True)
        out = os.path.join(args.export_dir, own_name)
        # compact() above canonicalised the file: the snapshot bytes are
        # a pure function of the record set, so an unchanged registry
        # re-exports byte-identical content (rsync sees a no-op).
        shutil.copyfile(registry.path, out)
        sidecar = reg.machine_seen_path(registry.path)
        if os.path.exists(sidecar):
            shutil.copyfile(sidecar, reg.machine_seen_path(out))
        print(f"exported {len(registry)} records to {out}")
    return 0


def cmd_serve_report(args) -> int:
    """Per-shape report of what the adaptive dispatch runtime has
    learned: offline predictions vs run-time measurements for every
    kernel-schedule record (plus serve/train step measurements)."""
    registry = _registry(args)
    schedule_kinds = ("conv_schedule", "matmul_schedule",
                      "flash_attention_schedule",
                      "decode_attention_schedule", "ssm_scan_schedule",
                      "sparse_conv_schedule")
    runtime_kinds = ("serve_decode", "train_step")
    rows = measured = 0
    print(f"{'kind':26s} {'problem':44s} {'predicted':>11s} "
          f"{'measured':>11s} {'ratio':>7s} src")
    for rec in registry.records():
        kind = rec.key.kind
        if kind not in schedule_kinds and kind not in runtime_kinds:
            continue
        if args.kind and kind != args.kind:
            continue
        # Predicted time of the schedule the measurement belongs to (the
        # committed winner may not be the offline rank-0 pick); fall
        # back to rank 0 for measurement-free records.  Measurement-only
        # records (adaptive write-back on shapes offline tuning never
        # saw) carry no predicted cost at all, and fleet-merged
        # registries can carry cost dicts from other writers — neither
        # may crash the report, so every predicted-side access degrades
        # to "-" instead of raising.
        pred = None
        value = rec.value if isinstance(rec.value, dict) else {}
        meas_rec = rec.measured if isinstance(rec.measured, dict) else {}
        costs = value.get("costs") or []
        scheds = value.get("schedules") or []
        best = meas_rec.get("best")
        if costs:
            idx = scheds.index(best) if best in scheds[:len(costs)] else 0
            try:
                pred = float(reg.cost_from_dict(costs[idx]).time_s)
            except (TypeError, ValueError, KeyError):
                pred = None
        meas = meas_rec.get("time_s")
        if not isinstance(meas, (int, float)):
            # legacy writers stored the bare time under ``measured``
            meas = rec.measured if isinstance(rec.measured,
                                              (int, float)) else None
        ratio = (meas / pred) if (pred and meas is not None) else None
        measured += meas is not None
        rows += 1
        fmt = lambda v, f: ("-" if v is None else f % v)  # noqa: E731
        print(f"{kind:26s} {_fmt_problem(rec.key.problem_dict()):44s} "
              f"{fmt(pred, '%.3e'):>11s} {fmt(meas, '%.3e'):>11s} "
              f"{fmt(ratio, '%.2f'):>7s} {rec.source}")
    print(f"-- {rows} serving-path records, {measured} with run-time "
          f"measurements"
          + (f" ({registry.path})" if registry.path else ""))
    return 0


def cmd_doctor(args) -> int:
    """Offline drift report: flag registry records whose run-time
    measurement disagrees with the offline prediction.

    The online half lives in
    :class:`repro_torch.obs.watchdog.PerformanceWatchdog` (sustained breach →
    reopen the slot); ``doctor`` is the post-hoc view over a persisted
    registry — the same measured/predicted extraction as
    ``serve-report``, with a verdict column: ``DRIFT`` when the ratio
    leaves ``[1/ratio, ratio]``, ``ok`` inside the band, ``unmeasured``
    when only the prediction exists.  ``--metrics`` folds in a JSON
    metrics snapshot from a live run (``tune metrics --format json`` or
    a benchmark artifact) and reports the ``watchdog.*`` / ``slo.*``
    counters it carries; ``--fail-on-drift`` exits non-zero for CI.
    """
    registry = _registry(args)
    schedule_kinds = ("conv_schedule", "matmul_schedule",
                      "flash_attention_schedule",
                      "decode_attention_schedule", "ssm_scan_schedule",
                      "sparse_conv_schedule")
    runtime_kinds = ("serve_decode", "train_step")
    lo, hi = 1.0 / args.ratio, args.ratio
    rows = drifted = unmeasured = 0
    print(f"{'kind':26s} {'problem':44s} {'predicted':>11s} "
          f"{'measured':>11s} {'ratio':>7s} verdict")
    for rec in registry.records():
        kind = rec.key.kind
        if kind not in schedule_kinds and kind not in runtime_kinds:
            continue
        if args.kind and kind != args.kind:
            continue
        # Same degrade-to-"-" extraction as cmd_serve_report: predicted
        # time of the measured winner (rank 0 fallback), measurement
        # with the legacy bare-number fallback.
        pred = None
        value = rec.value if isinstance(rec.value, dict) else {}
        meas_rec = rec.measured if isinstance(rec.measured, dict) else {}
        costs = value.get("costs") or []
        scheds = value.get("schedules") or []
        best = meas_rec.get("best")
        if costs:
            idx = scheds.index(best) if best in scheds[:len(costs)] else 0
            try:
                pred = float(reg.cost_from_dict(costs[idx]).time_s)
            except (TypeError, ValueError, KeyError):
                pred = None
        meas = meas_rec.get("time_s")
        if not isinstance(meas, (int, float)):
            meas = rec.measured if isinstance(rec.measured,
                                              (int, float)) else None
        ratio = (meas / pred) if (pred and meas is not None) else None
        if ratio is None:
            verdict = "unmeasured"
            unmeasured += 1
        elif ratio > hi or ratio < lo:
            verdict = "DRIFT"
            drifted += 1
        else:
            verdict = "ok"
        rows += 1
        fmt = lambda v, f: ("-" if v is None else f % v)  # noqa: E731
        print(f"{kind:26s} {_fmt_problem(rec.key.problem_dict()):44s} "
              f"{fmt(pred, '%.3e'):>11s} {fmt(meas, '%.3e'):>11s} "
              f"{fmt(ratio, '%.2f'):>7s} {verdict}")
    print(f"-- {rows} records checked: {drifted} drifted (band "
          f"[{lo:.2f}, {hi:.2f}]), {unmeasured} unmeasured"
          + (f" ({registry.path})" if registry.path else ""))
    if args.metrics:
        with open(args.metrics, encoding="utf-8") as f:
            snap = json.load(f)
        watch = {k: v for k, v in sorted(snap.items())
                 if k.startswith(("watchdog.", "slo.",
                                  "dispatch.reopens"))}
        if watch:
            print("live watchdog counters "
                  f"({os.path.basename(args.metrics)}):")
            for name, val in watch.items():
                v = val.get("value") if isinstance(val, dict) else val
                print(f"  {name} = {v}")
        else:
            print(f"no watchdog.*/slo.* series in {args.metrics}")
    if drifted and args.fail_on_drift:
        return 1
    return 0


def cmd_metrics(args) -> int:
    """Export the process metrics registry (``repro_torch.obs.metrics``).

    Registry-snapshot gauges (record counts per kind/source, from
    ``TuningRegistry.stats()``) are folded in first, so the command is
    useful even in a fresh process where no tuner/dispatch counters
    have fired yet.  ``--format prom`` prints Prometheus text
    exposition; ``--format json`` prints the snapshot dict.
    """
    from repro_torch.obs.metrics import get_metrics_registry
    registry = _registry(args)
    met = get_metrics_registry()
    stats = registry.stats()
    met.set_gauges({k: v for k, v in stats.items()
                    if isinstance(v, (int, float))},
                   prefix="registry.", help="tuning-registry snapshot")
    for group in ("by_kind", "by_source"):
        sub = stats.get(group)
        if isinstance(sub, dict):
            met.set_gauges(sub, prefix=f"registry.{group}.",
                           help="tuning-registry snapshot")
    text = (met.to_prometheus() if args.format == "prom"
            else json.dumps(met.snapshot(), indent=2, sort_keys=True))
    if args.out and args.out != "-":
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text if text.endswith("\n") else text + "\n")
        print(f"wrote {args.format} metrics to {args.out}")
    else:
        print(text, end="" if text.endswith("\n") else "\n")
    return 0


def cmd_invalidate(args) -> int:
    registry = _registry(args)
    if not (args.all or args.kind or args.machine or args.cost_model):
        raise SystemExit("refusing to invalidate without a filter; "
                         "pass --all to clear everything")
    n = registry.invalidate(kind=args.kind, machine=args.machine,
                            cost_model=args.cost_model)
    print(f"invalidated {n} records; {len(registry)} remain")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description=__doc__.splitlines()[0] if __doc__ else None)
    ap.add_argument("--registry", default=None,
                    help="registry path (default: $REPRO_TORCH_TUNE_REGISTRY or "
                         f"{reg.TuningRegistry.default_path()})")
    sub = ap.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("warm", help="tune a layer set into the registry")
    w.add_argument("--config", default="squeezenet_layers",
                   help="layer set: " + ", ".join(sorted(CONFIG_SETS)))
    w.add_argument("--kinds", default="conv_sweep,conv_schedule",
                   help="comma list of conv_sweep,conv_schedule")
    w.add_argument("--threads", type=int, default=1,
                   help="modelled thread count for the cache sweeps")
    w.add_argument("--top-k", type=int, default=5)
    w.add_argument("--elem-bytes", type=int, default=2,
                   help="element size the conv_schedule keys are tuned "
                        "for: 2 = bf16 (default), 4 = f32 — must match "
                        "the dtype callers will use (conv2d_tuned keys "
                        "on the input dtype's itemsize, and each size "
                        "offers the blocks of its own CUDA body)")
    w.add_argument("--refresh", action="store_true",
                   help="recompute even on cache hits")
    w.set_defaults(fn=cmd_warm)

    i = sub.add_parser("inspect", help="print registry contents")
    i.add_argument("--kind", default=None)
    i.set_defaults(fn=cmd_inspect)

    s = sub.add_parser("stats", help="summary counts (records, by_kind, "
                                     "by_tier, measured)")
    s.set_defaults(fn=cmd_stats)

    ec = sub.add_parser("ecm", help="three-tier sweep: roofline + ECM "
                                    "everywhere, tracesim only on "
                                    "disagreement")
    ec.add_argument("--config", default="squeezenet_layers",
                    help="layer set: " + ", ".join(sorted(CONFIG_SETS)))
    ec.add_argument("--hierarchy", default=None,
                    help="one of the §5.1 cache hierarchies "
                         "(16K/128K, 32K/512K, 64K/960K); default: "
                         "thesis Table 2.1 machine")
    ec.add_argument("--limit", type=int, default=None,
                    help="only the first N layers of the set")
    ec.add_argument("--threads", type=int, default=1,
                    help="modelled thread count")
    ec.add_argument("--top-k", type=int, default=8,
                    help="short-list size per tier for the "
                         "disagreement check")
    ec.add_argument("--tolerance", type=float, default=0.25,
                    help="relative roofline-vs-ECM disagreement that "
                         "triggers exact consultation")
    ec.add_argument("--max-exact-iters", type=int, default=200_000,
                    help="trace-length cap per exact consultation "
                         "(thesis §4.3.2-style instruction cap)")
    ec.add_argument("--workers", type=int, default=None,
                    help="process-pool width for exact consultations")
    ec.add_argument("--no-exact", action="store_true",
                    help="never consult tracesim (pure two-tier mode)")
    ec.set_defaults(fn=cmd_ecm)

    e = sub.add_parser("export", help="dump as a JSON array")
    e.add_argument("--out", default="-", help="output path ('-' = stdout)")
    e.set_defaults(fn=cmd_export)

    m = sub.add_parser("merge", help="union another registry into this "
                                     "one (+ stale-machine eviction)")
    m.add_argument("other", help="path to the registry JSONL to merge in")
    m.add_argument("--evict-days", type=int, default=None,
                   help="drop records whose machine fingerprint has not "
                        "been seen in this many days (sidecar: "
                        "<registry>.machines.json)")
    m.add_argument("--now", default=None,
                   help="override today's date (YYYY-MM-DD; for tests "
                        "and replayed merges)")
    m.set_defaults(fn=cmd_merge)

    sy = sub.add_parser("sync", help="fleet sync round: import every "
                                     "*.jsonl snapshot from a shared "
                                     "directory and/or export this "
                                     "registry as host-<fp>.jsonl")
    sy.add_argument("--export-dir", default=None,
                    help="write this registry's canonical snapshot here "
                         "(deterministic per-host file name)")
    sy.add_argument("--import-dir", default=None,
                    help="merge every *.jsonl snapshot in this directory "
                         "(the merge union policy per file)")
    sy.add_argument("--evict-days", type=int, default=None,
                    help="drop records whose machine fingerprint has not "
                         "been seen in this many days")
    sy.add_argument("--snapshot-name", default=None,
                    help="override the exported snapshot file name "
                         "(default host-<runtime fingerprint>.jsonl; "
                         "needed when several registries on one host "
                         "share an export directory)")
    sy.add_argument("--now", default=None,
                    help="override today's date (YYYY-MM-DD; for tests "
                         "and replayed syncs)")
    sy.add_argument("--device", default=None,
                    help="the device whose runtime fingerprint this host "
                         "stamps and names its snapshot by (default: the "
                         "CUDA card; 'cpu' to run without one)")
    sy.set_defaults(fn=cmd_sync)

    sr = sub.add_parser("serve-report",
                        help="per-shape adaptive-dispatch report: "
                             "predicted vs measured for serving-path "
                             "records")
    sr.add_argument("--kind", default=None,
                    help="restrict to one kind (e.g. "
                         "decode_attention_schedule)")
    sr.set_defaults(fn=cmd_serve_report)

    dr = sub.add_parser("doctor",
                        help="offline drift report: flag records whose "
                             "measurement left the [1/ratio, ratio] "
                             "band around the prediction")
    dr.add_argument("--kind", default=None,
                    help="restrict to one kind")
    dr.add_argument("--ratio", type=float, default=3.0,
                    help="drift band half-width (flag when "
                         "measured/predicted > ratio or < 1/ratio)")
    dr.add_argument("--metrics", default=None,
                    help="JSON metrics snapshot from a live run; "
                         "reports its watchdog.*/slo.* series")
    dr.add_argument("--fail-on-drift", action="store_true",
                    help="exit 1 when any record drifted (CI gate)")
    dr.set_defaults(fn=cmd_doctor)

    mt = sub.add_parser("metrics",
                        help="export process metrics (+ registry "
                             "snapshot gauges) as Prometheus text or "
                             "JSON")
    mt.add_argument("--format", default="prom", choices=("prom", "json"),
                    help="output format (default: Prometheus text)")
    mt.add_argument("--out", default="-",
                    help="output path ('-' = stdout)")
    mt.set_defaults(fn=cmd_metrics)

    v = sub.add_parser("invalidate", help="drop records by filter")
    v.add_argument("--kind", default=None)
    v.add_argument("--machine", default=None,
                   help="machine fingerprint (12 hex)")
    v.add_argument("--cost-model", default=None,
                   help=f"cost-model version (current: H100 "
                        f"{cm.COST_MODEL_VERSION}, Loki "
                        f"{cm.LOKI_MODEL_VERSION})")
    v.add_argument("--all", action="store_true")
    v.set_defaults(fn=cmd_invalidate)
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    try:
        code = args.fn(args)
    except BrokenPipeError:
        # stdout went away (e.g. `... | head`); suppress the interpreter's
        # flush-on-exit complaint and leave quietly.
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    sys.exit(code)
