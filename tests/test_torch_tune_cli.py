"""``python -m repro_torch.tune`` and the two ``launch`` counterparts of
the JAX package's examples, on the CPU.

Each command runs on both packages over temporary registries of its
own.  Where both packages compute the same thing (the Loki sweeps, the
ECM tier, merges and evictions of the same records) the outputs and
the registry files are compared exactly, apart from timing text and
the registry's path; where the port reads its own records (schedule
records keyed by the spec and ``runtime_fingerprint``, carrying the
batch) the expected rows are written out here.
"""
import json
import re
import runpy
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the suite runs beside the JAX reference)

from repro.core import registry as jreg  # noqa: E402
from repro.tune import cli as jcli  # noqa: E402
from repro_torch.configs.squeezenet_layers import TABLE_4_1  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core import registry as reg  # noqa: E402
from repro_torch.core import tuner  # noqa: E402
from repro_torch.launch import quickstart, tune_conv  # noqa: E402
from repro_torch.tune import cli  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TIMING = [(re.compile(r"in [0-9.]+m?s\b"), "in <t>"),
          (re.compile(r"\([0-9,]+ evals/s\)"), "(<rate>)")]


def run(main, argv, capsys):
    """(exit code, stdout) of one CLI invocation."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr().out


def untimed(text, *paths):
    """``text`` with timings and the given registry paths masked."""
    for rx, sub in TIMING:
        text = rx.sub(sub, text)
    for p in paths:
        text = text.replace(str(p), "<registry>")
    return text


def both(tmp_path, capsys, argv, name="r.jsonl"):
    """Run ``argv`` on the port and on the JAX package, each over its
    own registry; returns ((code, out), (jcode, jout), path, jpath)."""
    p, j = tmp_path / "port" / name, tmp_path / "jax" / name
    p.parent.mkdir(exist_ok=True)
    j.parent.mkdir(exist_ok=True)
    mine = run(cli.main, ["--registry", str(p)] + argv, capsys)
    theirs = run(jcli.main, ["--registry", str(j)] + argv, capsys)
    return mine, theirs, p, j


def kind_lines(path, kind):
    """The registry file's lines of one kind, in file order."""
    return [line for line in Path(path).read_text().splitlines()
            if json.loads(line)["key"]["kind"] == kind]


def test_every_command_of_the_jax_cli():
    def commands(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return list(sub.choices)
    assert commands(cli.build_parser()) == commands(jcli.build_parser())
    assert len(commands(cli.build_parser())) == 11


def test_warm_inspect_stats_export_equal(tmp_path, capsys):
    (code, out), (jcode, jout), p, j = both(tmp_path, capsys, ["warm"])
    assert code == jcode == 0
    assert untimed(out, p).splitlines()[0] == \
        untimed(jout, j).splitlines()[0]
    assert "conv_sweep=8, conv_schedule=8, skipped=0" in out
    assert kind_lines(p, "conv_sweep") == kind_lines(j, "conv_sweep")
    assert len(kind_lines(p, "conv_schedule")) == 8
    # a warm re-run computes nothing
    (code, out), (_, jout), _, _ = both(tmp_path, capsys, ["warm"])
    assert "skipped=16" in out and "0 cost-model evals" in out
    assert untimed(out, p) == untimed(jout, j)

    (code, out), (_, jout), _, _ = both(
        tmp_path, capsys, ["inspect", "--kind", "conv_sweep"])
    assert code == 0 and out.count("conv_sweep ") == 8
    assert untimed(out, p) == untimed(jout, j)

    (code, out), (_, jout), _, _ = both(tmp_path, capsys, ["stats"])
    st, jst = json.loads(out), json.loads(jout)
    assert st.pop("path") == str(p) and jst.pop("path") == str(j)
    assert st == jst == {"by_kind": {"conv_schedule": 8, "conv_sweep": 8},
                         "by_tier": {"roofline": 16}, "malformed_lines": 0,
                         "measured": 0, "records": 16}

    ex, jex = tmp_path / "port.json", tmp_path / "jax.json"
    assert run(cli.main, ["--registry", str(p), "export", "--out", str(ex)],
               capsys) == (0, f"exported 16 records to {ex}\n")
    run(jcli.main, ["--registry", str(j), "export", "--out", str(jex)],
        capsys)
    sweeps = [[r for r in json.loads(f.read_text())
               if r["key"]["kind"] == "conv_sweep"] for f in (ex, jex)]
    assert sweeps[0] == sweeps[1] and len(sweeps[0]) == 8
    code, out = run(cli.main, ["--registry", str(p), "export"], capsys)
    assert json.loads(out) == json.loads(ex.read_text())


@pytest.mark.parametrize("argv", [
    ["ecm", "--config", "squeezenet_layers"],
    ["ecm", "--config", "synthetic_mt", "--limit", "6", "--threads", "4",
     "--hierarchy", "16K/128K"],
    ["ecm", "--config", "synthetic", "--limit", "12", "--no-exact",
     "--hierarchy", "64K/960K"],
], ids=["table4.1", "table4.3-mt", "table4.2-no-exact"])
def test_ecm_output_and_records_equal(tmp_path, capsys, argv):
    (code, out), (jcode, jout), p, j = both(tmp_path, capsys, argv)
    assert code == jcode == 0
    assert untimed(out) == untimed(jout)
    assert "exact consultation rate" in out
    assert kind_lines(p, "ecm_sweep") == kind_lines(j, "ecm_sweep")


def test_unknown_config_and_hierarchy_refused(tmp_path, capsys):
    for argv in (["ecm", "--config", "nope"],
                 ["ecm", "--hierarchy", "1K/2K"]):
        with pytest.raises(SystemExit) as e:
            cli.main(["--registry", str(tmp_path / "r.jsonl")] + argv)
        assert "unknown" in str(e.value.code)


# ---------------------------------------------------------- handcrafted

def port_records():
    """Records the port's dispatch service and sessions write on a card
    (here keyed by the CPU's runtime, which the port keys the same way):
    a conv schedule at batch 4 whose measured winner is rank 1 and ran
    5x its prediction, a decode schedule at 1.5x, a ``serve_decode``
    measurement, an adaptive-only record, a legacy bare-number
    measurement, and a record a JAX registry carries (its TPU cost
    fields, which the port's KernelCost cannot read)."""
    machine = reg.machine_key(cm.H100Spec(), "cpu")
    layer = TABLE_4_1["fire9-conv3x3-2"]
    ranked = tuner.tune_conv(layer, top_k=3, batch=4)
    scheds = [reg.schedule_to_dict(s) for s, _ in ranked]
    costs = [reg.cost_to_dict(c) for _, c in ranked]
    conv = reg.TuningRecord(
        reg.conv_schedule_key(layer, machine, 2, batch=4),
        {"schedules": scheds, "costs": costs, "tier": "roofline"},
        {"best": scheds[1], "time_s": 5 * ranked[1][1].time_s},
        "adaptive")
    dranked = tuner.tune_decode_attention(4, 32, 32, 544, 96, top_k=2)
    dec = reg.TuningRecord(
        reg.decode_attention_schedule_key(4, 32, 32, 544, 96, machine),
        {"schedules": [reg.schedule_to_dict(s) for s, _ in dranked],
         "costs": [reg.cost_to_dict(c) for _, c in dranked]},
        {"best": reg.schedule_to_dict(dranked[0][0]),
         "time_s": 1.5 * dranked[0][1].time_s}, "adaptive")
    serve = reg.TuningRecord(
        reg.RegistryKey.make("serve_decode",
                             {"arch": "phi3-mini-3.8b", "batch": 4,
                              "prompt_len": 512, "new_tokens": 32},
                             reg.runtime_fingerprint("cpu"), "measured"),
        {"schedules": [{"type": "serve_decode", "arch": "phi3-mini-3.8b",
                        "decode_tok_s": 1234.5}]},
        {"best": {"type": "serve_decode", "arch": "phi3-mini-3.8b",
                  "decode_tok_s": 1234.5}, "time_s": 0.0123}, "adaptive")
    only = reg.TuningRecord(
        reg.ssm_scan_schedule_key(1, 512, 8192, 16, machine),
        {"schedules": [{"type": "ssm_scan", "block_d": 64}]},
        {"best": {"type": "ssm_scan", "block_d": 64}, "time_s": 2e-4},
        "adaptive")
    sranked = tuner.tune_ssm_scan(4, 1, 8192, 16, top_k=1)
    legacy = reg.TuningRecord(
        reg.ssm_scan_schedule_key(4, 1, 8192, 16, machine),
        {"schedules": [reg.schedule_to_dict(sranked[0][0])],
         "costs": [reg.cost_to_dict(sranked[0][1])]},
        0.5 * sranked[0][1].time_s, "adaptive")
    tpu = reg.TuningRecord(
        reg.RegistryKey.make("conv_schedule", reg.loki_problem(layer),
                             "0123456789ab", "1"),
        {"schedules": [scheds[0]],
         "costs": [{"flops": 1e9, "hbm_bytes": 1e6, "vmem_peak": 1e5,
                    "grid_steps": 8, "compute_s": 1e-5, "memory_s": 2e-5,
                    "overhead_s": 1e-6}]},
        {"best": scheds[0], "time_s": 4e-5}, "adaptive")
    return {"conv": conv, "dec": dec, "serve": serve, "only": only,
            "legacy": legacy, "tpu": tpu}


def write(path, recs):
    """A compacted registry file holding ``recs``."""
    r = reg.TuningRegistry(str(path))
    for rec in recs:
        r.put(rec)
    r.compact()
    return path


def rows(out):
    """serve-report/doctor rows: kind -> list of split columns."""
    got = {}
    for line in out.splitlines()[1:]:
        if line.startswith("--") or not line.strip():
            continue
        cols = line.split()
        got.setdefault(cols[0], []).append(cols)
    return got


def test_serve_report_and_doctor_on_port_records(tmp_path, capsys):
    recs = port_records()
    path = write(tmp_path / "r.jsonl", recs.values())
    code, out = run(cli.main, ["--registry", str(path), "serve-report"],
                    capsys)
    assert code == 0
    got = rows(out)
    assert sorted(got) == ["conv_schedule", "decode_attention_schedule",
                           "serve_decode", "ssm_scan_schedule"]
    # the measured winner's prediction (rank 1), not rank 0's
    conv = next(r for r in got["conv_schedule"] if "n=4" in r[1])
    assert conv[4] == "5.00"
    pred1 = reg.cost_from_dict(recs["conv"].value["costs"][1]).time_s
    assert conv[2] == f"{pred1:.3e}"
    tpu = next(r for r in got["conv_schedule"] if "n=4" not in r[1])
    assert tpu[2] == "-" and tpu[3] == "4.000e-05" and tpu[4] == "-"
    assert got["decode_attention_schedule"][0][4] == "1.50"
    assert got["serve_decode"][0][2:5] == ["-", "1.230e-02", "-"]
    legacy = next(r for r in got["ssm_scan_schedule"] if "bt=4" in r[1])
    assert legacy[4] == "0.50"
    assert out.splitlines()[-1].startswith(
        "-- 6 serving-path records, 6 with run-time measurements")

    code, out = run(cli.main, ["--registry", str(path), "doctor",
                               "--ratio", "3"], capsys)
    assert code == 0
    verdicts = {r[0] + ("/n4" if "n=4" in r[1] else ""): r[-1]
                for rs in rows(out).values() for r in rs}
    assert verdicts["conv_schedule/n4"] == "DRIFT"
    assert verdicts["conv_schedule"] == "unmeasured"    # TPU cost fields
    assert verdicts["decode_attention_schedule"] == "ok"
    assert verdicts["serve_decode"] == "unmeasured"
    assert "1 drifted (band [0.33, 3.00]), 3 unmeasured" in out
    code, _ = run(cli.main, ["--registry", str(path), "doctor", "--ratio",
                             "3", "--fail-on-drift"], capsys)
    assert code == 1
    code, _ = run(cli.main, ["--registry", str(path), "doctor", "--ratio",
                             "6", "--fail-on-drift"], capsys)
    assert code == 0


@pytest.mark.parametrize("command", ["serve-report", "doctor"])
def test_report_rows_without_costs_equal_jax(tmp_path, capsys, command):
    """Rows whose record holds no predicted cost read the same in both
    packages, the trainer's ``train_step`` measurement among them."""
    recs = port_records()
    train = reg.TuningRecord(
        reg.RegistryKey.make("train_step",
                             {"arch": "phi3-mini-3.8b", "global_batch": 4,
                              "seq_len": 512, "backend": "plain"},
                             reg.runtime_fingerprint("cpu"), "measured"),
        {"schedules": [{"type": "train_step", "arch": "phi3-mini-3.8b"}]},
        {"best": {"type": "train_step", "arch": "phi3-mini-3.8b"},
         "time_s": 0.3}, "adaptive")
    path = write(tmp_path / "r.jsonl", [recs["serve"], recs["only"], train])
    _, out = run(cli.main, ["--registry", str(path), command], capsys)
    _, jout = run(jcli.main, ["--registry", str(path), command], capsys)
    assert out == jout
    assert "train_step" in rows(out)
    assert [r[-1] for rs in rows(out).values() for r in rs] == \
        (["unmeasured"] * 3 if command == "doctor" else ["adaptive"] * 3)


def test_doctor_reads_a_metrics_snapshot(tmp_path, capsys):
    path = write(tmp_path / "r.jsonl", [port_records()["dec"]])
    snap = tmp_path / "m.json"
    snap.write_text(json.dumps({"watchdog.drift_total": {"value": 2},
                                "slo.pages_total": 0, "other": 1}))
    _, out = run(cli.main, ["--registry", str(path), "doctor", "--metrics",
                            str(snap)], capsys)
    _, jout = run(jcli.main, ["--registry", str(path), "doctor",
                              "--metrics", str(snap)], capsys)
    tail = out.split("live watchdog counters")[1]
    assert tail == jout.split("live watchdog counters")[1]
    assert "watchdog.drift_total = 2" in tail and "other" not in tail


def test_merge_equals_jax_and_evicts(tmp_path, capsys):
    """The same two registries merged by each package: equal output,
    registry bytes and last-seen sidecar; a machine not seen for the
    eviction window is dropped."""
    recs = port_records()
    unmeasured = reg.TuningRecord(recs["conv"].key,
                                  dict(recs["conv"].value), None, "offline")
    for pkg, main in (("port", cli.main), ("jax", jcli.main)):
        d = tmp_path / pkg
        d.mkdir()
        a = write(d / "a.jsonl", [unmeasured, recs["serve"], recs["tpu"]])
        write(d / "b.jsonl", [recs["conv"], recs["dec"]])
        reg.save_machine_seen(str(a), {"0123456789ab": "2026-01-01"})
        code, out = run(main, ["--registry", str(a), "merge",
                               str(d / "b.jsonl"), "--evict-days", "30",
                               "--now", "2026-03-01"], capsys)
        assert code == 0
        (d / "out.txt").write_text(out.replace(str(d), "<d>"))
    for f in ("out.txt", "a.jsonl", "a.jsonl.machines.json"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    out = (tmp_path / "port" / "out.txt").read_text()
    assert "added=1, identical=0, kept=0, replaced=1" in out
    assert "evicted 1 stale records; registry now has 3 records" in out
    merged = reg.TuningRegistry(str(tmp_path / "port" / "a.jsonl"))
    assert merged.get(recs["conv"].key).measured == recs["conv"].measured
    assert "0123456789ab" not in merged.machines()
    # the other direction converges on the same record set
    d = tmp_path / "rev"
    d.mkdir()
    b = write(d / "b.jsonl", [recs["conv"], recs["dec"]])
    write(d / "a.jsonl", [unmeasured, recs["serve"], recs["tpu"]])
    run(cli.main, ["--registry", str(b), "merge", str(d / "a.jsonl"),
                   "--now", "2026-03-01"], capsys)
    def lines(registry):
        return {reg.canonical_json(r.to_dict()) for r in registry.records()}
    assert lines(reg.TuningRegistry(str(b))) == \
        lines(merged) | {reg.canonical_json(recs["tpu"].to_dict())}


def test_merge_into_an_empty_file_copies_every_record(tmp_path, capsys):
    src = write(tmp_path / "src.jsonl", port_records().values())
    dst = tmp_path / "dst.jsonl"
    code, out = run(cli.main, ["--registry", str(dst), "merge", str(src)],
                    capsys)
    assert code == 0 and "added=6" in out
    assert dst.read_bytes() == src.read_bytes()


def test_sync_imports_evicts_and_exports_deterministically(tmp_path,
                                                           capsys):
    recs = port_records()
    fleet = tmp_path / "fleet"
    fleet.mkdir()
    write(fleet / "host-b.jsonl", [recs["dec"]])
    for pkg, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jcli.main, [])):
        d = tmp_path / pkg
        d.mkdir()
        shutil.copytree(fleet, d / "fleet")
        r = write(d / "r.jsonl", [recs["conv"], recs["tpu"]])
        reg.save_machine_seen(str(r), {"0123456789ab": "2026-01-01"})
        argv = ["--registry", str(r), "sync", "--import-dir",
                str(d / "fleet"), "--export-dir", str(d / "fleet"),
                "--snapshot-name", "host-a.jsonl", "--evict-days", "30",
                "--now", "2026-03-01"] + extra
        code, out = run(main, argv, capsys)
        assert code == 0
        (d / "out.txt").write_text(out.replace(str(d), "<d>"))
        snap = (d / "fleet" / "host-a.jsonl").read_bytes()
        assert snap == r.read_bytes()
        # an unchanged registry re-exports byte-identical bytes
        run(main, argv, capsys)
        assert (d / "fleet" / "host-a.jsonl").read_bytes() == snap
    for f in ("out.txt", "r.jsonl"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    out = (tmp_path / "port" / "out.txt").read_text()
    assert "imported 1 snapshot(s): added=1" in out
    assert "evicted 1 stale records; registry now has 2 records" in out
    seen = reg.load_machine_seen(str(tmp_path / "port" / "r.jsonl"))
    for fp in (reg.runtime_fingerprint("cpu"), reg.fingerprint(cm.H100Spec()),
               reg.machine_key(cm.H100Spec(), "cpu")):
        assert seen[fp] == "2026-03-01"


def test_sync_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = write(tmp_path / "r.jsonl", [port_records()["dec"]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--registry", str(r), "sync", "--export-dir",
                  str(tmp_path / "out")])


def test_invalidate_filters_and_refuses_without_one(tmp_path, capsys):
    recs = port_records()
    path = write(tmp_path / "r.jsonl", recs.values())
    with pytest.raises(SystemExit) as e:
        cli.main(["--registry", str(path), "invalidate"])
    assert "refusing" in str(e.value.code)
    machine = reg.machine_key(cm.H100Spec(), "cpu")
    assert run(cli.main, ["--registry", str(path), "invalidate",
                          "--machine", machine], capsys) == \
        (0, "invalidated 4 records; 2 remain\n")
    assert run(cli.main, ["--registry", str(path), "invalidate", "--kind",
                          "conv_sweep"], capsys) == \
        (0, "invalidated 0 records; 2 remain\n")
    assert run(cli.main, ["--registry", str(path), "invalidate",
                          "--cost-model", "measured"], capsys) == \
        (0, "invalidated 1 records; 1 remain\n")
    assert [json.loads(line)["key"]["machine"]
            for line in path.read_text().splitlines()] == ["0123456789ab"]
    assert run(cli.main, ["--registry", str(path), "invalidate", "--all"],
               capsys) == (0, "invalidated 1 records; 0 remain\n")


def test_metrics_registry_gauges_equal_jax(tmp_path, capsys):
    path = write(tmp_path / "r.jsonl", port_records().values())
    _, out = run(cli.main, ["--registry", str(path), "metrics", "--format",
                            "json"], capsys)
    _, jout = run(jcli.main, ["--registry", str(path), "metrics",
                              "--format", "json"], capsys)

    def gauges(text):
        return {k: v for k, v in json.loads(text).items()
                if k.startswith("registry.")}
    assert gauges(out) == gauges(jout)
    assert gauges(out)["registry.records"]["value"] == 6.0
    prom = tmp_path / "m.prom"
    assert run(cli.main, ["--registry", str(path), "metrics", "--out",
                          str(prom)], capsys)[0] == 0
    assert "registry_records" in prom.read_text()


def test_registry_file_operations_hold_the_lock(tmp_path):
    """compact, and the appends of put, run under the registry's lock:
    a writer holding it keeps both out of the file."""
    import threading
    r = reg.TuningRegistry(str(tmp_path / "r.jsonl"))
    recs = list(port_records().values())
    r.put(recs[0])
    done = []
    with r._lock:
        t1 = threading.Thread(target=lambda: (r.compact(), done.append(1)))
        t2 = threading.Thread(target=lambda: (r.put(recs[1]),
                                              done.append(2)))
        t1.start()
        t2.start()
        t1.join(0.3)
        t2.join(0.3)
        assert done == [] and len(
            (tmp_path / "r.jsonl").read_text().splitlines()) == 1
    t1.join(10)
    t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    assert sorted(done) == [1, 2]
    assert len(reg.TuningRegistry(str(tmp_path / "r.jsonl"))) == 2


def test_registry_views(tmp_path):
    recs = port_records()
    r = reg.TuningRegistry(str(write(tmp_path / "r.jsonl", recs.values())))
    assert len(r) == 6 and recs["dec"].key in r
    assert r.keys() == [rec.key for rec in r.records()]
    assert [k.canonical() for k in r.keys()] == \
        sorted(k.canonical() for k in r.keys())
    assert r.machines() == sorted({rec.key.machine for rec in
                                   recs.values()})
    j = jreg.TuningRegistry(str(tmp_path / "r.jsonl"))
    st, jst = r.stats(), j.stats()
    assert st == jst and st["measured"] == 6
    assert st["by_tier"] == {"other": 1, "roofline": 5}
    a, b = recs["conv"], reg.TuningRecord(recs["conv"].key,
                                          recs["conv"].value)
    assert reg.prefer_record(a, b) is a and reg.prefer_record(b, a) is a


# --------------------------------------------------------------- launch

def test_tune_conv_prints_the_jax_example(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_REGISTRY", str(tmp_path / "j.jsonl"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_REGISTRY", str(tmp_path / "p.jsonl"))
    runpy.run_path(str(REPO / "examples" / "tune_conv.py"),
                   run_name="__main__")
    jout = capsys.readouterr().out
    cold = tune_conv.main()
    out = capsys.readouterr().out
    assert out.splitlines()[1:] == jout.splitlines()[1:]
    assert len(out.splitlines()) == 22
    assert cold["sweep_evals"] == 8 * 720
    warm = tune_conv.main()
    assert capsys.readouterr().out.splitlines()[1:] == out.splitlines()[1:]
    assert warm["sweep_evals"] == 0
    # the search section scores the same candidates cold and warm
    assert warm["evals"] == cold["evals"] - cold["sweep_evals"] > 720


def test_quickstart_on_the_cpu(capsys):
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("720-perm sweep: best oc/y/x/ic/ky/kx")
    assert len(res["schedules"]) == 2 and res["device"] == "cpu"
    # float32 data, so float32 blocks: the tuner's own ranking at 4 bytes
    want = tuner.tune_conv(quickstart.LAYER, elem_bytes=4, top_k=2)
    assert res["schedules"] == [s for s, _ in want]
    assert res["max_abs_err"] == [0.0, 0.0]     # the plain path itself
    assert res["launches"] == 0                 # no kernel on the CPU
    assert res["best_index"] in (0, 1) and len(res["medians_s"]) == 2
    assert "host clock" in out[-1] and f"#{res['best_index']}" in out[-1]
    assert np.isfinite(res["predicted_s"]).all()
