"""The port's dry-run tools (``repro_torch.launch.{dryrun,hlo_analysis,
mesh,roofline}``) against the JAX package's, on the CPU.

Each side runs in a subprocess of its own, so that no process group
reaches the pytest worker: the JAX side lowers and compiles the cells
of ``tests/test_distributed.py::test_dryrun_cell_small_mesh`` (seq 32,
batch 8) on 8 XLA host placeholder devices, once as the dry-run does
(``lax.scan``) and once unrolled; the port runs the same cells on a
fake process group of 8 ranks, a (2, 4) ``(data, model)`` mesh.

What is held, and to what:
- ``argument_bytes`` equals JAX's ``argument_size_in_bytes`` exactly,
  except that ``jax.jit`` prunes an argument the step never reads: the
  ssm decode step's int32 ``pos`` (the port's count is JAX's + 4).
- Per-device flops over JAX's unrolled count lie in each cell's band
  (:data:`FLOPS_BAND`, measured with torch 2.13 on the CPU):
  train 1.599, ssm decode 2.018, moe prefill 4.611.  The port counts
  more: DTensor leaves some products and elementwise work replicated
  where XLA's partitioner splits it, the moe layer runs replicated
  (every token on every device) and the Mamba recurrence's elementwise
  passes count one flop an element.
- The collectives the recorder renders parse to the same bytes and
  counts through the port's and JAX's ``parse_collectives`` (tolerance
  0); all-gather, all-reduce, reduce-scatter and all-to-all of known
  shapes give their closed-form bytes; the port's parser gives
  ``tests/test_system.py``'s numbers.
- ``make_terms`` on the H100's constants, and the link rule: NVLink's
  450e9 B/s up to 8 cards, the network's 50e9 B/s from 9.
- The calibration's linear extension equals the full count (1e-9
  relative; measured 0) on each cell at 4 scaling units.
- ``run_cell``'s record has JAX's keys, and a skipped cell JAX's
  reason.
- A fake step's flops, bytes accessed and memory equal a real CPU
  step's under the same counter (what ``chip_smoke.py``'s
  ``[dryrun_vs_card]`` holds on the card).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the suite runs beside the JAX reference)

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import hlo_analysis, roofline  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TIMEOUT = 150
CELLS = [("qwen3-32b-smoke", "train_4k"),
         ("falcon-mamba-7b-smoke", "decode_32k"),
         ("qwen2-moe-a2.7b-smoke", "prefill_32k")]
# port flops a device over JAX's unrolled count: (low, high)
FLOPS_BAND = {"qwen3-32b-smoke": (1.55, 1.65),
              "falcon-mamba-7b-smoke": (1.95, 2.10),
              "qwen2-moe-a2.7b-smoke": (4.50, 4.70)}
# bytes of the arguments JAX's jit prunes, by cell: the ssm decode step
# never reads its int32 pos
PRUNED_BYTES = {"falcon-mamba-7b-smoke": 4}
EXTRAPOLATION_RTOL = 1e-9

JAX_SIDE = """
import dataclasses, json, os
import jax
from repro.configs import SHAPES, get_config
from repro.launch.mesh import make_mesh
from repro.runtime import sharding as shd
import repro.launch.dryrun as dr

mesh = make_mesh((2, 4), ("data", "model"))
rules = shd.ShardingRules()
out = {}
for arch, shape in %(cells)s:
    cfg = get_config(arch)
    shp = dataclasses.replace(SHAPES[shape], seq_len=32, global_batch=8)
    scan = dr.lower_compile(cfg, shp, mesh, rules)
    unrolled = dr.lower_compile(cfg, shp, mesh, rules, unroll=True)
    out[arch] = {"memory": scan["memory"],
                 "flops_unrolled": unrolled["flops_per_device"]}
SHAPES["train_4k"] = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                         global_batch=8)
rec = dr.run_cell("qwen3-32b-smoke", "train_4k", mesh_shape=(2, 4))
out["run_cell"] = {"keys": sorted(rec), "full": sorted(rec["full"]),
                   "roofline": sorted(rec["roofline"]),
                   "calibration": sorted(rec["calibration"])}
out["skipped"] = dr.run_cell("qwen3-32b-smoke", "long_500k")
json.dump(out, open(os.environ["OUT"] + "/jax.json", "w"))
"""

PORT_SIDE = """
import dataclasses, json, os
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as dr, hlo_analysis
from repro_torch.launch.mesh import close_group, init_fake_group, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import sharding as shd

OUT = os.environ["OUT"]
out = {}
init_fake_group(8)
try:
    init_fake_group(8)
except RuntimeError as e:
    out["second_group"] = str(e)
mesh = make_mesh((2, 4), ("data", "model"))
rules = shd.ShardingRules()
cut = lambda shape: dataclasses.replace(SHAPES[shape], seq_len=32,
                                        global_batch=8)
for arch, shape in %(cells)s:
    out[arch] = dr.lower_compile(get_config(arch), cut(shape), mesh, rules)
close_group()

# every kind of collective, on a group of 4, outside any DTensor
init_fake_group(4)
x = torch.ones(8, 16, dtype=torch.bfloat16)
rec = hlo_analysis.CollectiveRecorder()
with rec:
    funcol.all_gather_tensor(x, 0, dist.group.WORLD).wait()
    funcol.all_reduce(x, "sum", dist.group.WORLD).wait()
    funcol.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD).wait()
    funcol.all_to_all_single(x, None, None, dist.group.WORLD).wait()
close_group()
out["kinds_text"] = rec.text()

# the calibration at 4 scaling units
for arch, shape in %(cells)s:
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=4 * dr.scale_unit(cfg))
    r = dr.run_cell(arch, shape, mesh_shape=(2, 4), cfg=cfg,
                    shape=cut(shape))
    out["extrapolation/" + arch] = r.get("extrapolation")
    out["group_after/" + arch] = dist.is_initialized()

r = dr.run_cell("qwen3-32b-smoke", "train_4k", mesh_shape=(2, 4),
                shape=cut("train_4k"))
out["run_cell"] = {"keys": sorted(r), "full": sorted(r["full"]),
                   "roofline": sorted(r["roofline"]),
                   "calibration": sorted(r["calibration"])}
out["skipped"] = dr.run_cell("qwen3-32b-smoke", "long_500k")
failed = dr.run_cell("qwen3-32b-smoke", "train_4k", mesh_shape=(2, 4),
                     shape=cut("train_4k"), backend="no-such-backend")
out["failed"] = {"status": failed["status"], "error": failed["error"],
                 "group_after": dist.is_initialized()}

# a fake (1, 1) cell against a real CPU step under the same counter
cfg = get_config("phi3-mini-3.8b-smoke")
shp = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=4)
fake = dr.run_cell("phi3", "train_4k", mesh_shape=(1, 1), cfg=cfg,
                   shape=shp, calibrate=False)["full"]
model = build_model(cfg)
params = model.init(0, "cpu")
for p in dr._tensors(params):
    p.requires_grad_(True)
g = torch.Generator().manual_seed(0)
batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                          dtype=torch.int32) for k in ("tokens", "labels")}
real = dr.count_step(dr.cell_train_step(model, remat="full"),
                     (params, adamw.init(params), batch))
keys = ("flops_per_device", "bytes_per_device_accessed",
        "bytes_per_device", "memory")
out["fake_vs_real"] = {"fake": {k: fake[k] for k in keys},
                       "real": {k: real[k] for k in keys}}
json.dump(out, open(OUT + "/port.json", "w"))
"""


def _env(**kw):
    """The children's environment: ``src`` on the path, the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **kw)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both sides' JSON records, from two subprocesses run at once."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, "-c", JAX_SIDE % {"cells": CELLS}],
            env=_env(OUT=str(out), XLA_FLAGS=(
                "--xla_force_host_platform_device_count=8")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", PORT_SIDE % {"cells": CELLS}],
            env=_env(OUT=str(out)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
    try:
        logs = {k: p.communicate(timeout=TIMEOUT)[0]
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, logs[k][-3000:]
    return {k: json.loads((out / f"{k}.json").read_text()) for k in procs}


@pytest.mark.parametrize("arch", [a for a, _ in CELLS])
def test_argument_bytes_equal_jax(sides, arch):
    got = sides["port"][arch]["memory"]["argument_bytes"]
    # JAX's argument_size_in_bytes, under JAX's record key
    want = sides["jax"][arch]["memory"]["argument_bytes"]
    assert got == want + PRUNED_BYTES.get(arch, 0)


@pytest.mark.parametrize("arch", [a for a, _ in CELLS])
def test_flops_per_device_over_jax_in_band(sides, arch):
    ratio = (sides["port"][arch]["flops_per_device"]
             / sides["jax"][arch]["flops_unrolled"])
    lo, hi = FLOPS_BAND[arch]
    assert lo <= ratio <= hi, ratio


@pytest.mark.parametrize("arch", [a for a, _ in CELLS])
def test_recorded_collectives_parse_equal_in_both_packages(sides, arch):
    rec = sides["port"][arch]
    text = rec["collective_text"]
    got, want = hlo_analysis.parse_collectives(text), \
        jhlo.parse_collectives(text)
    assert got.count_by_kind == want.count_by_kind == \
        rec["collective_counts"]
    assert got.bytes_by_kind == want.bytes_by_kind == \
        rec["collectives_by_kind"]
    assert got.total_count > 0
    assert hlo_analysis.collective_schedule(text, 12) == \
        jhlo.collective_schedule(text, 12) == rec["collective_schedule"]


def test_every_kind_of_collective_has_its_bytes(sides):
    """A bf16 [8, 16] on a group of 4: all-gather counts its [32, 16]
    output, all-reduce twice its operand, reduce-scatter and all-to-all
    their operand; ``wait_tensor`` is not recorded."""
    text = sides["port"]["kinds_text"]
    operand = 8 * 16 * 2
    want_bytes = {"all-gather": 4 * operand, "all-reduce": 2 * operand,
                  "reduce-scatter": operand, "all-to-all": operand}
    for parse in (hlo_analysis.parse_collectives, jhlo.parse_collectives):
        stats = parse(text)
        assert stats.count_by_kind == {k: 1 for k in want_bytes}
        assert stats.bytes_by_kind == want_bytes
    assert len(text.splitlines()) == 4
    assert text.splitlines()[0] == (
        "%ag.0 = bf16[32,16]{1,0} all-gather(bf16[8,16]{1,0} %x.0)")


def test_port_parser_reads_jax_hlo():
    """``tests/test_system.py::test_hlo_collective_parsing``'s module."""
    hlo = """
  %ar = bf16[2048,1024]{1,0} all-reduce(bf16[2048,1024]{1,0} %x), replica_groups={}
  %ag = bf16[4096,1024]{1,0} all-gather(bf16[256,1024]{1,0} %y), dimensions={0}
  %rs = f32[256]{0} reduce-scatter(f32[4096]{0} %z), dimensions={0}
  %cp = f32[128]{0} collective-permute(f32[128]{0} %w), source_target_pairs={{0,1}}
"""
    stats = hlo_analysis.parse_collectives(hlo)
    assert stats.count_by_kind == {"all-reduce": 1, "all-gather": 1,
                                   "reduce-scatter": 1,
                                   "collective-permute": 1}
    assert stats.bytes_by_kind["all-reduce"] == 2 * 2048 * 1024 * 2
    assert stats.bytes_by_kind["all-gather"] == 4096 * 1024 * 2
    assert stats.bytes_by_kind["reduce-scatter"] == 4096 * 4
    assert stats.bytes_by_kind["collective-permute"] == 128 * 4
    assert stats.ops == jhlo.parse_collectives(hlo).ops
    assert hlo_analysis.shape_bytes("bf16[3,5]") == \
        jhlo.shape_bytes("bf16[3,5]") == 30


def test_make_terms_on_h100_constants():
    """``tests/test_system.py::test_roofline_terms_math`` on the H100:
    989e12 FLOP/s, 3.35e12 B/s, and 256 cards' link, the network's
    50e9 B/s (the same 0.1 s JAX's ICI gives)."""
    cfg = get_config("qwen3-32b")
    t = roofline.make_terms(
        arch="qwen3-32b", shape=SHAPES["train_4k"], mesh_name="16x16",
        chips=256, hlo_flops_global=2e17, hlo_bytes_global=1e15,
        coll_bytes_per_chip=5e9, cfg=cfg)
    assert t.compute_s == pytest.approx(2e17 / (256 * 989e12))
    assert t.memory_s == pytest.approx(1e15 / (256 * 3.35e12))
    assert t.collective_s == pytest.approx(0.1)
    assert t.dominant == "memory"
    assert t.model_flops == jroof.model_flops(
        jget_config("qwen3-32b"), JSHAPES["train_4k"])
    want = jroof.make_terms(
        arch="qwen3-32b", shape=JSHAPES["train_4k"], mesh_name="16x16",
        chips=256, hlo_flops_global=2e17, hlo_bytes_global=1e15,
        coll_bytes_per_chip=5e9, cfg=jget_config("qwen3-32b"))
    assert t.collective_s == want.collective_s
    assert roofline.extrapolate(10.0, 14.0, 1, 2, 64) == \
        pytest.approx(6.0 + 64 * 4.0)


@pytest.mark.parametrize("chips,link", [(1, 450e9), (8, 450e9),
                                        (9, 50e9), (256, 50e9),
                                        (512, 50e9)])
def test_link_rule(chips, link):
    """NVLink within one 8-card domain, the network past it."""
    assert roofline.link_bw(chips) == link
    t = roofline.make_terms(
        arch="qwen3-32b", shape=SHAPES["train_4k"], mesh_name="m",
        chips=chips, hlo_flops_global=1.0, hlo_bytes_global=1.0,
        coll_bytes_per_chip=4.5e9, cfg=get_config("qwen3-32b"))
    assert t.collective_s == 4.5e9 / link


@pytest.mark.parametrize("arch", [a for a, _ in CELLS])
def test_extrapolation_equals_full_count(sides, arch):
    ext = sides["port"]["extrapolation/" + arch]
    assert ext["ok"]
    for key in ("flops_per_device", "bytes_per_device_accessed",
                "collective_bytes_per_chip"):
        assert ext[key]["rel"] <= EXTRAPOLATION_RTOL, (key, ext[key])
        assert ext[key]["full"] > 0
    assert sides["port"]["group_after/" + arch] is False


def test_run_cell_keys_and_skip_reason_equal_jax(sides):
    got, want = sides["port"]["run_cell"], sides["jax"]["run_cell"]
    # the port's record adds the extrapolation check; its full record
    # adds the recorder's text
    assert set(want["keys"]) <= set(got["keys"])
    assert set(got["keys"]) - set(want["keys"]) == {"extrapolation"}
    assert set(got["full"]) - set(want["full"]) == {"collective_text"}
    assert set(want["full"]) <= set(got["full"])
    assert got["roofline"] == want["roofline"]
    assert got["calibration"] == want["calibration"]
    skip_got, skip_want = sides["port"]["skipped"], sides["jax"]["skipped"]
    assert skip_want["backend"] == "xla" and skip_got["backend"] == "plain"
    skip_got.pop("backend"), skip_want.pop("backend")
    assert skip_got == skip_want


def test_fake_group_and_failures_close_the_group(sides):
    port = sides["port"]
    assert "already running" in port["second_group"]
    assert port["failed"]["status"] == "failed"
    assert "no-such-backend" in port["failed"]["error"]
    assert port["failed"]["group_after"] is False


def test_fake_step_counts_equal_a_real_step(sides):
    got = sides["port"]["fake_vs_real"]
    assert got["fake"] == got["real"]
    assert got["fake"]["flops_per_device"] > 0


def test_import_sets_no_flags_and_starts_no_group():
    code = ("import os, torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "assert 'XLA_FLAGS' not in os.environ\n"
            "assert not dist.is_initialized()\n")
    env = _env()
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]


def test_cli_one_cell_and_a_skipped_one(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a smoke config at
    decode_32k's full shape (fake tensors: nothing is allocated) on a
    2 x 4 mesh, and a skipped cell; one line a cell and the JSON."""
    lines = []
    for shape in ("decode_32k", "long_500k"):
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "falcon-mamba-7b-smoke" if shape == "decode_32k"
             else "qwen3-32b-smoke", "--shape", shape, "--mesh-shape",
             "2x4", "--out", str(tmp_path / f"{shape}.json")],
            env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
        assert res.returncode == 0, res.stderr[-3000:]
        lines += [l for l in res.stdout.splitlines() if l.startswith("[")]
    assert lines[0].startswith("[ok     ] falcon-mamba-7b-smoke decode_32k "
                               "2x4")
    assert "extrapolation=ok" in lines[0]
    assert lines[1].startswith("[skipped] qwen3-32b-smoke long_500k")
    rec = json.loads((tmp_path / "decode_32k.json").read_text())[0]
    assert rec["status"] == "ok" and "collective_text" not in rec["full"]
    assert rec["full"]["memory"]["alias_bytes"] > 0
