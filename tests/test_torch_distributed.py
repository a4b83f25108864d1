"""The port's multi-process paths against the JAX package's meshed runs,
on the CPU: ``gloo`` process groups of 4 or 8 ranks (each a process of
its own, sharing a ``FileStore`` under the test's ``tmp_path``: no TCP
port is fixed) beside JAX subprocesses on as many host placeholder
devices (``XLA_FLAGS``, as ``tests/test_distributed.py`` runs them).
Every child has a timeout of its own (120 s), so a hang fails one test.

Tolerances: the meshed step-0 gradients within 1e-5 of each leaf's
largest |gradient| of JAX's meshed gradients (float32; both packages
split the same products over the mesh, summed in other orders); three
meshed steps' losses rtol 1e-4 (``RUN_RTOL``) of JAX's; every rank's
local shard equal (exactly) to the slice JAX's ``NamedSharding``
assigns the device at the same mesh coordinate, on (2, 2) and on a
(2, 2, 1) ``(pod, data, model)`` mesh; ``allreduce_compressed`` within
1e-6 of JAX's ``shard_map`` result, mean and new error, and JAX's own
``rel < 0.02`` against the exact mean; an elastic restore exact and its
checkpoint bytes equal to an unsharded save; the launcher's meshed
``done:`` line within 1e-4 of the unmeshed one's.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the suite runs beside the JAX reference)

REPO = Path(__file__).resolve().parent.parent
SRC = str(REPO / "src")
TIMEOUT = 120
GRAD_TOL = 1e-5
RUN_RTOL = 1e-4
AR_ATOL = 1e-6
LAUNCH_ATOL = 1e-4
ARCH = "phi3-mini-3.8b-smoke"

RANK_PRELUDE = """
import os, sys, json
import numpy as np
import torch
from repro_torch.launch.mesh import close_group, init_group, make_mesh
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD"])
OUT = os.environ["OUT"]
init_group("gloo", rank=RANK, world_size=WORLD,
           store_path=os.environ["STORE"])
"""


def _env(**kw):
    """The children's environment: ``src`` on the path, the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **kw)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_ranks(code: str, world: int, out: Path) -> None:
    """``code`` (after :data:`RANK_PRELUDE`) in ``world`` processes of
    one gloo group; each logs to ``out/rank<r>.log``; all must exit 0
    within :data:`TIMEOUT` seconds, or every one is killed."""
    procs, logs = [], []
    for r in range(world):
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_PRELUDE + code
             + "\nclose_group()\n"],
            env=_env(RANK=str(r), WORLD=str(world),
                     STORE=str(out / "store"), OUT=str(out)),
            stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out / f"rank{r}.log").read_text()[-3000:]


def run_jax(code: str, devices: int, out: Path) -> None:
    """``code`` in a JAX process on ``devices`` host placeholder
    devices, ``OUT`` naming ``out``."""
    res = subprocess.run(
        [sys.executable, "-c", code],
        env=_env(OUT=str(out), XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={devices}")),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]


JAX_MESHED_STEP = """
import functools, json, os
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import adamw
from repro.optim.schedule import constant
from repro.runtime import sharding as shd
from repro.runtime.train_loop import make_train_step

OUT = os.environ["OUT"]
rules = shd.ShardingRules()
m = build_model(get_config("%(arch)s"))
params, axes = m.init(jax.random.key(0))
is_ax = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)
flat = lambda t: {"/".join(k.key for k in p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(t)[0]}
np.savez(OUT + "/params.npz", **flat(params))
data = np.load(OUT + "/batches.npz")
batches = [{"tokens": jnp.asarray(data["tokens"][i]),
            "labels": jnp.asarray(data["labels"][i])} for i in range(3)]

def indices(mesh):
    # path -> [(mesh coordinate, [(start, stop) per dim])]
    specs = jax.tree.map(lambda ax, l: shd.resolve_spec(
        ax, l.shape, mesh, rules), axes, params, is_leaf=is_ax)
    out = {}
    for path, leaf in flat(params).items():
        node = specs
        for k in path.split("/"):
            node = node[k]
        imap = NamedSharding(mesh, node).devices_indices_map(leaf.shape)
        rows = []
        for coord in np.ndindex(mesh.devices.shape):
            sl = imap[mesh.devices[coord]]
            rows.append([list(coord), [[s.start or 0, leaf.shape[d]
                                        if s.stop is None else s.stop]
                                       for d, s in enumerate(sl)]])
        out[path] = rows
    return out

mesh = make_mesh((2, 2), ("data", "model"))
mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"))
json.dump({"mesh": indices(mesh), "mesh3": indices(mesh3)},
          open(OUT + "/indices.json", "w"))
ns = lambda s: NamedSharding(mesh, s)
p_sh = jax.tree.map(lambda ax, l: ns(shd.resolve_spec(ax, l.shape, mesh,
                                                      rules)),
                    axes, params, is_leaf=is_ax)
sf = shd.make_activation_shard_fn(mesh, rules)
grad = jax.jit(jax.grad(lambda p, b: m.loss_fn(p, b, shard_fn=sf)[0]),
               in_shardings=(p_sh, None))
np.savez(OUT + "/jax_grads.npz", **flat(grad(params, batches[0])))
opt = adamw.init(params)
m_sh = jax.tree.map(lambda ax, l: ns(shd.resolve_spec(ax, l.shape, mesh,
                                                      rules)),
                    axes, opt.m, is_leaf=is_ax)
opt_sh = adamw.AdamWState(step=ns(P()), m=m_sh, v=m_sh)
step = jax.jit(make_train_step(m, adamw.AdamWConfig(lr=1e-3),
                               functools.partial(constant, peak_lr=1e-3),
                               shard_fn=sf),
               in_shardings=(p_sh, opt_sh, None), donate_argnums=(0, 1))
losses = []
p, o = params, opt
for b in batches:
    p, o, met = step(p, o, b)
    losses.append(float(met["loss"]))
json.dump(losses, open(OUT + "/jax_losses.json", "w"))
"""

TORCH_MESHED_STEP = """
import functools
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.train_loop import make_train_step
from repro_torch.tree import flatten_with_paths, leaves

model = build_model(get_config("%(arch)s"))
rules = shd.ShardingRules()
tree = {}
for path, arr in np.load(OUT + "/params.npz").items():
    node = tree
    keys = path.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = arr
data = np.load(OUT + "/batches.npz")

def placed(mesh):
    params = params_from_numpy(tree, device="cpu")
    dp = shd.distribute_tree(
        params, shd.tree_specs(model.axes_tree(), params, mesh, rules),
        mesh)
    for t in leaves(dp):
        t.requires_grad_(True)
    return dp

def batch(mesh, i):
    b = {k: torch.from_numpy(data[k][i]) for k in ("tokens", "labels")}
    specs = shd.batch_specs(b, mesh, rules)
    return {k: shd.distribute(v, specs[k], mesh) for k, v in b.items()}

def shards(dp, mesh, name):
    coord = mesh.get_coordinate()
    np.savez(OUT + f"/{name}_rank{RANK}.npz",
             **{p: t.to_local().detach().numpy()
                for p, t in flatten_with_paths(dp)})
    json.dump({"coord": coord, "placements": {
        p: str(t.placements) for p, t in flatten_with_paths(dp)}},
        open(OUT + f"/{name}_rank{RANK}.json", "w"))

mesh = make_mesh((2, 2), ("data", "model"))
sf = shd.make_activation_shard_fn(mesh, rules)
dp = placed(mesh)
shards(dp, mesh, "mesh")
with implicit_replication():
    loss = model.loss_fn(dp, batch(mesh, 0), shard_fn=sf)[0]
    grads = torch.autograd.grad(loss, leaves(dp))
full = {p: g.full_tensor().numpy()
        for (p, _), g in zip(flatten_with_paths(dp), grads)}
if RANK == 0:
    np.savez(OUT + "/torch_grads.npz", **full)
step = make_train_step(model, adamw.AdamWConfig(lr=1e-3),
                       functools.partial(constant, peak_lr=1e-3),
                       shard_fn=sf)
dp = placed(mesh)
opt = adamw.init(dp)
losses = []
for i in range(3):
    dp, opt, met = step(dp, opt, batch(mesh, i))
    losses.append(float(met["loss"]))
assert all(isinstance(t, DTensor) for t in leaves(dp) + leaves(opt.m))
if RANK == 0:
    json.dump(losses, open(OUT + "/torch_losses.json", "w"))
mesh3 = make_mesh((2, 2, 1), ("pod", "data", "model"))
shards(placed(mesh3), mesh3, "mesh3")
"""


def test_meshed_step_matches_jax(tmp_path):
    """4 gloo ranks on a (2, 2) mesh from the bridged phi3-smoke weights
    against JAX's meshed step on 4 placeholder devices: step-0
    gradients, three steps' losses, and each rank's local shards (also
    on (2, 2, 1), where ``embed`` splits over ``("pod", "data")``)."""
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "batches.npz",
             tokens=rng.integers(0, 256, (3, 4, 16)).astype(np.int32),
             labels=rng.integers(0, 256, (3, 4, 16)).astype(np.int32))
    run_jax(JAX_MESHED_STEP % {"arch": ARCH}, 4, tmp_path)
    run_ranks(TORCH_MESHED_STEP % {"arch": ARCH}, 4, tmp_path)

    want = np.load(tmp_path / "jax_grads.npz")
    got = np.load(tmp_path / "torch_grads.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        scale = np.abs(want[k]).max()
        assert np.abs(got[k] - want[k]).max() <= GRAD_TOL * scale, k
    np.testing.assert_allclose(
        json.loads((tmp_path / "torch_losses.json").read_text()),
        json.loads((tmp_path / "jax_losses.json").read_text()),
        rtol=RUN_RTOL)

    full = np.load(tmp_path / "params.npz")
    indices = json.loads((tmp_path / "indices.json").read_text())
    for name in ("mesh", "mesh3"):
        by_coord = {}
        for r in range(4):
            meta = json.loads((tmp_path / f"{name}_rank{r}.json")
                              .read_text())
            by_coord[tuple(meta["coord"])] = (
                np.load(tmp_path / f"{name}_rank{r}.npz"),
                meta["placements"])
        sharded_model = split_pod_data = False
        for path, rows in indices[name].items():
            for coord, bounds in rows:
                local, placements = by_coord[tuple(coord)]
                sl = tuple(slice(a, b) for a, b in bounds)
                np.testing.assert_array_equal(local[path], full[path][sl])
            pl = placements[path]
            if name == "mesh":
                sharded_model |= pl.endswith("Shard(dim=2))") or \
                    pl.endswith("Shard(dim=1))")
            else:
                split_pod_data |= pl.startswith("(Shard(dim=1), "
                                                "Shard(dim=1)")
        if name == "mesh":
            assert sharded_model
        else:
            assert split_pod_data


JAX_ALLREDUCE = """
import os
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.launch.mesh import make_mesh
from repro.optim import grad_compress

OUT = os.environ["OUT"]
d = np.load(OUT + "/inputs.npz")
mesh = make_mesh((8,), ("data",))
g = {"a": jnp.asarray(d["ga"]), "b": jnp.asarray(d["gb"])}
e = {"a": jnp.asarray(d["ea"]), "b": jnp.asarray(d["eb"])}
fm = shard_map(lambda gs, es: grad_compress.allreduce_compressed(
    gs, es, "data"), mesh=mesh, in_specs=(P("data"), P("data")),
    out_specs=(P("data"), P("data")))
mean, err = fm(g, e)
np.savez(OUT + "/jax.npz", ma=np.asarray(mean["a"]), mb=np.asarray(mean["b"]),
         ea=np.asarray(err["a"]), eb=np.asarray(err["b"]))
"""

TORCH_ALLREDUCE = """
from repro_torch.optim import grad_compress
d = np.load(OUT + "/inputs.npz")
row = lambda k: torch.from_numpy(d[k][RANK:RANK + 1])
mean, err = grad_compress.allreduce_compressed(
    {"a": row("ga"), "b": row("gb")}, {"a": row("ea"), "b": row("eb")})
np.savez(OUT + f"/torch_rank{RANK}.npz", ma=mean["a"].numpy(),
         mb=mean["b"].numpy(), ea=err["a"].numpy(), eb=err["b"].numpy())
"""


def test_allreduce_compressed_matches_jax(tmp_path):
    """8 gloo ranks against JAX's ``shard_map`` over 8 devices: leaf
    ``a`` is JAX's test (``arange / 100``, no error feedback), leaf
    ``b`` random with a random error."""
    rng = np.random.default_rng(5)
    g = np.arange(8 * 16, dtype=np.float32).reshape(8, 16) / 100.0
    inputs = {"ga": g, "ea": np.zeros_like(g),
              "gb": rng.normal(size=(8, 16)).astype(np.float32),
              "eb": (1e-3 * rng.normal(size=(8, 16))).astype(np.float32)}
    np.savez(tmp_path / "inputs.npz", **inputs)
    run_jax(JAX_ALLREDUCE, 8, tmp_path)
    run_ranks(TORCH_ALLREDUCE, 8, tmp_path)
    want = np.load(tmp_path / "jax.npz")
    got = {k: np.concatenate([np.load(tmp_path / f"torch_rank{r}.npz")[k]
                              for r in range(8)]) for k in want.files}
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=AR_ATOL)
    for leaf in ("a", "b"):
        exact = (inputs["g" + leaf] + inputs["e" + leaf]).mean(axis=0)
        rel = (np.abs(got["m" + leaf][0] - exact).max()
               / (np.abs(exact).max() + 1e-9))
        assert rel < 0.02, (leaf, rel)


TORCH_ELASTIC = """
from repro_torch.checkpoint import Checkpointer, restore, save
from repro_torch.runtime import sharding as shd

x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
w = (torch.arange(32, dtype=torch.float32).reshape(4, 8) / 7).bfloat16()
tree = {"x": x, "w": w}
specs = {"x": ("data", "model"), "w": (None, "model")}
mesh_a = make_mesh((2, 2), ("data", "model"))
mesh_b = make_mesh((4, 1), ("data", "model"))
on_a = shd.distribute_tree(tree, specs, mesh_a)
save(OUT + "/meshed", on_a)
if RANK == 0:
    save(OUT + "/plain", tree)
ck = Checkpointer(OUT + "/ckpts")
ck.save(3, on_a, extra={"data_step": 3}, blocking=False)
ck.wait()
like = shd.distribute_tree(tree, specs, mesh_b)
got, _ = restore(OUT + "/meshed", like=like, device="cpu")
step, got2, extra = ck.restore_latest(like=like, device="cpu")
assert step == 3 and extra == {"data_step": 3}
for t in (got, got2):
    for k in tree:
        assert t[k].device_mesh is mesh_b
        assert tuple(t[k].placements) == tuple(like[k].placements)
        assert torch.equal(t[k].full_tensor(), tree[k])
        assert tuple(t[k].to_local().shape) == tuple(
            like[k].to_local().shape)
json.dump({"local_x": list(got["x"].to_local().shape)},
          open(OUT + f"/rank{RANK}.json", "w"))
"""


def test_elastic_restore_onto_another_mesh(tmp_path):
    """A tree saved from a (2, 2) mesh (gathered, written once) restores
    onto (4, 1) with the original values, and its checkpoint files are
    byte for byte an unsharded save's."""
    run_ranks(TORCH_ELASTIC, 4, tmp_path)
    for name in ("data.bin", "manifest.json"):
        assert (tmp_path / "meshed" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes()
    assert (tmp_path / "ckpts" / "step_00000003" / "data.bin"
            ).read_bytes() == (tmp_path / "plain" / "data.bin").read_bytes()
    for r in range(4):
        meta = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert meta["local_x"] == [2, 8]


def test_one_rank_mesh_trainer_matches_unmeshed():
    """A world of one (``HashStore``, no file, no port) and a (1, 1)
    mesh on the CPU: the meshed trainer's parameters and moments are
    DTensors and its losses equal the unmeshed trainer's to RUN_RTOL;
    ``make_mesh`` needs a running group, and a larger world needs a
    store path."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import close_group, init_group, make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    from repro_torch.tree import leaves

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="store_path"):
        init_group("gloo", rank=0, world_size=2)
    cfg = get_config(ARCH)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    tcfg = TrainConfig(steps=3, opt=AdamWConfig(lr=1e-3), device="cpu")
    want = Trainer(build_model(cfg), tcfg, dcfg).run()
    init_group("gloo")
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        got = Trainer(build_model(cfg), tcfg, dcfg, mesh=mesh).run()
    finally:
        close_group()
    assert all(isinstance(t, DTensor) for t in
               leaves(got["params"]) + leaves(got["opt_state"].m))
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=RUN_RTOL)


def _done(args):
    """(first, final) loss of ``launch/train``'s ``done:`` line."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--steps", "3", "--seq", "32", "--batch", "4", *args],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("done:")]
    assert len(line) == 1, res.stdout
    m = re.search(r"steps=3 first_loss=(\S+) final_loss=(\S+) "
                  r"stragglers=\d+", line[0])
    return float(m.group(1)), float(m.group(2))


def test_launch_train_devices_mesh():
    """``launch/train --devices 4 --mesh 2x2`` (4 CPU processes over
    gloo) prints one ``done:`` line, whose losses equal the unmeshed
    run's within 1e-4 (the line prints 4 decimals)."""
    meshed = _done(["--devices", "4", "--mesh", "2x2", "--device", "cpu"])
    plain = _done(["--device", "cpu"])
    np.testing.assert_allclose(meshed, plain, rtol=0,
                               atol=LAUNCH_ATOL + 1e-9)
