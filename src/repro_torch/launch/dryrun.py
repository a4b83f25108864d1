"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step once on
a fake process group (port of ``repro.launch.dryrun``).

The JAX dry-run lowers and compiles each step for 512 XLA host
placeholder devices and reads the compiled module's analyses.  The port
has no compiler to ask, so it runs the step itself, on nothing:

- the mesh is a :func:`~repro_torch.launch.mesh.init_fake_group` of the
  mesh's size, in which this process is rank 0 and every collective
  returns at once;
- the arguments are fake tensors (``FakeTensorMode``: shapes, dtypes
  and strides, no storage) made from ``Model.abstract_params()``,
  ``input_specs`` and ``cache_specs``, placed as DTensors by
  ``tree_specs``, ``batch_spec`` and ``cache_specs``: each rank's local
  shard has the shape the real mesh would give it;
- the step runs once under :class:`StepCounter`, which sees rank 0's
  local ops (below DTensor) and the collectives DTensor issues.

"ok" means the step ran to its end.  ``lower_s`` is the time to place
the arguments and ``compile_s`` the time to run the step (the names of
JAX's record, which a later reader compares).

The counterparts of XLA's analyses, all on rank 0's local tensors:

- ``memory``: ``argument_bytes``, the step's inputs' local-shard bytes;
  ``output_bytes``, its outputs'; ``alias_bytes``, the outputs that are
  inputs updated in place (parameters and moments in a train step, the
  cache in a decode step); ``temp_bytes``, the peak of live bytes during
  the step above the arguments, less the new outputs live at that peak
  (tracked per storage: each op's outputs are born, and die when their
  storage is freed).  ``bytes_per_device`` is JAX's formula, arguments
  + temporaries + outputs - aliases.
- ``flops_per_device``: each local op's flops: ``torch.utils.
  flop_counter``'s formulas for the products and convolutions, and one
  flop an output element for every op tagged pointwise (as XLA counts
  an elementwise op); reductions, copies, gathers and collectives count
  none.  A product that DTensor leaves replicated is done on every
  device and counted so.
- ``bytes_per_device_accessed``: the sum of each local op's input and
  output tensor bytes (views, and queries that return no tensor, such
  as a fake tensor's device, excepted), unfused: what the eager steps
  and their captured graphs run.  XLA counts after fusion: a deliberate
  difference.
- the collectives: :class:`~repro_torch.launch.hlo_analysis.
  CollectiveRecorder`'s lines through JAX's ``parse_collectives``.

No unroll knob: the port's layers are a Python loop (every layer is
dispatched and counted), so the full config's counts are exact and the
roofline takes them.  With ``calibrate`` the cell also runs 1 and 2
scaling units and keeps JAX's ``calibration`` fields; their linear
extension to the full depth must equal the full count
(``extrapolation``, 1e-9 relative), which checks the linearity the JAX
dry-run relied on.  With ``flash_adjust`` the calibration runs on the
``"stub"`` attention and the roofline takes its extension plus
``flash_attention_cost``, as in JAX (the check then compares unlike
runs and is left out).

Importing this module sets no environment variable and starts no
group; :func:`run_cell` starts the fake group at the mesh's size and
closes it in a ``finally``.

Usage (the CPU; no card is touched):
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun.json
  python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import hlo_analysis, roofline
from repro_torch.launch.mesh import close_group, init_fake_group, \
    make_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import placed_as
from repro_torch.optim import adamw
from repro_torch.optim.schedule import constant
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.train_loop import make_train_step
from repro_torch.tree import map_tree

# relative agreement of the calibration's linear extension with the
# full count
EXTRAPOLATION_RTOL = 1e-9


# ---------------------------------------------------------------------------
# Config scaling for the two-point calibration
# ---------------------------------------------------------------------------

def scale_unit(cfg: ModelConfig) -> int:
    """Layers per scaling unit (the pattern group for hybrid, else 1)."""
    return len(cfg.block_pattern) if cfg.block_pattern else 1


def full_units(cfg: ModelConfig) -> int:
    """Scaling units of the full config."""
    return cfg.n_layers // scale_unit(cfg)


def with_units(cfg: ModelConfig, units: int) -> ModelConfig:
    """The config with ``units`` scaling units (the hybrid tail kept)."""
    u = scale_unit(cfg)
    tail = cfg.n_layers % u if cfg.block_pattern else 0
    kw: Dict[str, Any] = {"n_layers": units * u + tail}
    if cfg.encoder_layers:
        kw["encoder_layers"] = units * u + tail
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# Counting one step on rank 0's local tensors
# ---------------------------------------------------------------------------

def _tensors(tree: Any) -> List[torch.Tensor]:
    """Every tensor of a tree of dicts, NamedTuples, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def local_of(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if shd.is_dtensor(t) else t


def local_bytes(tree: Any) -> int:
    """Bytes of the local shards of a tree's tensors."""
    return sum(local_of(t).numel() * local_of(t).element_size()
               for t in _tensors(tree))


class StepCounter(hlo_analysis.CollectiveRecorder):
    """Counts a step's local ops while it is entered (see the module
    docstring): flops, bytes accessed, the collectives' lines, and the
    live bytes of every storage born inside it.  Enter it above a
    ``FakeTensorMode`` for a fake step, or alone around a real one."""

    def __init__(self, arguments: Any = ()) -> None:
        """``arguments``: the step's inputs, whose storages are not
        born in the step."""
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self._formulas = flop_registry
        self._pointwise = torch.Tag.pointwise
        self.arg_storages = {local_of(t).untyped_storage()._cdata
                             for t in _tensors(arguments)}
        # (+bytes or -bytes) in the order storages are born and freed
        self._events: List[int] = []
        self._born: Dict[int, int] = {}       # storage -> event index
        self._bytes: Dict[int, int] = {}

    def observe(self, func, args, kwargs, out) -> None:
        """Count one local op."""
        outs = _tensors(out)
        packet = func._overloadpacket
        if packet in self._formulas:
            self.flops += int(self._formulas[packet](*args, **kwargs,
                                                     out_val=out))
        elif self._pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        if outs and not func.is_view:
            ins = _tensors(list(args) + list(kwargs.values()))
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._born or key in self.arg_storages:
                continue
            self._born[key] = len(self._events)
            self._bytes[key] = st.nbytes()
            self._events.append(st.nbytes())
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        """A storage born in the step died (its address may be reused)."""
        self._events.append(-self._bytes.pop(key))
        del self._born[key]

    def peak(self, outputs: Any = ()) -> Tuple[int, int]:
        """(peak live bytes born in the step, those of them that are
        ``outputs`` live at that peak)."""
        live = best = 0
        at = -1
        for i, e in enumerate(self._events):
            live += e
            if live > best:
                best, at = live, i
        out_keys = {local_of(t).untyped_storage()._cdata
                    for t in _tensors(outputs)}
        held = sum(self._bytes[k] for k in out_keys
                   if k in self._born and self._born[k] <= at)
        return best, held

    def is_argument(self, t: torch.Tensor) -> bool:
        """True when ``t``'s local storage is an argument's."""
        return local_of(t).untyped_storage()._cdata in self.arg_storages


def count_step(fn: Callable, args: Tuple) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under a :class:`StepCounter`; JAX's
    analysis keys (see the module docstring)."""
    counter = StepCounter(args)
    # storages die by reference counts only while the step runs (a
    # collection at a moment that depends on the process's history
    # would move the peak), so the count is the same run to run
    gc.collect()
    gc.disable()
    try:
        t0 = time.time()
        with counter:
            result = fn(*args)
        run_s = time.time() - t0
    finally:
        gc.enable()
    out: Dict[str, Any] = {"compile_s": run_s}
    arg_b = local_bytes(args)
    out_b = local_bytes(result)
    alias_b = sum(local_of(t).numel() * local_of(t).element_size()
                  for t in _tensors(result) if counter.is_argument(t))
    peak, held = counter.peak(result)
    temp_b = peak - held
    out["memory"] = {"argument_bytes": arg_b, "output_bytes": out_b,
                     "temp_bytes": temp_b, "alias_bytes": alias_b}
    out["bytes_per_device"] = arg_b + temp_b + out_b - alias_b
    out["flops_per_device"] = float(counter.flops)
    out["bytes_per_device_accessed"] = float(counter.bytes_accessed)
    txt = counter.text()
    stats = hlo_analysis.parse_collectives(txt)
    out["collective_bytes_per_chip"] = stats.total_bytes
    out["collectives_by_kind"] = dict(stats.bytes_by_kind)
    out["collective_counts"] = dict(stats.count_by_kind)
    out["collective_schedule"] = hlo_analysis.collective_schedule(txt, 12)
    out["collective_text"] = txt
    del result
    return out


# ---------------------------------------------------------------------------
# Step functions + placements per shape kind
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _meta(specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
          ) -> Dict[str, torch.Tensor]:
    """``input_specs``' ``(shape, dtype)`` pairs as meta tensors."""
    return {k: torch.empty(s, dtype=dt, device=META)
            for k, (s, dt) in specs.items()}


def cell_train_step(model, **kw) -> Callable:
    """The train step a train cell runs (JAX's: default AdamW, a
    constant lr of 1e-4); ``kw`` reaches ``make_train_step``.  A real
    step built here dispatches the ops a fake cell's step does."""
    return make_train_step(model, adamw.AdamWConfig(),
                           functools.partial(constant, peak_lr=1e-4), **kw)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
               backend: str = "plain", remat: str = "full",
               zero1: bool = False, microbatches: int = 1):
    """Returns ``(fn, abstract args, specs)``: the step, its arguments
    as meta tensors (no storage), and a spec tree beside each argument
    (``None`` for a plain replicated tensor).  A train step updates its
    parameters and moments in place, a decode step its cache (JAX's
    donated arguments).

    ``zero1``: ZeRO-1 instead of FSDP, parameters replicated over the
    data axes in compute (``rules.with_overrides(embed=())``) while the
    moments stay sharded by ``rules`` (the AdamW update runs on the
    moments' shards).  ``microbatches > 1`` (without ``zero1``) places
    the gradient accumulator as the moments (the port's
    ``grad_shard_fn``)."""
    model = build_model(cfg)
    axes = model.axes_tree()
    p_abs = model.abstract_params()
    param_rules = rules.with_overrides(embed=()) if zero1 else rules
    p_specs = shd.tree_specs(axes, p_abs, mesh, param_rules)
    shard_fn = shd.make_activation_shard_fn(mesh, rules)

    if shape.kind == "train":
        m_abs = map_tree(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                               device=META), p_abs)
        m_specs = shd.tree_specs(axes, m_abs, mesh, rules)
        opt_abs = adamw.AdamWState(
            step=torch.empty((), dtype=torch.int32, device=META),
            m=m_abs, v=m_abs)
        opt_specs = adamw.AdamWState(step=None, m=m_specs, v=m_specs)
        batch_abs = _meta(model.input_specs(shape))
        b_specs = shd.batch_specs(batch_abs, mesh, rules)
        if microbatches > 1 and not zero1:
            def grad_shard_fn(tree):
                """The accumulator placed as the moments (ZeRO-2)."""
                return map_tree(
                    lambda x, s: placed_as(x, mesh,
                                           shd.placements(s, mesh)),
                    tree, m_specs)
        else:
            grad_shard_fn = lambda t: t  # noqa: E731
        fn = cell_train_step(model, shard_fn=shard_fn, backend=backend,
                             remat=remat, microbatches=microbatches,
                             grad_shard_fn=grad_shard_fn)
        return fn, (p_abs, opt_abs, batch_abs), (p_specs, opt_specs, b_specs)

    if shape.kind == "prefill":
        batch_abs = _meta(model.input_specs(shape))
        b_specs = shd.batch_specs(batch_abs, mesh, rules)

        def fn(params, batch):
            """The prefill step (no autograd)."""
            with torch.no_grad():
                return model.prefill(params, batch, shard_fn=shard_fn,
                                     backend=backend)
        return fn, (p_abs, batch_abs), (p_specs, b_specs)

    cache_abs = model.cache_specs(shape)
    c_specs = shd.cache_specs(cache_abs, mesh, rules)
    io = _meta(model.input_specs(shape))
    tok_spec = shd.batch_spec(io["tokens"].shape, mesh, rules)

    def fn(params, cache, tokens, pos):
        """The decode step (no autograd; the cache written in place)."""
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos,
                                     shard_fn=shard_fn)
    return (fn, (p_abs, cache_abs, io["tokens"], io["pos"]),
            (p_specs, c_specs, tok_spec, None))


def place(abstract: Any, specs: Any, mesh) -> Any:
    """Fake tensors (run under ``FakeTensorMode``) of an abstract tree,
    each a DTensor placed by its spec (a ``None`` spec: a plain,
    replicated tensor)."""
    if isinstance(abstract, adamw.AdamWState):
        return adamw.AdamWState(*(place(a, s, mesh)
                                  for a, s in zip(abstract, specs)))
    if isinstance(abstract, dict):
        return {k: place(v, specs[k], mesh) for k, v in abstract.items()}
    t = torch.empty(abstract.shape, dtype=abstract.dtype)
    return t if specs is None else shd.distribute(t, specs, mesh)


def lower_compile(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                  backend: str = "plain", remat: str = "full",
                  zero1: bool = False, microbatches: int = 1
                  ) -> Dict[str, Any]:
    """One fake run of the cell's step on ``mesh`` (a mesh of a running
    fake group); returns JAX's analysis keys (see the module
    docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args_abs, specs = build_cell(cfg, shape, mesh, rules, backend,
                                     remat, zero1, microbatches)
    with FakeTensorMode():
        t0 = time.time()
        args = tuple(place(a, s, mesh) for a, s in zip(args_abs, specs))
        lower_s = time.time() - t0
        out = count_step(fn, args)
    out["lower_s"] = lower_s
    return out


def _extrapolation(cal_a: Dict[str, Any], cal_b: Dict[str, Any],
                   full: Dict[str, Any], ua: int, ub: int, uf: int
                   ) -> Dict[str, Any]:
    """The calibration's linear extension of each count beside the full
    count, their relative difference, and whether every one is within
    :data:`EXTRAPOLATION_RTOL`."""
    out: Dict[str, Any] = {}
    ok = True
    for key in ("flops_per_device", "bytes_per_device_accessed",
                "collective_bytes_per_chip"):
        ext = roofline.extrapolate(cal_a[key], cal_b[key], ua, ub, uf)
        rel = abs(ext - full[key]) / max(abs(full[key]), 1.0)
        ok &= rel <= EXTRAPOLATION_RTOL
        out[key] = {"extrapolated": ext, "full": full[key], "rel": rel}
    out["ok"] = ok
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules: Optional[shd.ShardingRules] = None,
             calibrate: bool = True,
             units_ab: Tuple[int, int] = (1, 2),
             backend: str = "plain", remat: str = "full",
             mesh_shape: Optional[Tuple[int, ...]] = None,
             flash_adjust: bool = False,
             zero1: bool = False,
             microbatches: int = 1,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """One cell's record (JAX's keys): status, the full run's analyses,
    the roofline and the calibration.  Starts a fake group of the
    mesh's size and closes it at the end.  ``cfg`` and ``shape``
    override the registry's (a cut-down cell for tests)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if mesh_shape is not None:
        mesh_name = "x".join(str(d) for d in mesh_shape)
    else:
        mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "backend": backend,
                           "remat": remat, "flash_adjust": flash_adjust,
                           "zero1": zero1, "microbatches": microbatches}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    rules = rules or shd.ShardingRules()
    chips = (math.prod(mesh_shape) if mesh_shape is not None
             else 512 if multi_pod else 256)
    init_fake_group(chips)
    try:
        if mesh_shape is not None:
            axes = (("data", "model") if len(mesh_shape) == 2
                    else ("pod", "data", "model"))
            mesh = make_mesh(mesh_shape, axes)
        else:
            mesh = make_production_mesh(multi_pod=multi_pod)
        run = functools.partial(lower_compile, shape=shape, mesh=mesh,
                                rules=rules, remat=remat, zero1=zero1,
                                microbatches=microbatches)
        try:
            full = run(cfg, backend=backend)
            rec["full"] = full
            rec["status"] = "ok"
        except Exception as e:
            rec["status"] = "failed"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
            return rec
        flops_dev = full["flops_per_device"]
        bytes_dev = full["bytes_per_device_accessed"]
        coll_chip = full["collective_bytes_per_chip"]
        if calibrate:
            try:
                ua, ub = units_ab
                adjust = flash_adjust and shape.kind != "decode"
                cal_backend = "stub" if adjust else backend
                cal_a = run(with_units(cfg, ua), backend=cal_backend)
                cal_b = run(with_units(cfg, ub), backend=cal_backend)
                uf = full_units(cfg)
                if adjust:
                    ext = lambda key: roofline.extrapolate(  # noqa: E731
                        cal_a[key], cal_b[key], ua, ub, uf)
                    fc = roofline.flash_attention_cost(cfg, shape)
                    flops_dev = ext("flops_per_device") + fc["flops"] / chips
                    bytes_dev = (ext("bytes_per_device_accessed")
                                 + fc["bytes"] / chips)
                    coll_chip = ext("collective_bytes_per_chip")
                    rec["flash_cost"] = fc
                else:
                    rec["extrapolation"] = _extrapolation(cal_a, cal_b, full,
                                                          ua, ub, uf)
                rec["calibration"] = {
                    "units": [ua, ub], "full_units": uf,
                    "flops_per_device": [cal_a["flops_per_device"],
                                         cal_b["flops_per_device"]],
                    "bytes_per_device": [
                        cal_a["bytes_per_device_accessed"],
                        cal_b["bytes_per_device_accessed"]],
                    "coll_bytes": [cal_a["collective_bytes_per_chip"],
                                   cal_b["collective_bytes_per_chip"]],
                }
            except Exception as e:
                rec["calibration_error"] = f"{type(e).__name__}: {e}"
        terms = roofline.make_terms(
            arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
            hlo_flops_global=flops_dev * chips,
            hlo_bytes_global=bytes_dev * chips,
            coll_bytes_per_chip=coll_chip, cfg=cfg,
            bytes_per_device=full.get("bytes_per_device"))
        rec["roofline"] = terms.to_dict()
        return rec
    finally:
        close_group()


def main(argv: Optional[List[str]] = None) -> None:
    """The CLI: JAX's flags (``--backend`` takes ``plain`` for JAX's
    ``xla``, and ``chunked``); one line a cell."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel activation override")
    ap.add_argument("--rules-override", default=None,
                    help='JSON dict, e.g. {"seq": ["model"]}')
    ap.add_argument("--backend", default="plain",
                    choices=["plain", "chunked"],
                    help="attention backend of train/prefill steps")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "none", "moe"])
    ap.add_argument("--mesh-shape", default=None,
                    help="override data x model, e.g. 32x8 (256 cards)")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1 params (replicated compute copy) instead "
                         "of FSDP")
    ap.add_argument("--flash-adjust", action="store_true",
                    help="kernel-substitution accounting: calibrate with "
                         "attention stubbed, add the flash kernel's "
                         "analytic flops/bytes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rules = shd.ShardingRules()
    if args.seq_shard:
        rules = rules.with_overrides(seq=("model",))
    if args.rules_override:
        ov = {k: tuple(v) for k, v in
              json.loads(args.rules_override).items()}
        rules = rules.with_overrides(**ov)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)

    results = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape_name, multi_pod=mp, rules=rules,
                               calibrate=not args.no_calibrate and not mp,
                               backend=args.backend, remat=args.remat,
                               mesh_shape=mesh_shape,
                               flash_adjust=args.flash_adjust,
                               zero1=args.zero1,
                               microbatches=args.microbatch)
                rec["wall_s"] = time.time() - t0
                rec.get("full", {}).pop("collective_text", None)
                results.append(rec)
                status = rec["status"]
                extra = ""
                if "roofline" in rec:
                    r = rec["roofline"]
                    extra = " dom=%s mfu=%.3f" % (r["dominant"], r["mfu"])
                if "extrapolation" in rec:
                    extra += " extrapolation=%s" % (
                        "ok" if rec["extrapolation"]["ok"] else "FAILED")
                print(f"[{status:7s}] {arch} {shape_name} {rec['mesh']} "
                      f"({rec['wall_s']:.0f}s){extra}", flush=True)
                if status == "failed":
                    print(rec["error"], flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
