"""Training loop (port of ``repro.runtime.train_loop``): an eager
train step on torch autograd, checkpoint/restart, the straggler monitor
and the tuning registry's write-back.

The loop is a pure function of (checkpoint, data-pipeline state): a
crash at any point resumes from the last committed checkpoint, replaying
the same global batches (the pipeline is stateless-shardable).  On the
CPU a resumed run's losses equal an uninterrupted run's bit for bit.

The step trains on ``backend="plain"``, the counterpart of the JAX
package's ``"xla"`` default: the hand-written kernels have no backward
in either package, so ``backend="cuda"`` refuses to train (the
:class:`~repro_torch.models.transformer.KernelGradError`, raised before
any launch).  A trainer built with ``"cuda"`` still resolves its
:class:`~repro_torch.core.schedule.ScheduleBundle`, as the JAX trainer
built with ``"pallas"`` does.

The attention backends ``"chunked"`` and ``"stub"`` pass through to
``loss_fn`` as any backend does in JAX (``"chunked"`` trains; the stub
is the roofline's calibration stand-in).

A meshed trainer (``Trainer(..., mesh=)``, a ``DeviceMesh`` of
:mod:`repro_torch.launch.mesh`) places the parameters and both AdamW
moments as DTensors by :func:`~repro_torch.runtime.sharding.tree_specs`
over ``Model.axes_tree()``, each batch by ``batch_specs``, and passes
the activation ``shard_fn`` to ``loss_fn``.  The step counter stays a
plain scalar, the same on every rank (replicated).  Plain tensors the
model makes inside the step (rope tables, masks) join DTensors as
replicated (``implicit_replication``); each gradient, which autograd
may leave ``Partial``, is brought to its parameter's placements before
:func:`~repro_torch.optim.adamw.apply`, whose in-place chunked update
then acts on each rank's local shard.

Where the port differs: the step runs eagerly (no captured graph) and
updates the parameters and the optimizer state in place (see
:func:`repro_torch.optim.adamw.apply`).
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core import registry as reg
from repro_torch.data import DataConfig, DataPipeline, shard_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import KernelGradError
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.models.layers import identity_shard
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.ft import StragglerMonitor
from repro_torch.tree import leaves, map_tree, map_with_paths

log = logging.getLogger("repro_torch.train")

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainConfig:
    """The JAX ``TrainConfig`` (``backend="plain"``, the counterpart of
    its ``"xla"``), plus the ``device`` the run trains on (the card
    unless ``"cpu"``)."""
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    warmup_steps: int = 10
    backend: str = "plain"
    seed: int = 0
    # measured step times are written back here for later runs and the
    # offline tuner
    registry_path: Optional[str] = None
    device: DeviceLike = None


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor metric gathered to a plain tensor (others as they are)."""
    return t.full_tensor() if shd.is_dtensor(t) else t


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Gradient ``g`` with parameter ``p``'s placements (a reduce for a
    ``Partial`` gradient); plain tensors pass."""
    if shd.is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    lr_fn: Callable, *, backend: str = "plain",
                    shard_fn: Callable = identity_shard,
                    remat: str = "full", microbatches: int = 1,
                    grad_shard_fn: Callable = lambda tree: tree,
                    schedules=None) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    The gradients come from ``torch.autograd.grad`` of
    ``model.loss_fn`` (every parameter is made to require grad); then
    :func:`~repro_torch.optim.adamw.apply` at ``lr_fn(opt_state.step)``
    updates the parameters and the state in place.  ``microbatches > 1``
    splits the batch's rows and sums each microbatch's gradients in
    float32 in order, as JAX's scan does; the gradient is that sum over
    ``microbatches`` in the parameters' dtype and the metrics are the
    microbatches' means.  ``schedules`` reaches ``loss_fn`` (a
    ``"cuda"`` loss raises under autograd before any launch).  Metrics:
    the loss's, ``grad_norm`` and ``lr``, as device scalars (gathered
    from DTensors).

    ``shard_fn`` is the activation placement passed to ``loss_fn``;
    ``grad_shard_fn`` places the microbatch accumulator tree, as JAX's
    constrains it.  With DTensor parameters each gradient is brought to
    its parameter's placements (see the module docstring)."""

    def grad_of(params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """Detached metrics and the gradients in leaf order."""
        flat = leaves(params)
        for p in flat:
            if not p.requires_grad:
                p.requires_grad_(True)
        with shd.meshed(params):
            loss, metrics = model.loss_fn(params, batch, backend=backend,
                                          remat=remat, schedules=schedules,
                                          shard_fn=shard_fn)
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
            grads = [_placed_like(g, p) for g, p in zip(grads, flat)]
        return ({k: _full(v.detach()) for k, v in metrics.items()},
                list(grads))

    def train_step(params: Params, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        """One optimizer step on ``batch``."""
        if microbatches == 1:
            metrics, grads = grad_of(params, batch)
        else:
            acc = leaves(grad_shard_fn(map_tree(
                lambda p: torch.zeros_like(p, dtype=torch.float32,
                                           requires_grad=False), params)))
            ms: List[Dict[str, torch.Tensor]] = []
            for i in range(microbatches):
                m, g = grad_of(params, shard_batch(batch, i, microbatches))
                for a, gi in zip(acc, g):
                    a.add_(gi.float())
                del g
                ms.append(m)
            grads = [(a / microbatches).to(p.dtype)
                     for a, p in zip(acc, leaves(params))]
            del acc
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        it = iter(grads)
        grad_tree = map_with_paths(lambda _, p: next(it), params)
        del grads, it
        lr = lr_fn(opt_state.step)
        params2, opt2, om = adamw.apply(opt_cfg, params, grad_tree,
                                        opt_state, lr)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr"] = lr
        return params2, opt2, metrics

    return train_step


class Trainer:
    """End-to-end trainer, meshless or meshed: random init (or the
    latest checkpoint), the data pipeline fast-forwarded to the restored
    step, the eager step, async checkpoints, the straggler monitor, and
    with a registry the dispatch service fed with step times and the
    ``train_step`` write-back."""

    def __init__(self, model: Model, cfg: TrainConfig,
                 data_cfg: DataConfig, mesh=None,
                 rules: Optional[shd.ShardingRules] = None):
        """Bind the model, the run's and the data's configs; open the
        checkpoint directory and the registry; with ``backend="cuda"``
        and a registry, resolve the kernels' schedules for the model's
        prefill shape (as JAX does for ``"pallas"``).  With ``mesh`` (a
        ``DeviceMesh`` of the default process group) every rank builds
        the same trainer; ``cfg.device`` must be of the mesh's device
        type (a card mesh trains on the rank's current card)."""
        self.model = model
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.mesh = mesh
        self.rules = rules or shd.ShardingRules()
        self.device = resolve_device(cfg.device)
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot train "
                                 f"on device {self.device}")
            if self.device.type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.monitor = StragglerMonitor()
        self.ckpt = (Checkpointer(cfg.ckpt_dir)
                     if cfg.ckpt_dir else None)
        self.registry = (reg.TuningRegistry(cfg.registry_path)
                         if cfg.registry_path else None)
        # with a registry, step times feed the per-shape scheduler under
        # the model's dominant GEMM (tokens x d_ff x d_model, the MLP
        # up-projection), so training traffic tunes the record serving
        # and kernel calls consult
        self.dispatch = None
        self._gemm_problem: Optional[Dict[str, int]] = None
        schedules = None
        if self.registry is not None:
            from repro_torch.runtime.dispatch import DispatchService
            self.dispatch = DispatchService(self.registry,
                                            device=self.device)
            self._gemm_problem = {
                "m": data_cfg.global_batch * data_cfg.seq_len,
                "n": model.cfg.d_ff, "k": model.cfg.d_model}
            if cfg.backend == "cuda":
                from repro_torch.runtime.serve_loop import \
                    serve_dispatch_problems
                problem = serve_dispatch_problems(
                    model.cfg, data_cfg.global_batch, data_cfg.seq_len,
                    data_cfg.seq_len)["prefill"]
                schedules = self.dispatch.schedule_bundle([problem])
        self.schedules = schedules
        self.history: List[Dict[str, float]] = []
        lr_fn = functools.partial(
            warmup_cosine, peak_lr=cfg.opt.lr,
            warmup_steps=cfg.warmup_steps, total_steps=cfg.steps)
        shard_fn = identity_shard
        if mesh is not None:
            shard_fn = shd.make_activation_shard_fn(mesh, self.rules)
        self._step_fn = make_train_step(model, cfg.opt, lr_fn,
                                        backend=cfg.backend,
                                        shard_fn=shard_fn,
                                        schedules=schedules)

    # -- state ---------------------------------------------------------
    def init_state(self) -> Tuple[Params, AdamWState]:
        """Random parameters from ``cfg.seed`` (requiring grad) and a
        fresh optimizer state, on the trainer's device; on a mesh both
        as DTensors placed by the rules over ``Model.axes_tree()`` (every
        rank draws the same values)."""
        params = self.model.init(self.cfg.seed, self.device)
        if self.mesh is not None:
            specs = shd.tree_specs(self.model.axes_tree(), params,
                                   self.mesh, self.rules)
            params = shd.distribute_tree(params, specs, self.mesh)
        for p in leaves(params):
            p.requires_grad_(True)
        return params, adamw.init(params)

    def place_batch(self, batch: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
        """A pipeline batch on the trainer's device; on a mesh as
        DTensors placed by ``batch_specs`` (rows over the batch rule)."""
        out = {k: torch.from_numpy(v).to(self.device)
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        specs = shd.batch_specs(out, self.mesh, self.rules)
        return {k: shd.distribute(v, specs[k], self.mesh)
                for k, v in out.items()}

    # -- run -----------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train to ``steps`` (``cfg.steps`` by default), resuming from
        the latest checkpoint; returns the final params and state, the
        per-step history, the wall time and the straggler events."""
        if self.cfg.backend == "cuda":
            raise KernelGradError(
                "Trainer: backend='cuda' cannot train: the hand-written "
                "kernels have no backward; train on backend='plain'")
        steps = steps or self.cfg.steps
        params, opt_state = self.init_state()
        start_step = 0
        if self.ckpt is not None:
            restored = self.ckpt.restore_latest(
                like={"params": params, "opt": opt_state},
                device=self.device)
            if restored is not None:
                start_step, tree, _ = restored
                params, opt_state = tree["params"], tree["opt"]
                for p in leaves(params):
                    p.requires_grad_(True)
                log.info("restored step %d", start_step)

        pipe = DataPipeline(self.data_cfg, state=None)
        # fast-forward the pipeline to the restored step
        for _ in range(start_step):
            pipe.next()

        t_total = time.time()
        try:
            for step in range(start_step, steps):
                batch = self.place_batch(pipe.next())
                if self.dispatch is not None:
                    self.dispatch.propose("matmul", self._gemm_problem)
                t0 = time.time()
                params, opt_state, metrics = self._step_fn(
                    params, opt_state, batch)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.time() - t0
                if self.dispatch is not None and step > start_step:
                    # skip the first step (warm-up); feed steady times only
                    self.dispatch.observe("matmul", self._gemm_problem, dt)
                self.monitor.record(step, dt)
                rec = {k: float(v) for k, v in metrics.items()}
                rec["step"] = step
                rec["dt"] = dt
                self.history.append(rec)
                if step % self.cfg.log_every == 0:
                    log.info("step %d loss %.4f dt %.3fs", step,
                             rec["loss"], dt)
                if (self.ckpt is not None and (step + 1)
                        % self.cfg.ckpt_every == 0):
                    self.ckpt.save(step + 1,
                                   {"params": params, "opt": opt_state},
                                   extra={"data_step": step + 1},
                                   blocking=False)
        finally:
            pipe.close()
            if self.ckpt is not None:
                self.ckpt.wait()
            self._write_back_step_time()
        return {"params": params, "opt_state": opt_state,
                "history": self.history,
                "wall_time": time.time() - t_total,
                "stragglers": [e.as_dict() for e in self.monitor.events]}

    def _write_back_step_time(self) -> None:
        """Persist the median step time but the first (the warm-up) to
        the registry as a ``train_step`` measurement under the device's
        runtime fingerprint."""
        if self.registry is None or len(self.history) < 2:
            return
        dts = [r["dt"] for r in self.history[1:]]
        key = reg.RegistryKey.make(
            "train_step",
            {"arch": self.model.cfg.name,
             "global_batch": self.data_cfg.global_batch,
             "seq_len": self.data_cfg.seq_len,
             "backend": self.cfg.backend},
            reg.runtime_fingerprint(self.device), "measured")
        self.registry.record_measurement(
            key, {"type": "train_step", "arch": self.model.cfg.name},
            float(np.median(dts)))


__all__ = ["TrainConfig", "make_train_step", "Trainer"]
