"""CapturedStep: what the executable cache stores in the port.

The JAX package's cache holds AOT-compiled XLA executables: one fixed
program per :class:`~repro_torch.serving.cache.ExecKey`, run with no
per-op host work.  The PyTorch counterpart is a CUDA graph.  A
:class:`CapturedStep` owns a step function's static input buffers, the
state it updates in place (a KV pool, recurrent states) and, on a card,
one ``torch.cuda.CUDAGraph`` of the function; :meth:`CapturedStep.replay`
runs it.

On a card the build is:

1. a warm-up call on the stream that ``torch.cuda.graph`` captures on,
   so that what a first call makes outside the stream's work exists
   before the capture: the kernel library (``kernels._build.load``),
   cuBLAS' handle and workspace for that stream, and the decode
   kernels' ticket counters, which are kept per stream;
2. the state the step updates is restored to what it held before the
   warm-up (the warm-up is part of the build, not a step);
3. the capture, into the graph's own private memory pool;
4. the wrappers' launch counts that the captured call added are kept
   (``launch_delta``) and
   the counts are set back to their values before the build: each
   replay adds the deltas, so the counters stay exact (one per kernel a
   step launches, none for the build);
5. the launch parameters the wrappers noted during the capture (kind,
   block sizes, the decode split: ``kernels/_launches.py``) are kept as
   ``launch_params``, so the card can show which schedule a graph runs.

A step whose ``timed`` is set records a CUDA event on the stream just
before each replay of its graph and one just after, and
:meth:`CapturedStep.device_seconds` reads the time between them once
the step's outputs have reached the host: the graph's time on the
card, which the host's scheduling cannot stretch but for the
microseconds between the events and the launch (the session's
watchdog judges it; host step times jitter by more than a small
model's step).

The step builders take the :class:`~repro_torch.core.schedule.
ScheduleBundle` their key carries and pass it to the model.  A rebuild
under another bundle in the middle of a run (the engine's and
``generate``'s recapture on a dispatch commit) is built over the run's
live state: the engine's pool, ``generate``'s cache; the warm-up leaves
that state as it found it, and ``generate`` copies its running inputs
(token, position, starts) into the new step.

A capture error raises out of the build; nothing here runs the step
eagerly in its place (the session retries a failed build
``compile_retries`` times, each with a new graph on a new capture
stream, and then raises, or with ``fallback_backend="eager"`` builds
the same step uncaptured, which then runs eagerly at every replay).
Where the buffers live on the CPU (the tests), or the caller passed
``capture=False`` (to time the eager path on a card), the same step
function runs directly into the same static buffers at every
:meth:`replay`.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels import _launches
from repro_torch.models.transformer import (ATTENTION_FAMILIES,
                                            MASKED_FAMILIES)


def _set_counts(counts: Dict[str, int]) -> None:
    """Set every wrapper's launch count to ``counts``."""
    for name, n in counts.items():
        kernels.WRAPPERS[name].launches = n


class CapturedStep:
    """A step function bound to static buffers, captured on a card.

    ``fn`` takes no argument: it reads ``inputs`` (name -> static
    tensor, written by :meth:`feed` or by the caller in place) and the
    tensors it closes over, and returns its outputs (any nest of
    tensors), which stay valid until the next replay.  ``state`` (name
    -> tensor) holds what ``fn`` updates in place, which the step owns
    (a graph keeps its addresses); the warm-up leaves it as it found
    it.  ``capture`` False runs ``fn`` at every replay on any device."""

    def __init__(self, fn: Callable[[], Any], device: torch.device, *,
                 inputs: Optional[Dict[str, torch.Tensor]] = None,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 capture: bool = True):
        """Build the step: on a card with ``capture``, warm up and
        capture; otherwise nothing runs until the first replay."""
        self.fn = fn
        self.device = torch.device(device)
        self.inputs = dict(inputs or {})
        self.state = dict(state or {})
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Any = None
        self.launch_delta: Dict[str, int] = {}
        self.launch_params: List[Dict[str, Any]] = []
        self.pool_bytes = 0             # the graph's private pool
        self.replays = 0
        self.timed = False
        self._events: Optional[tuple] = None
        self._timed_last = False
        self._staging: Dict[str, torch.Tensor] = {}
        self._fed: Optional[torch.cuda.Event] = None
        t0 = time.perf_counter()
        if capture and self.device.type == "cuda":
            self._capture()
        self.build_s = time.perf_counter() - t0

    def _capture(self) -> None:
        """Warm up on the capture stream, restore the state, capture.
        The wrappers' counts end as they were before the build, whether
        it succeeds or raises; a build that raises drops the shared
        capture stream, which a capture that failed partway may leave
        invalidated, so the next build (the session's retry) captures
        into a new graph on a new stream."""
        before = kernels.launch_counts()
        # no automatic collection while the step is built: a collection
        # that frees another step's graph (dead cyclic garbage) during the
        # capture invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            self._warm_up_and_capture()
        except BaseException:
            torch.cuda.graph.default_capture_stream = None
            raise
        finally:
            if collecting:
                gc.enable()
            _set_counts(before)

    def _warm_up_and_capture(self) -> None:
        """The build's steps 1-5 (module docstring)."""
        dev = self.device
        state = list(self.state.values())
        saved = [t.clone() for t in state]
        graph = torch.cuda.CUDAGraph()
        ctx = torch.cuda.graph(graph)
        stream = ctx.capture_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.fn()
        torch.cuda.current_stream(dev).wait_stream(stream)
        for t, s in zip(state, saved):
            t.copy_(s)
        del saved
        warm = kernels.launch_counts()
        # ``torch.cuda.graph`` empties the allocator's cache on entry;
        # doing it first makes the reserved bytes' growth the pool's
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        with _launches.recording() as noted:
            with ctx:
                outputs = self.fn()
        self.launch_params = noted
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = kernels.launch_counts()
        self.launch_delta = {k: after[k] - warm[k] for k in after
                             if after[k] != warm[k]}
        self.graph = graph
        self.outputs = outputs

    def feed(self, **arrays) -> None:
        """Copy host arrays into the static inputs of the same names.

        On a card each goes through a pinned staging buffer and an
        asynchronous copy on the current stream (a pageable copy would
        synchronise with the card); the staging buffers are rewritten
        only after the last feed's copies have run."""
        if self._fed is not None:
            self._fed.synchronize()
        for name, a in arrays.items():
            dst = self.inputs[name]
            src = torch.from_numpy(np.ascontiguousarray(a)).reshape(
                dst.shape)
            if dst.device.type != "cuda":
                dst.copy_(src)
                continue
            stage = self._staging.get(name)
            if stage is None:
                stage = torch.empty(dst.shape, dtype=dst.dtype,
                                    pin_memory=True)
                self._staging[name] = stage
            stage.copy_(src)
            dst.copy_(stage, non_blocking=True)
        if self._staging:
            self._fed = torch.cuda.Event()
            self._fed.record(torch.cuda.current_stream(self.device))

    def replay(self) -> Any:
        """Run the step once (the graph on a card, else ``fn``) and
        return its outputs; with ``timed``, the graph between two CUDA
        events (:meth:`device_seconds`)."""
        self._timed_last = self.timed and self.graph is not None
        if self.graph is None:
            self.outputs = self.fn()
        else:
            if self._timed_last:
                if self._events is None:
                    self._events = tuple(torch.cuda.Event(enable_timing=True)
                                         for _ in range(2))
                self._events[0].record()
            self.graph.replay()
            if self._timed_last:
                self._events[1].record()
            for name, n in self.launch_delta.items():
                kernels.WRAPPERS[name].launches += n
        self.replays += 1
        return self.outputs

    def device_seconds(self) -> Optional[float]:
        """Seconds on the card of the last replay's graph, from its
        events (None unless that replay ran a graph with ``timed``).
        Call it once the outputs have reached the host, which waits for
        the card: the end event is done by then."""
        if not self._timed_last:
            return None
        start, end = self._events
        return start.elapsed_time(end) / 1e3


# The ExecKey detail of a sampled step: it samples inside the step,
# where the JAX session samples outside its jitted step, so the two are
# other steps than the greedy ones, whose keys stay the JAX session's.
SAMPLED = ("sampled",)


def pick(last: torch.Tensor) -> torch.Tensor:
    """[2, B] int64 of the last logits [B, V]: each row's argmax and
    whether all its logits are finite (1) or not (0), so the host reads
    both with one copy."""
    return torch.stack([torch.argmax(last, dim=-1),
                        torch.isfinite(last).all(dim=-1).long()])


def sample_pick(last: torch.Tensor, noise: torch.Tensor,
                temperature: torch.Tensor) -> torch.Tensor:
    """:func:`pick` with each row's token drawn from ``softmax(last / T)``
    by the Gumbel-max rule (the rule of ``jax.random.categorical``):
    argmax of ``last / T - log(-log(u))`` for uniform ``noise`` u [B, V]
    in [0, 1), drawn outside the step; ``temperature`` is a 0-d
    tensor."""
    gumbel = -torch.log(-torch.log(noise))
    return torch.stack([torch.argmax(last / temperature + gumbel, dim=-1),
                        torch.isfinite(last).all(dim=-1).long()])


def step_inputs(bsz: int, vocab: int, dev: torch.device, *,
                sampled: bool = False, poison: bool = False
                ) -> Dict[str, torch.Tensor]:
    """The static inputs a step's pick reads besides its own: ``noise``
    [B, V] and ``temperature`` for a sampled step, ``poison`` [B] (bool:
    the rows whose logits the fault injector sets to NaN) for a step of
    a session with an injector."""
    inputs = {}
    if sampled:
        inputs["noise"] = torch.zeros((bsz, vocab), dtype=torch.float32,
                                      device=dev)
        inputs["temperature"] = torch.ones((), dtype=torch.float32,
                                           device=dev)
    if poison:
        inputs["poison"] = torch.zeros((bsz,), dtype=torch.bool,
                                       device=dev)
    return inputs


def step_pick(last: torch.Tensor, inputs: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
    """The pick of a step with the :func:`step_inputs` ``inputs``: the
    poisoned rows' logits set to NaN first, so the step's own finite
    flag reports them; then :func:`sample_pick` or :func:`pick`."""
    if "poison" in inputs:
        last = last.masked_fill(inputs["poison"][:, None], float("nan"))
    if "noise" in inputs:
        return sample_pick(last, inputs["noise"], inputs["temperature"])
    return pick(last)


def cache_state(cache: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flat ``name -> tensor`` state a step owns for a cache tree:
    the layer dict of a ``{"layers": ...}`` cache (dense, moe, ssm) as
    it is, else every leaf under its ``/``-joined path (hybrid:
    ``groups/b0/h``, ..., audio: ``self/k``, ``cross/v``, ...)."""
    if set(cache) == {"layers"}:
        return cache["layers"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict[str, Any], pre: str) -> None:
        """Collect the leaves under ``pre``."""
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                out[pre + k] = v

    walk(cache, "")
    return out


def cache_tree(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The cache tree of a :func:`cache_state` (the same tensors)."""
    if not any("/" in name for name in state):
        return {"layers": state}
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        *path, leaf = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def fit_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a prefill's cache leaf into the full-capacity ``dst`` (the
    JAX session's ``fit``): whole when the shapes agree, else into the
    leading ``src.shape`` corner of ``dst`` with the rest zeroed (a
    prompt's K/V in a longer cache, a window shorter than the
    capacity's)."""
    if dst.shape == src.shape:
        dst.copy_(src)
        return
    dst.zero_()
    dst[tuple(slice(0, n) for n in src.shape)].copy_(src)


def prefill_step(model, params, backend: str, bsz: int, length: int,
                 capture: bool, schedules=None,
                 sampled: bool = False) -> "CapturedStep":
    """The prefill of ``bsz`` rows of ``length`` tokens, the step behind
    every prefill key (the engine's batch-1 admissions and
    ``run_batch``), launching with ``schedules`` (a ScheduleBundle or
    None).  Inputs ``tokens`` [B, length], the modality fields of the
    model's family (``image_embeds``, ``frames``: ``Model.
    modality_specs``, in the model's dtype, fed like ``tokens``), for
    the left-padded families (dense, moe, ssm) ``starts`` [B], and a
    sampled step's :func:`step_inputs`; outputs (:func:`step_pick` of
    the last logits, the prefill's caches)."""
    dev = params["embed"].device
    masked = model.cfg.family in MASKED_FAMILIES
    inputs = {"tokens": torch.zeros((bsz, length), dtype=torch.int64,
                                    device=dev)}
    for name, (shape, dtype) in model.modality_specs(bsz).items():
        inputs[name] = torch.zeros(shape, dtype=dtype, device=dev)
    fields = list(inputs)
    if masked:
        inputs["starts"] = torch.zeros((bsz,), dtype=torch.int64,
                                       device=dev)
    inputs.update(step_inputs(bsz, model.cfg.vocab_size, dev,
                              sampled=sampled))

    def fn():
        """Prefill the static batch; last-token pick and caches."""
        logits, pcache = model.prefill(
            params, {n: inputs[n] for n in fields}, backend=backend,
            seq_starts=inputs["starts"] if masked else None,
            schedules=schedules)
        return step_pick(logits[:, -1], inputs), pcache

    return CapturedStep(fn, dev, inputs=inputs, capture=capture)


def recurrent_decode_step(model, params, backend: str, bsz: int,
                          capture: bool, layers=None, schedules=None,
                          sampled: bool = False,
                          poison: bool = False) -> "CapturedStep":
    """The ssm decode step of ``bsz`` rows, the step behind every ssm
    decode key, launching with ``schedules``.  Input ``tokens`` [B, 1]
    (and the :func:`step_inputs` of a sampled step or a session with an
    injector); state ``layers`` (the recurrent states, zero ones of its
    own when not given; a live run's when it is rebuilt under a new
    bundle); output :func:`step_pick` of the logits, whose token it also
    writes back into ``tokens`` (``run_batch`` replays it with no feed;
    the engine feeds its tokens before every replay).

    The engine's greedy key (rows, cap) and ``run_batch``'s (B, total)
    are equal whenever rows == B and cap == total, since a greedy
    recurrent decode key carries no detail (in JAX both entries are the
    same jitted step).  One builder for both keeps the entries of a key
    interchangeable."""
    dev = params["embed"].device
    if layers is None:
        layers = model.init_cache(bsz, 1, dev)["layers"]
    cache = {"layers": layers}
    tok = torch.zeros((bsz, 1), dtype=torch.int64, device=dev)
    inputs = {"tokens": tok, **step_inputs(bsz, model.cfg.vocab_size, dev,
                                           sampled=sampled, poison=poison)}

    def fn():
        """One recurrent step over all rows; feeds its token back."""
        lg, _ = model.decode_step(params, cache, tok, 0, backend=backend,
                                  schedules=schedules)
        picked = step_pick(lg[:, -1], inputs)
        tok.copy_(picked[0][:, None])
        return picked

    return CapturedStep(fn, dev, inputs=inputs, state=layers,
                        capture=capture)


def contiguous_decode_step(model, params, backend: str, bsz: int,
                           total: int, capture: bool, schedules=None,
                           state=None, sampled: bool = False
                           ) -> "CapturedStep":
    """``run_batch``'s decode step for a family with a contiguous cache
    (dense, moe, hybrid, vlm, audio), over a cache of ``total``
    positions (a new one, or a live run's ``state``, a
    :func:`cache_state`, when it is rebuilt under a new bundle),
    launching with ``schedules``.  Inputs ``tokens`` [B, 1], ``pos``
    (one int64), for dense and moe ``starts`` [B] (the left-pad masks;
    the other families are served unpadded), and a sampled step's
    :func:`step_inputs`; state the cache's :func:`cache_state`; output
    :func:`step_pick` of the logits, whose token it writes back into
    ``tokens`` before it advances ``pos`` (a hybrid step writes its
    rolling buffers at ``pos % W`` on the device)."""
    dev = params["embed"].device
    cache = (model.init_cache(bsz, total, dev) if state is None
             else cache_tree(state))
    masked = model.cfg.family in ATTENTION_FAMILIES
    inputs = {"tokens": torch.zeros((bsz, 1), dtype=torch.int64,
                                    device=dev),
              "pos": torch.zeros((), dtype=torch.int64, device=dev),
              **step_inputs(bsz, model.cfg.vocab_size, dev,
                            sampled=sampled)}
    if masked:
        inputs["starts"] = torch.zeros((bsz,), dtype=torch.int64,
                                       device=dev)
    tok, pos = inputs["tokens"], inputs["pos"]

    def fn():
        """One token per row; feeds it back and advances pos."""
        lg, _ = model.decode_step(
            params, cache, tok, pos, backend=backend,
            seq_starts=inputs["starts"] if masked else None,
            schedules=schedules)
        picked = step_pick(lg[:, -1], inputs)
        tok.copy_(picked[0][:, None])
        pos.add_(1)
        return picked

    return CapturedStep(fn, dev, inputs=inputs, state=cache_state(cache),
                        capture=capture)


__all__ = ["CapturedStep", "SAMPLED", "pick", "sample_pick", "step_inputs",
           "step_pick", "cache_state", "cache_tree", "fit_into",
           "prefill_step", "recurrent_decode_step",
           "contiguous_decode_step"]
