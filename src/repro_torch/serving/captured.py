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
   (``launch_delta``) and the counts are set back to their values
   before the build: each replay adds the delta, so the counters stay
   exact (one per kernel a step launches, none for the build);
5. the launch parameters the wrappers noted during the capture (kind,
   block sizes, the decode split: ``kernels/_launches.py``) are kept as
   ``launch_params``, so the card can show which schedule a graph runs.

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
        return its outputs."""
        if self.graph is None:
            self.outputs = self.fn()
        else:
            self.graph.replay()
            for name, n in self.launch_delta.items():
                kernels.WRAPPERS[name].launches += n
        self.replays += 1
        return self.outputs


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


def prefill_step(model, params, backend: str, bsz: int, length: int,
                 capture: bool, schedules=None,
                 sampled: bool = False) -> "CapturedStep":
    """The masked prefill of ``bsz`` left-padded rows of ``length``
    tokens, the step behind every prefill key (the engine's batch-1
    admissions and ``run_batch``), launching with ``schedules`` (a
    ScheduleBundle or None).  Inputs ``tokens`` [B, length] and
    ``starts`` [B] (and a sampled step's :func:`step_inputs`); outputs
    (:func:`step_pick` of the last logits, the prefill's caches)."""
    dev = params["embed"].device
    inputs = {"tokens": torch.zeros((bsz, length), dtype=torch.int64,
                                    device=dev),
              "starts": torch.zeros((bsz,), dtype=torch.int64, device=dev),
              **step_inputs(bsz, model.cfg.vocab_size, dev,
                            sampled=sampled)}

    def fn():
        """Prefill the static tokens; last-token pick and caches."""
        logits, pcache = model.prefill(params, {"tokens": inputs["tokens"]},
                                       backend=backend,
                                       seq_starts=inputs["starts"],
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
                           cache=None, sampled: bool = False
                           ) -> "CapturedStep":
    """``run_batch``'s contiguous decode step for an attention family,
    over a cache of ``total`` positions (a new one, or a live run's
    ``cache`` layers when it is rebuilt under a new bundle), launching
    with ``schedules``.  Inputs ``tokens`` [B, 1], ``pos`` (one int64)
    and ``starts`` [B] (and a sampled step's :func:`step_inputs`); state
    the cache's layers; output :func:`step_pick` of the logits, whose
    token it writes back into ``tokens`` before it advances ``pos``."""
    dev = params["embed"].device
    cache = (model.init_cache(bsz, total, dev) if cache is None
             else {"layers": cache})
    inputs = {"tokens": torch.zeros((bsz, 1), dtype=torch.int64,
                                    device=dev),
              "pos": torch.zeros((), dtype=torch.int64, device=dev),
              "starts": torch.zeros((bsz,), dtype=torch.int64, device=dev),
              **step_inputs(bsz, model.cfg.vocab_size, dev,
                            sampled=sampled)}
    tok, pos = inputs["tokens"], inputs["pos"]

    def fn():
        """One token per row; feeds it back and advances pos."""
        lg, _ = model.decode_step(params, cache, tok, pos, backend=backend,
                                  seq_starts=inputs["starts"],
                                  schedules=schedules)
        picked = step_pick(lg[:, -1], inputs)
        tok.copy_(picked[0][:, None])
        pos.add_(1)
        return picked

    return CapturedStep(fn, dev, inputs=inputs, state=cache["layers"],
                        capture=capture)


__all__ = ["CapturedStep", "SAMPLED", "pick", "sample_pick", "step_inputs",
           "step_pick", "prefill_step", "recurrent_decode_step",
           "contiguous_decode_step"]
