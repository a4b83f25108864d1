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
   exact (one per kernel a step launches, none for the build).

A capture error raises out of the build; nothing runs the step eagerly
in its place.  Where the buffers live on the CPU (the tests), or the
caller passed ``capture=False`` (to time the eager path on a card), the
same step function runs directly into the same static buffers at every
:meth:`replay`.  The device of the buffers, or the caller, makes that
choice, never a failure.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import kernels


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
        self.pool_bytes = 0             # the graph's private pool
        self.replays = 0
        self._staging: Dict[str, torch.Tensor] = {}
        self._fed: Optional[torch.cuda.Event] = None
        t0 = time.perf_counter()
        if capture and self.device.type == "cuda":
            self._capture()
        self.build_s = time.perf_counter() - t0

    def _capture(self) -> None:
        """Warm up on the capture stream, restore the state, capture."""
        dev = self.device
        before = kernels.launch_counts()
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
        with ctx:
            outputs = self.fn()
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        after = kernels.launch_counts()
        self.launch_delta = {k: after[k] - warm[k] for k in after
                             if after[k] != warm[k]}
        _set_counts(before)
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


def pick(last: torch.Tensor) -> torch.Tensor:
    """[2, B] int64 of the last logits [B, V]: each row's argmax and
    whether all its logits are finite (1) or not (0), so the host reads
    both with one copy."""
    return torch.stack([torch.argmax(last, dim=-1),
                        torch.isfinite(last).all(dim=-1).long()])


def prefill_step(model, params, backend: str, bsz: int, length: int,
                 capture: bool) -> "CapturedStep":
    """The masked prefill of ``bsz`` left-padded rows of ``length``
    tokens, the step behind every prefill key (the engine's batch-1
    admissions and ``generate``).  Inputs ``tokens`` [B, length] and
    ``starts`` [B]; outputs (:func:`pick` of the last logits, the
    prefill's caches)."""
    dev = params["embed"].device
    inputs = {"tokens": torch.zeros((bsz, length), dtype=torch.int64,
                                    device=dev),
              "starts": torch.zeros((bsz,), dtype=torch.int64, device=dev)}

    def fn():
        """Prefill the static tokens; last-token pick and caches."""
        logits, pcache = model.prefill(params, {"tokens": inputs["tokens"]},
                                       backend=backend,
                                       seq_starts=inputs["starts"])
        return pick(logits[:, -1]), pcache

    return CapturedStep(fn, dev, inputs=inputs, capture=capture)


def recurrent_decode_step(model, params, backend: str, bsz: int,
                          capture: bool, layers=None) -> "CapturedStep":
    """The ssm decode step of ``bsz`` rows, the step behind every ssm
    decode key.  Input ``tokens`` [B, 1]; state ``layers`` (the
    recurrent states, zero ones of its own when not given); output
    :func:`pick` of the logits, whose argmax it also writes back into
    ``tokens`` (``generate`` replays it with no feed; the engine feeds
    its tokens before every replay).

    The engine's key (rows, cap) and ``generate``'s (B, total) are equal
    whenever rows == B and cap == total, since a recurrent decode key
    carries no detail (in JAX both entries are the same jitted step).
    One builder for both keeps the entries of a key interchangeable."""
    dev = params["embed"].device
    if layers is None:
        layers = model.init_cache(bsz, 1, dev)["layers"]
    cache = {"layers": layers}
    tok = torch.zeros((bsz, 1), dtype=torch.int64, device=dev)

    def fn():
        """One recurrent step over all rows; feeds its argmax back."""
        lg, _ = model.decode_step(params, cache, tok, 0, backend=backend)
        picked = pick(lg[:, -1])
        tok.copy_(picked[0][:, None])
        return picked

    return CapturedStep(fn, dev, inputs={"tokens": tok}, state=layers,
                        capture=capture)


__all__ = ["CapturedStep", "pick", "prefill_step", "recurrent_decode_step"]
