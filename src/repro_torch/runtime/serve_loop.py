"""Batched prefill plus greedy decode over a contiguous KV cache (port
of ``repro.runtime.serve_loop.generate`` and the bucketed
``ServeSession.run_batch`` body it runs).

A left-padded batch is prefilled with ``seq_starts`` masking (zeros when
not given, as the JAX session always threads them), the caches are
copied into a buffer of the full capacity, and each decode step runs one
token per row through the contiguous decode kernel (``backend="cuda"``)
with the same ``starts``.  An ssm model keeps the prefill's recurrent
states as its cache (they have no length to grow) and decodes without
``starts``: a masked prefill leaves no pad entry in a recurrent state.

Both steps come from an :class:`~repro_torch.serving.cache.ExecutableCache`
keyed as the JAX session keys them (prefill ``(B, prompt_len)``, decode
``(B, prompt_len + max_new_tokens)``): the session's cache with
``session=``, else one of the call's own.  On a card each is a captured
CUDA graph (:class:`~repro_torch.serving.captured.CapturedStep`).  The
decode step owns its cache (and, for attention, a device ``pos``) and
feeds its argmax back as the next token, so the decode loop is
``max_new_tokens - 1`` replays, each followed by one device copy of its
tokens into the output, and one copy to the host at the end.  An ssm
model's decode step is the engine's (a recurrent key carries no detail,
so the engine's and ``generate``'s keys can be equal).
There is no dispatch service or registry in the port's serve loop yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.cache import ExecKey, ExecutableCache
from repro_torch.serving.captured import (CapturedStep, pick, prefill_step,
                                          recurrent_decode_step)


@dataclasses.dataclass
class ServeStats:
    """Timings and token count of one batch (host clock, synchronised)."""

    prefill_s: float
    decode_s: float
    tokens_generated: int           # every delivered token
    backend: str = "cuda"
    decode_tokens: int = 0          # tokens made by decode steps only

    @property
    def decode_tok_s(self) -> float:
        """Decode-step tokens per second of decode-step time (each
        row's first token comes from the prefill and is not counted)."""
        return self.decode_tokens / max(self.decode_s, 1e-9)


def _sync(device: torch.device) -> None:
    """Wait for the card (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_step(model, params, backend: str, bsz: int, total: int,
                 capture: bool) -> CapturedStep:
    """``generate``'s contiguous decode step for an attention family,
    over a cache of ``total`` positions.  Inputs ``tokens`` [B, 1],
    ``pos`` (one int64) and ``starts`` [B]; state the cache's layers;
    output :func:`~repro_torch.serving.captured.pick` of the logits,
    whose argmax it writes back into ``tokens`` before it advances
    ``pos``."""
    dev = params["embed"].device
    cache = model.init_cache(bsz, total, dev)
    inputs = {"tokens": torch.zeros((bsz, 1), dtype=torch.int64,
                                    device=dev),
              "pos": torch.zeros((), dtype=torch.int64, device=dev),
              "starts": torch.zeros((bsz,), dtype=torch.int64, device=dev)}
    tok, pos = inputs["tokens"], inputs["pos"]

    def fn():
        """One token per row; feeds it back and advances pos."""
        lg, _ = model.decode_step(params, cache, tok, pos, backend=backend,
                                  seq_starts=inputs["starts"])
        picked = pick(lg[:, -1])
        tok.copy_(picked[0][:, None])
        pos.add_(1)
        return picked

    return CapturedStep(fn, dev, inputs=inputs, state=cache["layers"],
                        capture=capture)


def generate(model, params, batch: Dict[str, object], *,
             max_new_tokens: int, backend: Optional[str] = None,
             seq_starts=None, session=None,
             capture: Optional[bool] = None
             ) -> Tuple[np.ndarray, ServeStats]:
    """Greedy continuation of a left-padded batch.

    ``batch["tokens"]`` is [B, S] (numpy or a CPU tensor); ``seq_starts``
    ([B], optional) marks each row's first real token.  Runs where
    ``params`` live.  Returns (tokens [B, max_new_tokens] int32,
    :class:`ServeStats`).

    ``session`` (a :class:`~repro_torch.serving.ServeSession`) shares its
    executable cache, and with it its ``backend`` and ``capture``: an
    argument of those names that differs from the session's raises, as
    does another model or params than the session's, since its cached
    steps were built against them.  Without a session ``backend``
    defaults to ``"cuda"`` and ``capture`` to True; ``capture=False``
    runs the same steps without CUDA graphs."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if session is not None:
        if session.model is not model or session.params is not params:
            raise ValueError(
                "generate(session=) runs the session's own model/params: "
                "its cached steps were built against them; build a new "
                "ServeSession for different weights")
        for name, mine, its in (("backend", backend, session.backend),
                                ("capture", capture, session.capture)):
            if mine is not None and mine != its:
                raise ValueError(
                    f"generate(session=) runs the session's {name} "
                    f"{its!r}, not {mine!r}")
        backend, capture, compile_ = (session.backend, session.capture,
                                      session._compile)
    else:
        backend = "cuda" if backend is None else backend
        capture = True if capture is None else capture
        compile_ = ExecutableCache().get
    dev = params["embed"].device
    toks = np.asarray(batch["tokens"])
    bsz, prompt_len = toks.shape
    starts = (np.zeros((bsz,), np.int64) if seq_starts is None
              else np.asarray(seq_starts).reshape(bsz))
    total = prompt_len + max_new_tokens
    arch = model.cfg.name
    recurrent = model.cfg.attention_free
    if recurrent:
        def build_decode():
            return recurrent_decode_step(model, params, backend, bsz,
                                         capture)
    else:
        def build_decode():
            return _decode_step(model, params, backend, bsz, total,
                                capture)
    pf, _ = compile_(ExecKey(arch, "prefill", bsz, prompt_len, None, backend),
                     lambda: prefill_step(model, params, backend, bsz,
                                          prompt_len, capture))
    dec, _ = compile_(ExecKey(arch, "decode", bsz, total, None, backend),
                      build_decode)

    t0 = time.perf_counter()
    pf.feed(tokens=toks, starts=starts)
    picked, pcache = pf.replay()
    state, ins = dec.state, dec.inputs
    for name, t in pcache["layers"].items():
        if recurrent:
            state[name].copy_(t)
        else:
            state[name].zero_()
            state[name][..., :prompt_len, :].copy_(t)
    ins["tokens"].copy_(picked[0][:, None])
    if not recurrent:
        ins["pos"].fill_(prompt_len)
        ins["starts"].copy_(pf.inputs["starts"])
    out = torch.empty((bsz, max_new_tokens), dtype=torch.int64, device=dev)
    out[:, 0].copy_(picked[0])
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    for i in range(1, max_new_tokens):
        out[:, i].copy_(dec.replay()[0])
    _sync(dev)
    decode_s = time.perf_counter() - t1
    stats = ServeStats(prefill_s=prefill_s, decode_s=decode_s,
                       tokens_generated=bsz * max_new_tokens,
                       backend=backend,
                       decode_tokens=bsz * (max_new_tokens - 1))
    return out.cpu().numpy().astype(np.int32), stats


__all__ = ["ServeStats", "generate"]
