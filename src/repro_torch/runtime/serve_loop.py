"""The serving loop of the port (port of ``repro.runtime.serve_loop``):
``generate``, the kernel-shape problems a serving run feeds the
dispatch service, and the commit policy the engine and the bucketed
path share.

:func:`generate` is a thin client of
:meth:`~repro_torch.serving.session.ServeSession.run_batch`, as the JAX
``generate`` is: a left-padded batch is prefilled with ``seq_starts``
masking (zeros when not given), the caches are copied into a buffer of
the full capacity, and each decode step runs one token per row through
the contiguous decode kernel (``backend="cuda"``) with the same
``starts``; an ssm model keeps the prefill's recurrent states as its
cache and decodes without ``starts``.  Both steps come from the
session's :class:`~repro_torch.serving.cache.ExecutableCache` (the
caller's ``session=``, else one of the call's own), keyed as the JAX
session keys them, and are captured CUDA graphs on a card.

With a :class:`~repro_torch.runtime.dispatch.DispatchService` the
prefill and every decode step are observed under the model's kernel
shapes (:func:`serve_dispatch_problems`); with ``backend="cuda"`` both
steps are keyed by and launch with a
:class:`~repro_torch.core.schedule.ScheduleBundle` resolved per role,
and a commit of another decode winner goes through
:func:`switch_on_commit`: the new key's step if it is cached, else one
rebuild (recapture) over the live state within ``max_recompiles``.
Every observation times the deployed step, not the candidate it is
attributed to: a commit is a traffic-level signal.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.captured import CapturedStep


@dataclasses.dataclass
class ServeStats:
    """Timings and token count of one batch (host clock, synchronised)."""

    prefill_s: float
    decode_s: float
    tokens_generated: int           # every delivered token
    backend: str = "cuda"
    decode_tokens: int = 0          # tokens made by decode steps only
    # recapture-on-commit accounting: decode steps rebuilt mid-stream,
    # the wall time those builds took (kept out of decode_s), and the
    # schedules the final steps ran with (serialised bundle fields; on
    # a kind collision, ssm prefill and decode both "ssm_scan", the
    # decode entry wins)
    recompiles: int = 0
    recompile_s: float = 0.0
    schedules: Optional[Dict[str, Any]] = None

    @property
    def decode_tok_s(self) -> float:
        """Decode-step tokens per second of decode-step time (each
        row's first token comes from the prefill and is not counted)."""
        return self.decode_tokens / max(self.decode_s, 1e-9)


def serve_dispatch_problems(cfg, bsz: int, prompt_len: int, total: int,
                            ) -> Dict[str, Tuple[str, Dict[str, int]]]:
    """The kernel-shape problems a serving run of ``cfg`` exercises:
    ``{"prefill": (kind, problem), "decode": (kind, problem)}`` (the JAX
    package's, field for field).

    Attention families map to (flash_attention, decode_attention) over
    the config's head geometry; SSMs map to the fused scan at prompt
    length (prefill) and one token (decode)."""
    if cfg.family == "ssm":
        return {
            "prefill": ("ssm_scan", {"bt": bsz, "seq": prompt_len,
                                     "di": cfg.d_inner,
                                     "n": cfg.ssm_state}),
            "decode": ("ssm_scan", {"bt": bsz, "seq": 1,
                                    "di": cfg.d_inner,
                                    "n": cfg.ssm_state}),
        }
    hd = cfg.resolved_head_dim
    # VLM prefill attends over image tokens + text tokens.
    prefill_s = prompt_len + (cfg.num_image_tokens
                              if cfg.family == "vlm" else 0)
    return {
        "prefill": ("flash_attention", {"b": bsz, "hq": cfg.n_heads,
                                        "hkv": cfg.n_kv_heads,
                                        "s": prefill_s, "d": hd,
                                        "causal": True}),
        "decode": ("decode_attention", {"b": bsz, "hq": cfg.n_heads,
                                        "hkv": cfg.n_kv_heads,
                                        "s": total, "d": hd}),
    }


@functools.lru_cache(maxsize=512)
def resolve_bundle_report(prefill_bundle, decode_bundle
                          ) -> Dict[str, Any]:
    """Serialised ``ServeStats.schedules`` for a (prefill, decode)
    bundle pair; the decode entry wins a kind collision.  Memoised on
    the frozen bundles (callers copy before mutating)."""
    report = {k: v for k, v in prefill_bundle.to_dict().items()
              if v is not None}
    report.update({k: v for k, v in decode_bundle.to_dict().items()
                   if v is not None})
    base = {k: None for k in decode_bundle.to_dict()}
    return {**base, **report}


def hand_over(old: CapturedStep, new: CapturedStep) -> None:
    """Carry a running step's state and inputs into the step that
    replaces it mid-run (after a commit): a step rebuilt over the live
    state shares its tensors, a cached step of another bundle gets
    copies."""
    for name, t in old.state.items():
        if new.state[name] is not t:
            new.state[name].copy_(t)
    for name, t in old.inputs.items():
        if new.inputs[name] is not t:
            new.inputs[name].copy_(t)


@dataclasses.dataclass
class CommitCounts:
    """What the commits of other decode winners did in one run (an
    engine activation or a ``generate`` call)."""

    commits_seen: int = 0
    free_switches: int = 0
    recompiles: int = 0
    recompile_s: float = 0.0        # kept out of the run's decode time
    blocked: bool = False           # the budget spent on an uncached commit


def switch_on_commit(step: CapturedStep, bundle, kind: str, committed, *,
                     key_of, build_of, contains, compile_,
                     max_recompiles: int, counts: CommitCounts):
    """The one policy of the engine and ``generate`` for a committed
    decode winner other than ``bundle``'s: switch to the new key's step
    if it is cached (free), else build it once within ``max_recompiles``
    a run, else keep ``step`` pinned for the rest of the run.  A build
    is ``build_of(new_bundle, step.state)`` (a ``make(backend,
    capture)`` for the session's ``compile_``), over the live state, so
    every decode step of a geometry holds one state.  Returns the step
    and bundle to run on, the old step's state and inputs handed over."""
    if counts.blocked or committed is None or committed == bundle.get(kind):
        return step, bundle
    new_bundle = bundle.replace(**{kind: committed})
    new_key = key_of(new_bundle)
    counts.commits_seen += 1
    build = build_of(new_bundle, step.state)
    if contains(new_key):
        new, _ = compile_(new_key, build)
        counts.free_switches += 1
    elif counts.recompiles < max_recompiles:
        t0 = time.perf_counter()
        new, _ = compile_(new_key, build)
        counts.recompile_s += time.perf_counter() - t0
        counts.recompiles += 1
    else:
        counts.blocked = True
        return step, bundle
    hand_over(step, new)
    return new, new_bundle


def generate(model, params, batch: Dict[str, object], *,
             max_new_tokens: int, temperature: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             backend: Optional[str] = None, seq_starts=None, session=None,
             capture: Optional[bool] = None, dispatch=None,
             max_recompiles: Optional[int] = None, registry=None
             ) -> Tuple[np.ndarray, ServeStats]:
    """Greedy (or sampled) continuation of a left-padded batch.

    ``batch["tokens"]`` is [B, S] (numpy or a CPU tensor), with the
    family's modality fields beside it (``image_embeds`` for vlm,
    ``frames`` for audio), which go to the prefill as they are;
    ``seq_starts`` ([B], optional; dense, moe and ssm only) marks each
    row's first real token.  Runs where ``params`` live.  Returns (tokens [B, max_new_tokens] int32,
    :class:`ServeStats`).

    ``temperature`` None defers to the session's (0.0, greedy, for the
    call's own session); above 0 each token is drawn from
    ``softmax(logits / T)`` on noise from ``generator`` (a
    ``torch.Generator`` on the params' device, where the JAX package
    takes ``rng``; None: one seeded 0 for the call).

    ``dispatch`` (a :class:`~repro_torch.runtime.dispatch.
    DispatchService`) observes the prefill and every decode step; with
    ``backend="cuda"`` the steps run its :class:`ScheduleBundle`, one
    per role, and a commit of another decode winner switches to the
    cached step of the new bundle or rebuilds it once over the live
    cache, at most ``max_recompiles`` times a call (default 1; 0 pins
    the step).  ``registry`` receives the ``serve_decode`` write-back.

    ``session`` (a :class:`~repro_torch.serving.ServeSession`) runs the
    call (:meth:`~repro_torch.serving.ServeSession.run_batch`) and
    shares its executable cache, and with it its ``backend``,
    ``capture``, ``dispatch``, ``max_recompiles`` and ``registry``: an
    argument of those names that differs from the session's raises, as
    does another model or params than the session's, since its cached
    steps were built against them.  Without a session the call makes
    its own, with ``backend`` ``"cuda"`` and ``capture`` True by
    default (``capture=False`` runs the same steps without CUDA
    graphs)."""
    from repro_torch.serving.session import ServeSession
    if session is not None:
        if session.model is not model or session.params is not params:
            raise ValueError(
                "generate(session=) runs the session's own model/params: "
                "its cached steps were built against them; build a new "
                "ServeSession for different weights")
        for name, mine, its in (("backend", backend, session.backend),
                                ("capture", capture, session.capture),
                                ("max_recompiles", max_recompiles,
                                 session.max_recompiles)):
            if mine is not None and mine != its:
                raise ValueError(
                    f"generate(session=) runs the session's {name} "
                    f"{its!r}, not {mine!r}")
        for name, mine, its in (("dispatch", dispatch, session.dispatch),
                                ("registry", registry, session.registry)):
            if mine is not None and mine is not its:
                raise ValueError(f"generate(session=) runs the session's "
                                 f"{name}, not another one")
    else:
        session = ServeSession(
            model, params, backend="cuda" if backend is None else backend,
            capture=True if capture is None else capture,
            dispatch=dispatch, registry=registry,
            max_recompiles=1 if max_recompiles is None else max_recompiles)
    return session.run_batch(batch, max_new_tokens=max_new_tokens,
                             temperature=temperature, generator=generator,
                             seq_starts=seq_starts)


__all__ = ["ServeStats", "generate", "serve_dispatch_problems",
           "resolve_bundle_report", "hand_over", "CommitCounts",
           "switch_on_commit"]
