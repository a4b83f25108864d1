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
model's decode step is the engine's (a recurrent key with an equal
bundle carries no other detail, so the engine's and ``generate``'s keys
can be equal).

With a :class:`~repro_torch.runtime.dispatch.DispatchService` the loop
feeds the port's adaptive runtime, as the JAX package's does: the
prefill and every decode step are timed (synchronised) and observed
under the model's kernel shapes (:func:`serve_dispatch_problems`).  With
``backend="cuda"`` both steps are keyed by and launch with a
:class:`~repro_torch.core.schedule.ScheduleBundle` resolved per role
(committed winner > registry measurement > offline rank-0); when the
service commits a winner other than the running bundle's, the decode
step switches to the new key's step if it is cached, else is rebuilt
(recaptured) once over the live cache, within ``max_recompiles``
(:func:`switch_on_commit`, the engine's policy too).  Every decode step
of a geometry is built over its one state, the engine's pool included
when an ssm key is shared.
Every observation times the deployed step, not the candidate it is
attributed to: a commit is a traffic-level signal.  With ``"plain"``
the service still observes, and no bundle is built.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, Optional, Tuple

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


def _sync(device: torch.device) -> None:
    """Wait for the card (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    is ``build_of(new_bundle, step.state)``, over the live state, so
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


def _decode_step(model, params, backend: str, bsz: int, total: int,
                 capture: bool, schedules=None, cache=None) -> CapturedStep:
    """``generate``'s contiguous decode step for an attention family,
    over a cache of ``total`` positions (a new one, or a live run's
    ``cache`` layers when it is rebuilt under a new bundle), launching
    with ``schedules``.  Inputs ``tokens`` [B, 1], ``pos`` (one int64)
    and ``starts`` [B]; state the cache's layers; output
    :func:`~repro_torch.serving.captured.pick` of the logits, whose
    argmax it writes back into ``tokens`` before it advances ``pos``."""
    dev = params["embed"].device
    cache = (model.init_cache(bsz, total, dev) if cache is None
             else {"layers": cache})
    inputs = {"tokens": torch.zeros((bsz, 1), dtype=torch.int64,
                                    device=dev),
              "pos": torch.zeros((), dtype=torch.int64, device=dev),
              "starts": torch.zeros((bsz,), dtype=torch.int64, device=dev)}
    tok, pos = inputs["tokens"], inputs["pos"]

    def fn():
        """One token per row; feeds it back and advances pos."""
        lg, _ = model.decode_step(params, cache, tok, pos, backend=backend,
                                  seq_starts=inputs["starts"],
                                  schedules=schedules)
        picked = pick(lg[:, -1])
        tok.copy_(picked[0][:, None])
        pos.add_(1)
        return picked

    return CapturedStep(fn, dev, inputs=inputs, state=cache["layers"],
                        capture=capture)


def generate(model, params, batch: Dict[str, object], *,
             max_new_tokens: int, backend: Optional[str] = None,
             seq_starts=None, session=None,
             capture: Optional[bool] = None, dispatch=None,
             max_recompiles: Optional[int] = None
             ) -> Tuple[np.ndarray, ServeStats]:
    """Greedy continuation of a left-padded batch.

    ``batch["tokens"]`` is [B, S] (numpy or a CPU tensor); ``seq_starts``
    ([B], optional) marks each row's first real token.  Runs where
    ``params`` live.  Returns (tokens [B, max_new_tokens] int32,
    :class:`ServeStats`).

    ``dispatch`` (a :class:`~repro_torch.runtime.dispatch.
    DispatchService`) observes the prefill and every decode step; with
    ``backend="cuda"`` the steps run its :class:`ScheduleBundle`, one
    per role (ssm prefill and decode are both ``ssm_scan`` at other
    shapes, so one merged bundle would let one shadow the other), and a
    commit of another decode winner switches to the cached step of the
    new bundle or rebuilds it once over the live cache, at most
    ``max_recompiles`` times a call (default 1; 0 pins the step).

    ``session`` (a :class:`~repro_torch.serving.ServeSession`) shares its
    executable cache, and with it its ``backend``, ``capture``,
    ``dispatch`` and ``max_recompiles``: an argument of those names that
    differs from the session's raises, as does another model or params
    than the session's, since its cached steps were built against them;
    its stats count the commits this call saw.  Without a session
    ``backend`` defaults to ``"cuda"`` and ``capture`` to True;
    ``capture=False`` runs the same steps without CUDA graphs."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
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
        if dispatch is not None and dispatch is not session.dispatch:
            raise ValueError("generate(session=) runs the session's "
                             "dispatch service, not another one")
        backend, capture = session.backend, session.capture
        dispatch, max_recompiles = session.dispatch, session.max_recompiles
        exec_cache, compile_ = session.exec_cache, session._compile
    else:
        backend = "cuda" if backend is None else backend
        capture = True if capture is None else capture
        max_recompiles = 1 if max_recompiles is None else max_recompiles
        exec_cache = ExecutableCache()
        compile_ = exec_cache.get
    dev = params["embed"].device
    cfg = model.cfg
    toks = np.asarray(batch["tokens"])
    bsz, prompt_len = toks.shape
    starts = (np.zeros((bsz,), np.int64) if seq_starts is None
              else np.asarray(seq_starts).reshape(bsz))
    total = prompt_len + max_new_tokens
    arch = cfg.name
    recurrent = cfg.attention_free
    eb = params["embed"].element_size()
    scheduled = dispatch is not None and backend == "cuda"

    problems = (serve_dispatch_problems(cfg, bsz, prompt_len, total)
                if dispatch is not None else {})
    prefill_bundle = decode_bundle = None
    if dispatch is not None:
        # resolve both shapes before the timed steps: a warm registry
        # answers with zero cost-model evaluations, a cold one pays one
        # batch sweep here
        for kind, problem in problems.values():
            dispatch.resolve(kind, problem, eb)
        if scheduled:
            prefill_bundle = dispatch.schedule_bundle(
                [problems["prefill"]], eb)
            decode_bundle = dispatch.schedule_bundle([problems["decode"]],
                                                     eb)

    def decode_key(bundle) -> ExecKey:
        """Cache key of this batch shape's decode step."""
        return ExecKey(arch, "decode", bsz, total, bundle, backend)

    def build_decode(bundle, state=None):
        """Builder of the decode step under ``bundle`` over ``state``
        (a running step's, when it replaces it), else over the state of
        a cached step of its geometry (the engine's too, for an ssm
        model), else a new one: a geometry's steps hold one state."""
        def build():
            """The step, over the geometry's state."""
            live = state
            if live is None:
                entry = exec_cache.peek_geometry(decode_key(bundle))
                live = None if entry is None else entry.state
            if recurrent:
                return recurrent_decode_step(model, params, backend, bsz,
                                             capture, layers=live,
                                             schedules=bundle)
            return _decode_step(model, params, backend, bsz, total, capture,
                                schedules=bundle, cache=live)
        return build

    pf, _ = compile_(ExecKey(arch, "prefill", bsz, prompt_len,
                             prefill_bundle, backend),
                     lambda: prefill_step(model, params, backend, bsz,
                                          prompt_len, capture,
                                          schedules=prefill_bundle))
    dec, _ = compile_(decode_key(decode_bundle), build_decode(decode_bundle))

    if dispatch is not None:
        dispatch.propose(*problems["prefill"], eb)
    t0 = time.perf_counter()
    pf.feed(tokens=toks, starts=starts)
    picked, pcache = pf.replay()
    if dispatch is not None:
        _sync(dev)
        dispatch.observe(*problems["prefill"], time.perf_counter() - t0,
                         eb)
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

    counts = CommitCounts()
    t1 = time.perf_counter()
    for i in range(1, max_new_tokens):
        if dispatch is None:
            out[:, i].copy_(dec.replay()[0])
            continue
        kind, problem = problems["decode"]
        t_step = time.perf_counter()
        dispatch.propose(kind, problem, eb)
        out[:, i].copy_(dec.replay()[0])
        _sync(dev)
        dispatch.observe(kind, problem, time.perf_counter() - t_step, eb)
        if scheduled:
            dec, decode_bundle = switch_on_commit(
                dec, decode_bundle, kind,
                dispatch.committed(kind, problem, eb), key_of=decode_key,
                build_of=build_decode, contains=exec_cache.contains,
                compile_=compile_, max_recompiles=max_recompiles,
                counts=counts)
    _sync(dev)
    decode_s = time.perf_counter() - t1 - counts.recompile_s
    report = (dict(resolve_bundle_report(prefill_bundle, decode_bundle))
              if prefill_bundle is not None else None)
    stats = ServeStats(prefill_s=prefill_s, decode_s=decode_s,
                       tokens_generated=bsz * max_new_tokens,
                       backend=backend,
                       decode_tokens=bsz * (max_new_tokens - 1),
                       recompiles=counts.recompiles,
                       recompile_s=counts.recompile_s, schedules=report)
    if session is not None:
        session.stats.add_commits(counts)
    return out.cpu().numpy().astype(np.int32), stats


__all__ = ["ServeStats", "generate", "serve_dispatch_problems",
           "resolve_bundle_report", "hand_over", "CommitCounts",
           "switch_on_commit"]
