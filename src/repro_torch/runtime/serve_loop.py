"""Batched prefill plus greedy decode over a contiguous KV cache (port
of ``repro.runtime.serve_loop.generate`` and the bucketed
``ServeSession.run_batch`` body it runs).

A left-padded batch is prefilled with ``seq_starts`` masking (zeros when
not given, as the JAX session always threads them), the caches are
copied into a buffer of the full capacity, and each decode step runs one
token per row through the contiguous decode kernel (``backend="cuda"``)
with the same ``starts``.  An ssm model keeps the prefill's recurrent
states as its cache (they have no length to grow) and decodes without
``starts``: a masked prefill leaves no pad entry in a recurrent state.  There is no dispatch service, registry or
executable cache in the port yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch


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


def generate(model, params, batch: Dict[str, object], *,
             max_new_tokens: int, backend: str = "cuda",
             seq_starts=None) -> Tuple[np.ndarray, ServeStats]:
    """Greedy continuation of a left-padded batch.

    ``batch["tokens"]`` is [B, S] (numpy or tensor); ``seq_starts`` ([B],
    optional) marks each row's first real token.  Runs where ``params``
    live.  Returns (tokens [B, max_new_tokens] int32, :class:`ServeStats`).
    """
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    dev = params["embed"].device
    tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=dev)
    tokens = tokens.to(torch.int64)
    bsz, prompt_len = tokens.shape
    starts = (torch.zeros((bsz,), dtype=torch.int64, device=dev)
              if seq_starts is None else
              torch.as_tensor(np.asarray(seq_starts), device=dev)
              .to(torch.int64).reshape(bsz))
    total = prompt_len + max_new_tokens

    t0 = time.perf_counter()
    logits, pcache = model.prefill(params, {"tokens": tokens},
                                   backend=backend, seq_starts=starts)
    if model.cfg.attention_free:
        cache, dec_starts = pcache, None
    else:
        cache, dec_starts = model.init_cache(bsz, total, dev), starts
        for name in ("k", "v"):
            cache["layers"][name][..., :prompt_len, :].copy_(
                pcache["layers"][name])
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]                 # stays on the device: one copy at the end
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    del pcache, logits

    t1 = time.perf_counter()
    for i in range(max_new_tokens - 1):
        lg, cache = model.decode_step(params, cache, tok[:, None],
                                      prompt_len + i, backend=backend,
                                      seq_starts=dec_starts)
        tok = torch.argmax(lg[:, -1], dim=-1)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t1
    stats = ServeStats(prefill_s=prefill_s, decode_s=decode_s,
                       tokens_generated=bsz * max_new_tokens,
                       backend=backend,
                       decode_tokens=bsz * (max_new_tokens - 1))
    return torch.stack(out, dim=1).cpu().numpy().astype(np.int32), stats


__all__ = ["ServeStats", "generate"]
