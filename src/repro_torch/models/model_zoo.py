"""Model facade and the prompt-padding helpers (port of
``repro.models.model_zoo``).

``build_model(cfg)`` returns a :class:`Model` whose methods are the
functional entry points of :mod:`repro_torch.models.transformer`.
``Model.init`` places the weights on the CUDA card unless it is given
``device="cpu"``; the other entry points run where the parameters are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    """One architecture's entry points (dense, moe and ssm families)."""

    cfg: ModelConfig

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
        """Random parameters from ``seed`` on ``device`` (CUDA by default;
        raises without a card unless ``device="cpu"``)."""
        return transformer.init_params(self.cfg, seed,
                                       resolve_device(device))

    def prefill(self, params, batch, *, backend: str = "plain",
                seq_starts=None, schedules=None):
        """Logits plus filled caches; see :func:`transformer.prefill`
        (``schedules``: a ScheduleBundle or None)."""
        return transformer.prefill(params, self.cfg, batch,
                                   backend=backend, seq_starts=seq_starts,
                                   schedules=schedules)

    def decode_step(self, params, cache, tokens, pos, *,
                    backend: str = "plain", seq_starts=None,
                    block_tables=None, schedules=None):
        """One token per row; see :func:`transformer.decode_step`."""
        return transformer.decode_step(params, self.cfg, cache, tokens,
                                       pos, backend=backend,
                                       seq_starts=seq_starts,
                                       block_tables=block_tables,
                                       schedules=schedules)

    def init_cache(self, bsz: int, max_len: int, device: torch.device):
        """Empty contiguous caches (ssm: zero recurrent states) on
        ``device``."""
        return transformer.init_cache(self.cfg, bsz, max_len, device)

    def init_paged_cache(self, n_blocks: int, block_size: int,
                         device: torch.device):
        """Empty block-paged pools on ``device`` (attention families)."""
        return transformer.init_paged_cache(self.cfg, n_blocks, block_size,
                                            device)


def build_model(cfg: ModelConfig) -> Model:
    """The :class:`Model` facade for ``cfg``."""
    return Model(cfg=cfg)


def bucket_length(n: int, lengths: Optional[Tuple[int, ...]] = None,
                  align: int = 8) -> int:
    """Smallest padded length that fits ``n`` tokens: the smallest entry
    of ``lengths`` that is >= n, or else the smallest power of two >= n,
    floored at ``align``."""
    if n <= 0:
        raise ValueError(f"cannot bucket a length of {n}")
    if lengths:
        fitting = [int(b) for b in lengths if b >= n]
        if not fitting:
            raise ValueError(
                f"no bucket in {sorted(lengths)} fits length {n}")
        return min(fitting)
    m = align
    while m < n:
        m *= 2
    return m


def left_pad_prompts(prompts: Sequence, target_len: int,
                     pad_id: int = 0) -> np.ndarray:
    """Stack 1-D prompts into one [B, target_len] int32 array, left-padded
    with ``pad_id`` (pass :func:`prompt_starts` as ``seq_starts``)."""
    out = np.full((len(prompts), target_len), int(pad_id), dtype=np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, dtype=np.int32).reshape(-1)
        if len(p) > target_len:
            raise ValueError(
                f"prompt of length {len(p)} exceeds bucket {target_len}")
        if len(p):
            out[i, target_len - len(p):] = p
    return out


def prompt_starts(prompts: Sequence, target_len: int) -> np.ndarray:
    """[B] int32 first real token index of each left-padded row."""
    starts = np.empty((len(prompts),), dtype=np.int32)
    for i, p in enumerate(prompts):
        n = int(np.asarray(p).reshape(-1).shape[0])
        if n > target_len:
            raise ValueError(
                f"prompt of length {n} exceeds bucket {target_len}")
        starts[i] = target_len - n
    return starts


__all__ = ["Model", "build_model", "bucket_length", "left_pad_prompts",
           "prompt_starts"]
