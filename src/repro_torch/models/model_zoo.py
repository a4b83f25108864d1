"""Model facade and the prompt-padding helpers (port of
``repro.models.model_zoo``).

``build_model(cfg)`` returns a :class:`Model` whose methods are the
functional entry points of :mod:`repro_torch.models.transformer`, or of
:mod:`repro_torch.models.encdec` for the audio family.
``Model.init`` places the weights on the CUDA card unless it is given
``device="cpu"``; the other entry points run where the parameters are.
``Model.axes_tree`` and ``Model.abstract_params`` build the logical-axes
tree and the parameters' shapes and dtypes on the meta device (nothing
drawn, no storage), the inputs of :mod:`repro_torch.runtime.sharding`.
Every entry point takes ``shard_fn`` (default: the identity), passed to
the model where the JAX package passes its own.  ``forward``,
``prefill`` and ``decode_step`` of DTensor parameters (a mesh) run under
``implicit_replication`` (:func:`~repro_torch.runtime.sharding.meshed`),
as the train step does, so that the plain tensors a step makes (rope
tables, masks, positions) join the DTensors as replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import dtype_of, identity_shard

META = torch.device("meta")


def _meshed(params):
    """:func:`repro_torch.runtime.sharding.meshed` (imported at the call:
    ``repro_torch.runtime`` imports this module)."""
    from repro_torch.runtime.sharding import meshed
    return meshed(params)


def _no_audio_masks(seq_starts=None, block_tables=None) -> None:
    """The audio family takes neither left-pad masks nor block tables."""
    if seq_starts is not None or block_tables is not None:
        raise ValueError("seq_starts/block_tables are not supported for "
                         "family 'audio'")


@dataclasses.dataclass(frozen=True)
class Model:
    """One architecture's entry points (every family of the JAX
    package)."""

    cfg: ModelConfig

    @property
    def audio(self) -> bool:
        """True for the encoder-decoder (audio) family."""
        return self.cfg.family == "audio"

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
        """Random parameters from ``seed`` on ``device`` (CUDA by default;
        raises without a card unless ``device="cpu"``)."""
        return self._init_fn()(self.cfg, seed, resolve_device(device))

    def _init_fn(self):
        """The family's ``init_params``."""
        return encdec.init_params if self.audio else transformer.init_params

    def axes_tree(self) -> Dict[str, Any]:
        """The logical-axes tree: beside every parameter path, a tuple of
        one axis name (or None) a dimension, JAX's ``Model.axes_tree``.
        Built on the meta device: nothing is drawn."""
        return self._init_fn()(self.cfg, 0, META, with_axes=True)[1]

    def abstract_params(self) -> Dict[str, Any]:
        """The parameter tree as meta tensors: shapes and dtypes, no
        storage (JAX's ``ShapeDtypeStruct`` tree)."""
        return self._init_fn()(self.cfg, 0, META)

    def loss_fn(self, params, batch, *, backend: str = "plain",
                remat: str = "full", schedules=None,
                shard_fn: Callable = identity_shard):
        """(loss, metrics) of a teacher-forced batch; see
        :func:`transformer.loss_fn` (audio: :func:`encdec.loss_fn`, which
        takes no schedules, as in JAX).  Trains on ``"plain"`` (or
        ``"chunked"``); ``"cuda"`` only under ``torch.no_grad()``."""
        if self.audio:
            return encdec.loss_fn(params, self.cfg, batch, backend=backend,
                                  remat=remat, shard_fn=shard_fn)
        return transformer.loss_fn(params, self.cfg, batch, backend=backend,
                                   remat=remat, schedules=schedules,
                                   shard_fn=shard_fn)

    def forward(self, params, batch, *, backend: str = "plain",
                seq_starts=None, schedules=None,
                shard_fn: Callable = identity_shard):
        """Teacher-forced logits and extras; see
        :func:`transformer.forward` (audio: :func:`encdec.forward`)."""
        with _meshed(params):
            if self.audio:
                _no_audio_masks(seq_starts)
                return encdec.forward(params, self.cfg, batch,
                                      backend=backend, shard_fn=shard_fn)
            return transformer.forward(params, self.cfg, batch,
                                       backend=backend,
                                       seq_starts=seq_starts,
                                       schedules=schedules,
                                       shard_fn=shard_fn)

    def prefill(self, params, batch, *, backend: str = "plain",
                seq_starts=None, schedules=None,
                shard_fn: Callable = identity_shard):
        """Logits plus filled caches; see :func:`transformer.prefill`
        (``schedules``: a ScheduleBundle or None).  The audio prefill
        (:func:`encdec.prefill`) takes no schedules, as in JAX: its
        kernels launch at their defaults."""
        with _meshed(params):
            if self.audio:
                _no_audio_masks(seq_starts)
                return encdec.prefill(params, self.cfg, batch,
                                      backend=backend, shard_fn=shard_fn)
            return transformer.prefill(params, self.cfg, batch,
                                       backend=backend,
                                       seq_starts=seq_starts,
                                       schedules=schedules,
                                       shard_fn=shard_fn)

    def decode_step(self, params, cache, tokens, pos, *,
                    backend: str = "plain", seq_starts=None,
                    block_tables=None, schedules=None,
                    shard_fn: Callable = identity_shard):
        """One token per row; see :func:`transformer.decode_step` (audio:
        :func:`encdec.decode_step`)."""
        with _meshed(params):
            if self.audio:
                _no_audio_masks(seq_starts, block_tables)
                return encdec.decode_step(params, self.cfg, cache, tokens,
                                          pos, backend=backend,
                                          schedules=schedules,
                                          shard_fn=shard_fn)
            return transformer.decode_step(params, self.cfg, cache, tokens,
                                           pos, backend=backend,
                                           seq_starts=seq_starts,
                                           block_tables=block_tables,
                                           schedules=schedules,
                                           shard_fn=shard_fn)

    def init_cache(self, bsz: int, max_len: int, device: torch.device):
        """Empty contiguous caches (ssm: zero recurrent states; hybrid:
        rolling K/V and RG-LRU states; audio: self and cross K/V) on
        ``device``."""
        if self.audio:
            return encdec.init_cache(self.cfg, bsz, max_len, device)
        return transformer.init_cache(self.cfg, bsz, max_len, device)

    def modality_specs(self, bsz: int
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """``{name: (shape, dtype)}`` of the batch fields besides
        ``tokens`` that a prefill of ``bsz`` rows takes, in the model's
        dtype: ``image_embeds`` [B, N_img, D] (vlm), ``frames`` [B,
        S_enc, D] (audio); none for the other families."""
        cfg = self.cfg
        dt = dtype_of(cfg.dtype)
        if cfg.family == "vlm":
            return {"image_embeds": ((bsz, cfg.num_image_tokens,
                                      cfg.d_model), dt)}
        if cfg.family == "audio":
            return {"frames": ((bsz, cfg.encoder_seq, cfg.d_model), dt)}
        return {}

    def input_specs(self, bsz: Union[int, ShapeConfig],
                    seq_len: Optional[int] = None, kind: str = "prefill"
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """``{name: (shape, dtype)}`` of a step's batch (JAX
        ``input_specs``): a decode step's ``tokens`` [B, 1] and ``pos``;
        a prefill's or training step's :meth:`modality_specs` and
        ``tokens`` (a vlm batch's ``seq_len`` counts its image tokens,
        the text is the rest), with ``labels`` [B, seq_len] for
        ``kind="train"``.  ``bsz`` may be a :class:`ShapeConfig`, whose
        global batch, sequence and kind are taken, as JAX's takes one."""
        if isinstance(bsz, ShapeConfig):
            bsz, seq_len, kind = bsz.global_batch, bsz.seq_len, bsz.kind
        i32 = torch.int32
        if kind == "decode":
            return {"tokens": ((bsz, 1), i32), "pos": ((), i32)}
        specs = self.modality_specs(bsz)
        s_text = seq_len - (self.cfg.num_image_tokens
                            if self.cfg.family == "vlm" else 0)
        specs["tokens"] = ((bsz, s_text), i32)
        if kind == "train":
            specs["labels"] = ((bsz, seq_len), i32)
        return specs

    def cache_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """The decode cache tree of a shape cell as meta tensors (JAX
        ``Model.cache_specs``): no storage."""
        return self.init_cache(shape.global_batch, shape.seq_len, META)

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
