"""Decoder-only LM (port of ``repro.models.transformer``) for the dense
and ssm (Mamba-1) families; the other families raise
``NotImplementedError``.

Entry points: ``forward`` (logits), ``prefill`` (logits plus the decode
caches: K/V for dense, the final SSM and conv states for ssm),
``decode_step`` (one token against a contiguous cache or recurrent
state, or, for dense, against a block-paged pool with ``block_tables``).
Layer weights are stacked ``[L, ...]`` as in the JAX pytree and the
layer loop is a Python loop over views, where JAX scans.  ``schedules``
(a :class:`~repro_torch.core.schedule.ScheduleBundle`, or None) carries
the committed launch parameters of the ``"cuda"`` kernels: its
``flash_attention`` field reaches the prefill's flash kernel, its
``decode_attention`` field both decode kernels, its ``ssm_scan`` field
the scan in prefill and decode; a None field keeps a kernel's default.
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import (ParamInit, Params, RopeTables,
                                       dtype_of, mlp, mlp_params, rmsnorm,
                                       rope_tables)


SERVED_FAMILIES = ("dense", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port does not serve yet."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"repro_torch serves the {' and '.join(SERVED_FAMILIES)} "
            f"families so far, got {cfg.family!r}")


def init_params(cfg: ModelConfig, seed: int, device: torch.device
                ) -> Params:
    """Random parameters with the JAX tree's paths, shapes and std rule,
    drawn on ``device`` from a generator seeded with ``seed``."""
    _check_family(cfg)
    b = ParamInit(seed, dtype_of(cfg.dtype), device)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    b.normal("embed", [cfg.vocab_size, d], fan_in=d, scale=float(d) ** 0.5)
    b.zeros("layers/ln1", [n, d])
    if cfg.family == "ssm":
        ssm.mamba_params(b, "layers/mamba", n, d, cfg.d_inner,
                         cfg.ssm_state, cfg.ssm_conv, cfg.resolved_dt_rank)
    else:
        attn.attn_params(b, "layers/attn", n, d, cfg.n_heads,
                         cfg.n_kv_heads, hd, cfg.qk_norm)
        b.zeros("layers/ln2", [n, d])
        mlp_params(b, "layers/mlp", n, d, cfg.d_ff, cfg.mlp_type)
    b.zeros("final_norm", [d])
    if not cfg.tie_embeddings:
        b.normal("lm_head", [d, cfg.vocab_size], fan_in=d)
    return b.params


def layer_params(stacked: Params, i: int) -> Params:
    """Views of layer ``i`` of a stacked ``[L, ...]`` parameter tree."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def _attn_block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                rope: RopeTables, *, backend: str,
                starts: Optional[torch.Tensor], schedule=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prefill layer; returns (x, k, v)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        hd=cfg.resolved_head_dim, rope=rope, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps)
    ctx = attn.attention(q, k, v, backend=backend, starts=starts,
                         schedule=schedule)
    x = x + attn.attn_out(ctx, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp_type), k, v


def _mamba_block(x: torch.Tensor, lp: Params, cfg: ModelConfig, *,
                 backend: str, cache: Optional[Dict[str, torch.Tensor]] = None,
                 seq_valid: Optional[torch.Tensor] = None, schedule=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One Mamba layer (pre-norm, residual); returns (x, new states)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, states = ssm.mamba_block(h, lp["mamba"], state=cfg.ssm_state,
                                conv=cfg.ssm_conv,
                                dt_rank=cfg.resolved_dt_rank, cache=cache,
                                backend=backend, seq_valid=seq_valid,
                                schedule=schedule)
    return x + y, states


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor
          ) -> torch.Tensor:
    """Final norm and LM head; float32 logits from float32 operands, so a
    bf16 model's logits are not rounded to bf16 (as the JAX head's
    ``preferred_element_type=float32`` does not round them)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].t()
    return torch.matmul(x.float(), head.float())


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain",
            collect_kv: bool = False,
            seq_starts: Optional[torch.Tensor] = None, schedules=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced logits [B, S, V] (float32) and, with
    ``collect_kv``, the per-layer decode caches: for dense the K/V
    stacked as ``[L,B,HKV,S,hd]`` (``extras["kv"]``), for ssm the final
    states ``{"ssm": [L,B,Di,N], "conv": [L,B,K-1,Di]}``
    (``extras["state"]``).

    ``seq_starts`` ([B] int) marks the first real token of each
    left-padded row: rope positions become ``arange(S) - starts`` and pad
    keys are masked out of attention (ssm: pads are masked out of the
    recurrence, see :func:`repro_torch.models.ssm.mamba_block`)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.to(params["embed"].device).long()]
    bsz, seq, _ = x.shape
    if cfg.family == "ssm":
        return _ssm_forward(params, cfg, x, backend=backend,
                            collect=collect_kv, seq_starts=seq_starts,
                            schedule=_field(schedules, "ssm_scan"))
    fa_sched = _field(schedules, "flash_attention")
    if seq_starts is not None:
        st = torch.as_tensor(seq_starts, device=x.device).to(torch.int64)
        positions = torch.arange(seq, device=x.device)[None, :] - st[:, None]
    else:
        st = None
        positions = torch.arange(seq, device=x.device)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, k, v = _attn_block(x, layer_params(params["layers"], i), cfg,
                              rope, backend=backend, starts=st,
                              schedule=fa_sched)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    extras: Dict[str, Any] = {}
    if collect_kv:
        extras["kv"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return _head(params, cfg, x), extras


def _field(schedules, kind: str):
    """A bundle's schedule for ``kind`` (None without a bundle)."""
    return None if schedules is None else schedules.get(kind)


def _ssm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 backend: str, collect: bool,
                 seq_starts: Optional[torch.Tensor], schedule=None
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The Mamba layer stack of :func:`forward` on embedded ``x``."""
    seq_valid = None
    if seq_starts is not None:
        st = torch.as_tensor(seq_starts, device=x.device).to(torch.int64)
        seq_valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                     >= st[:, None])
    ssms, convs = [], []
    for i in range(cfg.n_layers):
        x, states = _mamba_block(x, layer_params(params["layers"], i), cfg,
                                 backend=backend, seq_valid=seq_valid,
                                 schedule=schedule)
        if collect:
            ssms.append(states["ssm"])
            convs.append(states["conv"])
    extras: Dict[str, Any] = {}
    if collect:
        extras["state"] = {"ssm": torch.stack(ssms),
                           "conv": torch.stack(convs)}
    return _head(params, cfg, x), extras


def prefill(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain",
            seq_starts: Optional[torch.Tensor] = None, schedules=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the whole prompt: (logits [B,S,V], caches filled up to S; for
    ssm the recurrent states after the last token)."""
    logits, extras = forward(params, cfg, batch, backend=backend,
                             collect_kv=True, seq_starts=seq_starts,
                             schedules=schedules)
    return logits, {"layers": extras["state" if cfg.family == "ssm"
                                     else "kv"]}


def init_cache(cfg: ModelConfig, bsz: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    """Empty contiguous caches ``[L, B, HKV, max_len, hd]``; for ssm the
    zero states ``{"ssm": [L,B,Di,N], "conv": [L,B,K-1,Di]}`` in the
    model dtype (``max_len`` unused: the state is O(1) per row)."""
    _check_family(cfg)
    dt = dtype_of(cfg.dtype)
    if cfg.family == "ssm":
        per_row = ssm.mamba_cache_init(cfg.n_layers * bsz, cfg.d_inner,
                                       cfg.ssm_state, cfg.ssm_conv, dt,
                                       device)
        return {"layers": {k: v.reshape(cfg.n_layers, bsz, *v.shape[1:])
                           for k, v in per_row.items()}}
    shape = (cfg.n_layers, bsz, cfg.n_kv_heads, max_len,
             cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device: torch.device) -> Dict[str, Any]:
    """Empty block-paged pools ``[L, NB, HKV, bs, hd]``: ``n_blocks``
    shared blocks of ``block_size`` slots, addressed through per-row
    block tables.  Attention families only: a recurrent state is O(1)
    per row and needs no paging (ssm raises ``ValueError``, as JAX)."""
    _check_family(cfg)
    if cfg.family != "dense":
        raise ValueError(f"paged KV caches need an attention family, got "
                         f"{cfg.family!r}")
    dt = dtype_of(cfg.dtype)
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size,
             cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def _decode_block(x: torch.Tensor, lp: Params, ck: torch.Tensor,
                  cv: torch.Tensor, cfg: ModelConfig, pos, rope: RopeTables,
                  *, backend: str, starts: Optional[torch.Tensor],
                  tables: Optional[torch.Tensor],
                  slots: Optional[torch.Tensor], schedule=None
                  ) -> torch.Tensor:
    """One decode layer; updates this layer's cache (or pool) in place."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        hd=cfg.resolved_head_dim, rope=rope, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps)
    if tables is not None:
        attn.paged_update_kv(ck, cv, k, v, slots)
        ctx = attn.paged_decode_attention(q, ck, cv, tables, pos,
                                          backend=backend,
                                          schedule=schedule)
    else:
        attn.update_kv_cache(ck, cv, k, v, pos)
        ctx = attn.decode_attention(q, ck, cv, pos, backend=backend,
                                    starts=starts, schedule=schedule)
    x = x + attn.attn_out(ctx, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp_type)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *, backend: str = "plain",
                seq_starts: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                schedules=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens [B, 1]; ``pos`` the shared write position
    (an int, or an integer tensor of one element, which the step reads
    on the device only, as the JAX step takes a traced ``pos``) or,
    with ``block_tables`` [B,MB], a per-row [B] tensor.  Returns (logits
    [B, 1, V] float32, cache).

    The cache is updated in place (the JAX version returns a new one);
    the returned dict is the one passed in.  ``seq_starts`` continues a
    masked :func:`prefill`'s left-pad masks on the contiguous layout.

    For ssm, ``pos`` is unused and each layer's SSM and conv states are
    advanced by one token; ``block_tables`` and ``seq_starts`` raise
    ``ValueError`` as in JAX (a recurrent state carries no pad entries
    and needs no paging)."""
    _check_family(cfg)
    dev = params["embed"].device
    x = params["embed"][tokens.to(dev).long()]
    if cfg.family == "ssm":
        if block_tables is not None:
            raise ValueError(f"block_tables needs an attention family, "
                             f"got {cfg.family!r}")
        if seq_starts is not None:
            raise ValueError(
                f"seq_starts in decode_step needs an attention family, "
                f"got {cfg.family!r} (recurrent caches carry no pad "
                f"entries)")
        layers = cache["layers"]
        for i in range(cfg.n_layers):
            lc = {"ssm": layers["ssm"][i], "conv": layers["conv"][i]}
            x, new = _mamba_block(x, layer_params(params["layers"], i),
                                  cfg, backend=backend, cache=lc,
                                  schedule=_field(schedules, "ssm_scan"))
            lc["ssm"].copy_(new["ssm"])
            lc["conv"].copy_(new["conv"])
        return _head(params, cfg, x), cache
    starts = (None if seq_starts is None else
              torch.as_tensor(seq_starts, device=dev).to(torch.int64))
    tables = slots = None
    if block_tables is not None:
        tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
        pos = torch.as_tensor(pos, device=dev).to(torch.int64)
        _, hkv, bs, _ = cache["layers"]["k"].shape[1:]
        slots = attn.paged_slots(tables, pos, hkv, bs)
        positions = pos[:, None]                           # [B, 1]
    else:
        # one int64 element on the device: an int is filled there, a
        # tensor is only viewed, so no host value of it is read
        pos = (torch.full((), int(pos), dtype=torch.int64, device=dev)
               if isinstance(pos, numbers.Integral) else
               pos.to(device=dev, dtype=torch.int64).reshape(()))
        positions = (pos.reshape(1) if starts is None
                     else (pos - starts)[:, None])         # [1] or [B, 1]
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _decode_block(x, layer_params(params["layers"], i),
                          cache["layers"]["k"][i], cache["layers"]["v"][i],
                          cfg, pos, rope, backend=backend, starts=starts,
                          tables=tables, slots=slots,
                          schedule=_field(schedules, "decode_attention"))
    return _head(params, cfg, x), cache


__all__ = ["init_params", "layer_params", "forward", "prefill",
           "init_cache", "init_paged_cache", "decode_step"]
