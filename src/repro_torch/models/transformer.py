"""Dense decoder-only LM (port of ``repro.models.transformer``, dense
family only; the other families raise ``NotImplementedError``).

Entry points: ``forward`` (logits), ``prefill`` (logits plus the K/V
caches), ``decode_step`` (one token against a contiguous cache, or
against a block-paged pool with ``block_tables``).  Layer weights are
stacked ``[L, ...]`` as in the JAX pytree and the layer loop is a Python
loop over views, where JAX scans.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamInit, Params, RopeTables,
                                       dtype_of, mlp, mlp_params, rmsnorm,
                                       rope_tables)


def _dense_only(cfg: ModelConfig) -> None:
    """Raise for a family the port does not serve yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch ports the dense family only so far, got "
            f"{cfg.family!r}")


def init_params(cfg: ModelConfig, seed: int, device: torch.device
                ) -> Params:
    """Random parameters with the JAX tree's paths, shapes and std rule,
    drawn on ``device`` from a generator seeded with ``seed``."""
    _dense_only(cfg)
    b = ParamInit(seed, dtype_of(cfg.dtype), device)
    d, hd, n = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    b.normal("embed", [cfg.vocab_size, d], fan_in=d, scale=float(d) ** 0.5)
    b.zeros("layers/ln1", [n, d])
    attn.attn_params(b, "layers/attn", n, d, cfg.n_heads, cfg.n_kv_heads,
                     hd, cfg.qk_norm)
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
                starts: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prefill layer; returns (x, k, v)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        hd=cfg.resolved_head_dim, rope=rope, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps)
    ctx = attn.attention(q, k, v, backend=backend, starts=starts)
    x = x + attn.attn_out(ctx, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp_type), k, v


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
            seq_starts: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced logits [B, S, V] (float32) and, with
    ``collect_kv``, the per-layer K/V stacked as ``[L,B,HKV,S,hd]``.

    ``seq_starts`` ([B] int) marks the first real token of each
    left-padded row: rope positions become ``arange(S) - starts`` and pad
    keys are masked out of attention."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.to(params["embed"].device).long()]
    bsz, seq, _ = x.shape
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
                              rope, backend=backend, starts=st)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    extras: Dict[str, Any] = {}
    if collect_kv:
        extras["kv"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return _head(params, cfg, x), extras


def prefill(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain",
            seq_starts: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the whole prompt: (logits [B,S,V], caches filled up to S)."""
    logits, extras = forward(params, cfg, batch, backend=backend,
                             collect_kv=True, seq_starts=seq_starts)
    return logits, {"layers": extras["kv"]}


def init_cache(cfg: ModelConfig, bsz: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    """Empty contiguous caches ``[L, B, HKV, max_len, hd]``."""
    _dense_only(cfg)
    dt = dtype_of(cfg.dtype)
    shape = (cfg.n_layers, bsz, cfg.n_kv_heads, max_len,
             cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     device: torch.device) -> Dict[str, Any]:
    """Empty block-paged pools ``[L, NB, HKV, bs, hd]``: ``n_blocks``
    shared blocks of ``block_size`` slots, addressed through per-row
    block tables."""
    _dense_only(cfg)
    dt = dtype_of(cfg.dtype)
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size,
             cfg.resolved_head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def _decode_block(x: torch.Tensor, lp: Params, ck: torch.Tensor,
                  cv: torch.Tensor, cfg: ModelConfig, pos, rope: RopeTables,
                  *, backend: str, starts: Optional[torch.Tensor],
                  tables: Optional[torch.Tensor],
                  slots: Optional[torch.Tensor]) -> torch.Tensor:
    """One decode layer; updates this layer's cache (or pool) in place."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        hd=cfg.resolved_head_dim, rope=rope, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps)
    if tables is not None:
        attn.paged_update_kv(ck, cv, k, v, slots)
        ctx = attn.paged_decode_attention(q, ck, cv, tables, pos,
                                          backend=backend)
    else:
        attn.update_kv_cache(ck, cv, k, v, pos)
        ctx = attn.decode_attention(q, ck, cv, pos, backend=backend,
                                    starts=starts)
    x = x + attn.attn_out(ctx, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp_type)


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *, backend: str = "plain",
                seq_starts: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens [B, 1]; ``pos`` an int (shared write
    position) or, with ``block_tables`` [B,MB], a per-row [B] tensor.
    Returns (logits [B, 1, V] float32, cache).

    The cache is updated in place (the JAX version returns a new one);
    the returned dict is the one passed in.  ``seq_starts`` continues a
    masked :func:`prefill`'s left-pad masks on the contiguous layout."""
    _dense_only(cfg)
    dev = params["embed"].device
    x = params["embed"][tokens.to(dev).long()]
    starts = (None if seq_starts is None else
              torch.as_tensor(seq_starts, device=dev).to(torch.int64))
    tables = slots = None
    if block_tables is not None:
        tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
        pos = torch.as_tensor(pos, device=dev).to(torch.int64)
        _, hkv, bs, _ = cache["layers"]["k"].shape[1:]
        slots = attn.paged_slots(tables, pos, hkv, bs)
        positions = pos[:, None]                           # [B, 1]
    elif starts is not None:
        positions = (int(pos) - starts)[:, None]           # [B, 1]
    else:
        positions = torch.full((1,), int(pos), device=dev)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _decode_block(x, layer_params(params["layers"], i),
                          cache["layers"]["k"][i], cache["layers"]["v"][i],
                          cfg, pos, rope, backend=backend, starts=starts,
                          tables=tables, slots=slots)
    return _head(params, cfg, x), cache


__all__ = ["init_params", "layer_params", "forward", "prefill",
           "init_cache", "init_paged_cache", "decode_step"]
