"""Encoder-decoder backbone for the audio family (port of
``repro.models.encdec``, whisper-large-v3).

The conv/mel frontend is a stub, as in JAX: the batch carries the
precomputed frame embeddings ``frames`` [B, S_enc, D].  The encoder is a
bidirectional transformer over the frames plus sinusoidal positions (no
rotary positions); the decoder is a causal transformer with rotary
positions and cross-attention, whose K/V are computed once from the
encoder's output and kept as the ``cross`` cache for decode.

Backends as in :mod:`repro_torch.models.attention`: with ``"cuda"`` the
encoder's self-attention runs the flash kernel non-causal, the decoder's
prefill the flash kernel causal and its decode steps the contiguous
decode kernel; the cross-attention is the plain path on both backends,
as JAX runs its ``"xla"`` path there.  The prefill takes no schedules
(the JAX prefill takes none, so its flash runs at the kernel's
defaults); the decode step takes the bundle's ``decode_attention``.

``frames`` are cast to the model's dtype on entry: the dtype of the JAX
model's ``input_specs``.  (The JAX session stacks float32 frames, which
promote a bf16 encoder to float32; the float32 smoke configs are the
same either way.)
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (ParamInit, Params, RopeTables, dense,
                                       dtype_of, mlp, mlp_params, rmsnorm,
                                       rope_tables, sinusoidal_positions,
                                       softmax_xent)
from repro_torch.models.transformer import (_head, _field,
                                            check_kernels_without_grad,
                                            check_remat, layer_params,
                                            remat_call, unstack_layers)


def _check(cfg: ModelConfig) -> None:
    """This module runs the audio family only."""
    if cfg.family != "audio":
        raise ValueError(f"models.encdec runs the audio family, got "
                         f"{cfg.family!r}")


def init_params(cfg: ModelConfig, seed: int, device: torch.device
                ) -> Params:
    """Random parameters with the JAX tree's paths, shapes and std rule
    (``embed``, the ``encoder`` and ``decoder`` stacks, ``final_norm``
    and an untied ``lm_head``), drawn on ``device`` from ``seed``."""
    _check(cfg)
    b = ParamInit(seed, dtype_of(cfg.dtype), device)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    ne, nd = cfg.encoder_layers, cfg.n_layers
    b.normal("embed", [cfg.vocab_size, d], fan_in=d, scale=float(d) ** 0.5)
    b.zeros("encoder/ln1", [ne, d])
    attn.attn_params(b, "encoder/attn", ne, d, cfg.n_heads, cfg.n_kv_heads,
                     hd, False)
    b.zeros("encoder/ln2", [ne, d])
    mlp_params(b, "encoder/mlp", ne, d, cfg.d_ff, cfg.mlp_type)
    b.zeros("encoder/final_norm", [d])
    b.zeros("decoder/ln1", [nd, d])
    attn.attn_params(b, "decoder/self", nd, d, cfg.n_heads, cfg.n_kv_heads,
                     hd, False)
    b.zeros("decoder/lnx", [nd, d])
    attn.attn_params(b, "decoder/cross", nd, d, cfg.n_heads,
                     cfg.n_kv_heads, hd, False)
    b.zeros("decoder/ln2", [nd, d])
    mlp_params(b, "decoder/mlp", nd, d, cfg.d_ff, cfg.mlp_type)
    b.zeros("final_norm", [d])
    b.normal("lm_head", [d, cfg.vocab_size], fan_in=d)
    return b.params


def _encoder_layer(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                   backend: str) -> torch.Tensor:
    """One bidirectional encoder layer (pre-norm attention and MLP, both
    residual)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        hd=cfg.resolved_head_dim, rope=None, qk_norm=False, use_rope=False)
    ctx = attn.attention(q, k, v, causal=False, backend=backend)
    x = x + attn.attn_out(ctx, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp_type)


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           backend: str = "plain", remat: str = "full") -> torch.Tensor:
    """frames [B, S_enc, D] (the stub frontend's output) -> the encoder
    output [B, S_enc, D]: sinusoidal positions added in float32, then
    the bidirectional layers (each under the ``remat`` policy when
    autograd records it) and the encoder's final norm."""
    emb = params["embed"]
    frames = frames.to(device=emb.device, dtype=emb.dtype)
    pos = sinusoidal_positions(frames.shape[1], cfg.d_model, emb.device)
    x = (frames.float() + pos).to(frames.dtype)
    stacked = {k: v for k, v in params["encoder"].items()
               if k != "final_norm"}
    for lp in unstack_layers(stacked):
        x = remat_call(lambda h, p: _encoder_layer(h, p, cfg, backend),
                       remat, x, lp)
    return rmsnorm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _cross_kv(lp_cross: Params, cfg: ModelConfig, enc_out: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """One decoder layer's cross K/V from the encoder output:
    [B, HKV, S_enc, hd] each."""
    hd = cfg.resolved_head_dim
    bsz, s, _ = enc_out.shape
    k = dense(enc_out, lp_cross["wk"]).reshape(
        bsz, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = dense(enc_out, lp_cross["wv"]).reshape(
        bsz, s, cfg.n_kv_heads, hd).transpose(1, 2)
    return {"k": k.contiguous(), "v": v.contiguous()}


def _decoder_body(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                  enc_kv: Dict[str, torch.Tensor], rope: RopeTables, *,
                  backend: str,
                  self_cache: Optional[Dict[str, torch.Tensor]] = None,
                  pos: Optional[torch.Tensor] = None, schedule=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer: causal self-attention (over the prompt, or one
    token against ``self_cache``, updated in place at ``pos``), the
    cross-attention over ``enc_kv``, the MLP.  Returns (x, the layer's
    self K/V: the prompt's, or the cache's)."""
    hd = cfg.resolved_head_dim
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(
        h, lp["self"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=hd,
        rope=rope, qk_norm=False)
    if self_cache is None:
        ctx = attn.attention(q, k, v, causal=True, backend=backend)
        kv = {"k": k, "v": v}
    else:
        ck, cv = attn.update_kv_cache(self_cache["k"], self_cache["v"],
                                      k, v, pos)
        ctx = attn.decode_attention(q, ck, cv, pos, backend=backend,
                                    schedule=schedule)
        kv = {"k": ck, "v": cv}
    x = x + attn.attn_out(ctx, lp["self"])
    h = rmsnorm(x, lp["lnx"], cfg.norm_eps)
    bsz, s, _ = h.shape
    qx = dense(h, lp["cross"]["wq"]).reshape(
        bsz, s, cfg.n_heads, hd).transpose(1, 2)
    ctx = attn.cross_attention(qx, enc_kv["k"], enc_kv["v"])
    x = x + attn.attn_out(ctx, lp["cross"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg.mlp_type), kv


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain",
            collect_kv: bool = False, remat: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced decoder logits [B, S_dec, V] (float32) of
    ``batch["tokens"]`` [B, S_dec] over ``batch["frames"]``; with
    ``collect_kv`` also ``extras["kv"]``: the decoder's self K/V
    (``k``, ``v``) and cross K/V (``xk``, ``xv``), stacked per layer.
    Under autograd each layer (its cross K/V included) runs under the
    ``remat`` policy, and ``backend="cuda"`` raises
    :class:`~repro_torch.models.transformer.KernelGradError` before any
    launch."""
    _check(cfg)
    check_remat(remat)
    check_kernels_without_grad(params, backend)
    enc_out = encode(params, cfg, batch["frames"], backend=backend,
                     remat=remat)
    emb = params["embed"]
    x = emb[batch["tokens"].to(emb.device).long()]
    rope = rope_tables(torch.arange(x.shape[1], device=x.device),
                       cfg.resolved_head_dim, cfg.rope_theta)
    ys: Dict[str, list] = {"k": [], "v": [], "xk": [], "xv": []}

    def layer(h, lp):
        """One decoder layer with its cross K/V."""
        kv_x = _cross_kv(lp["cross"], cfg, enc_out)
        h, kv = _decoder_body(h, lp, cfg, kv_x, rope, backend=backend)
        return h, kv, kv_x

    for lp in unstack_layers(params["decoder"]):
        x, kv, kv_x = remat_call(layer, remat, x, lp)
        if collect_kv:
            for name, t in (("k", kv["k"]), ("v", kv["v"]),
                            ("xk", kv_x["k"]), ("xv", kv_x["v"])):
                ys[name].append(t)
    extras: Dict[str, Any] = {}
    if collect_kv:
        extras["kv"] = {n: torch.stack(ts) for n, ts in ys.items()}
    return _head(params, cfg, x), extras


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain",
            remat: str = "full"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of a teacher-forced batch (JAX ``encdec.loss_fn``):
    the masked cross-entropy with z-loss of ``batch["labels"]``; metrics
    ``xent``, ``tokens``, ``loss``."""
    logits, _ = forward(params, cfg, batch, backend=backend, remat=remat)
    loss, denom = softmax_xent(logits, batch["labels"])
    return loss, {"xent": loss, "tokens": denom, "loss": loss}


def init_cache(cfg: ModelConfig, bsz: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    """Empty caches: ``self`` K/V [L,B,HKV,max_len,hd] and ``cross``
    K/V [L,B,HKV,S_enc,hd], in the model's dtype."""
    _check(cfg)
    dt, hd, nd = dtype_of(cfg.dtype), cfg.resolved_head_dim, cfg.n_layers

    def zeros(s: int) -> torch.Tensor:
        """One zero K or V stack of ``s`` positions."""
        return torch.zeros((nd, bsz, cfg.n_kv_heads, s, hd), dtype=dt,
                           device=device)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(cfg.encoder_seq),
                      "v": zeros(cfg.encoder_seq)}}


def prefill(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain"
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Encode the frames and run the whole prompt: (logits [B,S,V],
    ``{"self": the prompt's K/V, "cross": the encoder's K/V}``)."""
    logits, extras = forward(params, cfg, batch, backend=backend,
                             collect_kv=True)
    kv = extras["kv"]
    return logits, {"self": {"k": kv["k"], "v": kv["v"]},
                    "cross": {"k": kv["xk"], "v": kv["xv"]}}


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *, backend: str = "plain",
                schedules=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode token per row against the ``self`` and ``cross``
    caches (the encoder already ran): tokens [B, 1]; ``pos`` an int or a
    one-element integer tensor, read on the device only.  Writes the
    ``self`` cache in place at ``pos`` and returns (logits [B, 1, V]
    float32, the same cache)."""
    _check(cfg)
    dev = params["embed"].device
    x = params["embed"][tokens.to(dev).long()]
    pos = (torch.full((), int(pos), dtype=torch.int64, device=dev)
           if isinstance(pos, numbers.Integral) else
           pos.to(device=dev, dtype=torch.int64).reshape(()))
    rope = rope_tables(pos.reshape(1), cfg.resolved_head_dim,
                       cfg.rope_theta)
    sched = _field(schedules, "decode_attention")
    for i in range(cfg.n_layers):
        sc = {n: t[i] for n, t in cache["self"].items()}
        xc = {n: t[i] for n, t in cache["cross"].items()}
        x, _ = _decoder_body(x, layer_params(params["decoder"], i), cfg,
                             xc, rope, backend=backend, self_cache=sc,
                             pos=pos, schedule=sched)
    return _head(params, cfg, x), cache


__all__ = ["init_params", "encode", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step"]
