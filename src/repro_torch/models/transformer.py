"""Decoder-only LM (port of ``repro.models.transformer``) for the dense,
moe, ssm (Mamba-1), hybrid (recurrentgemma) and vlm (paligemma)
families; the audio family is :mod:`repro_torch.models.encdec`.  A moe
layer is a dense one whose MLP is the routed expert FFN
(:mod:`repro_torch.models.moe`).  A vlm model is a dense decoder whose
input is the image's patch embeddings followed by the text tokens.  A
hybrid model repeats ``block_pattern`` (rglru, rglru, attn) in stacked
``groups`` and runs the remainder of ``n_layers`` as an explicit
``tail``; its attention is local (a ``local_window`` once the sequence
is longer) and its decode cache a rolling buffer of ``min(local_window,
capacity)`` slots.

Entry points: ``forward`` (logits), ``prefill`` (logits plus the decode
caches: K/V for dense and vlm, the final SSM and conv states for ssm,
both for hybrid, its K/V in rolling-slot order), ``decode_step`` (one
token against a contiguous cache or recurrent state, or, for dense,
against a block-paged pool with ``block_tables``).
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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (ParamInit, Params, RopeTables,
                                       copy_local_, dtype_of, embed_lookup,
                                       identity_shard, mlp,
                                       mlp_params, rmsnorm, rope_tables,
                                       softmax_xent)
from repro_torch.tree import leaves


SERVED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the families this module runs (audio is models/encdec.py)
DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
# the families whose layers attend over a paged or left-padded cache
ATTENTION_FAMILIES = ("dense", "moe")
# the families whose prefill takes ``seq_starts`` (left padding)
MASKED_FAMILIES = ("dense", "moe", "ssm")
# the vocabulary columns a bf16 head upcasts to float32 at a time
HEAD_CHUNK = 16384
# what a layer keeps for the backward pass (JAX ``_remat``): "full"
# recomputes the layer, "dots" keeps the outputs of its plain (2-D)
# matrix products, "moe" the tensors named ``moe_in`` and ``moe_out``
# (:func:`~repro_torch.models.layers.checkpoint_name`), "none" keeps
# everything
REMAT_POLICIES = ("full", "dots", "none", "moe")


class KernelGradError(RuntimeError):
    """``backend="cuda"`` under autograd: the hand-written kernels have
    no backward (in either package), so a launch would cut the attention
    or the scan out of the graph and give wrong gradients.  Raised before
    any launch; train on ``backend="plain"``, and take a ``"cuda"`` loss
    (or serve weights that require grad, a trainer's) under
    ``torch.no_grad()``."""


def check_kernels_without_grad(params: Params, backend: str) -> None:
    """Raise :class:`KernelGradError` when ``backend`` is ``"cuda"``,
    grad is enabled and a parameter requires it."""
    if (backend == "cuda" and torch.is_grad_enabled()
            and any(t.requires_grad for t in leaves(params))):
        raise KernelGradError(
            "backend='cuda' cannot run under autograd: the hand-written "
            "kernels have no backward; use backend='plain' to train, or "
            "torch.no_grad() for a forward-only loss")


_MM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep 2-D matrix products (JAX's
    ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _MM_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _keep_named(ctx, op, *args, **kwargs):
    """The "moe" policy: keep the ``checkpoint_name`` aliases."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.alias.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


_SELECTIVE = {"dots": _keep_dots, "moe": _keep_named}


def check_remat(remat: str) -> None:
    """Raise for a policy not in :data:`REMAT_POLICIES`."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                         f"{remat!r}")


def remat_call(fn: Callable, remat: str, x: torch.Tensor, lp: Params):
    """``fn(x, lp)`` under the remat policy: through
    ``torch.utils.checkpoint`` (non-reentrant) when autograd records it
    (grad enabled and ``x`` or a leaf of ``lp`` requires grad), directly
    otherwise (serving, ``no_grad``, ``"none"``).  A policy changes what
    the backward pass keeps, never a number."""
    if remat == "none" or not torch.is_grad_enabled() or not (
            x.requires_grad or any(t.requires_grad for t in leaves(lp))):
        return fn(x, lp)
    policy = _SELECTIVE.get(remat)
    if policy is None:
        return checkpoint(fn, x, lp, use_reentrant=False)
    return checkpoint(
        fn, x, lp, use_reentrant=False,
        context_fn=lambda: create_selective_checkpoint_contexts(policy))


def _check_family(cfg: ModelConfig) -> None:
    """Raise for a family this module does not run."""
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"repro_torch.models.transformer runs the "
            f"{', '.join(DECODER_FAMILIES)} families, got {cfg.family!r}")


def _attn_layer_params(b: ParamInit, prefix: str, cfg: ModelConfig,
                       n: int) -> None:
    """``n`` stacked attention layers (norms, attention, MLP or moe)."""
    d = cfg.d_model
    b.zeros(f"{prefix}/ln1", [n, d], ("layers", "embed"))
    attn.attn_params(b, f"{prefix}/attn", n, d, cfg.n_heads,
                     cfg.n_kv_heads, cfg.resolved_head_dim, cfg.qk_norm)
    b.zeros(f"{prefix}/ln2", [n, d], ("layers", "embed"))
    if cfg.n_experts:
        moe_mod.moe_params(b, f"{prefix}/moe", n, d, cfg.n_experts,
                           cfg.moe_d_ff, cfg.n_shared_experts, cfg.moe_d_ff)
    else:
        mlp_params(b, f"{prefix}/mlp", n, d, cfg.d_ff, cfg.mlp_type)


def _rglru_layer_params(b: ParamInit, prefix: str, cfg: ModelConfig,
                        n: int) -> None:
    """``n`` stacked RG-LRU layers (norms, RG-LRU, MLP)."""
    d = cfg.d_model
    b.zeros(f"{prefix}/ln1", [n, d], ("layers", "embed"))
    ssm.rglru_params(b, f"{prefix}/rglru", n, d, cfg.resolved_lru_width,
                     cfg.ssm_conv)
    b.zeros(f"{prefix}/ln2", [n, d], ("layers", "embed"))
    mlp_params(b, f"{prefix}/mlp", n, d, cfg.d_ff, cfg.mlp_type)


def hybrid_counts(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """A hybrid model's number of full ``block_pattern`` groups and the
    kinds of its tail layers (the rest of ``n_layers``)."""
    pat = cfg.block_pattern
    return cfg.n_layers // len(pat), pat[:cfg.n_layers % len(pat)]


def init_params(cfg: ModelConfig, seed: int, device: torch.device, *,
                with_axes: bool = False):
    """Random parameters with the JAX tree's paths, shapes and std rule,
    drawn on ``device`` from a generator seeded with ``seed``; with
    ``with_axes``, (params, the logical-axes tree), as JAX's init
    returns.  On the meta device nothing is drawn."""
    _check_family(cfg)
    b = ParamInit(seed, dtype_of(cfg.dtype), device)
    d, n = cfg.d_model, cfg.n_layers
    b.normal("embed", [cfg.vocab_size, d], ("vocab", "embed"), fan_in=d,
             scale=float(d) ** 0.5)
    if cfg.family == "ssm":
        b.zeros("layers/ln1", [n, d], ("layers", "embed"))
        ssm.mamba_params(b, "layers/mamba", n, d, cfg.d_inner,
                         cfg.ssm_state, cfg.ssm_conv, cfg.resolved_dt_rank)
    elif cfg.family == "hybrid":
        n_groups, tail = hybrid_counts(cfg)
        for where, kinds, count in (("groups", cfg.block_pattern, n_groups),
                                    ("tail", tail, 1)):
            for i, kind in enumerate(kinds):
                layer = (_rglru_layer_params if kind == "rglru"
                         else _attn_layer_params)
                layer(b, f"{where}/b{i}", cfg, count)
    else:
        _attn_layer_params(b, "layers", cfg, n)
    b.zeros("final_norm", [d], ("embed",))
    if not cfg.tie_embeddings:
        b.normal("lm_head", [d, cfg.vocab_size], ("embed", "vocab"),
                 fan_in=d)
    return (b.params, b.axes) if with_axes else b.params


def layer_params(stacked: Params, i: int) -> Params:
    """Views of layer ``i`` of a stacked ``[L, ...]`` parameter tree."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def unstack_layers(stacked: Params) -> List[Params]:
    """Views of every layer of a stacked ``[L, ...]`` tree, one
    ``unbind`` per leaf: under autograd its backward is one stack of the
    layers' gradients, where selecting one layer (:func:`layer_params`)
    makes a zero tensor of the whole stacked leaf in the backward pass,
    for every layer."""
    parts = {k: (unstack_layers(v) if isinstance(v, dict) else v.unbind(0))
             for k, v in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def _ffn(h: torch.Tensor, lp: Params, cfg: ModelConfig,
         shard_fn: Callable = identity_shard
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A layer's feed-forward half: the routed experts of a moe layer
    (with its aux loss), else the MLP (aux None)."""
    if cfg.n_experts:
        return moe_mod.moe_ffn(h, lp["moe"], n_experts=cfg.n_experts,
                               top_k=cfg.experts_per_token,
                               capacity_factor=cfg.capacity_factor,
                               shard_fn=shard_fn)
    return mlp(h, lp["mlp"], cfg.mlp_type), None


def _attn_block(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                rope: RopeTables, *, backend: str,
                starts: Optional[torch.Tensor], schedule=None,
                window: Optional[int] = None,
                shard_fn: Callable = identity_shard
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """One prefill layer (causal; local with ``window``); returns (x, k,
    v, the moe aux loss or None).  ``shard_fn`` places the residual
    stream after each half, as JAX's ``_attn_body``."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        hd=cfg.resolved_head_dim, rope=rope, qk_norm=cfg.qk_norm,
        norm_eps=cfg.norm_eps)
    ctx = attn.attention(q, k, v, causal=True, window=window,
                         backend=backend, starts=starts, schedule=schedule)
    if cfg.n_experts and starts is not None and backend == "cuda":
        # pad positions are routed and take expert capacity: they need
        # the xla/reference attention output, where the kernel gives
        # zeros (as JAX's Pallas flash kernel does)
        ctx = attn.mean_rows_before_start(ctx, v, starts)
    x = shard_fn(x + attn.attn_out(ctx, lp["attn"]))
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, aux = _ffn(h, lp, cfg, shard_fn)
    return shard_fn(x + y), k, v, aux


def _mamba_block(x: torch.Tensor, lp: Params, cfg: ModelConfig, *,
                 backend: str, cache: Optional[Dict[str, torch.Tensor]] = None,
                 seq_valid: Optional[torch.Tensor] = None, schedule=None,
                 shard_fn: Callable = identity_shard
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One Mamba layer (pre-norm, residual); returns (x, new states)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, states = ssm.mamba_block(h, lp["mamba"], state=cfg.ssm_state,
                                conv=cfg.ssm_conv,
                                dt_rank=cfg.resolved_dt_rank, cache=cache,
                                backend=backend, seq_valid=seq_valid,
                                schedule=schedule)
    return shard_fn(x + y), states


def _rglru_layer(x: torch.Tensor, lp: Params, cfg: ModelConfig, *,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 shard_fn: Callable = identity_shard
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One RG-LRU layer (pre-norm RG-LRU, then pre-norm MLP, both
    residual); returns (x, the RG-LRU's new states).  ``shard_fn``
    places the residual after each half, as JAX's forward does (its
    prefill only after the MLP: the identity makes them one)."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, states = ssm.rglru_block(h, lp["rglru"], cache=cache)
    x = shard_fn(x + y)
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return shard_fn(x + mlp(h, lp["mlp"], cfg.mlp_type)), states


def _hybrid_layers(params: Params, cfg: ModelConfig):
    """``(where, block, index, kind, layer params)`` of every layer of a
    hybrid model in order: each group's pattern, then the tail (tail
    weights are stacked ``[1, ...]``, as in JAX)."""
    n_groups, tail = hybrid_counts(cfg)
    if n_groups:
        for g, gp in enumerate(unstack_layers(params["groups"])):
            for i, kind in enumerate(cfg.block_pattern):
                yield "groups", f"b{i}", g, kind, gp[f"b{i}"]
    for i, kind in enumerate(tail):
        yield ("tail", f"b{i}", None, kind,
               unstack_layers(params["tail"][f"b{i}"])[0])


def _window_cache(k: torch.Tensor, seq: int, win: int) -> torch.Tensor:
    """Last ``win`` entries of a [..., S, hd] K/V tensor, rotated so the
    entry of absolute position p sits at rolling slot p % win."""
    if seq <= win:
        return k
    last, r = k[..., seq - win:, :], (seq - win) % win
    if r == 0:
        return last
    # torch.roll along -2, as two slices (DTensor has no roll strategy)
    return torch.cat([last[..., win - r:, :], last[..., :win - r, :]],
                     dim=-2)


def _hybrid_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                    backend: str, collect: bool, schedule=None,
                    remat: str = "full", shard_fn: Callable = identity_shard
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """The hybrid layer stack on embedded ``x``; with ``collect`` also
    its decode caches (the RG-LRU states, and each attention layer's
    last ``min(local_window, S)`` K/V in rolling-slot order), stacked
    per group block as in JAX's tree."""
    seq = x.shape[1]
    window = cfg.local_window if seq > cfg.local_window else None
    win = min(cfg.local_window, seq)
    rope = rope_tables(torch.arange(seq, device=x.device),
                       cfg.resolved_head_dim, cfg.rope_theta)
    got: Dict[Tuple[str, str], list] = {}
    for where, blk, _, kind, lp in _hybrid_layers(params, cfg):
        if kind == "rglru":
            x, st = remat_call(
                lambda h, p: _rglru_layer(h, p, cfg, shard_fn=shard_fn),
                remat, x, lp)
        else:
            x, k, v, _ = remat_call(
                lambda h, p: _attn_block(h, p, cfg, rope, backend=backend,
                                         starts=None, schedule=schedule,
                                         window=window, shard_fn=shard_fn),
                remat, x, lp)
            st = {"k": _window_cache(k, seq, win),
                  "v": _window_cache(v, seq, win)} if collect else None
        if collect:
            got.setdefault((where, blk), []).append(st)
    if not collect:
        return x, None
    cache: Dict[str, Any] = {"groups": {}, "tail": {}}
    for (where, blk), sts in got.items():
        cache[where][blk] = ({n: torch.stack([st[n] for st in sts])
                              for n in sts[0]} if where == "groups"
                             else sts[0])
    return x, cache


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings [B, S, D]; a vlm model's image embeddings
    ``batch["image_embeds"]`` [B, N_img, D] go in front of them, cast to
    the model's dtype."""
    emb = params["embed"]
    x = embed_lookup(emb, batch["tokens"])
    if cfg.family == "vlm":
        img = batch["image_embeds"].to(device=emb.device, dtype=x.dtype)
        x = torch.cat([img, x], dim=1)
    return x


def _check_starts(cfg: ModelConfig, seq_starts) -> None:
    """``seq_starts`` is for the families served left-padded only."""
    if seq_starts is not None and cfg.family not in MASKED_FAMILIES:
        raise ValueError(
            f"seq_starts is not supported for family {cfg.family!r}")


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor
          ) -> torch.Tensor:
    """Final norm and LM head; float32 logits from float32 operands, so a
    bf16 model's logits are not rounded to bf16 (as the JAX head's
    ``preferred_element_type=float32`` does not round them).  A bf16
    head is upcast :data:`HEAD_CHUNK` vocabulary columns at a time, so
    a step (and each captured graph's pool) holds one float32 slice of
    it, not the whole head (3.1 GB for qwen3-32b)."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].t()
    xf = x.float()
    if head.dtype == torch.float32:
        return torch.matmul(xf, head)
    return torch.cat([torch.matmul(xf, head[:, c:c + HEAD_CHUNK].float())
                      for c in range(0, head.shape[1], HEAD_CHUNK)], dim=-1)


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain",
            collect_kv: bool = False,
            seq_starts: Optional[torch.Tensor] = None, schedules=None,
            remat: str = "full", shard_fn: Callable = identity_shard
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced logits [B, S, V] (float32) and, with
    ``collect_kv``, the per-layer decode caches: for dense and moe the
    K/V stacked as ``[L,B,HKV,S,hd]`` (``extras["kv"]``), for ssm the
    final states ``{"ssm": [L,B,Di,N], "conv": [L,B,K-1,Di]}``
    (``extras["state"]``).  A moe model also returns the layers' mean
    load-balancing loss (``extras["aux"]``, as the JAX forward does).

    ``seq_starts`` ([B] int) marks the first real token of each
    left-padded row: rope positions become ``arange(S) - starts`` and pad
    keys are masked out of attention (ssm: pads are masked out of the
    recurrence, see :func:`repro_torch.models.ssm.mamba_block`; dense,
    moe and ssm only, as in JAX).  A hybrid model collects its caches
    as ``extras["cache"]`` (see :func:`prefill`).

    Under autograd each layer runs under the ``remat`` policy
    (:func:`remat_call`); ``backend="cuda"`` raises
    :class:`KernelGradError` there, before any launch.

    ``shard_fn`` (default: the identity) places activations where the
    JAX forward places them: the embedded input, and the residual
    stream after each half of every layer (a moe layer's expert
    buffers with ``"experts"``)."""
    _check_family(cfg)
    _check_starts(cfg, seq_starts)
    check_remat(remat)
    check_kernels_without_grad(params, backend)
    x = shard_fn(embed_inputs(params, cfg, batch))
    bsz, seq, _ = x.shape
    if cfg.family == "ssm":
        return _ssm_forward(params, cfg, x, backend=backend,
                            collect=collect_kv, seq_starts=seq_starts,
                            schedule=_field(schedules, "ssm_scan"),
                            remat=remat, shard_fn=shard_fn)
    fa_sched = _field(schedules, "flash_attention")
    if cfg.family == "hybrid":
        x, cache = _hybrid_forward(params, cfg, x, backend=backend,
                                   collect=collect_kv, schedule=fa_sched,
                                   remat=remat, shard_fn=shard_fn)
        return _head(params, cfg, x), ({"cache": cache} if collect_kv
                                       else {})
    if seq_starts is not None:
        st = torch.as_tensor(seq_starts, device=x.device).to(torch.int64)
        positions = torch.arange(seq, device=x.device)[None, :] - st[:, None]
    else:
        st = None
        positions = torch.arange(seq, device=x.device)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ks, vs, auxes = [], [], []
    for lp in unstack_layers(params["layers"]):
        x, k, v, aux = remat_call(
            lambda h, p: _attn_block(h, p, cfg, rope, backend=backend,
                                     starts=st, schedule=fa_sched,
                                     shard_fn=shard_fn),
            remat, x, lp)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        if aux is not None:
            auxes.append(aux)
    extras: Dict[str, Any] = {}
    if auxes:
        extras["aux"] = torch.stack(auxes).mean()
    if collect_kv:
        extras["kv"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return _head(params, cfg, x), extras


def _field(schedules, kind: str):
    """A bundle's schedule for ``kind`` (None without a bundle)."""
    return None if schedules is None else schedules.get(kind)


def _ssm_forward(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
                 backend: str, collect: bool,
                 seq_starts: Optional[torch.Tensor], schedule=None,
                 remat: str = "full", shard_fn: Callable = identity_shard
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The Mamba layer stack of :func:`forward` on embedded ``x``."""
    seq_valid = None
    if seq_starts is not None:
        st = torch.as_tensor(seq_starts, device=x.device).to(torch.int64)
        seq_valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                     >= st[:, None])
    ssms, convs = [], []
    for lp in unstack_layers(params["layers"]):
        x, states = remat_call(
            lambda h, p: _mamba_block(h, p, cfg, backend=backend,
                                      seq_valid=seq_valid,
                                      schedule=schedule,
                                      shard_fn=shard_fn), remat, x, lp)
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
            seq_starts: Optional[torch.Tensor] = None, schedules=None,
            shard_fn: Callable = identity_shard
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Run the whole prompt: (logits [B,S,V], caches filled up to S; for
    ssm the recurrent states after the last token; for hybrid
    ``{"groups", "tail"}`` with the RG-LRU states and the windowed K/V
    in rolling-slot order).  A vlm prompt is its image tokens and then
    its text: S counts both.  ``shard_fn`` as in :func:`forward`."""
    logits, extras = forward(params, cfg, batch, backend=backend,
                             collect_kv=True, seq_starts=seq_starts,
                             schedules=schedules, shard_fn=shard_fn)
    if cfg.family == "hybrid":
        return logits, extras["cache"]
    return logits, {"layers": extras["state" if cfg.family == "ssm"
                                     else "kv"]}


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, backend: str = "plain",
            remat: str = "full", schedules=None,
            shard_fn: Callable = identity_shard
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of a teacher-forced batch (JAX ``loss_fn``): the
    masked cross-entropy with z-loss of ``batch["labels"]`` (a vlm
    batch's labels cover its image tokens too), plus ``0.01 x`` the
    layers' mean moe aux loss for the dense, moe and vlm families (0
    without experts, as in JAX).  Metrics: ``xent``, ``tokens``,
    ``moe_aux`` (those families), ``loss``."""
    logits, extras = forward(params, cfg, batch, backend=backend,
                             remat=remat, schedules=schedules,
                             shard_fn=shard_fn)
    loss, denom = softmax_xent(logits, batch["labels"])
    metrics = {"xent": loss, "tokens": denom}
    if cfg.family in ("dense", "moe", "vlm"):
        aux = extras.get("aux")
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        loss = loss + 0.01 * aux
        metrics["moe_aux"] = aux
    metrics["loss"] = loss
    return loss, metrics


def init_cache(cfg: ModelConfig, bsz: int, max_len: int,
               device: torch.device) -> Dict[str, Any]:
    """Empty contiguous caches ``[L, B, HKV, max_len, hd]``; for ssm the
    zero states ``{"ssm": [L,B,Di,N], "conv": [L,B,K-1,Di]}`` in the
    model dtype (``max_len`` unused: the state is O(1) per row); for
    hybrid JAX's ``{"groups": {"b<i>": ...}, "tail": ...}`` tree, each
    RG-LRU block's ``h`` [G,B,W] and ``conv`` [G,B,K-1,W] and each
    attention block's rolling K/V [G,B,HKV,min(local_window, max_len),
    hd] (tail blocks without the G axis)."""
    _check_family(cfg)
    dt = dtype_of(cfg.dtype)
    if cfg.family == "hybrid":
        n_groups, tail = hybrid_counts(cfg)
        win = min(cfg.local_window, max_len)
        hd, w = cfg.resolved_head_dim, cfg.resolved_lru_width

        def block(kind: str, lead: Tuple[int, ...]) -> Dict[str, Any]:
            """Zero caches of one block, ``lead`` dims in front."""
            if kind == "rglru":
                st = ssm.rglru_cache_init(bsz, w, cfg.ssm_conv, dt, device)
            else:
                shape = (bsz, cfg.n_kv_heads, win, hd)
                st = {"k": torch.zeros(shape, dtype=dt, device=device),
                      "v": torch.zeros(shape, dtype=dt, device=device)}
            return {n: t.expand(*lead, *t.shape).contiguous()
                    for n, t in st.items()}

        return {"groups": {f"b{i}": block(kind, (n_groups,))
                           for i, kind in enumerate(cfg.block_pattern)},
                "tail": {f"b{i}": block(kind, ())
                         for i, kind in enumerate(tail)}}
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
    if cfg.family not in ATTENTION_FAMILIES:
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
                  slots: Optional[torch.Tensor], schedule=None,
                  window: Optional[int] = None) -> torch.Tensor:
    """One decode layer; updates this layer's cache (or pool) in place
    (with ``window``, a rolling buffer of that many slots)."""
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
        attn.update_kv_cache(ck, cv, k, v, pos, window=window)
        ctx = attn.decode_attention(q, ck, cv, pos, window=window,
                                    backend=backend, starts=starts,
                                    schedule=schedule)
    x = x + attn.attn_out(ctx, lp["attn"])
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(h, lp, cfg)[0]


def decode_step(params: Params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens: torch.Tensor, pos, *, backend: str = "plain",
                seq_starts: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                schedules=None, shard_fn: Callable = identity_shard
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
    advanced by one token.  A hybrid step advances each RG-LRU state and
    writes each attention block's rolling buffer at slot ``pos % W``.
    ``block_tables`` and ``seq_starts`` raise ``ValueError`` outside the
    dense and moe families, as in JAX (a recurrent state carries no pad
    entries and needs no paging; vlm and hybrid are served unpadded).
    ``shard_fn`` places the embedded token, the one place JAX's decode
    step calls it."""
    _check_family(cfg)
    dev = params["embed"].device
    x = shard_fn(embed_lookup(params["embed"], tokens))
    if block_tables is not None and cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(f"block_tables needs an attention family, "
                         f"got {cfg.family!r}")
    if seq_starts is not None and cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(
            f"seq_starts in decode_step needs an attention family, "
            f"got {cfg.family!r} (recurrent caches carry no pad "
            f"entries)")
    if cfg.family == "ssm":
        layers = cache["layers"]
        for i in range(cfg.n_layers):
            lc = {"ssm": layers["ssm"][i], "conv": layers["conv"][i]}
            x, new = _mamba_block(x, layer_params(params["layers"], i),
                                  cfg, backend=backend, cache=lc,
                                  schedule=_field(schedules, "ssm_scan"))
            copy_local_(lc["ssm"], new["ssm"])
            copy_local_(lc["conv"], new["conv"])
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
    if cfg.family == "hybrid":
        win = cache_window(cfg, cache)
        for where, blk, g, kind, lp in _hybrid_layers(params, cfg):
            lc = cache[where][blk]
            if g is not None:
                lc = {n: t[g] for n, t in lc.items()}
            if kind == "rglru":
                x, new = _rglru_layer(x, lp, cfg, cache=lc)
                copy_local_(lc["h"], new["h"])
                copy_local_(lc["conv"], new["conv"])
            else:
                x = _decode_block(
                    x, lp, lc["k"], lc["v"], cfg, pos, rope,
                    backend=backend, starts=None, tables=None, slots=None,
                    schedule=_field(schedules, "decode_attention"),
                    window=win)
        return _head(params, cfg, x), cache
    for i in range(cfg.n_layers):
        x = _decode_block(x, layer_params(params["layers"], i),
                          cache["layers"]["k"][i], cache["layers"]["v"][i],
                          cfg, pos, rope, backend=backend, starts=starts,
                          tables=tables, slots=slots,
                          schedule=_field(schedules, "decode_attention"))
    return _head(params, cfg, x), cache


def cache_window(cfg: ModelConfig, cache: Dict[str, Any]) -> Optional[int]:
    """Slots of a hybrid cache's rolling attention buffers (None when
    the pattern has no attention block)."""
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "attn":
            return cache["groups"][f"b{i}"]["k"].shape[3]
    return None


__all__ = ["SERVED_FAMILIES", "DECODER_FAMILIES", "ATTENTION_FAMILIES",
           "MASKED_FAMILIES", "REMAT_POLICIES", "KernelGradError",
           "check_kernels_without_grad", "remat_call",
           "init_params", "hybrid_counts", "layer_params",
           "unstack_layers", "embed_inputs", "forward", "loss_fn",
           "prefill",
           "init_cache", "init_paged_cache", "decode_step",
           "cache_window"]
