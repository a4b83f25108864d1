"""Model configuration: the port's own copy of ``repro.configs.base``:
:class:`ModelConfig`, :func:`reduce_for_smoke`, and the shape cells
(:class:`ShapeConfig`, :data:`SHAPES`, :func:`shape_applicable`) that
the analytic roofline (:mod:`repro_torch.launch.roofline`) and
``Model.input_specs`` take.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's hyper-parameters (same fields as the JAX copy)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # MLP / norm flavour
    mlp_type: str = "swiglu"         # swiglu | relu2 | gelu
    qk_norm: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba1)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0

    # Hybrid (recurrentgemma)
    block_pattern: Tuple[str, ...] = ()
    local_window: int = 2048
    lru_width: int = 0

    # Encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False

    # VLM (paligemma)
    num_image_tokens: int = 0

    rope_theta: float = 10000.0
    max_seq_len: int = 524288
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        """Head width: ``head_dim`` or ``d_model // n_heads``."""
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        """Mamba ``dt`` projection rank: ``dt_rank`` or ceil(d_model/16)."""
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        """Mamba inner width: ``ssm_expand * d_model``."""
        return self.ssm_expand * self.d_model

    @property
    def attention_free(self) -> bool:
        """True for the recurrent-only (ssm) family."""
        return self.family == "ssm"

    @property
    def resolved_lru_width(self) -> int:
        """RG-LRU width: ``lru_width`` or ``d_model``."""
        return self.lru_width or self.d_model

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: an SSM state or a bounded attention
        window."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (embedding, layers, head), the
        JAX package's formula for every family: a hybrid layer counts as
        an attention layer, an encoder-decoder adds its encoder stack
        and the decoder's cross-attention."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        per_layer = attn + (3 if self.mlp_type == "swiglu" else 2) * d * f
        if self.n_experts:
            ef = self.moe_d_ff or f
            routed = self.n_experts * 3 * d * ef
            shared = self.n_shared_experts * 3 * d * ef
            per_layer = attn + routed + shared + d * self.n_experts
        if self.family == "ssm":
            di, st, dr = self.d_inner, self.ssm_state, self.resolved_dt_rank
            per_layer = (d * 2 * di + di * self.ssm_conv
                         + di * (dr + 2 * st) + dr * di + di * st + di
                         + di * d)
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = self.n_layers * per_layer + emb
        if self.encoder_layers:
            total += self.encoder_layers * per_layer
            total += self.n_layers * (2 * d * hd * self.n_kv_heads
                                      + d * hd * self.n_heads
                                      + self.n_heads * hd * d)
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (sequence, global batch) cell of a step kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        """True for a decode cell."""
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig
                     ) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and the reason when it does
    not (long_500k needs a sub-quadratic architecture)."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, ("full-attention arch: 500k dense-KV decode excluded "
                       "per shape table (needs sub-quadratic attention)")
    return True, ""


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests: few layers, narrow width,
    tiny vocab, float32 (the same rule as the JAX package)."""
    n_layers = min(cfg.n_layers, 2)
    pattern = cfg.block_pattern
    if pattern:
        n_layers = len(pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=8,
        lru_width=0,
        local_window=16,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 24) if cfg.encoder_seq else 0,
        num_image_tokens=min(cfg.num_image_tokens, 8)
        if cfg.num_image_tokens else 0,
        max_seq_len=512,
        dtype="float32",
    )


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
           "reduce_for_smoke"]
