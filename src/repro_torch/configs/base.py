"""Model configuration: the port's own copy of ``repro.configs.base``.

Only :class:`ModelConfig` and :func:`reduce_for_smoke` are copied; the
shape cells of the dry-run tooling are not part of the serving path.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


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

    def param_count(self) -> int:
        """Parameter count (embedding, layers, head) of a dense or ssm
        decoder; the families the port does not serve yet raise."""
        if self.family not in ("dense", "ssm"):
            raise NotImplementedError(
                f"param_count is ported for the dense and ssm families "
                f"only, got {self.family!r}")
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        if self.family == "ssm":
            di, st, dr = self.d_inner, self.ssm_state, self.resolved_dt_rank
            per_layer = (d * 2 * di + di * self.ssm_conv
                         + di * (dr + 2 * st) + dr * di + di * st + di
                         + di * d)
        else:
            hd = self.resolved_head_dim
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
            per_layer = attn + (3 if self.mlp_type == "swiglu" else 2) * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb


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


__all__ = ["ModelConfig", "reduce_for_smoke"]
