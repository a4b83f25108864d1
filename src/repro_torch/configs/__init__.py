"""Architecture registry of the port: ``get_config(arch_id)``.

Every architecture of the JAX package is registered: the dense, moe,
ssm, hybrid, vlm and audio families.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      reduce_for_smoke, shape_applicable)
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in [_phi3, _falcon_mamba, _qwen3, _minitron, _nemotron,
                        _qwen2_moe, _llama4, _rgemma, _paligemma,
                        _whisper]}


def get_config(name: str) -> ModelConfig:
    """Config for ``name``; a ``-smoke`` suffix gives the reduced copy."""
    if name.endswith("-smoke"):
        return reduce_for_smoke(get_config(name[:-len("-smoke")]))
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> List[str]:
    """Registered architecture ids."""
    return sorted(REGISTRY)


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "REGISTRY",
           "get_config", "list_archs", "shape_applicable",
           "reduce_for_smoke"]
