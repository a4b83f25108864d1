"""Architecture registry of the port: ``get_config(arch_id)``.

Only the architectures whose family the port serves (dense and ssm) are
registered; others arrive with their families.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, reduce_for_smoke
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.phi3_mini_3_8b import CONFIG as _phi3

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in [_phi3,
                                                        _falcon_mamba]}


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


__all__ = ["ModelConfig", "REGISTRY", "get_config", "list_archs",
           "reduce_for_smoke"]
