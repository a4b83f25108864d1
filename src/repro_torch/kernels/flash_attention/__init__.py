"""Flash attention for prefill: CUDA kernel wrapper and plain version."""
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_dispatched, flash_attention_scheduled)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_scheduled",
           "flash_attention_dispatched", "flash_attention_ref"]
