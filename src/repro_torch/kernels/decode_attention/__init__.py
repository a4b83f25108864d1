"""Single-query decode attention (contiguous and paged): CUDA kernel
wrappers and their plain versions."""
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_dispatched,
    decode_attention_scheduled, paged_decode_attention,
    paged_decode_attention_scheduled)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_scheduled",
           "decode_attention_dispatched", "paged_decode_attention",
           "paged_decode_attention_scheduled", "decode_attention_ref",
           "paged_decode_attention_ref"]
