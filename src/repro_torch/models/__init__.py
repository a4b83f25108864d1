"""Decoder models of the port (layers, attention, Mamba, transformer)."""
from repro_torch.models.model_zoo import (Model, build_model, bucket_length,
                                          left_pad_prompts, prompt_starts)

__all__ = ["Model", "build_model", "bucket_length", "left_pad_prompts",
           "prompt_starts"]
