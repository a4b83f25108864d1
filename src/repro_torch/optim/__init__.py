"""Optimizer of the port (port of ``repro.optim``): AdamW with global-norm
clipping, the learning-rate schedules and int8 gradient compression."""
from repro_torch.optim import adamw, grad_compress, schedule
from repro_torch.optim.adamw import AdamWConfig, AdamWState

__all__ = ["adamw", "schedule", "grad_compress", "AdamWConfig",
           "AdamWState"]
