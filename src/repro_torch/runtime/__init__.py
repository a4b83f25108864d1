"""Serving loop of the port (``generate`` over a contiguous cache)."""
from repro_torch.runtime.serve_loop import ServeStats, generate

__all__ = ["ServeStats", "generate"]
