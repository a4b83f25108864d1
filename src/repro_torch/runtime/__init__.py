"""Serving loop of the port (``generate`` over a contiguous cache) and
the kernel-shape problems it feeds the dispatch service."""
from repro_torch.runtime.serve_loop import (ServeStats, generate,
                                            resolve_bundle_report,
                                            serve_dispatch_problems)

__all__ = ["ServeStats", "generate", "serve_dispatch_problems",
           "resolve_bundle_report"]
