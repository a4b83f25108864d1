"""Hand-written Hopper kernels of the port and their launch counters.

Each kernel lives in its own subpackage with a wrapper (``ops.py``) and
its plain PyTorch version (``ref.py``).  The wrapper runs the plain
version only for CPU tensors; for a CUDA tensor it launches the kernel
or raises.  Each wrapper counts its launches in a plain integer
attribute, ``<wrapper>.launches``, which :func:`launch_counts` reads.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.conv2d import conv2d
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.sparse_conv import sparse_conv2d
from repro_torch.kernels.ssm_scan import ssm_scan

WRAPPERS = {
    "flash_attention": flash_attention,
    "paged_decode_attention": paged_decode_attention,
    "decode_attention": decode_attention,
    "ssm_scan": ssm_scan,
    "matmul": matmul,
    "conv2d": conv2d,
    "sparse_conv2d": sparse_conv2d,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "reset_launch_counts",
           "flash_attention", "decode_attention", "paged_decode_attention",
           "ssm_scan", "matmul", "conv2d", "sparse_conv2d"]
