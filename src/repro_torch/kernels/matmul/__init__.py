"""Tiled matmul: CUDA kernel wrapper, its plain versions and the
schedule-driven entry points."""
from repro_torch.kernels.matmul.ops import (GRID_AXES, default_block,
                                            matmul, matmul_dispatched,
                                            matmul_scheduled, matmul_tuned,
                                            staging_route)
from repro_torch.kernels.matmul.ref import (matmul_plain, matmul_ref,
                                            uses_scratch)

__all__ = ["matmul", "matmul_tuned", "matmul_scheduled",
           "matmul_dispatched", "matmul_ref", "matmul_plain",
           "default_block", "uses_scratch", "staging_route", "GRID_AXES"]
