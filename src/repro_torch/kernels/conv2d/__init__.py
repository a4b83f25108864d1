"""Direct convolution: CUDA kernel wrapper, its plain versions and the
schedule-driven entry points."""
from repro_torch.kernels.conv2d.ops import (GRID_AXES, conv2d,
                                            conv2d_dispatched,
                                            conv2d_scheduled, conv2d_tuned,
                                            default_block)
from repro_torch.kernels.conv2d.ref import (conv2d_plain, conv2d_ref,
                                            uses_scratch)

__all__ = ["conv2d", "conv2d_tuned", "conv2d_scheduled",
           "conv2d_dispatched", "conv2d_ref", "conv2d_plain",
           "default_block", "uses_scratch", "GRID_AXES"]
