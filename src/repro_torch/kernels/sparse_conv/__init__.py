"""Block-sparse direct convolution: CUDA kernel wrapper, its plain
versions and the host-side block structure."""
from repro_torch.kernels.sparse_conv.ops import (BlockSparsity,
                                                 analyze_weights,
                                                 build_block_index,
                                                 sparse_conv2d,
                                                 sparse_conv2d_dispatched,
                                                 sparse_conv2d_scheduled)
from repro_torch.kernels.sparse_conv.ref import (sparse_conv_plain,
                                                 sparse_conv_ref)

__all__ = ["sparse_conv2d", "sparse_conv2d_scheduled",
           "sparse_conv2d_dispatched", "sparse_conv_ref",
           "sparse_conv_plain", "analyze_weights", "BlockSparsity",
           "build_block_index"]
