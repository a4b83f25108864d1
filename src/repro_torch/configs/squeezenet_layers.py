"""The thesis' own workload: the convolution layers of Table 4.1
(SqueezeNet and TinyDarknet), at their published widths."""
from __future__ import annotations

from typing import Dict

from repro_torch.core.loopnest import ConvLayer

# Table 4.1: (out_ch, in_ch, img_w, img_h, k_w, k_h)
TABLE_4_1: Dict[str, ConvLayer] = {
    "initial-conf": ConvLayer(256, 32, 28, 28, 3, 3),
    "fire3-conv3x3-2": ConvLayer(64, 16, 55, 55, 3, 3),
    "fire4-conv1x1-1": ConvLayer(32, 128, 55, 55, 1, 1),
    "fire4-conv1x1-2": ConvLayer(128, 32, 55, 55, 1, 1),
    "fire7-conv1x1-1": ConvLayer(48, 384, 27, 27, 1, 1),
    "fire9-conv1x1-1": ConvLayer(64, 512, 13, 13, 1, 1),
    "fire9-conv3x3-2": ConvLayer(256, 64, 13, 13, 3, 3),
    "conv-final": ConvLayer(1000, 512, 13, 13, 1, 1),
}

__all__ = ["TABLE_4_1"]
