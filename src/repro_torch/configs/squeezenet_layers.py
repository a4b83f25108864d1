"""The thesis' own workload: the convolution layers of Table 4.1
(SqueezeNet and TinyDarknet), at their published widths, and the
synthetic design spaces of Tables 4.2 and 4.3 that the Ch. 4/5 sweeps
run over."""
from __future__ import annotations

from typing import Dict, List

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



def synthetic_design_space() -> List[ConvLayer]:
    """Table 4.2: channels 10..210 step 40 (in==out), image 10..210 step
    40 (square), kernel 1..11 step 2 (square) -> 216 layers."""
    layers = []
    for ch in range(10, 211, 40):
        for img in range(10, 211, 40):
            for k in range(1, 12, 2):
                layers.append(ConvLayer(ch, ch, img, img, k, k))
    return layers


def synthetic_design_space_mt() -> List[ConvLayer]:
    """Table 4.3 (multi-thread): channels/image 10..170 step 80,
    kernel in {1, 3, 9, 11} -> 36 layers."""
    layers = []
    for ch in range(10, 171, 80):
        for img in range(10, 171, 80):
            for k in (1, 3, 9, 11):
                layers.append(ConvLayer(ch, ch, img, img, k, k))
    return layers


__all__ = ["TABLE_4_1", "synthetic_design_space",
           "synthetic_design_space_mt"]
