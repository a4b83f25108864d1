"""Quickstart: the thesis pipeline end to end on one convolution layer.

1. sweep all 720 abstract loop permutations with the Loki cache model,
2. inspect the signature's best and worst permutation (thesis Ch. 4),
3. tune a conv schedule (grid order x blocks) with the H100 cost model,
   at the element size of the data it runs (float32: 4 bytes, so only
   blocks the float32 body takes are offered),
4. run the top two schedules through the hand-written ``conv2d`` kernel
   and hold each to its plain PyTorch version (float32, 1e-5 absolute;
   weights scaled by 1/sqrt(IC KH KW), as a layer's init scales them,
   so outputs are O(1)),
5. micro-profile the top two and commit (thesis §6.4): on the card with
   CUDA events, on the CPU with the host clock.

The port's counterpart of the JAX package's ``examples/quickstart.py``.
It runs on the CUDA card unless asked for the CPU (``--device cpu``,
where the wrapper runs the plain version); with no card it raises.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import tuner
from repro_torch.core.adaptive import host_time, microprofile
from repro_torch.core.loopnest import ConvLayer, LOOPS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import conv2d
from repro_torch.kernels.conv2d import conv2d_plain

LAYER = ConvLayer(oc=32, ic=16, h=14, w=14, kh=3, kw=3)
ELEM_BYTES = 4        # the data below is float32
TOL = 1e-5            # the float32 contract, absolute
SEED = 0              # numpy seed of the image and the weights


SPIN_CYCLES = 1_000_000  # ~0.5 ms of a busy stream before a timed call


def cuda_event_time(call) -> float:
    """Seconds of device work one ``call`` enqueues, between two CUDA
    events.  The stream is kept busy first, so the host has enqueued the
    call before the start event fires: the events time the card, not
    the host's launch."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def inputs(device: torch.device):
    """The image and weights of :data:`LAYER` (float32, numpy seed
    :data:`SEED`) on ``device``."""
    layer = LAYER
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.standard_normal(
        (1, layer.ic, layer.h + layer.kh - 1, layer.w + layer.kw - 1),
        dtype=np.float32)).to(device)
    wgt = torch.from_numpy(rng.standard_normal(
        (layer.oc, layer.ic, layer.kh, layer.kw), dtype=np.float32)
        * np.float32((layer.ic * layer.kh * layer.kw) ** -0.5)).to(device)
    return img, wgt


def run(device: DeviceLike = None) -> Dict:
    """Steps 1-5 on ``device`` (the card by default); prints each step
    and returns the schedules, their predicted and measured times, their
    errors against the plain version, the committed index and the conv
    kernel's launches."""
    dev = resolve_device(device)
    layer = LAYER

    # 1-2. abstract sweep (the "cache simulator" step)
    sweep = tuner.sweep_layer(layer)
    best = int(np.argmin(sweep.cycles))
    worst = int(np.argmax(sweep.cycles))
    print(f"720-perm sweep: best "
          f"{'/'.join(LOOPS[i] for i in tuner.ALL_PERMS[best])} "
          f"({sweep.cycles[best]:.3g} cyc), worst "
          f"{'/'.join(LOOPS[i] for i in tuner.ALL_PERMS[worst])} "
          f"({sweep.cycles[worst]:.3g} cyc), "
          f"ratio {sweep.cycles[worst]/sweep.cycles[best]:.2f}x")

    # 3. H100 schedule tuning at the data's element size
    schedules = tuner.tune_conv(layer, elem_bytes=ELEM_BYTES, top_k=2)
    for sched, cost in schedules:
        bound = "compute" if cost.compute_s >= cost.memory_s else "memory"
        print(f"schedule {sched.grid_order} blocks={sched.block_dict()} "
              f"-> {cost.time_s*1e6:.1f}us predicted ({bound}-bound, "
              f"AI={cost.flops / max(cost.dram_bytes, 1.0):.0f} "
              f"FLOP/B of device memory)")

    # 4. run the top two through the kernel, each held to its plain version
    img, wgt = inputs(dev)
    launches0 = conv2d.launches
    errs: List[float] = []
    for sched, _ in schedules:
        out = sched.run(img, wgt)
        plain = conv2d_plain(img, wgt, block=sched.block_dict(),
                             grid_order=sched.grid_order)
        errs.append(float((out - plain).abs().max()))
    print("kernel vs plain: max abs err "
          + ", ".join(f"{e:.2e} (#{i})" for i, e in enumerate(errs))
          + f" (tolerance {TOL:g})")
    if max(errs) > TOL:
        raise RuntimeError(f"conv2d disagrees with its plain version: "
                           f"{errs} > {TOL}")

    # 5. micro-profile and commit
    on_card = dev.type == "cuda"
    prof = microprofile([s for s, _ in schedules],
                        lambda s: s.run(img, wgt),
                        timer=cuda_event_time if on_card else host_time)
    clock = "CUDA events" if on_card else "host clock"
    print(f"micro-profile medians (us, {clock}): "
          f"{[f'{m*1e6:.0f}' for m in prof['medians']]} "
          f"-> committed schedule #{prof['best_index']}")
    return {"device": str(dev),
            "schedules": [s for s, _ in schedules],
            "predicted_s": [c.time_s for _, c in schedules],
            "max_abs_err": errs, "medians_s": prof["medians"],
            "best_index": prof["best_index"],
            "launches": conv2d.launches - launches0}


def main(argv: Optional[List[str]] = None) -> Dict:
    """Parse ``--device`` and run the quickstart."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.quickstart",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
