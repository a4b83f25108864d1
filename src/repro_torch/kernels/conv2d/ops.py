"""Wrapper of the CUDA direct-convolution kernel (``csrc/conv2d.cu``).

``conv2d`` replaces ``conv2d_pallas`` (``src/repro/kernels/conv2d/
kernel.py``) behind the JAX package's ops surface: ``conv2d`` with an
explicit schedule (block shapes and grid order), ``conv2d_scheduled``
with a :class:`~repro_torch.core.schedule.ConvSchedule`,
``conv2d_tuned`` with the schedule the H100 cost model ranks first
(through the port's tuning registry), and ``conv2d_dispatched`` through
the port's :class:`~repro_torch.runtime.dispatch.DispatchService`.

For CPU tensors the wrapper runs the plain version (``ref.conv2d_plain``,
rounded where the kernel rounds); for CUDA tensors it launches the
kernel or raises: bf16 runs the implicit GEMM on the tensor cores,
float32 the CUDA-core tile kernel in IEEE fp32 (``_geometry.conv_layout``
gives each one's layout).  ``conv2d.launches`` counts kernel launches: one for a
scratch schedule (ic innermost), one per input-channel block for a
read-modify-write schedule.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same, on_cpu,
                                         require)
from repro_torch.kernels._geometry import conv_layout, tensor_cores
from repro_torch.kernels.conv2d.ref import (GRID_AXES, conv2d_plain,
                                            conv2d_ref, uses_scratch)

_OUT_AXIS = {"oc": 0, "y": 1, "x": 2}


def _divisor_le(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def default_block(oc: int, ic: int, h: int, w: int) -> Dict[str, int]:
    """The port's default blocks (divisors of their dims): channels up
    to 32 and 16, pixels up to 8 x 16, a tile the kernel takes for
    kernels up to 5 x 5 in float32."""
    return {"oc": _divisor_le(oc, 32), "ic": _divisor_le(ic, 16),
            "y": _divisor_le(h, 8), "x": _divisor_le(w, 16)}


def _shapes(img: torch.Tensor, wgt: torch.Tensor):
    """(n, ic, h2, w2, oc, kh, kw, h, w) of a conv call; raises on
    shapes that do not fit together."""
    require(img.dim() == 4 and wgt.dim() == 4,
            f"conv2d: img [N,IC,H2,W2] and wgt [OC,IC,KH,KW], got "
            f"{tuple(img.shape)} and {tuple(wgt.shape)}")
    n, ic, h2, w2 = img.shape
    oc, ic2, kh, kw = wgt.shape
    require(ic == ic2, f"conv2d: img has {ic} channels, wgt {ic2}")
    h, w = h2 - kh + 1, w2 - kw + 1
    require(h >= 1 and w >= 1, "conv2d: image smaller than the kernel")
    return n, ic, h2, w2, oc, kh, kw, h, w


def conv2d(img: torch.Tensor, wgt: torch.Tensor, *,
           block: Optional[Dict[str, int]] = None,
           grid_order: Sequence[str] = ("oc", "y", "x", "ic")
           ) -> torch.Tensor:
    """Direct convolution, thesis semantics (valid, pre-padded input).

    img [N, IC, H+KH-1, W+KW-1]; wgt [OC, IC, KH, KW] -> [N, OC, H, W]
    in img's type (float32 or bf16 on the card).  ``block``: {"oc",
    "ic", "y", "x"} block sizes, which must divide their dims;
    ``grid_order``: a permutation of (oc, ic, y, x), outermost first.
    """
    n, ic, h2, w2, oc, kh, kw, h, w = _shapes(img, wgt)
    if block is None:
        block = default_block(oc, ic, h, w)
    boc, bic, by, bx = (block[a] for a in GRID_AXES)
    require(oc % boc == 0 and ic % bic == 0 and h % by == 0
            and w % bx == 0, f"conv2d: blocks {block} must divide dims "
            f"oc={oc} ic={ic} h={h} w={w}")
    order = tuple(grid_order)
    require(sorted(order) == sorted(GRID_AXES),
            f"conv2d: grid order {order} is not a permutation of "
            f"{GRID_AXES}")
    if on_cpu(img):
        return conv2d_plain(img, wgt, block=block, grid_order=order)
    require(img.dtype in KERNEL_DTYPES, f"conv2d: dtype {img.dtype} not "
            f"supported")
    check_same("conv2d", [img, wgt], img.dtype)
    mma = tensor_cores(img.element_size())
    tile = conv_layout(boc, bic, by, bx, kh, kw, img.element_size())
    require(tile.error is None, f"conv2d: block {block} with a {kh}x{kw} "
            f"kernel does not fit the {img.dtype} kernel: {tile.error}")
    out = torch.empty((n, oc, h, w), dtype=img.dtype, device=img.device)
    if uses_scratch(order):
        passes = [(0, ic, 0)]
    else:
        passes = [(c0, bic, int(c0 > 0)) for c0 in range(0, ic, bic)]
    ords = [_OUT_AXIS[a] for a in order if a != "ic"]
    lib = _build.load()
    stream = _build.stream_handle(img.device)
    for c0, count, accumulate in passes:
        if mma:
            rc = lib.conv2d_mma_fwd(
                img.data_ptr(), wgt.data_ptr(), out.data_ptr(), n, ic, h2, w2,
                oc, kh, kw, boc, bic, by, bx, tile.warps, *ords, c0, count,
                accumulate, stream)
        else:
            rc = lib.conv2d_fwd(
                img.data_ptr(), wgt.data_ptr(), out.data_ptr(), n, ic, h2, w2,
                oc, kh, kw, boc, bic, by, bx, tile.groups, tile.per_thread,
                *ords, c0, count, accumulate, stream)
        _build.check(rc, "conv2d_mma_fwd" if mma else "conv2d_fwd")
        conv2d.launches += 1
    return out


conv2d.launches = 0


@functools.lru_cache(maxsize=512)
def _tuned_schedule(shape_key: Tuple[int, ...], elem_bytes: int,
                    registry_path: str):
    """Registry lookup, memoised in-process so the JSON layer is touched
    once per shape; keyed on the registry path so repointing
    ``REPRO_TORCH_TUNE_REGISTRY`` misses."""
    from repro_torch.core import tuner
    from repro_torch.core.loopnest import ConvLayer
    n, oc, ic, h, w, kh, kw = shape_key
    ranked = tuner.cached_tune_conv(ConvLayer(oc, ic, h, w, kh, kw),
                                    elem_bytes=elem_bytes, top_k=1,
                                    batch=n)
    return ranked[0][0]


def conv2d_tuned(img: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """``conv2d`` with the schedule the H100 cost model ranks first for
    this batch, through the tuning registry: the first call on a new
    shape pays one batch sweep and persists it; every later call reuses
    it."""
    from repro_torch.core.registry import TuningRegistry
    n, ic, _, _, oc, kh, kw, h, w = _shapes(img, wgt)
    sched = _tuned_schedule((n, oc, ic, h, w, kh, kw), img.element_size(),
                            TuningRegistry.default_path())
    return conv2d(img, wgt, block=sched.block_dict(),
                  grid_order=sched.grid_order)


def conv2d_scheduled(img: torch.Tensor, wgt: torch.Tensor, *,
                     schedule) -> torch.Tensor:
    """``conv2d`` with a :class:`~repro_torch.core.schedule.ConvSchedule`."""
    return conv2d(img, wgt, block=schedule.block_dict(),
                  grid_order=schedule.grid_order)


def conv2d_dispatched(img: torch.Tensor, wgt: torch.Tensor, *,
                      service=None) -> torch.Tensor:
    """``conv2d`` through the port's dispatch service (the problem holds
    the batch): it proposes one of
    the registry-backed top-K schedules, the call is timed (synchronised
    on the card, so the time is the kernel's and not the enqueue's), and
    the measurement feeds the online selector, which commits the argmin
    and writes it back to the registry once steady."""
    from repro_torch.runtime.dispatch import get_dispatch_service
    n, ic, _, _, oc, kh, kw, h, w = _shapes(img, wgt)
    svc = service if service is not None else get_dispatch_service()
    problem = {"oc": oc, "ic": ic, "h": h, "w": w, "kh": kh, "kw": kw,
               "n": n}
    with svc.measure("conv2d", problem, elem_bytes=img.element_size(),
                     device=img.device) as sched:
        out = conv2d(img, wgt, block=sched.block_dict(),
                     grid_order=sched.grid_order)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out


__all__ = ["conv2d", "conv2d_tuned", "conv2d_scheduled",
           "conv2d_dispatched", "conv2d_ref", "conv2d_plain",
           "default_block", "GRID_AXES"]
