"""Wrapper of the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

``ssm_scan`` replaces ``ssm_scan_pallas``
(``src/repro/kernels/ssm_scan/kernel.py``).  On an H100 the prefill scan
is bound by its exps on the special-function units (67 M of them at
[1, 512, 8192], N 16: ~16 us against ~10 us for its ~35 MB), and the
S = 1 decode step by the float32 state it reads and writes.  The kernel
keeps every [Bt, S, Di, N] intermediate out of device memory, as the TPU
kernel kept its state in VMEM: a block scans ``block_d`` channels over
the whole sequence, each channel's N states split across N / 4 lanes of
a warp with the state in registers, and x, dt, b and c staged in shared
memory a tile of steps ahead, so no step waits on device memory
(``_geometry.scan_layout`` gives the block; the source has the design).

``block_d``, the channels a block scans, is the launch parameter: a
:class:`~repro_torch.core.schedule.SSMScanSchedule` sets it through
:func:`ssm_scan_scheduled`, the port's dispatch service through
:func:`ssm_scan_dispatched`.

For CPU tensors the wrapper runs the plain version in ``ref.py`` (which
has no blocks); for CUDA tensors it launches the kernel or raises, also
on a ``block_d`` the kernel refuses.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _launches
from repro_torch.kernels._geometry import SCAN_STATES, scan_layout
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same, on_cpu,
                                         require)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

# State sizes the kernel is instantiated for: falcon-mamba-7b (16) and
# its smoke config (8).
KERNEL_STATES = SCAN_STATES
# Channels a block on the main path: 32 (128 threads; Di = 8192 at
# batch 1 gives 256 blocks, two an SM), measured fastest of chip_smoke's
# sweep of 32-256 at both prefill shapes on an H100 (1-3% ahead of 64;
# 128 and 256 leave SMs idle at batch 1) and level with it at the decode
# step (PERF.md).
DEFAULT_BLOCK_D = 32


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             block_d: int = DEFAULT_BLOCK_D
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [Bt,S,Di] (float32 or bf16); dt [Bt,S,Di], b/c [Bt,S,N], a
    [Di,N] float32; d [Di] in x's dtype; h0 [Bt,Di,N] float32 or None
    (zeros).  Returns (y [Bt,S,Di] in x's dtype, final state [Bt,Di,N]
    float32).  ``block_d`` channels a block (a multiple of 32, with
    ``block_d * N / 4`` threads at most 1024) is the kernel's launch
    parameter; the plain version has no blocks."""
    if on_cpu(x):
        return ssm_scan_ref(x, dt, b, c, a, d, h0)
    name = "ssm_scan"
    require(x.dim() == 3, f"{name}: x must be [Bt,S,Di], got "
            f"{tuple(x.shape)}")
    bt, seq, di = x.shape
    require(b.dim() == 3 and b.shape[:2] == (bt, seq),
            f"{name}: b must be [Bt,S,N], got {tuple(b.shape)}")
    n = b.shape[2]
    require(seq >= 1, f"{name}: empty sequence")
    require(x.dtype in KERNEL_DTYPES, f"{name}: dtype {x.dtype} not "
            f"supported")
    layout = scan_layout(block_d, n, x.element_size())
    require(layout.error is None, f"{name}: {layout.error}")
    require(dt.shape == x.shape, f"{name}: dt {tuple(dt.shape)} must be "
            f"{tuple(x.shape)}")
    require(c.shape == b.shape, f"{name}: c {tuple(c.shape)} must be "
            f"{tuple(b.shape)}")
    require(a.shape == (di, n), f"{name}: a must be [{di},{n}]")
    require(d.shape == (di,), f"{name}: d must be [{di}]")
    check_same(name, [x, d], x.dtype)
    f32 = [dt, b, c, a] + ([] if h0 is None else [h0])
    check_same(name, [x] + f32)
    check_same(name, f32, torch.float32)
    if h0 is not None:
        require(h0.shape == (bt, di, n), f"{name}: h0 must be "
                f"[{bt},{di},{n}], got {tuple(h0.shape)}")
    y = torch.empty_like(x)
    h_out = torch.empty((bt, di, n), dtype=torch.float32, device=x.device)
    rc = _build.load().ssm_scan_fwd(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), d.data_ptr(), None if h0 is None else h0.data_ptr(),
        y.data_ptr(), h_out.data_ptr(), bt, seq, di, n, block_d,
        int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check(rc, "ssm_scan_fwd")
    ssm_scan.launches += 1
    _launches.note(name, block_d=block_d)
    return y, h_out


ssm_scan.launches = 0


def ssm_scan_scheduled(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       h0: Optional[torch.Tensor] = None, *, schedule=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan` with an
    :class:`~repro_torch.core.schedule.SSMScanSchedule`'s ``block_d``
    (None: the default)."""
    if schedule is None:
        return ssm_scan(x, dt, b, c, a, d, h0)
    return ssm_scan(x, dt, b, c, a, d, h0, block_d=schedule.block_d)


def ssm_scan_dispatched(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                        h0: Optional[torch.Tensor] = None, *, service=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssm_scan` through the port's dispatch service: ``block_d``
    for this (Bt, S, Di, N) shape comes from the registry-backed top-K,
    and the call's time (synchronised on the card) feeds the selector,
    which commits and writes back once steady."""
    from repro_torch.runtime.dispatch import get_dispatch_service
    bt, seq, di = x.shape
    svc = service if service is not None else get_dispatch_service()
    problem = {"bt": bt, "seq": seq, "di": di, "n": b.shape[2]}
    with svc.measure("ssm_scan", problem, elem_bytes=x.element_size(),
                     device=x.device) as sched:
        out = ssm_scan_scheduled(x, dt, b, c, a, d, h0, schedule=sched)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    return out


__all__ = ["ssm_scan", "ssm_scan_scheduled", "ssm_scan_dispatched",
           "DEFAULT_BLOCK_D", "KERNEL_STATES"]
