"""Wrapper of the CUDA tiled-matmul kernels (``csrc/matmul.cu``).

``matmul`` replaces ``matmul_pallas`` (``src/repro/kernels/matmul/
kernel.py``) behind the JAX package's ops surface: ``matmul`` with an
explicit schedule (blocks, grid order, resident RHS),
``matmul_scheduled``, ``matmul_tuned`` (the H100 cost model's rank-0
through the port's registry) and ``matmul_dispatched`` (the port's
dispatch service).

For CPU tensors the wrapper runs the plain version (``ref.matmul_plain``);
for CUDA tensors it launches the kernel or raises: bf16 runs the wgmma
body on the tensor cores (staging route per operand ``staging_route``),
float32 the CUDA-core body in IEEE fp32 (``_geometry.matmul_layout``
gives each one's layout).  ``matmul.launches``
counts launches: one for k innermost or a resident RHS, one per k block
for a read-modify-write schedule.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same, on_cpu,
                                         require)
from repro_torch.kernels._geometry import (matmul_layout, matmul_mma_route,
                                             tensor_cores)
from repro_torch.kernels.matmul.ref import (GRID_AXES, matmul_plain,
                                            matmul_ref, uses_scratch)


def _divisor_le(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def default_block(m: int, n: int, k: int) -> Dict[str, int]:
    """The port's default blocks (divisors of their dims): 64 x 64
    output tiles and k chunks of up to 32."""
    return {"m": _divisor_le(m, 64), "n": _divisor_le(n, 64),
            "k": _divisor_le(k, 32)}


def _shapes(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int]:
    """(m, n, k); raises on shapes that do not fit together."""
    require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
            f"matmul: A [m,k] and B [k,n], got {tuple(a.shape)} and "
            f"{tuple(b.shape)}")
    return a.shape[0], b.shape[1], a.shape[1]


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           block: Optional[Dict[str, int]] = None,
           grid_order: Sequence[str] = ("m", "n", "k"),
           resident_rhs: bool = False) -> torch.Tensor:
    """C[m, n] = A[m, k] @ B[k, n] with float32 accumulation, in A's
    type.  ``block`` {"m", "n", "k"} must divide the dims;
    ``grid_order`` is a permutation of (m, n, k), outermost first;
    ``resident_rhs`` keeps each block's whole [k, bn] B panel in shared
    memory."""
    m, n, k = _shapes(a, b)
    if block is None:
        block = default_block(m, n, k)
    bm, bn, bk = (block[x] for x in GRID_AXES)
    require(m % bm == 0 and n % bn == 0 and k % bk == 0,
            f"matmul: blocks {block} must divide m={m} n={n} k={k}")
    order = tuple(grid_order)
    require(sorted(order) == sorted(GRID_AXES), f"matmul: grid order "
            f"{order} is not a permutation of {GRID_AXES}")
    if on_cpu(a):
        return matmul_plain(a, b, block=block, grid_order=order,
                            resident_rhs=resident_rhs)
    require(a.dtype in KERNEL_DTYPES, f"matmul: dtype {a.dtype} not "
            f"supported")
    check_same("matmul", [a, b], a.dtype)
    mma = tensor_cores(a.element_size())
    tile = matmul_layout(bm, bn, bk, k, a.element_size(), resident_rhs)
    require(tile.error is None, f"matmul: block {block} (resident_rhs="
            f"{resident_rhs}) does not fit the {a.dtype} kernel: "
            f"{tile.error}")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if uses_scratch(order, resident_rhs):
        passes = [(0, k, 0)]
    else:
        passes = [(k0, bk, int(k0 > 0)) for k0 in range(0, k, bk)]
    m_outer = int(resident_rhs or order.index("m") < order.index("n"))
    lib = _build.load()
    stream = _build.stream_handle(a.device)
    route = staging_route(a, b)
    for k0, count, accumulate in passes:
        if mma:
            rc = lib.matmul_mma_fwd(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                bk, tile.bn_pad, tile.stages, m_outer, k0, count, accumulate,
                int(resident_rhs), int(route[0] == "tma"),
                int(route[1] == "tma"), stream)
        else:
            rc = lib.matmul_fwd(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                bk, tile.mi, tile.mj, m_outer, k0, count, accumulate,
                int(resident_rhs), stream)
        _build.check(rc, "matmul_mma_fwd" if mma else "matmul_fwd")
        matmul.launches += 1
    return out


def staging_route(a: torch.Tensor, b: torch.Tensor) -> Tuple[str, str]:
    """How the bf16 kernel stages A and B: "tma" where the operand's rows
    are 16-byte multiples and its base is 16-byte aligned, else "regs"
    (loads through the producer's registers into the same swizzled
    stage).  A shape rule, fixed per operand."""
    k, n = a.shape[1], b.shape[1]
    a_ok, b_ok = matmul_mma_route(k, n)
    return ("tma" if a_ok and a.data_ptr() % 16 == 0 else "regs",
            "tma" if b_ok and b.data_ptr() % 16 == 0 else "regs")


matmul.launches = 0


@functools.lru_cache(maxsize=512)
def _tuned_schedule(mnk: Tuple[int, int, int], elem_bytes: int,
                    registry_path: str):
    """Registry lookup memoised per (shape, dtype, registry path)."""
    from repro_torch.core import tuner
    m, n, k = mnk
    return tuner.cached_tune_matmul(m, n, k, elem_bytes=elem_bytes,
                                    top_k=1)[0][0]


def matmul_tuned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul`` with the H100 cost model's rank-0 schedule from the
    tuning registry; tunes at most once per (m, n, k, dtype)."""
    from repro_torch.core.registry import TuningRegistry
    m, n, k = _shapes(a, b)
    sched = _tuned_schedule((m, n, k), a.element_size(),
                            TuningRegistry.default_path())
    return matmul_scheduled(a, b, schedule=sched)


def matmul_scheduled(a: torch.Tensor, b: torch.Tensor, *,
                     schedule) -> torch.Tensor:
    """``matmul`` with a :class:`~repro_torch.core.schedule.MatmulSchedule`."""
    return matmul(a, b, block=schedule.block_dict(),
                  grid_order=schedule.grid_order,
                  resident_rhs=schedule.resident_rhs)


def matmul_dispatched(a: torch.Tensor, b: torch.Tensor, *,
                      service=None) -> torch.Tensor:
    """``matmul`` through the port's dispatch service: propose a
    registry-backed candidate, time the call (synchronised on the card),
    feed the selector, commit and write back once steady."""
    from repro_torch.runtime.dispatch import get_dispatch_service
    m, n, k = _shapes(a, b)
    svc = service if service is not None else get_dispatch_service()
    with svc.measure("matmul", {"m": m, "n": n, "k": k},
                     elem_bytes=a.element_size(), device=a.device) as sched:
        out = matmul_scheduled(a, b, schedule=sched)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    return out


__all__ = ["matmul", "matmul_tuned", "matmul_scheduled",
           "matmul_dispatched", "matmul_ref", "matmul_plain", "staging_route",
           "default_block", "GRID_AXES"]
