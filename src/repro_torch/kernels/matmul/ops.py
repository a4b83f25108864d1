"""Wrapper of the CUDA tiled-matmul kernels (``csrc/matmul.cu``).

``matmul`` replaces ``matmul_pallas`` (``src/repro/kernels/matmul/
kernel.py``) behind the JAX package's ops surface: ``matmul`` with an
explicit schedule (blocks, grid order, resident RHS),
``matmul_scheduled``, ``matmul_tuned`` (the H100 cost model's rank-0
through the port's registry) and ``matmul_dispatched`` (the port's
dispatch service).

For CPU tensors the wrapper runs the plain version (``ref.matmul_plain``);
for CUDA tensors it launches the kernel or raises: bf16 runs the
persistent wgmma body on the tensor cores (staging route per operand
``staging_route``; its launch plan, grid and tail split,
``_geometry.matmul_plan`` at the card's resident blocks), float32 the
CUDA-core body in IEEE fp32 (``_geometry.matmul_layout`` gives each
one's layout).  ``matmul.launches`` counts launches: one for k innermost
or a resident RHS, one per k block for a read-modify-write schedule.

The bf16 tail split finds the last part of a tile through a ticket
counter a tile, kept per (device, stream) and zeroed once, as the decode
kernels keep theirs: each launch leaves them at zero again, so a CUDA
graph replays with no memset, and counters first made inside a capture
raise (``_scratch``).  The f32 partials come from ``torch.empty``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (KERNEL_DTYPES, check_same, on_cpu,
                                         require)
from repro_torch.kernels._geometry import (MatmulPlan, matmul_layout,
                                           matmul_mma_route, matmul_mma_tile,
                                           matmul_plan, tensor_cores)
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
    lib = _build.load()
    stream = _build.stream_handle(a.device)
    if mma:
        # n tiles fastest when m comes first in the order; a resident RHS
        # walks each column's m tiles
        m_outer = int(not resident_rhs
                      and order.index("m") < order.index("n"))
        route = staging_route(a, b)
    else:
        m_outer = int(resident_rhs or order.index("m") < order.index("n"))
    for k0, count, accumulate in passes:
        if mma:
            plan = launch_plan(a, m, n, k, bm, bn, bk, count, resident_rhs)
            ws, tickets = _scratch(plan, a.device)
            rc = lib.matmul_mma_fwd(
                a.data_ptr(), b.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if tickets is None else tickets.data_ptr(), m, n, k,
                bm, bn, bk, tile.bn_pad, tile.stages, m_outer, k0, count,
                accumulate, int(resident_rhs), int(route[0] == "tma"),
                int(route[1] == "tma"), plan.grid, plan.full_tiles,
                plan.tail_tiles, plan.splits, stream)
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

# (device index, raw stream) -> zeroed int32 ticket counters
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
# counters that larger ones replaced: a graph may hold their address
_RETIRED: List[torch.Tensor] = []
# (library, device index, bm, bn_pad, smem) -> resident blocks
_RESIDENT: Dict[Tuple[int, int, int, int, int], int] = {}


def resident_blocks(device: torch.device, bm: int, bn_pad: int,
                    smem: int) -> int:
    """Blocks of the bf16 body at ``smem`` bytes that the card holds at
    once (the occupancy query times the SMs), asked once per (library,
    device, instance, bytes)."""
    lib = _build.load()
    key = (id(lib), device.index, bm if bm <= 64 else 128, bn_pad, smem)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.matmul_mma_resident(
                bm, bn_pad, smem, ctypes.addressof(out)),
                "matmul_mma_resident")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def launch_plan(a: torch.Tensor, m: int, n: int, k: int, bm: int, bn: int,
                bk: int, k_count: int, resident_rhs: bool) -> MatmulPlan:
    """The bf16 launch's plan at the card's resident blocks; raises on
    one the kernel cannot run."""
    tile = matmul_mma_tile(bm, bn, bk, k, resident_rhs)
    plan = matmul_plan(
        m, n, k, bm, bn, bk, k_count=k_count, resident_rhs=resident_rhs,
        resident_blocks=(resident_blocks(a.device, bm, tile.bn_pad,
                                         tile.smem)
                         if tile.error is None else None))
    require(plan.error is None, f"matmul: {plan.error}")
    return plan


def _scratch(plan: MatmulPlan, device: torch.device):
    """(partials workspace or None, ticket counters or None) for one
    launch: the workspace from the caching allocator (no launch), the
    counters those of the current stream, zeroed when first made or
    grown (never inside a CUDA graph capture; the ones they replace are
    kept, since a graph captured earlier may still use them)."""
    if plan.splits == 1:
        return None, None
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                     device=device)
    key = (device.index, _build.stream_handle(device))
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < plan.tickets:
        require(not torch.cuda.is_current_stream_capturing(),
                "matmul ticket counters must exist before a CUDA graph "
                "capture: run the call once on the capture stream first")
        if tickets is not None:
            _RETIRED.append(tickets)
        tickets = torch.zeros(max(plan.tickets, 1024), dtype=torch.int32,
                              device=device)
        _TICKETS[key] = tickets
    return ws, tickets


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
           "launch_plan", "resident_blocks",
           "default_block", "GRID_AXES"]
