"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import numbers
from typing import Optional, Sequence

import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper then runs the plain version).

    Any device other than the CPU and CUDA raises: a wrapper never
    falls back to the plain version for a tensor it cannot launch on."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got "
                         f"a tensor on {t.device}")
    return False


def require(cond: bool, msg: str) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``."""
    if not cond:
        raise ValueError(msg)


def check_same(name: str, ts: Sequence[torch.Tensor],
               dtype: Optional[torch.dtype] = None) -> None:
    """All of ``ts`` on one CUDA device, contiguous, and (when given)
    of ``dtype``; raise otherwise."""
    dev = ts[0].device
    for t in ts:
        require(t.device == dev, f"{name}: tensors on {t.device} and {dev}")
        require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        if dtype is not None:
            require(t.dtype == dtype,
                    f"{name}: expected {dtype}, got {t.dtype}")


def q_scale(q: torch.Tensor) -> float:
    """``1/sqrt(D)`` rounded to q's dtype, as every Pallas entry takes it
    (``jnp.asarray(scale, q.dtype)``); the kernels multiply q by it and
    round the product to q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return float(torch.tensor(scale, dtype=q.dtype))


def scale_q(q: torch.Tensor) -> torch.Tensor:
    """``q * 1/sqrt(D)`` in q's own dtype (the plain versions' side of
    :func:`q_scale`): the scale is rounded to q's dtype and the product
    is rounded once."""
    return q * torch.tensor(q_scale(q), dtype=q.dtype, device=q.device)


def int_vector(x, n: int, device: torch.device, name: str,
               dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``x`` (an int, or a tensor of [n] or no dims) as a contiguous [n]
    integer tensor of ``dtype`` on ``device``.  An int is filled on the
    device, so no host-to-device copy stalls the stream."""
    if isinstance(x, numbers.Integral):
        return torch.full((n,), int(x), dtype=dtype, device=device)
    require(isinstance(x, torch.Tensor), f"{name} must be an int or a "
            f"tensor, got {type(x).__name__}")
    t = x.to(device=device, dtype=dtype)
    if t.dim() == 0:
        t = t.expand(n)
    require(t.shape == (n,), f"{name} must be a scalar or [{n}], got "
            f"{tuple(t.shape)}")
    return t.contiguous()
