"""Collective-traffic accounting for the roofline (port of
``repro.launch.hlo_analysis``).

The accounting is JAX's, unchanged: every ``all-gather`` /
``all-reduce`` / ``reduce-scatter`` / ``all-to-all`` /
``collective-permute`` line of a module's text (and their async
``-start`` forms) contributes its operand or output bytes with a
per-primitive wire multiplier (ring algorithm accounting):

    all-gather          output bytes          (each chip receives ~N)
    all-reduce          2x operand bytes      (reduce-scatter + all-gather)
    reduce-scatter      operand bytes
    all-to-all          operand bytes
    collective-permute  operand bytes

Bytes are per-shard quantities, i.e. per-chip wire traffic, which is
what the collective roofline term divides by a card's link rate.

The port has no partitioned HLO module: DTensor issues its collectives
op by op, as c10d functional ops on each rank's local shards.
:class:`CollectiveRecorder`, a ``TorchDispatchMode``, records the ones
rank 0 issues while a step runs and renders each as one HLO-style
line, for example

    %ag.3 = bf16[4096,1024]{1,0} all-gather(bf16[256,1024]{1,0} %x.3)

so :func:`parse_collectives` and :func:`collective_schedule` read the
port's "partitioned module" (:meth:`CollectiveRecorder.text`) exactly
as they read XLA's.  ``wait_tensor`` (the end of an async collective)
is not a collective.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLL_RE = re.compile(
    r"= *((?:\([^)]*\))|(?:\S+)) +"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(-start)?\(")

_MULTIPLIER = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def shape_bytes(token: str) -> int:
    """Bytes of one ``dtype[a,b,c]`` token (0 if not a shape)."""
    m = _SHAPE_RE.match(token)
    if not m:
        return 0
    dt, dims = m.groups()
    if dt not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


@dataclasses.dataclass
class CollectiveStats:
    """Wire bytes and counts by collective kind, and each op in order."""
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    ops: List[Tuple[str, float]]

    @property
    def total_bytes(self) -> float:
        """Wire bytes of every kind."""
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        """Collectives of every kind."""
        return sum(self.count_by_kind.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """The collectives of a module's text, each at its wire bytes (see
    the module docstring)."""
    bytes_by: Dict[str, float] = {}
    count_by: Dict[str, int] = {}
    ops: List[Tuple[str, float]] = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        out_shapes, kind, is_start = m.group(1), m.group(2), m.group(3)
        if is_start and "-done(" in line:
            continue
        # output bytes: every shape token of the output type (a tuple
        # output of a variadic or async collective has several)
        out_bytes = sum(shape_bytes(tok.strip().lstrip("("))
                        for tok in re.findall(r"\w+\[[\d,]*\]",
                                              out_shapes))
        if kind == "all-gather":
            vol = out_bytes
        else:
            # operand bytes: the shapes inside the call's parentheses
            call = line[m.end():]
            depth = 1
            end = 0
            for i, ch in enumerate(call):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        end = i
                        break
            operands = call[:end]
            op_bytes = sum(shape_bytes(tok) for tok in
                           re.findall(r"\w+\[[\d,]*\]", operands))
            vol = op_bytes
        vol *= _MULTIPLIER[kind]
        bytes_by[kind] = bytes_by.get(kind, 0.0) + vol
        count_by[kind] = count_by.get(kind, 0) + 1
        ops.append((kind, vol))
    return CollectiveStats(bytes_by_kind=bytes_by, count_by_kind=count_by,
                           ops=ops)


def collective_schedule(hlo_text: str, limit: int = 20) -> List[str]:
    """The first ``limit`` collective lines in program order, each cut to
    160 characters."""
    out = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if m:
            out.append(line.strip()[:160])
            if len(out) >= limit:
                break
    return out


# torch dtype -> HLO element type
HLO_DTYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2",
}

# c10d op name (any of the namespaces below) -> HLO collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",       # DTensor's own op
    # one rank's send to another: what a permute is made of
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
               "_dtensor")
_SHORT = {"all-gather": "ag", "all-reduce": "ar", "reduce-scatter": "rs",
          "all-to-all": "a2a", "collective-permute": "cp"}


def collective_kind(func) -> str:
    """The HLO kind of a c10d op overload, or "" for any other op
    (``wait_tensor`` included)."""
    if func.namespace not in _NAMESPACES:
        return ""
    return _KINDS.get(func._schema.name.split("::")[-1], "")


def hlo_type(t: torch.Tensor) -> str:
    """A tensor's HLO type, ``bf16[256,1024]{1,0}`` (row-major layout)."""
    dims = ",".join(str(int(d)) for d in t.shape)
    layout = ",".join(str(i) for i in reversed(range(t.dim())))
    return f"{HLO_DTYPES[t.dtype]}[{dims}]{{{layout}}}"


def _tensors(x: Any) -> List[torch.Tensor]:
    """The tensors of an op's argument or result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


# DTensor's methods that run an op on global-shape fake tensors to learn
# its output's shape and strides (the name differs between torch
# versions; each that exists is wrapped)
_META_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta")


class CollectiveRecorder(TorchDispatchMode):
    """Records every c10d collective dispatched on local tensors while
    it is entered, one HLO-style line each (:meth:`text`).

    Ops on DTensors are handed back (``NotImplemented``), so DTensor
    lowers them first and the recorder sees the local ops and the
    collectives rank 0 issues.  The ops DTensor's sharding propagation
    runs on global-shape fake tensors to learn an output's metadata
    (once per op signature, then cached) are no rank's work and are
    skipped.  Subclasses observe every other local op through
    :meth:`observe`."""

    def __init__(self) -> None:
        """An empty record."""
        super().__init__()
        self.lines: List[str] = []
        self._shadow = 0
        self._patched: List[Tuple[Any, str, Any]] = []

    def __enter__(self):
        """Enter the mode; wrap DTensor's metadata propagation."""
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name in _META_PROPAGATION:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is None:
                continue

            def wrapped(*a, _orig=orig, **k):
                """The propagation, its ops skipped."""
                self._shadow += 1
                try:
                    return _orig(*a, **k)
                finally:
                    self._shadow -= 1
            setattr(ShardingPropagator, name, wrapped)
            self._patched.append((ShardingPropagator, name, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        """Leave the mode; restore DTensor's propagation."""
        try:
            return super().__exit__(*exc)
        finally:
            for cls, name, orig in reversed(self._patched):
                setattr(cls, name, orig)
            self._patched.clear()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        """Run ``func``; record it when it is a collective."""
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        kind = collective_kind(func)
        if kind:
            self.record(kind, _tensors(list(args) + list(kwargs.values())),
                        _tensors(out))
        self.observe(func, args, kwargs, out)
        return out

    def observe(self, func, args, kwargs, out) -> None:
        """Called after every local op (a hook for subclasses)."""

    def record(self, kind: str, inputs: List[torch.Tensor],
               outputs: List[torch.Tensor]) -> None:
        """Append one collective's line."""
        n = len(self.lines)
        ins = ", ".join(f"{hlo_type(t)} %x.{n}" for t in inputs)
        outs = [hlo_type(t) for t in outputs]
        out = outs[0] if len(outs) == 1 else "(" + ", ".join(outs) + ")"
        self.lines.append(f"%{_SHORT[kind]}.{n} = {out} {kind}({ins})")

    def text(self) -> str:
        """The recorded lines, one a collective, in program order."""
        return "\n".join(self.lines)


__all__ = ["shape_bytes", "CollectiveStats", "parse_collectives",
           "collective_schedule", "HLO_DTYPES", "collective_kind",
           "hlo_type", "CollectiveRecorder"]
