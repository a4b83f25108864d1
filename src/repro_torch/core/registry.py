"""The port's persistent tuning registry: ranked schedules and measured
winners that survive the process.

Every record is stored under a four-part key, as in the JAX package::

    (kind, problem signature, machine fingerprint, cost-model version)

Storage is JSON-lines: one canonical (sorted-keys, compact) JSON object
per line, appended under ``O_APPEND``; readers replay the log, last
write per key wins.  The port's registry is its own file
(``~/.cache/repro_torch/tuning.jsonl``, or ``REPRO_TORCH_TUNE_REGISTRY``),
so tools of the JAX package never read H100 records.

Machine keys: an offline ranking is a prediction of the H100 cost model
and is keyed by the spec's fingerprint.  The dispatch service keys its
slots, and so its measured write-back, by the spec *and*
:func:`runtime_fingerprint` of the torch device that ran the calls, so a
time taken on the CPU is never stored under a key the card reads, nor
the reverse.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import logging
import os
import threading
from typing import Any, Dict, Optional, Tuple

log = logging.getLogger("repro_torch.registry")

SCHEMA_VERSION = 1

_ENV_PATH = "REPRO_TORCH_TUNE_REGISTRY"
_DEFAULT_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "tuning.jsonl")


def canonical_json(obj: Any) -> str:
    """Deterministic serialisation: sorted keys, no whitespace."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@functools.lru_cache(maxsize=1024)
def _fingerprint_dataclass(obj: Any) -> str:
    """Memoised digest of a frozen (hashable) dataclass."""
    payload = {"__class__": type(obj).__name__, **dataclasses.asdict(obj)}
    return hashlib.sha256(canonical_json(payload).encode()).hexdigest()[:12]


def fingerprint(obj: Any) -> str:
    """Stable 12-hex digest of a dataclass / dict / tuple describing a
    machine (``H100Spec``, a runtime description, ...)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return _fingerprint_dataclass(obj)
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()[:12]


def runtime_fingerprint(device) -> str:
    """Fingerprint of the torch device that runs (and times) the calls:
    the card's name, compute capability and the device count, or
    ``{"platform": "cpu"}``."""
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return fingerprint({"platform": "cpu"})
    if dev.type != "cuda":
        raise ValueError(f"no runtime fingerprint for device {dev}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return fingerprint({"platform": "cuda",
                        "name": torch.cuda.get_device_name(index),
                        "capability": list(
                            torch.cuda.get_device_capability(index)),
                        "device_count": torch.cuda.device_count()})


def machine_key(spec: Any, device=None) -> str:
    """The machine part of a key: the spec's fingerprint alone (an
    offline prediction), or with ``device`` the spec and the runtime
    together (what a measurement on that device is filed under)."""
    if device is None:
        return fingerprint(spec)
    return fingerprint({"spec": fingerprint(spec),
                        "runtime": runtime_fingerprint(device)})


@dataclasses.dataclass(frozen=True)
class RegistryKey:
    """The four-part key every record is stored under."""

    kind: str
    problem: Tuple[Tuple[str, Any], ...]   # hashable canonical form
    machine: str                           # fingerprint
    cost_model: str                        # cost-model version string

    @staticmethod
    def make(kind: str, problem: Dict[str, Any], machine: str,
             cost_model: str) -> "RegistryKey":
        """Build a key from a problem dict (canonicalised to a tuple)."""
        return RegistryKey(kind, tuple(sorted(problem.items())), machine,
                           cost_model)

    def problem_dict(self) -> Dict[str, Any]:
        """The problem signature back as a plain dict."""
        return dict(self.problem)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-serialisable form (inverse of :meth:`from_dict`)."""
        return {"kind": self.kind, "problem": self.problem_dict(),
                "machine": self.machine, "cost_model": self.cost_model}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RegistryKey":
        """Rebuild a key from its :meth:`to_dict` form."""
        return RegistryKey.make(d["kind"], d["problem"], d["machine"],
                                d["cost_model"])

    def canonical(self) -> str:
        """Canonical-JSON identity string (the in-memory map key)."""
        return canonical_json(self.to_dict())


@dataclasses.dataclass
class TuningRecord:
    """One tuning result: the ranked schedules and their predicted costs,
    plus (after an online commit) the measured winner and its time."""
    key: RegistryKey
    value: Dict[str, Any]
    measured: Optional[Dict[str, Any]] = None
    source: str = "offline"

    def to_dict(self) -> Dict[str, Any]:
        """JSON-serialisable form, schema-stamped (one JSONL line)."""
        return {"schema": SCHEMA_VERSION, "key": self.key.to_dict(),
                "value": self.value, "measured": self.measured,
                "source": self.source}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TuningRecord":
        """Rebuild a record from its :meth:`to_dict` form."""
        return TuningRecord(key=RegistryKey.from_dict(d["key"]),
                            value=d["value"], measured=d.get("measured"),
                            source=d.get("source", "offline"))


def schedule_to_dict(sched: Any) -> Dict[str, Any]:
    """Serialise a schedule to a typed JSON dict (the JAX package's
    form)."""
    from repro_torch.core import schedule as sch
    if isinstance(sched, sch.ConvSchedule):
        return {"type": "conv", "grid_order": list(sched.grid_order),
                "block": sched.block_dict()}
    if isinstance(sched, sch.MatmulSchedule):
        return {"type": "matmul", "grid_order": list(sched.grid_order),
                "block": sched.block_dict(),
                "resident_rhs": bool(sched.resident_rhs)}
    if isinstance(sched, sch.FlashAttentionSchedule):
        return {"type": "flash_attention", "block_q": int(sched.block_q),
                "block_kv": int(sched.block_kv)}
    if isinstance(sched, sch.DecodeAttentionSchedule):
        return {"type": "decode_attention", "block_kv": int(sched.block_kv)}
    if isinstance(sched, sch.SSMScanSchedule):
        return {"type": "ssm_scan", "block_d": int(sched.block_d)}
    if isinstance(sched, sch.SparseConvSchedule):
        return {"type": "sparse_conv", "block": sched.block_dict()}
    raise TypeError(f"not a schedule of the port: {sched!r}")


def schedule_from_dict(d: Dict[str, Any]) -> Any:
    """Inverse of :func:`schedule_to_dict` (raises on unknown types)."""
    from repro_torch.core import schedule as sch
    if d["type"] == "conv":
        return sch.ConvSchedule.make(d["grid_order"], d["block"])
    if d["type"] == "matmul":
        return sch.MatmulSchedule.make(d["grid_order"], d["block"],
                                       d.get("resident_rhs", False))
    if d["type"] == "flash_attention":
        return sch.FlashAttentionSchedule(int(d["block_q"]),
                                          int(d["block_kv"]))
    if d["type"] == "decode_attention":
        return sch.DecodeAttentionSchedule(int(d["block_kv"]))
    if d["type"] == "ssm_scan":
        return sch.SSMScanSchedule(int(d["block_d"]))
    if d["type"] == "sparse_conv":
        return sch.SparseConvSchedule.make(d["block"])
    raise ValueError(f"cannot rebuild schedule of type {d['type']!r}")


def cost_to_dict(cost: Any) -> Dict[str, Any]:
    """Serialise a predicted cost to a plain dict."""
    return dataclasses.asdict(cost)


def cost_from_dict(d: Dict[str, Any]) -> Any:
    """Inverse of :func:`cost_to_dict` (KernelCost fields)."""
    from repro_torch.core.cost_model import KernelCost
    return KernelCost(**d)


# Which cost-model tier produced each record kind.  The port has the
# roofline-style analytic tier only.
KIND_TIERS: Dict[str, str] = {
    "conv_schedule": "roofline",
    "matmul_schedule": "roofline",
    "sparse_conv_schedule": "roofline",
    "flash_attention_schedule": "roofline",
    "decode_attention_schedule": "roofline",
    "ssm_scan_schedule": "roofline",
}


def kind_tier(kind: str) -> str:
    """Default cost-model tier for a record kind ("other" if unknown)."""
    return KIND_TIERS.get(kind, "other")


class TuningRegistry:
    """Versioned on-disk store of tuning results (JSON-lines).

    ``path=None`` keeps the registry in memory only (tests, one-shot
    runs).  Every ``put`` with a path appends one line.
    """

    def __init__(self, path: Optional[str] = None, autoload: bool = True):
        """Open (and by default replay) the registry at ``path``."""
        self.path = path
        self._records: Dict[str, TuningRecord] = {}
        self._lock = threading.Lock()
        self.malformed_lines = 0
        if path and autoload:
            self.load()

    @staticmethod
    def default_path() -> str:
        """``REPRO_TORCH_TUNE_REGISTRY`` or the user cache path."""
        return os.environ.get(_ENV_PATH, _DEFAULT_PATH)

    @classmethod
    def default(cls) -> "TuningRegistry":
        """The process-wide default registry (re-opened when the
        environment points elsewhere)."""
        global _DEFAULT_REGISTRY
        path = cls.default_path()
        if _DEFAULT_REGISTRY is None or _DEFAULT_REGISTRY.path != path:
            _DEFAULT_REGISTRY = cls(path)
        return _DEFAULT_REGISTRY

    def load(self) -> int:
        """Replay the JSONL log (last write per key wins).  Future-schema
        lines are skipped; malformed lines (a torn append) are counted in
        ``malformed_lines`` and reported once, never raised."""
        if not self.path or not os.path.exists(self.path):
            return 0
        n = bad = 0
        with self._lock:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        d = json.loads(line)
                        if d.get("schema", 0) > SCHEMA_VERSION:
                            continue
                        rec = TuningRecord.from_dict(d)
                    except (ValueError, KeyError, TypeError):
                        bad += 1
                        continue
                    self._records[rec.key.canonical()] = rec
                    n += 1
            self.malformed_lines += bad
        if bad:
            log.warning("registry %s: skipped %d malformed line(s); kept %d",
                        self.path, bad, n)
        return n

    def _append_line(self, rec: TuningRecord) -> None:
        """Durably append one canonical JSONL line for ``rec``; a torn
        tail left by a crashed writer is closed with a newline first."""
        if not self.path:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        buf = (canonical_json(rec.to_dict()) + "\n").encode("utf-8")
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    buf = b"\n" + buf
        except (OSError, ValueError):
            pass  # missing or empty file: nothing to repair
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, buf)
            os.fsync(fd)
        finally:
            os.close(fd)

    def get(self, key: RegistryKey) -> Optional[TuningRecord]:
        """The record stored under ``key``, or None."""
        return self._records.get(key.canonical())

    def put(self, record: TuningRecord, persist: bool = True) -> None:
        """Store (and by default append-persist) one record."""
        with self._lock:
            self._records[record.key.canonical()] = record
        if persist:
            self._append_line(record)

    def record_measurement(self, key: RegistryKey, best: Dict[str, Any],
                           time_s: float,
                           persist: bool = True) -> TuningRecord:
        """Online write-back: attach a measured winner and its time to
        ``key`` (creating the record if no ranking was stored)."""
        rec = self.get(key)
        if rec is None:
            rec = TuningRecord(key=key, value={"schedules": [best]},
                               source="adaptive")
        rec.measured = {"best": best, "time_s": float(time_s)}
        self.put(rec, persist=persist)
        return rec


_DEFAULT_REGISTRY: Optional[TuningRegistry] = None


def _machine(machine: Any) -> str:
    """A machine fingerprint: a string as given, else the spec's."""
    return machine if isinstance(machine, str) else fingerprint(machine)


def conv_problem(layer: Any, elem_bytes: int = 2, batch: int = 1
                 ) -> Dict[str, Any]:
    """Canonical problem dict of a ConvLayer shape at ``batch`` images."""
    return {"oc": layer.oc, "ic": layer.ic, "h": layer.h, "w": layer.w,
            "kh": layer.kh, "kw": layer.kw, "n": batch,
            "elem_bytes": elem_bytes}


def conv_schedule_key(layer: Any, machine: Any, elem_bytes: int = 2,
                      batch: int = 1) -> RegistryKey:
    """Key of a conv-schedule ranking at ``batch`` images; ``machine`` is
    a spec or a fingerprint (:func:`machine_key`)."""
    from repro_torch.core.cost_model import COST_MODEL_VERSION
    return RegistryKey.make("conv_schedule",
                            conv_problem(layer, elem_bytes, batch),
                            _machine(machine), COST_MODEL_VERSION)


def matmul_schedule_key(m: int, n: int, k: int, machine: Any,
                        elem_bytes: int = 2) -> RegistryKey:
    """Key of a matmul-schedule ranking."""
    from repro_torch.core.cost_model import COST_MODEL_VERSION
    problem = {"m": m, "n": n, "k": k, "elem_bytes": elem_bytes}
    return RegistryKey.make("matmul_schedule", problem, _machine(machine),
                            COST_MODEL_VERSION)


def quantize_density(density: float, steps: int = 16) -> int:
    """Density quantised to a 1/``steps`` grid (an int numerator), so
    sparse-conv keys stay a finite, canonical-JSON-stable space."""
    return max(0, min(steps, int(round(float(density) * steps))))


def sparse_conv_schedule_key(layer: Any, density: float, machine: Any,
                             elem_bytes: int = 2,
                             batch: int = 1) -> RegistryKey:
    """Key of a block-sparse conv schedule ranking at ``batch`` images."""
    from repro_torch.core.cost_model import COST_MODEL_VERSION
    problem = conv_problem(layer, elem_bytes, batch)
    problem["density_16"] = quantize_density(density)
    return RegistryKey.make("sparse_conv_schedule", problem,
                            _machine(machine), COST_MODEL_VERSION)


def flash_attention_schedule_key(b: int, hq: int, hkv: int, s: int, d: int,
                                 machine: Any, causal: bool = True,
                                 elem_bytes: int = 2) -> RegistryKey:
    """Key of a flash-attention schedule ranking (the JAX package's
    problem fields)."""
    from repro_torch.core.cost_model import COST_MODEL_VERSION
    problem = {"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d,
               "causal": bool(causal), "elem_bytes": elem_bytes}
    return RegistryKey.make("flash_attention_schedule", problem,
                            _machine(machine), COST_MODEL_VERSION)


def decode_attention_schedule_key(b: int, hq: int, hkv: int, s: int, d: int,
                                  machine: Any, elem_bytes: int = 2
                                  ) -> RegistryKey:
    """Key of a decode-attention schedule ranking."""
    from repro_torch.core.cost_model import COST_MODEL_VERSION
    problem = {"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d,
               "elem_bytes": elem_bytes}
    return RegistryKey.make("decode_attention_schedule", problem,
                            _machine(machine), COST_MODEL_VERSION)


def ssm_scan_schedule_key(bt: int, seq: int, di: int, n: int, machine: Any,
                          elem_bytes: int = 2) -> RegistryKey:
    """Key of a selective-scan schedule ranking."""
    from repro_torch.core.cost_model import COST_MODEL_VERSION
    problem = {"bt": bt, "seq": seq, "di": di, "n": n,
               "elem_bytes": elem_bytes}
    return RegistryKey.make("ssm_scan_schedule", problem, _machine(machine),
                            COST_MODEL_VERSION)


__all__ = [
    "SCHEMA_VERSION", "RegistryKey", "TuningRecord", "TuningRegistry",
    "canonical_json", "fingerprint", "runtime_fingerprint", "machine_key",
    "schedule_to_dict", "schedule_from_dict", "cost_to_dict",
    "cost_from_dict", "conv_problem", "conv_schedule_key",
    "matmul_schedule_key", "sparse_conv_schedule_key", "quantize_density",
    "flash_attention_schedule_key", "decode_attention_schedule_key",
    "ssm_scan_schedule_key",
    "KIND_TIERS", "kind_tier",
]
