"""The port's persistent tuning registry: ranked schedules and measured
winners that survive the process.

Every record is stored under a four-part key, as in the JAX package::

    (kind, problem signature, machine fingerprint, cost-model version)

Storage is JSON-lines: one canonical (sorted-keys, compact) JSON object
per line, appended under ``O_APPEND``; readers replay the log, last
write per key wins.  The port's registry is its own file
(``~/.cache/repro_torch/tuning.jsonl``, or ``REPRO_TORCH_TUNE_REGISTRY``),
so tools of the JAX package never read H100 records.

Every rewrite of the file (:meth:`TuningRegistry.compact`, and through
it ``invalidate``) and every append happens under the registry's lock, so
a thread's append never lands in a file another thread is replacing.
:meth:`TuningRegistry.merge` is the fleet-sync union (``python -m
repro_torch.tune merge``/``sync``), with the JAX package's conflict rule
(:func:`prefer_record`) and its machine last-seen sidecar.

Machine keys: an offline ranking is a prediction of the H100 cost model
and is keyed by the spec's fingerprint; a Loki sweep (``conv_sweep``) or
an ECM record by the ``MachineModel``'s, under the Loki model's own
version strings, so those keys equal the JAX package's letter for
letter.  The dispatch service keys its
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
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

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
    machine (``H100Spec``, ``MachineModel``, a runtime description, ...).
    Hashable (frozen) dataclasses are memoised per process."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        try:
            return _fingerprint_dataclass(obj)
        except TypeError:
            # unhashable (mutable) dataclass: compute without the cache
            payload = {"__class__": type(obj).__name__,
                       **dataclasses.asdict(obj)}
    else:
        payload = obj
    return hashlib.sha256(canonical_json(payload).encode()).hexdigest()[:12]


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


# Which cost-model tier produced each record kind: the roofline-style
# analytic models, the ECM layer-condition tier, or the exact
# trace-driven simulator.  A record may override it with an explicit
# ``value["tier"]`` (an ``ecm_sweep`` winner an exact consultation
# decided).
KIND_TIERS: Dict[str, str] = {
    "conv_sweep": "roofline",
    "conv_schedule": "roofline",
    "matmul_schedule": "roofline",
    "sparse_conv_schedule": "roofline",
    "flash_attention_schedule": "roofline",
    "decode_attention_schedule": "roofline",
    "ssm_scan_schedule": "roofline",
    "ecm_sweep": "ecm",
    "ecm_correction": "ecm",
    "exact_sweep": "exact",
}


def kind_tier(kind: str) -> str:
    """Default cost-model tier for a record kind ("other" if unknown)."""
    return KIND_TIERS.get(kind, "other")


class TuningRegistry:
    """Versioned on-disk store of tuning results (JSON-lines).

    ``path=None`` keeps the registry in memory only (tests, one-shot
    runs).  Every ``put`` with a path appends one line; :meth:`compact`
    canonicalises the file.
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

    def compact(self) -> None:
        """Rewrite the log as one canonical line per key, sorted by key,
        so the file's bytes depend only on the record set.  Atomic (a
        temporary file, then a rename), under the lock every append
        takes."""
        if not self.path:
            return
        with self._lock:
            items = sorted(self._records.items())
            dirname = os.path.dirname(os.path.abspath(self.path)) or "."
            os.makedirs(dirname, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    for _, rec in items:
                        f.write(canonical_json(rec.to_dict()) + "\n")
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise

    def export_json(self, path: str) -> int:
        """Dump the current state as one pretty JSON array."""
        with self._lock:
            recs = [rec.to_dict() for _, rec in sorted(self._records.items())]
        with open(path, "w", encoding="utf-8") as f:
            json.dump(recs, f, indent=2, sort_keys=True)
            f.write("\n")
        return len(recs)

    def get(self, key: RegistryKey) -> Optional[TuningRecord]:
        """The record stored under ``key``, or None."""
        return self._records.get(key.canonical())

    def put(self, record: TuningRecord, persist: bool = True) -> None:
        """Store (and by default append-persist) one record; the append
        happens under the lock, so it never races a :meth:`compact`."""
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

    def invalidate(self, kind: Optional[str] = None,
                   machine: Optional[str] = None,
                   cost_model: Optional[str] = None,
                   persist: bool = True) -> int:
        """Drop records matching all given filters (None = wildcard);
        with no filter, every record.  Persisting compacts the file."""
        with self._lock:
            doomed = [ck for ck, rec in self._records.items()
                      if (kind is None or rec.key.kind == kind)
                      and (machine is None or rec.key.machine == machine)
                      and (cost_model is None
                           or rec.key.cost_model == cost_model)]
            for ck in doomed:
                del self._records[ck]
        if doomed and persist:
            self.compact()
        return len(doomed)

    def merge(self, other: "TuningRegistry",
              persist: bool = True) -> Dict[str, int]:
        """Content-addressed union with ``other`` (fleet sync).

        Identical records dedupe; a key conflict goes to
        :func:`prefer_record`, a total order, so ``a.merge(b)`` and
        ``b.merge(a)`` converge on the same record set."""
        stats = {"added": 0, "replaced": 0, "kept": 0, "identical": 0}
        for rec in other.records():
            mine = self.get(rec.key)
            if mine is None:
                self.put(rec, persist=persist)
                stats["added"] += 1
            elif canonical_json(mine.to_dict()) == \
                    canonical_json(rec.to_dict()):
                stats["identical"] += 1
            elif prefer_record(mine, rec) is mine:
                stats["kept"] += 1
            else:
                self.put(rec, persist=persist)
                stats["replaced"] += 1
        return stats

    def _sorted_items(self) -> List[Tuple[str, TuningRecord]]:
        """(canonical key, record) pairs in canonical key order, read
        under the lock."""
        with self._lock:
            return sorted(self._records.items())

    def machines(self) -> List[str]:
        """Distinct machine fingerprints present in the record set."""
        return sorted({rec.key.machine for _, rec in self._sorted_items()})

    def keys(self) -> List[RegistryKey]:
        """All keys, sorted canonically."""
        return [rec.key for _, rec in self._sorted_items()]

    def records(self) -> Iterator[TuningRecord]:
        """All records in canonical key order."""
        for _, rec in self._sorted_items():
            yield rec

    def __len__(self) -> int:
        """Number of distinct keys held."""
        return len(self._records)

    def __contains__(self, key: RegistryKey) -> bool:
        """Whether ``key`` has a stored record."""
        return key.canonical() in self._records

    def stats(self) -> Dict[str, Any]:
        """Summary counts: total, per kind, per cost-model tier (an
        explicit ``value["tier"]`` wins over the kind's default), and how
        many records carry run-time measurements."""
        by_kind: Dict[str, int] = {}
        by_tier: Dict[str, int] = {}
        measured = 0
        for _, rec in self._sorted_items():
            by_kind[rec.key.kind] = by_kind.get(rec.key.kind, 0) + 1
            tier = rec.value.get("tier") or kind_tier(rec.key.kind)
            by_tier[tier] = by_tier.get(tier, 0) + 1
            measured += rec.measured is not None
        return {"records": len(self._records), "by_kind": by_kind,
                "by_tier": by_tier, "measured": measured,
                "path": self.path,
                "malformed_lines": self.malformed_lines}


_DEFAULT_REGISTRY: Optional[TuningRegistry] = None


def prefer_record(a: TuningRecord, b: TuningRecord) -> TuningRecord:
    """Deterministic, order-independent conflict rule for merges: a
    measured record beats an unmeasured one, more ranked schedules beat
    fewer, and canonical bytes break the remaining ties."""
    def rank(rec: TuningRecord):
        """Sort key of the conflict rule (higher wins)."""
        return (rec.measured is not None,
                len(rec.value.get("schedules", ())),
                len(rec.value.get("costs", ())))
    ra, rb = rank(a), rank(b)
    if ra != rb:
        return a if ra > rb else b
    ca, cb = canonical_json(a.to_dict()), canonical_json(b.to_dict())
    return a if ca <= cb else b


# Machine last-seen sidecar (fleet eviction): records carry no wall-clock
# time, so ``<registry>.machines.json`` maps a machine fingerprint to the
# ISO date it was last seen in a merge; ``tune merge --evict-days N``
# drops records of machines not seen for N days.

def machine_seen_path(registry_path: str) -> str:
    """Path of the last-seen sidecar next to a registry file."""
    return registry_path + ".machines.json"


def load_machine_seen(registry_path: str) -> Dict[str, str]:
    """Read the sidecar: machine fingerprint -> last-seen ISO date."""
    path = machine_seen_path(registry_path)
    if not os.path.exists(path):
        return {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        return {str(k): str(v) for k, v in d.items()}
    except (ValueError, OSError):
        return {}


def save_machine_seen(registry_path: str, seen: Dict[str, str]) -> None:
    """Write the sidecar (sorted, pretty) next to the registry."""
    path = machine_seen_path(registry_path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dict(sorted(seen.items())), f, indent=2, sort_keys=True)
        f.write("\n")


def _machine(machine: Any) -> str:
    """A machine fingerprint: a string as given, else the spec's."""
    return machine if isinstance(machine, str) else fingerprint(machine)


def conv_problem(layer: Any, elem_bytes: int = 2, batch: int = 1
                 ) -> Dict[str, Any]:
    """Canonical problem dict of a ConvLayer shape at ``batch`` images."""
    return {"oc": layer.oc, "ic": layer.ic, "h": layer.h, "w": layer.w,
            "kh": layer.kh, "kw": layer.kw, "n": batch,
            "elem_bytes": elem_bytes}


def conv_layer_from_problem(problem: Dict[str, Any]) -> Any:
    """Rebuild the ConvLayer a :func:`conv_problem` dict describes."""
    from repro_torch.core.loopnest import ConvLayer
    return ConvLayer(problem["oc"], problem["ic"], problem["h"],
                     problem["w"], problem["kh"], problem["kw"])


def loki_problem(layer: Any) -> Dict[str, Any]:
    """Problem dict of a layer of the Loki model's records: the JAX
    package's ``conv_problem`` at the layer's element size (no batch)."""
    problem = conv_problem(layer, layer.elem_bytes)
    del problem["n"]
    return problem


def conv_sweep_key(layer: Any, machine: Any, threads: int = 1,
                   ) -> RegistryKey:
    """Key of a tier-1 720-permutation Loki sweep signature, under the
    Loki model's version (equal to the JAX package's key)."""
    from repro_torch.core.loki import LOKI_MODEL_VERSION
    problem = {**loki_problem(layer), "threads": threads}
    return RegistryKey.make("conv_sweep", problem,
                            _machine(machine), LOKI_MODEL_VERSION)


def ecm_sweep_key(layer: Any, machine: Any, threads: int = 1,
                  ) -> RegistryKey:
    """Key of a tier-2 ECM sweep winner, under
    :data:`repro_torch.core.ecm.ECM_MODEL_VERSION`."""
    from repro_torch.core.ecm import ECM_MODEL_VERSION
    problem = {**loki_problem(layer), "threads": threads}
    return RegistryKey.make("ecm_sweep", problem,
                            _machine(machine), ECM_MODEL_VERSION)


def ecm_correction_key(machine: Any) -> RegistryKey:
    """Key of a machine's learned ECM correction: the "problem" is the
    correction's functional form, so a refit overwrites in place."""
    from repro_torch.core.ecm import ECM_MODEL_VERSION, N_FEATURES
    problem = {"features": N_FEATURES, "form": "log-linear"}
    return RegistryKey.make("ecm_correction", problem, _machine(machine),
                            ECM_MODEL_VERSION)


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
    "KIND_TIERS", "kind_tier", "prefer_record", "conv_layer_from_problem",
    "loki_problem",
    "conv_sweep_key", "ecm_sweep_key", "ecm_correction_key",
    "machine_seen_path", "load_machine_seen", "save_machine_seen",
]
