"""Atomic, async checkpoints in the JAX package's format (port of
``repro.checkpoint.checkpointer``): a checkpoint written by either
package restores in the other.

Format: one directory per step::

    <dir>/step_00000010/manifest.json   {"extra": user metadata,
                                         "leaves": [{path, shape, dtype,
                                                     offset, nbytes}]}
    <dir>/step_00000010/data.bin        the leaves' raw bytes, in order

Leaves are keyed and ordered as ``jax.tree_util`` walks the tree
(:mod:`repro_torch.tree`): ``params/layers/attn/wq``, and for the
optimizer state ``opt/.step``, ``opt/.m/<path>``, ``opt/.v/<path>``.
bfloat16 is stored as its raw bits under the dtype name ``"bfloat16"``
(what the JAX package writes through ``ml_dtypes``; the port reads and
writes the bits as int16, needing no ``ml_dtypes``).  Writes go to
``*.tmp`` and are renamed when complete, so a crash mid-write never
corrupts the latest checkpoint.

The async mode copies the leaves to the host in the caller's thread
(the caller may update the tensors in place right after) and writes
them in a background thread; ``wait()`` joins it before the next save
or at shutdown.

Mesh-elastic (JAX's gathered save): a DTensor leaf is gathered
(``full_tensor()``, a collective every rank of its mesh joins) before it
is written, so a meshed checkpoint is byte for byte the unsharded one of
the same values, and only rank 0 writes it (the others wait for it in
``wait()``, or at the end of :func:`save`).  :func:`restore` with a
``like`` tree of DTensors places each leaf as its ``like`` leaf is
placed, on whatever mesh the run restarts with: a tree saved on a
(2, 2) mesh restores onto (4, 1) when ``like`` was placed there by the
rules.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import flatten_with_paths, map_with_paths

BF16 = "bfloat16"


def _host(leaf: Any) -> Tuple[str, np.ndarray]:
    """(dtype name, a host copy of the leaf's bytes) of a tensor or
    array leaf; bfloat16 as its int16 bits."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.detach().full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return BF16, t.view(torch.int16).numpy()
        return str(t.numpy().dtype), t.numpy()
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == BF16:
        return BF16, arr.view(np.int16)
    return str(arr.dtype), arr


def _is_dtensor(t: Any) -> bool:
    """True for a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _snapshot(tree: Any) -> List[Tuple[str, str, np.ndarray]]:
    """``(path, dtype name, host copy)`` of every leaf, taken now
    (DTensor leaves gathered)."""
    return [(path, *_host(leaf)) for path, leaf in flatten_with_paths(tree)]


def _meshed(tree: Any) -> bool:
    """True when a leaf is a DTensor: the ranks share one write."""
    return any(_is_dtensor(leaf) for _, leaf in flatten_with_paths(tree))


def _writer() -> bool:
    """True on the rank that writes a meshed checkpoint (rank 0)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    """Wait for every rank of the default group (none: return)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _write(path: str, flat: List[Tuple[str, str, np.ndarray]],
           extra: Optional[Dict]) -> None:
    """Write a snapshot atomically to ``path``."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"extra": extra or {}, "leaves": []}
    offset = 0
    with open(os.path.join(tmp, "data.bin"), "wb") as f:
        for key, name, arr in flat:
            raw = np.ascontiguousarray(arr).tobytes()
            manifest["leaves"].append({
                "path": key, "shape": list(arr.shape), "dtype": name,
                "offset": offset, "nbytes": len(raw)})
            f.write(raw)
            offset += len(raw)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def save(path: str, tree: Any, extra: Optional[Dict] = None) -> None:
    """Synchronous atomic save of a tree of tensors or arrays (and
    JSON-able ``extra`` metadata).  A tree with DTensor leaves is saved
    gathered by rank 0, and every rank returns once it is written."""
    meshed = _meshed(tree)
    flat = _snapshot(tree)
    if not meshed or _writer():
        _write(path, flat, extra)
    if meshed:
        _barrier()


def _tensor(raw: np.ndarray, entry: Dict[str, Any],
            device: torch.device) -> torch.Tensor:
    """One stored leaf as a tensor on ``device``."""
    if entry["dtype"] == BF16:
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(entry["dtype"])).copy())
    return t.reshape(entry["shape"]).to(device)


def restore(path: str, like: Optional[Any] = None,
            device: DeviceLike = None) -> Tuple[Any, Dict]:
    """(tree, extra) of a checkpoint, its leaves tensors on ``device``
    (the card unless ``device="cpu"``).  With ``like`` (a tree of
    tensors, arrays or anything with a ``shape``) the result has its
    structure, each leaf checked against its shape, and a leaf whose
    ``like`` is a DTensor placed as that one (on its mesh and device);
    otherwise it is a nested dict keyed by the stored paths."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.memmap(os.path.join(path, "data.bin"), dtype=np.uint8,
                     mode="r")
    by_path: Dict[str, torch.Tensor] = {}
    for entry in manifest["leaves"]:
        raw = data[entry["offset"]:entry["offset"] + entry["nbytes"]]
        by_path[entry["path"]] = _tensor(np.asarray(raw), entry, dev)
    del data
    if like is None:
        nested: Dict[str, Any] = {}
        for key, t in by_path.items():
            node = nested
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
        return nested, manifest["extra"]

    def pick(key: str, leaf: Any) -> torch.Tensor:
        """The stored leaf at ``key``, checked against ``leaf``'s shape."""
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = by_path[key]
        want = tuple(getattr(leaf, "shape", t.shape))
        if tuple(t.shape) != want:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs {want}")
        if _is_dtensor(leaf):
            from torch.distributed.tensor import distribute_tensor
            return distribute_tensor(t.to(leaf.device), leaf.device_mesh,
                                     leaf.placements)
        return t

    return map_with_paths(pick, like), manifest["extra"]


class Checkpointer:
    """Step-indexed checkpoint manager with async writes and retention
    of the newest ``keep`` steps."""

    def __init__(self, directory: str, keep: int = 3):
        """Manage ``directory`` (created if missing)."""
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._shared = False      # the pending save was a meshed one

    def _step_dir(self, step: int) -> str:
        """The directory of ``step``."""
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        """Committed steps, ascending (``*.tmp`` writes excluded)."""
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """The newest committed step, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Save ``tree`` as ``step``: the host copy is taken here, in the
        caller's thread; with ``blocking=False`` the write runs in a
        background thread (joined by the next save or :meth:`wait`).  A
        meshed tree is gathered on every rank and written by rank 0;
        every rank calls this and :meth:`wait` alike."""
        self.wait()
        self._shared = _meshed(tree)
        flat = _snapshot(tree)
        if self._shared and not _writer():
            if blocking:
                self.wait()
            return

        def _do():
            """Write, then drop steps beyond ``keep``."""
            _write(self._step_dir(step), flat, extra)
            self._gc()

        if blocking:
            _do()
            self.wait()
        else:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()

    def restore_latest(self, like: Optional[Any] = None,
                       device: DeviceLike = None
                       ) -> Optional[Tuple[int, Any, Dict]]:
        """(step, tree, extra) of the newest step on ``device``, or
        None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = restore(self._step_dir(step), like, device)
        return step, tree, extra

    def wait(self) -> None:
        """Join the pending async write, if any; after a meshed save,
        every rank waits here until rank 0 has written it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._shared:
            self._shared = False
            _barrier()

    def _gc(self) -> None:
        """Remove all but the newest ``keep`` steps."""
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


__all__ = ["Checkpointer", "save", "restore"]
