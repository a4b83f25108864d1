"""Another checkout's ``repro_torch`` imported beside this tree's, so that
a timeline times the other commit's kernels and this tree's in one
process (``decode_timeline`` and ``matmul_timeline``, ``--parent DIR``).

The other package is imported from DIR/src with this tree's modules set
aside, which are then set back.  Its modules keep their own globals, so
its wrappers launch its own library (built from its sources into its own
``build/kernels/``) under its own rules, and its tuner ranks with its
own cost model.  Its wrappers and tuner import what they use at module
level; a function of it that imported a module of the package at call
time would get this tree's.
"""
import importlib
import sys
import threading
import types
from pathlib import Path

# the parent's modules a timeline uses, by the name it reads them under
MODULES = {"kernels": "repro_torch.kernels",
           "build": "repro_torch.kernels._build",
           "geo": "repro_torch.kernels._geometry",
           "tuner": "repro_torch.core.tuner"}


def _package_modules():
    return [k for k in sys.modules
            if k == "repro_torch" or k.startswith("repro_torch.")]


def load_parent(root) -> types.SimpleNamespace:
    """DIR's modules of ``MODULES`` (``.kernels``, ``.build``, ``.geo``,
    ``.tuner``) and its wrappers (``.wrappers``, ``kernels.WRAPPERS``),
    imported beside this tree's."""
    src = str(Path(root).resolve() / "src")
    mine = {k: sys.modules.pop(k) for k in _package_modules()}
    sys.path.insert(0, src)
    importlib.invalidate_caches()
    try:
        got = {name: importlib.import_module(mod)
               for name, mod in MODULES.items()}
    finally:
        sys.path.remove(src)
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(mine)
    return types.SimpleNamespace(root=Path(root).resolve(),
                                 wrappers=got["kernels"].WRAPPERS, **got)


def build_all(loads):
    """Call every library's ``load`` (this tree's ``_build.load``, a
    parent's ``.build.load``) in a thread of its own, so their sources
    compile at once; raises the first failure."""
    errors = []

    def run(fn):
        try:
            fn()
        except BaseException as e:          # raised below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in loads]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


__all__ = ["MODULES", "load_parent", "build_all"]
