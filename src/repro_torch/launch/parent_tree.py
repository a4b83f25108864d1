"""Another checkout's ``repro_torch`` imported beside this tree's, so that
a timeline times the other commit's kernels and this tree's in one
process (``decode_timeline``, ``matmul_timeline`` and ``conv_timeline``,
``--parent DIR``).

The other package is imported from DIR/src with this tree's modules set
aside, which are then set back.  Its modules keep their own globals, so
its wrappers launch its own library (built from its sources into its own
``build/kernels/``) under its own rules, and its tuner ranks with its
own cost model.  Each of its modules is executed with an ``__import__``
of its own, so that an import of the package a function of it makes at
call time also resolves to the other checkout's module (importing it
then, beside this tree's, where it was not loaded yet).
"""
import builtins
import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import sys
import threading
import types
from pathlib import Path

PACKAGE = "repro_torch"

# the parent's modules a timeline uses, by the name it reads them under
MODULES = {"kernels": "repro_torch.kernels",
           "build": "repro_torch.kernels._build",
           "geo": "repro_torch.kernels._geometry",
           "tuner": "repro_torch.core.tuner",
           "sparse": "repro_torch.kernels.sparse_conv",
           "sparsity": "repro_torch.core.sparsity"}


def _package_modules():
    return [k for k in sys.modules
            if k == PACKAGE or k.startswith(PACKAGE + ".")]


class _Tree(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """One checkout's package: its modules, which it imports from its
    own ``src`` with this tree's set aside, each executed under builtins
    whose ``__import__`` resolves the package's names to this checkout's
    modules."""

    def __init__(self, src: str):
        self.src = src
        self.modules = {}
        self.builtins = dict(vars(builtins), __import__=self._import)
        self._lock = threading.RLock()
        self._loading = False

    # -- the finder and loader, active only inside ``load``
    def find_spec(self, name, path=None, target=None):
        if name != PACKAGE and not name.startswith(PACKAGE + "."):
            return None
        spec = importlib.machinery.PathFinder.find_spec(
            name, path if path is not None else [self.src])
        if spec is not None:
            spec.loader_state = spec.loader
            spec.loader = self
        return spec

    def create_module(self, spec):
        return spec.loader_state.create_module(spec)

    def exec_module(self, module):
        module.__builtins__ = self.builtins
        module.__spec__.loader_state.exec_module(module)

    def load(self, name: str) -> types.ModuleType:
        """The module ``name`` of this checkout, imported where needed."""
        with self._lock:
            if name in self.modules:
                return self.modules[name]
            if self._loading:        # a module of it importing another
                return importlib.import_module(name)
            mine = {k: sys.modules.pop(k) for k in _package_modules()}
            sys.modules.update(self.modules)
            sys.meta_path.insert(0, self)
            importlib.invalidate_caches()
            self._loading = True
            try:
                importlib.import_module(name)
            finally:
                self._loading = False
                sys.meta_path.remove(self)
                for k in _package_modules():
                    self.modules[k] = sys.modules.pop(k)
                sys.modules.update(mine)
            return self.modules[name]

    def _import(self, name, globals=None, locals=None, fromlist=(),
                level=0):
        """``__import__`` for this checkout's modules."""
        if level:
            name = importlib.util.resolve_name(
                "." * level + name, (globals or {}).get("__package__"))
        if name != PACKAGE and not name.startswith(PACKAGE + "."):
            return builtins.__import__(name, globals, locals, fromlist, 0)
        mod = self.load(name)
        if not fromlist:
            return self.load(name.partition(".")[0])
        for attr in fromlist:
            if attr != "*" and not hasattr(mod, attr):
                try:
                    self.load(f"{name}.{attr}")
                except ModuleNotFoundError:
                    pass         # a missing name raises where it is read
        return mod


def load_parent(root) -> types.SimpleNamespace:
    """DIR's modules of ``MODULES`` (``.kernels``, ``.build``, ``.geo``,
    ``.tuner``, ``.sparse``, ``.sparsity``) and its wrappers
    (``.wrappers``, ``kernels.WRAPPERS``), imported beside this tree's."""
    tree = _Tree(str(Path(root).resolve() / "src"))
    got = {name: tree.load(mod) for name, mod in MODULES.items()}
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
