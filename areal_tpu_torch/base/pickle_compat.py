"""Pickles that cross between the port and the reference.

The reference's recovery artifacts (``engine_state.pkl``,
``recover_info.pkl``) are pickles that name its own classes (optax's
optimizer states, ``areal_tpu.base.recover.RecoverInfo``). The port has
neither package, so it reads and writes them through stand-in classes
of its own:

- ``load`` unpickles with a restricted ``find_class``: the stand-ins
  under the names the caller maps, numpy's array reconstructors and a
  few plain builtins. Every other global is refused by name, so a
  checkpoint cannot run code on load. A ``bfloat16`` leaf (numpy needs
  ``ml_dtypes`` for it, which the port does not use) is refused with an
  error that says so.
- ``dump`` pickles with a ``pickle._Pickler`` whose ``save_global``
  writes each stand-in under its counterpart's module and name, so the
  reference's plain ``pickle.load`` builds its own classes from what
  the port wrote. (The C pickler checks that a global imports to the
  object it pickles, which a stand-in does not.)
"""

from __future__ import annotations

import builtins
import importlib
import pickle
from typing import Any, Dict, IO, Tuple

# numpy's own reconstructors: numpy 2 names its internals numpy._core,
# numpy 1 numpy.core (each resolves the other's names).
_NUMPY_GLOBALS = {
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "scalar"),
}
_BUILTINS = {"set", "frozenset", "bytearray", "complex", "slice"}


def _numpy_global(module: str, name: str):
    for m in (module, module.replace("numpy._core", "numpy.core"),
              module.replace("numpy.core", "numpy._core")):
        try:
            return getattr(importlib.import_module(m), name)
        except (ImportError, AttributeError):
            continue
    raise pickle.UnpicklingError(f"numpy has no {module}.{name}")


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file: IO[bytes], classes: Dict[Tuple[str, str], type]):
        super().__init__(file)
        self._classes = classes

    def find_class(self, module: str, name: str):
        if (module, name) in self._classes:
            return self._classes[(module, name)]
        if (module, name) in _NUMPY_GLOBALS:
            return _numpy_global(module, name)
        if module == "builtins" and name in _BUILTINS:
            return getattr(builtins, name)
        if module.split(".")[0] == "ml_dtypes":
            raise pickle.UnpicklingError(
                f"the pickle holds a {module}.{name} array: numpy reads bfloat16 "
                f"only through ml_dtypes, which the port does not use; write the "
                f"checkpoint with float32 params")
        raise pickle.UnpicklingError(f"refusing to unpickle the global {module}.{name}")


def load(file: IO[bytes], classes: Dict[Tuple[str, str], type]) -> Any:
    """Unpickle ``file``, mapping each ``(module, name)`` of ``classes`` to
    its stand-in; any other class or function is refused."""
    return _RestrictedUnpickler(file, classes).load()


class _CompatPickler(pickle._Pickler):
    def __init__(self, file: IO[bytes], names: Dict[type, Tuple[str, str]], protocol: int):
        super().__init__(file, protocol)
        self._names = names

    def save_global(self, obj, name=None):
        if obj in self._names:
            module, qualname = self._names[obj]
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def dump(obj: Any, file: IO[bytes], names: Dict[type, Tuple[str, str]],
         protocol: int = pickle.DEFAULT_PROTOCOL) -> None:
    """Pickle ``obj`` with each class of ``names`` written under its
    ``(module, name)``. Needs protocol 4 or later (``STACK_GLOBAL``)."""
    if protocol < 4:
        raise ValueError("protocol 4 or later")
    _CompatPickler(file, names, protocol).dump(obj)
