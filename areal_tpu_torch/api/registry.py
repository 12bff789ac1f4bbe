"""Name -> factory registries (the port's copy of ``Registry`` from
``areal_tpu/api/config.py``). Models, backends, interfaces, datasets,
agents, environments and experiments each keep one, under the
reference's registered names."""

from __future__ import annotations

from typing import Any, Dict


class Registry:
    """Simple name -> factory registry with helpful errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Any] = {}

    def register(self, name: str, factory):
        if name in self._factories:
            raise ValueError(f"{self.kind} {name!r} already registered")
        self._factories[name] = factory

    def make(self, abstraction_or_name, *args, **kwargs):
        """Build from a registered name, or from an abstraction (its
        ``type_`` and ``args``; keyword arguments override ``args``)."""
        if isinstance(abstraction_or_name, str):
            name, extra = abstraction_or_name, {}
        else:
            name, extra = abstraction_or_name.type_, abstraction_or_name.args
        if name not in self._factories:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {sorted(self._factories)}"
            )
        return self._factories[name](*args, **{**extra, **kwargs})
