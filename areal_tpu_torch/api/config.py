"""Abstraction records that name a registered factory and its arguments
(the port's copy of ``ModelAbstraction`` from ``areal_tpu/api/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass
class ModelAbstraction:
    type_: str = "default"
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
