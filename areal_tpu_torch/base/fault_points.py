"""The named chaos-injection points the port fires (the port's copy of
the entries of ``areal_tpu/base/fault_points.py`` that its generation
server and worker fire; names and meanings are the reference's, so one
``AREAL_FAULTS`` spec arms reference and port processes alike).

Names under ``test.`` are reserved for the injector's own tests and are
exempt from declaration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

TEST_PREFIX = "test."


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    name: str
    modules: Tuple[str, ...]  # modules with maybe_fail sites
    doc: str  # the real-world failure this point simulates


_GS = ("areal_tpu_torch/system/generation_server.py",)

_POINTS: List[FaultPoint] = [
    FaultPoint("gserver.generate", _GS,
               "Generation request dies or stalls server-side (engine crash, "
               "wedged decode lap)."),
    FaultPoint("gserver.update_weights", _GS,
               "Weight load from the shared dump dies mid-update."),
    FaultPoint("worker.poll", ("areal_tpu_torch/system/worker_base.py",),
               "A worker's poll loop dies or hangs."),
]

REGISTRY: Dict[str, FaultPoint] = {p.name: p for p in _POINTS}
