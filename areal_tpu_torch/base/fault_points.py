"""The named chaos-injection points the port fires (the port's copy of
the entries of ``areal_tpu/base/fault_points.py`` that its generation
server, worker system, rollout worker and gserver manager fire; names
and meanings are the reference's, so one ``AREAL_FAULTS`` spec arms
reference and port processes alike).

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
    FaultPoint("master.step", ("areal_tpu_torch/system/master_worker.py",),
               "The master dies at the top of a train step."),
    FaultPoint("buffer.wal_append", ("areal_tpu_torch/system/wal.py",),
               "The trainer dies while journaling an accepted trajectory."),
    FaultPoint("rollout.episode", ("areal_tpu_torch/system/rollout_worker.py",),
               "One rollout episode dies mid-flight (agent/env crash)."),
    FaultPoint("manager.fanout", ("areal_tpu_torch/system/gserver_manager.py",),
               "The manager dies inside the update-weights fanout wave."),
    FaultPoint("buffer.consume", ("areal_tpu_torch/system/buffer.py",),
               "The trainer dies after a batch is handed to training, before "
               "its consumption is durable."),
]

REGISTRY: Dict[str, FaultPoint] = {p.name: p for p in _POINTS}
