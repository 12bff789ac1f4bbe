"""The named chaos-injection points the port fires (the port's copy of
the entries of ``areal_tpu/base/fault_points.py`` that its generation
server, serving engine, worker system, rollout worker, gserver manager,
weight plane and engine checkpoint fire; names and meanings are the reference's, so one ``AREAL_FAULTS``
spec arms reference and port processes alike).

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
    FaultPoint("gserver.kv_export", _GS,
               "Prefill side dies mid KV handoff export."),
    FaultPoint("gserver.kv_restore", _GS,
               "Tier restore fails mid delta-prefill: the session falls back "
               "to a full re-prefill, spill-not-loss."),
    FaultPoint("gserver.kv_import", _GS,
               "Decode side dies mid KV handoff import."),
    FaultPoint("gserver.drain", _GS,
               "Drain-then-leave dies at the start of the drain."),
    FaultPoint("gserver.kv_accept", _GS,
               "Migration target fails while accepting a parked prefix from a "
               "draining peer."),
    FaultPoint("gserver.kv_chunk_bytes", _GS,
               "KV chunk/blob payload corrupted after its chunk index was "
               "minted: the puller's per-chunk sha256 verify must reject and "
               "re-fetch."),
    FaultPoint("gserver.distribute_weights", _GS,
               "Plane fanout transfer dies on this server (mid-fetch peer "
               "kill in the weight-plane e2e)."),
    FaultPoint("gserver.weight_fetch", _GS,
               "One chunk fetch inside the plane transfer fails (transient "
               "peer error; the stream must retry/re-source)."),
    FaultPoint("gserver.cutover_weights", _GS,
               "Cutover window dies between interrupt and swap."),
    FaultPoint("weight_plane.serve_chunk",
               ("areal_tpu_torch/system/weight_plane.py",) + _GS,
               "A serving peer/origin fails mid-chunk."),
    FaultPoint("weight_plane.chunk_bytes", ("areal_tpu_torch/system/weight_plane.py",),
               "Weight chunk payload corrupted on the wire AFTER its hash was "
               "stamped: the puller's sha256 verify must reject and re-fetch; "
               "corrupt weights never cut over."),
    FaultPoint("engine.kv_spill", ("areal_tpu_torch/engine/serving.py",),
               "KV tier spill write fails: the eviction falls back to a clean "
               "free, counted as kv_prefix_lost, never a wedge."),
    FaultPoint("worker.poll", ("areal_tpu_torch/system/worker_base.py",),
               "A worker's poll loop dies or hangs."),
    FaultPoint("master.step", ("areal_tpu_torch/system/master_worker.py",),
               "The master dies at the top of a train step."),
    FaultPoint("buffer.wal_append", ("areal_tpu_torch/system/wal.py",),
               "The trainer dies while journaling an accepted trajectory."),
    FaultPoint("rollout.episode", ("areal_tpu_torch/system/rollout_worker.py",),
               "One rollout episode dies mid-flight (agent/env crash)."),
    FaultPoint("manager.plane_fanout", ("areal_tpu_torch/system/gserver_manager.py",),
               "The manager dies inside the weight-plane fanout push."),
    FaultPoint("manager.fanout", ("areal_tpu_torch/system/gserver_manager.py",),
               "The manager dies inside the update-weights fanout wave."),
    FaultPoint("buffer.consume", ("areal_tpu_torch/system/buffer.py",),
               "The trainer dies after a batch is handed to training, before "
               "its consumption is durable."),
    FaultPoint("train.checkpoint", ("areal_tpu_torch/engine/checkpoint.py",),
               "The trainer dies at the engine-checkpoint commit point, after "
               "artifacts landed but around the manifest rename: recovery "
               "must resume from the previous complete checkpoint, never a "
               "torn one."),
]

REGISTRY: Dict[str, FaultPoint] = {p.name: p for p in _POINTS}
