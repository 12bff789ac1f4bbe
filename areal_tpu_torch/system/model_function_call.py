"""Master-side per-MFC coroutine (the port's copy of
``areal_tpu/system/model_function_call.py``): acquire a batch from the
buffer once its input keys are ready, split it across the model's DP
workers (token-balanced FFD, or by sequence count for generation),
derive a data-transfer plan, ship requests with hooks, gather replies,
and amend the buffer with output metadata.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType, OffloadHook, ParamReallocHook, SaveHook, EvaluateHook
from areal_tpu_torch.base import datapack, logging, stats_tracker, tracing
from areal_tpu_torch.system import request_reply_stream as rrs
from areal_tpu_torch.system.buffer import AsyncIOSequenceBuffer
from areal_tpu_torch.system.redistributor import GlobalStorageTracker, RedistribPlanner

logger = logging.getLogger("mfc")


@dataclasses.dataclass
class RPCCorountineControl:
    """Shared step state of the MFC coroutines."""

    step_info: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"epoch": 0, "epoch_step": 0, "global_step": 0}
    )
    train_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Per-MFC stats for ALL interface types this step (perf telemetry:
    # timeperf/tflops per MFC).
    mfc_stats: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    used_ids: set = dataclasses.field(default_factory=set)


async def async_poll(stream, request_id: str, timeout: Optional[float] = None):
    """Await one reply on a synchronous request client without blocking the
    event loop."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        try:
            return stream.poll(request_id, block=False)
        except rrs.NoMessage:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"no reply for {request_id}")
            await asyncio.sleep(0.002)


def _hook_dict(h) -> Dict:
    if isinstance(h, SaveHook):
        return {"type": "save"}
    if isinstance(h, EvaluateHook):
        return {"type": "evaluate"}
    if isinstance(h, OffloadHook):
        return {"type": "offload"}
    if isinstance(h, ParamReallocHook):
        return {
            "type": "param_realloc",
            "source": str(h.source) if h.source else None,
            "target": str(h.target) if h.target else None,
            "eta": h.eta,
        }
    if isinstance(h, dict):
        return h
    raise ValueError(f"unknown hook {h!r}")


class ModelFunctionCall:
    def __init__(
        self,
        rpc: MFCDef,
        stream,  # NameResolvingRequestClient
        buffer: AsyncIOSequenceBuffer,
        tracker: GlobalStorageTracker,
        planner: RedistribPlanner,
        workers: List[str],  # DP-ordered model worker names for rpc's model
        ctrl: RPCCorountineControl,
    ):
        self.rpc = rpc
        self.stream = stream
        self.buffer = buffer
        self.tracker = tracker
        self.planner = planner
        self.workers = workers
        self.ctrl = ctrl

    # ------------------------------------------------------------------

    def data_parallel_dispatch(self, ids: List[str], batch: SequenceSample):
        """Partition sample ids across DP workers.

        Generation balances by sequence count (decode steps dominate);
        everything else balances by token count.
        """
        n_dp = len(self.workers)
        if self.rpc.balanced_dp or self.rpc.interface_type == ModelInterfaceType.GENERATE:
            lens = [1] * len(ids)
        else:
            lens = [batch.sample_total_len(i) for i in range(batch.bs)]
        parts = datapack.balanced_partition(lens, n_dp)
        return [[ids[i] for i in p] for p in parts]

    async def run_step(self) -> Optional[Dict]:
        rpc = self.rpc
        ids, batch = await self.buffer.get_batch_for_rpc(rpc)
        self.ctrl.used_ids |= set(ids)

        # Master-side MFC span under the step's trace. A train MFC also
        # records which rollout traces it consumed, giving the merger the
        # rollout -> train-step flow links (capped: the attr is evidence,
        # not a database).
        consumed_traces: List[str] = []
        if tracing.enabled():
            for c in batch.metadata.get("trace_ctx") or []:
                if isinstance(c, dict) and c.get("trace_id"):
                    consumed_traces.append(str(c["trace_id"]))
            # Group sampling stamps bs copies of one episode ctx: dedup
            # (order-preserving) before the cap or duplicates eat it.
            consumed_traces = list(dict.fromkeys(consumed_traces))
        mfc_span = tracing.start_span(
            f"master.mfc.{rpc.name}",
            itype=rpc.interface_type.value,
            n_seqs=len(ids),
            **(
                {"consumed_traces": consumed_traces[:256]}
                if consumed_traces
                else {}
            ),
        )
        if mfc_span is not None:
            tracing.set_current(mfc_span.ctx)

        t0 = time.monotonic()
        # The try covers dispatch building and posting too: once
        # set_current is active, any posted request parents worker spans
        # under this span id — it must be recorded on EVERY exit path or
        # the validator sees a zero-drop dangling parent.
        try:
            assignments = self.data_parallel_dispatch(ids, batch)
            dests = {
                w: part for w, part in zip(self.workers, assignments) if part
            }
            plan = self.planner.derive_plan(dests, list(rpc.input_keys))

            handlers, datas, pre_hooks, post_hooks = [], [], [], []
            for w, part in dests.items():
                worker_steps = [
                    dataclasses.asdict(s) for s in plan if s.dst == w
                ]
                handlers.append(w)
                datas.append(
                    dict(
                        mfc_name=rpc.name,
                        model_name=str(rpc.model_name),
                        interface_type=rpc.interface_type.value,
                        ids=part,
                        input_keys=list(rpc.input_keys),
                        input_key_remap=dict(rpc.input_key_remap),
                        output_key_remap=dict(rpc.output_key_remap),
                        mb_spec=dataclasses.asdict(rpc.mb_spec),
                        plan=worker_steps,
                        step_info=dict(self.ctrl.step_info),
                    )
                )
                pre_hooks.append([_hook_dict(h) for h in rpc.pre_hooks])
                post_hooks.append([_hook_dict(h) for h in rpc.post_hooks])

            req_ids = self.stream.request(
                handlers,
                "mfc",
                datas,
                pre_hooks=pre_hooks,
                post_hooks=post_hooks,
            )
            t0 = time.monotonic()
            replies = await asyncio.gather(
                *[async_poll(self.stream, rid) for rid in req_ids]
            )
        finally:
            if mfc_span is not None:
                mfc_span.end()
        elapsed = time.monotonic() - t0

        # Collect outputs / stats.
        stats_list: List[Dict] = []
        out_metas: List[SequenceSample] = []
        for p in replies:
            if isinstance(p.data, dict) and p.data.get("error"):
                raise RuntimeError(
                    f"MFC {rpc.name} failed on {p.sender}: {p.data['error']}"
                )
            if p.data.get("output_meta") is not None:
                out_metas.append(p.data["output_meta"])
            if p.data.get("stats"):
                stats_list.append(p.data["stats"])
        stats = merge_worker_stats(stats_list)
        if rpc.interface_type == ModelInterfaceType.TRAIN_STEP:
            # Rollout-pipeline telemetry riding the consumed samples'
            # metadata (stamped by the rollout worker; absent on sync
            # runs): end-to-end episode latency percentiles and the
            # interruption re-prefill cost of this batch. Works with
            # tracing OFF — metadata is always stamped.
            e2e = [
                float(v)
                for v in batch.metadata.get("rollout_e2e_s") or []
                if isinstance(v, (int, float))
            ]
            if e2e:
                stats["perf/rollout_e2e_p50_ms"] = float(
                    np.percentile(e2e, 50) * 1e3
                )
                stats["perf/rollout_e2e_p95_ms"] = float(
                    np.percentile(e2e, 95) * 1e3
                )
            reprefill = [
                float(v)
                for v in batch.metadata.get("reprefill_tokens") or []
                if isinstance(v, (int, float))
            ]
            if reprefill:
                stats["perf/reprefill_tokens"] = float(np.sum(reprefill))
            turns = [
                int(v)
                for v in batch.metadata.get("turns") or []
                if isinstance(v, (int, float))
            ]
            if turns:
                stats["perf/episode_turns"] = float(np.mean(turns))
            tool_calls = [
                int(v)
                for v in batch.metadata.get("tool_calls") or []
                if isinstance(v, (int, float))
            ]
            if tool_calls:
                stats["perf/episode_tool_calls"] = float(np.mean(tool_calls))
            # Per-task staleness consumed this step: the train-step lag of
            # each sample's version_end, split by its task tag, so the
            # math and agentic windows are both observable.
            tasks = batch.metadata.get("task") or []
            v_ends = batch.metadata.get("version_end") or []
            step = int(self.buffer.current_train_step)
            for tag, key in (
                ("math", "perf/task_staleness_math"),
                ("agentic", "perf/task_staleness_agentic"),
            ):
                lags = [
                    step - int(v)
                    for t, v in zip(tasks, v_ends)
                    if t == tag and isinstance(v, (int, float))
                ]
                if lags:
                    stats[key] = float(np.mean(lags))
            # Admission-side complement: per-task counts of samples the
            # buffer's staleness windows dropped.
            for tag, key in (
                ("math", "perf/task_stale_dropped_math"),
                ("agentic", "perf/task_stale_dropped_agentic"),
            ):
                dropped = self.buffer.stale_dropped_by_task.get(tag, 0)
                if dropped:
                    stats[key] = float(dropped)
        # DP workers run concurrently: wall time is the max, flops add,
        # so MFC TFLOP/s is aggregate-over-workers per wall second.
        if stats.get("perf/flops") and stats.get("perf/sec"):
            stats["perf/tflops"] = stats["perf/flops"] / elapsed / 1e12
        if stats.get("perf/gen_tokens"):
            stats["perf/gen_tokens_per_sec"] = (
                stats["perf/gen_tokens"] / elapsed
            )
        stats["perf/elapsed"] = elapsed

        if out_metas:
            merged = SequenceSample.gather(out_metas)
            # Track new data locations.
            for p in replies:
                om = p.data.get("output_meta")
                if om is not None:
                    self.tracker.add_batch(list(om.ids), list(om.keys), p.sender)
            if not rpc.is_dst:
                await self.buffer.amend_batch(merged)

        logger.debug(
            f"MFC {rpc.name}: {len(ids)} seqs on {len(dests)} workers "
            f"in {elapsed:.3f}s"
        )
        self.ctrl.mfc_stats[rpc.name] = stats
        if rpc.interface_type == ModelInterfaceType.TRAIN_STEP:
            self.ctrl.train_stats[rpc.name] = stats
        return stats


# Reduce-type resolution for merging per-DP-worker stats: explicit types
# shipped by the worker (stats_tracker declared ReduceTypes) win; the
# suffix heuristic covers plain dicts.
_ADDITIVE_SUFFIXES = ("n_tokens", "n_mbs", "n_seqs", "count")
_ADDITIVE_KEYS = ("perf/flops", "perf/gen_tokens")
_MAX_KEYS = ("perf/sec",)


def merge_worker_stats(stats_list: List[Dict]) -> Dict[str, Any]:
    """Merge stats dicts from concurrent DP workers into one.

    The master is the reduction point, so no collective is needed. Workers may embed
    `__reduce_types__` (from stats_tracker.export(..., return_types=True))
    to pin per-key semantics.
    """
    stats: Dict[str, Any] = {}
    if not stats_list:
        return stats
    types: Dict[str, str] = {}
    for s in stats_list:
        types.update(s.get("__reduce_types__") or {})
    keys = [k for k in stats_list[0] if k != "__reduce_types__"]
    for k in keys:
        vals = [s[k] for s in stats_list if k in s and s[k] is not None]
        if not vals or not isinstance(vals[0], (int, float)):
            continue
        rt = types.get(k)
        if rt is None:
            if k in _MAX_KEYS:
                rt = "max"
            elif k in _ADDITIVE_KEYS or k.endswith(_ADDITIVE_SUFFIXES):
                rt = "sum"
            else:
                rt = "avg"
        if rt == "sum":
            stats[k] = float(np.sum(vals))
        elif rt == "min":
            stats[k] = float(np.min(vals))
        elif rt == "max":
            stats[k] = float(np.max(vals))
        else:
            stats[k] = float(np.mean(vals))
    return stats
