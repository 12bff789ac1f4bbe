"""Runs one DFG traversal per training step: data loading + all MFC
coroutines concurrently (the port's copy of
``areal_tpu/system/function_executor.py``). Data loading fetches
metadata from the dataset-hosting model workers into the buffer; each
MFC coroutine fires as soon as its input keys are ready (ordering falls
out of the buffer); after the traversal the per-step sample cache is
cleared on every worker.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Dict, List, Optional

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.dfg import DFGraph
from areal_tpu_torch.base import logging, name_resolve, names
from areal_tpu_torch.system.buffer import AsyncIOSequenceBuffer
from areal_tpu_torch.system.model_function_call import (
    ModelFunctionCall,
    RPCCorountineControl,
    async_poll,
)
from areal_tpu_torch.system.redistributor import GlobalStorageTracker, RedistribPlanner

logger = logging.getLogger("function_executor")


class FunctionExecutor:
    def __init__(
        self,
        graph: DFGraph,
        stream,
        buffer: AsyncIOSequenceBuffer,
        model_topos: Dict[str, List[str]],  # model_name str -> worker names
        data_hosts: List[str],
        ctrl: Optional[RPCCorountineControl] = None,
        experiment_name: str = "",
        trial_name: str = "",
    ):
        self.graph = graph
        self.stream = stream
        self.buffer = buffer
        self.data_hosts = data_hosts
        self.ctrl = ctrl or RPCCorountineControl()
        self.tracker = GlobalStorageTracker()
        self.planner = RedistribPlanner(self.tracker)
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self._data_epoch_done = False
        self._samples_loaded = 0

        # One persistent loop for all steps: asyncio primitives in the
        # buffer bind to the loop they first wait on, so a fresh loop per
        # step (asyncio.run) would break on step 2.
        self._loop = asyncio.new_event_loop()

        self.mfcs: List[ModelFunctionCall] = []
        for name, rpc in graph.rpcs.items():
            workers = model_topos[str(rpc.model_name)]
            self.mfcs.append(
                ModelFunctionCall(
                    rpc=rpc,
                    stream=self.stream,
                    buffer=buffer,
                    tracker=self.tracker,
                    planner=self.planner,
                    workers=workers,
                    ctrl=self.ctrl,
                )
            )

    # ------------------------------------------------------------------

    @property
    def src_rpcs(self):
        return [m.rpc for m in self.mfcs if m.rpc.is_src]

    async def load_data(self):
        """Fetch dataset batches (metadata) until every src MFC can draw a
        full batch this step."""
        need = max(r.n_seqs for r in self.src_rpcs)
        while True:
            counts = [
                await self.buffer.poll_ready_count(r) for r in self.src_rpcs
            ]
            if all(c >= r.n_seqs for c, r in zip(counts, self.src_rpcs)):
                return
            req_ids = self.stream.request(self.data_hosts, "fetch")
            replies = await asyncio.gather(
                *[async_poll(self.stream, rid) for rid in req_ids]
            )
            epoch_done = False
            total_new = 0
            for p in replies:
                meta: Optional[SequenceSample] = p.data.get("meta")
                epoch_done = epoch_done or p.data.get("epoch_done", False)
                if meta is None or meta.bs == 0:
                    continue
                self.tracker.add_batch(list(meta.ids), list(meta.keys), p.sender)
                total_new += await self.buffer.put_batch([meta])
            self._samples_loaded += total_new
            if epoch_done:
                self._data_epoch_done = True
            if total_new == 0 and not any(
                p.data.get("meta") is not None for p in replies
            ):
                # Dataset exhausted and nothing new: avoid a hot loop.
                await asyncio.sleep(0.01)
            # Publish the global sample counter for the staleness gate.
            # Off-loop: the write is file I/O (NFS-backed in production)
            # and this loop also drives every MFC request round trip.
            if self.experiment_name:
                await asyncio.get_running_loop().run_in_executor(
                    None,
                    functools.partial(
                        name_resolve.add,
                        names.training_samples(
                            self.experiment_name, self.trial_name
                        ),
                        str(self._samples_loaded),
                        replace=True,
                        keepalive_ttl=None,
                    ),
                )

    async def clear_gpu_cache(self):
        """Drop this step's consumed samples everywhere."""
        used = set(self.ctrl.used_ids)
        # Epoch carryover: a consumed id may have been RE-admitted to the
        # buffer mid-step (tiny datasets re-issue row ids every epoch).
        # Clearing such an id now would wipe the tracker ownership and
        # worker-side data its resident copy needs next step ("no owner"
        # at derive_plan). Defer it — its next consumption re-adds it to
        # used_ids and the clear happens then.
        resident = self.buffer.resident_ids(used)
        ids = sorted(used - resident)
        self.ctrl.used_ids.clear()
        if resident:
            logger.warning(
                "deferring cache clear of %d id(s) re-admitted to the "
                "buffer (epoch carryover), e.g. %r",
                len(resident), next(iter(resident)),
            )
        if not ids:
            return
        all_workers = sorted(
            {w for m in self.mfcs for w in m.workers} | set(self.data_hosts)
        )
        req_ids = self.stream.request(
            all_workers, "clear_data_cache", [ids for _ in all_workers]
        )
        await asyncio.gather(*[async_poll(self.stream, rid) for rid in req_ids])
        self.tracker.drop_samples(ids)

    async def execute_step(self) -> Dict:
        """One DFG traversal; returns train stats keyed by MFC name."""
        self.ctrl.train_stats.clear()
        tasks = [asyncio.create_task(self.load_data())]
        tasks += [asyncio.create_task(m.run_step()) for m in self.mfcs]
        try:
            await asyncio.gather(*tasks)
        except Exception:
            for t in tasks:
                t.cancel()
            raise
        await self.clear_gpu_cache()
        return dict(self.ctrl.train_stats)

    def execute_step_sync(self) -> Dict:
        return self._loop.run_until_complete(self.execute_step())

    @property
    def epoch_done(self) -> bool:
        """True once the underlying dataset signalled an epoch boundary."""
        v = self._data_epoch_done
        self._data_epoch_done = False
        return v
