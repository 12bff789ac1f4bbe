"""Rollout worker: prompts -> agent episodes -> trajectory push (the
port's copy of ``areal_tpu/system/rollout_worker.py``).

An async loop loads the next prompt, asks the gserver manager for quota
(``/allocate_rollout``: capacity and staleness gated), runs the agent's
episode coroutine with the ``PartialRolloutManager`` servicing its obs
queue, reports ``/finish_rollout`` (the quota slot is released on every
exit path) and pushes accepted trajectories to the trainer over the ZMQ
push stream as JSON, each with a sequence id the trainer acks once its
WAL holds it when ``AREAL_WAL`` is on. At each epoch boundary the
episodes' success rates merge into the shared score file and the
dataset's curriculum filter runs. The worker installs a client of the
pooled reward executors (``functioncall/remote.py``): the tool env's
python tool and the math grader's sympy path run there while an executor
is live, in local sandboxes otherwise. The gateway route is not ported.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import Dict, Optional

import aiohttp

from areal_tpu_torch.api import data_api
from areal_tpu_torch.api.agent_api import make_agent
from areal_tpu_torch.api.env_api import make_env
from areal_tpu_torch.api.system_api import RolloutWorkerConfig
from areal_tpu_torch.base import (
    constants, env_registry, logging, name_resolve, names, rpc, seeding, tracing)
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.system import eval_scores
from areal_tpu_torch.system.partial_rollout import PartialRolloutManager
from areal_tpu_torch.system.push_pull_stream import NameResolvingZmqPusher
from areal_tpu_torch.system.worker_base import AsyncWorker, PollResult

logger = logging.getLogger("rollout_worker")


class _TracedEnv:
    """Wraps an EnvironmentService so every step (= reward/functioncall
    verification for the single-step envs) records a `reward.verify`
    span under the episode's trace — without touching each agent."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        return getattr(self._env, name)

    async def step(self, action):
        with tracing.span("reward.verify"):
            return await self._env.step(action)


class RolloutWorker(AsyncWorker):
    # Class-level defaults so harness-built partial workers (tests
    # construct via __new__) get the manager-blip discipline without
    # running _configure.
    _mgr_fails = 0
    _mgr_policy: Optional[rpc.RetryPolicy] = None
    # Ack/seq mode stays off for partial workers too: their hand-built
    # pushers have no ack socket to drain.
    _wal_acks = False

    @property
    def pending_scores(self) -> Dict[str, float]:
        """Per-episode success rates accumulated locally, merged into the
        shared score file at epoch boundaries (one locked write per epoch,
        not per episode). Lazy so harness-built partial workers work."""
        if not hasattr(self, "_pending_scores"):
            self._pending_scores: Dict[str, float] = {}
        return self._pending_scores

    def _configure(self, config: RolloutWorkerConfig):
        self.cfg = config
        constants.set_experiment_trial_names(
            config.experiment_name, config.trial_name
        )
        seeding.set_random_seed(config.seed, config.worker_name)
        import areal_tpu_torch.agents  # noqa: F401  (registers agents/envs)
        import areal_tpu_torch.datasets  # noqa: F401

        tokenizer = (
            data_api.load_hf_tokenizer(config.tokenizer_path)
            if config.tokenizer_path
            else None
        )
        self.tokenizer = tokenizer
        util = data_api.DatasetUtility(
            seed=config.seed,
            dp_rank=config.worker_index,
            world_size=config.n_rollout_workers,
            tokenizer=tokenizer,
        )
        if len(config.datasets) != 1:
            raise NotImplementedError(
                f"rollout worker supports exactly one dataset, got "
                f"{len(config.datasets)}"
            )
        self.dataset = data_api.make_dataset(config.datasets[0], util)
        # Recovery: resume the curriculum where the previous incarnation
        # left it (reference rollout_worker.py:122-134).
        eval_scores.restore_indices(
            self.dataset,
            config.experiment_name,
            config.trial_name,
            tag=f"rollout{config.worker_index}",
        )
        self.dataloader = data_api.PackedDataLoader(
            self.dataset, batch_size=1, shuffle=True, seed=config.seed
        )
        agent_kwargs = {"tokenizer": tokenizer}
        if "gconfig" not in (config.agent.args or {}):
            import dataclasses as _dc

            agent_kwargs["gconfig"] = _dc.asdict(config.gconfig)
        self.agent = make_agent(config.agent, **agent_kwargs)
        self.env = _TracedEnv(make_env(config.env))
        # Pooled reward-executor discovery: install the process-wide
        # client. With no executor registered available() is False and
        # everything degrades to the local fork-per-call sandboxes.
        from areal_tpu_torch.functioncall import remote as fc_remote

        fc_remote.register_executor_pool(
            fc_remote.ExecutorPoolClient(config.experiment_name, config.trial_name))
        self.manager_addr = name_resolve.wait(
            names.gen_server_manager(config.experiment_name, config.trial_name),
            timeout=300,
        )
        prm_resolver = lambda: name_resolve.get(  # noqa: E731
            names.gen_server_manager(config.experiment_name, config.trial_name)
        )
        self.prm = PartialRolloutManager(
            self.manager_addr,
            new_tokens_per_chunk=config.new_tokens_per_chunk,
            request_timeout=config.rollout_request_timeout,
            max_retries=config.rollout_max_retries,
            addr_resolver=prm_resolver,
        )
        # Ack mode rides the WAL switch: with the durable plane armed,
        # every trajectory carries a minted sequence id and stays in the
        # pusher's unacked window until the trainer journals it.
        self._wal_acks = env_registry.get_bool("AREAL_WAL")
        self.pusher = NameResolvingZmqPusher(
            config.experiment_name,
            config.trial_name,
            pusher_index=config.worker_index,
            n_pushers=config.n_rollout_workers,
            n_pullers=config.n_pullers,
            ack=self._wal_acks,
        )
        self._session: Optional[aiohttp.ClientSession] = None
        self._tasks: Dict[str, asyncio.Task] = {}
        self._episode_counter = itertools.count()
        self._seq_counter = itertools.count()
        self._last_redeliver = 0.0
        self._mgr_policy = rpc.rediscovery_policy()
        self._mgr_fails = 0
        logger.info(
            f"{config.worker_name} configured; manager at {self.manager_addr}"
        )

    def _rediscover_manager(self):
        try:
            addr = name_resolve.get(
                names.gen_server_manager(
                    self.cfg.experiment_name, self.cfg.trial_name
                )
            )
        except name_resolve.NameEntryNotFoundError:
            return
        if addr != self.manager_addr:
            logger.warning(
                f"gserver manager moved {self.manager_addr} -> {addr}"
            )
            self.manager_addr = addr
            self.prm.manager_addr = addr

    async def _http(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=60)
            )
        return self._session

    async def _allocate(self) -> bool:
        sess = await self._http()
        async with sess.post(
            f"{self.manager_addr}/allocate_rollout",
            # Slot ownership: the manager reclaims this worker's
            # outstanding slots if its heartbeat dies.
            json=tracing.inject_into({"worker": self.cfg.worker_name}),
        ) as r:
            d = await r.json()
        return bool(d.get("success"))

    async def _finish(self, accepted: bool):
        sess = await self._http()
        async with sess.post(
            f"{self.manager_addr}/finish_rollout",
            json={"accepted": accepted, "worker": self.cfg.worker_name},
        ) as r:
            await r.json()

    async def _release_quota(self, accepted: bool):
        """Release this episode's quota slot, retrying through transient
        manager failures under the declared RPC policy — a leaked slot
        would permanently shrink the rollout quota (and enough of them
        starve it entirely)."""

        async def attempt(_timeout: float):
            await self._finish(accepted)

        try:
            await rpc.retry_async(
                attempt, policy=rpc.default_policy(attempts=3),
                retryable=(Exception,), what="finish_rollout",
            )
        except rpc.RpcError:
            logger.warning(
                "finish_rollout failed; quota slot leaks until "
                "the manager resyncs", exc_info=True,
            )

    async def rollout_task(self, prompt, trace_parent=None):
        """One episode: agent coroutine + generation servicing
        (reference rollout_task:330)."""
        obs_queue: asyncio.Queue = asyncio.Queue()
        act_queue: asyncio.Queue = asyncio.Queue()
        t_start = time.monotonic()
        # Episode span: the rollout's trace root for everything from the
        # first generation chunk to the trainer's buffer.wait (the
        # allocate span that admitted it is its parent). ep is None when
        # tracing is off.
        ep = tracing.start_span(
            "rollout.episode",
            ctx=trace_parent,
            qid=str(prompt.ids[0]) if prompt.ids else "",
            # getattr: harness-built partial workers (agent tests) have
            # no cfg, and span kwargs evaluate even when tracing is off.
            worker=getattr(getattr(self, "cfg", None), "worker_name", ""),
        )
        ep_gen = {"reprefill_tokens": 0, "interruptions": 0}
        # Task-local: this coroutine runs in its own asyncio Task, so the
        # context needs no reset; tasks created below (generation
        # servicing, the agent) inherit it at create_task time.
        if ep is not None:
            tracing.set_current(ep.ctx)

        seen_qids: set = set()

        async def service_gen():
            # Serve generation requests until the agent finishes — an
            # agent may issue any number of them (multi-turn agents issue
            # one per turn; reference rollout_worker.py:330 loops the
            # same way). The task is cancelled once the agent returns.
            # A repeated qid within the episode is a SESSION CONTINUATION
            # (the agent's next turn on the same conversation): it rides
            # the priority-0 affinity path and re-prefills only the turn
            # delta instead of the whole transcript.
            while True:
                qid, prompt_ids, gconfig = await obs_queue.get()
                continuation = str(qid) in seen_qids
                seen_qids.add(str(qid))
                bundle = await self.prm.generate_group(
                    str(qid), prompt_ids, gconfig,
                    continuation=continuation,
                )
                ep_gen["reprefill_tokens"] += sum(bundle.reprefill_tokens)
                ep_gen["interruptions"] += sum(bundle.n_interruptions)
                await act_queue.put(bundle)

        accepted = False
        # An episode that raised (not one cancelled at shutdown): the
        # span's `failed` attribute, a port addition the smoke reads.
        failed = False
        gen_task = None
        try:
            faults.maybe_fail("rollout.episode")
            gen_task = asyncio.create_task(service_gen())
            agent_task = asyncio.create_task(
                self.agent.collect_trajectory(
                    prompt, self.env, obs_queue, act_queue
                )
            )
            # service_gen never completes normally; if it finishes first
            # it raised, and the agent would block on act_queue forever —
            # watch both and cancel the agent on gen failure.
            done, _ = await asyncio.wait(
                {gen_task, agent_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if gen_task in done:
                agent_task.cancel()
                try:
                    await agent_task
                except (asyncio.CancelledError, Exception):
                    pass
                raise gen_task.exception() or RuntimeError(
                    "generation servicing exited unexpectedly"
                )
            trajs = await agent_task
            e2e_s = time.monotonic() - t_start
            # Per-row share across ALL of the episode's trajectories
            # (multi-turn agents return several): the consumer sums over
            # batch rows, so the shares must add back to the episode
            # total exactly once.
            ep_rows = sum(t.bs for t in trajs) or 1
            for t in trajs:
                # Group success rates feed the curriculum filter
                # (degenerate groups the agent drops are never scored —
                # the reference's async path behaves the same way).
                for sid, sc in zip(t.ids, t.metadata.get("scores") or []):
                    self.pending_scores[str(sid)] = float(sc)
                # Episode telemetry rides the trajectory metadata to the
                # trainer: e2e latency + interruption re-prefill cost
                # feed the master's perf scalars, the trace context
                # parents the buffer-residency spans. Lists align with
                # ids (SequenceSample contract).
                t.metadata["rollout_e2e_s"] = [e2e_s] * t.bs
                t.metadata["reprefill_tokens"] = (
                    [ep_gen["reprefill_tokens"] / ep_rows] * t.bs
                )
                if ep is not None:
                    t.metadata["trace_ctx"] = [ep.ctx.to_dict()] * t.bs
                seq = (
                    f"{self.cfg.worker_index}/{next(self._seq_counter)}"
                    if self._wal_acks else None
                )
                self.pusher.push(data_api.sample_to_json(t), seq=seq)
            accepted = bool(trajs)
        except Exception:
            failed = True
            logger.exception("rollout episode failed")
        finally:
            if ep is not None:
                ep.end(
                    accepted=accepted,
                    failed=failed,
                    reprefill_tokens=ep_gen["reprefill_tokens"],
                    interruptions=ep_gen["interruptions"],
                )
            # The quota slot is released on EVERY exit path — normal,
            # crashing agent, or cancellation — so a dying episode can't
            # starve the rollout quota. Shielded so cancellation of this
            # task doesn't also cancel the release mid-flight.
            if gen_task is not None and not gen_task.done():
                gen_task.cancel()
            try:
                await asyncio.shield(self._release_quota(accepted))
            except asyncio.CancelledError:
                pass

    async def _poll_async(self) -> Optional[PollResult]:
        # Experiment status gate (reference rollout_worker.py:216-228).
        # Regression note (areal-lint blocking-async): the name_resolve
        # read is file I/O (NFS-backed in production) and this poll runs
        # on the SAME event loop as every live episode's generate/reward
        # round-trips — an inline read stalled all of them for the
        # duration of one slow stat. Executor keeps the loop serving.
        loop = asyncio.get_running_loop()
        try:
            status = await loop.run_in_executor(
                None,
                lambda: name_resolve.get(
                    names.experiment_status(
                        self.cfg.experiment_name, self.cfg.trial_name
                    )
                ),
            )
            if status in ("COMPLETE", "ABORT"):
                for t in self._tasks.values():
                    t.cancel()
                await asyncio.gather(*self._tasks.values(), return_exceptions=True)
                await self.prm.close()
                if self._session is not None:
                    await self._session.close()
                return None
        except name_resolve.NameEntryNotFoundError:
            pass

        # Reap finished episode tasks, retrieving their exceptions so a
        # crashed episode can't emit "Task exception was never retrieved"
        # at GC time (rollout_task handles its own errors; anything that
        # still escapes is a harness bug worth logging, not crashing on).
        live = {}
        for k, t in self._tasks.items():
            if not t.done():
                live[k] = t
            elif not t.cancelled() and t.exception() is not None:
                logger.error(f"episode task {k} died", exc_info=t.exception())
        self._tasks = live

        if self._wal_acks:
            self.pusher.drain_acks()
            if self.pusher.unacked():
                # Samples past the ack timeout mean the trainer died (or
                # is wedged) before journaling them. A restarted puller
                # re-registers under the same stream name on a NEW port,
                # so re-resolve (file I/O — executor, same rule as the
                # status gate above) and re-target before re-sending.
                # Sockets stay loop-thread-only: reconnect/redeliver run
                # inline here, never on the executor.
                now = time.monotonic()
                if now - self._last_redeliver >= 1.0:
                    self._last_redeliver = now
                    try:
                        addr = await loop.run_in_executor(
                            None,
                            lambda: name_resolve.get(self.pusher.stream_key),
                        )
                    except name_resolve.NameEntryNotFoundError:
                        addr = None
                    if addr:
                        host, port = addr.rsplit(":", 1)
                        self.pusher.reconnect(host, int(port))
                        n = self.pusher.redeliver()
                        if n:
                            logger.warning(
                                "redelivered %d unacked trajectory(ies)", n
                            )

        if len(self._tasks) >= self.cfg.max_concurrent_rollouts:
            await asyncio.sleep(0.02)
            return PollResult(batch_count=0)

        # The allocate span roots the episode's trace: the admission
        # request (and the manager's child span) is the first thing that
        # happens to a rollout, so queue-wait shows up on its timeline.
        alloc_ctx = None
        try:
            with tracing.span(
                "rollout.allocate", worker=self.cfg.worker_name
            ) as alloc_ctx:
                ok = await self._allocate()
        except Exception:
            logger.warning("allocate_rollout failed; retrying", exc_info=True)
            # A restarted gserver manager re-registers at a NEW address;
            # re-resolve so this worker follows it instead of hammering
            # the dead endpoint forever. Off-loop: the lookup is file
            # I/O (areal-lint blocking-async, see poll-gate note above).
            # Backoff comes from the SAME declared rediscovery policy
            # partial_rollout uses (base/rpc.py), so a manager blip has
            # one fleet-wide budget, not two private ones.
            await loop.run_in_executor(None, self._rediscover_manager)
            if self._mgr_policy is None:
                self._mgr_policy = rpc.rediscovery_policy()
            self._mgr_fails += 1
            await asyncio.sleep(self._mgr_policy.backoff(self._mgr_fails))
            return PollResult(batch_count=0)
        self._mgr_fails = 0
        if not ok:
            await asyncio.sleep(0.1)
            return PollResult(batch_count=0)

        try:
            batch, epoch_last = self.dataloader.next_batch()
            if epoch_last:
                # Epoch boundary: publish this worker's scores and run the
                # curriculum filter over the merged file (reference
                # rollout_worker.py:147-176). In-flight episodes from the old
                # epoch still complete; their scores publish next epoch.
                eval_scores.merge_scores(
                    self.cfg.experiment_name,
                    self.cfg.trial_name,
                    self.pending_scores,
                )
                self._pending_scores = {}
                eval_scores.apply_filter(
                    self.dataset,
                    self.cfg.experiment_name,
                    self.cfg.trial_name,
                    tag=f"rollout{self.cfg.worker_index}",
                    min_size=1,
                )
            eid = next(self._episode_counter)
            self._tasks[f"ep{eid}"] = asyncio.create_task(
                self.rollout_task(batch, trace_parent=alloc_ctx)
            )
        except Exception:
            # The slot was allocated but no episode task owns it yet: a
            # failure in this window (dataloader, curriculum filter, task
            # spawn) must give the slot back or the quota leaks.
            await self._release_quota(False)
            raise
        return PollResult(sample_count=1, batch_count=1)

    def _exit_hook(self):
        try:
            # Scores gathered since the last epoch boundary must survive a
            # shutdown/restart — they inform the post-recovery filter.
            eval_scores.merge_scores(
                self.cfg.experiment_name,
                self.cfg.trial_name,
                self.pending_scores,
            )
            self._pending_scores = {}
        except Exception:
            pass
        try:
            self.pusher.close()
        except Exception:
            pass
