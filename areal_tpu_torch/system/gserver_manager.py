"""Generation-server manager: router, staleness gate and weight updater
(the port's copy of the core of ``areal_tpu/system/gserver_manager.py``).

A singleton worker that:

- routes generation requests across the healthy servers
  (``/schedule_request``) by ``round_robin``, ``least_requests`` or
  ``least_token_usage``, with qid session affinity (a rollout's next
  chunk goes back to the server holding its prefix) that spills to the
  least-loaded server when the holder sheds or is saturated;
- gates new rollouts by capacity and staleness (``/allocate_rollout``,
  ``/finish_rollout``): a rollout may start only if the version it will
  train at, less the current weight version, is at most
  ``max_head_offpolicyness``;
- watches the trainer's published model version and fans each new raw
  dump out to every healthy server with ``/update_weights_from_disk``
  (``allow_interrupt``, ``version``), quorum-based: a server that fails
  the update is evicted;
- evicts servers whose heartbeat dies or that a client reports failed,
  and readmits a returning one after re-syncing it to the current
  version;
- logs the fleet's generation throughput from the servers' ``/metrics``.

The JSON bodies of every route are the reference's, so a port manager
fronts reference servers and a reference client reaches a port manager.

Not ported, each refused at ``configure`` when set: disaggregated pools
and re-roles (``elastic_pools``), drain (no ``/drain_server`` route),
autoscaling (``autoscale``), the elastic fleet and its HA lease
(``elastic_fleet``, ``standby``), the weight plane (``weight_plane``,
``weight_wire_dtype``), the global KV prefix index (``kv_index_size``),
multi-model pools (``multi_model``) and the gateway's tenant rows. The
per-peer circuit breakers are not ported either: a client-reported
failure evicts the server. A server whose heartbeat names a role other
than "unified" is kept out of rotation.

A dump is ready once its ``step.txt`` exists, the file the port's
trainer writes after the raw dump (the reference's trainer is recognised
by its ``engine_state.pkl``, which the port's dump does not write).
When the trial completes, the manager fans out a version published after
its last poll before it leaves, and the servers outlive the trial's
COMPLETE until it has (the reference's manager and servers just leave,
so its last version may or may not land).
"""

from __future__ import annotations

import asyncio
import collections
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import aiohttp
from aiohttp import web

from areal_tpu_torch.api.system_api import GserverManagerConfig
from areal_tpu_torch.base import (
    constants, health, logging, name_resolve, names, network, tracing)
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.system.worker_base import PollResult, Worker

logger = logging.getLogger("gserver_manager")

# Files whose presence marks a finished dump: the port's trainer writes
# step.txt after the raw dump, the reference's writes engine_state.pkl.
DUMP_MARKERS = ("step.txt", "engine_state.pkl")


class RolloutStat:
    def __init__(self):
        self.submitted = 0
        self.running = 0
        self.accepted = 0

    def as_dict(self):
        return dict(
            submitted=self.submitted, running=self.running, accepted=self.accepted
        )


def _refuse_unported(config: GserverManagerConfig):
    refused = {
        "elastic_pools": config.elastic_pools,
        "autoscale": config.autoscale,
        "elastic_fleet": config.elastic_fleet,
        "standby": config.standby,
        "weight_plane": config.weight_plane,
        "weight_wire_dtype": config.weight_wire_dtype is not None,
        "kv_index_size": bool(config.kv_index_size),
        "multi_model": config.multi_model,
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            f"the port's gserver manager does not support {bad} yet (ROADMAP "
            f"Queue A item 4): leave them off")


class GserverManager(Worker):

    def _configure(self, config: GserverManagerConfig):
        _refuse_unported(config)
        self.cfg = config
        constants.set_experiment_trial_names(
            config.experiment_name, config.trial_name
        )
        self._registry = health.HealthRegistry(
            config.experiment_name, config.trial_name,
            prefix="generation_server",
        )
        # First boot: wait for the launch-time fleet to register.
        key = names.gen_servers(config.experiment_name, config.trial_name)
        deadline = time.monotonic() + 300
        while True:
            urls = name_resolve.get_subtree(key)
            if len(urls) >= config.n_servers:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(urls)}/{config.n_servers} generation servers up"
                )
            time.sleep(0.2)
        self.server_urls: List[str] = sorted(urls)
        self._rr = 0
        self._server_reqs = {u: 0 for u in self.server_urls}  # in-flight est.
        self._server_tokens = {u: 0.0 for u in self.server_urls}
        self.weight_version = 0
        self.last_weight_sync_s = 0.0
        self.rollout_stat = RolloutStat()
        self._lock = threading.Lock()
        self._last_metrics_poll = 0.0
        # Training-samples counter snapshot, refreshed on the poll
        # thread: is_staled() runs inside /allocate_rollout on the HTTP
        # loop and must not do name_resolve file I/O there.
        self._training_samples_cache = 0
        self._server_gen_totals = {u: 0.0 for u in self.server_urls}
        # qid -> url LRU (a session's next chunk goes to the server
        # holding its prefix); servers that shed a client with 429 are
        # routed around until their Retry-After elapses; tokens routed
        # since the last /metrics poll fold into least_token_usage.
        self._affinity: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        self._server_shed_until = {u: 0.0 for u in self.server_urls}
        self._server_tokens_pending = {u: 0.0 for u in self.server_urls}
        self._server_shed_total = {u: 0.0 for u in self.server_urls}
        self._last_gen_total = 0.0
        self._last_throughput_log = time.monotonic()
        self._throughput_log_interval = 10.0

        # Fault domain: servers start healthy; heartbeat loss, client
        # failure reports and failed fanouts evict; heartbeat return plus
        # a weight re-sync readmits.
        self._healthy = set(self.server_urls)
        self._evicted: Dict[str, str] = {}  # url -> reason
        self._server_versions = {u: 0 for u in self.server_urls}
        self._member_urls: Dict[str, str] = {}  # health member -> url
        # Rollout-worker quota reconciliation: outstanding slots per
        # worker, reclaimed when that worker's heartbeat dies.
        self._worker_slots: Dict[str, int] = {}
        self._rollout_registry = health.HealthRegistry(
            config.experiment_name, config.trial_name, prefix="rollout_worker",
        )
        self._rollout_seen: set = set()
        self._last_health_poll = 0.0

        self._http_loop = asyncio.new_event_loop()
        # Prime the staleness-gate snapshot before /allocate_rollout can
        # be served.
        self._refresh_training_samples()
        self._http_ready = threading.Event()
        self._http_thread = threading.Thread(target=self._serve_http, daemon=True)
        self._http_thread.start()
        if not self._http_ready.wait(30):
            raise RuntimeError("gserver manager HTTP failed to start")
        name_resolve.add(
            names.gen_server_manager(config.experiment_name, config.trial_name),
            self.address,
            keepalive_ttl=60,
            replace=True,
        )
        logger.info(f"gserver manager at {self.address}, servers={self.server_urls}")

    def _heartbeat_ttl(self) -> float:
        # The fanout blocks the poll loop (no beats) for up to
        # flush_request_timeout.
        return max(health.default_ttl(), self.cfg.flush_request_timeout / 2)

    def _await_fut(self, fut, timeout_s: float):
        """Block on a future of the HTTP loop, beating the heartbeat
        while a long fanout or re-sync runs."""
        import concurrent.futures as _cf

        deadline = time.monotonic() + timeout_s
        while True:
            try:
                return fut.result(timeout=min(5.0, max(0.1, deadline - time.monotonic())))
            except _cf.TimeoutError:
                self._beat()
                if time.monotonic() > deadline:
                    raise

    # ------------------------------------------------------------------
    # Scheduling / staleness
    # ------------------------------------------------------------------

    def _healthy_urls(self) -> List[str]:
        return [u for u in self.server_urls if u in self._healthy]

    def _load_key(self, u: str) -> Tuple[int, float]:
        """Least-loaded order: in-flight request estimate first, then
        token usage with the since-last-poll estimate folded in."""
        return (
            self._server_reqs.get(u, 0),
            self._server_tokens.get(u, 0.0)
            + self._server_tokens_pending.get(u, 0.0),
        )

    def _choose_server(
        self, meta: Dict
    ) -> Tuple[Optional[str], str, Optional[str], Optional[str]]:
        """Pick a healthy server; returns (url, policy, decode_url,
        kv_source), the reference's tuple. The port has no prefill /
        decode pairing and no prefix index, so the last two are None
        except for a spill, whose kv_source names the holder. policy is
        'affinity' (the session's holder), 'spill' (holder shedding or
        saturated -> least loaded), 'sticky' (the client's previous
        server at an unchanged version) or the configured base policy;
        (None, 'none', None, None) when no server is healthy."""
        candidates = self._healthy_urls()
        if not candidates:
            return None, "none", None, None
        now = time.monotonic()
        open_ = [u for u in candidates if self._server_shed_until.get(u, 0.0) <= now]
        # Whole fleet inside a shed window: route anyway (the client
        # backs off on the 429 itself).
        pool = open_ or candidates
        qid = str(meta.get("qid") or "")
        if self.cfg.session_affinity and qid:
            aff = self._affinity.get(qid)
            if aff is not None and aff in candidates:
                sat = self.cfg.affinity_saturation_requests
                shedding = self._server_shed_until.get(aff, 0.0) > now
                saturated = sat is not None and self._server_reqs.get(aff, 0) >= sat
                if not shedding and not saturated:
                    return aff, "affinity", None, None
                spill_pool = [u for u in pool if u != aff] or pool
                spilled = min(spill_pool, key=self._load_key)
                return spilled, "spill", None, aff if spilled != aff else None
        prev = meta.get("previous_server_url") or ""
        prev_version = int(meta.get("previous_version", -1))
        # Sticky hint from clients without affinity: only while the
        # weight version is unchanged.
        if prev in pool and prev_version == self.weight_version:
            return prev, "sticky", None, None
        policy = self.cfg.schedule_policy
        if policy == "least_requests":
            url = min(pool, key=lambda u: self._server_reqs[u])
        elif policy == "least_token_usage":
            url = min(
                pool,
                key=lambda u: self._server_tokens[u]
                + self._server_tokens_pending.get(u, 0.0),
            )
        else:
            policy = "round_robin"
            url = pool[self._rr % len(pool)]
            self._rr += 1
        return url, policy, None, None

    def _route(
        self, meta: Dict
    ) -> Tuple[Optional[str], str, Optional[str], Optional[str]]:
        """Choose a server and do the routing bookkeeping: the in-flight
        request estimate, the routed tokens folded into the load
        estimate until the next /metrics poll, the session's affinity."""
        qid = str(meta.get("qid") or "")
        with self._lock:
            url, policy, decode_url, kv_source = self._choose_server(meta)
            if url is not None:
                self._server_reqs[url] += 1
                self._server_tokens_pending[url] = (
                    self._server_tokens_pending.get(url, 0.0)
                    + float(meta.get("prompt_len") or 0)
                    + float(meta.get("new_token_budget") or 0)
                )
                self._record_affinity(qid, url)
        return url, policy, decode_url, kv_source

    def _record_affinity(self, qid: str, url: str):
        """LRU-bounded qid -> url map (call under self._lock)."""
        if not qid or not self.cfg.session_affinity:
            return
        self._affinity.pop(qid, None)
        self._affinity[qid] = url
        while len(self._affinity) > max(1, self.cfg.affinity_map_size):
            self._affinity.popitem(last=False)

    # ------------------------------------------------------------------
    # Fault-domain isolation: eviction + readmission
    # ------------------------------------------------------------------

    def _forget_server(self, url: str):
        """Drop an evicted server's routing state (call under _lock):
        its load estimates, shed window and affinity entries."""
        self._server_reqs[url] = 0
        self._server_tokens[url] = 0.0
        self._server_tokens_pending[url] = 0.0
        self._server_shed_until[url] = 0.0
        for qid in [q for q, u in self._affinity.items() if u == url]:
            self._affinity.pop(qid, None)

    def _mark_unhealthy(self, url: str, reason: str):
        if url not in self.server_urls:
            return
        with self._lock:
            if url not in self._healthy:
                return
            self._healthy.discard(url)
            self._evicted[url] = reason
            self._forget_server(url)
        logger.warning(
            f"evicted generation server {url}: {reason} "
            f"({len(self._healthy_urls())}/{len(self.server_urls)} healthy)"
        )

    def _readmit(self, url: str):
        with self._lock:
            self._evicted.pop(url, None)
            self._healthy.add(url)
        logger.info(
            f"readmitted generation server {url} at weight version "
            f"{self._server_versions.get(url, 0)} "
            f"({len(self._healthy_urls())}/{len(self.server_urls)} healthy)"
        )

    def _current_param_path(self) -> Optional[str]:
        path = os.path.join(
            constants.get_param_realloc_path(self.cfg.experiment_name, self.cfg.trial_name),
            self.cfg.model_name,
        )
        if any(os.path.exists(os.path.join(path, f)) for f in DUMP_MARKERS):
            return path
        return None

    async def _post_update(self, sess, url: str, path: str, version: int, ctx=None):
        return await sess.post(
            f"{url}/update_weights_from_disk",
            json=tracing.inject_ctx_into(
                {"model_path": path, "allow_interrupt": True, "version": version}, ctx),
        )

    def _resync_server(self, url: str) -> bool:
        """Push the current weight version to a returning server before
        it re-enters rotation (a cheap no-op server-side when it already
        holds the version)."""
        target_v = self.weight_version
        if target_v <= 0:
            return True
        path = self._current_param_path()
        if path is None:
            return False

        async def _push():
            async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.cfg.flush_request_timeout)
            ) as sess:
                async with await self._post_update(sess, url, path, target_v) as r:
                    body = await r.json()
                    return bool(body.get("success"))

        try:
            fut = asyncio.run_coroutine_threadsafe(_push(), self._http_loop)
            ok = self._await_fut(fut, self.cfg.flush_request_timeout + 10)
        except Exception:
            logger.warning(f"re-sync of {url} failed; staying evicted", exc_info=True)
            return False
        if ok:
            with self._lock:
                self._server_versions[url] = target_v
        return ok

    def _poll_health(self):
        """Fold the health registry into the healthy/evicted split:
        heartbeat loss evicts, heartbeat return (after a weight re-sync)
        readmits; then reclaim the quota slots of dead rollout workers."""
        snapshot, _ = self._registry.classified()
        alive_urls = set()
        for member, record in sorted(snapshot.items()):
            url = record.get("url")
            if not url or url not in self.server_urls:
                continue
            self._member_urls[member] = url
            role = record.get("role") or "unified"
            if role != "unified":
                self._mark_unhealthy(
                    url, f"role {role!r}: disaggregated serving is not ported")
                continue
            alive_urls.add(url)
        for member, url in list(self._member_urls.items()):
            if member not in snapshot and url in self._healthy:
                self._mark_unhealthy(url, f"missed heartbeats ({member})")
        for url in [u for u in list(self._evicted) if u in alive_urls]:
            self._beat()
            if (self._server_versions.get(url, 0) >= self.weight_version
                    or self._resync_server(url)):
                self._readmit(url)
        # A rollout worker whose heartbeat died can never finish its
        # episodes: give its outstanding slots back.
        rollout_alive = self._rollout_registry.snapshot()
        self._rollout_seen |= set(rollout_alive)
        for member in [m for m in self._rollout_seen if m not in rollout_alive]:
            self._rollout_seen.discard(member)
            with self._lock:
                n = self._worker_slots.pop(member, 0)
                if n:
                    self.rollout_stat.running = max(0, self.rollout_stat.running - n)
                    self.rollout_stat.submitted = max(0, self.rollout_stat.submitted - n)
            if n:
                logger.warning(
                    f"reclaimed {n} quota slot(s) from dead/departed rollout worker {member}")

    def _training_samples(self) -> int:
        """The poll thread's snapshot of the trainer's sample counter."""
        return self._training_samples_cache

    def _refresh_training_samples(self) -> None:
        """Poll-thread-only: fetch the published counter (file I/O)."""
        try:
            self._training_samples_cache = int(
                name_resolve.get(
                    names.training_samples(self.cfg.experiment_name, self.cfg.trial_name)
                )
            )
        except (name_resolve.NameEntryNotFoundError, ValueError):
            pass

    def is_staled(self) -> bool:
        """Staleness gate: if this rollout trained at the version implied
        by the samples already produced, would it be more than
        max_head_offpolicyness behind?"""
        global_samples = max(self._training_samples(), self.rollout_stat.submitted)
        expected_version = global_samples // self.cfg.train_batch_size
        return expected_version - self.weight_version > self.cfg.max_head_offpolicyness

    # ------------------------------------------------------------------
    # HTTP endpoints
    # ------------------------------------------------------------------

    def _serve_http(self):
        asyncio.set_event_loop(self._http_loop)
        app = web.Application()
        app.router.add_post("/schedule_request", self._h_schedule)
        app.router.add_post("/allocate_rollout", self._h_allocate)
        app.router.add_post("/finish_rollout", self._h_finish)
        app.router.add_get("/status", self._h_status)
        runner = web.AppRunner(app)
        self._http_loop.run_until_complete(runner.setup())
        host = network.gethostip()
        self._http_loop.run_until_complete(web.TCPSite(runner, host, 0).start())
        port = runner.addresses[0][1]
        self.address = f"http://{host}:{port}"
        self._http_ready.set()
        self._http_loop.run_forever()

    async def _h_schedule(self, request: web.Request) -> web.Response:
        meta = await request.json()
        trace_ctx = tracing.extract_from(meta)
        # The server a request just failed on leaves rotation; the
        # health fold readmits it once it beats and re-syncs.
        failed = meta.get("failed_server_url")
        if failed:
            self._mark_unhealthy(failed, "client-reported request failure")
        # A 429 is load-shedding, never a failure: route around the
        # server for its Retry-After window and keep it healthy.
        shed = meta.get("shed_server_url")
        if shed and shed in self.server_urls:
            ra = float(meta.get("shed_retry_after") or 1.0)
            with self._lock:
                self._server_shed_until[shed] = time.monotonic() + ra
                self._server_shed_total[shed] = self._server_shed_total.get(shed, 0.0) + 1.0
        qid = str(meta.get("qid") or "")
        url, policy, _, kv_source = self._route(meta)
        tracing.event(
            "manager.schedule", ctx=trace_ctx,
            server=url or "", routed=url is not None, policy=policy,
            qid=qid, kv_source=kv_source or "",
        )
        if url is None:
            return web.json_response(
                {"error": "no healthy generation servers", "retry_after": 0.5},
                status=503,
            )
        resp = {"url": url, "version": self.weight_version, "policy": policy}
        if kv_source is not None:
            resp["kv_source"] = kv_source
        return web.json_response(resp)

    async def _h_allocate(self, request: web.Request) -> web.Response:
        d = await request.json()
        trace_ctx = tracing.extract_from(d)
        worker = str(d.get("worker", "?"))
        reason = None
        with self._lock:
            cap = self.cfg.max_concurrent_rollouts or (1 << 30)
            if self.rollout_stat.running >= cap:
                reason = "capacity"
            elif self.is_staled():
                reason = "staled"
            else:
                self.rollout_stat.submitted += 1
                self.rollout_stat.running += 1
                self._worker_slots[worker] = self._worker_slots.get(worker, 0) + 1
        tracing.event(
            "manager.allocate", ctx=trace_ctx,
            admitted=reason is None, reason=reason or "",
            version=self.weight_version,
        )
        if reason is not None:
            resp = {"success": False, "reason": reason}
            if reason == "staled":
                resp["version"] = self.weight_version
            return web.json_response(resp)
        return web.json_response({"success": True, "version": self.weight_version})

    async def _h_finish(self, request: web.Request) -> web.Response:
        d = await request.json()
        worker = str(d.get("worker", "?"))
        with self._lock:
            self.rollout_stat.running = max(0, self.rollout_stat.running - 1)
            n = self._worker_slots.get(worker, 0)
            if n > 1:
                self._worker_slots[worker] = n - 1
            else:
                self._worker_slots.pop(worker, None)
            if d.get("accepted", True):
                self.rollout_stat.accepted += 1
            else:
                # Rejected rollouts give their staleness budget back.
                self.rollout_stat.submitted = max(0, self.rollout_stat.submitted - 1)
        return web.json_response({"success": True})

    async def _h_status(self, request: web.Request) -> web.Response:
        """The reference's /status keys for the features the port has."""
        with self._lock:
            healthy = self._healthy_urls()
            status = {
                "weight_version": self.weight_version,
                "rollout_stat": self.rollout_stat.as_dict(),
                "servers": self.server_urls,
                "healthy_servers": healthy,
                "evicted_servers": dict(self._evicted),
                "server_versions": dict(self._server_versions),
                "load_shed": {
                    "total": sum(self._server_shed_total.values()),
                    "per_server": dict(self._server_shed_total),
                },
                "affinity_entries": len(self._affinity),
            }
        return web.json_response(status)

    # ------------------------------------------------------------------
    # Weight updates
    # ------------------------------------------------------------------

    def check_new_params(self) -> Optional[str]:
        """The dump path when the trainer published a newer version."""
        try:
            v = int(name_resolve.get(names.model_version(
                self.cfg.experiment_name, self.cfg.trial_name, self.cfg.model_name)))
        except (name_resolve.NameEntryNotFoundError, ValueError):
            return None
        if v <= self.weight_version:
            return None
        path = self._current_param_path()
        if path is None:
            return None
        self._new_version = v
        return path

    def flush_requests_and_update_weights(self, path: str):
        """Quorum-based fanout: push the new version to every healthy
        server; the step proceeds when at least one succeeds, and the
        failed ones are evicted (they re-sync on readmission)."""
        t_start = time.monotonic()
        targets = self._healthy_urls()
        if not targets:
            raise RuntimeError("weight-update fanout: no healthy generation servers")
        load_stats: list = []
        successes: List[str] = []
        failures: Dict[str, str] = {}
        fanout_span = tracing.start_span(
            "manager.weight_update", version=self._new_version, n_targets=len(targets),
        )

        async def _update():
            await faults.maybe_fail_async("manager.fanout")
            async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.cfg.flush_request_timeout)
            ) as sess:
                resps = await asyncio.gather(
                    *[self._post_update(sess, u, path, self._new_version,
                                        fanout_span.ctx if fanout_span else None)
                      for u in targets],
                    return_exceptions=True)
                for u, r in zip(targets, resps):
                    if isinstance(r, Exception):
                        failures[u] = repr(r)
                        continue
                    body = await r.json()
                    if not body.get("success"):
                        failures[u] = f"rejected: {body}"
                        continue
                    successes.append(u)
                    load_stats.append((body.get("source", "?"), float(body.get("load_s", 0.0))))

        try:
            fut = asyncio.run_coroutine_threadsafe(_update(), self._http_loop)
            self._await_fut(fut, self.cfg.flush_request_timeout + 10)
        finally:
            if fanout_span is not None:
                fanout_span.end(n_success=len(successes), n_failed=len(failures))
        if not successes:
            # No quorum: weight_version stays put and the next poll
            # retries the (idempotent, version-pinned) fanout.
            raise RuntimeError(
                f"weight update v{self._new_version} reached no server: {failures}")
        for u, reason in failures.items():
            self._mark_unhealthy(u, f"weight update failed: {reason}")
        with self._lock:
            self.weight_version = self._new_version
            for u in successes:
                self._server_versions[u] = self._new_version
            self.last_weight_sync_s = time.monotonic() - t_start
        if failures:
            logger.warning(
                f"degraded weight-update fanout to v{self._new_version}: "
                f"{len(successes)}/{len(targets)} servers in "
                f"{self.last_weight_sync_s:.3f}s; evicted {sorted(failures)}")
        else:
            logger.info(
                f"all servers updated to weight version {self._new_version} "
                f"in {self.last_weight_sync_s:.3f}s "
                f"(loads: {', '.join(f'{s} {t:.3f}s' for s, t in load_stats)})")

    def _last_fanout(self):
        """At COMPLETE, fan out a version the trainer published after
        this manager's last poll, so the fleet ends on the trained
        weights (the servers outlive COMPLETE until this manager
        stops)."""
        path = self.check_new_params()
        if path is None:
            return
        try:
            self.flush_requests_and_update_weights(path)
        except Exception:
            logger.warning("last weight-update fanout failed", exc_info=True)

    async def _poll_metrics(self):
        """Fold each healthy server's /metrics into the routing loads and
        the throughput counter."""
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=5)) as sess:
            for u in self._healthy_urls():
                try:
                    async with sess.get(f"{u}/metrics") as r:
                        text = await r.text()
                    for line in text.splitlines():
                        name, _, val = line.strip().partition(" ")
                        if name == "areal:num_used_tokens":
                            self._server_tokens[u] = float(val)
                            self._server_tokens_pending[u] = 0.0
                        elif name == "areal:num_running_reqs":
                            self._server_reqs[u] = int(float(val))
                        elif name == "areal:load_shed_total":
                            self._server_shed_total[u] = float(val)
                        elif name == "areal:total_generated_tokens":
                            self._server_gen_totals[u] = float(val)
                except Exception:
                    logger.warning(f"metrics poll failed for {u}")

    def _poll(self) -> Optional[PollResult]:
        try:
            status = name_resolve.get(
                names.experiment_status(self.cfg.experiment_name, self.cfg.trial_name))
            if status == "COMPLETE":
                self._last_fanout()
            if status in ("COMPLETE", "ABORT"):
                return None
        except name_resolve.NameEntryNotFoundError:
            pass
        self._refresh_training_samples()
        if time.monotonic() - self._last_health_poll > self.cfg.health_check_interval:
            try:
                self._poll_health()
            except Exception:
                logger.warning("health poll failed", exc_info=True)
            self._last_health_poll = time.monotonic()

        path = self.check_new_params()
        if path is not None:
            try:
                self.flush_requests_and_update_weights(path)
            except Exception:
                # weight_version stays put: the next poll retries.
                logger.warning("weight-update fanout failed; will retry", exc_info=True)
                time.sleep(1.0)
            return PollResult(batch_count=1)
        if time.monotonic() - self._last_metrics_poll > 2.0:
            fut = asyncio.run_coroutine_threadsafe(self._poll_metrics(), self._http_loop)
            try:
                fut.result(timeout=10)
            except Exception:
                pass
            self._last_metrics_poll = time.monotonic()
        # Periodic generation-throughput log: interval tokens/s over all
        # servers plus the rollout counters.
        now = time.monotonic()
        if now - self._last_throughput_log > self._throughput_log_interval:
            total_gen = sum(self._server_gen_totals.values())
            dt = now - self._last_throughput_log
            tps = max(0.0, total_gen - self._last_gen_total) / dt
            with self._lock:
                rs = self.rollout_stat.as_dict()
            logger.info(
                f"generation throughput: {tps:.0f} tokens/s (total {total_gen:.0f}) "
                f"rollouts={rs} weight_version={self.weight_version}")
            self._last_gen_total = total_gen
            self._last_throughput_log = now
        time.sleep(0.05)
        return PollResult(batch_count=0)

    def _exit_hook(self):
        try:
            self._http_loop.call_soon_threadsafe(self._http_loop.stop)
            self._http_thread.join(timeout=5)
        except Exception:
            pass
