"""Generation-server manager: router, staleness gate and weight updater
(the port's copy of the core of ``areal_tpu/system/gserver_manager.py``).

A singleton worker that:

- routes generation requests across the healthy servers
  (``/schedule_request``) by ``round_robin``, ``least_requests`` or
  ``least_token_usage``, with qid session affinity (a rollout's next
  chunk goes back to the server holding its prefix) that spills to the
  least-loaded server when the holder sheds or is saturated;
- with prefill- or decode-role servers in the fleet, routes by pool:
  fresh work pairs the least prompt-loaded prefill server with the most
  page-free decode server (``decode_url`` in the answer), continuations
  follow their decode-side KV, and a failure retry re-pairs through the
  pools; with ``elastic_pools`` it re-roles "unified"-configured servers
  between the pools on queued-prompt and free-page watermarks
  (``/set_role``);
- with ``kv_index_size`` keeps a global prefix index fed from every
  server's ``/kv/index``: a session routed away from the server holding
  its prefix gets a ``kv_source`` hint and the routed server pulls it;
- drains a server on ``/drain_server``: routing stops at once, the
  server migrates its prefixes to the others and leaves; a drain past
  ``drain_timeout_s`` is evicted;
- gates new rollouts by capacity and staleness (``/allocate_rollout``,
  ``/finish_rollout``): a rollout may start only if the version it will
  train at, less the current weight version, is at most
  ``max_head_offpolicyness``;
- watches the trainer's published model version and fans each new raw
  dump out to every healthy server with ``/update_weights_from_disk``
  (``allow_interrupt``, ``version``), quorum-based: a server that fails
  the update is evicted;
- with ``weight_plane``, fans it out over the weight-distribution plane
  instead: a degree-bounded peer tree (``weight_fanout_degree``) from
  the origin (the trainer's registered source, else one this manager
  starts over the dump dir), wave by wave with ``/distribute_weights``,
  an edge whose parent failed re-parented onto a holder (the origin
  last), then every holder's ``/cutover_weights`` at once; the
  ``weight_wire_dtype`` stream when the dump has it, else the raw one;
- evicts servers whose heartbeat dies or that a client reports failed,
  and readmits a returning one after bringing it to the current version
  (over the plane from peers that hold it, the origin last, or with
  ``/update_weights_from_disk``); a server restarted in place beats the
  same health member at a new address, which replaces its dead one in
  the routing table and starts evicted at version 0;
- keeps a per-peer circuit breaker board (``breakers``, base/rpc.py) fed
  by client failure reports, its own fanout and cutover posts and its
  ``/metrics`` polls: routing leaves an open-breaker server out as it
  leaves out a shedding one (never evicting it for that), so a server
  that keeps failing stops taking traffic between its readmissions;
- logs the fleet's generation throughput from the servers' ``/metrics``,
  with the fleet's speculation yield when a server speculates.

The JSON bodies of every route are the reference's, so a port manager
fronts reference servers and a reference client reaches a port manager.

Not ported, each refused at ``configure`` when set: autoscaling
(``autoscale``, which needs a launcher), the elastic fleet and its HA
lease (``elastic_fleet``, ``standby``; so a drained server that leaves
is evicted as missed heartbeats, not removed), multi-model pools
(``multi_model``) and the gateway's tenant rows; the plane fans out to
unsharded servers only (shard streams wait for multi-device). A server
beyond the launch-time fleet (a joiner) is ignored: adopting one belongs
to the elastic fleet.

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
    constants, health, logging, name_resolve, names, network, rpc, tracing)
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
        "autoscale": config.autoscale,
        "elastic_fleet": config.elastic_fleet,
        "standby": config.standby,
        "multi_model": config.multi_model,
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            f"the port's gserver manager does not support {bad} yet (ROADMAP "
            f"Queue A item 4): leave them off")


class GserverManager(Worker):

    @property
    def breakers(self) -> rpc.BreakerBoard:
        """Per-peer circuit breakers fed by this manager's own calls
        (metrics polls, fanout and cutover posts) and by client-reported
        request failures. An OPEN breaker makes the peer unroutable, as
        an active shed window does; eviction stays the health fold's
        call. Built lazily, so a manager built with ``__new__`` has one."""
        b = self.__dict__.get("_breaker_board")
        if b is None:
            b = rpc.BreakerBoard()
            self.__dict__["_breaker_board"] = b
        return b

    def _record_breaker(self, url: str, ok: bool):
        """Feed one outcome to ``url``'s breaker; an opening is traced."""
        br = self.breakers.breaker(url)
        opens = br.opens
        if ok:
            br.record_success()
        else:
            br.record_failure()
        if br.opens > opens:
            logger.warning(f"circuit breaker of {url} opened ({br.opens} opening(s))")
            tracing.event("manager.breaker_open", server=url, opens=br.opens,
                          cooldown_s=br.cooldown_s)

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
        # Fleet speculation yield as a ratio of SUMS: each server's emitted
        # tokens and active decode steps (a mean of per-server ratios would
        # overweight idle servers).
        self._server_spec_emitted = {u: 0.0 for u in self.server_urls}
        self._server_spec_steps = {u: 0.0 for u in self.server_urls}
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
        # Global prefix index: qid -> {url, tier, n_tokens, version},
        # LRU-bounded, fed from each server's /kv/index on the metrics
        # poll. Affinity is the fast path; the index gives a session
        # routed elsewhere a kv_source hint to pull its prefix from.
        self._kv_index_size = int(config.kv_index_size or 0)
        self._prefix_index: "collections.OrderedDict[str, Dict]" = collections.OrderedDict()
        # url -> qids that server last advertised (pruning, eviction).
        self._server_kv_index: Dict[str, set] = {}
        # Disaggregated pools: live role per server (heartbeat, /metrics,
        # or our own re-role), elastic eligibility (configured "unified"),
        # and the load signals the pools route on.
        self._server_roles: Dict[str, str] = {u: "unified" for u in self.server_urls}
        self._server_elastic: Dict[str, bool] = {}
        self._server_queued_toks = {u: 0.0 for u in self.server_urls}
        self._server_free_pages: Dict[str, float] = {}
        self._server_total_pages: Dict[str, float] = {}
        self._server_kv: Dict[str, Dict[str, float]] = {}
        # Re-role bookkeeping: url -> its role before our flip, and a log.
        self._rerole_orig: Dict[str, str] = {}
        self._rerole_log: List[Dict] = []
        self._last_rerole = 0.0
        # Drains: a draining server finishes its work and serves KV pulls
        # but takes no new routing, fanouts or re-roles.
        self._draining: set = set()
        self._drain_deadline: Dict[str, float] = {}
        self._drain_log: List[Dict] = []
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
        # Weight plane: the origin this manager started when no trainer
        # source is registered, and the last tree fanout for /status.
        self._own_source = None
        # Set at COMPLETE: the trainer-side source closes as its model
        # worker exits, so the last fanout is served from _own_source.
        self._trainer_source_gone = False
        self._wp_last: Dict = {}

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
        """Routable servers: healthy and not draining."""
        return [u for u in self.server_urls if u in self._healthy and u not in self._draining]

    def _live_urls(self) -> List[str]:
        """Healthy servers including draining ones: the metrics and
        prefix-index poll set (a draining server still reports progress
        and serves its prefixes)."""
        return [u for u in self.server_urls if u in self._healthy]

    def _load_key(self, u: str) -> Tuple[int, float]:
        """Least-loaded order: in-flight request estimate first, then
        token usage with the since-last-poll estimate folded in."""
        return (
            self._server_reqs.get(u, 0),
            self._server_tokens.get(u, 0.0)
            + self._server_tokens_pending.get(u, 0.0),
        )

    def _role(self, u: str) -> str:
        return self._server_roles.get(u, "unified")

    def _disagg_split(self, candidates: List[str]) -> bool:
        """True when the routable fleet holds a dedicated prefill or
        decode server: pool routing engages only then."""
        return any(self._role(u) != "unified" for u in candidates)

    def _index_holder(self, qid: str, candidates: List[str]) -> Optional[str]:
        """Routable holder of qid's prefix per the global index (call
        under self._lock); None when the index is off or nobody holds."""
        if not qid or not self._kv_index_size:
            return None
        ent = self._prefix_index.get(qid)
        if ent is None:
            return None
        url = ent.get("url")
        return url if url in candidates else None

    def _choose_server(
        self, meta: Dict
    ) -> Tuple[Optional[str], str, Optional[str], Optional[str]]:
        """Pick a healthy server; returns (url, policy, decode_url,
        kv_source). policy names the decision: 'affinity' (the session's
        holder), 'kv-index' (the holder from the global prefix index once
        the affinity map forgot), 'spill' (holder shedding or saturated
        -> least loaded, with kv_source naming the holder so the target
        pulls the prefix), 'sticky' (the client's previous server at an
        unchanged version), 'disagg' (a prefill/decode pair: decode_url
        is set), or the configured base policy. kv_source, when set,
        names another server holding the session's prefix. (None,
        'none', None, None) when no server is routable."""
        candidates = self._healthy_urls()
        if not candidates:
            return None, "none", None, None
        now = time.monotonic()
        tripped = set(self.breakers.open_peers())
        open_ = [u for u in candidates
                 if self._server_shed_until.get(u, 0.0) <= now and u not in tripped]
        # Whole fleet shedding or breaker-open: route anyway (the client
        # backs off on the 429 itself, and a half-open probe needs some
        # traffic); shed windows and breakers never evict.
        pool = open_ or candidates
        qid = str(meta.get("qid") or "")
        if self._disagg_split(candidates):
            return self._choose_disagg(meta, candidates, pool, qid, now)
        holder = self._index_holder(qid, candidates)
        if self.cfg.session_affinity and qid:
            aff = self._affinity.get(qid)
            policy_hit = "affinity"
            if aff is None or aff not in candidates:
                # The affinity map forgot, the global index still knows.
                aff, policy_hit = holder, "kv-index"
            if aff is not None and aff in candidates:
                sat = self.cfg.affinity_saturation_requests
                shedding = self._server_shed_until.get(aff, 0.0) > now
                saturated = sat is not None and self._server_reqs.get(aff, 0) >= sat
                if not shedding and not saturated:
                    return aff, policy_hit, None, None
                spill_pool = [u for u in pool if u != aff] or pool
                spilled = min(spill_pool, key=self._load_key)
                return spilled, "spill", None, aff if spilled != aff else None
        prev = meta.get("previous_server_url") or ""
        prev_version = int(meta.get("previous_version", -1))
        # Sticky hint from clients without affinity: only while the
        # weight version is unchanged.
        if prev in pool and prev_version == self.weight_version:
            return prev, "sticky", None, holder if holder and holder != prev else None
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
        # Without affinity the index still pays: the routed server pulls
        # the prefix.
        return url, policy, None, holder if holder and holder != url else None

    def _choose_disagg(self, meta, candidates, pool, qid, now):
        """Pool routing for a split fleet: continuations follow their
        decode-side KV (session affinity), fresh work pairs the least
        prompt-loaded prefill server with the most page-free decode
        server."""
        prefill_pool = [u for u in pool if self._role(u) != "decode"]
        decode_pool = [u for u in pool if self._role(u) != "prefill"]
        # A failure retry re-pairs through the pools: the affinity entry
        # was recorded at pairing time and may name a decode server that
        # never received the session's KV.
        retry = bool(meta.get("failed_server_url"))
        holder = None if retry else self._index_holder(qid, candidates)
        if self.cfg.session_affinity and qid and not retry:
            aff = self._affinity.get(qid)
            policy_hit = "affinity"
            if aff is None or aff not in candidates:
                aff, policy_hit = holder, "kv-index"
            if aff is not None and aff in candidates:
                # The session's KV is parked on its decode server: a plain
                # /generate there prefills only the delta (any role serves
                # one). Spill as the unified path does, with kv_source.
                sat = self.cfg.affinity_saturation_requests
                shedding = self._server_shed_until.get(aff, 0.0) > now
                saturated = sat is not None and self._server_reqs.get(aff, 0) >= sat
                if not shedding and not saturated:
                    return aff, policy_hit, None, None
                if decode_pool:
                    spill = [u for u in decode_pool if u != aff] or decode_pool
                    spilled = min(spill, key=self._load_key)
                    return spilled, "spill", None, aff if spilled != aff else None
        if not prefill_pool or not decode_pool:
            # Degenerate split (one pool empty): serve unified on what
            # remains.
            rest = prefill_pool or decode_pool or pool
            url = min(rest, key=self._load_key)
            return url, "disagg-degenerate", None, holder if holder and holder != url else None
        # Prefill by queued prompt tokens, decode by free-page headroom.
        purl = min(prefill_pool, key=lambda u: (
            self._server_queued_toks.get(u, 0.0) + self._server_tokens_pending.get(u, 0.0),
            self._server_reqs.get(u, 0)))
        durl = min(decode_pool, key=lambda u: (
            self._server_reqs.get(u, 0), -self._server_free_pages.get(u, 0.0)))
        if purl == durl:
            # One unified server won both pools: a plain local serve.
            return purl, "disagg-local", None, holder if holder and holder != purl else None
        # The prefill server runs the (delta) prefill, so it pulls.
        return purl, "disagg", durl, holder if holder and holder != purl else None

    def _route(
        self, meta: Dict
    ) -> Tuple[Optional[str], str, Optional[str], Optional[str]]:
        """Choose a server and do the routing bookkeeping: the in-flight
        request estimate, the routed tokens folded into the load
        estimate until the next /metrics poll, the session's affinity.
        For a prefill/decode pair the prompt lands on the prefill
        server's estimate, the decode budget on the decode server's, and
        the affinity points at the decode server, where the KV will live."""
        qid = str(meta.get("qid") or "")
        with self._lock:
            url, policy, decode_url, kv_source = self._choose_server(meta)
            if url is not None:
                self._server_reqs[url] += 1
                self._server_tokens_pending[url] = (
                    self._server_tokens_pending.get(url, 0.0)
                    + float(meta.get("prompt_len") or 0)
                    + (0.0 if decode_url else float(meta.get("new_token_budget") or 0))
                )
                if decode_url is not None:
                    self._server_reqs[decode_url] = self._server_reqs.get(decode_url, 0) + 1
                    self._server_tokens_pending[decode_url] = (
                        self._server_tokens_pending.get(decode_url, 0.0)
                        + float(meta.get("prompt_len") or 0)
                        + float(meta.get("new_token_budget") or 0)
                    )
                self._record_affinity(qid, decode_url or url)
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

    def _drop_index_for(self, url: str):
        """Drop an evicted server's prefix-index entries (call under
        self._lock): its process, and so its tier, cannot be trusted."""
        qids = self._server_kv_index.pop(url, None) or set()
        for q in qids:
            ent = self._prefix_index.get(q)
            if ent is not None and ent.get("url") == url:
                self._prefix_index.pop(q, None)

    # Keep in sync with _add_server_row: every map here gets a zeroed
    # row there.
    _PER_SERVER_FLOAT_MAPS = (
        "_server_tokens", "_server_gen_totals", "_server_spec_emitted",
        "_server_spec_steps", "_server_tokens_pending", "_server_shed_until",
        "_server_shed_total", "_server_queued_toks",
    )
    _PER_SERVER_SPARSE_MAPS = (
        "_server_free_pages", "_server_total_pages", "_server_kv",
        "_server_elastic", "_rerole_orig",
    )

    def _forget_server(self, url: str, remove: bool = False):
        """Drop a server's routing state (call under _lock): its load
        estimates, shed window, affinity and prefix-index entries and
        drain state. ``remove`` (a dead address replaced by its restarted
        server's new one) also drops its whole row: table membership,
        per-server maps, role, version, health split, member mapping and
        breaker."""
        self._server_reqs[url] = 0
        self._server_tokens[url] = 0.0
        self._server_tokens_pending[url] = 0.0
        self._server_shed_until[url] = 0.0
        for qid in [q for q, u in self._affinity.items() if u == url]:
            self._affinity.pop(qid, None)
        self._drop_index_for(url)
        self._draining.discard(url)
        self._drain_deadline.pop(url, None)
        if not remove:
            return
        # The dead incarnation's cumulative tokens leave the fleet sum;
        # shift the throughput baseline down with them.
        self._last_gen_total = max(
            0.0, self._last_gen_total - self._server_gen_totals.get(url, 0.0))
        self.server_urls = [u for u in self.server_urls if u != url]
        for attr in self._PER_SERVER_FLOAT_MAPS + self._PER_SERVER_SPARSE_MAPS:
            getattr(self, attr).pop(url, None)
        self._server_reqs.pop(url, None)
        self._server_roles.pop(url, None)
        self._server_versions.pop(url, None)
        self.breakers.drop(url)
        for member in [m for m, u in self._member_urls.items() if u == url]:
            self._member_urls.pop(member, None)
        self._healthy.discard(url)
        self._evicted.pop(url, None)

    def _add_server_row(self, url: str):
        """A zeroed routing-table row for a url entering the table (call
        under _lock); its role comes from its first heartbeat."""
        self.server_urls = sorted(set(self.server_urls) | {url})
        for attr in self._PER_SERVER_FLOAT_MAPS:
            getattr(self, attr)[url] = 0.0
        self._server_reqs[url] = 0
        self._server_roles[url] = "unified"
        self._server_versions[url] = 0

    def _replace_server_url(self, old: str, new: str):
        """A generation server restarted in place beats the SAME health
        member at a NEW address: forget the dead incarnation's routing
        footprint (the new process holds no KV) and add a zeroed row for
        the new address. It starts evicted at version 0, so readmission
        brings it to the current version before it serves."""
        with self._lock:
            self._forget_server(old, remove=True)
            self._add_server_row(new)
            self._evicted[new] = "restarted at new address"
        logger.info(f"generation server moved {old} -> {new}")
        tracing.event("manager.server_moved", old=old, new=new)

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

    def _bootstrap_server(self, url: str) -> bool:
        """Bring a returning server to the current weight version before
        it re-enters rotation: over the plane from peers that hold it (the
        origin last) when the plane is armed, else by the disk re-sync.
        False keeps it evicted until the next health poll."""
        if self.weight_version <= 0:
            return True
        if self.cfg.weight_plane:
            try:
                return self._plane_bootstrap(url)
            except Exception:
                logger.warning(f"plane bootstrap of {url} failed; staying evicted",
                               exc_info=True)
                return False
        return self._resync_server(url)

    def _plane_bootstrap(self, url: str) -> bool:
        """One server's weight bootstrap over the plane: the manifest and
        chunks from healthy peers at the current version (their stores
        outlive the cutover for this), the origin last, then a cutover."""
        from areal_tpu_torch.engine.weight_client import fetch_manifest

        version = self.weight_version
        with self._lock:
            holders = [u for u in self._healthy_urls()
                       if u != url and self._server_versions.get(u, 0) == version]
        origin = self._weight_plane_origin(self._current_param_path())
        man = None
        if self.cfg.join_bootstrap != "origin":
            for h in holders:
                try:
                    man = fetch_manifest(h, version=version, timeout=5.0,
                                         wire=self.cfg.weight_wire_dtype)
                    break
                except Exception:
                    continue
        if man is None:
            if origin is None:
                logger.warning(f"bootstrap of {url}: no peer holds v{version} and no plane "
                               f"origin is reachable; retrying next poll")
                return False
            man = self._fetch_plane_manifest(origin, version)
        upstreams = ([origin] if origin else []) if self.cfg.join_bootstrap == "origin" \
            else holders[:3] + ([origin] if origin else [])
        payload = {"version": version, "manifest": man, "upstreams": upstreams,
                   "origin": origin, "deadline_s": self.cfg.flush_request_timeout}
        cut_total = self._cutover_timeout()

        async def _push():
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(
                    total=self.cfg.flush_request_timeout + cut_total)) as sess:
                _, ok, body = await self._post_distribute(
                    sess, url, upstreams[0] if upstreams else "", payload, None)
                if not ok:
                    return False, body
                _, ok2, body2 = await self._post_cutover(sess, url, version, None)
                return ok2, {**body, **body2}

        fut = asyncio.run_coroutine_threadsafe(_push(), self._http_loop)
        ok, body = self._await_fut(fut, self.cfg.flush_request_timeout + cut_total + 10)
        if not ok:
            logger.warning(f"plane bootstrap of {url} rejected: {body}")
            return False
        with self._lock:
            self._server_versions[url] = version
        logger.info(f"plane bootstrap of {url} to v{version}: "
                    f"{float(body.get('bytes_from_peers') or 0.0):.0f} bytes from peers, "
                    f"{float(body.get('bytes_from_origin') or 0.0):.0f} from the origin")
        return True

    def _poll_health(self):
        """Fold the health registry into the healthy/evicted split:
        heartbeat loss evicts, heartbeat return (after a weight re-sync)
        readmits; roles and drains come from the heartbeat payloads; then
        reclaim the quota slots of dead rollout workers."""
        snapshot, _ = self._registry.classified()
        alive_urls = set()
        unknown = []
        for member, record in sorted(snapshot.items()):
            url = record.get("url")
            if not url:
                continue
            old = self._member_urls.get(member)
            if old is not None and old != url and old in self.server_urls:
                # A known member beating at a new address: restarted.
                self._replace_server_url(old, url)
            elif url not in self.server_urls:
                if old is None:
                    unknown.append((member, url))
                continue
            self._member_urls[member] = url
            alive_urls.add(url)
            # The heartbeat's role, unless our sizer set this one (the
            # beat may predate the /set_role landing).
            role = record.get("role")
            if role and url not in self._rerole_orig:
                self._server_roles[url] = str(role)
            # A drain advertised through the heartbeat gets a deadline
            # too (drains this manager did not start).
            if record.get("draining") and url not in self._draining:
                with self._lock:
                    self._draining.add(url)
                    self._drain_deadline.setdefault(
                        url, time.monotonic() + self.cfg.drain_timeout_s)
        # A member never seen before, at an address outside the table:
        # if its last incarnation died before this manager saw it beat,
        # it is the restarted owner of an evicted url that no live member
        # claims; it replaces the first such url. Any other stranger is a
        # joiner beyond the launch-time fleet, which is ignored.
        for member, url in unknown:
            claimed = set(self._member_urls.values())
            dead_weight = sorted(u for u in self.server_urls
                                 if u in self._evicted and u not in claimed)
            if dead_weight:
                self._replace_server_url(dead_weight[0], url)
                self._member_urls[member] = url
                alive_urls.add(url)
        for member, url in list(self._member_urls.items()):
            if member not in snapshot and url in self._healthy:
                self._mark_unhealthy(url, f"missed heartbeats ({member})")
        # Readmission, never of a draining server: only its departure
        # (or death) ends a drain.
        for url in [u for u in list(self._evicted)
                    if u in alive_urls and u not in self._draining]:
            self._beat()
            if (self._server_versions.get(url, 0) >= self.weight_version
                    or self._bootstrap_server(url)):
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
                tracing.event("manager.reclaim", worker=member, slots=n)

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
        app.router.add_post("/drain_server", self._h_drain_server)
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
            # The breaker first: eviction clears routing state, but the
            # breaker remembers, so a server that keeps failing stays
            # unroutable through its cooldown instead of re-entering
            # rotation at every readmission.
            self._record_breaker(failed, ok=False)
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
        url, policy, decode_url, kv_source = self._route(meta)
        tracing.event(
            "manager.schedule", ctx=trace_ctx,
            server=url or "", routed=url is not None, policy=policy,
            qid=qid, kv_source=kv_source or "", version=self.weight_version,
        )
        if url is None:
            return web.json_response(
                {"error": "no healthy generation servers", "retry_after": 0.5},
                status=503,
            )
        resp = {"url": url, "version": self.weight_version, "policy": policy}
        if kv_source is not None:
            # Another server holds this session's KV: the routed server
            # pulls it over /kv/{manifest,chunk} instead of re-prefilling.
            resp["kv_source"] = kv_source
        if decode_url is not None:
            tracing.event(
                "manager.pair", ctx=trace_ctx, qid=qid, prefill=url, decode=decode_url,
                prefill_queued_tokens=self._server_queued_toks.get(url, 0.0),
                decode_free_pages=self._server_free_pages.get(decode_url, 0.0),
            )
            resp["decode_url"] = decode_url
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

    async def _h_drain_server(self, request: web.Request) -> web.Response:
        """Drain-then-leave on request: POST {"url": ...}."""
        d = await request.json()
        res = await self._initiate_drain(str(d.get("url") or ""),
                                         str(d.get("reason") or "requested"))
        return web.json_response(res, status=200 if res.get("success") else 409)

    async def _h_status(self, request: web.Request) -> web.Response:
        """The reference's /status keys for the features the port has."""
        with self._lock:
            healthy = self._healthy_urls()
            roles = {u: self._role(u) for u in self.server_urls}

            def kv_sum(key):
                return sum(v.get(key, 0.0) for v in self._server_kv.values())

            by_tier: Dict[str, int] = {}
            for ent in self._prefix_index.values():
                t = ent.get("tier", "host")
                by_tier[t] = by_tier.get(t, 0) + 1
            status = {
                "pools": {
                    "roles": roles,
                    "prefill": sorted(u for u in healthy if roles[u] != "decode"),
                    "decode": sorted(u for u in healthy if roles[u] != "prefill"),
                    "elastic": sorted(u for u in healthy if self._server_elastic.get(u, False)),
                    "queued_prompt_tokens": {
                        u: self._server_queued_toks.get(u, 0.0) for u in healthy},
                    "kv_pages_free": {u: self._server_free_pages.get(u, 0.0) for u in healthy},
                    "kv_handoff": {k: kv_sum(k) for k in (
                        "exports", "imports", "export_bytes", "import_bytes")},
                    "reroles": list(self._rerole_log),
                },
                "kv_tier": {
                    "index_entries": len(self._prefix_index),
                    "index_by_tier": by_tier,
                    "spills": kv_sum("spills"),
                    "restores": kv_sum("restores"),
                    "peer_hits": kv_sum("peer_hits"),
                    "prefix_lost": kv_sum("lost"),
                },
                "fleet": {
                    "n_members": len(self.server_urls),
                    "draining": sorted(self._draining),
                    "drains": list(self._drain_log),
                },
                "weight_version": self.weight_version,
                "rollout_stat": self.rollout_stat.as_dict(),
                # Outstanding rollout slots per worker (a port key): what a
                # dead worker's reclamation gives back.
                "worker_slots": dict(self._worker_slots),
                "servers": self.server_urls,
                "healthy_servers": healthy,
                "evicted_servers": dict(self._evicted),
                "server_versions": dict(self._server_versions),
                "load_shed": {
                    "total": sum(self._server_shed_total.values()),
                    "per_server": dict(self._server_shed_total),
                },
                "affinity_entries": len(self._affinity),
                # This process's areal:rpc_* counters and the breaker
                # board routing consults: an "open" entry is why a
                # healthy-looking server takes no traffic.
                "rpc": {
                    "stats": rpc.stats.snapshot(),
                    "breakers": self.breakers.snapshot(),
                    "open": self.breakers.open_peers(),
                },
                # The last tree fanout: per-server transfer and cutover
                # ms, the tree, and its evictions. Empty when the plane
                # is off.
                "weight_plane": dict(self._wp_last),
            }
        return web.json_response(status)

    # ------------------------------------------------------------------
    # Drain-then-leave
    # ------------------------------------------------------------------

    def _drain_server_sync(self, url: str, reason: str) -> bool:
        """Poll-thread entry to the drain (the POST runs on the HTTP loop)."""
        fut = asyncio.run_coroutine_threadsafe(self._initiate_drain(url, reason),
                                               self._http_loop)
        try:
            return bool(fut.result(timeout=30).get("success"))
        except Exception:
            logger.warning(f"drain initiation for {url} failed", exc_info=True)
            return False

    async def _initiate_drain(self, url: str, reason: str) -> Dict:
        """Stop routing to the server now (its running work finishes, its
        KV stays pullable), then ask it to migrate its prefixes to the
        other routable servers over the /kv wire and leave. A drain that
        never completes is evicted by the deadline sweep in _poll."""
        with self._lock:
            if url not in self.server_urls or url not in self._healthy:
                return {"success": False, "error": f"{url} is not healthy"}
            if url in self._draining:
                return {"success": False, "error": f"{url} is already draining"}
            migrate = [u for u in self._healthy_urls() if u != url]
            if not migrate:
                return {"success": False, "error": "cannot drain the last routable server"}
            self._draining.add(url)
            self._drain_deadline[url] = time.monotonic() + self.cfg.drain_timeout_s
        try:
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=15)) as sess:
                async with sess.post(f"{url}/drain", json={
                        "migrate_to": migrate, "exit": True, "reason": reason}) as r:
                    body = await r.json()
            ok = bool(body.get("success"))
        except Exception as e:
            ok, body = False, {"error": repr(e)}
        if not ok:
            with self._lock:
                self._draining.discard(url)
                self._drain_deadline.pop(url, None)
            return {"success": False, "error": f"drain request failed: {body}"}
        with self._lock:
            self._drain_log.append({"t": time.time(), "url": url, "reason": reason,
                                    "status": "draining"})
            del self._drain_log[:-32]
        tracing.event("manager.drain", server=url, reason=reason)
        logger.info(f"draining {url}: {reason} (migrating KV to {len(migrate)} peer(s))")
        return {"success": True, "migrate_to": migrate}

    def _sweep_expired_drains(self):
        """Evict drains past drain_timeout_s. A drain cannot be cancelled
        server-side (the server sheds everything until it leaves), so the
        server stays marked draining: readmission must skip it."""
        now = time.monotonic()
        with self._lock:
            expired = [u for u, d in self._drain_deadline.items()
                       if now > d and u in self.server_urls]
            for u in expired:
                self._healthy.discard(u)
                self._evicted[u] = "drain timed out; awaiting departure"
                self._forget_server(u)
                self._draining.add(u)
        for u in expired:
            logger.warning(f"drain of {u} exceeded drain_timeout_s; evicted while it "
                           f"finishes quiescing")

    # ------------------------------------------------------------------
    # Elastic pool sizing (re-roles)
    # ------------------------------------------------------------------

    def _post_set_role(self, url: str, role: str) -> bool:
        async def _push():
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=15)) as sess:
                async with sess.post(f"{url}/set_role", json={"role": role}) as r:
                    body = await r.json()
                    return bool(body.get("success"))

        try:
            fut = asyncio.run_coroutine_threadsafe(_push(), self._http_loop)
            return fut.result(timeout=20)
        except Exception:
            logger.warning(f"set_role({role}) failed for {url}", exc_info=True)
            return False

    def _rerole(self, url: str, to_role: str, reason: str) -> bool:
        """Flip one elastic server's pool. Routing flips first (under the
        lock) so no new work of the old kind lands; running requests
        finish as they are; weights stay resident."""
        with self._lock:
            from_role = self._server_roles.get(url, "unified")
            if from_role == to_role:
                return False
            self._rerole_orig.setdefault(url, from_role)
            self._server_roles[url] = to_role
        if not self._post_set_role(url, to_role):
            with self._lock:  # unreachable: roll the map back
                self._server_roles[url] = from_role
                if self._rerole_orig.get(url) == from_role:
                    self._rerole_orig.pop(url, None)
            return False
        if to_role == self._rerole_orig.get(url):
            self._rerole_orig.pop(url, None)  # the flip-back completed
        with self._lock:
            self._rerole_log.append({"t": time.time(), "url": url, "from": from_role,
                                     "to": to_role, "reason": reason})
            del self._rerole_log[:-32]
        self._last_rerole = time.monotonic()
        tracing.event("manager.rerole", server=url, from_role=from_role, to_role=to_role,
                      reason=reason)
        logger.info(f"re-roled {url}: {from_role} -> {to_role} ({reason})")
        return True

    def _maybe_rerole(self):
        """Watermark-driven pool sizing over the elastic (configured
        "unified") servers: prefill queue pressure pulls a server out of
        the decode pool; a drained prefill queue (or a decode free-page
        floor breach) sends it back."""
        cfg = self.cfg
        if not cfg.elastic_pools:
            return
        if time.monotonic() - self._last_rerole < cfg.rerole_cooldown_s:
            return
        with self._lock:
            healthy = self._healthy_urls()
            roles = {u: self._server_roles.get(u, "unified") for u in healthy}
            elastic = {u for u in healthy if self._server_elastic.get(u, False)}
            queued = dict(self._server_queued_toks)
            free = dict(self._server_free_pages)
            total = dict(self._server_total_pages)
            flipped = {u: orig for u, orig in self._rerole_orig.items() if u in healthy}
        if not healthy:
            return
        prefill_pool = [u for u in healthy if roles[u] != "decode"]
        decode_pool = [u for u in healthy if roles[u] != "prefill"]
        prefill_queue = sum(queued.get(u, 0.0) for u in prefill_pool)
        dec_free = sum(free.get(u, 0.0) for u in decode_pool)
        dec_total = sum(total.get(u, 0.0) for u in decode_pool)
        dec_free_frac = dec_free / dec_total if dec_total > 0 else 1.0

        if (prefill_queue >= cfg.prefill_queue_high_tokens
                and dec_free_frac >= cfg.decode_free_page_min_frac):
            # Prompts queue: grow the prefill pool from elastic decode-side
            # servers (most free pages first), keeping the decode floor.
            cands = [u for u in decode_pool if u in elastic and roles[u] != "prefill"
                     and len(decode_pool) - 1 >= cfg.pool_min_decode]
            if cands:
                u = max(cands, key=lambda c: free.get(c, 0.0))
                self._rerole(u, "prefill", f"prefill queue {prefill_queue:.0f} tokens >= "
                                           f"{cfg.prefill_queue_high_tokens}")
            return
        if dec_free_frac < cfg.decode_free_page_min_frac:
            # The decode pool starves for pages: pull an elastic prefill
            # server back in.
            cands = [u for u in prefill_pool if u in elastic and roles[u] != "decode"
                     and len(prefill_pool) - 1 >= cfg.pool_min_prefill]
            if cands:
                u = min(cands, key=lambda c: queued.get(c, 0.0))
                self._rerole(u, "decode", f"decode free pages {dec_free_frac:.2f} < "
                                          f"{cfg.decode_free_page_min_frac}")
            return
        if prefill_queue <= cfg.prefill_queue_low_tokens and flipped:
            # Pressure gone: return a flipped server to its pool.
            for u, orig in sorted(flipped.items()):
                if roles.get(u) != orig:
                    if self._rerole(u, orig, f"prefill queue {prefill_queue:.0f} tokens <= "
                                             f"{cfg.prefill_queue_low_tokens}"):
                        return

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
        failed ones are evicted (they re-sync on readmission). With the
        weight plane armed this is the tree fanout instead."""
        origin = self._weight_plane_origin(path)
        if origin is not None:
            return self._plane_update_weights(origin)
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

    # ------------------------------------------------------------------
    # Weight-distribution plane (system/weight_plane.py)
    # ------------------------------------------------------------------

    def _cutover_timeout(self) -> float:
        """A client timeout above the server's own cutover timeout
        (max(120, budget * 10)): timing out first would evict a server
        whose slow cutover already serves the new version."""
        return max(self.cfg.flush_request_timeout, 120.0,
                   self.cfg.weight_cutover_budget_s * 10.0) + 10

    def _weight_plane_origin(self, path: Optional[str]) -> Optional[str]:
        """The plane's origin URL, or None when the plane is off: the
        trainer-side source registered in name_resolve while it answers,
        else a source this manager starts over the dump dir ``path`` (one
        read of the dump here instead of one per server). The fallback
        also covers the trainer's exit: the last version, which this
        manager fans out after the trial completes, outlives its source,
        so that fanout always takes the fallback."""
        import urllib.error
        import urllib.request

        if not self.cfg.weight_plane:
            return None
        if not self._trainer_source_gone:
            try:
                url = name_resolve.get(names.weight_plane_source(
                    self.cfg.experiment_name, self.cfg.trial_name, self.cfg.model_name))
                with urllib.request.urlopen(f"{url}/weights/stats", timeout=5.0):
                    return url
            except urllib.error.HTTPError:
                return url  # it answers
            except (name_resolve.NameEntryNotFoundError, OSError):
                pass
        if self._own_source is None:
            if path is None:
                return None  # no source and no dump: peers only
            from areal_tpu_torch.system.weight_plane import WeightPlaneSource

            self._own_source = WeightPlaneSource(
                path, chunk_bytes=self.cfg.weight_chunk_bytes, host=network.gethostip()).start()
            logger.info(f"weight plane: no trainer-side source registered for "
                        f"{self.cfg.model_name!r}; manager-hosted origin at "
                        f"{self._own_source.address} over {path}")
        return self._own_source.address

    def _fetch_plane_manifest(self, origin: str, version: int) -> Dict:
        """The pinned-version manifest from the origin, retried briefly
        (the version's publication can race the dump). With
        ``weight_wire_dtype`` armed it asks for that stream; a definitive
        404 for it, with the raw stream of the version there, proves the
        dump has no such wire, and the raw stream is used instead."""
        import urllib.error

        from areal_tpu_torch.engine.weight_client import fetch_manifest

        wire = self.cfg.weight_wire_dtype
        deadline = time.monotonic() + 15.0
        while True:
            try:
                return fetch_manifest(origin, version=version, timeout=5.0, wire=wire)
            except Exception as e:
                if (wire is not None and isinstance(e, urllib.error.HTTPError)
                        and e.code == 404):
                    try:
                        man = fetch_manifest(origin, version=version, timeout=5.0)
                        logger.warning(f"weight plane: no {wire!r}-wire stream for "
                                       f"v{version}; falling back to the raw wire")
                        return man
                    except Exception:
                        pass  # the dump is still landing: retry the wire
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    async def _post_distribute(self, sess, url, parent, payload, span):
        edge_span = tracing.start_span("manager.weight_update.fetch",
                                       ctx=span.ctx if span else None, server=url,
                                       parent=parent)
        try:
            # The hop inherits the wave's budget as its deadline.
            dl = rpc.Deadline.after(self.cfg.flush_request_timeout)
            async with sess.post(
                    f"{url}/distribute_weights", headers=dl.headers(),
                    json=tracing.inject_ctx_into(
                        dict(payload),
                        edge_span.ctx if edge_span else (span.ctx if span else None))) as r:
                body = await r.json()
            ok = bool(body.get("success"))
        except Exception as e:
            ok, body = False, {"error": repr(e)}
        self._record_breaker(url, ok=ok)
        if edge_span is not None:
            edge_span.end(ok=ok, transfer_ms=float(body.get("transfer_ms") or 0.0),
                          verify_ms=float(body.get("verify_ms") or 0.0))
        return url, ok, body

    async def _post_cutover(self, sess, url, version, span):
        cut_span = tracing.start_span("manager.weight_update.cutover",
                                      ctx=span.ctx if span else None, server=url)
        try:
            dl = rpc.Deadline.after(self.cfg.flush_request_timeout)
            async with sess.post(
                    f"{url}/cutover_weights", headers=dl.headers(),
                    json=tracing.inject_ctx_into(
                        {"version": version, "allow_interrupt": True,
                         "budget_s": self.cfg.weight_cutover_budget_s},
                        cut_span.ctx if cut_span else (span.ctx if span else None))) as r:
                body = await r.json()
            ok = bool(body.get("success"))
        except Exception as e:
            ok, body = False, {"error": repr(e)}
        self._record_breaker(url, ok=ok)
        if cut_span is not None:
            cut_span.end(ok=ok, cutover_ms=float(body.get("cutover_ms") or 0.0),
                         within_budget=bool(body.get("within_budget", True)))
        return url, ok, body

    def _plane_update_weights(self, origin: str):
        """Tree fanout over the plane, wave by wave. An edge whose planned
        parent failed is re-parented onto a server that holds the version
        (the origin last), so a dead peer costs its subtree a hop, not an
        origin upload. Once the transfer is done every holder cuts over at
        once: one short interrupt window a server, measured apart from
        the transfer."""
        from areal_tpu_torch.system.weight_plane import plan_fanout

        faults.maybe_fail("manager.plane_fanout")
        t_start = time.monotonic()
        version = self._new_version
        targets = self._healthy_urls()
        if not targets:
            raise RuntimeError("weight-plane fanout: no healthy generation servers")
        fanout_span = tracing.start_span("manager.weight_update", version=version,
                                         n_targets=len(targets), plane=True)
        successes: List[str] = []
        failures: Dict[str, str] = {}
        transfer_ms: Dict[str, float] = {}
        cutover_ms: Dict[str, float] = {}
        ready: List[str] = []
        try:
            man = self._fetch_plane_manifest(origin, version)
            waves = plan_fanout(origin, targets, self.cfg.weight_fanout_degree)

            async def _run_wave(wave):
                # Headroom over the servers' fetch deadline (deadline_s): a
                # transfer that ends just inside it must not be timed out
                # here and its ready server evicted.
                async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(
                        total=self.cfg.flush_request_timeout + 10)) as sess:
                    tasks = []
                    for url, parent in wave:
                        eff = parent
                        if eff != origin and eff not in ready:
                            eff = ready[0] if ready else origin
                        upstreams = ([eff] + [u for u in ready if u != eff][:2]
                                     + ([origin] if eff != origin else []))
                        tasks.append(self._post_distribute(
                            sess, url, eff,
                            {"version": version, "manifest": man, "upstreams": upstreams,
                             "origin": origin, "deadline_s": self.cfg.flush_request_timeout},
                            fanout_span))
                    return await asyncio.gather(*tasks)

            for wave in waves:
                self._beat()  # a wave can take a whole transfer
                fut = asyncio.run_coroutine_threadsafe(_run_wave(wave), self._http_loop)
                for url, ok, body in self._await_fut(fut, self.cfg.flush_request_timeout + 20):
                    if ok:
                        ready.append(url)
                        transfer_ms[url] = float(body.get("transfer_ms") or 0.0)
                    else:
                        failures[url] = f"prefetch failed: {body}"
            if not ready:
                raise RuntimeError(f"weight plane v{version}: no server prefetched: {failures}")
            cut_total = self._cutover_timeout()

            async def _run_cutovers():
                async with aiohttp.ClientSession(
                        timeout=aiohttp.ClientTimeout(total=cut_total)) as sess:
                    return await asyncio.gather(*[
                        self._post_cutover(sess, u, version, fanout_span) for u in ready])

            self._beat()
            fut = asyncio.run_coroutine_threadsafe(_run_cutovers(), self._http_loop)
            for url, ok, body in self._await_fut(fut, cut_total + 10):
                if ok:
                    successes.append(url)
                    cutover_ms[url] = float(body.get("cutover_ms") or 0.0)
                else:
                    failures[url] = f"cutover failed: {body}"
            if not successes:
                raise RuntimeError(f"weight plane v{version}: no server cut over: {failures}")
        finally:
            if fanout_span is not None:
                fanout_span.end(n_success=len(successes), n_failed=len(failures))
        for u, reason in failures.items():
            self._mark_unhealthy(u, f"weight plane: {reason}")
        with self._lock:
            self.weight_version = version
            for u in successes:
                self._server_versions[u] = version
            self.last_weight_sync_s = time.monotonic() - t_start
            self._wp_last = {
                "version": version,
                "model": self.cfg.model_name,
                "origin": origin,
                "tree": [[[u, p] for u, p in w] for w in waves],
                "total_bytes": int(man["total_bytes"]),
                "n_chunks": int(man["n_chunks"]),
                "wire": man.get("wire", "raw"),
                "groups": {"0/1": {"servers": list(targets),
                                   "shard_bytes": int(man["total_bytes"]),
                                   "n_chunks": int(man["n_chunks"])}},
                "transfer_ms": dict(transfer_ms),
                "cutover_ms": dict(cutover_ms),
                "failures": dict(failures),
                "sync_s": self.last_weight_sync_s,
            }
        (logger.warning if failures else logger.info)(
            f"weight plane v{version}: {len(successes)}/{len(targets)} servers in "
            f"{self.last_weight_sync_s:.3f}s (transfer max "
            f"{max(transfer_ms.values(), default=0):.1f}ms, cutover max "
            f"{max(cutover_ms.values(), default=0):.1f}ms"
            + (f"; evicted {sorted(failures)}" if failures else "") + ")")

    def _last_fanout(self):
        """At COMPLETE, fan out a version the trainer published after
        this manager's last poll, so the fleet ends on the trained
        weights (the servers outlive COMPLETE until this manager
        stops)."""
        path = self.check_new_params()
        if path is None:
            return
        # A trainer source that still answers a probe may close before the
        # servers pull from it.
        self._trainer_source_gone = True
        try:
            self.flush_requests_and_update_weights(path)
        except Exception:
            logger.warning("last weight-update fanout failed", exc_info=True)

    async def _poll_metrics(self):
        """Fold each live server's /metrics into the routing loads, the
        pool signals and the throughput counter, and its /kv/index into
        the global prefix index. Draining servers are polled too: their
        prefixes stay pullable until they leave."""
        kv_keys = {
            "areal:kv_export_total": "exports", "areal:kv_export_bytes": "export_bytes",
            "areal:kv_import_total": "imports", "areal:kv_import_bytes": "import_bytes",
            "areal:last_kv_transfer_ms": "last_transfer_ms",
            "areal:kv_spill_total": "spills", "areal:kv_restore_total": "restores",
            "areal:kv_prefix_lost_total": "lost", "areal:kv_tier_peer_hits": "peer_hits",
        }
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=5)) as sess:
            for u in self._live_urls():
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
                        elif name == "areal:spec_emitted_tokens":
                            self._server_spec_emitted[u] = float(val)
                        elif name == "areal:spec_active_steps":
                            self._server_spec_steps[u] = float(val)
                        elif name == "areal:queued_prompt_tokens":
                            self._server_queued_toks[u] = float(val)
                        elif name == "areal:kv_pages_free":
                            self._server_free_pages[u] = float(val)
                        elif name == "areal:kv_pages_total":
                            self._server_total_pages[u] = float(val)
                        elif name == "areal:role":
                            # The sizer's view wins for a server it
                            # re-roled until the server's surface catches up.
                            if u not in self._rerole_orig or val == self._server_roles.get(u):
                                self._server_roles[u] = val
                        elif name == "areal:elastic":
                            self._server_elastic[u] = float(val) > 0.5
                        elif name in kv_keys:
                            self._server_kv.setdefault(u, {})[kv_keys[name]] = float(val)
                    if self._kv_index_size:
                        await self._poll_kv_index(sess, u)
                    # A served /metrics clears stray strikes on a CLOSED
                    # breaker only: a wedged engine whose HTTP thread still
                    # answers /metrics must not close a tripped one (that
                    # takes a fanout or cutover success, or the removal).
                    br = self.breakers.breaker(u)
                    if br.state() == rpc.STATE_CLOSED:
                        br.record_success()
                except Exception:
                    self._record_breaker(u, ok=False)
                    logger.warning(f"metrics poll failed for {u}")

    async def _poll_kv_index(self, sess, u: str):
        """Fold one server's /kv/index into the global prefix index:
        entries it holds point at it, entries it stopped advertising are
        dropped if they still pointed at it, the map stays LRU-bounded."""
        try:
            async with sess.get(f"{u}/kv/index") as r:
                if r.status != 200:
                    return
                body = await r.json()
        except Exception:
            return
        held = body.get("held") or []
        with self._lock:
            prev = self._server_kv_index.get(u) or set()
            now_qids = set()
            for e in held:
                qid = str(e.get("qid") or "")
                if not qid:
                    continue
                now_qids.add(qid)
                self._prefix_index.pop(qid, None)
                self._prefix_index[qid] = {
                    "url": u,
                    "tier": str(e.get("tier") or "host"),
                    "n_tokens": int(e.get("n_tokens") or 0),
                    "version": int(e.get("version", -1)),
                }
            for qid in prev - now_qids:
                ent = self._prefix_index.get(qid)
                if ent is not None and ent.get("url") == u:
                    self._prefix_index.pop(qid, None)
            self._server_kv_index[u] = now_qids
            while len(self._prefix_index) > self._kv_index_size:
                old_qid, old_ent = self._prefix_index.popitem(last=False)
                s = self._server_kv_index.get(old_ent.get("url"))
                if s is not None:
                    s.discard(old_qid)

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
        self._sweep_expired_drains()
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
            # Pool sizing rides the fresh load snapshot.
            try:
                self._maybe_rerole()
            except Exception:
                logger.warning("elastic rerole pass failed", exc_info=True)
        now = time.monotonic()
        if now - self._last_throughput_log > self._throughput_log_interval:
            self._log_throughput(now)
        time.sleep(0.05)
        return PollResult(batch_count=0)

    def _log_throughput(self, now: float):
        """The periodic generation-throughput log: interval tokens/s over
        all servers, the rollout counters and, when any server speculates,
        the fleet's speculation yield (total emitted tokens over total
        active decode steps, so busy servers weigh in proportionally)."""
        total_gen = sum(self._server_gen_totals.values())
        dt = now - self._last_throughput_log
        tps = max(0.0, total_gen - self._last_gen_total) / dt
        with self._lock:
            rs = self.rollout_stat.as_dict()
        steps = sum(self._server_spec_steps.values())
        logger.info(
            f"generation throughput: {tps:.0f} tokens/s (total {total_gen:.0f}) "
            f"rollouts={rs} weight_version={self.weight_version}"
            + (f" spec_tokens_per_step={sum(self._server_spec_emitted.values()) / steps:.2f}"
               if steps > 0 else ""))
        self._last_gen_total = total_gen
        self._last_throughput_log = now

    def _exit_hook(self):
        try:
            if getattr(self, "_own_source", None) is not None:
                self._own_source.close()
            self._http_loop.call_soon_threadsafe(self._http_loop.stop)
            self._http_thread.join(timeout=5)
        except Exception:
            pass
