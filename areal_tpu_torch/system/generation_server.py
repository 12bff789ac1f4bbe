"""Generation server worker: the port's ServingEngine behind HTTP (the
counterpart of ``areal_tpu/system/generation_server.py``).

The wire contract is the reference's, so rollout workers and a gserver
manager reach a port server exactly as they reach a reference one:

- ``POST /generate`` ``{qid, input_ids, gconfig, priority}`` -> token-in,
  token-out with logprobs and version stamps; an expired
  ``X-Areal-Deadline`` and admission shedding answer 429 with
  ``Retry-After``, a dead engine loop 500;
- ``POST /update_weights_from_disk`` ``{model_path, allow_interrupt,
  version}``: raw dump (tmpfs, then disk) or pickle, with the stale
  short-cut for a version already staged;
- ``POST /configure``: the admission watermarks, and the chaos keys when
  ``AREAL_CHAOS_HTTP`` armed them at boot;
- ``GET /metrics``: every line of the reference, in its order and
  format; lines of features the port lacks print what a reference server
  with those features off prints;
- ``GET /health``;
- disaggregated serving: a ``/generate`` body whose ``decode_url`` names
  another server runs the prefill leg to the first token here, exports
  the KV (``areal-kv-handoff/v1``) and posts it to that server's
  ``POST /kv_handoff``, which pulls the blob from ``GET
  /kv_handoff/blob`` (per-chunk sha256, ``Range`` resume), imports it and
  runs the decode stream; on any failure the request is finished here
  (``kv_handoff_fallback``);
- the tiered KV plane: a ``/generate`` for a prefix this server spilled
  restores it from its tier first, and one carrying ``kv_source`` pulls
  it from that peer over ``GET /kv/manifest`` and ``/kv/chunk``; ``GET
  /kv/index`` advertises the held prefixes to the manager's index;
- drain-then-leave: ``POST /drain`` sheds new work, waits out the
  running requests, migrates the parked and tiered prefixes to the
  given peers (their ``POST /kv/accept`` pulls each one into their tier),
  deregisters and exits with code 0; ``GET /drain`` reports progress;
- ``POST /set_role`` flips the live pool role.

HTTP runs on the standard library's ``ThreadingHTTPServer`` (HTTP/1.1,
``Content-Length`` on every response, the JSON content type aiohttp's
``json_response`` sends), one thread a request. A ``/generate`` thread
does no device work: it submits to the engine and waits for the
request's ``done_cb``; a weight update loads and stages on its own
request thread while the engine loop keeps decoding, and so does a
plane fetch, which holds its request thread for the whole transfer while
other threads serve its verified chunks. The reference's async handlers
become blocking ones on the request's thread; its peer client is
``urllib``; the drain runs on a thread of its own.

- the weight-distribution plane (system/weight_plane.py): ``POST
  /distribute_weights`` ``{version, manifest, upstreams, origin}``
  prefetches a version's chunk stream into a host ChunkStore while the
  current version keeps serving, and returns once it is complete and
  verified (a duplicate joins the fetch in flight; an older version is
  refused); ``POST /cutover_weights`` ``{version, budget_s}`` swaps to
  it (``ServingEngine.cutover_params``) and reports the window against
  the budget; ``GET /weights/manifest`` and ``/weights/chunk`` serve the
  held store to sibling servers, during the fetch too.

Not ported yet (refused at boot when configured): tensor parallelism
and weight shards (with them the plane's shard streams), speculative
decoding, int8 decode weights. The server serves an HF checkpoint
(``model_path``) in its compute dtype and takes its EOS from the
tokenizer (``tokenizer_path``, else the checkpoint's); a weight update
from a directory that holds no raw dump or pickle reads it as an HF
checkpoint (``"source": "hf"``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional, Tuple

from areal_tpu_torch import kernels
from areal_tpu_torch.api import data_api
from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.api.system_api import GenerationServerConfig
from areal_tpu_torch.base import (
    constants, env_registry, health, logging, name_resolve, names, network, rpc, seeding,
    tracing)
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.base.chunking import chunk_spans, verify_chunk
from areal_tpu_torch.base.latency import encode_counts
from areal_tpu_torch.base.wire_schemas import KV_TIER_V1
from areal_tpu_torch.engine.kv_handoff import KVHandoffError, KVHandoffVersionMismatch
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.engine.weight_client import ChunkStore, assemble_params
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.system.weight_plane import (
    serve_store_chunk, serve_store_manifest, write_response)
from areal_tpu_torch.system.worker_base import (  # noqa: F401 (exit_record_path)
    PollResult, Worker, exit_record_path, write_exit_record,
)

logger = logging.getLogger("generation_server")

# Longest a server outlives its trial's COMPLETE while the gserver
# manager is still fanning the last trained version out.
LAST_FANOUT_WAIT_S = 120.0

# (status, body, content type, extra headers)
Response = Tuple[int, bytes, str, Dict[str, str]]


def _json(payload: Any, status: int = 200, headers: Optional[Dict[str, str]] = None) -> Response:
    # aiohttp's json_response: json.dumps with default separators.
    return status, json.dumps(payload).encode(), "application/json; charset=utf-8", headers or {}


def _text(text: str, status: int = 200) -> Response:
    return status, text.encode(), "text/plain; charset=utf-8", {}


def _bytes(data: bytes, status: int = 200, headers: Optional[Dict[str, str]] = None) -> Response:
    return status, data, "application/octet-stream", headers or {}


def http_request(url: str, payload: Any = None, headers: Optional[Dict[str, str]] = None,
                 timeout: float = 600.0) -> Tuple[int, Dict[str, str], bytes]:
    """(status, headers, body) of one request to a peer: a JSON POST when
    ``payload`` is given, else a GET. A non-2xx answer returns its status
    (no exception); a connection failure raises OSError."""
    data = None if payload is None else json.dumps(payload).encode()
    hdrs = dict(headers or {})
    if data is not None:
        hdrs.setdefault("Content-Type", "application/json")
    req = urllib.request.Request(url, data, hdrs)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers or {}), e.read()


def make_model(model: ModelAbstraction, seed: int, device, model_path: Optional[str] = None):
    """(TransformerConfig, params) of a ``tpu_transformer`` abstraction:
    from the HF checkpoint at ``model_path`` (the config's, else the
    abstraction's ``model_path``), its params cast to the compute dtype
    the engine serves in; else ``args["config"]`` holds TransformerConfig
    fields and the params are random, drawn from ``seed``."""
    if model is None or model.type_ != "tpu_transformer":
        raise ValueError(f"unknown model {model!r}: the port builds 'tpu_transformer'")
    args = dict(model.args)
    is_critic = bool(args.get("is_critic", False))
    model_path = model_path or args.get("model_path")
    if model_path is not None:
        from areal_tpu_torch import torch_dtype
        from areal_tpu_torch.models.hf import load_hf_model

        cfg, params = load_hf_model(model_path, is_critic=is_critic,
                                    family=args.get("hf_family"))
        dtype = torch_dtype(cfg.compute_dtype)
        return cfg, _cast_tree(params, dtype)
    cfg = TransformerConfig(**{**args["config"], "is_critic": is_critic})
    return cfg, init_params(cfg, seed=seed, device=device)


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _refuse_unported(config: GenerationServerConfig):
    """Fail at boot on any option whose feature the port lacks, rather
    than serve without it."""
    if config.role not in ("unified", "prefill", "decode"):
        raise ValueError(f"role must be unified/prefill/decode, got {config.role!r}")
    refused = {
        "tensor_parallel": config.tensor_parallel > 1,
        "weight_shard_rank": config.weight_shard_rank is not None,
        "weight_shard_degree": config.weight_shard_degree is not None,
        "speculative_draft_len": config.speculative_draft_len > 0,
        "decode_weight_dtype": config.decode_weight_dtype not in (None, "model"),
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            f"the port's generation server does not support {bad} yet "
            f"(ROADMAP Queue A): leave them at their defaults")


class GenerationServer(Worker):
    def _configure(self, config: GenerationServerConfig):
        _refuse_unported(config)
        self.cfg = config
        constants.set_experiment_trial_names(config.experiment_name, config.trial_name)
        seeding.set_random_seed(config.seed, config.worker_name)
        model_cfg, params = make_model(config.model, config.seed, config.device,
                                       config.model_path)
        # The tokenizer gives the engine its EOS; it is the named one, else
        # the HF checkpoint's own, as the reference's model factory reads.
        args = config.model.args
        tokenizer_path = (config.tokenizer_path or args.get("tokenizer_path")
                          or config.model_path or args.get("model_path"))
        self.tokenizer = (data_api.load_hf_tokenizer(tokenizer_path)
                          if tokenizer_path else None)
        eos = self.tokenizer.eos_token_id if self.tokenizer else None
        self.engine = ServingEngine(
            cfg=model_cfg,
            params=params,
            max_batch_size=config.max_concurrent_requests,
            max_seq_len=config.max_seq_len,
            decode_block_steps=config.decode_block_steps,
            eos_token_id=eos,
            seed=config.seed + config.server_index,
            page_size=config.kv_page_size,
            kv_pool_tokens=config.kv_pool_tokens,
            prefill_max_batch=config.prefill_max_batch,
            prefill_chunk=config.prefill_chunk,
            chunked_prefill_per_lap=config.chunked_prefill_per_lap,
            prefix_cache_tokens=config.prefix_cache_tokens,
            kv_cache_dtype=config.kv_cache_dtype,
            prefill_token_budget=config.prefill_token_budget,
            decode_blocks_per_admit=config.decode_blocks_per_admit,
            kv_tier_bytes=config.kv_tier_bytes,
            kv_tier_disk_dir=config.kv_tier_disk_dir,
            kv_tier_disk_bytes=config.kv_tier_disk_bytes,
            kv_spill_dtype=config.kv_spill_dtype,
            device=config.device,
        )
        del params
        self.engine.start()
        if config.warm_on_start:
            # Warm before discovery registration below.
            self.engine.warm([config.prompt_bucket])
        # Live pool role: the manager's sizer re-roles "unified"-
        # configured servers at runtime through /set_role.
        self.role = config.role
        self._role_lock = threading.Lock()
        self._counter_lock = threading.Lock()
        self._n_interrupted = 0
        self._n_shed = 0
        self._last_load_info = None
        self._complete_at: Optional[float] = None
        # Drain-then-leave: once draining, /generate sheds every request,
        # running work finishes, parked prefixes migrate to peers, and
        # the worker departs with a graceful heartbeat stop. The drain
        # thread alone writes _drain_state.
        self._draining = False
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_state: Dict[str, Any] = {
            "draining": False, "done": False, "held": 0, "migrated": 0,
            "lost": 0, "stale_dropped": 0, "drain_ms": 0.0, "reason": "",
        }
        self._kv_accepted = 0
        self._kv_accept_bytes = 0
        # Exported blobs the decode servers pull: qid -> (meta, payload, t).
        self._handoff_store: "collections.OrderedDict[str, tuple]" = collections.OrderedDict()
        self._handoff_ok = 0
        self._handoff_failed = 0
        self._handoff_fallback = 0
        self._last_handoff_ms = 0.0
        self._last_kv_transfer_ms = 0.0
        # Tiered KV plane: peer pulls of prefixes the manager's index
        # names, and what this server serves to peers.
        self._kv_peer_hits = 0
        self._kv_peer_bytes = 0
        self._kv_peer_failed = 0
        self._last_kv_restore_ms = 0.0
        self._kv_manifests_served = 0
        self._kv_chunks_served = 0
        self._kv_chunk_bytes_served = 0
        # Weight-plane prefetch state: idle -> fetching -> ready (or
        # failed). The store outlives its cutover, so this server keeps
        # serving chunks to later-wave siblings and re-fanouts; a newer
        # /distribute_weights replaces it.
        self._wp_lock = threading.Lock()
        self._wp_store: Any = None
        self._wp_state = "idle"
        self._wp_transfer_ms = 0.0
        self._wp_verify_ms = 0.0
        self._wp_cutover_ms = 0.0
        self._wp_bytes_from_origin = 0
        self._wp_bytes_from_peers = 0
        self._wp_chunks_served = 0
        self._wp_bytes_served = 0
        self._wp_expected_bytes = 0
        self._wp_ingress_eq = 0.0
        self._wp_wire = "raw"
        self._launches_at_cutover: Dict[str, int] = {}

        self._routes: Dict[str, Dict[str, Callable[..., Response]]] = {
            "/generate": {"POST": self._h_generate},
            "/kv_handoff": {"POST": self._h_kv_handoff},
            "/kv_handoff/blob": {"GET": self._h_kv_blob},
            "/kv/manifest": {"GET": self._h_kv_manifest},
            "/kv/chunk": {"GET": self._h_kv_chunk},
            "/kv/index": {"GET": self._h_kv_index},
            "/kv/accept": {"POST": self._h_kv_accept},
            "/drain": {"POST": self._h_drain, "GET": self._h_drain_status},
            "/set_role": {"POST": self._h_set_role},
            "/configure": {"POST": self._h_configure},
            "/update_weights_from_disk": {"POST": self._h_update_weights},
            "/distribute_weights": {"POST": self._h_distribute_weights},
            "/cutover_weights": {"POST": self._h_cutover_weights},
            "/weights/manifest": {"GET": self._h_weights_manifest},
            "/weights/chunk": {"GET": self._h_weights_chunk},
            "/metrics": {"GET": self._h_metrics},
            "/health": {"GET": self._h_health},
        }
        host = network.gethostip()
        self._httpd = network.OwnedHTTPServer((host, 0), self)
        self.address = f"http://{host}:{self._httpd.server_address[1]}"
        self._http_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._http_thread.start()

        # Register for discovery.
        name_resolve.add_subentry(
            names.gen_servers(config.experiment_name, config.trial_name), self.address)
        name_resolve.add(
            names.gen_server_url(config.experiment_name, config.trial_name,
                                 str(config.server_index)),
            self.address, keepalive_ttl=60, replace=True,
        )
        logger.info(f"generation server {config.server_index} at {self.address}")

    def _heartbeat_payload(self):
        payload = super()._heartbeat_payload()
        payload["url"] = self.address
        payload["server_index"] = self.cfg.server_index
        payload["role"] = self.role
        if self.cfg.model_id:
            payload["model_id"] = self.cfg.model_id
        # The drain flag rides the heartbeat so a restarted manager learns
        # of it without asking.
        payload["draining"] = bool(self._draining)
        return payload

    # ------------------------------------------------------------------
    # HTTP
    # ------------------------------------------------------------------

    def _dispatch(self, handler: BaseHTTPRequestHandler, method: str):
        """Route one request and write its response (on the request's
        own thread). Unknown paths answer 404, a known path with another
        method 405, and a handler's exception 500, as aiohttp does.
        Handlers take (headers, body, query)."""
        length = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(length) if length else b""
        parts = urllib.parse.urlsplit(handler.path)
        query = dict(urllib.parse.parse_qsl(parts.query))
        methods = self._routes.get(parts.path)
        extra: Dict[str, str] = {}
        if methods is None:
            resp = _text("404: Not Found", 404)
        elif method not in methods:
            resp = _text("405: Method Not Allowed", 405)
            extra = {"Allow": ",".join(sorted(methods))}
        else:
            try:
                resp = methods[method](handler.headers, body, query)
            except Exception:
                logger.exception(f"error handling {method} {handler.path}")
                resp = _text("500 Internal Server Error\n\nServer got itself in trouble", 500)
        write_response(handler, resp, extra)

    def _admission_overloaded(self) -> Optional[float]:
        """Backpressure watermark check: the Retry-After seconds when
        /generate must shed, None when the request may queue. Reads only
        host counters the engine maintains (no device sync)."""
        cfg = self.cfg
        if self._draining:
            # Quiesce: stragglers (in-flight schedule decisions, stale
            # affinity) are shed and retry elsewhere.
            return cfg.shed_retry_after_s
        depth_wm = cfg.max_queue_depth
        token_wm = cfg.max_queued_tokens
        if depth_wm is None and token_wm is None:
            return None
        over = (
            depth_wm is not None and self.engine.queue_depth >= depth_wm
        ) or (
            token_wm is not None and self.engine.queued_prompt_tokens >= token_wm
        )
        return cfg.shed_retry_after_s if over else None

    def _h_generate(self, headers, body: bytes, query=None) -> Response:
        faults.maybe_fail("gserver.generate")
        d = json.loads(body)
        # An expired propagated deadline is refused cheaply: 429 with
        # Retry-After 0, so the client re-mints a budget.
        deadline = rpc.Deadline.from_headers(headers)
        if deadline is not None and deadline.expired():
            rpc.stats.incr("deadline_expired")
            return _json(
                {"qid": str(d.get("qid", "")), "error": "deadline expired",
                 "retry_after": 0.0},
                429, {"Retry-After": "0"},
            )
        # Admission control before the engine sees the request.
        retry_after = self._admission_overloaded()
        if retry_after is not None:
            with self._counter_lock:
                self._n_shed += 1
            tracing.event(
                "server.load_shed", ctx=tracing.extract_from(d),
                qid=str(d.get("qid", "")), queue_depth=self.engine.queue_depth,
            )
            return _json(
                {
                    "qid": str(d.get("qid", "")),
                    "error": "overloaded",
                    "retry_after": retry_after,
                    "queue_depth": self.engine.queue_depth,
                },
                429, {"Retry-After": str(max(1, int(-(-retry_after // 1))))},
            )
        gen_span = tracing.start_span(
            "server.generate", ctx=tracing.extract_from(d),
            qid=str(d.get("qid", "")), prompt_len=len(d.get("input_ids") or []),
        )
        # A returning session without its parked prefix restores it from
        # the local tier, or pulls it from the peer the manager's index
        # named (kv_source), before submission; any failure degrades to
        # the full re-prefill.
        self._maybe_restore_prefix(d, deadline=deadline)
        g = d.get("gconfig", {})
        # Disaggregated path: the manager paired a decode server in.
        # Single-token budgets and self-pairings serve locally.
        decode_url = d.get("decode_url") or None
        if (decode_url and decode_url != self.address
                and int(g.get("max_new_tokens", 256)) > 1):
            return self._h_generate_disagg(d, g, decode_url, gen_span, deadline=deadline)
        req = self._gen_request_from(d, g)
        try:
            res = self._submit_and_wait(req)
        except RuntimeError as e:
            # Fail fast: the serve loop already died.
            if gen_span is not None:
                gen_span.end(error=str(e))
            return _json({"qid": req.qid, "error": str(e)}, 500)
        if gen_span is not None:
            gen_span.end(
                n_tokens=len(res.output_ids), interrupted=res.interrupted,
                version_start=res.version_start, version_end=res.version_end,
                error=res.error or "",
            )
        if res.error is not None:
            # Serve-loop death: a 500, so clients retry elsewhere.
            return _json({"qid": res.qid, "error": res.error}, 500)
        if res.interrupted:
            self._count_interrupted()
        return _json(self._gen_response(res))

    @staticmethod
    def _gen_request_from(d: Dict, g: Dict) -> GenRequest:
        return GenRequest(
            qid=str(d["qid"]),
            input_ids=[int(t) for t in d["input_ids"]],
            max_new_tokens=int(g.get("max_new_tokens", 256)),
            min_new_tokens=int(g.get("min_new_tokens", 0)),
            greedy=bool(g.get("greedy", False)),
            temperature=float(g.get("temperature", 1.0)),
            top_p=float(g.get("top_p", 1.0)),
            top_k=int(g.get("top_k", -1)),
            stop_token_ids=tuple(g.get("stop_token_ids", [])),
            priority=int(d.get("priority", 1)),
        )

    def _submit_and_wait(self, req: GenRequest):
        """Submit to the engine and block this request thread until the
        result arrives. Raises RuntimeError when the loop is dead."""
        done = threading.Event()
        box = []

        def done_cb(res):
            box.append(res)
            done.set()

        req.done_cb = done_cb
        self.engine.submit(req)
        done.wait()
        return box[0]

    @staticmethod
    def _gen_response(res, **extra) -> Dict:
        out = {
            "qid": res.qid,
            "output_ids": res.output_ids,
            "output_logprobs": res.output_logprobs,
            "no_eos": res.no_eos,
            "interrupted": res.interrupted,
            "version_start": res.version_start,
            "version_end": res.version_end,
            "latency": res.latency,
        }
        out.update(extra)
        return out

    def _count_interrupted(self):
        with self._counter_lock:
            self._n_interrupted += 1

    # ------------------------------------------------------------------
    # Disaggregated prefill/decode
    # ------------------------------------------------------------------

    def _stash_handoff(self, qid: str, meta: Dict, payload: bytes):
        """Keep an exported blob for the decode server's chunked pull. An
        entry lives until its /kv_handoff POST returns (the decode
        server's whole stream), so the cap covers the server's admission
        concurrency; entries older than 600 s (a decode server that died
        mid-pull) are pruned."""
        now = time.monotonic()
        with self._counter_lock:
            self._handoff_store[qid] = (meta, payload, now)
            for k in [k for k, (_, _, t) in self._handoff_store.items() if now - t > 600.0]:
                self._handoff_store.pop(k, None)
            cap = max(32, 4 * self.cfg.max_concurrent_requests)
            while len(self._handoff_store) > cap:
                self._handoff_store.popitem(last=False)

    def _h_generate_disagg(self, d, g, decode_url, gen_span, deadline=None) -> Response:
        qid = str(d["qid"])
        budget = int(g.get("max_new_tokens", 256))
        min_new = int(g.get("min_new_tokens", 0))
        # Prefill leg: run to the first sampled token only; the finish
        # parks the prompt's KV under this qid.
        first_req = self._gen_request_from(d, g)
        first_req.max_new_tokens = 1
        first_req.min_new_tokens = min(1, min_new)
        try:
            res = self._submit_and_wait(first_req)
        except RuntimeError as e:
            if gen_span is not None:
                gen_span.end(error=str(e))
            return _json({"qid": qid, "error": str(e)}, 500)
        if res.error is not None:
            if gen_span is not None:
                gen_span.end(error=res.error)
            return _json({"qid": qid, "error": res.error}, 500)
        if res.interrupted or not res.output_ids or not res.no_eos:
            # Interrupted (the client resubmits), a zero budget, or the
            # first token is the EOS: nothing to hand off.
            if res.interrupted:
                self._count_interrupted()
            if gen_span is not None:
                gen_span.end(n_tokens=len(res.output_ids), interrupted=res.interrupted,
                             disagg="short-circuit")
            return _json(self._gen_response(res))
        first = int(res.output_ids[0])
        t_handoff0 = time.monotonic()

        exp_span = tracing.start_span("server.kv_export", ctx=tracing.extract_from(d),
                                      qid=qid, decode_url=decode_url)
        try:
            meta, payload = self.engine.export_kv_handoff(
                qid, compress=self.cfg.kv_handoff_compress)
        except (KeyError, KVHandoffError, RuntimeError, TimeoutError) as e:
            # A prompt shorter than a page, pool pressure evicted the
            # park, or the loop door timed out: finish here.
            logger.warning(f"{qid}: kv export unavailable ({e!r}); serving remainder locally")
            if exp_span is not None:
                exp_span.end(error=repr(e))
            return self._disagg_local_remainder(d, g, res, first, gen_span,
                                                reason=f"export: {e!r}")
        if exp_span is not None:
            exp_span.end(n_tokens=meta["n_tokens"], bytes=len(payload),
                         export_ms=self.engine.last_kv_export_ms)
        faults.maybe_fail("gserver.kv_export")
        self._stash_handoff(qid, meta, payload)
        try:
            # The decode hop inherits the request's remaining budget.
            hop_headers = deadline.headers() if deadline is not None else {}
            status, _, raw = http_request(
                f"{decode_url}/kv_handoff",
                tracing.inject_ctx_into({
                    "qid": qid,
                    "meta": meta,
                    "source": self.address,
                    "first_token": first,
                    "gconfig": {
                        "max_new_tokens": budget - 1,
                        "min_new_tokens": max(0, min_new - 1),
                        "greedy": bool(g.get("greedy", False)),
                        "temperature": float(g.get("temperature", 1.0)),
                        "top_p": float(g.get("top_p", 1.0)),
                        "top_k": int(g.get("top_k", -1)),
                        "stop_token_ids": list(g.get("stop_token_ids", [])),
                    },
                }, gen_span.ctx if gen_span is not None else None),
                headers=hop_headers,
                timeout=deadline.remaining() if deadline is not None and deadline.bounded()
                else 600.0)
            body = json.loads(raw)
            ok = status == 200 and "output_ids" in body
        except Exception as e:
            ok, body = False, {"error": repr(e)}
        finally:
            with self._counter_lock:
                self._handoff_store.pop(qid, None)
        if not ok:
            with self._counter_lock:
                self._handoff_failed += 1
            logger.warning(f"{qid}: kv handoff to {decode_url} failed "
                           f"({str(body.get('error'))[:200]}); serving remainder locally")
            return self._disagg_local_remainder(
                d, g, res, first, gen_span, reason=f"decode: {str(body.get('error'))[:120]}")
        with self._counter_lock:
            self._handoff_ok += 1
        self._last_handoff_ms = (time.monotonic() - t_handoff0) * 1000.0
        if gen_span is not None:
            gen_span.end(n_tokens=1 + len(body["output_ids"]), disagg="handoff",
                         decode_url=decode_url, handoff_ms=self._last_handoff_ms)
        return _json({
            "qid": qid,
            "output_ids": [first] + [int(t) for t in body["output_ids"]],
            "output_logprobs": res.output_logprobs + [float(x) for x in body["output_logprobs"]],
            "no_eos": bool(body["no_eos"]),
            "interrupted": bool(body["interrupted"]),
            "version_start": res.version_start,
            "version_end": int(body["version_end"]),
            "latency": time.monotonic() - (t_handoff0 - res.latency),
            "disagg": {
                "decode_url": decode_url,
                "handoff_bytes": len(payload),
                "handoff_ms": self._last_handoff_ms,
            },
        })

    def _disagg_local_remainder(self, d, g, first_res, first, gen_span, reason: str) -> Response:
        """Handoff fallback: finish the request on this engine (it holds
        or recomputes the prefix), so a failed handoff degrades to
        unified serving instead of losing the rollout."""
        with self._counter_lock:
            self._handoff_fallback += 1
        cont = self._gen_request_from(d, g)
        cont.input_ids = [int(t) for t in d["input_ids"]] + [first]
        cont.max_new_tokens = int(g.get("max_new_tokens", 256)) - 1
        cont.min_new_tokens = max(0, int(g.get("min_new_tokens", 0)) - 1)
        cont.priority = 0
        try:
            res2 = self._submit_and_wait(cont)
        except RuntimeError as e:
            if gen_span is not None:
                gen_span.end(error=str(e))
            return _json({"qid": cont.qid, "error": str(e)}, 500)
        if res2.error is not None:
            if gen_span is not None:
                gen_span.end(error=res2.error)
            return _json({"qid": res2.qid, "error": res2.error}, 500)
        if res2.interrupted:
            self._count_interrupted()
        if gen_span is not None:
            gen_span.end(n_tokens=1 + len(res2.output_ids), disagg="local-fallback",
                         fallback_reason=reason)
        merged = self._gen_response(res2, disagg={"fallback": reason})
        merged["output_ids"] = [first] + list(res2.output_ids)
        merged["output_logprobs"] = list(first_res.output_logprobs) + list(res2.output_logprobs)
        merged["version_start"] = first_res.version_start
        merged["latency"] = first_res.latency + res2.latency
        return _json(merged)

    # ------------------------------------------------------------------
    # Tiered KV plane: restore, peer pull, the /kv routes
    # ------------------------------------------------------------------

    def _maybe_restore_prefix(self, d: Dict, deadline: Optional[rpc.Deadline] = None
                              ) -> Optional[str]:
        """Best-effort prefix restore for a returning session: the tier it
        hit ('local' or 'peer') or None. Never raises: every failure is a
        plain re-prefill."""
        try:
            return self._restore_prefix_impl(d, deadline=deadline)
        except Exception:
            logger.warning(f"kv restore for {d.get('qid')!r} failed; "
                           f"falling back to re-prefill", exc_info=True)
            return None

    def _restore_prefix_impl(self, d: Dict, deadline: Optional[rpc.Deadline] = None
                             ) -> Optional[str]:
        qid = str(d.get("qid") or "")
        input_ids = [int(t) for t in (d.get("input_ids") or [])]
        eng = self.engine
        if not qid or len(input_ids) <= self.cfg.kv_page_size or eng.has_parked(qid):
            return None
        kv_source = str(d.get("kv_source") or "")
        if eng.kv_tier is None and (not kv_source or kv_source == self.address):
            return None
        faults.maybe_fail("gserver.kv_restore")
        t0 = time.monotonic()
        span_t0 = tracing.now_ns() if tracing.enabled() else 0
        # 1) The local tier.
        if eng.kv_tier is not None:
            n = eng.restore_from_tier(qid, input_ids)
            if n:
                self._last_kv_restore_ms = (time.monotonic() - t0) * 1000.0
                if tracing.enabled():
                    tracing.record_span("server.kv_restore", span_t0,
                                        ctx=tracing.extract_from(d), qid=qid,
                                        tier="local", n_tokens=n)
                return "local"
        # 2) A peer pull over /kv/{manifest,chunk}.
        if not kv_source or kv_source == self.address:
            return None
        status, _, raw = http_request(
            f"{kv_source}/kv/manifest?" + urllib.parse.urlencode({"qid": qid}), timeout=30.0)
        if status != 200:
            with self._counter_lock:
                self._kv_peer_failed += 1
            return None
        hmeta = json.loads(raw).get("meta") or {}
        toks = [int(t) for t in (hmeta.get("tokens") or [])]
        use = min(len(toks), len(input_ids) - 1)
        if (use < self.cfg.kv_page_size or toks[:use] != input_ids[:use]
                or int(hmeta.get("version", -1)) != eng.version):
            return None  # wrong content or stale version: skip the transfer
        payload = self._fetch_handoff_payload(kv_source, qid, hmeta, path="/kv/chunk",
                                              deadline=deadline)
        eng.import_kv_handoff(hmeta, payload)
        with self._counter_lock:
            self._kv_peer_hits += 1
            self._kv_peer_bytes += len(payload)
        self._last_kv_restore_ms = (time.monotonic() - t0) * 1000.0
        if tracing.enabled():
            tracing.record_span("server.kv_restore", span_t0, ctx=tracing.extract_from(d),
                                qid=qid, tier="peer", source=kv_source, n_tokens=len(toks),
                                bytes=len(payload))
        return "peer"

    def _h_kv_manifest(self, headers, body: bytes, query=None) -> Response:
        """Peer-pull hop 1: the handoff meta of a prefix this server holds
        (a tier entry as it is; a parked prefix is exported into the tier
        first so /kv/chunk can stream it)."""
        qid = (query or {}).get("qid", "")
        try:
            meta = self.engine.stage_peer_export(qid)
        except KeyError as e:
            return _json({"error": str(e)}, 404)
        except Exception as e:
            return _json({"error": repr(e)}, 503)
        with self._counter_lock:
            self._kv_manifests_served += 1
        return _json({"schema": KV_TIER_V1, "qid": qid, "holder": self.address, "meta": meta})

    @staticmethod
    def _serve_ranged(payload: bytes, headers) -> Response:
        """Range-aware byte serving for the handoff blob and the tier
        chunks. The ``gserver.kv_chunk_bytes`` chaos point corrupts the
        bytes actually served (the Range slice)."""
        rng = headers.get("Range")
        if rng and rng.startswith("bytes="):
            try:
                a, _, b = rng[len("bytes="):].partition("-")
                start = int(a)
                end = int(b) if b else len(payload) - 1
            except ValueError:
                return _text("", 416)
            if start >= len(payload):
                return _text("", 416)
            end = min(end, len(payload) - 1)
            data = faults.maybe_corrupt("gserver.kv_chunk_bytes", payload[start: end + 1])
            return _bytes(data, 206, {"Content-Range": f"bytes {start}-{end}/{len(payload)}"})
        return _bytes(faults.maybe_corrupt("gserver.kv_chunk_bytes", payload))

    def _h_kv_chunk(self, headers, body: bytes, query=None) -> Response:
        """Peer-pull hop 2: a held prefix's payload bytes (the puller
        verifies each chunk's hash)."""
        qid = (query or {}).get("qid", "")
        got = self.engine.peer_payload(qid)
        if got is None:
            return _json({"error": f"no tiered prefix for {qid!r}"}, 404)
        resp = self._serve_ranged(got[1], headers)
        with self._counter_lock:
            self._kv_chunks_served += 1
            self._kv_chunk_bytes_served += len(resp[1])
        return resp

    def _h_kv_index(self, headers, body: bytes, query=None) -> Response:
        """Holdings for the manager's global prefix index: parked
        prefixes (loop snapshot) and tier entries."""
        eng = self.engine
        held = eng.parked_index()
        if eng.kv_tier is not None:
            held += eng.kv_tier.held()
        return _json({"schema": KV_TIER_V1, "url": self.address, "held": held})

    def _h_kv_handoff(self, headers, body: bytes, query=None) -> Response:
        """Decode side: pull the blob from the prefill server, import it,
        and run the decode stream as a priority-0 continuation."""
        faults.maybe_fail("gserver.kv_import")
        d = json.loads(body)
        qid = str(d["qid"])
        meta = d["meta"]
        source = d["source"]
        imp_span = tracing.start_span("server.kv_import", ctx=tracing.extract_from(d),
                                      qid=qid, source=source,
                                      n_tokens=int(meta.get("n_tokens", 0)))
        t0 = time.monotonic()
        try:
            payload = self._fetch_handoff_payload(source, qid, meta,
                                                  deadline=rpc.Deadline.from_headers(headers))
        except Exception as e:
            if imp_span is not None:
                imp_span.end(error=repr(e))
            return _json({"qid": qid, "error": f"transfer failed: {e!r}"}, 502)
        self._last_kv_transfer_ms = (time.monotonic() - t0) * 1000.0
        try:
            self.engine.import_kv_handoff(meta, payload)
        except KVHandoffVersionMismatch as e:
            if imp_span is not None:
                imp_span.end(error=repr(e))
            return _json({"qid": qid, "error": str(e), "version": self.engine.version}, 409)
        except (KVHandoffError, RuntimeError, TimeoutError) as e:
            if imp_span is not None:
                imp_span.end(error=repr(e))
            return _json({"qid": qid, "error": str(e)}, 503)
        cont = self._gen_request_from(
            {"qid": qid, "input_ids": list(meta["tokens"]) + [int(d["first_token"])],
             "priority": 0},
            d.get("gconfig", {}))
        try:
            res = self._submit_and_wait(cont)
        except RuntimeError as e:
            if imp_span is not None:
                imp_span.end(error=str(e))
            return _json({"qid": qid, "error": str(e)}, 500)
        if res.error is not None:
            if imp_span is not None:
                imp_span.end(error=res.error)
            return _json({"qid": qid, "error": res.error}, 500)
        if res.interrupted:
            self._count_interrupted()
        if imp_span is not None:
            imp_span.end(bytes=len(payload), transfer_ms=self._last_kv_transfer_ms,
                         import_ms=self.engine.last_kv_import_ms,
                         n_tokens_out=len(res.output_ids))
        return _json(self._gen_response(res, transfer_ms=self._last_kv_transfer_ms,
                                        import_ms=self.engine.last_kv_import_ms))

    def _fetch_handoff_payload(self, source: str, qid: str, meta: Dict,
                               path: str = "/kv_handoff/blob",
                               deadline: Optional[rpc.Deadline] = None) -> bytes:
        """Chunked pull of a KV blob (a prefill server's export stash, or
        a peer's tier with ``path="/kv/chunk"``): each chunk verified by
        its sha256, a torn read resumed mid-chunk with ``Range``, a
        corrupt chunk fetched again, under the declared RPC policy and
        the caller's deadline."""
        index = meta["chunks"]
        total = int(index["total_bytes"])
        buf = bytearray(total)
        policy = rpc.default_policy()
        url = f"{source}{path}?" + urllib.parse.urlencode({"qid": qid})
        for i, (off, length) in enumerate(chunk_spans(total, int(index["chunk_bytes"]))):
            state = {"got": 0}

            def attempt(attempt_timeout: float, i=i, off=off, length=length, state=state):
                start = off + state["got"]
                dl = deadline or rpc.Deadline.after(attempt_timeout)
                status, _, data = http_request(
                    url, headers=dl.headers({"Range": f"bytes={start}-{off + length - 1}"}),
                    timeout=attempt_timeout)
                if status not in (200, 206):
                    raise OSError(f"blob fetch {status}: {data[:200]!r}")
                if status == 200:
                    data = data[start: off + length]  # a server without Range
                take = min(len(data), length - state["got"])
                buf[start: start + take] = data[:take]
                state["got"] += take
                if state["got"] < length:
                    raise OSError(f"short read {state['got']}/{length}")  # resume from here
                if not verify_chunk(bytes(buf[off: off + length]), index["hashes"][i]):
                    state["got"] = 0  # corrupt chunk: fetch it whole again
                    raise ValueError(f"chunk {i} content-hash mismatch")

            try:
                rpc.retry_sync(attempt, policy=policy, deadline=deadline,
                               what=f"kv chunk {i} <- {source}{path}")
            except rpc.RpcError as e:
                raise RuntimeError(f"chunk {i} unrecoverable after retries: {e}") from e
        return bytes(buf)

    def _h_kv_blob(self, headers, body: bytes, query=None) -> Response:
        qid = (query or {}).get("qid", "")
        with self._counter_lock:
            ent = self._handoff_store.get(qid)
        if ent is None:
            return _json({"error": f"no handoff blob for {qid!r}"}, 404)
        return self._serve_ranged(ent[1], headers)

    # ------------------------------------------------------------------
    # Drain-then-leave with KV migration
    # ------------------------------------------------------------------

    def _h_drain(self, headers, body: bytes, query=None) -> Response:
        """Quiesce admission now (every new /generate sheds 429), let the
        running work finish, migrate the parked and tiered prefixes to
        the given peers, then deregister and exit with a graceful
        heartbeat stop. Returns at once; GET /drain reports progress."""
        faults.maybe_fail("gserver.drain")
        d = json.loads(body)
        with self._counter_lock:
            if self._draining:
                return _json({"success": True, "already": True, **self._drain_state})
            self._draining = True
        migrate = [u for u in (d.get("migrate_to") or []) if u and u != self.address]
        self._drain_state.update(draining=True, reason=str(d.get("reason") or ""))
        hb = getattr(self, "_heartbeat", None)
        if hb is not None:
            hb.update_payload(draining=True)
        # A strong reference: the drain must outlive this request.
        self._drain_thread = threading.Thread(
            target=self._drain_task, args=(migrate, bool(d.get("exit", True))), daemon=True)
        self._drain_thread.start()
        tracing.event("server.drain", ctx=tracing.extract_from(d), n_targets=len(migrate),
                      reason=str(d.get("reason") or ""))
        logger.info(f"drain started ({d.get('reason')!r}): migrating KV to {len(migrate)} "
                    f"peer(s), {self.engine.n_running} in flight")
        return _json({"success": True, "draining": True})

    def _h_drain_status(self, headers, body: bytes, query=None) -> Response:
        return _json({"address": self.address, **self._drain_state,
                      "n_running": self.engine.n_running,
                      "queue_depth": self.engine.queue_depth})

    def _drain_task(self, migrate_to: List[str], exit_after: bool):
        t0 = time.monotonic()
        held: Dict[str, int] = {}
        migrated = lost = stale = 0
        # Lower bound for the failure path, should the authoritative
        # enumeration below never complete.
        snap_count = len(self.engine.parked_index())
        try:
            # 1) Quiesce: wait out running requests (bounded).
            deadline = t0 + self.cfg.drain_wait_s
            while time.monotonic() < deadline:
                if self.engine.n_running == 0 and self.engine.queue_depth == 0:
                    break
                time.sleep(0.1)
            # 2) Migrate parked prefixes and tier entries over the /kv
            #    wire; version-stale ones are dropped (not a loss). The
            #    parked set is read on the loop (authoritative).
            for qid in self.engine.parked_qids_now():
                held[qid] = int(self.engine.version)
            if self.engine.kv_tier is not None:
                for e in self.engine.kv_tier.held():
                    held.setdefault(e["qid"], int(e.get("version", -1)))
            self._drain_state["held"] = len(held)
            for i, (qid, ver) in enumerate(sorted(held.items())):
                if ver >= 0 and ver != self.engine.version:
                    stale += 1
                    continue
                ok = peer_409 = False
                if migrate_to:
                    try:
                        meta = self.engine.stage_peer_export(qid)
                    except Exception:
                        logger.warning(f"drain: staging {qid!r} failed", exc_info=True)
                        meta = None
                    # Every peer in turn from this prefix's round-robin
                    # home: one tierless peer must not lose its share.
                    k = i % len(migrate_to)
                    for target in (migrate_to[k:] + migrate_to[:k]) if meta is not None else []:
                        try:
                            status, _, raw = http_request(
                                f"{target}/kv/accept",
                                {"qid": qid, "meta": meta, "source": self.address},
                                timeout=600.0)
                            ok = status == 200 and bool(json.loads(raw).get("success"))
                            peer_409 = status == 409
                        except Exception:
                            logger.warning(f"drain: migrating {qid!r} to {target} failed",
                                           exc_info=True)
                        if ok or peer_409:
                            # 409 = version skew: the whole fleet has moved on.
                            break
                if ok:
                    migrated += 1
                elif peer_409:
                    stale += 1
                else:
                    lost += 1
            self._drain_state.update(migrated=migrated, lost=lost, stale_dropped=stale,
                                     drain_ms=(time.monotonic() - t0) * 1000.0, done=True)
            # 3) Deregister; the heartbeat's graceful stop at exit is the
            #    departure marker and carries the drain's results.
            try:
                name_resolve.delete(names.gen_server_url(
                    self.cfg.experiment_name, self.cfg.trial_name, str(self.cfg.server_index)))
            except Exception:
                pass
            hb = getattr(self, "_heartbeat", None)
            if hb is not None:
                hb.update_payload(drain_migrated=migrated, drain_lost=lost)
            logger.info(f"drain complete in {self._drain_state['drain_ms']:.0f}ms: migrated "
                        f"{migrated}, lost {lost}, stale {stale} of {len(held)} held prefix(es)")
        except Exception:
            # Whatever was held and not migrated (or proven stale) dies
            # with this process: report it as lost.
            lost = max(lost, len(held) - migrated - stale, snap_count - migrated - stale)
            self._drain_state.update(migrated=migrated, lost=lost, stale_dropped=stale,
                                     done=True, failed=True,
                                     drain_ms=(time.monotonic() - t0) * 1000.0)
            hb = getattr(self, "_heartbeat", None)
            if hb is not None:
                try:
                    hb.update_payload(drain_migrated=migrated, drain_lost=lost)
                except Exception:
                    pass
            logger.exception("drain task failed")
        finally:
            if exit_after:
                # The poll loop ends; Worker.run() stops the heartbeat
                # with the graceful marker and runs _exit_hook.
                self.exit()

    def _h_kv_accept(self, headers, body: bytes, query=None) -> Response:
        """Drain-migration ingest: pull a departing peer's prefix over the
        hash-verified /kv/chunk wire into the local tier (no device
        import: the session may return to any server; /kv/index
        advertises it, so the manager's index routes it here)."""
        faults.maybe_fail("gserver.kv_accept")
        d = json.loads(body)
        qid = str(d.get("qid") or "")
        meta = d.get("meta") or {}
        source = str(d.get("source") or "")
        if self.engine.kv_tier is None:
            return _json({"success": False, "error": "no kv tier"}, 503)
        if not qid or not source or not meta:
            return _json({"success": False, "error": "qid/meta/source required"}, 400)
        if int(meta.get("version", -1)) != self.engine.version:
            return _json({"success": False,
                          "error": f"version {meta.get('version')} != {self.engine.version}"},
                         409)
        try:
            payload = self._fetch_handoff_payload(source, qid, meta, path="/kv/chunk",
                                                  deadline=rpc.Deadline.from_headers(headers))
        except Exception as e:
            return _json({"success": False, "error": f"transfer failed: {e!r}"}, 502)
        self.engine.kv_tier.put(qid, meta, payload)
        with self._counter_lock:
            self._kv_accepted += 1
            self._kv_accept_bytes += len(payload)
        tracing.event("server.kv_accept", ctx=tracing.extract_from(d), qid=qid, source=source,
                      bytes=len(payload))
        return _json({"success": True, "bytes": len(payload)})

    def _h_set_role(self, headers, body: bytes, query=None) -> Response:
        """Elastic re-role (the manager's sizer): flip the live pool role.
        Running requests finish as they are; weights stay resident."""
        d = json.loads(body)
        role = str(d.get("role", ""))
        if role not in ("unified", "prefill", "decode"):
            return _json({"success": False, "error": f"bad role {role!r}"}, 400)
        with self._role_lock:
            prev, self.role = self.role, role
        tracing.event("server.set_role", ctx=tracing.extract_from(d), role=role, previous=prev,
                      n_running=self.engine.n_running)
        logger.info(f"re-roled {prev} -> {role} ({self.engine.n_running} in flight)")
        return _json({"success": True, "role": role, "previous": prev,
                      "n_running": self.engine.n_running,
                      "queue_depth": self.engine.queue_depth})

    def _h_configure(self, headers, body: bytes, query=None) -> Response:
        """Runtime admission-watermark overrides, plus (only when
        AREAL_CHAOS_HTTP armed it at boot) fault-injection control:
        ``{"faults": spec}`` arms points in this process,
        ``{"faults_reset": true}`` clears them, ``{"faults_hits": [...]}``
        reads hit counts. Refusals (403 knob off, 400 undeclared point)
        come before anything mutates."""
        d = json.loads(body)
        chaos_keys = "faults" in d or d.get("faults_reset") or "faults_hits" in d
        if chaos_keys:
            if not env_registry.get_bool("AREAL_CHAOS_HTTP"):
                return _json(
                    {"success": False,
                     "error": "chaos control disabled (set AREAL_CHAOS_HTTP=1 at server boot)"},
                    403,
                )
            try:
                for p in d.get("faults_hits", []):
                    faults.check_declared(str(p))
                for entry in str(d.get("faults") or "").split(";"):
                    entry = entry.strip()
                    if entry:
                        faults.check_declared(entry.partition("=")[0].partition("@")[0].strip())
            except ValueError as e:
                return _json({"success": False, "error": str(e)}, 400)
        changed = {}
        for key, cast in (("max_queue_depth", int), ("max_queued_tokens", int),
                          ("shed_retry_after_s", float)):
            if key in d:
                val = d[key]
                setattr(self.cfg, key, None if val is None else cast(val))
                changed[key] = val
        resp = {"success": True, "changed": changed}
        if chaos_keys:
            if d.get("faults_reset"):
                faults.reset()
                changed["faults_reset"] = True
            spec = d.get("faults")
            if spec:
                faults.load_env(str(spec))
                changed["faults"] = spec
            resp["faults_armed"] = faults.armed_points()
            resp["faults_hits"] = {p: faults.hits_declared(str(p))
                                   for p in d.get("faults_hits", [])}
        return _json(resp)

    def _h_update_weights(self, headers, body: bytes, query=None) -> Response:
        faults.maybe_fail("gserver.update_weights")
        d = json.loads(body)
        upd_span = tracing.start_span(
            "server.weight_update", ctx=tracing.extract_from(d),
            version=d.get("version"), n_running=self.engine.n_running,
        )
        model_path = d["model_path"]
        allow_interrupt = bool(d.get("allow_interrupt", True))
        version = d.get("version")
        version = None if version is None else int(version)
        if self.engine.is_stale_update(version):
            # A retry of a version already staged or live: skip the load,
            # but honor the interrupt escalation.
            if allow_interrupt:
                self.engine.escalate_pending_interrupt()
            logger.info(f"skipping stale weight update v{version}")
            if upd_span is not None:
                upd_span.end(stale=True)
            return _json({"success": True, "stale": True,
                          "num_paused_requests": self.engine.n_running})
        try:
            params, info = self._load_params(model_path, version)
        except Exception as e:
            logger.exception("weight update load failed")
            if upd_span is not None:
                upd_span.end(error=repr(e))
            return _json({"success": False, "error": repr(e)}, 500)
        self._last_load_info = info
        n_running = self.engine.n_running
        self.engine.update_params(params, allow_interrupt=allow_interrupt, version=version)
        logger.info(f"weight update: source={info['source']} "
                    f"load={info['load_s']:.3f}s dump_version={info['version']}")
        if upd_span is not None:
            upd_span.end(source=info["source"], load_s=info["load_s"], n_paused=n_running)
        return _json({"success": True, "num_paused_requests": n_running,
                      "load_s": info["load_s"], "source": info["source"]})

    def _load_params(self, model_path: str, want_version=None):
        """Fastest source first: tmpfs raw, disk raw, pickle, HF
        (system/weight_transfer.load_for_serving); a pinned version that
        no dump holds raises WeightVersionMismatch after brief retries.
        The tmpfs dump is keyed by the role name, the basename of the
        realloc dump dir."""
        from areal_tpu_torch.system.weight_transfer import load_for_serving, shm_transfer_dir

        role = os.path.basename(model_path.rstrip("/"))
        shm = shm_transfer_dir(self.cfg.experiment_name, self.cfg.trial_name, role)
        return load_for_serving(model_path, shm_dir=shm, want_version=want_version)

    # ------------------------------------------------------------------
    # Weight-distribution plane (system/weight_plane.py)
    # ------------------------------------------------------------------

    def _wp_held_reply(self) -> Response:
        return _json({"success": True, "already_held": True,
                      "transfer_ms": self._wp_transfer_ms, "verify_ms": self._wp_verify_ms})

    def _h_distribute_weights(self, headers, body: bytes, query=None) -> Response:
        """Prefetch version-N chunks into host memory while version N-1
        keeps serving. Returns once the payload is complete and verified,
        so the manager can make this server a parent in the next wave."""
        faults.maybe_fail("gserver.distribute_weights")
        d = json.loads(body)
        version = int(d["version"])
        upstreams = [u for u in (d.get("upstreams") or []) if u]
        origin = d.get("origin")
        # An unsharded server accepts only the unsharded stream; the 409
        # teaches the caller its real spec.
        man_shard = (d.get("manifest") or {}).get("shard") or {}
        man_key = (int(man_shard.get("tp_rank") or 0), int(man_shard.get("tp_degree") or 1))
        if man_key != (0, 1):
            return _json({"success": False,
                          "error": f"manifest shard {man_key} != server shard (0, 1)",
                          "weight_shard": [0, 1]}, 409)
        fetch_span = tracing.start_span("server.weight_fetch", ctx=tracing.extract_from(d),
                                        version=version, n_upstreams=len(upstreams))

        def superseded(held) -> Response:
            if fetch_span is not None:
                fetch_span.end(error="superseded")
            return _json({"success": False, "error": f"superseded by v{held.version}"}, 409)

        def held_already() -> Response:
            if fetch_span is not None:
                fetch_span.end(already_held=True)
            return self._wp_held_reply()

        with self._wp_lock:
            held = self._wp_store
            joining = False
            if held is not None and held.version > version:
                # A stale edge (a retry from an older fanout): refused
                # before the payload-sized allocation below.
                return superseded(held)
            if held is not None and held.version == version:
                if self._wp_state == "ready":
                    return held_already()
                if self._wp_state == "fetching":
                    # A duplicate of an in-flight fetch joins it: starting
                    # over would drop every verified chunk.
                    store, joining = held, True
        if not joining:
            try:
                store = ChunkStore(d["manifest"])
            except Exception as e:
                if fetch_span is not None:
                    fetch_span.end(error=repr(e))
                return _json({"success": False, "error": repr(e)}, 400)
            with self._wp_lock:
                held = self._wp_store
                if held is not None and held.version > version:
                    return superseded(held)
                if held is not None and held.version == version:
                    if self._wp_state == "ready":
                        return held_already()
                    if self._wp_state == "fetching":
                        store, joining = held, True
                if not joining:
                    self._wp_store = store
                    self._wp_state = "fetching"

        if joining:
            deadline = time.monotonic() + float(d.get("deadline_s") or 600.0)
            state = "timeout"
            while time.monotonic() < deadline:
                with self._wp_lock:
                    if self._wp_store is not store:
                        state = "superseded"
                        break
                    if self._wp_state != "fetching":
                        state = self._wp_state
                        break
                time.sleep(0.05)
            with self._wp_lock:
                reply = {"success": state == "ready", "joined": True,
                         "transfer_ms": self._wp_transfer_ms, "verify_ms": self._wp_verify_ms}
            if state != "ready":
                reply["error"] = f"in-flight fetch ended: {state}"
            if fetch_span is not None:
                fetch_span.end(joined=True, state=state)
            return _json(reply, 200 if state == "ready" else 500)

        try:
            faults.maybe_fail("gserver.weight_fetch")
            stats = store.fetch(upstreams, origin=origin,
                                timeout=float(d.get("chunk_timeout") or 30.0),
                                deadline_s=float(d.get("deadline_s") or 600.0))
        except Exception as e:
            with self._wp_lock:
                if self._wp_store is store:
                    self._wp_state = "failed"
            logger.exception("weight-plane prefetch failed")
            if fetch_span is not None:
                fetch_span.end(error=repr(e))
            return _json({"success": False, "error": repr(e)}, 500)
        with self._wp_lock:
            # A fetch superseded by a newer /distribute_weights must not
            # overwrite the live version's numbers.
            if self._wp_store is store:
                self._wp_state = "ready"
                self._wp_transfer_ms = stats["fetch_s"] * 1000.0
                self._wp_verify_ms = stats["verify_s"] * 1000.0
                self._wp_bytes_from_origin = stats["bytes_from_origin"]
                self._wp_bytes_from_peers = stats["bytes_from_peers"]
                self._wp_expected_bytes = stats["expected_bytes"]
                self._wp_ingress_eq = stats["ingress_payload_equivalents"]
                self._wp_wire = stats.get("wire") or "raw"
        logger.info(f"weight-plane prefetch v{version}: {stats['total_bytes']} bytes in "
                    f"{stats['fetch_s']:.3f}s (origin {stats['bytes_from_origin']}, peers "
                    f"{stats['bytes_from_peers']}); still serving v{self.engine.version}")
        if fetch_span is not None:
            fetch_span.end(fetch_s=stats["fetch_s"], verify_s=stats["verify_s"],
                           bytes_from_origin=stats["bytes_from_origin"],
                           bytes_from_peers=stats["bytes_from_peers"])
        return _json({"success": True,
                      "transfer_ms": stats["fetch_s"] * 1000.0,
                      "verify_ms": stats["verify_s"] * 1000.0,
                      "bytes_from_origin": stats["bytes_from_origin"],
                      "bytes_from_peers": stats["bytes_from_peers"],
                      "n_chunks": stats["n_chunks"],
                      "resumed_chunks": stats["resumed_chunks"]})

    def _h_cutover_weights(self, headers, body: bytes, query=None) -> Response:
        """Swap to the prefetched version: running requests are
        interrupted (partial results return for the client's re-prefill),
        the host buffer is staged on the device and the loop flips to it.
        Measured end to end, apart from the transfer, and held against
        the cutover budget."""
        faults.maybe_fail("gserver.cutover_weights")
        d = json.loads(body)
        version = int(d["version"])
        budget_s = float(d.get("budget_s") or 0.0)
        cut_span = tracing.start_span("server.weight_cutover", ctx=tracing.extract_from(d),
                                      version=version, n_running=self.engine.n_running)
        with self._wp_lock:
            store = self._wp_store
            if store is None or store.version != version or self._wp_state != "ready":
                if cut_span is not None:
                    cut_span.end(error="not holding")
                return _json({"success": False,
                              "error": f"not holding v{version} (state={self._wp_state})"}, 409)
        n_running = self.engine.n_running
        try:
            params, v = assemble_params(store)
            cut_s = self.engine.cutover_params(
                params, version=v, allow_interrupt=bool(d.get("allow_interrupt", True)),
                timeout_s=max(120.0, budget_s * 10.0))
            del params
        except Exception as e:
            logger.exception("weight-plane cutover failed")
            if cut_span is not None:
                cut_span.end(error=repr(e))
            return _json({"success": False, "error": repr(e)}, 500)
        with self._wp_lock:
            self._wp_cutover_ms = cut_s * 1000.0
            # The exit record's split of kernel launches before and after
            # the last cutover.
            self._launches_at_cutover = dict(kernels.launches)
        self._last_load_info = {"source": "weight_plane", "version": version,
                                "load_s": self._wp_transfer_ms / 1000.0}
        within = budget_s <= 0.0 or cut_s <= budget_s
        if not within:
            logger.warning(f"weight cutover v{version} took {cut_s:.3f}s, over the "
                           f"{budget_s:.3f}s budget")
        logger.info(f"weight-plane cutover to v{version}: {cut_s * 1000:.1f}ms "
                    f"({n_running} request(s) interrupted)")
        if cut_span is not None:
            cut_span.end(cutover_s=cut_s, within_budget=within, n_paused=n_running)
        return _json({"success": True, "cutover_ms": cut_s * 1000.0,
                      "transfer_ms": self._wp_transfer_ms, "within_budget": within,
                      "num_paused_requests": n_running})

    def _h_weights_manifest(self, headers, body: bytes, query=None) -> Response:
        with self._wp_lock:
            store = self._wp_store
        return serve_store_manifest(store, query or {})

    def _h_weights_chunk(self, headers, body: bytes, query=None) -> Response:
        """Peer hop: serve a verified chunk to a sibling, during this
        server's own fetch too (deeper tree levels pipeline)."""
        faults.maybe_fail("weight_plane.serve_chunk")
        with self._wp_lock:
            store = self._wp_store
        resp, served = serve_store_chunk(store, query or {}, headers)
        if served:
            with self._wp_lock:
                self._wp_chunks_served += 1
                self._wp_bytes_served += served
        return resp

    def _h_metrics(self, headers, body: bytes, query=None) -> Response:
        m = self.engine.metrics()
        snap = self.engine.latency_snapshot()
        rpc_snap = rpc.stats.snapshot()
        lines = [
            f"areal:num_running_reqs {m['num_running_reqs']}",
            f"areal:num_used_tokens {m['num_used_tokens']}",
            f"areal:total_generated_tokens {m['total_generated']}",
            f"areal:queue_depth {m['queue_depth']}",
            f"areal:queued_prompt_tokens {m['queued_prompt_tokens']}",
            f"areal:load_shed_total {float(self._n_shed)}",
            f"areal:ttft_p50_ms {snap['ttft_p50_ms']}",
            f"areal:ttft_p99_ms {snap['ttft_p99_ms']}",
            f"areal:itl_p50_ms {snap['itl_p50_ms']}",
            f"areal:itl_p99_ms {snap['itl_p99_ms']}",
            f"areal:ttft_hist {encode_counts(snap['ttft_counts']) or '-'}",
            f"areal:itl_hist {encode_counts(snap['itl_counts']) or '-'}",
            f"areal:num_interrupted_reqs {float(self._n_interrupted)}",
            f"areal:weight_version {float(self.engine.version)}",
            f"areal:kv_pages_free {m['kv_pages_free']}",
            f"areal:kv_pages_total {m['kv_pages_total']}",
            f"areal:moe_drop_rate {m.get('moe_drop_rate', 0.0)}",
            f"areal:moe_router_entropy {m.get('moe_router_entropy', 0.0)}",
            f"areal:role {self.role}",
            f"areal:model_id {self.cfg.model_id or '-'}",
            f"areal:elastic {1.0 if self.cfg.role == 'unified' else 0.0}",
            f"areal:kv_export_total {m['kv_export_total']}",
            f"areal:kv_export_bytes {m['kv_export_bytes']}",
            f"areal:last_kv_export_ms {m['last_kv_export_ms']}",
            f"areal:kv_import_total {m['kv_import_total']}",
            f"areal:kv_import_bytes {m['kv_import_bytes']}",
            f"areal:last_kv_import_ms {m['last_kv_import_ms']}",
            f"areal:last_kv_transfer_ms {self._last_kv_transfer_ms}",
            f"areal:kv_handoff_ok {float(self._handoff_ok)}",
            f"areal:kv_handoff_failed {float(self._handoff_failed)}",
            f"areal:kv_handoff_fallback {float(self._handoff_fallback)}",
            f"areal:kv_spill_total {m['kv_spill_total']}",
            f"areal:kv_spill_bytes {m['kv_spill_bytes']}",
            f"areal:kv_spill_tokens {m['kv_spill_tokens']}",
            f"areal:kv_restore_total {m['kv_restore_total']}",
            f"areal:kv_restore_host {m['kv_restore_host']}",
            f"areal:kv_restore_disk {m['kv_restore_disk']}",
            f"areal:kv_restore_tokens {m['kv_restore_tokens']}",
            f"areal:kv_prefix_lost_total {m['kv_prefix_lost_total']}",
            f"areal:kv_tier_host_bytes {m.get('kv_tier_host_bytes', 0.0)}",
            f"areal:kv_tier_disk_bytes {m.get('kv_tier_disk_bytes', 0.0)}",
            f"areal:kv_tier_host_entries {m.get('kv_tier_host_entries', 0.0)}",
            f"areal:kv_tier_disk_entries {m.get('kv_tier_disk_entries', 0.0)}",
            f"areal:kv_tier_misses {m.get('kv_tier_misses', 0.0)}",
            f"areal:kv_tier_corrupt_dropped {m.get('kv_tier_dropped_corrupt', 0.0)}",
            f"areal:kv_tier_peer_hits {float(self._kv_peer_hits)}",
            f"areal:kv_tier_peer_bytes {float(self._kv_peer_bytes)}",
            f"areal:kv_tier_peer_failed {float(self._kv_peer_failed)}",
            f"areal:draining {1.0 if self._draining else 0.0}",
            f"areal:kv_migrated_out {float(self._drain_state.get('migrated', 0))}",
            f"areal:kv_drain_lost {float(self._drain_state.get('lost', 0))}",
            f"areal:kv_accepted {float(self._kv_accepted)}",
            f"areal:kv_accept_bytes {float(self._kv_accept_bytes)}",
            f"areal:last_kv_restore_ms {self._last_kv_restore_ms}",
            f"areal:kv_manifests_served {float(self._kv_manifests_served)}",
            f"areal:kv_chunks_served {float(self._kv_chunks_served)}",
            f"areal:num_preempted_reqs {m['num_preempted_reqs']}",
            f"areal:prefix_cache_hits {m['prefix_cache_hits']}",
            f"areal:prefix_tokens_reused {m['prefix_tokens_reused']}",
            f"areal:prefix_cached_tokens {m['prefix_cached_tokens']}",
            f"areal:total_requests {m['total_requests']}",
            f"areal:spec_tokens_per_step {m['spec_tokens_per_step']}",
            f"areal:spec_emitted_tokens {m['spec_emitted_tokens']}",
            f"areal:spec_active_steps {m['spec_active_steps']}",
            f"areal:rpc_attempts {float(rpc_snap['attempts'])}",
            f"areal:rpc_retries {float(rpc_snap['retries'])}",
            f"areal:rpc_failures {float(rpc_snap['failures'])}",
            f"areal:rpc_hedges {float(rpc_snap['hedges'])}",
            f"areal:rpc_hedge_wins {float(rpc_snap['hedge_wins'])}",
            f"areal:rpc_hedge_cancelled {float(rpc_snap['hedge_cancelled'])}",
            f"areal:rpc_hedge_failures {float(rpc_snap['hedge_failures'])}",
            f"areal:rpc_deadline_expired {float(rpc_snap['deadline_expired'])}",
            f"areal:rpc_breaker_rejections {float(rpc_snap['breaker_rejections'])}",
            f"areal:rpc_breaker_opens {float(rpc_snap['breaker_opens'])}",
            f"areal:last_weight_swap_s {m['last_weight_swap_s']}",
            f"areal:last_weight_stage_s {m['last_weight_stage_s']}",
            f"areal:last_weight_load_s "
            f"{self._last_load_info['load_s'] if self._last_load_info else 0.0}",
            f"areal:weight_load_fast_path "
            f"{1.0 if (self._last_load_info or {}).get('source') == 'shm_raw' else 0.0}",
            # The weight plane: transfer (overlaps serving) and cutover
            # (the interrupt + swap window) are separate numbers.
            f"areal:weight_transfer_ms {self._wp_transfer_ms}",
            f"areal:weight_cutover_ms {self._wp_cutover_ms}",
            f"areal:weight_verify_ms {self._wp_verify_ms}",
            f"areal:weight_bytes_from_origin {float(self._wp_bytes_from_origin)}",
            f"areal:weight_bytes_from_peers {float(self._wp_bytes_from_peers)}",
            f"areal:weight_chunks_served {float(self._wp_chunks_served)}",
            f"areal:weight_bytes_served {float(self._wp_bytes_served)}",
            f"areal:weight_expected_bytes {float(self._wp_expected_bytes)}",
            f"areal:weight_ingress_payload_equivalents {self._wp_ingress_eq}",
            f"areal:weight_wire {self._wp_wire}",
            # Weight shards are refused at boot: never sharded.
            "areal:weight_shard -",
        ]
        return _text("\n".join(lines) + "\n")

    def _h_health(self, headers, body: bytes, query=None) -> Response:
        return _json({"status": "ok", "version": self.engine.version, "role": self.role})

    # ------------------------------------------------------------------

    def _poll(self) -> Optional[PollResult]:
        # Exit when the experiment completes; on COMPLETE, first outlive
        # the trial's gserver manager, which fans the last trained
        # version out before it leaves, and let that version go live.
        try:
            status = name_resolve.get(
                names.experiment_status(self.cfg.experiment_name, self.cfg.trial_name))
            if status == "ABORT":
                return None
            if status == "COMPLETE":
                if self._complete_at is None:
                    self._complete_at = time.monotonic()
                if ((not self._manager_alive() and not self.engine.update_pending)
                        or time.monotonic() - self._complete_at > LAST_FANOUT_WAIT_S):
                    return None
        except name_resolve.NameEntryNotFoundError:
            pass
        time.sleep(0.2)
        return PollResult(batch_count=0)

    def _manager_alive(self) -> bool:
        """True while the trial's gserver manager beats and has not
        stopped."""
        try:
            record = json.loads(name_resolve.get(names.health(
                self.cfg.experiment_name, self.cfg.trial_name, "gserver_manager")))
        except (name_resolve.NameEntryNotFoundError, ValueError):
            return False
        return (not record.get("stopped")
                and time.time() - float(record.get("ts", 0))
                <= float(record.get("ttl", health.default_ttl())) * health.STALE_FACTOR)

    def _exit_hook(self):
        try:
            self.engine.stop()
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(timeout=5)
        except Exception:
            pass
        try:
            self._write_exit_record()
        except Exception:
            logger.warning("exit record not written", exc_info=True)

    def _write_exit_record(self):
        """What this process did on its device, for the launcher to read
        after the run: its weight version, the port's kernel launches, the
        peak device memory and host RSS, the engine's metrics, the handoff
        counters and the weight plane's last transfer.
        /metrics keeps the reference's lines only, so these travel in a file:
        ``<log path>/exit_records/<worker name>.json``."""
        import resource

        import torch

        dev = self.engine.device
        record = {
            "worker": self.worker_name,
            "version": self.engine.version,
            "launches": dict(kernels.launches),
            "launches_at_cutover": dict(self._launches_at_cutover),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0),
            "metrics": self.engine.metrics(),
            "handoff": {"ok": self._handoff_ok, "failed": self._handoff_failed,
                        "fallback": self._handoff_fallback,
                        "last_transfer_ms": self._last_kv_transfer_ms},
            # ru_maxrss is in KiB on Linux.
            "max_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "weight_plane": {"transfer_ms": self._wp_transfer_ms,
                             "verify_ms": self._wp_verify_ms,
                             "cutover_ms": self._wp_cutover_ms,
                             "bytes_from_origin": self._wp_bytes_from_origin,
                             "bytes_from_peers": self._wp_bytes_from_peers,
                             "bytes_served": self._wp_bytes_served, "wire": self._wp_wire},
        }
        write_exit_record(self.cfg.experiment_name, self.cfg.trial_name,
                          self.worker_name, record)
