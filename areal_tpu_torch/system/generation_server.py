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
- ``GET /health``.

HTTP runs on the standard library's ``ThreadingHTTPServer`` (HTTP/1.1,
``Content-Length`` on every response, the JSON content type aiohttp's
``json_response`` sends), one thread a request. A ``/generate`` thread
does no device work: it submits to the engine and waits for the
request's ``done_cb``; a weight update loads and stages on its own
request thread while the engine loop keeps decoding.

Not ported yet (they answer 404 and are refused at boot when
configured): ``/drain``, ``/set_role`` and roles other than "unified";
``/kv_handoff*`` and ``/kv/*`` (KV tier, handoff, peer restore);
``/distribute_weights``, ``/cutover_weights`` and ``/weights/*`` (the
weight plane, sharded weights); tensor parallelism, speculative
decoding, int8 decode weights; HF checkpoints and tokenizers. A
``decode_url`` or ``kv_source`` in a ``/generate`` body is ignored: the
request is served here with a full prefill, the reference's own
fallback.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import urlsplit

from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.api.system_api import GenerationServerConfig
from areal_tpu_torch.base import (
    constants, env_registry, logging, name_resolve, names, network, rpc, seeding, tracing)
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.base.latency import encode_counts
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.system.worker_base import PollResult, Worker

logger = logging.getLogger("generation_server")

# (status, body, content type, extra headers)
Response = Tuple[int, bytes, str, Dict[str, str]]


def _json(payload: Any, status: int = 200, headers: Optional[Dict[str, str]] = None) -> Response:
    # aiohttp's json_response: json.dumps with default separators.
    return status, json.dumps(payload).encode(), "application/json; charset=utf-8", headers or {}


def _text(text: str, status: int = 200) -> Response:
    return status, text.encode(), "text/plain; charset=utf-8", {}


def make_model(model: ModelAbstraction, seed: int, device):
    """(TransformerConfig, params) of a ``tpu_transformer`` abstraction:
    ``args["config"]`` holds TransformerConfig fields, and the params are
    random, drawn from ``seed`` (a checkpoint comes later, through
    ``/update_weights_from_disk``)."""
    if model is None or model.type_ != "tpu_transformer":
        raise ValueError(f"unknown model {model!r}: the port builds 'tpu_transformer'")
    args = dict(model.args)
    if args.get("model_path") is not None:
        raise NotImplementedError("loading an HF checkpoint is not ported yet "
                                  "(ROADMAP Queue A item 3)")
    cfg = TransformerConfig(**{**args["config"], "is_critic": bool(args.get("is_critic", False))})
    return cfg, init_params(cfg, seed=seed, device=device)


def _refuse_unported(config: GenerationServerConfig):
    """Fail at boot on any option whose feature the port lacks, rather
    than serve without it."""
    if config.role not in ("unified", "prefill", "decode"):
        raise ValueError(f"role must be unified/prefill/decode, got {config.role!r}")
    refused = {
        "role": config.role != "unified",
        "tensor_parallel": config.tensor_parallel > 1,
        "weight_shard_rank": config.weight_shard_rank is not None,
        "weight_shard_degree": config.weight_shard_degree is not None,
        "kv_tier_bytes": config.kv_tier_bytes is not None,
        "kv_tier_disk_dir": config.kv_tier_disk_dir is not None,
        "kv_tier_disk_bytes": config.kv_tier_disk_bytes is not None,
        "kv_spill_dtype": config.kv_spill_dtype is not None,
        "speculative_draft_len": config.speculative_draft_len > 0,
        "decode_weight_dtype": config.decode_weight_dtype not in (None, "model"),
        "model_path": config.model_path is not None,
        "tokenizer_path": config.tokenizer_path is not None,
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            f"the port's generation server does not support {bad} yet "
            f"(ROADMAP Queue A): leave them at their defaults")


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # aiohttp's listen backlog: a fleet's burst of concurrent requests
    # must queue, not be reset (socketserver's default is 5).
    request_queue_size = 128

    def __init__(self, addr, owner: "GenerationServer"):
        self.owner = owner
        super().__init__(addr, _Handler)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        self.server.owner._dispatch(self, "GET")

    def do_POST(self):
        self.server.owner._dispatch(self, "POST")

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)


class GenerationServer(Worker):
    def _configure(self, config: GenerationServerConfig):
        _refuse_unported(config)
        self.cfg = config
        constants.set_experiment_trial_names(config.experiment_name, config.trial_name)
        seeding.set_random_seed(config.seed, config.worker_name)
        model_cfg, params = make_model(config.model, config.seed, config.device)
        # No tokenizer yet: clients name their stop tokens (gconfig
        # stop_token_ids).
        self.engine = ServingEngine(
            cfg=model_cfg,
            params=params,
            max_batch_size=config.max_concurrent_requests,
            max_seq_len=config.max_seq_len,
            decode_block_steps=config.decode_block_steps,
            eos_token_id=None,
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
            device=config.device,
        )
        del params
        self.engine.start()
        if config.warm_on_start:
            # Warm before discovery registration below.
            self.engine.warm([config.prompt_bucket])
        self.role = config.role
        self._counter_lock = threading.Lock()
        self._n_interrupted = 0
        self._n_shed = 0
        self._last_load_info = None

        self._routes: Dict[str, Dict[str, Callable[[Any, bytes], Response]]] = {
            "/generate": {"POST": self._h_generate},
            "/configure": {"POST": self._h_configure},
            "/update_weights_from_disk": {"POST": self._h_update_weights},
            "/metrics": {"GET": self._h_metrics},
            "/health": {"GET": self._h_health},
        }
        host = network.gethostip()
        self._httpd = _HTTPServer((host, 0), self)
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
        payload["draining"] = False
        return payload

    # ------------------------------------------------------------------
    # HTTP
    # ------------------------------------------------------------------

    def _dispatch(self, handler: BaseHTTPRequestHandler, method: str):
        """Route one request and write its response (on the request's
        own thread). Unknown paths answer 404, a known path with another
        method 405, and a handler's exception 500, as aiohttp does."""
        length = int(handler.headers.get("Content-Length") or 0)
        body = handler.rfile.read(length) if length else b""
        methods = self._routes.get(urlsplit(handler.path).path)
        extra: Dict[str, str] = {}
        if methods is None:
            resp = _text("404: Not Found", 404)
        elif method not in methods:
            resp = _text("405: Method Not Allowed", 405)
            extra = {"Allow": ",".join(sorted(methods))}
        else:
            try:
                resp = methods[method](handler.headers, body)
            except Exception:
                logger.exception(f"error handling {method} {handler.path}")
                resp = _text("500 Internal Server Error\n\nServer got itself in trouble", 500)
        status, data, ctype, headers = resp
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        for k, v in {**headers, **extra}.items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(data)

    def _admission_overloaded(self) -> Optional[float]:
        """Backpressure watermark check: the Retry-After seconds when
        /generate must shed, None when the request may queue. Reads only
        host counters the engine maintains (no device sync)."""
        cfg = self.cfg
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

    def _h_generate(self, headers, body: bytes) -> Response:
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
        req = self._gen_request_from(d, d.get("gconfig", {}))
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
            with self._counter_lock:
                self._n_interrupted += 1
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
    def _gen_response(res) -> Dict:
        return {
            "qid": res.qid,
            "output_ids": res.output_ids,
            "output_logprobs": res.output_logprobs,
            "no_eos": res.no_eos,
            "interrupted": res.interrupted,
            "version_start": res.version_start,
            "version_end": res.version_end,
            "latency": res.latency,
        }

    def _h_configure(self, headers, body: bytes) -> Response:
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

    def _h_update_weights(self, headers, body: bytes) -> Response:
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
        """Fastest source first: tmpfs raw, disk raw, pickle
        (system/weight_transfer.load_for_serving); a pinned version that
        no dump holds raises WeightVersionMismatch after brief retries.
        The tmpfs dump is keyed by the role name, the basename of the
        realloc dump dir."""
        from areal_tpu_torch.system.weight_transfer import load_for_serving, shm_transfer_dir

        role = os.path.basename(model_path.rstrip("/"))
        shm = shm_transfer_dir(self.cfg.experiment_name, self.cfg.trial_name, role)
        return load_for_serving(model_path, shm_dir=shm, want_version=want_version)

    def _h_metrics(self, headers, body: bytes) -> Response:
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
            # KV handoff, the KV tier's peer pulls, drain migration and the
            # weight plane are not ported: their lines read what a
            # reference server that never used them reads.
            f"areal:last_kv_transfer_ms {0.0}",
            f"areal:kv_handoff_ok {0.0}",
            f"areal:kv_handoff_failed {0.0}",
            f"areal:kv_handoff_fallback {0.0}",
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
            f"areal:kv_tier_peer_hits {0.0}",
            f"areal:kv_tier_peer_bytes {0.0}",
            f"areal:kv_tier_peer_failed {0.0}",
            f"areal:draining {0.0}",
            f"areal:kv_migrated_out {0.0}",
            f"areal:kv_drain_lost {0.0}",
            f"areal:kv_accepted {0.0}",
            f"areal:kv_accept_bytes {0.0}",
            f"areal:last_kv_restore_ms {0.0}",
            f"areal:kv_manifests_served {0.0}",
            f"areal:kv_chunks_served {0.0}",
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
            f"areal:weight_transfer_ms {0.0}",
            f"areal:weight_cutover_ms {0.0}",
            f"areal:weight_verify_ms {0.0}",
            f"areal:weight_bytes_from_origin {0.0}",
            f"areal:weight_bytes_from_peers {0.0}",
            f"areal:weight_chunks_served {0.0}",
            f"areal:weight_bytes_served {0.0}",
            f"areal:weight_expected_bytes {0.0}",
            f"areal:weight_ingress_payload_equivalents {0.0}",
            "areal:weight_wire raw",
            "areal:weight_shard -",
        ]
        return _text("\n".join(lines) + "\n")

    def _h_health(self, headers, body: bytes) -> Response:
        return _json({"status": "ok", "version": self.engine.version, "role": self.role})

    # ------------------------------------------------------------------

    def _poll(self) -> Optional[PollResult]:
        # Exit when the experiment completes.
        try:
            status = name_resolve.get(
                names.experiment_status(self.cfg.experiment_name, self.cfg.trial_name))
            if status in ("COMPLETE", "ABORT"):
                return None
        except name_resolve.NameEntryNotFoundError:
            pass
        time.sleep(0.2)
        return PollResult(batch_count=0)

    def _exit_hook(self):
        try:
            self.engine.stop()
            self._httpd.shutdown()
            self._httpd.server_close()
            self._http_thread.join(timeout=5)
        except Exception:
            pass

