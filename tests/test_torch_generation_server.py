"""Port parity of the generation server over HTTP: a reference
GenerationServer (JAX on the CPU) and areal_tpu_torch's
(``device="cpu"``) run in one process on the tiny model of
tests/test_torch_serving.py, each under its own experiment name, with
both packages' name_resolve on one nfs root. The same raw dump goes into
both through ``/update_weights_from_disk``; then:

- greedy ``/generate`` outputs are identical (logprobs within rtol 1e-4),
  with the same response keys, for fresh prompts and for priority-0
  continuations that hit the qid prefix cache;
- the expired-deadline, shed, stale-update and chaos-refusal paths give
  the same status, ``Retry-After`` and body keys;
- ``/metrics`` has the same line names in the same order, idle and after
  the requests, with equal values on the deterministic counters
  (latency lines are compared by name only);
- ``/health`` is equal, each package's name_resolve reads the URL the
  other registered, and the heartbeat records carry the same fields;
- the port refuses every unported option at boot; the weight plane's
  routes answer a server holding nothing as the reference's do;
- with ``speculative_draft_len=2`` and ``decode_weight_dtype="int8"`` a
  port server and a reference server give equal greedy tokens and equal
  ``areal:spec_*`` lines, and each package's gserver manager parses the
  same fleet yield from those ``/metrics`` and logs it alike.
"""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request
import uuid

import jax
import numpy as np
import pytest

from areal_tpu.api.config import ModelAbstraction as RefModel
from areal_tpu.api.system_api import GenerationServerConfig as RefConfig
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import names as ref_names
from areal_tpu.models.config import TransformerConfig as RefTransformerConfig
from areal_tpu.models.transformer import init_params
from areal_tpu.system.weight_transfer import dump_raw_params
from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.api.system_api import GenerationServerConfig
from areal_tpu_torch.base import name_resolve, names
from tests.test_torch_serving import TINY

SERVER_KW = dict(max_concurrent_requests=4, max_seq_len=128, kv_page_size=16,
                 decode_block_steps=4, prompt_bucket=16, prefix_cache_tokens=4096, seed=0)
# Counters both servers must agree on exactly after the same requests.
DETERMINISTIC = ("areal:total_generated_tokens", "areal:total_requests",
                 "areal:prefix_cache_hits", "areal:prefix_tokens_reused",
                 "areal:prefix_cached_tokens", "areal:weight_version", "areal:kv_pages_total",
                 "areal:kv_pages_free", "areal:load_shed_total", "areal:num_preempted_reqs",
                 "areal:num_interrupted_reqs", "areal:queue_depth",
                 "areal:queued_prompt_tokens", "areal:num_running_reqs", "areal:role",
                 "areal:elastic", "areal:weight_wire", "areal:weight_shard")
# Latency lines: compared by name only.
TIMING = ("ttft", "itl", "last_weight", "weight_load")


def _start(worker, cfg):
    worker.configure(cfg, experiment_name=cfg.experiment_name, trial_name=cfg.trial_name,
                     worker_name=cfg.worker_name)
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    return thread


def _stop(worker, thread):
    worker.exit()
    thread.join(timeout=30)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Both servers running, loaded with one raw dump at version 1."""
    from areal_tpu.system.generation_server import GenerationServer as RefServer
    from areal_tpu_torch.system.generation_server import GenerationServer

    import areal_tpu.engine.factories  # noqa: F401  (the reference's model registry)

    tmp = tmp_path_factory.mktemp("gserver")
    saved = ref_nr._default.repo, name_resolve._default.repo
    ref_nr.reconfigure("nfs", record_root=str(tmp / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp / "nr"))
    run_id = uuid.uuid4().hex[:6]
    ref_cfg = RefConfig(experiment_name=f"ref-{run_id}", trial_name="t0",
                        model=RefModel("tpu_transformer", args=dict(config=dict(TINY))),
                        **SERVER_KW)
    port_cfg = GenerationServerConfig(
        experiment_name=f"port-{run_id}", trial_name="t0",
        model=ModelAbstraction("tpu_transformer", args=dict(config=dict(TINY))),
        device="cpu", **SERVER_KW)
    ref, port = RefServer(), GenerationServer()
    threads = []
    try:
        threads.append((ref, _start(ref, ref_cfg)))
        threads.append((port, _start(port, port_cfg)))
        tree = jax.tree_util.tree_map(
            np.asarray, init_params(RefTransformerConfig(**TINY), jax.random.PRNGKey(0)))
        dump_dir = str(tmp / "realloc" / "actor")
        dump_raw_params(tree, dump_dir, version=1)
        fleet = dict(ref=ref, port=port, ref_cfg=ref_cfg, port_cfg=port_cfg,
                     dump_dir=dump_dir, metrics_idle={})
        for side in ("ref", "port"):
            fleet["metrics_idle"][side] = get(fleet[side].address, "/metrics")[2].decode()
            status, _, body = post(fleet[side].address, "/update_weights_from_disk",
                                   {"model_path": dump_dir, "allow_interrupt": True,
                                    "version": 1})
            assert status == 200, body
            reply = json.loads(body)
            assert reply["success"] and reply["source"] == "disk_raw", reply
            fleet[side + "_load"] = reply
        yield fleet
    finally:
        for worker, thread in threads:
            _stop(worker, thread)
        ref_nr._default.repo.reset()
        name_resolve._default.repo.reset()
        ref_nr._default.repo, name_resolve._default.repo = saved


def _call(req, timeout=120):
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def post(url, path, payload, headers=None):
    return _call(urllib.request.Request(
        url + path, json.dumps(payload).encode(),
        {"Content-Type": "application/json", **(headers or {})}))


def get(url, path):
    return _call(urllib.request.Request(url + path))


def both(fleet, fn):
    return fn(fleet["ref"].address), fn(fleet["port"].address)


def parse_metrics(text):
    out = []
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        out.append((name, value))
    return out


def assert_same_metrics(ref_text, port_text):
    ref_m, port_m = parse_metrics(ref_text), parse_metrics(port_text)
    assert [n for n, _ in port_m] == [n for n, _ in ref_m]
    assert ref_text.endswith("\n") and port_text.endswith("\n")
    ref_d, port_d = dict(ref_m), dict(port_m)
    for name in ref_d:
        if any(t in name for t in TIMING):
            continue
        if name in DETERMINISTIC or name.endswith(("_total", "_bytes", "_ms")):
            assert port_d[name] == ref_d[name], name
    return ref_d, port_d


@pytest.mark.timeout(120)
def test_idle_metrics_lines_match(fleet):
    ref_d, port_d = assert_same_metrics(fleet["metrics_idle"]["ref"],
                                        fleet["metrics_idle"]["port"])
    assert port_d["areal:weight_version"] == "0.0"
    assert set(fleet["port_load"]) == set(fleet["ref_load"])


@pytest.mark.timeout(120)
def test_greedy_generate_matches_the_reference_server(fleet):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, TINY["vocab_size"], size=n).tolist() for n in (5, 20, 37, 12)]
    outs = {"ref": [], "port": []}
    for side in outs:
        url = fleet[side].address
        for i, p in enumerate(prompts):
            status, headers, body = post(url, "/generate", {
                "qid": f"g{i}", "input_ids": p,
                "gconfig": {"max_new_tokens": 10, "greedy": True}})
            assert status == 200, body
            assert headers["Content-Type"] == "application/json; charset=utf-8"
            outs[side].append(json.loads(body))
        # Continuations of the two prompts longer than a page: priority 0,
        # prompt + output + fresh tokens, served from the parked prefix.
        for i in (1, 2):
            first = outs[side][i]
            status, _, body = post(url, "/generate", {
                "qid": f"g{i}", "priority": 0,
                "input_ids": prompts[i] + first["output_ids"] + [1, 2, 3],
                "gconfig": {"max_new_tokens": 6, "greedy": True}})
            assert status == 200, body
            outs[side].append(json.loads(body))
    for a, b in zip(outs["ref"], outs["port"]):
        assert set(b) == set(a)
        assert b["output_ids"] == a["output_ids"], a["qid"]
        np.testing.assert_allclose(b["output_logprobs"], a["output_logprobs"],
                                   rtol=1e-4, atol=1e-5)
        for k in ("qid", "no_eos", "interrupted", "version_start", "version_end"):
            assert b[k] == a[k], k
        assert a["version_start"] == 1
    text = both(fleet, lambda u: get(u, "/metrics")[2].decode())
    _, port_d = assert_same_metrics(*text)
    assert float(port_d["areal:prefix_cache_hits"]) == 2.0


@pytest.mark.timeout(120)
def test_refusal_paths_match(fleet, monkeypatch):
    body = {"qid": "late", "input_ids": [1, 2, 3], "gconfig": {"max_new_tokens": 2}}
    ref, port = both(fleet, lambda u: post(u, "/generate", body, {"X-Areal-Deadline": "0"}))
    assert ref[0] == port[0] == 429
    assert ref[1]["Retry-After"] == port[1]["Retry-After"] == "0"
    assert json.loads(port[2]) == json.loads(ref[2])

    def shed(url):
        assert post(url, "/configure", {"max_queue_depth": 0})[0] == 200
        try:
            return post(url, "/generate", body)
        finally:
            assert post(url, "/configure", {"max_queue_depth": None})[0] == 200

    ref, port = both(fleet, shed)
    assert ref[0] == port[0] == 429
    assert ref[1]["Retry-After"] == port[1]["Retry-After"] == "1"
    assert json.loads(port[2]) == json.loads(ref[2])

    stale = {"model_path": fleet["dump_dir"], "allow_interrupt": True, "version": 1}
    ref, port = both(fleet, lambda u: post(u, "/update_weights_from_disk", stale))
    assert ref[0] == port[0] == 200
    assert json.loads(port[2]) == json.loads(ref[2]) == {
        "success": True, "stale": True, "num_paused_requests": 0}

    # A version no dump holds: both load paths retry briefly, then 500.
    monkeypatch.setenv("AREAL_WEIGHT_LOAD_RETRIES", "2")
    monkeypatch.setenv("AREAL_WEIGHT_LOAD_RETRY_S", "0.01")
    missing = {"model_path": fleet["dump_dir"], "version": 7}
    ref, port = both(fleet, lambda u: post(u, "/update_weights_from_disk", missing))
    assert ref[0] == port[0] == 500
    assert set(json.loads(port[2])) == set(json.loads(ref[2])) == {"success", "error"}

    chaos = {"faults": "gserver.generate=raise"}
    ref, port = both(fleet, lambda u: post(u, "/configure", chaos))
    assert ref[0] == port[0] == 403
    assert json.loads(port[2]) == json.loads(ref[2])


@pytest.mark.timeout(120)
def test_health_and_discovery_cross_packages(fleet):
    ref, port = both(fleet, lambda u: get(u, "/health"))
    assert ref[0] == port[0] == 200
    assert json.loads(port[2]) == json.loads(ref[2]) == {
        "status": "ok", "version": 1, "role": "unified"}
    rc, pc = fleet["ref_cfg"], fleet["port_cfg"]
    # Each package's name_resolve reads the URL the other registered.
    assert name_resolve.get(names.gen_server_url(rc.experiment_name, "t0", "0")) \
        == fleet["ref"].address
    assert ref_nr.get(ref_names.gen_server_url(pc.experiment_name, "t0", "0")) \
        == fleet["port"].address
    assert ref_nr.get_subtree(ref_names.gen_servers(pc.experiment_name, "t0")) \
        == [fleet["port"].address]
    beats = [json.loads(ref_nr.get(ref_names.health(c.experiment_name, "t0", c.worker_name)))
             for c in (rc, pc)]
    assert set(beats[1]) == set(beats[0])
    assert beats[1]["url"] == fleet["port"].address and beats[1]["draining"] is False


@pytest.mark.timeout(120)
@pytest.mark.parametrize("path,method", [
    ("/distribute_weights", "POST"), ("/cutover_weights", "POST"),
    ("/weights/manifest", "GET"), ("/weights/chunk", "GET"),
])
def test_unported_routes_answer_404(fleet, path, method):
    """The weight plane's routes (ported since; tests/test_torch_weight_plane.py
    drives them) answer a server that holds no prefetched version as the
    reference's does: the /weights GETs 404, a cutover 409, a distribute
    of a malformed manifest 400. Unknown routes still 404."""
    payload = {"/distribute_weights": {"version": 3, "manifest": {"schema": "bad"}},
               "/cutover_weights": {"version": 3}}.get(path)
    query = "?version=3&idx=0" if path == "/weights/chunk" else ""

    def call(url):
        url += path + query
        req = (urllib.request.Request(url, json.dumps(payload).encode(),
                                      {"Content-Type": "application/json"})
               if method == "POST" else urllib.request.Request(url))
        return _call(req)

    ref, port = both(fleet, call)
    assert port[0] == ref[0] == {"/distribute_weights": 400, "/cutover_weights": 409}.get(
        path, 404)
    assert set(json.loads(port[2])) == set(json.loads(ref[2]))
    assert get(fleet["port"].address, "/weights/unknown")[0] == 404
    assert get(fleet["port"].address, "/generate")[0] == 405


@pytest.mark.parametrize("option", [
    dict(tensor_parallel=2), dict(weight_shard_rank=0, weight_shard_degree=2),
    dict(weight_shard_degree=2),
])
def test_unported_options_are_refused_at_boot(option):
    from areal_tpu_torch.system.generation_server import GenerationServer

    cfg = GenerationServerConfig(
        experiment_name="refuse", trial_name="t0", device="cpu",
        model=ModelAbstraction("tpu_transformer", args=dict(config=dict(TINY))), **option)
    with pytest.raises(NotImplementedError):
        GenerationServer()._configure(cfg)


@pytest.mark.timeout(120)
def test_chaos_control_and_a_dead_engine_match(fleet, monkeypatch):
    """With AREAL_CHAOS_HTTP on, /configure arms a fault point in each
    server's own process-global injector: the next /generate fails with
    the same 500 in both and the hit counts agree. A dead engine loop
    answers /generate with the same 500 body in both."""
    monkeypatch.setenv("AREAL_CHAOS_HTTP", "1")
    # Each injector counts every /generate its process served, so earlier
    # tests in this process that called one package's server alone would
    # make the counts differ: start both from zero.
    for side in ("ref", "port"):
        assert post(fleet[side].address, "/configure", {"faults_reset": True})[0] == 200
    body = {"qid": "chaos", "input_ids": [1, 2, 3], "gconfig": {"max_new_tokens": 2}}
    typo = {"faults": "gserver.generat=raise"}
    ref, port = both(fleet, lambda u: post(u, "/configure", typo))
    assert ref[0] == port[0] == 400
    assert set(json.loads(port[2])) == set(json.loads(ref[2])) == {"success", "error"}
    arm = {"faults": "gserver.generate=raise", "faults_hits": ["gserver.generate"]}
    ref, port = both(fleet, lambda u: post(u, "/configure", arm))
    assert ref[0] == port[0] == 200
    assert set(json.loads(port[2])) == set(json.loads(ref[2]))
    try:
        ref, port = both(fleet, lambda u: post(u, "/generate", body))
        assert ref[0] == port[0] == 500
        assert port[2] == ref[2]
        hits = {"faults_hits": ["gserver.generate"]}
        ref, port = both(fleet, lambda u: post(u, "/configure", hits))
        assert json.loads(port[2])["faults_hits"] == json.loads(ref[2])["faults_hits"]
        assert json.loads(port[2])["faults_armed"] == ["gserver.generate"]
    finally:
        for side in ("ref", "port"):
            assert post(fleet[side].address, "/configure", {"faults_reset": True})[0] == 200
    engines = fleet["ref"].engine, fleet["port"].engine
    try:
        for eng in engines:
            eng.fatal_error = RuntimeError("engine gone")
        ref, port = both(fleet, lambda u: post(u, "/generate", body))
        assert ref[0] == port[0] == 500
        assert json.loads(port[2]) == json.loads(ref[2])
    finally:
        for eng in engines:
            eng.fatal_error = None


# ---------------------------------------------------------------------------
# Speculative decoding and int8 decode weights behind the server
# ---------------------------------------------------------------------------

SPEC_KW = dict(SERVER_KW, speculative_draft_len=2, decode_weight_dtype="int8",
               prefix_cache_tokens=None)
SPEC_LINES = ("areal:spec_tokens_per_step", "areal:spec_emitted_tokens",
              "areal:spec_active_steps")


def _settled_metrics(url):
    """/metrics once two reads 50 ms apart agree on the deterministic lines:
    the engine refreshes its page snapshot on the lap after a request's
    reply."""
    prev = None
    for _ in range(100):
        text = get(url, "/metrics")[2].decode()
        now = [kv for kv in parse_metrics(text) if kv[0] in DETERMINISTIC]
        if now == prev:
            return text
        prev = now
        time.sleep(0.05)
    return text


@pytest.fixture(scope="module")
def spec_fleet(tmp_path_factory):
    """A reference and a port server with both options on, loaded with one
    raw dump at version 1, each served one greedy wave."""
    from areal_tpu.system.generation_server import GenerationServer as RefServer
    from areal_tpu_torch.system.generation_server import GenerationServer

    import areal_tpu.engine.factories  # noqa: F401  (the reference's model registry)

    tmp = tmp_path_factory.mktemp("gserver_spec")
    saved = ref_nr._default.repo, name_resolve._default.repo
    ref_nr.reconfigure("nfs", record_root=str(tmp / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp / "nr"))
    run_id = uuid.uuid4().hex[:6]
    ref_cfg = RefConfig(experiment_name=f"sref-{run_id}", trial_name="t0",
                        model=RefModel("tpu_transformer", args=dict(config=dict(TINY))),
                        **SPEC_KW)
    port_cfg = GenerationServerConfig(
        experiment_name=f"sport-{run_id}", trial_name="t0",
        model=ModelAbstraction("tpu_transformer", args=dict(config=dict(TINY))),
        device="cpu", **SPEC_KW)
    ref, port = RefServer(), GenerationServer()
    threads = []
    try:
        threads.append((ref, _start(ref, ref_cfg)))
        threads.append((port, _start(port, port_cfg)))
        tree = jax.tree_util.tree_map(
            np.asarray, init_params(RefTransformerConfig(**TINY), jax.random.PRNGKey(1)))
        dump_dir = str(tmp / "realloc" / "actor")
        dump_raw_params(tree, dump_dir, version=1)
        rng = np.random.default_rng(5)
        prompts = []
        for n in (6, 19, 33, 11):
            p = rng.integers(0, TINY["vocab_size"], size=n).tolist()
            prompts.append(p + p[:5] * 2)  # a repeated span to draft from
        fleet = dict(ref=ref, port=port, outs={}, metrics={})
        for side in ("ref", "port"):
            url = fleet[side].address
            status, _, body = post(url, "/update_weights_from_disk",
                                   {"model_path": dump_dir, "allow_interrupt": True,
                                    "version": 1})
            assert status == 200, body
            outs = []
            for i, p in enumerate(prompts):
                status, _, body = post(url, "/generate", {
                    "qid": f"s{i}", "input_ids": p,
                    "gconfig": {"max_new_tokens": 24, "greedy": True}})
                assert status == 200, body
                outs.append(json.loads(body))
            fleet["outs"][side] = outs
            fleet["metrics"][side] = _settled_metrics(url)
        yield fleet
    finally:
        for worker, thread in threads:
            _stop(worker, thread)
        ref_nr._default.repo.reset()
        name_resolve._default.repo.reset()
        ref_nr._default.repo, name_resolve._default.repo = saved


@pytest.mark.timeout(180)
def test_spec_and_int8_weights_match_the_reference_server(spec_fleet):
    for a, b in zip(spec_fleet["outs"]["ref"], spec_fleet["outs"]["port"]):
        assert b["output_ids"] == a["output_ids"], a["qid"]
        np.testing.assert_allclose(b["output_logprobs"], a["output_logprobs"],
                                   rtol=1e-4, atol=1e-5)
        assert (b["no_eos"], b["version_start"]) == (a["no_eos"], a["version_start"])
    ref_d, port_d = assert_same_metrics(spec_fleet["metrics"]["ref"],
                                        spec_fleet["metrics"]["port"])
    for name in SPEC_LINES:
        assert port_d[name] == ref_d[name], name
    assert float(port_d["areal:spec_emitted_tokens"]) > float(port_d["areal:spec_active_steps"])
    assert spec_fleet["port"].engine._qparams is not None


def _manager_pair(urls):
    """Each package's manager, built as tests/test_torch_rollout_parts.py
    builds them, with the state its /metrics poll folds into."""
    from tests.test_torch_rollout_parts import _port_manager, _ref_manager

    out = []
    for make in (_ref_manager, _port_manager):
        m = make(urls=urls)
        for attr in ("_server_gen_totals", "_server_spec_emitted", "_server_spec_steps",
                     "_server_prefix_hits", "_server_prefix_reused", "_server_gen_reqs"):
            setattr(m, attr, {u: 0.0 for u in urls})
        for attr in ("_server_ttft_hist", "_server_itl_hist", "_server_total_pages",
                     "_server_elastic", "_rerole_orig", "_server_kv", "_server_shards"):
            setattr(m, attr, {})
        out.append(m)
    return out


@pytest.mark.timeout(120)
def test_managers_parse_and_log_the_fleet_yield_alike(spec_fleet):
    import logging

    from areal_tpu_torch.system import gserver_manager as tgm

    urls = [spec_fleet["ref"].address, spec_fleet["port"].address]
    ref_m, port_m = _manager_pair(urls)
    for m in (ref_m, port_m):
        asyncio.run(m._poll_metrics())
    assert port_m._server_spec_emitted == ref_m._server_spec_emitted
    assert port_m._server_spec_steps == ref_m._server_spec_steps
    assert port_m._server_gen_totals == ref_m._server_gen_totals
    steps = sum(ref_m._server_spec_steps.values())
    assert steps > 0
    # The reference's log suffix, from its own parsed sums.
    want = f" spec_tokens_per_step={sum(ref_m._server_spec_emitted.values()) / steps:.2f}"
    port_m.rollout_stat = type("Stat", (), {"as_dict": lambda self: {}})()
    port_m._last_gen_total, port_m._last_throughput_log = 0.0, 0.0
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab(level=logging.INFO)
    tgm.logger.addHandler(grab)  # the package's loggers do not propagate
    try:
        port_m._log_throughput(10.0)
        assert lines and lines[-1].endswith(want)
        # Speculation off fleet-wide: no yield in the line.
        port_m._server_spec_steps = {u: 0.0 for u in urls}
        port_m._log_throughput(20.0)
        assert len(lines) == 2 and "spec_tokens_per_step" not in lines[-1]
    finally:
        tgm.logger.removeHandler(grab)
