"""Port parity of disaggregated serving and the KV plane, on the CPU with
the tiny float32 model of tests/test_torch_serving.py (one numpy param
set, so the JAX reference and the port compute the same model).

Engines (``engine/serving.py`` of both packages):

- a prefill engine's export, imported by a decode engine of either
  package (float and int8 pools), continues with the greedy tokens of a
  unified engine; a blob on the lossy int8 or fp8 wire continues alike
  in both packages;
- prefixes evicted past the prefix-cache budget spill to the tier and
  restore for their continuations with the tokens of an engine that
  never evicted them, with ``kv_prefix_lost_total`` 0 and counters
  equal to the reference's;
- an import at another weight version raises KVHandoffVersionMismatch.

Servers (``system/generation_server.py``, in one process, weights from
one raw dump):

- a port prefill + decode pair behind the port's manager, and the mixed
  pairs (a reference prefill server handing off to a port decode server
  and the other way round), give a unified server's greedy tokens;
- ``/kv/chunk`` serves ``Range`` slices and a torn chunk pull resumes
  mid-chunk; ``/drain`` through the manager's ``/drain_server`` migrates
  every parked prefix to a peer's tier, GET ``/drain`` reports it, the
  server leaves, and a continuation of a migrated session restores there
  with the unified tokens; ``/set_role`` answers as the reference's.

Manager (``system/gserver_manager.py``): the pool routing, the prefix
index's hints and the re-role decisions equal the reference manager's
on the same scripted fleet state; the options still unported raise (the
weight plane's are ported: tests/test_torch_weight_plane.py).
"""

import asyncio
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
import zlib

import jax
import numpy as np
import pytest

from areal_tpu.engine import kv_handoff as ref_kvh
from areal_tpu.engine.serving import GenRequest as RefRequest
from areal_tpu.engine.serving import ServingEngine as RefEngine
from areal_tpu.models.config import TransformerConfig as RefConfig
from areal_tpu.models.transformer import init_params
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.engine import kv_handoff as kvh
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.models.config import TransformerConfig
from tests.test_torch_serving import TINY

V = TINY["vocab_size"]
PAGE = 16
ENGINE_KW = dict(max_batch_size=4, max_seq_len=256, decode_block_steps=4, page_size=PAGE,
                 prefix_cache_tokens=4096)


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, init_params(RefConfig(**TINY), jax.random.PRNGKey(4)))


def _run(engine, reqs, timeout=120):
    results, done = {}, threading.Event()

    def cb(res):
        results[res.qid] = res
        if len(results) == len(reqs):
            done.set()

    for r in reqs:
        r.done_cb = cb
        engine.submit(r)
    assert done.wait(timeout), f"only {len(results)}/{len(reqs)} finished"
    return results


def _toks(seed, n):
    return np.random.default_rng(seed).integers(0, V, size=n).tolist()


@pytest.fixture(scope="module")
def engines(tree):
    """side -> pool -> role -> started engine; side is 'ref' or 'port',
    pool 'model' or 'int8', role 'prefill', 'decode' or 'unified'."""
    made = {}
    ref_params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    port_params = params_from_numpy(tree, device="cpu")
    for side in ("ref", "port"):
        for pool in ("model", "int8"):
            for i, role in enumerate(("prefill", "decode", "unified")):
                kw = dict(ENGINE_KW, seed=10 + i, kv_cache_dtype=None if pool == "model" else pool)
                e = (RefEngine(RefConfig(**TINY), ref_params, **kw) if side == "ref" else
                     ServingEngine(TransformerConfig(**TINY), port_params, device="cpu", **kw))
                e.start()
                made.setdefault(side, {}).setdefault(pool, {})[role] = e
    yield made
    for side in made.values():
        for pool in side.values():
            for e in pool.values():
                e.stop()


def _req(side, **kw):
    return (RefRequest if side == "ref" else GenRequest)(**kw)


@pytest.mark.parametrize("pool", ["model", "int8"])
@pytest.mark.parametrize("direction", ["port->port", "port->ref", "ref->port"])
def test_export_import_matches_unified_greedy(engines, direction, pool):
    src, dst = direction.split("->")
    qid = f"h-{direction}-{pool}"
    prompt = _toks(zlib.crc32(qid.encode()) % 1000, 40)
    pre = engines[src]["model"]["prefill"]
    dec = engines[dst][pool]["decode"]
    uni = engines[dst][pool]["unified"]
    first = _run(pre, [_req(src, qid=qid, input_ids=list(prompt), max_new_tokens=1,
                            greedy=True)])[qid].output_ids
    meta, payload = pre.export_kv_handoff(qid)
    assert meta["n_tokens"] == len(prompt) and meta["tokens"] == prompt
    assert meta["kv_wire"] == "float32"
    with pytest.raises(KeyError):  # the export consumed the park
        pre.export_kv_handoff(qid)
    hits0 = dec.prefix_cache_hits
    dec.import_kv_handoff(meta, payload)
    rest = _run(dec, [_req(dst, qid=qid, input_ids=list(prompt) + first, max_new_tokens=8,
                           greedy=True, priority=0)])[qid].output_ids
    assert dec.prefix_cache_hits == hits0 + 1  # a one-token delta prefill
    want = _run(uni, [_req(dst, qid="u" + qid, input_ids=list(prompt), max_new_tokens=9,
                           greedy=True)])["u" + qid].output_ids
    assert first + rest == want


@pytest.mark.parametrize("compress", ["int8", "fp8"])
@pytest.mark.parametrize("pool", ["model", "int8"])
@pytest.mark.parametrize("src", ["port", "ref"])
def test_compressed_wire_imports_alike_in_both_packages(engines, src, pool, compress):
    """A quantized wire is lossy, so the check is the packages against
    each other: one blob, imported by each package's decode engine,
    continues with the same greedy tokens."""
    qid = f"c-{src}-{pool}-{compress}"
    prompt = _toks(zlib.crc32(qid.encode()) % 1000, 40)
    pre = engines[src]["model"]["prefill"]
    first = _run(pre, [_req(src, qid=qid, input_ids=list(prompt), max_new_tokens=1,
                            greedy=True)])[qid].output_ids
    meta, payload = pre.export_kv_handoff(qid, compress=compress)
    assert meta["kv_wire"] == compress
    # 1-byte data plus a float32 scale per 16-value vector, against float32.
    assert len(payload) == 2 * 2 * len(prompt) * (16 + 4)
    rest = {}
    for side in ("port", "ref"):
        dec = engines[side][pool]["decode"]
        dec.import_kv_handoff(meta, payload)
        rest[side] = _run(dec, [_req(side, qid=qid, input_ids=list(prompt) + first,
                                     max_new_tokens=8, greedy=True,
                                     priority=0)])[qid].output_ids
    assert rest["port"] == rest["ref"] and len(rest["port"]) == 8


def _wait_spills(engine, n, timeout=30):
    deadline = time.monotonic() + timeout
    while engine.metrics()["kv_spill_total"] < n:
        assert time.monotonic() < deadline, engine.metrics()
        time.sleep(0.02)


@pytest.mark.parametrize("pool,spill_dtype", [("model", None), ("int8", None),
                                              ("model", "fp8")])
def test_spill_restore_matches_never_evicted(tree, pool, spill_dtype):
    """Four 48-token sessions against a 64-token prefix budget: each park
    evicts (spills) the older ones; every continuation restores from the
    tier. Tokens equal an engine with room for all; counters equal the
    reference's."""
    kv_dtype = None if pool == "model" else pool
    ref_params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    port_params = params_from_numpy(tree, device="cpu")
    prompts = {f"s{i}": _toks(100 + i, 48) for i in range(4)}
    out = {}
    for side in ("ref", "port"):
        def make(**kw):
            kw = dict(ENGINE_KW, kv_cache_dtype=kv_dtype, **kw)
            if side == "ref":
                return RefEngine(RefConfig(**TINY), ref_params, **kw)
            return ServingEngine(TransformerConfig(**TINY), port_params, device="cpu", **kw)

        tiered = make(prefix_cache_tokens=64, kv_tier_bytes=1 << 24, kv_spill_dtype=spill_dtype)
        roomy = make()
        tiered.start()
        roomy.start()
        try:
            toks = {}
            for e, tag in ((tiered, "t"), (roomy, "r")):
                for q, p in prompts.items():
                    res = _run(e, [_req(side, qid=q, input_ids=list(p), max_new_tokens=6,
                                        greedy=True)])[q]
                    toks[tag, q, 1] = res.output_ids
            _wait_spills(tiered, 3)
            restored = []
            for e, tag in ((tiered, "t"), (roomy, "r")):
                for q, p in prompts.items():
                    cont = list(p) + toks[tag, q, 1] + _toks(200, 5)
                    if e is tiered:
                        restored.append(e.restore_from_tier(q, cont))
                    res = _run(e, [_req(side, qid=q, input_ids=cont, max_new_tokens=6,
                                        greedy=True, priority=0)])[q]
                    toks[tag, q, 2] = res.output_ids
            m = tiered.metrics()
            out[side] = (toks, restored, {k: m[k] for k in (
                "kv_spill_total", "kv_spill_tokens", "kv_restore_total", "kv_restore_host",
                "kv_restore_tokens", "kv_prefix_lost_total", "prefix_cache_hits",
                "kv_tier_put_total", "kv_tier_host_hits", "kv_tier_misses")})
        finally:
            tiered.stop()
            roomy.stop()
    toks, restored, counters = out["port"]
    for q in prompts:
        if spill_dtype is None:  # the float and int8 wires restore exactly
            assert toks["t", q, 2] == toks["r", q, 2], q
        assert toks["t", q, 1] == toks["r", q, 1]
    assert counters["kv_spill_total"] >= 3 and counters["kv_restore_total"] >= 3
    assert counters["kv_prefix_lost_total"] == 0
    assert sum(1 for n in restored if n) == counters["kv_restore_total"]
    assert out["port"][1:] == out["ref"][1:]
    assert out["port"][0] == out["ref"][0]


def test_import_at_another_version_raises(engines):
    for side, exc in (("port", kvh.KVHandoffVersionMismatch),
                      ("ref", ref_kvh.KVHandoffVersionMismatch)):
        pre = engines[side]["model"]["prefill"]
        dec = engines[side]["model"]["decode"]
        qid = f"v-{side}"
        _run(pre, [_req(side, qid=qid, input_ids=_toks(7, 40), max_new_tokens=1, greedy=True)])
        meta, payload = pre.export_kv_handoff(qid)
        n0 = dec.kv_imports
        with pytest.raises(exc):
            dec.import_kv_handoff(dict(meta, version=meta["version"] + 1), payload)
        assert dec.kv_imports == n0
        with pytest.raises(KeyError):
            pre.export_kv_handoff("never-parked")


# ---------------------------------------------------------------------------
# Servers
# ---------------------------------------------------------------------------

SERVER_KW = dict(max_concurrent_requests=4, max_seq_len=256, kv_page_size=PAGE,
                 decode_block_steps=4, prompt_bucket=16, prefix_cache_tokens=4096, seed=0)


def _start(worker, cfg):
    worker.configure(cfg, experiment_name=cfg.experiment_name, trial_name=cfg.trial_name,
                     worker_name=cfg.worker_name)
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    worker.thread = thread
    return worker


def _http(url, payload=None, headers=None, timeout=120):
    """(status, headers, body bytes); a JSON POST when payload is given."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json",
                                             **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(url, path, payload):
    status, _, body = _http(url + path, payload)
    return status, json.loads(body)


def _metrics(url):
    return dict(line.split(" ", 1) for line in _http(url + "/metrics")[2].decode().splitlines())


def _body(qid, prompt, max_new, **extra):
    return {"qid": qid, "input_ids": list(prompt),
            "gconfig": {"max_new_tokens": max_new, "greedy": True}, **extra}


@pytest.fixture(scope="module")
def fleet(tree, tmp_path_factory):
    """Port servers P (prefill), D and X (decode, with a tier) behind a
    port manager with the prefix index; U (unified, with a tier) alone;
    reference servers RP (prefill) and RD (decode, with a tier), each in
    an experiment of its own. All load one raw dump at version 1."""
    from areal_tpu.api.config import ModelAbstraction as RefModel
    from areal_tpu.api.system_api import GenerationServerConfig as RefServerConfig
    from areal_tpu.base import name_resolve as ref_nr
    from areal_tpu.system.generation_server import GenerationServer as RefServer
    from areal_tpu.system.weight_transfer import dump_raw_params
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenerationServerConfig, GserverManagerConfig
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.gserver_manager import GserverManager

    import areal_tpu.engine.factories  # noqa: F401  (the reference's model registry)

    tmp = tmp_path_factory.mktemp("disagg")
    saved = ref_nr._default.repo, name_resolve._default.repo
    saved_root = os.environ.get("AREAL_FILEROOT")
    os.environ["AREAL_FILEROOT"] = str(tmp / "fileroot")
    ref_nr.reconfigure("nfs", record_root=str(tmp / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp / "nr"))
    run = uuid.uuid4().hex[:6]
    dump_dir = str(tmp / "dump" / "actor")
    dump_raw_params(tree, dump_dir, version=1)
    tier = dict(kv_tier_bytes=1 << 24)
    workers = {}
    try:
        def port(name, exp, index, **kw):
            workers[name] = _start(GenerationServer(), GenerationServerConfig(
                experiment_name=exp, trial_name="t0", server_index=index, device="cpu",
                model=ModelAbstraction("tpu_transformer", args=dict(config=dict(TINY))),
                **SERVER_KW, **kw))

        def ref(name, exp, **kw):
            workers[name] = _start(RefServer(), RefServerConfig(
                experiment_name=exp, trial_name="t0",
                model=RefModel("tpu_transformer", args=dict(config=dict(TINY))),
                **SERVER_KW, **kw))

        split = f"split-{run}"
        port("P", split, 0, role="prefill")
        port("D", split, 1, role="decode", **tier)
        port("X", split, 2, role="decode", **tier)
        port("U", f"uni-{run}", 0, **tier)
        ref("RP", f"rp-{run}", role="prefill")
        ref("RD", f"rd-{run}", role="decode", **tier)
        for name, w in workers.items():
            status, reply = _post(w.address, "/update_weights_from_disk", {
                "model_path": dump_dir, "allow_interrupt": True, "version": 1})
            assert status == 200 and reply["success"], (name, reply)
        workers["M"] = _start(GserverManager(), GserverManagerConfig(
            experiment_name=split, trial_name="t0", n_servers=3, train_batch_size=4,
            max_head_offpolicyness=8, kv_index_size=1024, schedule_policy="round_robin"))
        # The manager learns the roles from the heartbeats and /metrics.
        want = {workers[n].address: r for n, r in (("P", "prefill"), ("D", "decode"),
                                                    ("X", "decode"))}
        deadline = time.monotonic() + 30
        while json.loads(_http(workers["M"].address + "/status")[2])["pools"]["roles"] != want:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        yield workers
    finally:
        for w in workers.values():
            w.exit()
        for w in workers.values():
            w.thread.join(timeout=30)
        ref_nr._default.repo.reset()
        name_resolve._default.repo.reset()
        ref_nr._default.repo, name_resolve._default.repo = saved
        # The fault injectors are process-global: leave no hit counts
        # behind for the next module's servers.
        from areal_tpu.base.fault_injection import faults as ref_faults
        from areal_tpu_torch.base.fault_injection import faults

        ref_faults.reset()
        faults.reset()
        if saved_root is None:
            os.environ.pop("AREAL_FILEROOT", None)
        else:
            os.environ["AREAL_FILEROOT"] = saved_root


def _unified(fleet, qid, prompt, max_new):
    status, out = _post(fleet["U"].address, "/generate", _body("u-" + qid, prompt, max_new))
    assert status == 200, out
    return out["output_ids"]


def test_split_pair_behind_the_manager_gives_unified_tokens(fleet):
    from areal_tpu_torch.api.model_api import GenerationHyperparameters
    from areal_tpu_torch.system.partial_rollout import PartialRolloutManager

    prompt = _toks(31, 40)
    before = _metrics(fleet["P"].address)
    prm = PartialRolloutManager(fleet["M"].address, request_timeout=120)

    async def go():
        try:
            return await prm.generate_group(
                "g0", prompt, GenerationHyperparameters(n=2, max_new_tokens=10, greedy=True))
        finally:
            await prm.close()

    out = asyncio.run(go())
    want = _unified(fleet, "g0", prompt, 10)
    assert [s[len(prompt):] for s in out.seqs] == [want, want]
    after = _metrics(fleet["P"].address)
    assert float(after["areal:kv_handoff_ok"]) - float(before["areal:kv_handoff_ok"]) == 2
    assert float(after["areal:kv_export_total"]) - float(before["areal:kv_export_total"]) == 2
    assert after["areal:kv_handoff_fallback"] == "0.0" and after["areal:role"] == "prefill"
    imports = sum(float(_metrics(fleet[n].address)["areal:kv_import_total"]) for n in "DX")
    assert imports >= 2


@pytest.mark.parametrize("pair", ["RP->D", "P->RD"])
def test_mixed_pairs_give_unified_tokens(fleet, pair):
    pre, dec = (fleet[n] for n in pair.split("->"))
    prompt = _toks(41 if pair == "RP->D" else 43, 40)
    status, out = _post(pre.address, "/generate",
                        _body(f"mix-{pair}", prompt, 9, decode_url=dec.address))
    assert status == 200, out
    assert "fallback" not in out["disagg"], out["disagg"]
    assert out["disagg"]["decode_url"] == dec.address and out["disagg"]["handoff_bytes"] > 0
    assert out["output_ids"] == _unified(fleet, f"mix-{pair}", prompt, 9)
    assert out["version_start"] == out["version_end"] == 1


def test_kv_chunk_serves_ranges_and_a_torn_pull_resumes(fleet, monkeypatch):
    from areal_tpu_torch.system import generation_server as gs

    outs = {}
    for name in ("D", "RD"):
        url = fleet[name].address
        assert _post(url, "/generate", _body("r0", _toks(51, 40), 4))[0] == 200
        status, _, raw = _http(url + "/kv/manifest?qid=r0")
        assert status == 200, raw
        man = json.loads(raw)
        status, _, full = _http(url + "/kv/chunk?qid=r0")
        assert status == 200 and len(full) == man["meta"]["chunks"]["total_bytes"]
        status, hdrs, part = _http(url + "/kv/chunk?qid=r0", headers={"Range": "bytes=100-299"})
        assert status == 206 and part == full[100:300]
        assert hdrs["Content-Range"] == f"bytes 100-299/{len(full)}"
        assert _http(url + "/kv/chunk?qid=r0", headers={
            "Range": f"bytes={len(full)}-"})[0] == 416
        assert _http(url + "/kv/chunk?qid=nope")[0] == 404
        assert _http(url + "/kv/manifest?qid=nope")[0] == 404
        outs[name] = (sorted(man), man["schema"], man["meta"]["kv_wire"], len(full))
    assert outs["D"] == outs["RD"]

    # A pull from the port's D whose first answer tears mid-chunk: the
    # next attempt asks for the rest of that chunk only.
    d = fleet["D"]
    meta = json.loads(_http(d.address + "/kv/manifest?qid=r0")[2])["meta"]
    _, _, full = _http(d.address + "/kv/chunk?qid=r0")
    real, ranges = gs.http_request, []

    def tearing(url, payload=None, headers=None, timeout=600.0):
        ranges.append((headers or {}).get("Range"))
        status, hdrs, body = real(url, payload, headers, timeout)
        return (status, hdrs, body[: len(body) // 2]) if len(ranges) == 1 else (status, hdrs, body)

    monkeypatch.setattr(gs, "http_request", tearing)
    got = d._fetch_handoff_payload(d.address, "r0", meta, path="/kv/chunk")
    assert got == full
    first_len = min(meta["chunks"]["chunk_bytes"], len(full))
    assert ranges[0] == f"bytes=0-{first_len - 1}"
    assert ranges[1] == f"bytes={first_len // 2}-{first_len - 1}"


def test_a_corrupt_kv_chunk_is_fetched_again(fleet):
    """The ``gserver.kv_chunk_bytes`` chaos point corrupts the bytes a
    server sends after their hash was minted: the puller's sha256 check
    rejects the chunk and fetches it again, so the payload arrives
    intact."""
    from areal_tpu_torch.base.fault_injection import faults

    d = fleet["D"]
    assert _post(d.address, "/generate", _body("cx", _toks(53, 40), 4))[0] == 200
    meta = json.loads(_http(d.address + "/kv/manifest?qid=cx")[2])["meta"]
    _, _, full = _http(d.address + "/kv/chunk?qid=cx")
    faults.reset()  # hits count from here: the next one is corrupted
    faults.arm("gserver.kv_chunk_bytes", "corrupt", at_hit=1, times=1)
    try:
        got = d._fetch_handoff_payload(d.address, "cx", meta, path="/kv/chunk")
        assert faults.hits("gserver.kv_chunk_bytes") >= 2
    finally:
        faults.reset()
    assert got == full


def test_set_role_answers_as_the_reference(fleet):
    answers = {}
    for name in ("D", "RD"):
        url = fleet[name].address
        status, flip = _post(url, "/set_role", {"role": "unified"})
        assert status == 200 and _metrics(url)["areal:role"] == "unified"
        assert json.loads(_http(url + "/health")[2])["role"] == "unified"
        status_back, back = _post(url, "/set_role", {"role": "decode"})
        bad = _post(url, "/set_role", {"role": "sideways"})
        answers[name] = (status, sorted(flip), flip["previous"], back["previous"], bad[0],
                         sorted(bad[1]), _metrics(url)["areal:role"],
                         _metrics(url)["areal:elastic"])
    assert answers["D"] == answers["RD"]
    assert answers["D"][4] == 400


def test_drain_through_the_manager_migrates_and_leaves(fleet):
    """X parks three sessions, the manager drains it: every prefix
    migrates into D's tier (P has no tier and refuses), GET /drain
    reports it, X deregisters and its worker ends; the manager's index
    then routes a continuation to D, which restores it with U's tokens."""
    from areal_tpu_torch.base import name_resolve, names

    x, d, m = fleet["X"], fleet["D"], fleet["M"]
    prompts = {f"dr{i}": _toks(60 + i, 40) for i in range(3)}
    outs = {}
    for q, p in prompts.items():
        status, out = _post(x.address, "/generate", _body(q, p, 5))
        assert status == 200
        outs[q] = out["output_ids"]
    status, res = _post(m.address, "/drain_server", {"url": x.address, "reason": "test"})
    assert status == 200 and res["success"] and x.address not in res["migrate_to"]
    # GET /drain reports progress until the server leaves (it exits as
    # soon as the migration is done, so the last poll may find it gone).
    reports = []
    deadline = time.monotonic() + 60
    while x.thread.is_alive():
        try:
            reports.append(json.loads(_http(x.address + "/drain", timeout=5)[2]))
        except OSError:
            break
        assert time.monotonic() < deadline, reports[-1:]
        time.sleep(0.01)
    x.thread.join(timeout=30)
    assert not x.thread.is_alive()
    assert reports and all(r["draining"] and r["reason"] == "test" for r in reports)
    st = x._drain_state  # the final report (GET /drain's body, in process)
    assert st["done"] and st["held"] >= 3 and st["migrated"] == st["held"], st
    assert st["lost"] == 0 and st["stale_dropped"] == 0
    with pytest.raises(name_resolve.NameEntryNotFoundError):
        name_resolve.get(names.gen_server_url(x.cfg.experiment_name, "t0", "2"))
    held = {e["qid"]: e["tier"] for e in json.loads(_http(d.address + "/kv/index")[2])["held"]}
    assert all(held.get(q) == "host" for q in prompts), held
    assert float(_metrics(d.address)["areal:kv_accepted"]) >= 3

    q = "dr1"
    cont = prompts[q] + outs[q] + _toks(70, 20)
    deadline = time.monotonic() + 30
    while True:  # the index learns D's tier on the metrics poll; X is gone
        status = json.loads(_http(m.address + "/status")[2])
        if (status["kv_tier"]["index_by_tier"].get("host", 0) >= 3
                and x.address in status["evicted_servers"]):
            break
        assert time.monotonic() < deadline, (status["kv_tier"], status["evicted_servers"])
        time.sleep(0.2)
    assert x.address not in status["pools"]["decode"]
    _, sched = _post(m.address, "/schedule_request",
                     {"qid": q, "prompt_len": len(cont), "new_token_budget": 6})
    assert sched["policy"] == "kv-index" and sched["url"] == d.address, sched
    restores = float(_metrics(d.address)["areal:kv_restore_total"])
    status, out = _post(d.address, "/generate", _body(q, cont, 6, priority=0))
    assert status == 200
    assert float(_metrics(d.address)["areal:kv_restore_total"]) == restores + 1
    assert out["output_ids"] == _unified(fleet, q + "c", cont, 6)
    status, st = _post(m.address, "/drain_server", {"url": x.address})
    assert status == 409 and not st["success"]


# ---------------------------------------------------------------------------
# The manager's pools, index and re-roles against the reference's
# ---------------------------------------------------------------------------


def _managers():
    from tests.test_torch_rollout_parts import A, B, C, _port_manager, _ref_manager

    out = []
    for make in (_ref_manager, _port_manager):
        m = make(affinity_saturation_requests=6)
        for attr, val in (("_server_total_pages", {}), ("_server_elastic", {}),
                          ("_rerole_orig", {}), ("_rerole_log", []), ("_last_rerole", 0.0),
                          ("_drain_deadline", {})):
            setattr(m, attr, type(val)(val) if not isinstance(val, float) else val)
        out.append(m)
    return out, (A, B, C)


def _pool_script(m, urls):
    """Pool routing over every branch: pairing by queued prompt tokens and
    free pages, affinity to the decode side, the index's hint, a failure
    retry, a shed and a saturated holder, a drain, a degenerate split and
    a unified server that wins both pools."""
    A, B, C = urls
    out = []
    route = lambda **meta: out.append(m._route(meta))  # noqa: E731
    m._server_roles.update({A: "prefill", B: "decode", C: "unified"})
    m._server_queued_toks.update({A: 300.0, B: 0.0, C: 100.0})
    m._server_free_pages.update({B: 50.0, C: 80.0})
    for i in range(4):
        route(qid=f"f{i}/0", prompt_len=40 + 10 * i, new_token_budget=16)
    route(qid="f0/0", prompt_len=90)  # continuation: the decode side's KV
    m._kv_index_size = 8
    m._prefix_index["ix/0"] = {"url": B, "tier": "host", "n_tokens": 64, "version": 0}
    route(qid="ix/0", prompt_len=80)  # the index names the holder
    m._prefix_index["iy/0"] = {"url": C, "tier": "hbm", "n_tokens": 64, "version": 0}
    route(qid="f1/0", prompt_len=70, failed_server_url=A)  # a retry re-pairs
    held = m._affinity["f2/0"]
    m._server_shed_until[held] = float("inf")
    route(qid="f2/0", prompt_len=60)  # holder shedding: spill + kv_source
    m._server_shed_until[held] = 0.0
    m._server_reqs[held] = 9
    route(qid="f2/0", prompt_len=60)  # holder saturated
    route(qid="iy/0", prompt_len=60, new_token_budget=4)
    m._draining.add(B)
    route(qid="n0/0", prompt_len=30)  # B draining: the decode pool shrinks
    m._server_roles[C] = "prefill"
    route(qid="n1/0", prompt_len=30)  # no decode pool left: degenerate
    m._draining.discard(B)
    m._server_roles.update({A: "decode", C: "unified"})
    m._server_reqs.update({A: 9, B: 9, C: 0})
    m._server_queued_toks.update({C: 0.0})
    m._server_tokens_pending.update({A: 0.0, B: 0.0, C: 0.0})
    route(qid="n2/0", prompt_len=30)  # C wins both pools: served locally
    return out, dict(m._affinity)


def test_pool_routing_matches_reference():
    (ref, port), urls = _managers()
    got_ref, got_port = _pool_script(ref, urls), _pool_script(port, urls)
    assert got_port == got_ref
    policies = {r[1] for r in got_port[0]}
    assert {"disagg", "affinity", "kv-index", "spill", "disagg-degenerate",
            "disagg-local"} <= policies
    assert any(r[2] for r in got_port[0]) and any(r[3] for r in got_port[0])


def _rerole_script(m, urls):
    A, B, C = urls
    posted = []
    m._post_set_role = lambda url, role: posted.append((url, role)) or True
    m.cfg.elastic_pools = True
    m.cfg.rerole_cooldown_s = 0.0
    m.cfg.prefill_queue_high_tokens = 500
    m.cfg.prefill_queue_low_tokens = 10
    m.cfg.decode_free_page_min_frac = 0.2
    m._server_roles.update({A: "prefill", B: "decode", C: "unified"})
    m._server_elastic.update({A: False, B: False, C: True})
    m._server_total_pages.update({A: 100.0, B: 100.0, C: 100.0})
    m._server_free_pages.update({A: 90.0, B: 60.0, C: 90.0})
    steps = [
        ({A: 800.0, C: 0.0}, {}),               # prompts queue: C flips to prefill
        ({A: 800.0, C: 900.0}, {}),             # still queued, nothing left to flip
        ({A: 5.0, C: 0.0}, {}),                 # pressure gone: C flips back
        ({A: 0.0, C: 0.0}, {B: 5.0, C: 5.0}),   # decode pages starve: C flips to decode
        ({A: 600.0, C: 0.0}, {B: 10.0, C: 10.0}),  # queued but pages short: no flip
    ]
    trace = []
    for queued, free in steps:
        m._server_queued_toks.update(queued)
        m._server_free_pages.update(free)
        m._maybe_rerole()
        trace.append((dict(m._server_roles), dict(m._rerole_orig),
                       [(e["url"], e["from"], e["to"]) for e in m._rerole_log]))
    return trace, posted


def test_rerole_decisions_match_reference():
    (ref, port), urls = _managers()
    got_ref, got_port = _rerole_script(ref, urls), _rerole_script(port, urls)
    assert got_port == got_ref
    assert got_port[1] == [(urls[2], "prefill"), (urls[2], "unified"), (urls[2], "decode")]


@pytest.mark.parametrize("option", [
    dict(autoscale=True), dict(elastic_fleet=True), dict(standby=True),
    dict(multi_model=True),
])
def test_manager_refuses_what_is_still_unported(option):
    from areal_tpu_torch.api.system_api import GserverManagerConfig
    from areal_tpu_torch.system.gserver_manager import GserverManager

    with pytest.raises(NotImplementedError):
        GserverManager()._configure(GserverManagerConfig(
            experiment_name="refuse", trial_name="t0", **option))
