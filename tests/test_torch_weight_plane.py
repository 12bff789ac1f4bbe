"""Port parity of the weight-distribution plane, on the CPU with the tiny
float32 model of tests/test_torch_serving.py (one numpy param set, so
the JAX reference and the port compute the same model).

Parts, each against the reference:

- ``StreamChunker`` / ``build_chunk_index`` give equal indexes on the
  same bytes;
- both packages' dumps of the same params (float32 and bfloat16 leaves,
  with and without ``wire_dtype="int8"``) are byte-equal in every file:
  bins, ``params.json``, the chunk and layout sidecars;
- ``quantize_wire_leaf`` / ``dequantize_wire_leaf`` are bit-equal;
- ``chunk_manifest_for_dump`` gives equal manifests (sidecar or rebuilt);
- ``plan_fanout`` / ``fanout_edges`` give equal trees (0-9 servers,
  degree 1-4), and a bad degree raises in both;
- a port ``ChunkStore`` fetches from a reference ``WeightPlaneSource``
  and the other way round, to equal assembled leaves;
- a torn chunk resumes with ``Range``, a corrupt peer is rejected by
  hash, a fetch without upstreams fails loudly, a peer store 404s chunks
  it lacks, and shard streams are refused.

Servers and manager (in one process):

- a port server's ``/distribute_weights`` + ``/cutover_weights`` gives a
  reference server's greedy tokens and ``/metrics`` weight lines, on the
  raw and the int8 wire;
- a duplicate distribute joins the fetch in flight, and a superseded
  fetch leaves the stats alone;
- the port manager's chain fanout (degree 1: the origin sends one
  payload, the peers the rest), its re-fanout around a failed mid-chain
  server and the plane bootstrap that readmits it, and mixed fleets both
  ways (the port manager in front of a reference server, the
  reference's in front of a port server).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from areal_tpu.base import chunking as ref_chunking
from areal_tpu.engine import weight_client as ref_wc
from areal_tpu.models.config import TransformerConfig as RefTransformerConfig
from areal_tpu.models.transformer import init_params
from areal_tpu.system import weight_plane as ref_wp
from areal_tpu.system import weight_transfer as ref_wt
from areal_tpu_torch.base import chunking
from areal_tpu_torch.engine import weight_client as wc
from areal_tpu_torch.system import weight_plane as wp
from areal_tpu_torch.system import weight_transfer as wt
from tests.test_torch_serving import TINY

CHUNK = 4096  # several chunks for the tiny model's ~35 KB payload


@pytest.fixture(scope="module")
def tree():
    return jax.tree_util.tree_map(
        np.asarray, init_params(RefTransformerConfig(**TINY), jax.random.PRNGKey(7)))


def _bits(x) -> np.ndarray:
    """Raw bits of a numpy (bf16 too) or torch leaf."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().copy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint8).reshape(-1)


def _same_leaves(port_leaves, ref_leaves):
    assert sorted(port_leaves) == sorted(ref_leaves)
    for k in ref_leaves:
        want = np.asarray(ref_leaves[k])
        got = port_leaves[k]
        assert list(got.shape) == list(want.shape), k
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, k
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=k)


# ---------------------------------------------------------------------------
# Chunking, dumps, the int8 wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,chunk,pieces", [
    (0, 8, [0]), (1, 8, [1]), (64, 8, [64]), (100, 16, [7, 9, 84]),
    (100, 16, [16] * 6 + [4]), (1000, 64, [1] * 50 + [950]), (4099, 4096, [4095, 4]),
])
def test_stream_chunker_equals_build_chunk_index(tmp_path, total, chunk, pieces):
    data = np.random.default_rng(total).integers(0, 256, size=total, dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    want = ref_chunking.build_chunk_index(str(path), chunk)
    assert chunking.build_chunk_index(str(path), chunk) == want
    for pkg in (chunking, ref_chunking):
        c = pkg.StreamChunker(chunk)
        pos = 0
        for n in pieces:
            c.update(data[pos: pos + n])
            pos += n
        assert c.finish() == want
    assert chunking.CHUNK_SCHEMA == ref_chunking.CHUNK_SCHEMA
    assert chunking.DEFAULT_CHUNK_BYTES == ref_chunking.DEFAULT_CHUNK_BYTES
    with pytest.raises(ValueError):
        chunking.StreamChunker(0)


def _dtype_tree(tree, dtype):
    out = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(dtype), tree)
    out["step"] = np.arange(3, dtype=np.int32)  # an integer leaf ships raw
    return out


def _torch_tree(np_tree):
    def conv(v):
        if v.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(v))
    return jax.tree_util.tree_map(conv, np_tree)


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["float32", "bfloat16"])
def test_dumps_with_sidecars_are_byte_equal(tmp_path, tree, dtype, wire):
    params = _dtype_tree(tree, dtype)
    ref_wt.dump_raw_params(params, str(tmp_path / "ref"), version=4, chunk_bytes=CHUNK,
                           wire_dtype=wire)
    wt.dump_raw_params(params, str(tmp_path / "port"), version=4, chunk_bytes=CHUNK,
                       wire_dtype=wire)
    # The port's trainer dumps torch tensors: the same bytes.
    wt.dump_raw_params(_torch_tree(params), str(tmp_path / "port_torch"), version=4,
                       chunk_bytes=CHUNK, wire_dtype=wire)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert "params-v4.chunks.json" in names and "params-v4.layout.json" in names
    assert ("params-v4.int8.bin" in names) == (wire == "int8")
    for d in ("port", "port_torch"):
        assert sorted(os.listdir(tmp_path / d)) == names
        for name in names:
            assert (tmp_path / d / name).read_bytes() == (tmp_path / "ref" / name).read_bytes(), \
                (d, name)
    if wire:
        assert wt.LAST_DUMP_STATS["wire_total_bytes"] == os.path.getsize(
            tmp_path / "port" / "params-v4.int8.bin")
    with pytest.raises(ValueError, match="unsupported"):
        wt.dump_raw_params(params, str(tmp_path / "bad"), version=1, wire_dtype="fp4")


def _wire_cases():
    rng = np.random.default_rng(3)
    ties = (np.arange(-20, 21, dtype=np.float32) * 0.5).reshape(41, 1) * np.ones((1, 3), np.float32)
    ties[0, :] = 127.0 * 0.5 * 2  # the column max sets s = 1, so w / s hits x.5 exactly
    zero_col = rng.standard_normal((6, 4)).astype(np.float32)
    zero_col[:, 2] = 0.0  # s floors at 1e-8 / 127
    return {
        "matrix": rng.standard_normal((16, 8)).astype(np.float32),
        "stacked": (rng.standard_normal((3, 8, 12)) * 0.02).astype(np.float32),
        "ties": ties,
        "zero_column": zero_col,
        "bf16": rng.standard_normal((9, 5)).astype(ml_dtypes.bfloat16),
        "wide_range": (rng.standard_normal((7, 7)) * 10.0 ** rng.integers(-6, 6, (7, 7))
                       ).astype(np.float32),
    }


@pytest.mark.parametrize("case", sorted(_wire_cases()))
def test_wire_quantization_is_bit_equal(case):
    arr = _wire_cases()[case]
    rq, rs = ref_wt.quantize_wire_leaf(arr)
    pq, ps = wt.quantize_wire_leaf(arr)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), rq)
    np.testing.assert_array_equal(ps.numpy().view(np.uint32), rs.view(np.uint32))
    want = ref_wt.dequantize_wire_leaf(rq, rs, arr.dtype)
    got = wt.dequantize_wire_leaf(pq, ps, arr.dtype.name)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert wt._wire_quantizable("layers/attn/wq", arr) == ref_wt._wire_quantizable(
        "layers/attn/wq", arr)
    assert not wt._wire_quantizable("layers/ln1/bias", arr)


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("sidecar", ["dump_time", "rebuilt", "other_chunk_size"])
def test_chunk_manifest_for_dump_matches(tmp_path, tree, wire, sidecar):
    d = str(tmp_path / "dump")
    wt.dump_raw_params(tree, d, version=2, chunk_bytes=CHUNK, wire_dtype="int8")
    chunk = CHUNK
    if sidecar == "rebuilt":
        for name in os.listdir(d):
            if name.endswith(".chunks.json"):
                os.unlink(os.path.join(d, name))
    elif sidecar == "other_chunk_size":
        chunk = CHUNK // 2
    want = ref_wp.chunk_manifest_for_dump(d, chunk, wire=wire)
    assert want is not None and want["chunk_bytes"] == chunk
    assert wp.chunk_manifest_for_dump(d, chunk, wire=wire) == want
    assert wp.chunk_manifest_for_dump(str(tmp_path / "none"), chunk) is None
    assert wp.chunk_manifest_for_dump(d, chunk, wire="fp8") is None


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
@pytest.mark.parametrize("n", list(range(10)))
def test_plan_fanout_matches(n, degree):
    servers = [f"http://s{i}" for i in range(n)]
    want = ref_wp.plan_fanout("http://origin", servers, degree)
    got = wp.plan_fanout("http://origin", servers, degree)
    assert got == want
    assert wp.fanout_edges(got) == ref_wp.fanout_edges(want)
    # The origin uploads to at most `degree` children.
    assert sum(1 for _, p in wp.fanout_edges(got) if p == "http://origin") == min(n, degree)


@pytest.mark.parametrize("degree", [0, -1])
def test_bad_fanout_degree_raises_in_both(degree):
    for pkg in (ref_wp, wp):
        with pytest.raises(ValueError, match="degree"):
            pkg.plan_fanout("http://origin", ["http://s0"], degree)


# ---------------------------------------------------------------------------
# Fetching: sources, stores, peers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dump(tree, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("plane") / "actor")
    wt.dump_raw_params(tree, d, version=1, chunk_bytes=CHUNK, wire_dtype="int8")
    return d


@pytest.fixture
def sources(dump):
    port, ref = wp.WeightPlaneSource(dump, CHUNK).start(), ref_wp.WeightPlaneSource(dump, CHUNK)
    ref.start()
    yield {"port": port, "ref": ref}
    port.close()
    ref.close()


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("direction", ["port_store_ref_source", "ref_store_port_source"])
def test_fetch_crosses_packages(sources, wire, direction):
    src = sources["ref" if direction.endswith("ref_source") else "port"].address
    other = sources["port" if direction.endswith("ref_source") else "ref"].address
    man = wc.fetch_manifest(src, version=1, wire=wire)
    assert man == ref_wc.fetch_manifest(other, version=1, wire=wire)
    store, ref_store = wc.ChunkStore(man), ref_wc.ChunkStore(man)
    if direction == "port_store_ref_source":
        stats = store.fetch([src], origin=src)
        ref_store.fetch([other], origin=other)
    else:
        stats = ref_store.fetch([src], origin=src)
        store.fetch([other], origin=other)
    assert stats["bytes_from_origin"] == man["total_bytes"] and stats["bytes_from_peers"] == 0
    assert bytes(store.buf) == bytes(ref_store.buf)
    _same_leaves(wc.assemble_leaves(store), ref_wc.assemble_leaves(ref_store))
    params, v = wc.assemble_params(store)
    ref_params, ref_v = ref_wc.assemble_params(ref_store)
    assert v == ref_v == 1 and sorted(params) == sorted(ref_params)
    # Each origin counts one payload out for this wire.
    for s in sources.values():
        eq = s.stats()["full_payload_equivalents"].get(1, 0.0)
        assert eq >= 1.0


def test_origin_answers_as_the_reference(sources):
    def call(base, path):
        try:
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    for path in ("/weights/manifest?version=9", "/weights/chunk?version=1&idx=999",
                 "/weights/chunk?idx=1", "/weights/manifest?tp_degree=2&tp_rank=5",
                 "/weights/manifest?wire=fp8", "/weights/stats"):
        ref_status, ref_body = call(sources["ref"].address, path)
        status, body = call(sources["port"].address, path)
        assert status == ref_status, path
        if status != 200:
            assert set(json.loads(body)) == set(json.loads(ref_body)), path
    # A shard stream is refused with a message (the reference serves one).
    status, body = call(sources["port"].address, "/weights/manifest?tp_degree=2&tp_rank=0")
    assert status == 501 and "not ported" in json.loads(body)["error"]
    with pytest.raises(NotImplementedError):
        wc.ChunkStore(dict(wc.fetch_manifest(sources["port"].address), shard={
            "tp_degree": 2, "tp_rank": 0}))
    with pytest.raises(NotImplementedError):
        wp.group_by_shard(["http://a"], {"http://a": (0, 2)})
    assert wp.group_by_shard(["http://a", "http://b"], {}) == ref_wp.group_by_shard(
        ["http://a", "http://b"], {})


def test_torn_chunk_resumes_with_range(sources, monkeypatch):
    src = sources["port"].address
    man = wc.fetch_manifest(src, version=1)
    # The origin serves Range slices: 206 and the chunk's tail.
    req = urllib.request.Request(f"{src}/weights/chunk?version=1&idx=1",
                                 headers={"Range": "bytes=1000-"})
    with urllib.request.urlopen(req, timeout=30) as r:
        tail = r.read()
        assert r.status == 206 and r.headers["X-Chunk-Hash"] == man["hashes"][1]
    store = wc.ChunkStore(man)
    real = wc.ChunkStore._get_range
    torn = set()

    def tearing(self, base_url, idx, start, length, timeout):
        n = real(self, base_url, idx, start, length, timeout)
        if idx not in torn and n > 100:
            torn.add(idx)
            return n // 3  # the connection dropped mid-chunk
        return n

    monkeypatch.setattr(wc.ChunkStore, "_get_range", tearing)
    stats = store.fetch([src], origin=src)
    assert stats["resumed_chunks"] == man["n_chunks"] == len(torn)
    assert bytes(store.chunk(1))[1000:] == tail
    ref_store = ref_wc.ChunkStore(man)
    ref_store.fetch([src], origin=src)
    assert bytes(store.buf) == bytes(ref_store.buf)


def test_corrupt_peer_is_rejected_by_hash(sources):
    src = sources["port"].address
    man = wc.fetch_manifest(src, version=1)
    bad = wp.PeerStoreServer().start()
    try:
        bad.store = wc.ChunkStore(man)
        bad.store.fetch([src], origin=src)
        bad.store.buf[5] ^= 0xFF  # chunk 0 rots after it was verified
        served = []
        for pkg in (wc, ref_wc):
            store = pkg.ChunkStore(man)
            n0 = bad.chunks_served
            stats = store.fetch([bad.address, src], origin=src)
            # The peer's chunk 0 failed its hash on every attempt: it came
            # from the origin, which then stays first (sticky order).
            served.append(bad.chunks_served - n0)
            assert stats["bytes_from_origin"] == man["total_bytes"]
            assert stats["bytes_from_peers"] == 0
            assert all(wc.verify_chunk(store.chunk(i), man["hashes"][i])
                       for i in range(man["n_chunks"]))
        assert served[0] == served[1] >= 1
    finally:
        bad.close()


def test_fetch_without_upstreams_fails_loudly(sources):
    man = wc.fetch_manifest(sources["port"].address, version=1)
    for pkg in (wc, ref_wc):
        with pytest.raises(pkg.WeightFetchError, match="no upstreams"):
            pkg.ChunkStore(man).fetch([])
        dead = pkg.ChunkStore(man)
        with pytest.raises(pkg.WeightFetchError, match="unavailable"):
            dead.fetch(["http://127.0.0.1:9"], timeout=1.0)
        with pytest.raises(pkg.WeightFetchError):
            pkg.assemble_leaves(dead)


def test_peer_store_404s_what_it_lacks(sources):
    src = sources["port"].address
    man = wc.fetch_manifest(src, version=1)
    int8 = wc.fetch_manifest(src, version=1, wire="int8")
    holders = {"port": wp.PeerStoreServer().start(), "ref": ref_wp.PeerStoreServer()}
    holders["ref"].start()
    try:
        got = {}
        for side, h in holders.items():
            h.store = (wc if side == "port" else ref_wc).ChunkStore(man)
            h.store.fetch([src], origin=src)
            h.store._have[2] = False  # a chunk not verified yet
            out = []
            for path in ("/weights/chunk?version=1&idx=2", "/weights/chunk?version=1&idx=0",
                         "/weights/chunk?version=2&idx=0", "/weights/chunk?version=1&idx=0&wire=int8",
                         "/weights/manifest?version=2", "/weights/manifest?wire=int8",
                         "/weights/manifest?version=1", "/weights/chunk?version=x"):
                try:
                    with urllib.request.urlopen(h.address + path, timeout=30) as r:
                        out.append((r.status, r.read()))
                except urllib.error.HTTPError as e:
                    out.append((e.code, e.read()))
            got[side] = out
        assert [s for s, _ in got["port"]] == [s for s, _ in got["ref"]] == [
            404, 200, 404, 404, 404, 404, 200, 400]
        assert got["port"][1][1] == got["ref"][1][1]
        assert json.loads(got["port"][6][1]) == json.loads(got["ref"][6][1]) == man
        assert int8["wire"] == "int8" and int8["total_bytes"] < man["total_bytes"]
    finally:
        for h in holders.values():
            h.close()


def test_distribute_to_stores_chains_through_peers(sources):
    src = sources["port"]
    before = src.stats()["bytes_served"].get(1, 0)
    holders, stats = wp.distribute_to_stores(src.address, 3, 1, version=1)
    try:
        per = list(stats["per_holder"].values())
        assert sum(s["bytes_from_origin"] for s in per) == stats["total_bytes"]
        assert sum(s["bytes_from_peers"] for s in per) == 2 * stats["total_bytes"]
        assert src.stats()["bytes_served"][1] - before == stats["total_bytes"]
        assert all(h.store.complete() for h in holders)
    finally:
        for h in holders:
            h.close()


# ---------------------------------------------------------------------------
# Servers: distribute + cutover, against the reference server
# ---------------------------------------------------------------------------

SERVER_KW = dict(max_concurrent_requests=4, max_seq_len=256, kv_page_size=16,
                 decode_block_steps=4, prompt_bucket=16, prefix_cache_tokens=4096, seed=0)
# The weight lines both servers must print alike after the same transfer
# (the times differ).
WEIGHT_LINES = ("areal:weight_bytes_from_origin", "areal:weight_bytes_from_peers",
                "areal:weight_expected_bytes", "areal:weight_ingress_payload_equivalents",
                "areal:weight_wire", "areal:weight_shard", "areal:weight_version",
                "areal:weight_chunks_served", "areal:weight_bytes_served")


def _http(url, payload=None, timeout=120):
    """(status, parsed JSON or text); a JSON POST when payload is given."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def _metrics(url):
    text = _http(url + "/metrics")[1]
    return [tuple(line.split(" ", 1)) for line in text.splitlines()]


def _start(worker, cfg):
    worker.configure(cfg, experiment_name=cfg.experiment_name, trial_name=cfg.trial_name,
                     worker_name=cfg.worker_name)
    worker.thread = threading.Thread(target=worker.run, daemon=True)
    worker.thread.start()
    return worker


def _greedy(url, prompts, n=8):
    out = []
    for i, p in enumerate(prompts):
        status, body = _http(url + "/generate", {
            "qid": f"q{i}-{uuid.uuid4().hex[:4]}", "input_ids": p,
            "gconfig": {"max_new_tokens": n, "greedy": True}})
        assert status == 200, body
        out.append(body)
    return out


PROMPTS = [[3, 9, 27, 17], list(range(1, 24)), [60, 2, 44, 8, 31, 12, 5]]
BYTE_LINES = ("areal:weight_bytes_from_origin", "areal:weight_bytes_from_peers")


@pytest.fixture(scope="module")
def world(tree, tmp_path_factory):
    """Both packages' name_resolve on one nfs root, the file root in a
    temp dir, a port server and a reference server (each its own
    experiment), and the process-global fault injectors reset after."""
    from areal_tpu.api.config import ModelAbstraction as RefModel
    from areal_tpu.api.system_api import GenerationServerConfig as RefServerConfig
    from areal_tpu.base import name_resolve as ref_nr
    from areal_tpu.base.fault_injection import faults as ref_faults
    from areal_tpu.system.generation_server import GenerationServer as RefServer
    from areal_tpu_torch.api.config import ModelAbstraction
    from areal_tpu_torch.api.system_api import GenerationServerConfig
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.base.fault_injection import faults
    from areal_tpu_torch.system.generation_server import GenerationServer

    import areal_tpu.engine.factories  # noqa: F401  (the reference's model registry)

    tmp = tmp_path_factory.mktemp("plane_world")
    saved = ref_nr._default.repo, name_resolve._default.repo
    saved_root = os.environ.get("AREAL_FILEROOT")
    os.environ["AREAL_FILEROOT"] = str(tmp / "fileroot")
    ref_nr.reconfigure("nfs", record_root=str(tmp / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp / "nr"))
    faults.reset()
    ref_faults.reset()
    run = uuid.uuid4().hex[:6]
    workers = []

    def port_server(exp, index=0):
        w = _start(GenerationServer(), GenerationServerConfig(
            experiment_name=exp, trial_name="t0", server_index=index, device="cpu",
            model=ModelAbstraction("tpu_transformer", args=dict(config=dict(TINY))),
            **SERVER_KW))
        workers.append(w)
        return w

    def ref_server(exp, index=0):
        w = _start(RefServer(), RefServerConfig(
            experiment_name=exp, trial_name="t0", server_index=index,
            model=RefModel("tpu_transformer", args=dict(config=dict(TINY))), **SERVER_KW))
        workers.append(w)
        return w

    def start(w):
        workers.append(w)
        return w

    try:
        yield dict(tmp=tmp, run=run, port_server=port_server, ref_server=ref_server,
                   start=start, faults=faults)
    finally:
        for w in workers:
            (w.close if isinstance(w, (wp.WeightPlaneSource, ref_wp.WeightPlaneSource))
             else w.exit)()
        for w in workers:
            if getattr(w, "thread", None) is not None:
                w.thread.join(timeout=30)
        faults.reset()
        ref_faults.reset()
        ref_nr._default.repo.reset()
        name_resolve._default.repo.reset()
        ref_nr._default.repo, name_resolve._default.repo = saved
        if saved_root is None:
            os.environ.pop("AREAL_FILEROOT", None)
        else:
            os.environ["AREAL_FILEROOT"] = saved_root


@pytest.fixture(scope="module")
def pair(world):
    return {"port": world["port_server"](f"pp-{world['run']}"),
            "ref": world["ref_server"](f"rp-{world['run']}")}


def _perturbed(tree, scale):
    return jax.tree_util.tree_map(lambda x: (np.asarray(x) * scale).astype(x.dtype), tree)


def _source_over(world, tree, version, name, wire="int8"):
    d = str(world["tmp"] / name)
    wt.dump_raw_params(tree, d, version=version, chunk_bytes=CHUNK, wire_dtype=wire)
    return world["start"](wp.WeightPlaneSource(d, CHUNK).start())


@pytest.mark.parametrize("version,wire", [(1, None), (2, "int8")], ids=["raw", "int8"])
def test_distribute_and_cutover_match_the_reference_server(world, pair, tree, version, wire):
    src = _source_over(world, _perturbed(tree, 1.0 + 0.01 * version), version, f"pair{version}")
    man = wc.fetch_manifest(src.address, version=version, wire=wire)
    replies = {}
    for side, server in pair.items():
        status, d = _http(server.address + "/distribute_weights", {
            "version": version, "manifest": man, "upstreams": [src.address],
            "origin": src.address, "deadline_s": 60})
        assert status == 200 and d["success"], d
        status, c = _http(server.address + "/cutover_weights",
                          {"version": version, "budget_s": 30.0})
        assert status == 200 and c["success"] and c["within_budget"], c
        replies[side] = (d, c)
        # A second distribute of the held version is answered at once.
        status, again = _http(server.address + "/distribute_weights", {
            "version": version, "manifest": man, "upstreams": [src.address],
            "origin": src.address})
        assert status == 200 and again["already_held"], again
    for i in (0, 1):
        assert set(replies["port"][i]) == set(replies["ref"][i])
    assert replies["port"][0]["bytes_from_origin"] == man["total_bytes"]
    outs = {side: _greedy(s.address, PROMPTS) for side, s in pair.items()}
    for a, b in zip(outs["ref"], outs["port"]):
        assert b["output_ids"] == a["output_ids"]
        np.testing.assert_allclose(b["output_logprobs"], a["output_logprobs"],
                                   rtol=1e-4, atol=1e-5)
        assert a["version_start"] == b["version_start"] == version
    ref_m, port_m = _metrics(pair["ref"].address), _metrics(pair["port"].address)
    assert [n for n, _ in port_m] == [n for n, _ in ref_m]
    ref_d, port_d = dict(ref_m), dict(port_m)
    for name in WEIGHT_LINES:
        assert port_d[name] == ref_d[name], name
    assert port_d["areal:weight_wire"] == (wire or "raw")
    assert float(port_d["areal:weight_cutover_ms"]) > 0.0
    # Nothing held at another version: the cutover refuses, as the reference's.
    for s in pair.values():
        status, body = _http(s.address + "/cutover_weights", {"version": version + 5})
        assert status == 409 and not body["success"]


def test_duplicate_distribute_joins_and_a_superseded_fetch_keeps_stats(world, pair, tree,
                                                                      monkeypatch):
    server = pair["port"]
    slow = {10, 12}
    real = wc.ChunkStore._get_range

    def slowed(self, *a, **kw):
        if self.version in slow:
            time.sleep(0.03)
        return real(self, *a, **kw)

    monkeypatch.setattr(wc.ChunkStore, "_get_range", slowed)
    srcs = {v: _source_over(world, _perturbed(tree, 1.0 + 0.001 * v), v, f"dup{v}")
            for v in (10, 12, 13)}

    def body(v, wire=None):
        return {"version": v, "manifest": wc.fetch_manifest(srcs[v].address, v, wire=wire),
                "upstreams": [srcs[v].address], "origin": srcs[v].address, "deadline_s": 60}

    def in_background(payload):
        box = {}
        t = threading.Thread(target=lambda: box.setdefault(
            "r", _http(server.address + "/distribute_weights", payload)))
        t.start()
        deadline = time.monotonic() + 30
        while not (server._wp_store is not None and server._wp_store.version == payload["version"]
                   and server._wp_state == "fetching"):
            assert time.monotonic() < deadline
            time.sleep(0.005)
        return t, box

    # A duplicate of an in-flight fetch joins it.
    t, first = in_background(body(10))
    status, joined = _http(server.address + "/distribute_weights", body(10))
    t.join(timeout=60)
    assert first["r"][0] == 200 and first["r"][1]["success"]
    assert status == 200 and joined["success"] and joined["joined"]
    assert server._wp_store.resumed_chunks == 0

    # A newer version supersedes an in-flight fetch; the old fetch ends
    # without touching the stats the new one set.
    t, old = in_background(body(12))
    status, new = _http(server.address + "/distribute_weights", body(13, wire="int8"))
    assert status == 200 and new["success"], new
    int8_total = wc.fetch_manifest(srcs[13].address, 13, wire="int8")["total_bytes"]
    t.join(timeout=60)
    assert old["r"][0] == 200, old
    m = dict(_metrics(server.address))
    assert m["areal:weight_wire"] == "int8"
    assert float(m["areal:weight_expected_bytes"]) == float(int8_total)
    assert server._wp_store.version == 13 and server._wp_state == "ready"
    assert _http(server.address + "/cutover_weights", {"version": 12})[0] == 409
    # An older version than the one held is refused before any allocation.
    status, stale = _http(server.address + "/distribute_weights", body(12))
    assert status == 409 and "superseded" in stale["error"]


@pytest.mark.parametrize("path,method", [
    ("/weights/manifest?version=99", "GET"), ("/weights/chunk?version=99&idx=0", "GET"),
    ("/cutover_weights", "POST"),
])
def test_held_nothing_routes_answer_as_the_reference(pair, path, method):
    payload = {"version": 99} if method == "POST" else None
    ref = _http(pair["ref"].address + path, payload)
    port = _http(pair["port"].address + path, payload)
    assert port[0] == ref[0] and port[0] in (404, 409)
    assert set(port[1]) == set(ref[1])


# ---------------------------------------------------------------------------
# The manager's plane fanout
# ---------------------------------------------------------------------------


def _publish(exp, tree, version, wire=None, ref_marker=False):
    """A trainer's hand-off into the manager's param-realloc dir: the raw
    dump (with its sidecars and wire), the markers, the version."""
    from areal_tpu_torch.base import constants, name_resolve, names

    d = os.path.join(constants.get_param_realloc_path(exp, "t0"), "actor")
    wt.dump_raw_params(tree, d, version=version, chunk_bytes=CHUNK, wire_dtype=wire)
    for marker in ("step.txt",) + (("engine_state.pkl",) if ref_marker else ()):
        with open(os.path.join(d, marker), "w") as f:
            f.write(str(version))
    name_resolve.add(names.model_version(exp, "t0", "actor"), str(version), replace=True)
    return d


def _wait(cond, what, timeout=60):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def _port_manager(world, exp, n, **kw):
    from areal_tpu_torch.api.system_api import GserverManagerConfig
    from areal_tpu_torch.system.gserver_manager import GserverManager

    return world["start"](_start(GserverManager(), GserverManagerConfig(
        experiment_name=exp, trial_name="t0", n_servers=n, train_batch_size=4,
        max_head_offpolicyness=8, weight_plane=True, weight_chunk_bytes=CHUNK,
        health_check_interval=0.3, **kw)))


def test_manager_chain_fanout_refanout_and_bootstrap(world, tree):
    from areal_tpu_torch.base import constants

    exp = f"chain-{world['run']}"
    servers = [world["port_server"](exp, i) for i in range(3)]
    d = os.path.join(constants.get_param_realloc_path(exp, "t0"), "actor")
    os.makedirs(d, exist_ok=True)
    # The trainer-side origin, registered as the model worker's is.
    src = world["start"](wp.WeightPlaneSource(d, CHUNK).start()).register(exp, "t0", "actor")
    mgr = _port_manager(world, exp, 3, weight_fanout_degree=1)
    urls = sorted(s.address for s in servers)

    def status():
        return _http(mgr.address + "/status")[1]

    def metrics(url):
        return {k: float(v) for k, v in _metrics(url) if k in BYTE_LINES}

    # Version 1: the chain origin -> S0 -> S1 -> S2.
    _publish(exp, _perturbed(tree, 1.01), 1)
    _wait(lambda: mgr.weight_version == 1, "fanout of v1")
    row = status()["weight_plane"]
    assert row["tree"] == [[[urls[0], src.address]], [[urls[1], urls[0]]], [[urls[2], urls[1]]]]
    total = row["total_bytes"]
    assert src.stats()["bytes_served"][1] == total  # one payload from the origin
    per = [metrics(u) for u in urls]
    assert sum(m["areal:weight_bytes_from_origin"] for m in per) == total
    assert sum(m["areal:weight_bytes_from_peers"] for m in per) == 2 * total
    outs = [_greedy(u, PROMPTS[:2]) for u in urls]
    assert all([o["output_ids"] for o in out] == [o["output_ids"] for o in outs[0]]
               for out in outs)
    assert all(o["version_start"] == 1 for out in outs for o in out)

    # Version 2 on the int8 wire... the manager asks for the raw stream
    # unless weight_wire_dtype is set; the mid-chain server S1 fails its
    # distribute, S2 re-parents onto S0, S1 is evicted, then readmitted
    # through the plane bootstrap from its peers.
    world["faults"].reset()
    world["faults"].arm("gserver.distribute_weights", "raise", at_hit=2)
    _publish(exp, _perturbed(tree, 1.02), 2)
    _wait(lambda: mgr.weight_version == 2, "fanout of v2")
    row = status()["weight_plane"]
    assert list(row["failures"]) == [urls[1]]
    assert src.stats()["bytes_served"][2] == total
    m2 = metrics(urls[2])
    assert m2["areal:weight_bytes_from_origin"] == 0.0
    assert m2["areal:weight_bytes_from_peers"] == total
    _wait(lambda: status()["server_versions"][urls[1]] == 2
          and urls[1] in status()["healthy_servers"], "bootstrap of S1")
    m1 = metrics(urls[1])
    assert m1["areal:weight_bytes_from_peers"] == total
    assert m1["areal:weight_bytes_from_origin"] == 0.0
    assert src.stats()["bytes_served"][2] == total  # the bootstrap came from peers
    world["faults"].reset()
    outs = [_greedy(u, PROMPTS[:1]) for u in urls]
    assert all(out[0]["output_ids"] == outs[0][0]["output_ids"] for out in outs)
    assert all(out[0]["version_start"] == 2 for out in outs)


@pytest.mark.parametrize("manager", ["port", "ref"])
def test_mixed_fleet_fans_out_across_packages(world, tree, manager):
    """The port's manager in front of a reference and a port server, and
    the reference's manager in front of the same mix; no trainer source
    is registered, so each manager starts its own origin over the dump."""
    from areal_tpu.api.system_api import GserverManagerConfig as RefManagerConfig
    from areal_tpu.system.gserver_manager import GserverManager as RefManager

    exp = f"mix{manager}-{world['run']}"
    servers = [world["ref_server"](exp, 0), world["port_server"](exp, 1)]
    _publish(exp, _perturbed(tree, 0.99), 1, wire="int8", ref_marker=True)
    if manager == "port":
        mgr = _port_manager(world, exp, 2, weight_fanout_degree=1, weight_wire_dtype="int8")
    else:
        mgr = world["start"](_start(RefManager(), RefManagerConfig(
            experiment_name=exp, trial_name="t0", n_servers=2, train_batch_size=4,
            max_head_offpolicyness=8, weight_plane=True, weight_chunk_bytes=CHUNK,
            weight_fanout_degree=1, weight_wire_dtype="int8")))
    _wait(lambda: _http(mgr.address + "/status")[1]["weight_version"] == 1, "mixed fanout")
    row = _http(mgr.address + "/status")[1]["weight_plane"]
    assert row["wire"] == "int8" and not row["failures"]
    per = [{k: float(v) for k, v in _metrics(s.address) if k in BYTE_LINES} for s in servers]
    assert sum(m["areal:weight_bytes_from_peers"] for m in per) == row["total_bytes"]
    assert sum(m["areal:weight_bytes_from_origin"] for m in per) == row["total_bytes"]
    outs = [_greedy(s.address, PROMPTS) for s in servers]
    for a, b in zip(*outs):
        assert a["output_ids"] == b["output_ids"] and a["version_start"] == b["version_start"] == 1


def test_last_fanout_serves_from_the_managers_own_source(tmp_path):
    """At COMPLETE the trainer-side source closes as its model worker
    exits, so the manager's last fanout takes its own source over the
    dump dir even while the registered one still answers a probe."""
    from areal_tpu_torch.api.system_api import GserverManagerConfig
    from areal_tpu_torch.base import name_resolve
    from areal_tpu_torch.system.gserver_manager import GserverManager

    saved = name_resolve._default.repo
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    exp = f"last-{uuid.uuid4().hex[:6]}"
    d = str(tmp_path / "dump")
    os.makedirs(d)
    src = wp.WeightPlaneSource(d, CHUNK).start().register(exp, "t0", "actor")
    mgr = GserverManager()
    mgr.cfg = GserverManagerConfig(experiment_name=exp, trial_name="t0", weight_plane=True,
                                   weight_chunk_bytes=CHUNK)
    mgr._own_source, mgr._trainer_source_gone = None, False
    mgr.check_new_params = lambda: d
    mgr.flush_requests_and_update_weights = lambda path: origins.append(
        mgr._weight_plane_origin(path))
    origins = []
    try:
        assert mgr._weight_plane_origin(d) == src.address
        mgr._last_fanout()
        assert origins == [mgr._own_source.address] and origins[0] != src.address
    finally:
        src.close()
        if mgr._own_source is not None:
            mgr._own_source.close()
        name_resolve._default.repo = saved

