"""Port parity of the raw weight dump and the base copies the generation
server relies on: areal_tpu_torch.system.weight_transfer against
areal_tpu.system.weight_transfer, and the port's latency, rpc,
name_resolve and health copies against the reference's.

- The two packages write byte-equal ``params-v{N}.bin`` and
  ``params.json`` for the same numpy tree (float32 and bfloat16), and
  each loads the other's dump to equal arrays.
- A pinned version that no dump holds raises WeightVersionMismatch in
  both; the fallback chain reports the same source.
- Latency bucket encodings and percentiles, Deadline header parsing,
  name_resolve records and heartbeat records agree exactly.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from areal_tpu.base import health as ref_health
from areal_tpu.base import latency as ref_latency
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import names as ref_names
from areal_tpu.base import rpc as ref_rpc
from areal_tpu.system import weight_transfer as ref_wt
from areal_tpu_torch.base import health, latency, name_resolve, names, rpc
from areal_tpu_torch.system import weight_transfer as wt


def tree(dtype, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(dtype)

    return {
        "embedding": {"weight": leaf(16, 8)},
        "layers": {"attn": {"wq": leaf(2, 8, 8), "wk": leaf(2, 8, 4)},
                   "ln1": {"weight": leaf(2, 8)}},
        "final_norm": {"weight": leaf(8)},
    }


def flat(t, prefix=""):
    if isinstance(t, dict):
        return {k: v for key in sorted(t) for k, v in flat(t[key], f"{prefix}/{key}").items()}
    return {prefix: t}


def bits(leaf) -> np.ndarray:
    """A leaf's raw bits as an integer array (numpy or torch, bf16 too)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy()
        return leaf.numpy().view(f"i{leaf.element_size()}")
    arr = np.asarray(leaf)
    return arr.view(f"i{arr.itemsize}")


DTYPES = [np.float32, ml_dtypes.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_dumps_are_byte_equal(tmp_path, dtype):
    params = tree(dtype)
    ref_wt.dump_raw_params(params, str(tmp_path / "ref"), version=3)
    wt.dump_raw_params(params, str(tmp_path / "port"), version=3)
    for name in ("params-v3.bin", "params.json"):
        a = (tmp_path / "ref" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name
    # The port also dumps torch tensors to the same bytes.
    torch_tree = wt.unflatten_leaves({
        k.lstrip("/"): (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                        if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
        for k, v in flat(params).items()})
    wt.dump_raw_params(torch_tree, str(tmp_path / "port_torch"), version=3)
    for name in ("params-v3.bin", "params.json"):
        assert ((tmp_path / "ref" / name).read_bytes()
                == (tmp_path / "port_torch" / name).read_bytes()), name


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_each_package_loads_the_others_dump(tmp_path, dtype):
    params = tree(dtype, seed=1)
    want = {k: bits(v) for k, v in flat(params).items()}
    ref_wt.dump_raw_params(params, str(tmp_path / "ref"), version=5)
    got, v = wt.load_raw_params(str(tmp_path / "ref"))
    assert v == 5
    got = flat(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(bits(got[k]), want[k])
    wt.dump_raw_params(params, str(tmp_path / "port"), version=6)
    back, v = ref_wt.load_raw_params(str(tmp_path / "port"))
    assert v == 6
    back = flat(back)
    for k in want:
        assert back[k].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(bits(back[k]), want[k])


def test_gc_keeps_two_versions_like_the_reference(tmp_path):
    for pkg, d in ((ref_wt, tmp_path / "ref"), (wt, tmp_path / "port")):
        for v in range(4):
            pkg.dump_raw_params(tree(np.float32, seed=v), str(d), version=v)
    ref_bins = sorted(f for f in os.listdir(tmp_path / "ref") if f.endswith(".bin"))
    port_bins = sorted(f for f in os.listdir(tmp_path / "port") if f.endswith(".bin"))
    assert port_bins == ref_bins == ["params-v2.bin", "params-v3.bin"]


def test_load_for_serving_sources_and_pinned_mismatch(tmp_path):
    disk, shm = tmp_path / "actor", tmp_path / "shm"
    ref_wt.dump_raw_params(tree(np.float32), str(disk), version=2)
    for pkg in (ref_wt, wt):
        _, info = pkg.load_for_serving(str(disk), shm_dir=str(shm), want_version=2)
        assert info["source"] == "disk_raw" and info["version"] == 2
        with pytest.raises(pkg.WeightVersionMismatch, match="holds version 2"):
            pkg.load_for_serving(str(disk), shm_dir=str(shm), want_version=3,
                                 retries=2, retry_s=0.01)
        with pytest.raises(pkg.WeightVersionMismatch, match="no raw dump"):
            pkg.load_for_serving(str(tmp_path / "empty"), want_version=1, retries=1)
    wt.dump_raw_params(tree(np.float32, seed=4), str(shm), version=3)
    for pkg in (ref_wt, wt):
        _, info = pkg.load_for_serving(str(disk), shm_dir=str(shm), want_version=3)
        assert info["source"] == "shm_raw" and info["version"] == 3
    assert wt.shm_transfer_dir("e", "t", "actor") == ref_wt.shm_transfer_dir("e", "t", "actor")


def test_latency_encoding_and_percentiles_agree():
    rng = np.random.default_rng(0)
    ref_h, port_h = ref_latency.LatencyHistogram(), latency.LatencyHistogram()
    assert latency.encode_counts(port_h.counts()) == ref_latency.encode_counts(ref_h.counts()) == ""
    for ms in rng.lognormal(2.0, 2.5, size=500).tolist() + [0.0, 0.5, 1e9]:
        ref_h.add(ms)
        port_h.add(ms)
    port_h.add(12.0, count=7)
    ref_h.add(12.0, count=7)
    assert latency.BUCKET_EDGES_MS == ref_latency.BUCKET_EDGES_MS
    assert port_h.counts() == ref_h.counts()
    assert latency.encode_counts(port_h.counts()) == ref_latency.encode_counts(ref_h.counts())
    for p in (0.0, 1.0, 50.0, 90.0, 99.0, 100.0):
        assert port_h.percentile(p) == ref_h.percentile(p)
    assert latency.percentile_from_counts([0] * latency.N_BUCKETS, 50.0) == 0.0


@pytest.mark.parametrize("value", [None, "", "abc", "0", "-1", "12.5", "0.25"])
def test_deadline_from_headers_agrees(value):
    assert rpc.DEADLINE_HEADER == ref_rpc.DEADLINE_HEADER
    headers = {} if value is None else {rpc.DEADLINE_HEADER: value}
    ref_d = ref_rpc.Deadline.from_headers(headers)
    port_d = rpc.Deadline.from_headers(headers)
    assert (port_d is None) == (ref_d is None)
    if ref_d is not None:
        assert port_d.expired() == ref_d.expired()
        assert port_d.bounded() == ref_d.bounded()
        assert abs(port_d.remaining() - ref_d.remaining()) < 0.05
    assert sorted(rpc.stats.snapshot()) == sorted(ref_rpc.stats.snapshot())


@pytest.fixture
def shared_nfs(tmp_path):
    """Both packages' name_resolve on one nfs root; the previous
    process-global repositories come back afterwards."""
    saved = ref_nr._default.repo, name_resolve._default.repo
    root = str(tmp_path / "nr")
    yield ref_nr.reconfigure("nfs", record_root=root), name_resolve.reconfigure(
        "nfs", record_root=root)
    ref_nr._default.repo.reset()
    name_resolve._default.repo.reset()
    ref_nr._default.repo, name_resolve._default.repo = saved


def test_name_resolve_records_cross_packages(shared_nfs):
    key = names.gen_server_url("exp", "trial", "0")
    assert key == ref_names.gen_server_url("exp", "trial", "0")
    name_resolve.add(key, "http://127.0.0.1:1234", keepalive_ttl=60, replace=True)
    assert ref_nr.get(key) == "http://127.0.0.1:1234"
    other = ref_names.gen_server_url("exp", "trial", "1")
    ref_nr.add(other, "http://127.0.0.1:5678", replace=True)
    assert name_resolve.get(other) == "http://127.0.0.1:5678"
    sub = name_resolve.add_subentry(names.gen_servers("exp", "trial"), "http://a")
    assert ref_nr.get_subtree(ref_names.gen_servers("exp", "trial")) == ["http://a"]
    assert ref_nr.get(sub) == "http://a"
    with pytest.raises(NotImplementedError):
        name_resolve.reconfigure("kv")


def test_heartbeat_record_reads_in_the_reference_registry(shared_nfs):
    hb = health.Heartbeat("exp", "trial", "generation_server/0",
                          payload={"url": "http://x", "role": "unified"}, ttl=30.0)
    assert names.health("exp", "trial", "m") == ref_names.health("exp", "trial", "m")
    reg = ref_health.HealthRegistry("exp", "trial")
    alive = reg.snapshot()
    assert alive["generation_server/0"]["url"] == "http://x"
    record = json.loads(ref_nr.get(ref_names.health("exp", "trial", "generation_server/0")))
    assert set(record) == {"url", "role", "ts", "ttl"}
    hb.stop()
    assert "generation_server/0" in reg.stopped_members()
    assert reg.snapshot() == {}
