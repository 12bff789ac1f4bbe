"""Port parity of the tiered KV store: one scripted sequence of puts,
gets, LRU demotions to disk, a disk corruption, promotions, discards
and a clear runs on the reference's ``KVTierStore``
(``areal_tpu/engine/kv_tier.py``) and the port's
(``areal_tpu_torch/engine/kv_tier.py``), each with its own disk
directory; every step's result, ``held()``, ``peek_meta``,
``peek_tier`` and ``stats()`` must be equal. The blobs are real
``areal-kv-handoff/v1`` blobs (the port packs them), so the disk
re-verification hashes real chunk indexes.
"""

import os

import numpy as np
import pytest
import torch

from areal_tpu.engine import kv_tier as ref_tier
from areal_tpu_torch.engine import kv_handoff as kvh
from areal_tpu_torch.engine import kv_tier as port_tier


class _Cfg:
    n_layers, n_kv_heads, head_dim = 2, 1, 16


def _blob(qid, n_tokens, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 1, n_tokens, 16)).astype(np.float32))
    seg, idx, payload = kvh.pack_arrays([("k", x), ("v", x * 2)], chunk_bytes=1024)
    return kvh.build_meta(qid, 0, list(range(n_tokens)), "float32", _Cfg, seg, idx), payload


def _script(store, disk_dir):
    """Returns the observable trace of one fixed sequence of calls."""
    out = []
    blobs = {f"q{i}": _blob(f"q{i}", 16 + 8 * i, i) for i in range(6)}
    size = {q: len(p) for q, (_, p) in blobs.items()}

    def obs(tag, val):
        out.append((tag, val))

    def snapshot():
        obs("held", store.held())
        obs("stats", store.stats())
        obs("len", len(store))

    for q in ("q0", "q1", "q2"):
        store.put(q, *blobs[q])
        snapshot()
    got = store.get("q0")
    obs("get q0", None if got is None else (got[0]["qid"], got[1] == blobs["q0"][1], got[2]))
    store.put("q3", *blobs["q3"])  # over host capacity: the LRU demotes to disk
    store.put("q4", *blobs["q4"])
    snapshot()
    for q in blobs:
        obs(f"tier {q}", store.peek_tier(q))
        m = store.peek_meta(q, count_miss=True)
        obs(f"meta {q}", None if m is None else m["content_hash"])
    # Corrupt the disk payload of the oldest demoted entry.
    demoted = [e["qid"] for e in store.held() if e["tier"] == "disk"]
    obs("demoted", demoted)
    victim = demoted[-1]
    path = store._entries[victim].path + ".bin"
    with open(path, "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    obs("get corrupt", store.get(victim))
    snapshot()
    # Promote a healthy disk entry back to the host tier.
    healthy = [q for q in demoted if q != victim]
    if healthy:
        got = store.get(healthy[0])
        obs("promote", (got[2], got[1] == blobs[healthy[0]][1]))
    snapshot()
    obs("peer get", store.get("q4", count=False)[2])
    store.discard("q4")
    store.put("q1", *blobs["q5"])  # replace an entry
    obs("miss", store.get("nope"))
    snapshot()
    obs("files", len([f for f in os.listdir(disk_dir)]))
    store.clear()
    snapshot()
    obs("files after clear", len(os.listdir(disk_dir)))
    obs("sizes", sorted(size.values()))
    return out


@pytest.mark.parametrize("host_blobs", [2, 3])
def test_tier_script_matches_reference(tmp_path, host_blobs):
    cap = host_blobs * len(_blob("q2", 32, 2)[1])
    results = []
    for name, mod in (("ref", ref_tier), ("port", port_tier)):
        d = str(tmp_path / name)
        store = mod.KVTierStore(cap, disk_dir=d, disk_capacity_bytes=3 * cap)
        results.append(_script(store, d))
    assert results[1] == results[0]
    stats = [v for k, v in results[1] if k == "stats"]
    assert stats[-2]["dropped_corrupt"] == 1.0 and stats[-2]["demoted_to_disk"] >= 1.0


def test_hostonly_tier_drops_at_capacity_like_reference():
    results = []
    for mod in (ref_tier, port_tier):
        store = mod.KVTierStore(len(_blob("a", 16, 0)[1]) + 1)
        for i in range(3):
            store.put(f"a{i}", *_blob(f"a{i}", 16, i))
        results.append((store.held(), store.stats(), store.get("a0"), store.get("a2")[2]))
    assert results[1] == results[0]
    assert results[1][1]["dropped_capacity"] == 2.0
    assert port_tier.verify_payload(*_blob("x", 24, 9))
    meta, payload = _blob("x", 24, 9)
    assert not port_tier.verify_payload(meta, payload[:-1])
