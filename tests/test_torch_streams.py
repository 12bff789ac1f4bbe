"""Port parity of the worker system's streams.

- The trajectory wire crosses packages: a reference pusher feeds the
  port's ``PullerStreamDataset`` and a port pusher feeds the reference's,
  with ``sample_to_json`` trajectories and the WAL armed; the samples
  decode equal (data bit-equal, seqlens, dtypes, metadata plus the
  ``wal_seq`` the puller stamps) and every push is acked.
- ``grouping`` (pushers onto pullers) equals the reference's on a grid.
- The port's request/reply stream round-trips requests, syn acks and
  compressed payloads between a master and a worker end.

Every wait is bounded (``WAIT_S``) and every socket is closed in
``finally``.
"""

import threading
import time
import types
import uuid

import numpy as np
import pytest

from areal_tpu.api import data_api as rdata
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.system import push_pull_stream as rpps
from areal_tpu.system import stream_dataset as rsd
from areal_tpu_torch.api import data_api as tdata
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.system import push_pull_stream as tpps
from areal_tpu_torch.system import request_reply_stream as rrs
from areal_tpu_torch.system import stream_dataset as tsd

WAIT_S = 30.0


@pytest.fixture
def shared_names(tmp_path, monkeypatch):
    """Both packages' name_resolve on one nfs root, files under tmp."""
    monkeypatch.setenv("AREAL_FILEROOT", str(tmp_path / "fileroot"))
    saved = ref_nr._default.repo, name_resolve._default.repo
    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    try:
        yield f"streams-{uuid.uuid4().hex[:6]}", "t0"
    finally:
        ref_nr._default.repo.reset()
        name_resolve._default.repo.reset()
        ref_nr._default.repo, name_resolve._default.repo = saved


def _samples(n=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lens = [int(x) for x in rng.integers(3, 12, size=2)]
        s = rdata.SequenceSample(
            ids=[f"q{i}"], keys={"packed_input_ids", "packed_logprobs", "rewards"},
            data={"packed_input_ids": rng.integers(0, 1000, size=sum(lens)).astype(np.int64),
                  "packed_logprobs": rng.standard_normal(sum(lens)).astype(np.float32),
                  "rewards": rng.standard_normal(2).astype(np.float32)},
            seqlens={"packed_input_ids": [lens], "packed_logprobs": [lens],
                     "rewards": [[1, 1]]},
            metadata={"version_start": [i], "task": ["math"]})
        out.append(s)
    return out


def _assert_same(got, want, seq):
    assert got.ids == want.ids and got.keys == want.keys
    for k in want.keys:
        assert got.data[k].dtype == want.data[k].dtype, k
        np.testing.assert_array_equal(got.data[k], want.data[k], err_msg=k)
        assert got.seqlens[k] == want.seqlens[k], k
    assert got.metadata == {**want.metadata, "wal_seq": [seq]}


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_trajectories_cross_packages_with_acks(shared_names, direction):
    exp, trial = shared_names
    if direction == "reference_to_port":
        dataset_cls, pusher_cls, to_json = (tsd.PullerStreamDataset, rpps.NameResolvingZmqPusher,
                                            rdata.sample_to_json)
    else:
        dataset_cls, pusher_cls, to_json = (rsd.PullerStreamDataset, tpps.NameResolvingZmqPusher,
                                            tdata.sample_to_json)
    samples = _samples()
    dataset = dataset_cls(exp, trial, puller_index=0)
    pusher = None
    try:
        pusher = pusher_cls(exp, trial, pusher_index=0, n_pushers=1, n_pullers=1, ack=True)
        for i, s in enumerate(samples):
            pusher.push(to_json(s), seq=f"0/{i}")
        got = []
        deadline = time.monotonic() + WAIT_S
        while (len(got) < len(samples) or pusher.unacked()) and time.monotonic() < deadline:
            batch = dataset.poll_batch()
            if batch is not None:
                got.extend(batch.unpack())
            pusher.drain_acks()
            time.sleep(0.02)
        assert len(got) == len(samples) and pusher.unacked() == 0, (len(got), pusher.unacked())
        for i, (g, w) in enumerate(zip(got, samples)):
            _assert_same(g, w, f"0/{i}")
    finally:
        if pusher is not None:
            pusher.close()
        dataset.close()


def test_pull_thread_starts_after_the_dataset_is_built(shared_names, monkeypatch):
    """The pull thread may take a trajectory as soon as it starts, so every
    field it updates exists before then (a trajectory pulled before
    ``n_pulled`` was set killed the thread, and the trainer waited for
    data that never came)."""
    fields = ("n_pulled", "_queue", "_held", "_seen", "_wal", "counters")
    seen = []

    class Probe:
        def __init__(self, target, daemon):
            self.target = target

        def start(self):
            ds = self.target.__self__
            seen.append({k: hasattr(ds, k) for k in fields})

        def join(self, timeout=None):
            pass

    monkeypatch.setattr(tsd, "threading", types.SimpleNamespace(
        Thread=Probe, Event=threading.Event, Lock=threading.Lock))
    exp, trial = shared_names
    dataset = tsd.PullerStreamDataset(exp, trial, puller_index=0)
    try:
        assert seen == [dict.fromkeys(fields, True)]
    finally:
        dataset.close()


@pytest.mark.parametrize("n_pushers,n_pullers", [(1, 1), (4, 2), (5, 2), (7, 3), (8, 8), (9, 4)])
def test_grouping_matches_reference(n_pushers, n_pullers):
    assert tpps.grouping(n_pushers, n_pullers) == rpps.grouping(n_pushers, n_pullers)


def test_request_reply_round_trip(shared_names):
    exp, trial = shared_names
    master = rrs.make_master_stream(exp, trial)
    worker = rrs.make_worker_stream(exp, trial, "model_worker/0")
    stop = threading.Event()
    seen = []

    def serve():
        while not stop.is_set():
            try:
                req = worker.poll(block=True, timeout_ms=50)
            except rrs.NoMessage:
                continue
            seen.append((req.handle_name, req.pre_hooks, req.post_hooks))
            worker.reply_to(req, {"echo": req.data, "n": len(seen)})

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    try:
        assert master.call(["model_worker/0"], "spec", timeout=WAIT_S) == [
            {"echo": None, "n": 1}]
        # A payload above the compression threshold, with hooks and a syn.
        big = np.arange(20000, dtype=np.int64)
        rid, = master.request(["model_worker/0"], "mfc", [{"ids": big}], no_syn=False,
                              pre_hooks=[[{"type": "data_transfer"}]],
                              post_hooks=[[{"type": "param_realloc"}]])
        assert master.await_syn(rid, timeout=WAIT_S).request_id == rid
        reply = master.poll(rid, block=True, timeout=WAIT_S)
        np.testing.assert_array_equal(reply.data["echo"]["ids"], big)
        assert reply.sender == "model_worker/0" and reply.data["n"] == 2
        assert seen[1] == ("mfc", [{"type": "data_transfer"}], [{"type": "param_realloc"}])
        with pytest.raises(rrs.NoMessage):
            master.poll("no-such-request")
    finally:
        stop.set()
        thread.join(timeout=WAIT_S)
        master.close()
        worker.close()
