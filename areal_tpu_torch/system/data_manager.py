"""Per-model-worker sample storage + peer-to-peer pull execution (the
port's copy of ``areal_tpu/system/data_manager.py``).

Each model worker stores the `SequenceSample`s it produced or loaded;
transfer plans from the master's RedistribPlanner are executed by
pulling missing (id, key) data directly from the owning peer over a
dedicated ZMQ socket pair. A background serving thread answers peer
pulls even while the worker's main thread is blocked inside an MFC,
which makes the pull protocol deadlock-free.
"""

from __future__ import annotations

import pickle
import threading
import zlib
from typing import Dict, List, Optional

import zmq

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.base import logging, name_resolve, names, network
from areal_tpu_torch.system.redistributor import RedistribStep

logger = logging.getLogger("data_manager")


def _ns(experiment_name: str, trial_name: str, worker: str) -> str:
    return names.worker_key(experiment_name, trial_name, f"data_plane/{worker}")


class DataManager:
    def __init__(self, experiment_name: str, trial_name: str, worker_name: str):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.worker_name = worker_name
        self._lock = threading.RLock()
        # sample_id -> SequenceSample (full data, host numpy)
        self._store: Dict[str, SequenceSample] = {}

        self._ctx = zmq.Context.instance()
        self._rep = self._ctx.socket(zmq.REP)
        self._rep.setsockopt(zmq.LINGER, 0)
        host_ip = network.gethostip()
        port = self._rep.bind_to_random_port(f"tcp://{host_ip}")
        self.address = f"{host_ip}:{port}"
        name_resolve.add(
            _ns(experiment_name, trial_name, worker_name),
            self.address,
            keepalive_ttl=60,
            replace=True,
        )
        self._peer_sockets: Dict[str, zmq.Socket] = {}
        self._stop = threading.Event()
        self._serve_thread = threading.Thread(target=self._serve, daemon=True)
        self._serve_thread.start()

    # ------------------------------------------------------------------
    # Local store
    # ------------------------------------------------------------------

    def store(self, sample: SequenceSample):
        """Insert or merge one (possibly batched) sample."""
        with self._lock:
            for sub in sample.unpack():
                cur = self._store.get(sub.ids[0])
                if cur is None:
                    self._store[sub.ids[0]] = sub
                else:
                    cur.update_(sub)

    def get(self, sample_id: str) -> Optional[SequenceSample]:
        with self._lock:
            return self._store.get(sample_id)

    def gather(self, sample_ids: List[str], keys: Optional[List[str]] = None) -> SequenceSample:
        """Assemble a batch (in the given id order) from the local store."""
        with self._lock:
            samples = []
            for i in sample_ids:
                s = self._store.get(i)
                if s is None:
                    raise KeyError(f"sample {i} not in local store")
                samples.append(s.select_keys(keys) if keys is not None else s)
        return SequenceSample.gather(samples)

    def has(self, sample_id: str, key: str) -> bool:
        with self._lock:
            s = self._store.get(sample_id)
            return s is not None and key in s.keys and s.data.get(key) is not None

    def clear(self, sample_ids: Optional[List[str]] = None):
        with self._lock:
            if sample_ids is None:
                self._store.clear()
            else:
                for i in sample_ids:
                    self._store.pop(i, None)

    def __len__(self):
        with self._lock:
            return len(self._store)

    # ------------------------------------------------------------------
    # Peer pulls
    # ------------------------------------------------------------------

    def _serve(self):
        while not self._stop.is_set():
            if not self._rep.poll(100):
                continue
            raw = self._rep.recv()
            # After a successful recv, the REP socket MUST send exactly one
            # reply before it can recv again — so any processing failure
            # still produces an error reply, or the data plane wedges.
            try:
                req = pickle.loads(zlib.decompress(raw))
                batch = self.gather(req["ids"], req["keys"])
                resp = {"ok": True, "batch": batch}
            except Exception as e:
                logger.exception("data plane serve error")
                resp = {"ok": False, "error": repr(e)}
            try:
                payload = zlib.compress(pickle.dumps(resp), level=1)
            except Exception as e:
                logger.exception("data plane reply encode failed")
                payload = zlib.compress(
                    pickle.dumps({"ok": False, "error": repr(e)}), level=1
                )
            try:
                self._rep.send(payload)
            except Exception:
                logger.exception("data plane reply send failed")

    def _peer(self, worker: str) -> zmq.Socket:
        if worker not in self._peer_sockets:
            addr = name_resolve.wait(
                _ns(self.experiment_name, self.trial_name, worker), timeout=60
            )
            sock = self._ctx.socket(zmq.REQ)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(f"tcp://{addr}")
            self._peer_sockets[worker] = sock
        return self._peer_sockets[worker]

    def pull(self, src: str, ids: List[str], keys: List[str], timeout: float = 60.0):
        """Pull (ids x keys) from the owning peer and merge locally."""
        sock = self._peer(src)
        sock.send(zlib.compress(pickle.dumps({"ids": ids, "keys": keys}), level=1))
        if not sock.poll(int(timeout * 1000)):
            # REQ socket is now stuck awaiting a reply; recreate it.
            sock.close()
            del self._peer_sockets[src]
            raise TimeoutError(f"data pull from {src} timed out")
        resp = pickle.loads(zlib.decompress(sock.recv()))
        if not resp["ok"]:
            raise RuntimeError(f"data pull from {src} failed: {resp['error']}")
        self.store(resp["batch"])

    def redistribute(self, plan: List[RedistribStep]):
        """Execute the steps of a master-derived plan that target this
        worker."""
        for step in plan:
            if step.dst != self.worker_name:
                continue
            missing_ids = [
                i for i in step.ids if not all(self.has(i, k) for k in step.keys)
            ]
            if missing_ids:
                self.pull(step.src, missing_ids, step.keys)

    def close(self):
        self._stop.set()
        self._serve_thread.join(timeout=2)
        self._rep.close()
        for s in self._peer_sockets.values():
            s.close()
        try:
            name_resolve.delete(
                _ns(self.experiment_name, self.trial_name, self.worker_name)
            )
        except name_resolve.NameEntryNotFoundError:
            pass
