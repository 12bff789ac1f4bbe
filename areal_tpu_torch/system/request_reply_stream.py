"""Master <-> model-worker messaging over ZMQ with name_resolve discovery
(the port's copy of ``areal_tpu/system/request_reply_stream.py``).

Protocol shape is the reference's:
the master posts a request `Payload`, the worker immediately acknowledges
it with a `syn` frame (so the master knows the worker is alive and has
ordered the request), and later posts the actual reply. Payloads carry
only metadata + small host arrays; bulk tensors move through the data
manager, not through this stream.

Sockets: every participant binds one PULL socket (its inbox) and keeps
lazily-connected PUSH sockets to its peers' inboxes. Addresses are
registered under `names.request_reply_stream` in name_resolve.

Frames are the reference's (a tag, then the pickled `Payload`, zlib
compressed above 16 KiB), but the pickle names the sender's `Payload`
class: a port peer pickles this module's class, so a reference master
cannot drive a port model worker or the other way round. A port peer
unpickles only what port peers sent.
"""

from __future__ import annotations

import dataclasses
import pickle
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional

import zmq

from areal_tpu_torch.base import logging, name_resolve, names, network, tracing

logger = logging.getLogger("request_reply_stream")

ZMQ_IO_THREADS = 1
# Compress payloads above this many pickled bytes (upstream compresses all;
# small control frames are cheaper uncompressed).
_COMPRESS_THRESHOLD = 16 * 1024


class NoMessage(Exception):
    pass


@dataclasses.dataclass
class Payload:
    """One message on the stream.

    handler: destination peer name (e.g. 'model_worker/3' or 'master').
    handle_name: what to do ('train_step', 'inference', 'generate',
        'fetch', 'spec', 'initialize', 'model_config', 'clear_data_cache',
        'flush', 'save', 'evaluate', ...).
    request_id: unique id; replies echo it.
    syn_reply_id: id under which the receiver posts the syn ack.
    data: arbitrary pickled payload (metadata / host numpy arrays).
    pre_hooks/post_hooks: hook dicts executed around the main handler.
    """

    handler: str = ""
    handle_name: str = ""
    request_id: str = ""
    syn_reply_id: str = ""
    sender: str = ""
    data: Any = None
    pre_hooks: List[Dict] = dataclasses.field(default_factory=list)
    post_hooks: List[Dict] = dataclasses.field(default_factory=list)
    no_syn: bool = True
    send_time: float = 0.0
    # RL-trace context (base/tracing.inject()): stamped by post() when
    # tracing is on so receivers parent their spans under the sender's
    # (e.g. an MFC request under the master's train-step span).
    trace_ctx: Optional[Dict] = None

    def __post_init__(self):
        if not self.request_id:
            self.request_id = str(uuid.uuid4())
        if not self.syn_reply_id:
            self.syn_reply_id = str(uuid.uuid4())


def _encode(payload: Payload) -> List[bytes]:
    raw = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    if len(raw) > _COMPRESS_THRESHOLD:
        return [b"z", zlib.compress(raw, level=1)]
    return [b"r", raw]


def _decode(frames: List[bytes]) -> Payload:
    tag, raw = frames
    if tag == b"z":
        raw = zlib.decompress(raw)
    return pickle.loads(raw)


class _Peer:
    """A bound PULL inbox + lazily connected PUSH sockets to other peers."""

    def __init__(self, experiment_name: str, trial_name: str, peer_name: str):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.peer_name = peer_name
        self._ctx = zmq.Context.instance(ZMQ_IO_THREADS)
        self._recv = self._ctx.socket(zmq.PULL)
        self._recv.setsockopt(zmq.LINGER, 0)
        host_ip = network.gethostip()
        port = self._recv.bind_to_random_port(f"tcp://{host_ip}")
        self.address = f"{host_ip}:{port}"
        name_resolve.add(
            names.request_reply_stream(experiment_name, trial_name, peer_name),
            self.address,
            keepalive_ttl=60,
            replace=True,
        )
        self._send_sockets: Dict[str, zmq.Socket] = {}

    def _peer_address(self, peer: str) -> str:
        key = names.request_reply_stream(self.experiment_name, self.trial_name, peer)
        return name_resolve.wait(key, timeout=60)

    def _send_socket(self, peer: str) -> zmq.Socket:
        if peer not in self._send_sockets:
            sock = self._ctx.socket(zmq.PUSH)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(f"tcp://{self._peer_address(peer)}")
            self._send_sockets[peer] = sock
        return self._send_sockets[peer]

    def post(self, payload: Payload) -> str:
        payload.sender = self.peer_name
        payload.send_time = time.monotonic()
        if payload.trace_ctx is None:
            payload.trace_ctx = tracing.inject()
        self._send_socket(payload.handler).send_multipart(_encode(payload))
        return payload.request_id

    def poll(self, block: bool = False, timeout_ms: int = 100) -> Payload:
        if block:
            if not self._recv.poll(timeout_ms):
                raise NoMessage()
        else:
            if not self._recv.poll(0):
                raise NoMessage()
        return _decode(self._recv.recv_multipart())

    def close(self):
        key = names.request_reply_stream(
            self.experiment_name, self.trial_name, self.peer_name
        )
        try:
            name_resolve.delete(key)
        except name_resolve.NameEntryNotFoundError:
            pass
        self._recv.close()
        for s in self._send_sockets.values():
            s.close()


class NameResolvingRequestClient:
    """The master's end: post requests to workers, gather replies.

    request() returns ids, poll() and gather() collect replies, call()
    is the blocking convenience used for configuration RPCs.
    """

    def __init__(self, experiment_name: str, trial_name: str, name: str = "master"):
        self._peer = _Peer(experiment_name, trial_name, name)
        self.name = name
        self._reply_cache: Dict[str, Payload] = {}
        self._syn_cache: Dict[str, Payload] = {}

    @property
    def address(self) -> str:
        return self._peer.address

    def post(self, payload: Payload) -> str:
        return self._peer.post(payload)

    def request(
        self,
        handlers: List[str],
        handle_type: str,
        datas: Optional[List[Any]] = None,
        no_syn: bool = True,
        pre_hooks: Optional[List[List[Dict]]] = None,
        post_hooks: Optional[List[List[Dict]]] = None,
    ) -> List[str]:
        if datas is None:
            datas = [None for _ in handlers]
        if len(datas) != len(handlers):
            raise ValueError(
                f"{len(handlers)} handlers but {len(datas)} datas"
            )
        ids = []
        for i, (h, d) in enumerate(zip(handlers, datas)):
            p = Payload(
                handler=h,
                handle_name=handle_type,
                data=d,
                no_syn=no_syn,
                pre_hooks=list(pre_hooks[i]) if pre_hooks else [],
                post_hooks=list(post_hooks[i]) if post_hooks else [],
            )
            ids.append(self.post(p))
        return ids

    def _drain(self, block: bool, timeout_ms: int = 100):
        try:
            while True:
                p = self._peer.poll(block=block, timeout_ms=timeout_ms)
                block = False
                if p.handle_name == "syn":
                    self._syn_cache[p.request_id] = p
                else:
                    self._reply_cache[p.request_id] = p
        except NoMessage:
            pass

    def poll(self, request_id: str, block: bool = False, timeout: Optional[float] = None) -> Payload:
        """Fetch the reply for one request id."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if request_id in self._reply_cache:
                return self._reply_cache.pop(request_id)
            self._drain(block=block)
            if request_id in self._reply_cache:
                return self._reply_cache.pop(request_id)
            if not block:
                raise NoMessage()
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"no reply for request {request_id}")

    def await_syn(self, request_id: str, timeout: float = 60.0) -> Payload:
        deadline = time.monotonic() + timeout
        while request_id not in self._syn_cache:
            self._drain(block=True)
            if time.monotonic() > deadline:
                raise TimeoutError(f"no syn for request {request_id}")
        return self._syn_cache.pop(request_id)

    def gather(self, request_ids: List[str], timeout: Optional[float] = None) -> List[Payload]:
        return [self.poll(rid, block=True, timeout=timeout) for rid in request_ids]

    def call(
        self,
        handlers: List[str],
        handle_type: str,
        datas: Optional[List[Any]] = None,
        timeout: Optional[float] = None,
    ) -> List[Any]:
        """Blocking request → gather; returns reply datas in handler order."""
        ids = self.request(handlers, handle_type, datas)
        return [p.data for p in self.gather(ids, timeout=timeout)]

    def close(self):
        self._peer.close()


class NameResolvingReplyServer:
    """A worker's end: poll requests, send syn acks and replies.

    """

    def __init__(self, experiment_name: str, trial_name: str, name: str, master_name: str = "master"):
        self._peer = _Peer(experiment_name, trial_name, name)
        self.name = name
        self.master_name = master_name

    @property
    def address(self) -> str:
        return self._peer.address

    def poll(self, block: bool = False, timeout_ms: int = 100) -> Payload:
        p = self._peer.poll(block=block, timeout_ms=timeout_ms)
        if not p.no_syn:
            self._peer.post(
                Payload(
                    handler=p.sender,
                    handle_name="syn",
                    request_id=p.request_id,
                    data=None,
                )
            )
        return p

    def post(self, reply: Payload):
        self._peer.post(reply)

    def reply_to(self, request: Payload, data: Any, handle_name: str = "reply"):
        self.post(
            Payload(
                handler=request.sender or self.master_name,
                handle_name=handle_name,
                request_id=request.request_id,
                data=data,
            )
        )

    def close(self):
        self._peer.close()


def make_master_stream(experiment_name: str, trial_name: str, name: str = "master") -> NameResolvingRequestClient:
    return NameResolvingRequestClient(experiment_name, trial_name, name)


def make_worker_stream(
    experiment_name: str, trial_name: str, name: str
) -> NameResolvingReplyServer:
    return NameResolvingReplyServer(experiment_name, trial_name, name)
