"""Rollout -> trainer trajectory transport: ZMQ PUSH/PULL of JSON dicts
(the port's copy of ``areal_tpu/system/push_pull_stream.py``).

M rollout-worker pushers are deterministically grouped onto N
trainer-side pullers, addresses are discovered via name_resolve, and
messages are newline-free JSON objects (trajectories are token-id lists).
The wire is the reference's byte for byte, acks included: a reference
pusher feeds a port puller and the other way round.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

import zmq

from areal_tpu_torch.base import env_registry, logging, name_resolve, names, network, tracing

logger = logging.getLogger("push_pull_stream")

# Reserved payload keys for the exactly-once ledger (AREAL_WAL): the
# pusher's minted sequence id and its ack return address ride the JSON
# like the trace context does, and the puller strips them back off.
SEQ_KEY = "__wal_seq__"
ACK_KEY = "__ack__"


class ZMQJsonPusher:
    """PUSH end. Connects to a puller's bound address.

    With ``ack=True`` the pusher also binds a PULL socket for acks and
    keeps every pushed sample in an unacked window until the puller
    confirms it journaled the sample durably; `redeliver()` re-sends
    samples whose ack timed out (a killed/restarted puller), so a
    trainer SIGKILL never loses an in-flight rollout.
    """

    def __init__(self, host: str, port: int, hwm: int = 1000, ack: bool = False):
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PUSH)
        self.sock.setsockopt(zmq.SNDHWM, hwm)
        self.sock.setsockopt(zmq.LINGER, 0)
        self.addr = f"tcp://{host}:{port}"
        self.sock.connect(self.addr)
        self._ack_enabled = ack
        # seq -> (payload, last_send_monotonic, redeliveries so far).
        self._unacked: Dict[str, Tuple[Dict[str, Any], float, int]] = {}
        self.counters = {"areal:train_samples_lost_total": 0}
        if ack:
            ack_host = network.gethostip()
            self.ack_sock = self.ctx.socket(zmq.PULL)
            self.ack_sock.setsockopt(zmq.LINGER, 0)
            ack_port = self.ack_sock.bind_to_random_port(f"tcp://{ack_host}")
            self.ack_addr = f"{ack_host}:{ack_port}"

    def push(self, data: Dict[str, Any], seq: Optional[str] = None):
        # Best-effort RL-trace propagation: the current span context rides
        # the JSON under a reserved key the puller strips back off (one
        # no-op branch when tracing is disabled).
        data = tracing.inject_into(data)
        if self._ack_enabled and seq is not None:
            data = {**data, SEQ_KEY: seq, ACK_KEY: self.ack_addr}
            self._unacked[seq] = (data, time.monotonic(), 0)
        self.sock.send_string(json.dumps(data, separators=(",", ":")), flags=0)

    def drain_acks(self) -> int:
        """Consume pending acks off the ack socket; returns how many
        samples left the unacked window."""
        if not self._ack_enabled:
            return 0
        n = 0
        while self.ack_sock.poll(0):
            seq = self.ack_sock.recv_string()
            if self._unacked.pop(seq, None) is not None:
                n += 1
        return n

    def unacked(self) -> int:
        return len(self._unacked)

    def redeliver(self, timeout_s: Optional[float] = None,
                  max_redeliver: Optional[int] = None) -> int:
        """Re-send samples unacked for AREAL_WAL_ACK_TIMEOUT_S. The
        puller-side ledger makes redelivery idempotent, so over-sending
        is safe; under the default unbounded AREAL_WAL_REDELIVER_MAX
        budget nothing is ever dropped (exactly-once). Returns the
        number redelivered."""
        if not self._ack_enabled or not self._unacked:
            return 0
        if timeout_s is None:
            timeout_s = env_registry.get_float("AREAL_WAL_ACK_TIMEOUT_S")
        if max_redeliver is None:
            max_redeliver = env_registry.get_int("AREAL_WAL_REDELIVER_MAX")
        now = time.monotonic()
        redelivered = 0
        for seq, (data, sent_at, attempts) in list(self._unacked.items()):
            if now - sent_at < timeout_s:
                continue
            if max_redeliver and attempts >= max_redeliver:
                del self._unacked[seq]
                self.counters["areal:train_samples_lost_total"] += 1
                logger.error("sample %s dropped after %d redeliveries", seq, attempts)
                continue
            self.sock.send_string(json.dumps(data, separators=(",", ":")), flags=0)
            self._unacked[seq] = (data, now, attempts + 1)
            redelivered += 1
        return redelivered

    def reconnect(self, host: str, port: int):
        """Point the PUSH socket at a (possibly new) puller address — a
        restarted puller binds a fresh random port, so redelivery after
        a trainer kill must re-target before it can land."""
        addr = f"tcp://{host}:{port}"
        if addr == self.addr:
            return
        try:
            self.sock.disconnect(self.addr)
        except zmq.ZMQError:
            pass
        self.addr = addr
        self.sock.connect(addr)

    def close(self):
        self.sock.close()
        if self._ack_enabled:
            self.ack_sock.close()


class ZMQJsonPuller:
    """PULL end. Binds and accepts many pushers."""

    # RL-trace context of the most recent message (None before the first
    # pull, when absent, or when tracing is disabled).
    last_trace_ctx = None
    # Sequence id + ack return address of the most recent message (None
    # when the pusher is not in ack mode). The consumer acks via
    # `ack(seq, addr)` only AFTER the sample is durable (WAL fsync) —
    # acking earlier would let a kill between ack and fsync lose it.
    last_seq = None
    last_ack_addr = None

    def __init__(self, host: str = "0.0.0.0", port: Optional[int] = None, hwm: int = 1000,
                 default_timeout_ms: int = 100):
        self.ctx = zmq.Context.instance()
        self.sock = self.ctx.socket(zmq.PULL)
        self.sock.setsockopt(zmq.RCVHWM, hwm)
        self.sock.setsockopt(zmq.LINGER, 0)
        if port is None:
            self.port = self.sock.bind_to_random_port(f"tcp://{host}")
        else:
            self.sock.bind(f"tcp://{host}:{port}")
            self.port = port
        self.host = host
        self.default_timeout_ms = default_timeout_ms
        self._ack_socks: Dict[str, zmq.Socket] = {}

    def pull(self, timeout_ms: Optional[int] = None) -> Dict[str, Any]:
        """Blocking with timeout; raises queue-empty style TimeoutError.

        Strips the pusher's RL-trace context off the payload and exposes
        it as `last_trace_ctx` (None when absent/disabled) so consumers
        can parent their spans without the key leaking into the data;
        same treatment for the ledger's seq/ack-address keys."""
        t = self.default_timeout_ms if timeout_ms is None else timeout_ms
        # Reset first: a timeout must not leave a previous message's
        # context attributed to whatever the caller reads next.
        self.last_trace_ctx = None
        self.last_seq = None
        self.last_ack_addr = None
        if not self.sock.poll(t):
            raise TimeoutError("no message within timeout")
        d = json.loads(self.sock.recv_string())
        self.last_trace_ctx = tracing.extract_from(d)
        self.last_seq = d.pop(SEQ_KEY, None)
        self.last_ack_addr = d.pop(ACK_KEY, None)
        return d

    def ack(self, seq: str, addr: str):
        """Confirm `seq` durable to the pusher that sent it (addr from
        the message's ack key). Best-effort: a dead pusher's socket just
        buffers and is dropped on close — redelivery handles the rest."""
        sock = self._ack_socks.get(addr)
        if sock is None:
            sock = self.ctx.socket(zmq.PUSH)
            sock.setsockopt(zmq.LINGER, 0)
            sock.connect(f"tcp://{addr}")
            self._ack_socks[addr] = sock
        try:
            sock.send_string(seq, flags=zmq.NOBLOCK)
        except zmq.Again:
            logger.warning("ack %s to %s dropped (pusher backlogged/gone)", seq, addr)

    def close(self):
        self.sock.close()
        for sock in self._ack_socks.values():
            sock.close()
        self._ack_socks.clear()


def grouping(n_pushers: int, n_pullers: int) -> Dict[int, List[int]]:
    """puller index -> pusher indices, contiguous blocks."""
    if not n_pushers >= n_pullers > 0:
        raise ValueError(f"cannot group {n_pushers} pushers onto {n_pullers} pullers")
    base = n_pushers // n_pullers
    rem = n_pushers % n_pullers
    out: Dict[int, List[int]] = {}
    start = 0
    for i in range(n_pullers):
        cnt = base + (1 if i < rem else 0)
        out[i] = list(range(start, start + cnt))
        start += cnt
    return out


class NameResolvingZmqPuller(ZMQJsonPuller):
    """Puller that registers its address under the stream name."""

    def __init__(self, experiment_name: str, trial_name: str, puller_index: int, **kwargs):
        host_ip = network.gethostip()
        super().__init__(host=host_ip, **kwargs)
        key = names.push_pull_stream(
            experiment_name, trial_name, f"puller{puller_index}"
        )
        name_resolve.add(key, f"{host_ip}:{self.port}", keepalive_ttl=60, replace=True)


class NameResolvingZmqPusher(ZMQJsonPusher):
    """Pusher that looks up its assigned puller by the grouping rule."""

    def __init__(self, experiment_name: str, trial_name: str, pusher_index: int,
                 n_pushers: int, n_pullers: int, **kwargs):
        group = grouping(n_pushers, n_pullers)
        puller_index = next(i for i, pushers in group.items() if pusher_index in pushers)
        self.stream_key = names.push_pull_stream(
            experiment_name, trial_name, f"puller{puller_index}"
        )
        addr = name_resolve.wait(self.stream_key, timeout=300)
        host, port = addr.rsplit(":", 1)
        super().__init__(host, int(port), **kwargs)

    def re_resolve(self, timeout: float = 5) -> bool:
        """Re-look-up the puller and reconnect if its address changed —
        a restarted puller re-registers under the same stream name with
        a fresh port, so the redelivery path calls this before
        re-sending. Returns False when the name is (still) absent."""
        try:
            addr = name_resolve.wait(self.stream_key, timeout=timeout)
        except TimeoutError:
            return False
        host, port = addr.rsplit(":", 1)
        self.reconnect(host, int(port))
        return True
