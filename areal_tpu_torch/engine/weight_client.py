"""Fetch side of the streaming weight-distribution plane (the port's copy
of ``areal_tpu/engine/weight_client.py``).

A generation server prefetches the next weight version into host memory
while it keeps serving the current one: a :class:`ChunkStore` pulls the
payload of one chunk stream chunk by chunk over HTTP from an ordered list
of upstreams (its fanout-tree parent first, surviving peer holders next,
the trainer origin last), verifies every chunk's sha256 and resumes a
torn chunk with an HTTP ``Range`` request. Once complete, the store's
buffer is read as the params tree (``assemble_params``: CPU tensors
viewed over the buffer, int8-wire leaves dequantized) and handed to
``ServingEngine.cutover_params``, the short interrupt + swap window that
is measured apart from the transfer.

Where a chunk has two peer holders, its pull is hedged
(``AREAL_RPC_HEDGE``, base/rpc.py ``hedged_sync``): the second holder
races the first after ``AREAL_RPC_HEDGE_DELAY_S`` of silence, each leg
reads into a buffer of its own, and only the first verified chunk is
copied into the store and counted, so a slow peer costs the fetch one
hedge delay a chunk and the ingress accounting never counts a loser.
The origin is never hedged.

Synchronous stdlib HTTP: the caller runs it on a request thread. Not
ported: shard streams (``tp_degree`` / ``ep_degree``), which wait for
multi-device.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

import torch

from areal_tpu_torch.base import logging, rpc
from areal_tpu_torch.base.chunking import CHUNK_SCHEMA, chunk_spans, verify_chunk
from areal_tpu_torch.system.weight_transfer import (
    dequantize_wire_leaf, torch_dtype, unflatten_leaves)

logger = logging.getLogger("weight_client")

# Per-chunk, per-upstream (re)connection budget (base/rpc.py policy). A
# mid-chunk drop resumes with a Range request, so a retry re-pays at most
# the torn tail.
_CHUNK_ATTEMPTS = 3


class WeightFetchError(RuntimeError):
    """The payload could not be completed from any upstream."""


class ChunkHashMismatch(ValueError):
    """A chunk's bytes failed sha256 verification (torn or corrupted
    upstream). Retryable: the re-fetch restarts the whole chunk."""


def http_get_json(url: str, timeout: float = 10.0) -> Dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def refuse_shard_stream(shard) -> None:
    """Shard streams wait for multi-device: refuse one loudly."""
    if shard:
        raise NotImplementedError(
            f"weight shard streams ({shard}) are not ported: they wait for multi-device "
            f"(ROADMAP Queue A item 7)")


def stream_params(wire: Optional[str] = None) -> Dict[str, str]:
    """Query params that pick one chunk stream of a version: the wire
    precision (``raw`` is left off the URL, as the reference does)."""
    return {"wire": str(wire)} if wire and wire != "raw" else {}


def manifest_stream_params(manifest: Dict) -> Dict[str, str]:
    """The stream-identity params of a fetched manifest (what ChunkStore
    appends to every chunk URL so holders serve the matching stream)."""
    refuse_shard_stream(manifest.get("shard"))
    return stream_params(wire=manifest.get("wire"))


def fetch_manifest(base_url: str, version: Optional[int] = None, timeout: float = 10.0,
                   wire: Optional[str] = None) -> Dict:
    """GET ``{base_url}/weights/manifest``, optionally pinned to a version
    (the holder answers 404 until it can serve exactly that one); ``wire``
    picks the quantized stream."""
    q = stream_params(wire=wire)
    if version is not None:
        q["version"] = str(int(version))
    url = f"{base_url}/weights/manifest"
    if q:
        url += "?" + urllib.parse.urlencode(q)
    man = http_get_json(url, timeout=timeout)
    if man.get("schema") != CHUNK_SCHEMA:
        raise WeightFetchError(
            f"{base_url}: manifest schema {man.get('schema')!r} != {CHUNK_SCHEMA!r}")
    return man


class ChunkStore:
    """Host-memory staging buffer for one (version, payload).

    Verified chunks are servable to sibling fetchers at once (the peer
    hop), so ``has`` / ``chunk`` are safe to call from an HTTP thread
    while ``fetch`` runs on another: ``_have`` flips True only after the
    chunk's bytes are written and verified.
    """

    def __init__(self, manifest: Dict):
        if manifest.get("schema") != CHUNK_SCHEMA:
            raise WeightFetchError(f"bad manifest schema: {manifest.get('schema')!r}")
        refuse_shard_stream(manifest.get("shard"))
        self.manifest = manifest
        self.version = int(manifest["version"])
        self.total_bytes = int(manifest["total_bytes"])
        self.chunk_bytes = int(manifest["chunk_bytes"])
        self.spans = chunk_spans(self.total_bytes, self.chunk_bytes)
        self.n_chunks = len(self.spans)
        if self.n_chunks != int(manifest["n_chunks"]):
            raise WeightFetchError(
                f"manifest n_chunks {manifest['n_chunks']} != computed {self.n_chunks}")
        # The tensors assemble_leaves makes view this buffer: it lives as
        # long as the store (a server keeps its store past the cutover).
        self.buf = bytearray(self.total_bytes)
        self._have = [False] * self.n_chunks
        self._stream_q = manifest_stream_params(manifest)
        # Who served how much (the origin-egress accounting), and time
        # split between fetch and verify.
        self.bytes_from: Dict[str, int] = {}
        self.fetch_s = 0.0
        self.verify_s = 0.0
        self.resumed_chunks = 0
        # Chunks raced between two peers, and races a hedge leg won.
        self.hedged_chunks = 0
        self.hedge_wins = 0
        self._lock = threading.Lock()

    # -- serving side (safe during fetch) ------------------------------

    def complete(self) -> bool:
        return all(self._have)

    def has(self, idx: int) -> bool:
        return 0 <= idx < self.n_chunks and self._have[idx]

    def chunk(self, idx: int) -> memoryview:
        off, length = self.spans[idx]
        return memoryview(self.buf)[off: off + length]

    # -- fetch side ----------------------------------------------------

    def _get_range(self, base_url: str, idx: int, start: int, length: int,
                   timeout: float) -> int:
        """Read bytes [start, length) of chunk ``idx`` from one upstream
        straight into the store's buffer (the chunk is not servable until
        it verifies); returns how many arrived, fewer on a torn read."""
        return self._read_range(base_url, idx, start, length, timeout, self.chunk(idx))

    def _read_range(self, base_url: str, idx: int, start: int, length: int,
                    timeout: float, dst: memoryview) -> int:
        """``_get_range`` into ``dst``, the chunk's bytes wherever they
        live."""
        url = f"{base_url}/weights/chunk?" + urllib.parse.urlencode(
            {"version": self.version, "idx": idx, **self._stream_q})
        req = urllib.request.Request(url)
        if start:
            req.add_header("Range", f"bytes={start}-")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.readinto(dst[start:length])

    def _fetch_chunk(self, base_url: str, idx: int, timeout: float,
                     deadline: Optional[rpc.Deadline] = None,
                     dst: Optional[memoryview] = None) -> Optional[int]:
        """One chunk from one upstream under the RPC retry policy
        (base/rpc.py): Range resume of a torn read, a whole re-fetch on a
        hash mismatch. The bytes land in ``dst`` (default: the chunk's
        place in the store's buffer, which is not servable until it
        verifies). Returns the chunk's length once they verify, or None
        (upstream exhausted)."""
        _, length = self.spans[idx]
        expected = self.manifest["hashes"][idx]
        if dst is None:
            dst, read = self.chunk(idx), self._get_range
        else:
            def read(*args):
                return self._read_range(*args, dst)
        got = 0  # bytes of this chunk in dst, not verified yet

        def attempt(attempt_timeout: float) -> int:
            nonlocal got
            n = read(base_url, idx, got, length, min(timeout, attempt_timeout))
            if got:
                with self._lock:
                    self.resumed_chunks += 1
            got += n
            if got < length:
                raise OSError(f"short read {got}/{length}")  # resume next attempt
            t0 = time.monotonic()
            ok = verify_chunk(dst, expected)
            with self._lock:
                self.verify_s += time.monotonic() - t0
            if not ok:
                got = 0  # poisoned: restart the whole chunk
                raise ChunkHashMismatch(f"chunk {idx} from {base_url}: content-hash mismatch")
            return length

        try:
            return rpc.retry_sync(
                attempt, policy=rpc.default_policy(attempts=_CHUNK_ATTEMPTS),
                deadline=deadline, retryable=(urllib.error.URLError, OSError, ValueError),
                what=f"weights/chunk {idx} <- {base_url}")
        except rpc.RpcDeadlineExceeded:
            raise
        except rpc.RpcError as e:
            logger.debug(f"chunk {idx} from {base_url}: {e}")
            return None

    def _hedge_fetch(self, url: str, idx: int, timeout: float,
                     deadline: rpc.Deadline) -> bytearray:
        """One hedge leg: the chunk into a buffer of the leg's own (a
        losing leg may still be reading when the winner is copied in),
        raising on a miss so the race tells failure from success."""
        part = bytearray(self.spans[idx][1])
        if self._fetch_chunk(url, idx, timeout, deadline, dst=memoryview(part)) is None:
            raise OSError(f"chunk {idx} unavailable from {url}")
        return part

    def fetch(self, upstreams: List[str], origin: Optional[str] = None,
              timeout: float = 30.0, deadline_s: float = 600.0,
              deadline: Optional[rpc.Deadline] = None,
              hedge: Optional[bool] = None) -> Dict[str, Any]:
        """Pull every missing chunk, trying ``upstreams`` in order per
        chunk (sticky: the last upstream that delivered goes first for the
        next chunk). With ``hedge`` (default ``rpc.hedging_enabled()``)
        and two peer upstreams (the origin is never hedged), the first two
        peers in that order race each chunk through ``rpc.hedged_sync``;
        only the winner's verified bytes reach the buffer and
        ``bytes_from``; if both legs fail the remaining upstreams are
        tried in order. Raises WeightFetchError if a chunk cannot be had
        from any upstream before the deadline. Returns the transfer stats
        (also kept on the store)."""
        t_start = time.monotonic()
        order = list(dict.fromkeys(u.rstrip("/") for u in upstreams if u))
        if not order:
            raise WeightFetchError("no upstreams to fetch from")
        origin = origin.rstrip("/") if origin else None
        if deadline is None:
            deadline = rpc.Deadline.after(deadline_s)
        if hedge is None:
            hedge = rpc.hedging_enabled()
        preferred = 0
        for idx in range(self.n_chunks):
            if self._have[idx]:
                continue
            if deadline.expired():
                raise WeightFetchError(f"weight fetch v{self.version} deadline after "
                                       f"{idx}/{self.n_chunks} chunks")
            tried = [order[preferred]] + [u for i, u in enumerate(order) if i != preferred]
            got, winner = None, None
            peers = [u for u in tried if u != origin]
            rest = tried
            if hedge and len(peers) >= 2:
                self.hedged_chunks += 1
                legs = [lambda u=u: self._hedge_fetch(u, idx, timeout, deadline)
                        for u in peers[:2]]
                try:
                    part, i = rpc.hedged_sync(legs, deadline=deadline,
                                              what=f"weights/chunk {idx} v{self.version}")
                    self.chunk(idx)[:] = part
                    got, winner = len(part), peers[i]
                    if i > 0:
                        self.hedge_wins += 1
                except rpc.RpcDeadlineExceeded:
                    raise
                except rpc.RpcError:
                    rest = [u for u in tried if u not in peers[:2]]
            for u in rest if got is None else ():
                got = self._fetch_chunk(u, idx, timeout, deadline)
                if got is not None:
                    winner = u
                    break
            if got is None:
                raise WeightFetchError(
                    f"chunk {idx}/{self.n_chunks} of v{self.version} unavailable from all "
                    f"of {tried}")
            preferred = order.index(winner)
            with self._lock:
                self.bytes_from[winner] = self.bytes_from.get(winner, 0) + got
            self._have[idx] = True
        self.fetch_s = time.monotonic() - t_start
        return self.stats(origin)

    def stats(self, origin: Optional[str] = None) -> Dict[str, Any]:
        origin = origin.rstrip("/") if origin else None
        from_origin = sum(n for u, n in self.bytes_from.items() if u == origin)
        total_in = sum(self.bytes_from.values())
        expected = self.total_bytes
        return {
            "version": self.version,
            "total_bytes": self.total_bytes,
            "expected_bytes": expected,
            "model_total_bytes": int(self.manifest.get("model_total_bytes",
                                                       self.total_bytes)),
            "wire": self.manifest.get("wire", "raw"),
            "shard": self.manifest.get("shard"),
            "ingress_payload_equivalents": total_in / expected if expected else 0.0,
            "n_chunks": self.n_chunks,
            "fetch_s": self.fetch_s,
            "verify_s": self.verify_s,
            "resumed_chunks": self.resumed_chunks,
            "hedged_chunks": self.hedged_chunks,
            "hedge_wins": self.hedge_wins,
            "bytes_from": dict(self.bytes_from),
            "bytes_from_origin": from_origin,
            "bytes_from_peers": total_in - from_origin,
        }


def assemble_leaves(store: ChunkStore) -> Dict[str, torch.Tensor]:
    """Flat {path: tensor} of a complete store's buffer.

    Raw-wire leaves are CPU tensors viewed over the buffer (copied only
    when a leaf's offset is not aligned to its element size), as
    ``load_raw_params`` views a mapped dump; the engine copies them to its
    device at the cutover. int8-wire leaves dequantize here, bit-equal to
    the reference's ``dequantize_wire_leaf``."""
    if not store.complete():
        raise WeightFetchError(f"assemble on incomplete store v{store.version}")
    base = torch.frombuffer(store.buf, dtype=torch.uint8) if store.total_bytes else None
    base_ptr = base.data_ptr() if base is not None else 0

    def view(off: int, nbytes: int, dtype: torch.dtype, shape) -> torch.Tensor:
        raw = base[off: off + nbytes]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if (base_ptr + off) % itemsize:
            raw = raw.clone()
        return raw.view(dtype).reshape(shape)

    leaves = {}
    for e in store.manifest["leaves"]:
        dt = torch_dtype(e["dtype"])
        if e.get("wire", "raw") == "int8":
            q = view(int(e["offset"]), int(e["nbytes"]), torch.int8, e["shape"])
            s = view(int(e["scale_offset"]), int(e["scale_nbytes"]), torch.float32,
                     e["scale_shape"])
            leaves[e["path"]] = dequantize_wire_leaf(q, s, e["dtype"])
        else:
            n = 1
            for d in e["shape"]:
                n *= int(d)
            nbytes = int(e.get("nbytes") or n * torch.empty((), dtype=dt).element_size())
            leaves[e["path"]] = view(int(e["offset"]), nbytes, dt, e["shape"])
    return leaves


def assemble_params(store: ChunkStore) -> Tuple[Any, int]:
    """A complete store's buffer as the nested-dict params tree and its
    version."""
    return unflatten_leaves(assemble_leaves(store)), store.version
