"""Streaming weight-distribution plane (the port's copy of the unsharded
part of ``areal_tpu/system/weight_plane.py``).

The disk path (system/weight_transfer.py) makes every generation server
re-read the whole dump on every version. The plane replaces it:

- :class:`WeightPlaneSource`: the trainer's dump rank (or the gserver
  manager's fallback) serves the raw dump (``params-v{N}.bin`` and its
  int8 companion) over chunked HTTP, each chunk named by its sha256, with
  ``Range`` resume;
- :func:`plan_fanout`: the manager plans a degree-bounded peer tree per
  version, so the origin uploads each byte at most ``degree`` times and
  every other hop is peer to peer;
- :class:`PeerStoreServer`: a holder serving a fetched
  :class:`~areal_tpu_torch.engine.weight_client.ChunkStore` over the same
  ``/weights/...`` contract (generation servers mount the same handlers,
  ``serve_store_manifest`` / ``serve_store_chunk``, on their own server).

HTTP runs on the standard library's ``ThreadingHTTPServer``, one thread a
request, so a chunk request never waits behind another. Not ported: shard
streams (``tp_degree`` / ``ep_degree`` queries answer 501; they wait for
multi-device) and shard-local dumps.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from areal_tpu_torch.base import logging
from areal_tpu_torch.base.chunking import CHUNK_SCHEMA, DEFAULT_CHUNK_BYTES, build_chunk_index
from areal_tpu_torch.base.fault_injection import faults

logger = logging.getLogger("weight_plane")

_MANIFEST = "params.json"  # weight_transfer's manifest name

# (status, body, content type, extra headers), as the generation server's.
Response = Tuple[int, bytes, str, Dict[str, str]]


def _json(payload: Any, status: int = 200) -> Response:
    # aiohttp's json_response: json.dumps with default separators.
    return status, json.dumps(payload).encode(), "application/json; charset=utf-8", {}


# ----------------------------------------------------------------------
# Manifest: raw dump + chunk index
# ----------------------------------------------------------------------


def _sidecar_index(dump_dir: str, bin_name: str, chunk_bytes: int) -> Optional[Dict]:
    """The chunk index dump_raw_params published next to the bin (spares
    the origin a re-read and sha256 of the whole bin), or None when absent
    or of another chunk size."""
    from areal_tpu_torch.system.weight_transfer import chunk_sidecar_name

    try:
        with open(os.path.join(dump_dir, chunk_sidecar_name(bin_name))) as f:
            idx = json.load(f)
    except (OSError, ValueError, json.JSONDecodeError):
        return None
    if idx.get("schema") != CHUNK_SCHEMA or idx.get("chunk_bytes") != chunk_bytes:
        return None
    return idx


def chunk_manifest_for_dump(dump_dir: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                            wire: Optional[str] = None) -> Optional[Dict]:
    """The dump's params.json merged with its chunk index, or None when no
    complete raw dump is there; retries once on the GC race. ``wire="int8"``
    gives the manifest of the quantized companion bin, whose layout
    sidecar is its source of truth (None when the dump has no such
    wire)."""
    from areal_tpu_torch.system.weight_transfer import (
        _read_manifest, read_layout_sidecar, wire_bin_name)

    for _ in range(2):
        man = _read_manifest(dump_dir)
        if man is None:
            return None
        if man.get("storage") == "sharded":
            raise NotImplementedError(
                f"{dump_dir} holds a shard-local dump: those wait for multi-device "
                f"(ROADMAP Queue A item 7)")
        version = int(man["version"])
        if wire not in (None, "raw", "model"):
            bin_name = wire_bin_name(version, wire)
            layout = read_layout_sidecar(dump_dir, bin_name)
            if layout is None or layout.get("wire") != wire:
                return None
            leaves = layout["leaves"]
            want_total = int(layout["total_bytes"])
        else:
            wire = None
            bin_name = man["bin"]
            leaves = man["leaves"]
            want_total = man.get("total_bytes")
        try:
            idx = _sidecar_index(dump_dir, bin_name, chunk_bytes)
            if idx is None:
                idx = build_chunk_index(os.path.join(dump_dir, bin_name), chunk_bytes)
        except FileNotFoundError:
            continue
        except (OSError, ValueError, KeyError):
            return None
        if idx["total_bytes"] != want_total:
            return None  # torn write, or a stale sidecar
        return {
            **idx,
            "version": version,
            "bin": bin_name,
            "wire": wire or "raw",
            # The full payload of this wire: the denominator of the
            # origin's full_payload_equivalents.
            "model_total_bytes": int(idx["total_bytes"]),
            "leaves": leaves,
        }
    return None


def manifest_stream_key(man_or_query: Dict) -> Tuple[str, int, int, int, int]:
    """(wire, tp_degree, tp_rank, ep_degree, ep_rank) identity of a chunk
    stream: holders serve only requests for their own stream."""
    wire = man_or_query.get("wire") or "raw"
    shard = man_or_query.get("shard") or {}
    degree = int(man_or_query.get("tp_degree") or shard.get("tp_degree") or 1)
    rank = int(man_or_query.get("tp_rank") or shard.get("tp_rank") or 0)
    ep_degree = int(man_or_query.get("ep_degree") or shard.get("ep_degree") or 1)
    ep_rank = int(man_or_query.get("ep_rank") or shard.get("ep_rank") or 0)
    return (str(wire), degree, rank, ep_degree, ep_rank)


# ----------------------------------------------------------------------
# Shared HTTP surface (origin and peers speak the same contract)
# ----------------------------------------------------------------------


def parse_range_start(headers) -> int:
    """``Range: bytes=<start>-`` -> start (0 when absent or malformed): the
    resume offset of a torn chunk download."""
    rng = headers.get("Range", "") or ""
    if rng.startswith("bytes=") and rng.endswith("-"):
        try:
            return max(0, int(rng[len("bytes="):-1]))
        except ValueError:
            return 0
    return 0


def chunk_response(data, start: int, chunk_hash: str) -> Response:
    """A chunk (bytes, or a memoryview of a verified chunk, sent without
    a copy) from ``start`` on."""
    if start >= len(data):
        return _json({"error": "range start past chunk"}, 416)
    # Chaos point (corrupt): flip payload bytes after the hash header was
    # stamped; every consumer's sha256 verify must catch it.
    body = faults.maybe_corrupt("weight_plane.chunk_bytes", data[start:] if start else data)
    return (206 if start else 200, body, "application/octet-stream",
            {"X-Chunk-Hash": chunk_hash, "X-Chunk-Bytes": str(len(data))})


def _store_matches_query(store, query) -> bool:
    """A holder serves exactly one chunk stream, its manifest's (wire,
    shard) identity; a request for another one 404s."""
    try:
        want = manifest_stream_key(dict(query))
    except ValueError:
        return False
    return manifest_stream_key(store.manifest) == want


def serve_store_manifest(store, query) -> Response:
    """The /weights/manifest contract of a ChunkStore holder."""
    want = query.get("version")
    try:
        want_v = int(want) if want is not None else None
    except ValueError:
        return _json({"error": "bad version"}, 400)
    if store is None or (want_v is not None and store.version != want_v):
        return _json({"error": "not holding"}, 404)
    if not _store_matches_query(store, query):
        return _json({"error": "holding a different chunk stream"}, 404)
    return _json(store.manifest)


def serve_store_chunk(store, query, headers) -> Tuple[Response, int]:
    """The /weights/chunk contract of a ChunkStore holder: (response,
    bytes served). A fetching holder 404s chunks it has not verified yet;
    the child retries or falls back to its next upstream."""
    try:
        version = int(query["version"])
        idx = int(query["idx"])
    except (KeyError, ValueError):
        return _json({"error": "version/idx required"}, 400), 0
    if (store is None or store.version != version or not _store_matches_query(store, query)
            or not store.has(idx)):
        return _json({"error": "chunk not held"}, 404), 0
    data = store.chunk(idx)
    start = parse_range_start(headers)
    return (chunk_response(data, start, store.manifest["hashes"][idx]),
            max(0, len(data) - start))


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 128

    def __init__(self, addr, owner: "_PlaneHTTP"):
        self.owner = owner
        super().__init__(addr, _Handler)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_GET(self):
        self.server.owner._dispatch(self)

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)


def write_response(handler: BaseHTTPRequestHandler, resp: Response, extra=None) -> None:
    """Send one response (Content-Length always set, HTTP/1.1)."""
    status, data, ctype, headers = resp
    handler.send_response(status)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(data)))
    for k, v in {**headers, **(extra or {})}.items():
        handler.send_header(k, v)
    handler.end_headers()
    try:
        handler.wfile.write(data)
    except (BrokenPipeError, ConnectionResetError):
        # The client gave up (a cancelled rollout at shutdown).
        logger.debug(f"client left before the reply to {handler.command} {handler.path}")


class _PlaneHTTP:
    """A GET-only HTTP server on its own thread, shared by the origin and
    the peer holders."""

    def __init__(self, host: str = "127.0.0.1"):
        self._host = host
        self._httpd: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self.address: str = ""

    def routes(self) -> Dict[str, Callable[[Any, Dict[str, str]], Response]]:
        raise NotImplementedError

    def start(self):
        self._routes = self.routes()
        self._httpd = _Server((self._host, 0), self)
        self.address = f"http://{self._host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def _dispatch(self, handler: BaseHTTPRequestHandler):
        parts = urllib.parse.urlsplit(handler.path)
        query = dict(urllib.parse.parse_qsl(parts.query))
        fn = self._routes.get(parts.path)
        if fn is None:
            resp = (404, b"404: Not Found", "text/plain; charset=utf-8", {})
        else:
            try:
                resp = fn(handler.headers, query)
            except Exception:
                logger.exception(f"error handling GET {handler.path}")
                resp = (500, b"500 Internal Server Error\n\nServer got itself in trouble",
                        "text/plain; charset=utf-8", {})
        write_response(handler, resp)

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None


def _parse_stream_query(query) -> Tuple[Optional[int], str]:
    """(pinned version or None, wire) of a stream query. A shard stream
    raises NotImplementedError (answered 501), a malformed one ValueError
    (400)."""
    want = query.get("version")
    want_v = int(want) if want is not None else None
    wire = query.get("wire") or "raw"
    degree, rank = int(query.get("tp_degree") or 1), int(query.get("tp_rank") or 0)
    ep_degree, ep_rank = int(query.get("ep_degree") or 1), int(query.get("ep_rank") or 0)
    if degree < 1 or not (0 <= rank < degree) or ep_degree < 1 or not (0 <= ep_rank < ep_degree):
        raise ValueError(f"bad shard {rank}/{degree}, expert shard {ep_rank}/{ep_degree}")
    if degree > 1 or ep_degree > 1:
        raise NotImplementedError(
            f"shard streams (tp {rank}/{degree}, ep {ep_rank}/{ep_degree}) are not ported: "
            f"they wait for multi-device (ROADMAP Queue A item 7)")
    return want_v, wire


class WeightPlaneSource(_PlaneHTTP):
    """Trainer-side origin: serves the dump dir over chunked HTTP. Builds
    the chunk manifest of each version lazily (from the dump's sidecar when
    its chunk size matches) and counts every byte it sends, so the fleet's
    one-payload-from-the-origin property is read off these counters."""

    def __init__(self, dump_dir: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 host: str = "127.0.0.1"):
        super().__init__(host=host)
        self.dump_dir = dump_dir
        self.chunk_bytes = chunk_bytes
        # Cached manifests, one per wire ("raw" / "int8").
        self._man: Dict[str, Optional[Dict]] = {}
        # Cached pread readers per (version, wire). Pruned readers retire
        # with a grace period: a request thread may still be reading one.
        self._readers: Dict[Tuple[int, str], Any] = {}
        self._retired_readers: List[Tuple[float, Any]] = []
        self._lock = threading.Lock()
        # Serializes manifest (re)builds without blocking chunk serving: a
        # build may sha256 the whole bin when the sidecar is missing.
        self._build_lock = threading.Lock()
        # Per-version egress counters (they survive re-dumps).
        self.chunks_served: Dict[int, int] = {}
        self.bytes_served: Dict[int, int] = {}
        # Egress and full payload per (version, wire): each wire's egress
        # divides by its own full payload.
        self._bytes_by_wire: Dict[Tuple[int, str], int] = {}
        self._full_by_wire: Dict[Tuple[int, str], int] = {}

    def routes(self):
        return {"/weights/manifest": self._h_manifest, "/weights/chunk": self._h_chunk,
                "/weights/stats": self._h_stats}

    def register(self, experiment_name: str, trial_name: str, model_name: str):
        """Publish this origin's URL for manager discovery."""
        from areal_tpu_torch.base import name_resolve, names

        name_resolve.add(names.weight_plane_source(experiment_name, trial_name, model_name),
                         self.address, keepalive_ttl=60, replace=True)
        return self

    def _dump_version(self) -> Optional[int]:
        """The dump dir's current version, off params.json alone."""
        try:
            with open(os.path.join(self.dump_dir, _MANIFEST)) as f:
                return int(json.load(f)["version"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None

    def _cached_manifest(self, want_version: Optional[int], wire: str) -> Optional[Dict]:
        """The cached manifest, or None when it cannot serve this request
        (absent, another pinned version, or, unpinned, older than the
        dump dir's current version)."""
        with self._lock:
            man = self._man.get(wire)
        if man is None:
            return None
        if want_version is None:
            cur = self._dump_version()
            return None if cur is not None and cur != man["version"] else man
        return man if man["version"] == want_version else None

    def _manifest(self, want_version: Optional[int], wire: str = "raw") -> Optional[Dict]:
        man = self._cached_manifest(want_version, wire)
        if man is not None:
            return man
        # A pinned version this dir does not hold 404s cheaply, without a
        # rebuild.
        if want_version is not None and self._dump_version() != want_version:
            return None
        with self._build_lock:
            man = self._cached_manifest(want_version, wire)  # built while we waited
            if man is None:
                man = chunk_manifest_for_dump(self.dump_dir, self.chunk_bytes,
                                              wire=None if wire == "raw" else wire)
                if man is not None:
                    with self._lock:
                        self._man[wire] = man
        if man is None or (want_version is not None and man["version"] != want_version):
            return None
        return man

    def _get_reader(self, man: Dict):
        """The cached reader of one manifest's bin, or None when the bin
        vanished (GC race: the caller 404s). Readers of versions older
        than the last two retire."""
        from areal_tpu_torch.system.weight_transfer import DumpStreamReader

        version = int(man["version"])
        key = (version, man.get("wire", "raw"))
        with self._lock:
            r = self._readers.get(key)
        if r is not None:
            return r
        try:
            r = DumpStreamReader(self.dump_dir, man)
        except (OSError, ValueError, KeyError):
            return None
        now = time.monotonic()
        with self._lock:
            have = self._readers.get(key)
            if have is not None:
                r.close()
                return have
            for k in [k for k in self._readers if k[0] < version - 1]:
                self._retired_readers.append((now, self._readers.pop(k)))
            self._readers[key] = r
            closable = [old for t, old in self._retired_readers if now - t > 120.0]
            self._retired_readers = [(t, old) for t, old in self._retired_readers
                                     if now - t <= 120.0]
        for old in closable:
            old.close()
        return r

    def close(self):
        super().close()
        with self._lock:
            readers = list(self._readers.values()) + [r for _, r in self._retired_readers]
            self._readers = {}
            self._retired_readers = []
        for r in readers:
            r.close()

    def _h_manifest(self, headers, query) -> Response:
        try:
            want_v, wire = _parse_stream_query(query)
        except NotImplementedError as e:
            return _json({"error": str(e)}, 501)
        except ValueError:
            return _json({"error": "bad stream query"}, 400)
        man = self._manifest(want_v, wire)
        if man is None:
            return _json({"error": "no dump for requested stream", "retry_after": 0.2}, 404)
        return _json(man)

    def _count_egress(self, version: int, wire: str, full_bytes: int, served: int) -> None:
        with self._lock:
            self.chunks_served[version] = self.chunks_served.get(version, 0) + 1
            self.bytes_served[version] = self.bytes_served.get(version, 0) + served
            self._bytes_by_wire[(version, wire)] = (
                self._bytes_by_wire.get((version, wire), 0) + served)
            self._full_by_wire[(version, wire)] = full_bytes

    def _h_chunk(self, headers, query) -> Response:
        faults.maybe_fail("weight_plane.serve_chunk")
        try:
            version = int(query["version"])
            idx = int(query["idx"])
            _, wire = _parse_stream_query(query)
        except NotImplementedError as e:
            return _json({"error": str(e)}, 501)
        except (KeyError, ValueError):
            return _json({"error": "version/idx required"}, 400)
        start = parse_range_start(headers)
        man = self._manifest(version, wire)
        if man is None or not (0 <= idx < man["n_chunks"]):
            return _json({"error": "unknown chunk"}, 404)
        off = idx * man["chunk_bytes"]
        length = min(man["chunk_bytes"], man["total_bytes"] - off)
        # One pread a request, off the dump host's page cache.
        reader = self._get_reader(man)
        if reader is None:
            return _json({"error": "bin vanished (GC race)"}, 404)
        try:
            data = reader.read_at(off, length)
        except (OSError, ValueError):
            return _json({"error": "short read"}, 404)
        self._count_egress(version, wire, int(man.get("model_total_bytes", man["total_bytes"])),
                           max(0, length - start))
        return chunk_response(data, start, man["hashes"][idx])

    def stats(self) -> Dict:
        with self._lock:
            return {
                "chunks_served": dict(self.chunks_served),
                "bytes_served": dict(self.bytes_served),
                # Full-payload equivalents sent per version: each (version,
                # wire)'s egress over that wire's own full payload, summed
                # over the wires.
                "full_payload_equivalents": {
                    v: sum((b / self._full_by_wire[(vv, w)]
                            if self._full_by_wire.get((vv, w)) else 0.0)
                           for (vv, w), b in self._bytes_by_wire.items() if vv == v)
                    for v in {vv for vv, _ in self._bytes_by_wire}
                } or {v: 0.0 for v in self.bytes_served},
            }

    def _h_stats(self, headers, query) -> Response:
        return _json(self.stats())


class PeerStoreServer(_PlaneHTTP):
    """Serve a fetched ChunkStore over the same /weights contract (a
    holder); generation servers mount the same handlers on their own
    server."""

    def __init__(self, host: str = "127.0.0.1"):
        super().__init__(host=host)
        self.store = None  # engine.weight_client.ChunkStore
        self.chunks_served = 0
        self.bytes_served = 0
        self._count_lock = threading.Lock()

    def routes(self):
        return {"/weights/manifest": self._h_manifest, "/weights/chunk": self._h_chunk}

    def _h_manifest(self, headers, query) -> Response:
        return serve_store_manifest(self.store, query)

    def _h_chunk(self, headers, query) -> Response:
        faults.maybe_fail("weight_plane.serve_chunk")
        resp, served = serve_store_chunk(self.store, query, headers)
        if served:
            with self._count_lock:
                self.chunks_served += 1
                self.bytes_served += served
        return resp


# ----------------------------------------------------------------------
# Fanout planning
# ----------------------------------------------------------------------


def plan_fanout(origin_url: str, server_urls: List[str],
                degree: int) -> List[List[Tuple[str, str]]]:
    """Degree-bounded distribution tree as BFS waves:
    ``[[(server_url, parent_url), ...], ...]``; wave k's servers fetch
    from parents that completed in wave k-1 (wave 0's parent is the
    origin). Server i's parent is ``servers[i // degree - 1]`` (the
    origin for ``i < degree``), so the origin uploads at most ``degree``
    copies of each byte."""
    if degree < 1:
        raise ValueError(f"fanout degree must be >= 1, got {degree}")
    servers = list(server_urls)
    waves: List[List[Tuple[str, str]]] = []
    level: Dict[str, int] = {}
    for i, u in enumerate(servers):
        parent = origin_url if i < degree else servers[i // degree - 1]
        lvl = 0 if i < degree else level[parent] + 1
        level[u] = lvl
        while len(waves) <= lvl:
            waves.append([])
        waves[lvl].append((u, parent))
    return waves


def fanout_edges(waves: List[List[Tuple[str, str]]]) -> List[Tuple[str, str]]:
    return [edge for wave in waves for edge in wave]


def group_by_shard(server_urls: List[str],
                   shards: Dict[str, Optional[Tuple[int, int]]]
                   ) -> Dict[Tuple[int, int], List[str]]:
    """Same-shard peer groups, keyed ``(tp_degree, tp_rank)``. The port
    serves unsharded fleets only: every server lands in ``(1, 0)``, and a
    sharded spec raises NotImplementedError (shard streams wait for
    multi-device)."""
    for u in server_urls:
        spec = shards.get(u)
        if spec is not None and int(spec[1]) > 1:
            raise NotImplementedError(
                f"{u} holds weight shard {spec[0]}/{spec[1]}: shard streams wait for "
                f"multi-device (ROADMAP Queue A item 7)")
    return {(1, 0): list(server_urls)} if server_urls else {}


def distribute_to_stores(origin_url: str, n_holders: int, degree: int,
                         version: Optional[int] = None, timeout: float = 30.0
                         ) -> Tuple[List[PeerStoreServer], Dict]:
    """Fetch one payload from ``origin_url`` into ``n_holders`` fresh
    PeerStoreServers along a degree-bounded tree, wave by wave. Returns
    (holders, stats); the caller closes the holders."""
    from areal_tpu_torch.engine.weight_client import ChunkStore, fetch_manifest

    man = fetch_manifest(origin_url, version=version, timeout=timeout)
    holders = [PeerStoreServer().start() for _ in range(n_holders)]
    by_url = {h.address: h for h in holders}
    waves = plan_fanout(origin_url, [h.address for h in holders], degree)
    t0 = time.monotonic()
    per_holder: Dict[str, Dict] = {}
    completed: List[str] = []
    for wave in waves:
        threads = []
        for url, parent in wave:
            holder = by_url[url]
            holder.store = ChunkStore(man)
            # Surviving peer holders before the origin, as the manager
            # orders them: a holder that dies mid-chain costs its subtree
            # a re-parent, not an origin upload.
            fallbacks = [u for u in completed if u != parent][:2]

            def run(h=holder, p=parent, fb=fallbacks):
                per_holder[h.address] = h.store.fetch([p] + fb + [origin_url],
                                                      origin=origin_url, timeout=timeout)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=timeout * max(1, man["n_chunks"]))
        completed.extend(u for u, _ in wave if u in per_holder)
    missing = [u for u, _ in fanout_edges(waves) if u not in per_holder]
    if missing:
        for h in holders:
            h.close()
        raise RuntimeError(f"fanout incomplete: {missing} never finished")
    return holders, {
        "version": man["version"], "total_bytes": man["total_bytes"],
        "n_chunks": man["n_chunks"], "wall_s": time.monotonic() - t0,
        "per_holder": per_holder,
    }
