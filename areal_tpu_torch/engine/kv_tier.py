"""Tiered KV store: host-RAM (+ optional local-disk) home for parked
prefixes that no longer fit the device pool (the port's copy of
``areal_tpu/engine/kv_tier.py``).

The serving engine's prefix eviction SPILLS a parked prefix here, in the
``areal-kv-handoff/v1`` blob format (engine/kv_handoff.py), content-
hashed per chunk, instead of freeing it; a returning session restores
the prefix through ``import_kv_handoff`` instead of a full re-prefill.

Two tiers:

- **host**: an LRU of (meta, payload) pairs bounded by
  ``host_capacity_bytes`` of payload;
- **disk** (optional): host-LRU evictions demote into ``disk_dir``
  (meta json + payload bin per entry, content-addressed filenames),
  bounded by ``disk_capacity_bytes``; a disk read re-verifies every
  chunk hash before the entry is trusted (a torn or corrupted file is
  dropped and counted, never imported).

Entries are keyed by qid and carry the prefix content hash and the
weight version they were computed under; the manager's global prefix
index reads ``held()``. Payloads are opaque bytes, so the server serves
them to peers (``/kv/{manifest,chunk}``) without touching the device.
Writes are not fsynced, as in the reference.

Thread-safe: the engine's spill thread writes, server threads read and
serve, one lock serializes it all.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from areal_tpu_torch.base import logging
from areal_tpu_torch.base.chunking import chunk_spans, hash_chunk
from areal_tpu_torch.base.wire_schemas import KV_TIER_V1

logger = logging.getLogger("kv_tier")

TIER_SCHEMA = KV_TIER_V1


class _Entry:
    __slots__ = ("meta", "payload", "n_bytes", "path")

    def __init__(self, meta: Dict, payload: Optional[bytes],
                 n_bytes: int, path: Optional[str] = None):
        self.meta = meta
        self.payload = payload  # None when demoted to disk
        self.n_bytes = n_bytes
        self.path = path  # disk payload path when demoted

    @property
    def tier(self) -> str:
        return "host" if self.payload is not None else "disk"


def verify_payload(meta: Dict, payload: bytes) -> bool:
    """Re-hash a payload against its handoff chunk index (the authority
    rule: the hash, not the filesystem, decides whether bytes are the
    prefix). Cheap relative to the device scatter it gates."""
    index = meta.get("chunks") or {}
    if len(payload) != int(index.get("total_bytes", -1)):
        return False
    cb = int(index.get("chunk_bytes") or 1)
    hashes = index.get("hashes") or []
    for i, (off, ln) in enumerate(chunk_spans(len(payload), cb)):
        if i >= len(hashes) or hash_chunk(payload[off: off + ln]) != hashes[i]:
            return False
    return True


class KVTierStore:
    """LRU host-RAM KV tier with an optional local-disk second tier."""

    def __init__(
        self,
        host_capacity_bytes: int,
        disk_dir: Optional[str] = None,
        disk_capacity_bytes: int = 1 << 30,
    ):
        assert host_capacity_bytes > 0, "use None/0 upstream to disable"
        self.host_capacity = int(host_capacity_bytes)
        self.disk_dir = disk_dir
        self.disk_capacity = int(disk_capacity_bytes)
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)
        self._lock = threading.Lock()
        # qid -> _Entry, LRU order (oldest first). Host and disk entries
        # share one map — the tier is per entry, not per map, so a
        # promote/demote is a field flip, not a cross-map move.
        self._entries: "collections.OrderedDict[str, _Entry]" = (
            collections.OrderedDict()
        )
        self._host_bytes = 0
        self._disk_bytes = 0
        # Telemetry (per-tier hit/miss/bytes — the /metrics surface).
        self.host_hits = 0
        self.disk_hits = 0
        self.misses = 0
        self.put_total = 0
        self.put_bytes = 0
        self.demoted_to_disk = 0
        self.dropped_capacity = 0
        self.dropped_corrupt = 0

    # -- internals (call under self._lock) ------------------------------

    def _disk_path(self, qid: str, meta: Dict) -> str:
        key = hashlib.sha256(
            f"{qid}:{meta.get('content_hash', '')}".encode()
        ).hexdigest()[:24]
        return os.path.join(self.disk_dir, key)

    def _unlink(self, path: str):
        for suffix in (".bin", ".json"):
            try:
                os.unlink(path + suffix)
            except OSError:
                pass

    def _drop(self, qid: str, ent: _Entry, corrupt: bool = False):
        self._entries.pop(qid, None)
        if ent.payload is not None:
            self._host_bytes -= ent.n_bytes
        else:
            self._disk_bytes -= ent.n_bytes
        if ent.path is not None:
            self._unlink(ent.path)
        if corrupt:
            self.dropped_corrupt += 1

    def _demote_or_drop(self, qid: str, ent: _Entry):
        """Host-tier eviction: demote to disk when configured, else the
        prefix is gone for good (the restore path re-prefills)."""
        assert ent.payload is not None
        self._host_bytes -= ent.n_bytes
        if self.disk_dir is None:
            self._entries.pop(qid, None)
            self.dropped_capacity += 1
            return
        path = self._disk_path(qid, ent.meta)
        try:
            with open(path + ".bin", "wb") as f:
                f.write(ent.payload)
            with open(path + ".json", "w") as f:
                json.dump(ent.meta, f)
        except OSError:
            logger.warning(f"kv tier: disk demotion failed for {qid!r}",
                           exc_info=True)
            self._entries.pop(qid, None)
            self._unlink(path)
            self.dropped_capacity += 1
            return
        ent.payload = None
        ent.path = path
        self._disk_bytes += ent.n_bytes
        self.demoted_to_disk += 1
        # Disk tier has its own LRU bound (oldest disk entries go).
        while self._disk_bytes > self.disk_capacity:
            victim = next(
                (q for q, e in self._entries.items()
                 if e.payload is None and q != qid),
                None,
            )
            if victim is None:
                break
            self._drop(victim, self._entries[victim])
            self.dropped_capacity += 1

    def _trim_host(self, keep: Optional[str] = None):
        while self._host_bytes > self.host_capacity:
            victim = next(
                (q for q, e in self._entries.items()
                 if e.payload is not None and q != keep),
                None,
            )
            if victim is None:
                break
            self._demote_or_drop(victim, self._entries[victim])

    # -- public API ------------------------------------------------------

    def put(self, qid: str, meta: Dict, payload: bytes):
        """Insert/replace a spilled prefix (host tier), LRU-evicting
        (demoting) over capacity. Oversized single entries demote/drop
        immediately rather than wedging the whole tier."""
        with self._lock:
            old = self._entries.get(qid)
            if old is not None:
                self._drop(qid, old)
            ent = _Entry(meta, payload, len(payload))
            self._entries[qid] = ent
            self._host_bytes += ent.n_bytes
            self.put_total += 1
            self.put_bytes += ent.n_bytes
            self._trim_host()

    def get(self, qid: str,
            count: bool = True) -> Optional[Tuple[Dict, bytes, str]]:
        """(meta, payload, tier-it-was-found-in) or None. A disk hit is
        hash-verified and promoted back to the host tier; corruption
        drops the entry (counted) and reads as a miss. ``count=False``
        skips hit/miss accounting (peer chunk serving probes the same
        entry once per chunk — that is one logical hit, not dozens)."""
        with self._lock:
            ent = self._entries.get(qid)
            if ent is None:
                if count:
                    self.misses += 1
                return None
            if ent.payload is not None:
                self._entries.move_to_end(qid)
                if count:
                    self.host_hits += 1
                return ent.meta, ent.payload, "host"
            try:
                with open(ent.path + ".bin", "rb") as f:
                    payload = f.read()
            except OSError:
                self._drop(qid, ent, corrupt=True)
                if count:
                    self.misses += 1
                return None
            if not verify_payload(ent.meta, payload):
                logger.warning(
                    f"kv tier: corrupted disk entry for {qid!r}; dropped"
                )
                self._drop(qid, ent, corrupt=True)
                if count:
                    self.misses += 1
                return None
            # Promote: disk -> host (the entry is hot again).
            self._disk_bytes -= ent.n_bytes
            self._unlink(ent.path)
            ent.path = None
            ent.payload = payload
            self._host_bytes += ent.n_bytes
            self._entries.move_to_end(qid)
            self._trim_host(keep=qid)
            if count:
                self.disk_hits += 1
            return ent.meta, ent.payload, "disk"

    def peek_tier(self, qid: str) -> Optional[str]:
        """Which tier holds qid (no hit accounting, no promotion)."""
        with self._lock:
            ent = self._entries.get(qid)
            return None if ent is None else ent.tier

    def peek_meta(self, qid: str,
                  count_miss: bool = False) -> Optional[Dict]:
        """The entry's meta without touching the payload: metas stay in
        host memory even for disk-demoted entries, so callers can
        validate (prompt prefix, version) BEFORE paying a disk read /
        promotion / hit count — a rejected probe must not churn the
        LRU or overstate tier effectiveness."""
        with self._lock:
            ent = self._entries.get(qid)
            if ent is None:
                if count_miss:
                    self.misses += 1
                return None
            return ent.meta

    def discard(self, qid: str):
        with self._lock:
            ent = self._entries.get(qid)
            if ent is not None:
                self._drop(qid, ent)

    def clear(self):
        """Drop everything — the weight-swap path: spilled KV from the
        old version can never be restored under the new weights."""
        with self._lock:
            for qid in list(self._entries):
                self._drop(qid, self._entries[qid])

    def held(self, cap: int = 8192) -> List[Dict]:
        """Index view for the manager's global prefix index: newest-
        first, bounded (a million-session tail doesn't belong in one
        poll response — the oldest entries are the next to age out
        anyway)."""
        with self._lock:
            out = []
            for qid in reversed(self._entries):
                if len(out) >= cap:
                    break
                ent = self._entries[qid]
                out.append({
                    "qid": qid,
                    "tier": ent.tier,
                    "n_tokens": int(ent.meta.get("n_tokens", 0)),
                    "content_hash": ent.meta.get("content_hash", ""),
                    "version": int(ent.meta.get("version", -1)),
                })
            return out

    def stats(self) -> Dict[str, float]:
        with self._lock:
            n_host = sum(
                1 for e in self._entries.values() if e.payload is not None
            )
            return {
                "host_entries": float(n_host),
                "disk_entries": float(len(self._entries) - n_host),
                "host_bytes": float(self._host_bytes),
                "disk_bytes": float(self._disk_bytes),
                "host_hits": float(self.host_hits),
                "disk_hits": float(self.disk_hits),
                "misses": float(self.misses),
                "put_total": float(self.put_total),
                "put_bytes": float(self.put_bytes),
                "demoted_to_disk": float(self.demoted_to_disk),
                "dropped_capacity": float(self.dropped_capacity),
                "dropped_corrupt": float(self.dropped_corrupt),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
