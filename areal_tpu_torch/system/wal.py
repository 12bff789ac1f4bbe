"""Rollout-buffer write-ahead log + exactly-once sample ledger (the
port's copy of ``areal_tpu/system/wal.py``; the journal's lines and
schema header are the reference's, so either package replays the
other's WAL).

The durable half of the training data plane. Samples accepted off the
push/pull wire journal here (append-only JSONL, batched fsync) BEFORE
the pusher is acked, so a trainer SIGKILL can never lose an in-flight
rollout: unacked samples are redelivered by the pusher, journaled ones
are replayed from the WAL at restart. `SeqLedger` is the other half of
exactly-once — a compressed permanent-membership set over the rollout
workers' minted sequence ids, persisted atomically with the recover
record so a resume filters both WAL replay and pusher redelivery
against the same cut the engine state was taken at.

Crash safety model:
- append → fsync → ack, in that order. A kill between append and fsync
  may tear the final record; replay drops the torn tail (the sample was
  never acked, so the pusher redelivers it — admission dedup makes the
  redelivery idempotent).
- compaction (checkpoint-barrier truncation) rewrites tmp+fsync+rename,
  so a kill mid-compaction leaves the previous journal intact.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from areal_tpu_torch.base import env_registry, logging
from areal_tpu_torch.base.fault_injection import faults

# The journal's schema header (the reference's wire schema tag).
BUFFER_WAL_V1 = "areal-buffer-wal/v1"

logger = logging.getLogger("wal")


class SeqLedger:
    """Permanent membership set over rollout sequence ids.

    Seqs are minted per pusher as ``{pusher}/{n}`` with n counting from
    0, so membership compresses to a per-pusher contiguous watermark
    plus a sparse set of out-of-order extras above it. Unlike the
    buffer's skip-once ``ignore_ids``, membership here is permanent —
    seqs are globally unique, so "seen once" means "never again".
    """

    def __init__(self):
        # pusher -> highest n with 0..n all marked (-1 = none).
        self._water: Dict[str, int] = {}
        # pusher -> marked n's above the watermark (gaps pending).
        self._extras: Dict[str, Set[int]] = {}

    @staticmethod
    def _parse(seq: str) -> Tuple[str, int]:
        pusher, _, n = seq.rpartition("/")
        return pusher, int(n)

    def mark(self, seq: str):
        pusher, n = self._parse(seq)
        water = self._water.get(pusher, -1)
        if n <= water:
            return
        extras = self._extras.setdefault(pusher, set())
        extras.add(n)
        while water + 1 in extras:
            water += 1
            extras.discard(water)
        self._water[pusher] = water
        if not extras:
            self._extras.pop(pusher, None)

    def __contains__(self, seq: str) -> bool:
        pusher, n = self._parse(seq)
        if n <= self._water.get(pusher, -1):
            return True
        return n in self._extras.get(pusher, ())

    def to_dict(self) -> Dict[str, Any]:
        """JSON/pickle-safe snapshot (RecoverInfo.consumed_seqs)."""
        return {
            "water": dict(self._water),
            "extras": {p: sorted(s) for p, s in self._extras.items()},
        }

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SeqLedger":
        led = cls()
        if d:
            led._water = {p: int(n) for p, n in d.get("water", {}).items()}
            led._extras = {
                p: set(ns) for p, ns in d.get("extras", {}).items() if ns
            }
        return led


class RolloutWAL:
    """Append-only JSONL journal with a schema header and batched fsync.

    Layout: line 1 is ``{"schema": "areal-buffer-wal/v1"}``, every
    further line one accepted-sample record. `append()` buffers; the
    fsync (and any `on_durable` callbacks registered with appended
    records — the deferred pusher acks) lands on `maybe_sync()` once
    AREAL_WAL_FSYNC_MS elapsed, or immediately on `sync()`.
    """

    def __init__(self, path: str, fsync_ms: Optional[float] = None,
                 schema: str = BUFFER_WAL_V1):
        self.path = path
        # Which areal-*-wal/vN header this journal carries: the buffer
        # WAL by default; the gateway's usage ledger reuses the same
        # torn-tail/compaction machinery under its own schema tag.
        self.schema = schema
        if fsync_ms is None:
            fsync_ms = env_registry.get_float("AREAL_WAL_FSYNC_MS")
        self._fsync_s = max(0.0, float(fsync_ms)) / 1000.0
        self._f = None
        self._dirty = False
        self._oldest_dirty: Optional[float] = None
        self._on_durable: List[Callable[[], None]] = []
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    # -- recovery ---------------------------------------------------------

    def replay(self) -> List[Dict[str, Any]]:
        """Read back journaled records, tolerating a torn tail.

        Decodes line by line; the first undecodable line (a record torn
        by a kill mid-append) and everything after it is discarded AND
        truncated off the file, so later appends never interleave with
        torn bytes. Returns the surviving records and leaves the file
        open for append.
        """
        records: List[Dict[str, Any]] = []
        good_end = 0
        torn = False
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
            offset = 0
            first = True
            for line in data.split(b"\n"):
                end = offset + len(line) + 1  # +1 for the newline
                if end > len(data) + 1:
                    break
                # A final line without its newline is a torn append.
                terminated = end <= len(data)
                try:
                    if line:
                        rec = json.loads(line)
                    else:
                        rec = None
                except (ValueError, UnicodeDecodeError):
                    torn = True
                    break
                if not terminated and line:
                    torn = True
                    break
                if rec is not None:
                    if first:
                        if rec.get("schema") != self.schema:
                            raise ValueError(
                                f"WAL {self.path} has unsupported schema "
                                f"{rec.get('schema')!r}"
                            )
                        first = False
                    else:
                        records.append(rec)
                if line:
                    good_end = min(end, len(data))
                offset = end
            if torn or good_end < len(data):
                logger.warning(
                    "WAL %s: dropping torn tail (%d bytes past offset %d)",
                    self.path, len(data) - good_end, good_end,
                )
                with open(self.path, "r+b") as f:
                    f.truncate(good_end)
        self._open_for_append(write_header=not os.path.exists(self.path)
                              or os.path.getsize(self.path) == 0)
        return records

    # -- append path ------------------------------------------------------

    def _open_for_append(self, write_header: bool):
        self._f = open(self.path, "ab")
        if write_header:
            self._f.write(
                json.dumps({"schema": self.schema},
                           separators=(",", ":")).encode() + b"\n"
            )
            self._f.flush()
            os.fsync(self._f.fileno())

    def append(self, record: Dict[str, Any],
               on_durable: Optional[Callable[[], None]] = None):
        """Journal one record; `on_durable` fires after the fsync that
        covers it (the deferred pusher ack)."""
        faults.maybe_fail("buffer.wal_append")
        if self._f is None:
            self._open_for_append(
                write_header=not os.path.exists(self.path)
                or os.path.getsize(self.path) == 0)
        self._f.write(
            json.dumps(record, separators=(",", ":")).encode() + b"\n"
        )
        self._dirty = True
        if self._oldest_dirty is None:
            self._oldest_dirty = time.monotonic()
        if on_durable is not None:
            self._on_durable.append(on_durable)
        self.maybe_sync()

    def maybe_sync(self, force: bool = False) -> bool:
        """Batched fsync: flush once the oldest unsynced record has sat
        for AREAL_WAL_FSYNC_MS (or immediately when forced)."""
        if not self._dirty:
            return False
        if not force and self._oldest_dirty is not None:
            if time.monotonic() - self._oldest_dirty < self._fsync_s:
                return False
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = False
        self._oldest_dirty = None
        callbacks, self._on_durable = self._on_durable, []
        for cb in callbacks:
            try:
                cb()
            except Exception:
                logger.exception("WAL on_durable callback failed")
        return True

    def sync(self) -> bool:
        return self.maybe_sync(force=True)

    # -- checkpoint-barrier truncation ------------------------------------

    def compact(self, keep: Callable[[Dict[str, Any]], bool]) -> int:
        """Atomically rewrite the journal keeping only records where
        ``keep(record)`` — the checkpoint-barrier prefix truncation
        (records whose seqs the durable ledger marked consumed are GC'd).
        Returns the number of records dropped."""
        self.sync()
        if self._f is not None:
            self._f.close()
            self._f = None
        kept: List[bytes] = []
        dropped = 0
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                for i, line in enumerate(f.read().split(b"\n")):
                    if not line or i == 0:
                        continue  # header rewritten below
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail — never carried forward
                    if keep(rec):
                        kept.append(line)
                    else:
                        dropped += 1
        tmp = self.path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(json.dumps({"schema": self.schema},
                               separators=(",", ":")).encode() + b"\n")
            for line in kept:
                f.write(line + b"\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        dir_fd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._open_for_append(write_header=False)
        return dropped

    def close(self):
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None
