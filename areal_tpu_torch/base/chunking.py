"""Content-addressed chunking (the port's copy of the unsharded parts of
``areal_tpu/base/chunking.py``, shared by the KV plane and the weight
plane).

A payload moves over HTTP in fixed-size chunks, each named by its
content hash, so a receiver verifies every piece on its own, resumes a
torn connection mid-chunk and accepts bytes from any holder (trainer
origin or a sibling generation server): the hash, not the peer, is the
authority. Stdlib only.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Tuple

from areal_tpu_torch.base.wire_schemas import WEIGHT_CHUNKS_V1 as CHUNK_SCHEMA

# 8 MiB: per-chunk HTTP overhead is noise for GB-scale payloads, and a
# resumed transfer re-pays at most one chunk.
DEFAULT_CHUNK_BYTES = 8 << 20


def hash_chunk(data) -> str:
    """Content hash of one chunk (sha256, full hex) of any bytes-like
    object, hashed in place."""
    return hashlib.sha256(data).hexdigest()


def chunk_spans(total_bytes: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    """[(offset, length), ...] covering [0, total_bytes). The final chunk
    is short; a zero-byte payload has zero chunks."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be > 0, got {chunk_bytes}")
    return [
        (off, min(chunk_bytes, total_bytes - off))
        for off in range(0, total_bytes, chunk_bytes)
    ]


def build_chunk_index(bin_path: str, chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Dict:
    """Stream the bin once and return its chunk index
    ``{schema, chunk_bytes, total_bytes, n_chunks, hashes}``. Raises
    OSError if the bin vanishes or shrinks mid-read (the dump's GC: the
    caller retries against the refreshed manifest)."""
    total = os.path.getsize(bin_path)
    hashes: List[str] = []
    with open(bin_path, "rb") as f:
        for _, length in chunk_spans(total, chunk_bytes):
            data = f.read(length)
            if len(data) != length:
                raise OSError(f"short read on {bin_path}: wanted {length}, got {len(data)} "
                              f"(torn write or concurrent GC)")
            hashes.append(hash_chunk(data))
    return {"schema": CHUNK_SCHEMA, "chunk_bytes": int(chunk_bytes),
            "total_bytes": int(total), "n_chunks": len(hashes), "hashes": hashes}


class StreamChunker:
    """Hash a byte stream incrementally into the index
    ``build_chunk_index`` gives for the same bytes. The dump feeds each
    leaf through it while writing the bin and publishes the index as a
    sidecar, so the plane's origin never re-reads a bin it just wrote."""

    def __init__(self, chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        if chunk_bytes <= 0:
            raise ValueError(f"chunk_bytes must be > 0, got {chunk_bytes}")
        self.chunk_bytes = int(chunk_bytes)
        self.total = 0
        self.hashes: List[str] = []
        self._h = hashlib.sha256()
        self._fill = 0  # bytes fed into the open chunk

    def update(self, data) -> None:
        mv = memoryview(data).cast("B")
        while len(mv):
            take = min(len(mv), self.chunk_bytes - self._fill)
            self._h.update(mv[:take])
            self._fill += take
            self.total += take
            if self._fill == self.chunk_bytes:
                self.hashes.append(self._h.hexdigest())
                self._h = hashlib.sha256()
                self._fill = 0
            mv = mv[take:]

    def finish(self) -> Dict:
        if self._fill:
            self.hashes.append(self._h.hexdigest())
            self._h = hashlib.sha256()
            self._fill = 0
        return {"schema": CHUNK_SCHEMA, "chunk_bytes": self.chunk_bytes,
                "total_bytes": int(self.total), "n_chunks": len(self.hashes),
                "hashes": list(self.hashes)}


def verify_chunk(data, expected_hash: str) -> bool:
    return hash_chunk(data) == expected_hash
