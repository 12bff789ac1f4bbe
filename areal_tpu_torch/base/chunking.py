"""Content-addressed chunking (the port's copy of the parts of
``areal_tpu/base/chunking.py`` the KV plane uses).

A payload moves over HTTP in fixed-size chunks, each named by its
content hash, so a receiver verifies every piece on its own, resumes a
torn connection mid-chunk and accepts bytes from any holder: the hash,
not the peer, is the authority. Stdlib only.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple


def hash_chunk(data) -> str:
    """Content hash of one chunk (sha256, full hex)."""
    return hashlib.sha256(bytes(data)).hexdigest()


def chunk_spans(total_bytes: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    """[(offset, length), ...] covering [0, total_bytes). The final chunk
    is short; a zero-byte payload has zero chunks."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be > 0, got {chunk_bytes}")
    return [
        (off, min(chunk_bytes, total_bytes - off))
        for off in range(0, total_bytes, chunk_bytes)
    ]


def verify_chunk(data, expected_hash: str) -> bool:
    return hash_chunk(data) == expected_hash
