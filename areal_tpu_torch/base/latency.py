"""Fixed-bucket latency histograms for serving SLO telemetry (the
port's copy of ``areal_tpu/base/latency.py``; the bucket edges and the
sparse ``i:count`` encoding are the reference's, so a fleet manager can
merge counts from reference and port servers alike).

The serving engine records per-request TTFT (time to first token) and
per-token inter-token latency into log-spaced fixed buckets; the
generation server exports the raw bucket counts on ``/metrics`` and a
manager merges them fleet-wide by summing counts (averaging per-server
percentiles would be wrong; summed buckets give the true fleet
distribution).
"""

from __future__ import annotations

import threading
from typing import List

# Upper edges in milliseconds, log2-spaced: 0.5 ms .. ~131 s, plus an
# implicit overflow bucket. Wide enough that an unbounded-backlog p99
# (the no-backpressure failure mode the openloop bench demonstrates)
# still lands on a finite edge.
BUCKET_EDGES_MS: tuple = tuple(2.0 ** i for i in range(-1, 18))
N_BUCKETS = len(BUCKET_EDGES_MS) + 1  # + overflow


def bucket_index(value_ms: float) -> int:
    lo, hi = 0, len(BUCKET_EDGES_MS)
    while lo < hi:
        mid = (lo + hi) // 2
        if value_ms <= BUCKET_EDGES_MS[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def percentile_from_counts(counts: List[int], p: float) -> float:
    """p in [0, 100] -> the upper bucket edge covering that quantile
    (conservative: reported latency is never below the true value by
    more than one bucket width). 0.0 when the histogram is empty."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = max(1, int(-(-total * p // 100)))  # ceil(total * p / 100)
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target:
            return float(
                BUCKET_EDGES_MS[i]
                if i < len(BUCKET_EDGES_MS)
                else 2 * BUCKET_EDGES_MS[-1]
            )
    return float(2 * BUCKET_EDGES_MS[-1])


def encode_counts(counts: List[int]) -> str:
    """Sparse ``i:count`` comma string ('' when empty) — one /metrics
    line, whitespace-free so ``line.split()[-1]`` parsing survives."""
    return ",".join(f"{i}:{c}" for i, c in enumerate(counts) if c)


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram (adds from the engine loop,
    reads from HTTP handler threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * N_BUCKETS

    def add(self, value_ms: float, count: int = 1) -> None:
        if count <= 0:
            return
        i = bucket_index(max(0.0, float(value_ms)))
        with self._lock:
            self._counts[i] += count

    def counts(self, reset: bool = False) -> List[int]:
        with self._lock:
            out = list(self._counts)
            if reset:
                self._counts = [0] * N_BUCKETS
        return out

    def total(self) -> int:
        with self._lock:
            return sum(self._counts)

    def percentile(self, p: float) -> float:
        return percentile_from_counts(self.counts(), p)
