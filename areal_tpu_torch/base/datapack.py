"""Sequence packing algorithms (the port's copy of what it calls from
``areal_tpu/base/datapack.py``): first-fit-decreasing bin packing for
token-budget micro-batch splitting and for packing sequences into rows.
Pure numpy, host side."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def flat2d(lists: Sequence[Sequence]) -> List:
    return [x for sub in lists for x in sub]


def ffd_allocate(
    lengths: Sequence[int],
    capacity: int,
    min_groups: int = 1,
) -> List[List[int]]:
    """First-fit-decreasing bin packing.

    Partition items with the given `lengths` into bins of at most `capacity`
    total length (a single item longer than capacity gets its own bin),
    producing at least `min_groups` bins. Returns a list of index groups.
    """
    lengths = np.asarray(lengths)
    order = np.argsort(-lengths, kind="stable")
    groups: List[List[int]] = [[] for _ in range(min_groups)]
    sums = [0] * min_groups
    for idx in order:
        idx = int(idx)
        l = int(lengths[idx])
        # Least-loaded bin with room (keeps the min_groups bins balanced);
        # empty bins always accept, so oversized items get their own bin.
        candidates = [g for g in range(len(groups)) if sums[g] + l <= capacity or not groups[g]]
        if candidates:
            g = min(candidates, key=lambda g: sums[g])
            groups[g].append(idx)
            sums[g] += l
        else:
            groups.append([idx])
            sums.append(l)
    # Drop empty bins (possible when min_groups > n items).
    return [g for g in groups if g]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_shape(
    lengths: Sequence[int],
    row_len_multiple: int = 128,
    n_rows_multiple: int = 1,
    max_row_len: int = None,
) -> tuple:
    """(n_rows, row_len) that `models.packing.pack_sequences` allocates
    for these sequence lengths, computed without packing. Where the pack
    raises (a sequence longer than max_row_len) the rows widen to fit."""
    lengths = [int(l) for l in lengths]
    if not lengths:
        raise ValueError("cannot compute pack shape of zero sequences")
    longest = max(lengths)
    row_len = _round_up(max(longest, row_len_multiple), row_len_multiple)
    if max_row_len is not None:
        row_len = min(row_len, _round_up(max_row_len, row_len_multiple))
        row_len = max(row_len, _round_up(longest, row_len_multiple))
    groups = ffd_allocate(lengths, capacity=row_len, min_groups=1)
    n_rows = _round_up(len(groups), n_rows_multiple)
    return n_rows, row_len


def packing_density(
    lengths: Sequence[int],
    row_len_multiple: int = 128,
    n_rows_multiple: int = 1,
    max_row_len: int = None,
) -> float:
    """Real tokens over the [R, T] cells of the FFD pack of `lengths`
    (the `perf/packing_efficiency` series)."""
    n_rows, row_len = pack_shape(lengths, row_len_multiple, n_rows_multiple, max_row_len)
    return float(sum(int(l) for l in lengths)) / float(n_rows * row_len)


def balanced_partition(nums: Sequence[int], k: int) -> List[List[int]]:
    """Split into k groups balanced by sum, order-free (greedy LPT)."""
    order = np.argsort(-np.asarray(nums), kind="stable")
    groups: List[List[int]] = [[] for _ in range(k)]
    sums = np.zeros(k)
    for idx in order:
        g = int(np.argmin(sums))
        groups[g].append(int(idx))
        sums[g] += nums[int(idx)]
    return [sorted(g) for g in groups]
