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
