"""Master-side data-location tracking and transfer planning (the port's
copy of ``areal_tpu/system/redistributor.py``). The master tracks which
model worker owns each (sample_id, key) and, when an MFC dispatches a
batch to its DP workers, derives per-destination pull plans. Transfers
are host-side peer pulls over ZMQ (token-scale arrays; device tensors
never move through this plane), executed by ``system/data_manager.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Set, Tuple


@dataclasses.dataclass
class RedistribStep:
    """One transfer: dst worker pulls `keys` of `ids` from src worker."""

    src: str
    dst: str
    ids: List[str]
    keys: List[str]


class GlobalStorageTracker:
    """(sample_id, key) -> owner worker names."""

    def __init__(self):
        self.storage: Dict[Tuple[str, str], Set[str]] = {}

    def add(self, sample_id: str, key: str, worker: str):
        self.storage.setdefault((sample_id, key), set()).add(worker)

    def add_batch(self, sample_ids: List[str], keys: List[str], worker: str):
        for i in sample_ids:
            for k in keys:
                self.add(i, k, worker)

    def owners(self, sample_id: str, key: str) -> Set[str]:
        return self.storage.get((sample_id, key), set())

    def drop_samples(self, sample_ids: List[str]):
        ids = set(sample_ids)
        self.storage = {
            (i, k): v for (i, k), v in self.storage.items() if i not in ids
        }

    def clear(self):
        self.storage.clear()


class RedistribPlanner:
    """Derive pull plans.

    For each destination worker and each (id, key) it needs but does not
    own, pick one owner (prefer the destination itself, then round-robin
    across owners for load balance) and emit per-(src,dst) merged steps.
    """

    def __init__(self, tracker: GlobalStorageTracker):
        self.tracker = tracker
        self._rr = 0

    def derive_plan(
        self,
        dests: Dict[str, List[str]],  # dst worker -> sample ids it needs
        keys: List[str],
    ) -> List[RedistribStep]:
        steps: Dict[Tuple[str, str], Dict[str, List[str]]] = {}
        for dst, ids in dests.items():
            for sample_id in ids:
                for key in keys:
                    owners = self.tracker.owners(sample_id, key)
                    if not owners:
                        raise ValueError(
                            f"no owner for (id={sample_id}, key={key})"
                        )
                    if dst in owners:
                        continue
                    src = sorted(owners)[self._rr % len(owners)]
                    self._rr += 1
                    bucket = steps.setdefault((src, dst), {})
                    bucket.setdefault(key, []).append(sample_id)
        plan: List[RedistribStep] = []
        for (src, dst), by_key in steps.items():
            # Group keys that share the same id list into one step.
            sig: Dict[Tuple[str, ...], List[str]] = {}
            for key, ids in by_key.items():
                sig.setdefault(tuple(ids), []).append(key)
            for ids, ks in sig.items():
                plan.append(RedistribStep(src=src, dst=dst, ids=list(ids), keys=ks))
        return plan
