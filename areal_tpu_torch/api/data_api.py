"""Packed variable-length batch contracts (the port's copy of what it
calls from ``areal_tpu/api/data_api.py``).

`SequenceSample` is the exchange format between datasets, interfaces and
engines: every array is packed along a single leading dimension with
explicit per-sample sequence lengths, no padding. Packing into [R, T] rows
happens at the last moment inside the engine. Host-side numpy throughout;
the engine moves rows to its device. The dataset registry, loaders and the
JSON wire format of the reference are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from areal_tpu_torch.base import datapack

@dataclasses.dataclass
class MicroBatchSpec:
    """How to split a batch into micro-batches.

    n_mbs: minimum number of micro-batches (DP ranks may sync to the max).
    max_tokens_per_mb: token budget per micro-batch (None = unbounded).
    """

    n_mbs: int = 1
    max_tokens_per_mb: Optional[int] = None

    @classmethod
    def new(cls, other: "MicroBatchSpec", **kwargs) -> "MicroBatchSpec":
        d = dataclasses.asdict(other)
        d.update(kwargs)
        return cls(**d)


@dataclasses.dataclass
class SequenceSample:
    """A batch of variable-length packed sequences.

    ids: unique sample identifiers (hashable strings).
    keys: the set of data keys present.
    data: key -> packed array of shape (sum(seqlens[key]), *trailing) or
        None for metadata-only (control-plane) samples.
    seqlens: key -> per-sample list of sequence lengths. A sample may hold
        several sequences under one key (e.g. grouped GRPO responses), hence
        the inner list.
    dtypes / trailing_shapes: per-key array metadata, kept even when data is
        None so receivers can preallocate.
    metadata: free-form per-batch lists (rewards, versions, ...), each value
        a list aligned with ids.
    """

    ids: List[str]
    keys: Set[str]
    data: Dict[str, Optional[np.ndarray]]
    seqlens: Dict[str, List[List[int]]]
    dtypes: Dict[str, Optional[np.dtype]] = dataclasses.field(default_factory=dict)
    trailing_shapes: Dict[str, Optional[Tuple[int, ...]]] = dataclasses.field(
        default_factory=dict
    )
    metadata: Dict[str, List[Any]] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    def __post_init__(self):
        self.keys = set(self.keys)
        for k in self.keys:
            if k not in self.seqlens:
                raise ValueError(f"missing seqlens for key {k!r}")
            if len(self.seqlens[k]) != len(self.ids):
                raise ValueError(
                    f"seqlens[{k!r}] has {len(self.seqlens[k])} entries for "
                    f"{len(self.ids)} ids"
                )
            self.seqlens[k] = [[int(x) for x in sl] for sl in self.seqlens[k]]
            d = self.data.get(k)
            if d is not None:
                expected = sum(sum(sl) for sl in self.seqlens[k])
                if d.shape[0] != expected:
                    raise ValueError(
                        f"data[{k!r}] leading dim {d.shape[0]} != total seqlen {expected}"
                    )
                self.dtypes.setdefault(k, d.dtype)
                self.trailing_shapes.setdefault(k, tuple(d.shape[1:]))
            else:
                self.dtypes.setdefault(k, None)
                self.trailing_shapes.setdefault(k, None)
        for mk, mv in self.metadata.items():
            if not isinstance(mv, list) or len(mv) != len(self.ids):
                raise ValueError(
                    f"metadata[{mk!r}] must be a list aligned with ids "
                    f"({len(self.ids)}), got {mv!r}"
                )

    @classmethod
    def from_default(
        cls,
        ids: Sequence[str],
        seqlens: Sequence[int],
        data: Dict[str, np.ndarray],
        metadata: Optional[Dict[str, List[Any]]] = None,
    ) -> "SequenceSample":
        """All keys share one sequence per sample with the same lengths,
        except scalar-per-sequence keys (detected by data length == n_samples
        while total tokens differ)."""
        ids = [str(i) for i in ids]
        seqlens = [int(x) for x in seqlens]
        total = sum(seqlens)
        key_seqlens = {}
        for k, v in data.items():
            if v is None:
                key_seqlens[k] = [[l] for l in seqlens]
            elif v.shape[0] == total:
                key_seqlens[k] = [[l] for l in seqlens]
            elif v.shape[0] == len(ids):
                key_seqlens[k] = [[1] for _ in ids]
            else:
                raise ValueError(
                    f"cannot infer seqlens for key {k!r}: leading dim "
                    f"{v.shape[0]} is neither total tokens {total} nor batch {len(ids)}"
                )
        return cls(
            ids=ids,
            keys=set(data.keys()),
            data=dict(data),
            seqlens=key_seqlens,
            metadata=metadata or {},
        )

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    @property
    def bs(self) -> int:
        return len(self.ids)

    def _main_key(self) -> str:
        for k in ("packed_input_ids", "packed_prompts", "seq"):
            if k in self.keys:
                return k
        return sorted(self.keys)[0]

    def total_seqlen(self, key: Optional[str] = None) -> int:
        key = key or self._main_key()
        return sum(sum(sl) for sl in self.seqlens[key])

    def seqlens_of(self, key: Optional[str] = None) -> List[int]:
        """Per-sample total lengths under `key` (the packing weight)."""
        key = key or self._main_key()
        return [sum(sl) for sl in self.seqlens[key]]

    # ------------------------------------------------------------------
    # Gather / split
    # ------------------------------------------------------------------

    def _select_indices(self, indices: Sequence[int]) -> "SequenceSample":
        """New sample containing the given sample positions, in that order."""
        indices = list(indices)
        data = {}
        seqlens = {}
        for k in self.keys:
            seqlens[k] = [self.seqlens[k][i] for i in indices]
            d = self.data.get(k)
            if d is None:
                data[k] = None
                continue
            # Per-sample offsets into the packed dim.
            lens = [sum(sl) for sl in self.seqlens[k]]
            offsets = np.concatenate([[0], np.cumsum(lens)])
            data[k] = np.concatenate(
                [d[offsets[i] : offsets[i] + lens[i]] for i in indices], axis=0
            ) if indices else d[:0]
        return SequenceSample(
            ids=[self.ids[i] for i in indices],
            keys=set(self.keys),
            data=data,
            seqlens=seqlens,
            dtypes=dict(self.dtypes),
            trailing_shapes=dict(self.trailing_shapes),
            metadata={k: [v[i] for i in indices] for k, v in self.metadata.items()},
        )

    def split(
        self, spec: MicroBatchSpec
    ) -> Tuple[List["SequenceSample"], List[int], List[int]]:
        """Token-budget micro-batch split (FFD bin packing).

        Returns (micro_batches, forward_indices, backward_indices):
        `forward_indices[j]` is the original position of the j-th sample in
        the concatenated micro-batch order; `backward_indices` inverts it,
        for `reorder_output`.
        """
        lens = self.seqlens_of()
        cap = spec.max_tokens_per_mb or int(np.sum(lens)) + 1
        groups = datapack.ffd_allocate(lens, capacity=cap, min_groups=spec.n_mbs)
        groups = [sorted(g) for g in groups]
        forward_indices = datapack.flat2d(groups)
        backward_indices = np.argsort(forward_indices).tolist()
        return ([self._select_indices(g) for g in groups], forward_indices,
                backward_indices)

    @staticmethod
    def reorder_output(
        x: np.ndarray,
        mb_seqlens: Sequence[Sequence[int]],
        backward_indices: Sequence[int],
    ) -> np.ndarray:
        """Un-permute packed outputs concatenated over micro-batches.

        mb_seqlens: per-micro-batch per-sample total lengths, in mb order.
        """
        flat_lens = datapack.flat2d(mb_seqlens)
        offsets = np.concatenate([[0], np.cumsum(flat_lens)])
        chunks = [
            x[offsets[i] : offsets[i + 1]] for i in range(len(flat_lens))
        ]
        return np.concatenate([chunks[i] for i in backward_indices], axis=0)

    # ------------------------------------------------------------------
    # Mutation
    # ------------------------------------------------------------------

    def update_(self, other: "SequenceSample"):
        """Merge `other`'s keys into self (ids must match)."""
        if other.ids != self.ids:
            raise ValueError("update_ requires identical id order")
        for k in other.keys:
            self.keys.add(k)
            self.data[k] = other.data.get(k)
            self.seqlens[k] = other.seqlens[k]
            self.dtypes[k] = other.dtypes.get(k)
            self.trailing_shapes[k] = other.trailing_shapes.get(k)
        self.metadata.update(other.metadata)
