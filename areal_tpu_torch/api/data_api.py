"""Packed variable-length batch contracts (the port's copy of what it
calls from ``areal_tpu/api/data_api.py``).

`SequenceSample` is the exchange format between datasets, interfaces and
engines: every array is packed along a single leading dimension with
explicit per-sample sequence lengths, no padding. Packing into [R, T] rows
happens at the last moment inside the engine. Host-side numpy throughout;
the engine moves rows to its device. ``sample_to_json`` /
``sample_from_json`` are the trajectory wire of the push/pull stream, the
reference's key for key, so a reference rollout worker can feed a port
trainer. The dataset registry (``register_dataset`` / ``make_dataset``
with a ``DatasetUtility``), ``load_hf_tokenizer``, the seeded shuffle and
split of ``load_shuffle_split_dataset`` and the epoch-based
``PackedDataLoader`` are what a rollout worker reads prompts through.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from areal_tpu_torch.api.registry import Registry
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

    def sample_total_len(self, i: int, key: Optional[str] = None) -> int:
        key = key or self._main_key()
        return sum(self.seqlens[key][i])

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

    @classmethod
    def gather(
        cls, samples: Sequence["SequenceSample"], keys: Optional[Sequence[str]] = None
    ) -> "SequenceSample":
        if not samples:
            raise ValueError("cannot gather zero samples")
        keys = set(keys) if keys is not None else set(samples[0].keys)
        for s in samples:
            if not keys.issubset(s.keys):
                raise ValueError(f"sample missing keys {keys - s.keys}")
        ids = datapack.flat2d([s.ids for s in samples])
        if len(set(ids)) != len(ids):
            raise ValueError("duplicate ids in gathered samples")
        data = {}
        seqlens = {}
        dtypes = {}
        trailing = {}
        for k in keys:
            seqlens[k] = datapack.flat2d([s.seqlens[k] for s in samples])
            chunks = [s.data.get(k) for s in samples]
            if all(c is None for c in chunks):
                data[k] = None
            elif any(c is None for c in chunks):
                raise ValueError(f"mixed data/None for key {k!r} in gather")
            else:
                data[k] = np.concatenate(chunks, axis=0)
            dtypes[k] = samples[0].dtypes.get(k)
            trailing[k] = samples[0].trailing_shapes.get(k)
        metadata = {}
        meta_keys = set(itertools.chain.from_iterable(s.metadata for s in samples))
        for mk in meta_keys:
            vals = []
            for s in samples:
                # Samples of mixed streams may lack a stream-specific key:
                # pad with None to keep the per-sample alignment.
                vals.extend(s.metadata[mk] if mk in s.metadata else [None] * s.bs)
            metadata[mk] = vals
        return cls(
            ids=ids,
            keys=keys,
            data=data,
            seqlens=seqlens,
            dtypes=dtypes,
            trailing_shapes=trailing,
            metadata=metadata,
        )

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

    def select_ids(self, ids: Sequence[str]) -> "SequenceSample":
        pos = {i: p for p, i in enumerate(self.ids)}
        return self._select_indices([pos[i] for i in ids])

    def select_keys(self, keys: Sequence[str]) -> "SequenceSample":
        keys = set(keys)
        if not keys.issubset(self.keys):
            raise ValueError(f"missing keys: {keys - self.keys}")
        return SequenceSample(
            ids=list(self.ids),
            keys=keys,
            data={k: self.data.get(k) for k in keys},
            seqlens={k: self.seqlens[k] for k in keys},
            dtypes={k: self.dtypes.get(k) for k in keys},
            trailing_shapes={k: self.trailing_shapes.get(k) for k in keys},
            metadata=dict(self.metadata),
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

    def remap_keys_(self, remap: Dict[str, str]):
        for src, dst in remap.items():
            if src not in self.keys:
                continue
            self.keys.discard(src)
            self.keys.add(dst)
            self.data[dst] = self.data.pop(src)
            self.seqlens[dst] = self.seqlens.pop(src)
            self.dtypes[dst] = self.dtypes.pop(src)
            self.trailing_shapes[dst] = self.trailing_shapes.pop(src)

    def meta(self) -> "SequenceSample":
        """Metadata-only copy (control-plane payloads carry no tensors)."""
        return SequenceSample(
            ids=list(self.ids),
            keys=set(self.keys),
            data={k: None for k in self.keys},
            seqlens={k: [list(sl) for sl in v] for k, v in self.seqlens.items()},
            dtypes=dict(self.dtypes),
            trailing_shapes=dict(self.trailing_shapes),
            metadata=dict(self.metadata),
        )

    def unpack(self) -> List["SequenceSample"]:
        return [self._select_indices([i]) for i in range(self.bs)]


@dataclasses.dataclass
class DatasetUtility:
    """Context handed to dataset constructors."""

    seed: int = 0
    dp_rank: int = 0
    world_size: int = 1
    tokenizer: Any = None


DATASET_REGISTRY = Registry("dataset")


def register_dataset(name: str, factory):
    DATASET_REGISTRY.register(name, factory)


def make_dataset(cfg: "DatasetAbstraction | str", util: DatasetUtility):
    return DATASET_REGISTRY.make(cfg, util=util)


def load_hf_tokenizer(path: str, fast: bool = True):
    import transformers

    tok = transformers.AutoTokenizer.from_pretrained(
        path, use_fast=fast, trust_remote_code=True
    )
    if tok.pad_token_id is None:
        tok.pad_token_id = tok.eos_token_id
    return tok


# ---------------------------------------------------------------------------
# Dataset loading helpers (counterpart of the reference data_api.py:747-792)
# ---------------------------------------------------------------------------

# Task vocabulary for RL datasets; indices are shipped as `task_ids`
# (reference data_api.py:47).
RL_TASKS = ["math", "code", "rlhf", "stem"]


def get_shuffle_indices(seed: int, size: int) -> np.ndarray:
    """Deterministic permutation used for dataset shuffling."""
    rng = np.random.RandomState(seed)
    return rng.permutation(size)


def load_shuffle_split_dataset(
    util: DatasetUtility,
    dataset_path: Optional[str] = None,
    dataset_builder: Optional[Any] = None,
) -> List[Dict[str, Any]]:
    """Load a jsonl dataset (or call a builder), assign missing ids,
    deterministically shuffle by `util.seed`, and return this DP rank's
    near-equal contiguous slice of the shuffled order (round-robin bin
    sizes so every rank gets data; reference data_api.py:754-792)."""
    import json

    if dataset_path is not None:
        if not str(dataset_path).endswith(".jsonl"):
            raise NotImplementedError(f"unknown dataset extension: {dataset_path}")
        with open(dataset_path, "r") as f:
            data = [json.loads(line) for line in f if line.strip()]
    else:
        assert dataset_builder is not None
        data = dataset_builder()

    if any("id" not in d for d in data):
        # Backfill with ids that cannot collide with explicit integer/str ids.
        for idx, d in enumerate(data):
            d.setdefault("id", f"__auto_{idx}")
    seen_ids = set()
    for d in data:
        sid = str(d["id"])
        if sid in seen_ids:
            raise ValueError(f"duplicate dataset id {sid!r}")
        seen_ids.add(sid)

    if len(data) < util.world_size:
        raise ValueError(
            f"dataset size {len(data)} smaller than DP world size {util.world_size}"
        )
    bins = np.zeros(util.world_size, dtype=np.int64)
    for idx in range(len(data)):
        bins[idx % util.world_size] += 1
    bounds = np.pad(np.cumsum(bins), (1, 0))
    shuffle = get_shuffle_indices(util.seed, len(data))
    subset = shuffle[bounds[util.dp_rank] : bounds[util.dp_rank + 1]]
    return [data[i] for i in subset]


class PackedDataLoader:
    """Minimal epoch-based loader over a map-style dataset of
    `SequenceSample`s: deterministic per-epoch shuffling, `SequenceSample.
    gather` collation, and an index cursor (`state_dict`). Restoring a
    cursor comes with recover, which is not ported."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._cursor = 0
        self._order: Optional[np.ndarray] = None

    def _regen_order(self, n: int):
        self._order = (
            get_shuffle_indices(self.seed + self.epoch, n)
            if self.shuffle
            else np.arange(n)
        )

    def _ensure_order(self):
        n = len(self.dataset)
        if self._order is not None and len(self._order) != n:
            # The dataset changed size mid-epoch (curriculum filter): the old
            # permutation is invalid, so start a fresh epoch over the new set
            # rather than slicing past the end / repeating samples.
            self.epoch += 1
            self._cursor = 0
            self._order = None
        if self._order is None:
            self._regen_order(n)

    def __len__(self) -> int:
        return max(1, (len(self.dataset) + self.batch_size - 1) // self.batch_size)

    def next_batch(self) -> Tuple["SequenceSample", bool]:
        """Returns (batch, is_epoch_last). Advances epoch + reshuffles when
        the dataset is exhausted."""
        if len(self.dataset) == 0:
            raise RuntimeError("cannot draw a batch from an empty dataset")
        self._ensure_order()
        n = len(self._order)
        end = min(self._cursor + self.batch_size, n)
        idx = self._order[self._cursor : end]
        samples = [self.dataset[int(i)] for i in idx]
        batch = SequenceSample.gather(samples)
        self._cursor = end
        epoch_last = self._cursor >= n
        if epoch_last:
            self.epoch += 1
            self._cursor = 0
            self._order = None
        return batch, epoch_last

    def state_dict(self) -> Dict[str, Any]:
        return {
            "epoch": self.epoch,
            "cursor": self._cursor,
            "seed": self.seed,
            "size": len(self.dataset),
        }


def sample_to_json(s: "SequenceSample") -> Dict[str, Any]:
    """Lossless JSON encoding of a SequenceSample (token-scale arrays)."""
    return {
        "ids": list(s.ids),
        "keys": sorted(s.keys),
        "data": {
            k: (None if s.data.get(k) is None else np.asarray(s.data[k]).tolist())
            for k in s.keys
        },
        "seqlens": {k: s.seqlens[k] for k in s.keys},
        "dtypes": {
            k: (None if s.dtypes.get(k) is None else np.dtype(s.dtypes[k]).name)
            for k in s.keys
        },
        "trailing_shapes": {
            k: (None if s.trailing_shapes.get(k) is None else list(s.trailing_shapes[k]))
            for k in s.keys
        },
        "metadata": s.metadata,
    }


def sample_from_json(d: Dict[str, Any]) -> "SequenceSample":
    data = {}
    for k in d["keys"]:
        v = d["data"].get(k)
        if v is None:
            data[k] = None
        else:
            dt = d["dtypes"].get(k) or "float32"
            data[k] = np.asarray(v, dtype=np.dtype(dt))
    return SequenceSample(
        ids=list(d["ids"]),
        keys=set(d["keys"]),
        data=data,
        seqlens={k: [list(map(int, sl)) for sl in v] for k, v in d["seqlens"].items()},
        dtypes={
            k: (None if v is None else np.dtype(v))
            for k, v in d.get("dtypes", {}).items()
        },
        trailing_shapes={
            k: (None if v is None else tuple(v))
            for k, v in d.get("trailing_shapes", {}).items()
        },
        metadata=d.get("metadata", {}),
    )
