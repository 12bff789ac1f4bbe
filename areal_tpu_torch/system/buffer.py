"""Asyncio sequence buffer: MFC ordering falls out of key readiness (the
port's copy of ``areal_tpu/system/buffer.py``).

The master stores metadata-only `SequenceSample`s here; each MFC's
coroutine awaits a batch whose input keys are all ready and that the MFC
has not consumed yet. Oldest-first selection, per-sample reuse counting
(a sample is garbage-collected once every MFC consumed it), and the
recover state: ``ignore_ids`` (ids consumed before a crash, skipped once
at admission), the ids consumed this epoch, and the sequence ledger's
snapshot and seeding. Not ported yet: the reference's per-task staleness
windows (ROADMAP Queue A item 4.2).
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Set, Tuple

from areal_tpu_torch.api.data_api import SequenceSample
from areal_tpu_torch.api.dfg import MFCDef
from areal_tpu_torch.base import logging, tracing
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.system.wal import SeqLedger

logger = logging.getLogger("buffer")


@dataclasses.dataclass
class _Slot:
    idx: int
    sample: SequenceSample  # metadata-only on the master
    ready_keys: Set[str]
    consumed_by: Set[str]
    birth: float
    sample_id: str
    birth_ns: int = 0  # monotonic-ns enqueue time for residency tracing


class AsyncIOSequenceBuffer:
    """Key-availability-tracking buffer shared by all MFC coroutines.

    put_batch: insert fresh samples (dataset keys ready).
    amend_batch: merge MFC outputs into stored samples, marking new keys.
    get_batch_for_rpc: await `rpc.n_seqs` samples with rpc.input_keys
    ready and rpc not in consumed_by; marks consumption; GCs exhausted
    slots.
    """

    def __init__(self, rpcs: List[MFCDef], max_size: int = 16384):
        self._rpcs = {r.name: r for r in rpcs}
        self._n_rpcs = len(rpcs)
        self._max_size = max_size
        self._slots: Dict[str, _Slot] = {}  # sample_id -> slot
        self._counter = itertools.count()
        self._cond = asyncio.Condition()
        # Dedup is against RESIDENT ids only: multi-epoch training re-puts
        # the same dataset row ids each epoch, which is legal. Exactly-once
        # across a crash is handled by `ignore_ids` (seeded from recover
        # info): each listed id is skipped once — its pre-crash consumption
        # — then becomes valid again for later epochs.
        self.ignore_ids: Set[str] = set()
        # ids fully consumed since the last epoch boundary (recover dump).
        self.consumed_this_epoch: Set[str] = set()
        # resident duplicates skipped on put (epoch carryover); surfaced
        # in logs so silent data-accounting drift stays visible.
        self.n_dropped_duplicates = 0
        # Exactly-once over rollout sequence ids (wal_seq metadata from
        # the stream dataset): seqs are globally unique, so unlike
        # ignore_ids membership is PERMANENT. Seeded from RecoverInfo at
        # recovery; persisted back at every checkpoint barrier.
        self.seq_ledger = SeqLedger()
        # seq -> resident sample ids not yet fully consumed; a seq is
        # marked in the ledger only once its last id is GC'd.
        self._seq_pending: Dict[str, Set[str]] = {}
        self._id_seq: Dict[str, str] = {}
        # Replayed/redelivered samples dropped at admission because
        # their seq is ledgered or already resident under another id
        # set (prevented duplicates, expected nonzero after recovery).
        self.n_ledger_filtered = 0
        # The invariant DETECTOR, not a dedup count: a sample whose seq
        # was already ledger-marked reaching full consumption again.
        # Expected 0 — the kill-anywhere e2e asserts exactly that.
        self.counters = {"areal:train_samples_duplicated_total": 0}
        # Advanced by the master each step; stamped on buffer.wait spans
        # so the trace report can derive staleness (train step minus the
        # policy version that STARTED the sample's generation).
        self.current_train_step = 0

    def __len__(self):
        return len(self._slots)

    @property
    def size(self) -> int:
        return len(self._slots)

    def resident_ids(self, ids) -> Set[str]:
        """Subset of `ids` currently holding a live slot. Used by the
        step-end cache clear to spare epoch-carryover copies: a consumed
        id that was re-admitted mid-step still needs its tracker entry
        and worker-side data next step."""
        return {i for i in ids if i in self._slots}

    async def put_batch(self, samples: List[SequenceSample]) -> int:
        """Insert samples whose dataset keys are ready. Returns #inserted."""
        async with self._cond:
            # Validate up front so any raise happens before insertion (a
            # mid-loop raise would strand inserted samples without waking
            # consumers). A duplicate id WITHIN one call is always a
            # producer bug and raises; a duplicate of a RESIDENT id is
            # skipped with a warning — multi-epoch training legitimately
            # re-puts row ids whose previous-epoch copy may still await
            # consumption (class contract above), but the skip is counted
            # (`n_dropped_duplicates`) so accounting bugs stay visible.
            new_ids = set()
            ignored_seen = set()
            resident_dups = set()
            ledgered = set()
            for s in samples:
                seqs = s.metadata.get("wal_seq")
                for i in range(s.bs):
                    sample_id = s.ids[i]
                    seq = seqs[i] if seqs else None
                    if seq is not None and (
                        seq in self.seq_ledger
                        or (seq in self._seq_pending
                            and sample_id not in self._seq_pending[seq])
                    ):
                        # WAL replay / pusher redelivery of a sequence
                        # already consumed (ledgered) or resident: drop
                        # at admission — this is exactly-once working,
                        # counted so recovery accounting stays visible.
                        ledgered.add(sample_id)
                        continue
                    if (
                        sample_id in self.ignore_ids
                        and sample_id not in ignored_seen
                    ):
                        # first occurrence consumes the ignore entry
                        ignored_seen.add(sample_id)
                        continue
                    if sample_id in self._slots:
                        resident_dups.add(sample_id)
                        continue
                    if sample_id in new_ids:
                        raise ValueError(
                            f"duplicate sample id {sample_id!r} within one "
                            f"put_batch call"
                        )
                    new_ids.add(sample_id)
            if ledgered:
                self.n_ledger_filtered += len(ledgered)
                logger.info(
                    "seq ledger filtered %d already-delivered sample(s) at "
                    "admission (total %d)",
                    len(ledgered), self.n_ledger_filtered,
                )
            if resident_dups:
                self.n_dropped_duplicates += len(resident_dups)
                logger.warning(
                    "skipping %d resident duplicate id(s) (epoch carryover), "
                    "e.g. %r; total skipped: %d",
                    len(resident_dups), next(iter(resident_dups)),
                    self.n_dropped_duplicates,
                )
            if len(self._slots) + len(new_ids) > self._max_size:
                raise RuntimeError(
                    f"buffer overflow: {len(self._slots)} + {len(new_ids)} > "
                    f"max_size={self._max_size}"
                )
            n = 0
            for s in samples:
                seqs = s.metadata.get("wal_seq")
                for sid in range(s.bs):
                    sub = s._select_indices([sid]) if s.bs > 1 else s
                    sample_id = sub.ids[0]
                    if sample_id in ledgered:
                        continue
                    if sample_id in self.ignore_ids:
                        # consumed before a crash; skip exactly once
                        self.ignore_ids.discard(sample_id)
                        continue
                    if sample_id in resident_dups:
                        continue
                    seq = seqs[sid] if seqs else None
                    if seq is not None:
                        self._seq_pending.setdefault(seq, set()).add(sample_id)
                        self._id_seq[sample_id] = seq
                    self._slots[sample_id] = _Slot(
                        idx=next(self._counter),
                        sample=sub,
                        ready_keys=set(sub.keys),
                        consumed_by=set(),
                        birth=time.monotonic(),
                        sample_id=sample_id,
                        birth_ns=(
                            tracing.now_ns() if tracing.enabled() else 0
                        ),
                    )
                    n += 1
            if n:
                self._cond.notify_all()
            return n

    async def amend_batch(self, sample: SequenceSample):
        """Merge MFC output keys into the stored samples."""
        async with self._cond:
            for sub in sample.unpack():
                slot = self._slots.get(sub.ids[0])
                if slot is None:
                    logger.warning("amend for unknown sample %s", sub.ids[0])
                    continue
                slot.sample.update_(sub)
                slot.ready_keys |= set(sub.keys)
            self._cond.notify_all()

    def _candidates(self, rpc: MFCDef) -> List[_Slot]:
        need = set(rpc.input_keys)
        return sorted(
            (
                s
                for s in self._slots.values()
                if rpc.name not in s.consumed_by and need <= s.ready_keys
            ),
            key=lambda s: s.idx,
        )

    async def get_batch_for_rpc(
        self, rpc: MFCDef
    ) -> Tuple[List[str], SequenceSample]:
        """Await and consume a batch of rpc.n_seqs samples (oldest first)."""
        # The kill window the ledger exists for: batch handed to
        # training, consumed-seq watermark not yet durable.
        faults.maybe_fail("buffer.consume")
        async with self._cond:
            while True:
                cand = self._candidates(rpc)
                if len(cand) >= rpc.n_seqs:
                    chosen = cand[: rpc.n_seqs]
                    for slot in chosen:
                        slot.consumed_by.add(rpc.name)
                        if tracing.enabled() and slot.birth_ns:
                            # Residency span: enqueue -> this consumption,
                            # parented under the rollout's episode span
                            # with the staleness facts as attributes.
                            # Best-effort: malformed metadata must never
                            # take down batch assembly.
                            try:
                                md = slot.sample.metadata
                                ctx = (md.get("trace_ctx") or [None])[0]
                                v0 = (md.get("version_start") or [-1])[0]
                                v1 = (md.get("version_end") or [-1])[0]
                                tracing.record_span(
                                    "buffer.wait", slot.birth_ns,
                                    ctx=tracing.extract(ctx),
                                    rpc=rpc.name,
                                    # One span per CONSUMING MFC (each
                                    # wait is real); sample_id lets the
                                    # staleness report count each sample
                                    # once despite multi-MFC graphs.
                                    sample_id=str(slot.sample_id),
                                    version_start=int(v0 if v0 is not None else -1),
                                    version_end=int(v1 if v1 is not None else -1),
                                    train_step=int(self.current_train_step),
                                )
                            except Exception:
                                logger.debug(
                                    "buffer.wait span failed", exc_info=True
                                )
                    # GC slots every MFC has consumed.
                    for slot in chosen:
                        if len(slot.consumed_by) == self._n_rpcs:
                            del self._slots[slot.sample_id]
                            self.consumed_this_epoch.add(slot.sample_id)
                            self._mark_consumed(slot.sample_id)
                    ids = [s.sample_id for s in chosen]
                    # Restrict to the rpc's input keys: candidates may have
                    # heterogeneous extra keys (amended at different times),
                    # and gather requires a common key set.
                    keys = list(rpc.input_keys) or None
                    batch = SequenceSample.gather(
                        [s.sample.meta() for s in chosen], keys=keys
                    )
                    return ids, batch
                await self._cond.wait()

    def _mark_consumed(self, sample_id: str):
        """A sample left the buffer fully consumed: once the LAST id of
        its sequence goes, the seq is ledger-marked (and from then on
        admission rejects it forever)."""
        seq = self._id_seq.pop(sample_id, None)
        if seq is None:
            return
        if seq in self.seq_ledger:
            # A ledgered seq reached full consumption AGAIN — the
            # exactly-once invariant broke somewhere upstream. Count it
            # loudly; the kill-anywhere e2e asserts this stays 0.
            self.counters["areal:train_samples_duplicated_total"] += 1
            logger.error(
                "sample %s of already-consumed seq %s trained twice",
                sample_id, seq,
            )
        pending = self._seq_pending.get(seq)
        if pending is not None:
            pending.discard(sample_id)
            if not pending:
                del self._seq_pending[seq]
                self.seq_ledger.mark(seq)

    def consumed_seqs(self) -> Dict:
        """Ledger snapshot for the recover record (checkpoint barrier)."""
        return self.seq_ledger.to_dict()

    def seed_consumed_seqs(self, snapshot: Optional[Dict]):
        """Recovery: re-arm the ledger from the last durable snapshot so
        WAL replay and pusher redelivery filter against the same cut the
        engine state was taken at."""
        self.seq_ledger = SeqLedger.from_dict(snapshot)

    async def poll_ready_count(self, rpc: MFCDef) -> int:
        async with self._cond:
            return len(self._candidates(rpc))

    def on_epoch_boundary(self):
        """Epoch rolled over: prior consumptions are no longer 'this epoch'
        for recovery accounting."""
        self.consumed_this_epoch.clear()
