"""Stream dataset: makes async rollouts look like a dataset to the trainer
(the port's copy of ``areal_tpu/system/stream_dataset.py``): a background
thread pulls JSON trajectories from the rollout workers' push stream into
a queue; the model worker's "fetch" handler drains it into
`SequenceSample` batches.

With AREAL_WAL armed (the default) every accepted trajectory journals to
an append-only WAL before its pusher is acked, and a restart replays the
journal — so trajectories that were in flight when the trainer died
survive the kill. A per-seq membership set drops redelivered duplicates
at admission (acking them immediately: they are already durable here).
At each checkpoint barrier the model worker compacts the journal
(``compact_wal``) against the ledger of the previous recover record.
"""

from __future__ import annotations

import os
import queue
import threading
from collections import deque
from typing import List, Optional

from areal_tpu_torch.api import data_api
from areal_tpu_torch.base import constants, env_registry, logging, tracing
from areal_tpu_torch.system.push_pull_stream import NameResolvingZmqPuller
from areal_tpu_torch.system.wal import RolloutWAL, SeqLedger

logger = logging.getLogger("stream_dataset")


class PullerStreamDataset:
    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        puller_index: int = 0,
        max_queue_size: int = 4096,
        pull_timeout_ms: int = 100,
    ):
        self.puller = NameResolvingZmqPuller(
            experiment_name, trial_name, puller_index=puller_index
        )
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue_size)
        self._stop = threading.Event()
        self._pull_timeout_ms = pull_timeout_ms
        self.counters = {
            "areal:train_wal_replayed_total": 0,
            "areal:train_wal_dup_dropped_total": 0,
        }
        # Journal of accepted trajectories; replayed (into a side deque
        # poll_batch serves first — the main queue's maxsize could
        # deadlock a large replay before the pull thread starts) and
        # then kept open for append. _seen guards re-journaling a seq
        # the journal already holds (pusher redelivery races).
        self._wal: Optional[RolloutWAL] = None
        self._wal_lock = threading.Lock()
        self._seen: set = set()
        self._replayed: deque = deque()
        # Samples held back because their ids collided with an earlier
        # sample in the same poll_batch drain (epoch carryover: a tiny
        # dataset re-issues row ids faster than the trainer drains the
        # queue). gather() refuses duplicate ids, so collisions are
        # deferred to the next batch rather than poisoning this one.
        self._held: deque = deque()
        if env_registry.get_bool("AREAL_WAL"):
            path = os.path.join(
                constants.get_recover_path(experiment_name, trial_name),
                "wal", f"puller{puller_index}.wal",
            )
            self._wal = RolloutWAL(path)
            for rec in self._wal.replay():
                seq = rec.get("seq")
                if seq is None or seq in self._seen:
                    continue
                try:
                    sample = data_api.sample_from_json(rec["data"])
                except Exception:
                    logger.exception("bad WAL trajectory dropped on replay")
                    continue
                self._seen.add(seq)
                sample.metadata["wal_seq"] = [seq] * sample.bs
                self._replayed.append(sample)
                self.counters["areal:train_wal_replayed_total"] += 1
            if self._replayed:
                logger.info(
                    "WAL replay: %d in-flight trajectories survived restart",
                    len(self._replayed),
                )
        # Set before the pull thread starts: it may take a trajectory at once.
        self.n_pulled = 0
        self._thread = threading.Thread(target=self._pull_worker, daemon=True)
        self._thread.start()

    def _pull_worker(self):
        while not self._stop.is_set():
            try:
                d = self.puller.pull(timeout_ms=self._pull_timeout_ms)
            except TimeoutError:
                # Idle: flush the batched WAL fsync so deferred acks
                # don't sit past the fsync window with no traffic.
                if self._wal is not None:
                    with self._wal_lock:
                        self._wal.maybe_sync(force=True)
                continue
            except Exception:
                logger.exception("puller error")
                continue
            seq = self.puller.last_seq
            ack_addr = self.puller.last_ack_addr
            if seq is not None and seq in self._seen:
                # Redelivered duplicate: the journal already holds this
                # seq durably, so ack right away and never re-admit —
                # each drop here is a prevented duplicate.
                self.counters["areal:train_wal_dup_dropped_total"] += 1
                if ack_addr:
                    self.puller.ack(seq, ack_addr)
                continue
            try:
                sample = data_api.sample_from_json(d)
            except Exception:
                logger.exception("bad trajectory json dropped")
                continue
            if self._wal is not None and seq is not None:
                self._seen.add(seq)
                sample.metadata["wal_seq"] = [seq] * sample.bs
                # Journal before ack; the ack itself is deferred to the
                # fsync that covers this record — acking earlier would
                # let a kill in between lose an acked sample.
                on_durable = None
                if ack_addr:
                    on_durable = (
                        lambda s=seq, a=ack_addr: self.puller.ack(s, a)
                    )
                with self._wal_lock:
                    self._wal.append({"seq": seq, "data": d},
                                     on_durable=on_durable)
            self.n_pulled += 1
            # Queue residency is traced per sample: span from arrival on
            # this host to the fetch that drains it, parented under the
            # rollout's episode span (trace ctx rides the sample
            # metadata; 0 when tracing is off — never allocated).
            recv_ns = tracing.now_ns() if tracing.enabled() else 0
            # Block (with stop checks) rather than drop: the manager already
            # counted this trajectory as submitted, so dropping it would
            # desync the staleness accounting. Blocking applies backpressure
            # through the ZMQ high-water mark to the rollout workers.
            while not self._stop.is_set():
                try:
                    self._queue.put((recv_ns, sample), timeout=1)
                    break
                except queue.Full:
                    continue

    def qsize(self) -> int:
        return self._queue.qsize() + len(self._replayed) + len(self._held)

    def poll_batch(self, max_samples: int = 64) -> Optional["data_api.SequenceSample"]:
        """Drain up to max_samples pulled trajectories into one batch
        (held-back collisions first, then WAL-replayed survivors).

        A sample whose ids repeat an earlier sample in the SAME drain is
        a later-epoch episode of the same dataset row; it is deferred to
        the next batch (gather refuses duplicate ids, and one fetch must
        never deliver two copies of an id anyway — the master's buffer
        and storage tracker key on ids)."""
        samples: List[data_api.SequenceSample] = []
        batch_ids: set = set()
        deferred: List[data_api.SequenceSample] = []

        def take(sample: "data_api.SequenceSample"):
            if batch_ids.intersection(sample.ids):
                deferred.append(sample)
                return
            batch_ids.update(sample.ids)
            samples.append(sample)

        while len(samples) < max_samples and self._held:
            take(self._held.popleft())
        while len(samples) < max_samples and self._replayed:
            take(self._replayed.popleft())
        while len(samples) < max_samples:
            try:
                recv_ns, sample = self._queue.get_nowait()
            except queue.Empty:
                break
            if tracing.enabled() and recv_ns:
                ctx = (sample.metadata.get("trace_ctx") or [None])[0]
                tracing.record_span(
                    "stream.recv", recv_ns,
                    ctx=tracing.extract(ctx),
                    qid=str(sample.ids[0]) if sample.ids else "",
                )
            take(sample)
        self._held.extend(deferred)
        if not samples:
            return None
        return data_api.SequenceSample.gather(samples)

    def compact_wal(self, consumed: SeqLedger) -> int:
        """Checkpoint-barrier truncation: drop journaled records whose
        seqs the durable ledger marked consumed (no future resume needs
        them). Returns the number dropped."""
        if self._wal is None:
            return 0
        with self._wal_lock:
            return self._wal.compact(lambda rec: rec.get("seq") not in consumed)

    def __len__(self):
        # Unknown a priori; reference returns the configured dataset size.
        return self.qsize()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=3)
        if self._wal is not None:
            with self._wal_lock:
                self._wal.close()
        self.puller.close()
