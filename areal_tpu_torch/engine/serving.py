"""Continuous-batching generation engine over a paged KV pool
(counterpart of ``areal_tpu/engine/serving.py``, its core).

A pool of B sequence slots whose KV lives in a shared paged pool
(``engine/paged.py``), a multi-step decode block, batched prefill,
chunked prefill for long prompts, per-slot sampling parameters, page
growth with pool-pressure preemption, and interruption BETWEEN blocks,
which makes weight updates cheap: the loop stops at a block boundary,
partial outputs return to the clients (who resubmit with the
concatenated prefix), and the new params go live.

The engine loop runs on a background thread pinned to the engine's
device and stream. Per-slot control state stays on the device between
blocks; each decode block costs exactly ONE device fetch (the packed
result), and each admission round one more (its first tokens).

Eager PyTorch compiles nothing per shape, so, unlike the reference,
prefill rows are not padded to power-of-two batches or bucketed
lengths: a prefill batch is padded only to a whole number of pages.

The surface a generation server calls is the reference's: request
priority classes with starvation aging, the qid-keyed prefix cache
(``prefix_cache_tokens``: a finished request parks its pages under its
qid and a resubmission extending them prefills only the delta),
token-budget admission (``prefill_token_budget``), the prefill/decode
interleave (``decode_blocks_per_admit``), TTFT / ITL histograms, the
queue counters and ``metrics()`` with the reference's key set (the
features the port lacks read their disabled values), ``warm`` and the
stale-update checks behind ``/update_weights_from_disk``.

The KV plane of disaggregated serving is the reference's too:
``export_kv_handoff`` / ``import_kv_handoff`` move a parked prefix as an
``areal-kv-handoff/v1`` blob (engine/kv_handoff.py) between a prefill
and a decode engine; with ``kv_tier_bytes`` an evicted prefix spills to
a host (+ disk) tier (engine/kv_tier.py) on a spill thread instead of
being lost, and ``restore_from_tier`` brings it back for a continuation.
Work on loop-owned state from other threads goes through the loop door
(``_run_on_loop``). The weight plane's ``cutover_params`` stages a
prefetched tree and blocks until the loop has swapped to it.

N-gram speculative decoding (``speculative_draft_len``,
engine/spec_decode.py) and int8 decode weights (``decode_weight_dtype``,
ops/wquant.py, rebuilt on every weight swap) are the reference's options;
prefill always runs the unquantized params.

Not ported yet: mesh / tensor parallelism (with it the shard-leaf
cutover) and the env knobs (the tier, speculation and decode weights are
configured by argument only: ``AREAL_SPEC_DRAFT``, ``AREAL_SPEC_WINDOW``
and ``AREAL_DECODE_WEIGHT_DTYPE`` are not read).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch import resolve_device, torch_dtype
from areal_tpu_torch.base import tracing
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.base.latency import LatencyHistogram, percentile_from_counts
from areal_tpu_torch.engine import kv_handoff as kvh
from areal_tpu_torch.engine.kv_tier import KVTierStore
from areal_tpu_torch.engine.paged import (
    TRASH_PAGE,
    PageAllocator,
    _chunk_prefill_body,
    gather_kv_tokens,
    paged_decode_block,
    pages_needed,
    quantize_kv,
    scatter_prefill,
    scatter_prefill_int8,
)
from areal_tpu_torch.engine.spec_decode import paged_spec_decode_block, set_history
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import forward, lm_head
from areal_tpu_torch.ops.sampling import select_tier, warp_sample
from areal_tpu_torch.ops.wquant import maybe_quantize_decode_weights

logger = logging.getLogger("areal_tpu_torch.serving")


@dataclasses.dataclass
class GenRequest:
    qid: str
    input_ids: List[int]
    max_new_tokens: int = 256
    min_new_tokens: int = 0
    greedy: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    stop_token_ids: Tuple[int, ...] = ()
    # Admission class, lower admits first: 0 = session continuation /
    # interrupted re-prefill, 1 = fresh request. The engine also promotes
    # a request whose qid holds a parked prefix to class 0.
    priority: int = 1
    # resolved by the engine loop:
    done_cb: Optional[Callable[["GenResult"], None]] = None
    submit_time: float = 0.0
    # Admission rounds this request sat in the backlog while others
    # admitted ahead of it (starvation aging).
    starved_rounds: int = 0


@dataclasses.dataclass
class GenResult:
    qid: str
    output_ids: List[int]
    output_logprobs: List[float]
    no_eos: bool  # True if stopped for a non-EOS reason (budget/interrupt)
    interrupted: bool
    version_start: int
    version_end: int
    latency: float = 0.0
    # Set iff the engine's serve loop died before this request finished:
    # outputs are empty/partial and the engine accepts no further submits.
    error: Optional[str] = None


def _round_up(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


def _to_device(tree, device, like=None):
    """A param tree (tensors or numpy arrays; an int8 decode tree's
    (data, scale) pairs too) on ``device``; each leaf keeps its dtype, or
    takes the matching leaf's dtype in ``like``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, like[k] if like is not None else None)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device, like[j] if like is not None else None)
                     for j, v in enumerate(tree))
    t = torch.as_tensor(tree)
    return t.to(device=device, dtype=like.dtype if like is not None else t.dtype)


def _prefill_batch(params, cfg: TransformerConfig, input_ids, lengths):
    """Batched prefill. input_ids: [n, pad] right-padded; lengths: [n].
    Returns (last_logits [n, V] float32, k_pref, v_pref each
    [L, n, pad, Hkv, hd]); the head runs on each row's last token only."""
    n, pad = input_ids.shape
    pos = torch.arange(pad, dtype=torch.int32, device=input_ids.device)[None, :]
    seg = (pos < lengths[:, None]).to(torch.int32)
    positions = torch.where(seg > 0, pos, 0).to(torch.int32)
    hidden, (k, v) = forward(params, cfg, input_ids, seg, positions,
                             output="hidden", return_kv=True,
                             device=input_ids.device)
    last = hidden[torch.arange(n, device=hidden.device),
                  torch.clamp(lengths - 1, min=0).long()]
    return lm_head(params, cfg, last, torch_dtype(cfg.compute_dtype)), k, v


class ServingEngine:
    """Slot-pool continuous-batching engine driven by a background thread.

    Engine-loop state (the backlog, prefix cache, page allocator, pools,
    device control state, page table and slot bookkeeping) is owned by
    the loop thread and has no locks; other threads read the loop's
    snapshots (``_backlog_len``, ``_kv_pages_free``) and host counters."""

    # Admission rounds a class-1 request may be passed over before it is
    # promoted to class 0, so a sustained continuation stream cannot
    # starve fresh requests.
    STARVATION_ROUNDS = 16

    def __init__(
        self,
        cfg: TransformerConfig,
        params,
        max_batch_size: int = 8,
        max_seq_len: int = 2048,
        decode_block_steps: int = 16,
        eos_token_id: Optional[int] = None,
        seed: int = 1,
        page_size: int = 128,
        kv_pool_tokens: Optional[int] = None,
        prefill_max_batch: int = 8,
        prefill_chunk: Optional[int] = None,
        chunked_prefill_per_lap: int = 2,
        prefix_cache_tokens: Optional[int] = None,
        kv_cache_dtype: Optional[str] = None,
        speculative_draft_len: int = 0,
        speculative_ngram: int = 2,
        speculative_window: Optional[int] = None,
        decode_weight_dtype: Optional[str] = None,
        prefill_token_budget: Optional[int] = None,
        decode_blocks_per_admit: int = 1,
        kv_tier_bytes: Optional[int] = None,
        kv_tier_disk_dir: Optional[str] = None,
        kv_tier_disk_bytes: Optional[int] = None,
        kv_spill_dtype: Optional[str] = None,
        device="cuda",
    ):
        if cfg.moe is not None:
            raise NotImplementedError("MoE models are not ported yet")
        # Sampled token ids round-trip through float32 in the packed
        # single-fetch decode result; exact only below 2^24.
        if cfg.vocab_size >= 2**24:
            raise ValueError(
                f"vocab_size {cfg.vocab_size} >= 2^24 would corrupt token ids "
                "in the packed float32 decode fetch")
        if prefill_chunk is not None and prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be positive or None, got {prefill_chunk}")
        if chunked_prefill_per_lap < 1:
            raise ValueError("chunked_prefill_per_lap must be >= 1")
        if kv_cache_dtype not in (None, "model", "int8"):
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r}: expected None, 'model', or 'int8'")
        if prefix_cache_tokens is not None and prefix_cache_tokens < 0:
            raise ValueError("prefix_cache_tokens must be >= 0 or None")
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError("prefill_token_budget must be >= 1 or None")
        if decode_blocks_per_admit < 1:
            raise ValueError("decode_blocks_per_admit must be >= 1")
        if speculative_draft_len < 0 or speculative_ngram < 1:
            raise ValueError(
                f"bad speculative config: draft_len={speculative_draft_len}, "
                f"ngram={speculative_ngram}")
        # None is the reference's default window (1024 recent tokens); 0
        # scans the whole history.
        if speculative_window is None:
            speculative_window = 1024
        if speculative_window < 0:
            raise ValueError(
                f"speculative_window must be >= 0 (0 = unbounded), got {speculative_window}")
        if decode_weight_dtype not in (None, "model", "int8"):
            raise ValueError(
                f"decode_weight_dtype={decode_weight_dtype!r}: expected None, 'model', or 'int8'")
        if kv_spill_dtype not in (None, "model", "int8", "fp8"):
            raise ValueError(
                f"kv_spill_dtype={kv_spill_dtype!r}: expected None, "
                f"'model', 'int8', or 'fp8'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.B = max_batch_size
        self.page_size = page_size
        self.max_pages = pages_needed(max_seq_len, page_size)
        self.S = self.max_pages * page_size
        self.block_steps = decode_block_steps
        self.prefill_max_batch = prefill_max_batch
        # Prompts longer than this prefill chunk by chunk through the
        # paged decode step instead of the batched packed forward; so do
        # the deltas of prefix-cache hits.
        self.prefill_chunk = prefill_chunk
        self.chunked_prefill_per_lap = chunked_prefill_per_lap
        # Token-budget admission: a round admits new prompts only while
        # their uncached prefill tokens fit (the first always admits).
        self.prefill_token_budget = prefill_token_budget
        # Decode blocks between admission rounds (1 = admit every lap);
        # the first lap always admits.
        self.decode_blocks_per_admit = decode_blocks_per_admit
        self._blocks_since_admit = decode_blocks_per_admit
        # qid -> (covered tokens, pages) of finished requests, LRU first;
        # budget-bounded in tokens, evicted under pool pressure, flushed
        # on weight swaps (old-weight KV is invalid). 0 disables.
        self.prefix_cache_tokens = prefix_cache_tokens or 0
        self._prefix_cache: "collections.OrderedDict[str, Tuple[List[int], List[int]]]" = (
            collections.OrderedDict())
        self._cached_tokens = 0
        self.prefix_cache_hits = 0
        self.prefix_tokens_reused = 0
        self.total_requests = 0
        self.eos_token_id = eos_token_id
        self.kv_cache_dtype = kv_cache_dtype
        self.version = 0
        # N-gram speculative decoding: draft_len > 0 feeds 1 + draft_len
        # rows a slot a step and keeps the verified prefix. The yield
        # counters: tokens emitted over steps of active slots.
        self.spec_draft_len = speculative_draft_len
        self.spec_ngram = speculative_ngram
        self.spec_window = speculative_window
        self._spec_emitted = 0
        self._spec_steps = 0
        # int8 decode weights (W8A16): the decode blocks run this tree,
        # rebuilt from the live params at init and on every swap; prefill
        # runs self.params.
        self.decode_weight_dtype = None if decode_weight_dtype == "model" else decode_weight_dtype
        self._qparams = None
        self._refresh_qparams()

        pool_tokens = kv_pool_tokens or max_batch_size * self.S
        self.n_pages = pages_needed(pool_tokens, page_size) + 1  # + trash
        self._allocator = PageAllocator(self.n_pages)
        self._k_pages = None
        self._v_pages = None

        # Device-resident control state: lengths, next_input, active,
        # remaining, min_remaining, temps, top_ps, top_ks, greedy.
        B, dev = self.B, self.device
        self._dstate = (
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.ones((B,), dtype=torch.float32, device=dev),
            torch.ones((B,), dtype=torch.float32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
        )
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        # Token history a slot (prompt + emitted; one scratch column for
        # masked writes), for the draft lookup.
        self._history = (torch.zeros((B, self.S + 1), dtype=torch.int32, device=dev)
                         if speculative_draft_len > 0 else None)
        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)

        # Host mirrors + page bookkeeping.
        self._page_table = np.full((B, self.max_pages), TRASH_PAGE, np.int32)
        self._pt_dirty = True
        self._pt_dev = None
        self._len = np.zeros((B,), np.int64)
        self._pending_deact = np.zeros((B,), bool)
        # Host copies of the per-slot top-p / top-k: the decode block's
        # warp tier is chosen from them without reading the device.
        self._host_tp = np.ones((B,), np.float32)
        self._host_tk = np.full((B,), -1, np.int32)
        self._eos_global = torch.from_numpy(self._eos_mask_np()).to(dev)
        # Host->device stagings on the admit/decode path (loop thread).
        self.h2d_transfers = 0
        self.h2d_bytes = 0

        self._slot_req: List[Optional[GenRequest]] = [None] * B
        self._slot_out: List[List[int]] = [[] for _ in range(B)]
        self._slot_lp: List[List[float]] = [[] for _ in range(B)]
        self._slot_vstart: List[int] = [0] * B
        self._slot_pages: List[List[int]] = [[] for _ in range(B)]
        # Wall time of each slot's last token delivery (ITL samples).
        self._slot_emit_t = [0.0] * B

        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        self._backlog: List[GenRequest] = []  # engine-thread only
        # Loop-thread command queue: closures that touch loop-owned state
        # (_prefix_cache, the allocator, the pools), run between laps.
        self._cmds: "queue.Queue" = queue.Queue()
        # qid -> accepted, not yet admitted requests: their parked
        # prefixes are evicted last. Updated under _fatal_lock.
        self._queued_qids: Dict[str, int] = {}
        # The batch inside _admit_impl, reachable by _fail_all.
        self._admit_inflight: List[Tuple[int, GenRequest, int, List[int], int]] = []
        self._lock = threading.Lock()
        self._interrupt = threading.Event()
        self._pending_params = None
        self._pending_version: Optional[int] = None
        # Serializes concurrent update_params callers.
        self._stage_lock = threading.Lock()
        # Pinned (trainer-published) versions, kept apart from
        # self.version, which unversioned updates also bump.
        self._highest_pinned = -1
        self._applied_pinned = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fatal_error: Optional[BaseException] = None
        self._fatal_lock = threading.Lock()
        # Host counters read by metrics() from other threads.
        self.decode_blocks = 0  # decode blocks run (the loop's lap count)
        self.n_running = 0
        self.n_used_tokens = 0
        self.ttft_hist = LatencyHistogram()
        self.itl_hist = LatencyHistogram()
        # Prompt tokens accepted but not yet admitted (the server's
        # admission watermark); under _fatal_lock.
        self.queued_prompt_tokens = 0
        self.total_generated = 0
        self.n_preempted = 0
        self.last_weight_swap_s = 0.0
        self.last_weight_stage_s = 0.0
        self.last_weight_cutover_s = 0.0
        # Off-thread snapshots of loop-only state, refreshed every lap.
        self._backlog_len = 0
        self._kv_pages_free = self._allocator.n_free
        # KV handoff telemetry (export on prefill-role engines, import on
        # decode-role ones).
        self.kv_exports = 0
        self.kv_export_bytes = 0
        self.last_kv_export_ms = 0.0
        self.kv_imports = 0
        self.kv_import_bytes = 0
        self.last_kv_import_ms = 0.0
        # The tier: evicted prefixes spill here in the handoff format. The
        # gather runs on the loop; the device fetch, quantize, hashing
        # and the insert run on the spill thread.
        self.kv_spill_dtype = None if kv_spill_dtype == "model" else kv_spill_dtype
        self.kv_tier = None
        if kv_tier_bytes and int(kv_tier_bytes) > 0:
            self.kv_tier = KVTierStore(
                int(kv_tier_bytes), disk_dir=kv_tier_disk_dir,
                disk_capacity_bytes=int(kv_tier_disk_bytes or (1 << 30)))
        # Bounded: each item holds one gathered KV pair on the device
        # until the spill thread drains it; overflow is a counted loss.
        self._spill_q: "queue.Queue" = queue.Queue(maxsize=64)
        self._spill_thread: Optional[threading.Thread] = None
        # Weight-swap tier flush, run by the spill thread.
        self._tier_clear = threading.Event()
        self.kv_spills = 0          # spill thread
        self.kv_spill_bytes = 0     # spill thread
        self.kv_spill_tokens = 0    # spill thread
        self.kv_restores = 0        # restore callers
        self.kv_restore_host = 0
        self.kv_restore_disk = 0
        self.kv_restore_tokens = 0
        # True prefix losses: pages freed while their KV was valid and
        # could not be spilled (no tier, spill queue full, spill failure),
        # one counter per writing thread.
        self._kv_lost_evict = 0     # engine loop
        self._kv_lost_spill = 0     # spill thread
        # Off-thread snapshot of the parked qids (qid -> tokens), replaced
        # by the loop every ~0.2 s.
        self._parked_qids: Dict[str, int] = {}
        self._parked_snap_t = 0.0

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        if self.kv_tier is not None:
            self._spill_thread = threading.Thread(target=self._spill_worker, daemon=True)
            self._spill_thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=60)
        if self._spill_thread:
            # Best-effort wake: the worker polls with a short timeout.
            try:
                self._spill_q.put_nowait(None)
            except queue.Full:
                pass
            self._spill_thread.join(timeout=10)

    def submit(self, req: GenRequest):
        with self._fatal_lock:
            if self.fatal_error is not None:
                raise RuntimeError(
                    f"serving engine loop died: {self.fatal_error!r}"
                ) from self.fatal_error
            req.submit_time = time.monotonic()
            self.total_requests += 1
            self.queued_prompt_tokens += len(req.input_ids)
            self._queued_qids[req.qid] = self._queued_qids.get(req.qid, 0) + 1
            self._queue.put(req)

    def warm(self, prompt_lens: List[int], max_new_tokens: Optional[int] = None,
             timeout_s: float = 1800.0) -> float:
        """Run one throwaway greedy request per prompt length through the
        live loop (prefill, decode block, first-token sampling: cuBLAS
        handles, the allocator and the kernels' first launches), before a
        server takes traffic. Returns seconds spent. Must be called after
        start(); raises on timeout or on a request that failed."""
        if self._thread is None:
            raise RuntimeError("warm() requires start()")
        if max_new_tokens is None:
            max_new_tokens = 2 * self.block_steps
        done = threading.Event()
        got: List[GenResult] = []
        n = len(prompt_lens)

        def cb(res):
            got.append(res)
            if len(got) == n:
                done.set()

        t0 = time.perf_counter()
        for i, plen in enumerate(prompt_lens):
            self.submit(GenRequest(
                qid=f"__warm{i}", input_ids=[1] * max(1, int(plen)),
                max_new_tokens=max_new_tokens, min_new_tokens=max_new_tokens,
                greedy=True, done_cb=cb,
            ))
        if not done.wait(timeout_s):
            raise TimeoutError(f"serving warm stalled: {len(got)}/{n} within {timeout_s:.0f}s")
        errs = [r.error for r in got if r.error]
        if errs:
            raise RuntimeError(f"serving warm failed: {errs[0]}")
        dt = time.perf_counter() - t0
        logger.info(f"serving warm: {n} request(s), {dt:.1f}s")
        return dt

    # ------------------------------------------------------------------
    # Disaggregated prefill/decode: KV-handoff export / import
    # ------------------------------------------------------------------

    def _run_on_loop(self, fn, timeout_s: float = 60.0):
        """Run ``fn()`` on the engine loop thread between laps and return
        its result: the one cross-thread door to loop-owned state (the
        prefix cache, the allocator, the pools)."""
        if threading.current_thread() is self._thread:
            return fn()
        done = threading.Event()
        cell: Dict[str, Any] = {}
        self._cmds.put((fn, done, cell))
        deadline = time.monotonic() + timeout_s
        while not done.wait(0.05):
            if self.fatal_error is not None:
                raise RuntimeError(
                    f"serving engine loop died: {self.fatal_error!r}"
                ) from self.fatal_error
            if self._thread is None or not self._thread.is_alive() or self._stop.is_set():
                raise RuntimeError("serving engine loop is not running")
            if time.monotonic() > deadline:
                raise TimeoutError(f"engine-loop command not served within {timeout_s}s")
        if "exc" in cell:
            raise cell["exc"]
        return cell.get("ret")

    def _drain_cmds(self):
        while True:
            try:
                fn, done, cell = self._cmds.get_nowait()
            except queue.Empty:
                return
            try:
                cell["ret"] = fn()
            except BaseException as e:  # delivered to the waiting caller
                cell["exc"] = e
            finally:
                done.set()

    def export_kv_handoff(self, qid: str, compress: Optional[str] = None
                          ) -> Tuple[Dict[str, Any], bytes]:
        """Export ``qid``'s parked KV prefix as a handoff blob (meta,
        payload), consuming the entry: its pages are freed here (the
        decode side owns the sequence now). A prefix spilled to the tier
        is served from there. Raises KeyError when neither holds ``qid``.
        ``compress="int8"`` or ``"fp8"`` quantizes a float pool's KV on
        the wire; int8 pools always ship their (data, scales) form."""
        t0 = time.monotonic()

        def _peek_and_gather():
            # Peek, don't pop: if the caller's door wait times out, the
            # entry and its pages stay owned by the cache.
            ent = self._prefix_cache.get(qid)
            if ent is None:
                raise KeyError(f"no parked KV prefix for qid {qid!r}")
            toks, pages = ent
            n = len(toks)
            n_pg = pages_needed(n, self.page_size)
            k = gather_kv_tokens(self._k_pages, pages[:n_pg], n)
            v = gather_kv_tokens(self._v_pages, pages[:n_pg], n)
            return ent, toks, self.version, k, v

        def _consume(ent):
            # Identity-checked pop and free: an admission may have taken
            # the entry meanwhile (then it owns the pages).
            if self._prefix_cache.get(qid) is ent:
                self._prefix_cache.pop(qid, None)
                self._cached_tokens -= len(ent[0])
                self._allocator.free(ent[1])

        try:
            ent, toks, version, k, v = self._run_on_loop(_peek_and_gather)
        except KeyError:
            got = self.kv_tier.get(qid, count=False) if self.kv_tier is not None else None
            if got is None:
                raise
            meta, payload, _tier = got
            self.kv_tier.discard(qid)
            self.kv_exports += 1
            self.kv_export_bytes += len(payload)
            self.last_kv_export_ms = (time.monotonic() - t0) * 1000.0
            return meta, payload
        try:
            arrays, wire = self._pack_kv_wire(k, v, compress)
            segments, chunks, payload = kvh.pack_arrays(arrays)
            meta = kvh.build_meta(qid, version, toks, wire, self.cfg, segments, chunks)
        finally:
            self._run_on_loop(lambda: _consume(ent))
        self.kv_exports += 1
        self.kv_export_bytes += len(payload)
        self.last_kv_export_ms = (time.monotonic() - t0) * 1000.0
        return meta, payload

    def _wire_to_device(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        """A token-major wire tensor ([L, H, n, ...]) zero-padded to
        ``pad`` tokens on the engine's device, in its wire dtype."""
        L, H, n = x.shape[:3]
        out = torch.zeros((L, H, pad) + tuple(x.shape[3:]), dtype=x.dtype)
        out[:, :, :n] = x
        return out.to(self.device)

    def import_kv_handoff(self, meta: Dict[str, Any], payload: bytes):
        """Import a handoff blob: allocate pages, write the KV into the
        pool and park it as ``qid``'s prefix (the decode side; the caller
        then submits prompt + first token at priority 0, which admits as
        a one-token delta prefill).

        Raises KVHandoffVersionMismatch when the blob's weight version is
        not the live engine's (checked on the loop thread, atomically
        with the park), KVHandoffError on geometry / hash problems or
        pool exhaustion. Host unpacking and the host->device copy run on
        the caller's thread; only the pool write runs on the loop."""
        t0 = time.monotonic()
        kvh.check_geometry(meta, self.cfg)
        qid = str(meta["qid"])
        toks = [int(t) for t in meta["tokens"]]
        n = len(toks)
        n_pg = pages_needed(n, self.page_size)
        pad = n_pg * self.page_size
        if n != int(meta["n_tokens"]):
            raise kvh.KVHandoffError(f"{n} tokens, meta says {meta['n_tokens']}")

        if meta["kv_wire"] == "int8" and self.kv_cache_dtype == "int8":
            # The wire's (data, scales) pairs are the pool's encoding:
            # straight in, bit-exact.
            parts = kvh.unpack_kv_int8(meta, payload)
            if parts[0].shape[2] != n:
                raise kvh.KVHandoffError(f"token/KV length mismatch: {n} tokens, KV {tuple(parts[0].shape)}")
            kd, ks, vd, vs = (self._wire_to_device(x, pad) for x in parts)

            def scatter(pages_dev):
                scatter_prefill_int8(self._k_pages, self._v_pages, kd, ks, vd, vs, pages_dev)
        else:
            if meta["kv_wire"] in ("int8", "fp8"):
                # Dequantized on the host, in the reference's float32 order.
                kf, vf = kvh.unpack_kv_float(meta, payload)
            else:
                # Float wires go to the device in their own dtype (the pool
                # write casts or quantizes, as from float32).
                arrs = kvh.unpack_arrays(meta, payload)
                kf, vf = arrs["k"], arrs["v"]
            if kf.shape[2] != n:
                raise kvh.KVHandoffError(f"token/KV length mismatch: {n} tokens, KV {tuple(kf.shape)}")

            def to_pref(x):
                # [L, Hkv, n, hd] -> scatter_prefill's [L, 1, pad, Hkv, hd]
                return self._wire_to_device(x, pad).permute(0, 2, 1, 3)[:, None]

            k_dev, v_dev = to_pref(kf), to_pref(vf)

            def scatter(pages_dev):
                scatter_prefill(self._k_pages, self._v_pages, k_dev, v_dev, pages_dev)

        def _write():
            if int(meta["version"]) != self.version:
                raise kvh.KVHandoffVersionMismatch(
                    f"blob v{meta['version']} vs engine v{self.version}")
            self._ensure_pool()
            pages = self._alloc_pages(n_pg)
            if pages is None:
                raise kvh.KVHandoffError(
                    f"pool exhausted: need {n_pg} pages, {self._allocator.n_free} free")
            scatter(torch.as_tensor(pages, dtype=torch.long, device=self.device))
            old = self._prefix_cache.pop(qid, None)
            if old is not None:
                self._allocator.free(old[1])
                self._cached_tokens -= len(old[0])
            self._prefix_cache[qid] = (toks, pages)
            self._cached_tokens += n

        self._run_on_loop(_write)
        self.kv_imports += 1
        self.kv_import_bytes += len(payload)
        self.last_kv_import_ms = (time.monotonic() - t0) * 1000.0

    def _pack_kv_wire(self, k, v, compress: Optional[str]):
        """(arrays, wire) of a gathered KV pair, shared by the export and
        the spill worker; the arrays are CPU tensors holding the device
        bytes unchanged. int8 pools ship their (data, scales) form; float
        pools ship their own dtype, or quantize on the wire
        (``compress="int8"`` on the device as the pool quantizes,
        ``"fp8"`` on the host)."""
        if isinstance(k, tuple):  # int8 pool: (data, scales)
            return [
                ("k_data", k[0].cpu()),
                ("k_scales", k[1].float().cpu()),
                ("v_data", v[0].cpu()),
                ("v_scales", v[1].float().cpu()),
            ], "int8"
        if compress == "int8":
            kw, ks = quantize_kv(k)
            vw, vs = quantize_kv(v)
            return [
                ("k_data", kw.cpu()),
                ("k_scales", ks[..., 0].cpu()),
                ("v_data", vw.cpu()),
                ("v_scales", vs[..., 0].cpu()),
            ], "int8"
        kh, vh = k.cpu(), v.cpu()
        if compress == "fp8":
            kw, ks = kvh.quantize_kv_fp8(kh)
            vw, vs = kvh.quantize_kv_fp8(vh)
            return [("k_data", kw), ("k_scales", ks), ("v_data", vw), ("v_scales", vs)], "fp8"
        return [("k", kh), ("v", vh)], kvh.wire_dtype_name(kh.dtype)

    # ------------------------------------------------------------------
    # The tier: spill, restore, peer serving
    # ------------------------------------------------------------------

    def _spill_or_lose(self, qid: str, toks: List[int], pages: List[int], spill: bool):
        """Loop half of a spill: gather the KV while its pages are still
        allocated, then hand it to the spill thread. Whatever prevents
        the spill of valid KV counts as a prefix loss."""
        if not spill:
            return  # weight-swap flush: the KV is stale, not lost
        if self.kv_tier is None:
            self._kv_lost_evict += 1
            return
        n = len(toks)
        n_pg = pages_needed(n, self.page_size)
        k = gather_kv_tokens(self._k_pages, pages[:n_pg], n)
        v = gather_kv_tokens(self._v_pages, pages[:n_pg], n)
        try:
            self._spill_q.put_nowait((qid, list(toks), self.version, k, v))
        except queue.Full:
            # Dropping (not blocking) bounds the loop's latency; the
            # continuation pays a re-prefill.
            self._kv_lost_evict += 1

    def _spill_worker(self):
        """Spill thread: device fetch, optional quantize, chunk hashing
        and the tier insert. One failure loses one prefix (counted),
        never the thread."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            if self._tier_clear.is_set():
                # A weight swap landed: every tiered prefix is stale.
                self._tier_clear.clear()
                self.kv_tier.clear()
            try:
                item = self._spill_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                continue
            qid, toks, version, k, v = item
            if version != self.version:
                continue  # spilled under replaced weights: stale, not lost
            t0 = tracing.now_ns() if tracing.enabled() else 0
            try:
                faults.maybe_fail("engine.kv_spill")
                with torch.inference_mode():
                    arrays, wire = self._pack_kv_wire(k, v, self.kv_spill_dtype)
                segments, chunks, payload = kvh.pack_arrays(arrays)
                meta = kvh.build_meta(qid, version, toks, wire, self.cfg, segments, chunks)
                self.kv_tier.put(qid, meta, payload)
                self.kv_spills += 1
                self.kv_spill_bytes += len(payload)
                self.kv_spill_tokens += len(toks)
                if tracing.enabled():
                    tracing.record_span("server.kv_spill", t0, qid=qid, n_tokens=len(toks),
                                        bytes=len(payload), wire=wire)
            except Exception:
                self._kv_lost_spill += 1
                logger.warning(f"kv spill failed for {qid!r}", exc_info=True)

    def restore_from_tier(self, qid: str, prompt_ids: Optional[List[int]] = None) -> int:
        """Pull a spilled prefix back from the tier into the pool and park
        it, so the continuation about to be submitted admits as a delta
        prefill. Returns the restored token count, 0 on a miss. Runs on
        server threads (import_kv_handoff takes the loop door itself).
        A version-stale entry is dropped; a prompt that does not extend
        the spilled tokens leaves the entry in place."""
        if self.kv_tier is None:
            return 0
        # Validate against the meta first (always in host memory): a
        # rejected probe pays no disk read and counts no hit.
        meta0 = self.kv_tier.peek_meta(qid, count_miss=True)
        if meta0 is None:
            return 0
        if int(meta0.get("version", -1)) != self.version:
            self.kv_tier.discard(qid)
            return 0
        if prompt_ids is not None:
            toks = [int(t) for t in meta0["tokens"]]
            use = min(len(toks), len(prompt_ids) - 1)
            if use < self.page_size or toks[:use] != [int(t) for t in prompt_ids[:use]]:
                return 0
        got = self.kv_tier.get(qid)
        if got is None:
            return 0  # aged out between peek and get
        meta, payload, tier = got
        try:
            self.import_kv_handoff(meta, payload)
        except kvh.KVHandoffVersionMismatch:
            self.kv_tier.discard(qid)
            return 0
        except (kvh.KVHandoffError, RuntimeError, TimeoutError):
            # Pool exhaustion or loop trouble: keep the entry.
            return 0
        self.kv_tier.discard(qid)  # the pool owns the prefix again
        self.kv_restores += 1
        self.kv_restore_tokens += int(meta["n_tokens"])
        if tier == "disk":
            self.kv_restore_disk += 1
        else:
            self.kv_restore_host += 1
        return int(meta["n_tokens"])

    def has_parked(self, qid: str) -> bool:
        """Whether the pool holds a parked prefix for qid, from the
        loop's snapshot (up to ~0.2 s stale; admission revalidates)."""
        return qid in self._parked_qids

    def parked_qids_now(self, timeout_s: float = 30.0) -> Dict[str, int]:
        """Authoritative qid -> token count of the parked prefixes, read
        on the loop thread (a drain enumerating what it must migrate
        cannot use the stale snapshot)."""
        return self._run_on_loop(
            lambda: {q: len(e[0]) for q, e in self._prefix_cache.items()}, timeout_s)

    def parked_index(self, cap: int = 8192) -> List[Dict[str, Any]]:
        """Parked entries for ``/kv/index`` (from the snapshot; tier
        entries come from kv_tier.held())."""
        out = []
        for q, n in list(self._parked_qids.items()):
            if len(out) >= cap:
                break
            out.append({"qid": q, "tier": "hbm", "n_tokens": int(n),
                        "content_hash": "", "version": int(self.version)})
        return out

    def stage_peer_export(self, qid: str) -> Dict[str, Any]:
        """Peer-pull staging (``/kv/manifest``): the handoff meta of a
        prefix this engine holds, with its payload servable from the
        tier. A tier entry is served as it is; a parked prefix is
        exported (consumed: the session moves) into the tier. Raises
        KeyError when neither holds qid."""
        if self.kv_tier is None:
            raise KeyError(f"no kv tier to stage peer export for {qid!r}")
        got = self.kv_tier.get(qid, count=False)
        if got is not None:
            return got[0]
        meta, payload = self.export_kv_handoff(qid)
        self.kv_tier.put(qid, meta, payload)
        return meta

    def peer_payload(self, qid: str) -> Optional[Tuple[Dict, bytes]]:
        """(meta, payload) for ``/kv/chunk``: no hit accounting, no
        consume (a peer pulls many chunks)."""
        if self.kv_tier is None:
            return None
        got = self.kv_tier.get(qid, count=False)
        return None if got is None else (got[0], got[1])

    def is_stale_update(self, version: Optional[int]) -> bool:
        """True iff update_params(version=version) would drop the update
        as stale, so a caller can skip loading the weights at all."""
        if version is None:
            return False
        with self._stage_lock:
            return version <= self._highest_pinned

    @property
    def update_pending(self) -> bool:
        """True while a staged weight update waits to go live."""
        return self._pending_params is not None

    def escalate_pending_interrupt(self):
        """Interrupt running requests iff a staged update is waiting to
        apply (a bare interrupt with nothing pending would cut running
        requests for nothing)."""
        with self._lock:
            if self._pending_params is not None:
                self._interrupt.set()

    def update_params(self, params, allow_interrupt: bool = True,
                      version: Optional[int] = None):
        """Swap weights at the next block boundary. With allow_interrupt,
        running requests are interrupted and returned partially; without
        it, admission pauses and the swap happens once running requests
        drain. ``version`` pins the new weight version to the trainer's.

        The host->device copy runs HERE, on the caller's thread, onto the
        engine's device by name (leaves keep the live params' dtypes), so
        decoding continues while the weights stream in; the serve loop's
        swap is a pointer flip. Its seconds land in last_weight_stage_s.
        Concurrent callers are serialized, and a pinned update not newer
        than the highest pinned version staged is dropped (still honoring
        the interrupt escalation)."""
        with self._stage_lock:
            if version is not None and version <= self._highest_pinned:
                logger.info(f"dropping stale weight update v{version} "
                            f"(highest pinned v{self._highest_pinned}, live v{self.version})")
                if allow_interrupt:
                    self.escalate_pending_interrupt()
                return
            with self._lock:
                # Never stack staged copies: drop a not-yet-applied one
                # first (its pinned version never went live).
                if self._pending_params is not None and self._pending_version is not None:
                    self._highest_pinned = self._applied_pinned
                self._pending_params = None
                self._pending_version = None
            t0 = time.monotonic()
            staged = _to_device(params, self.device, like=self.params)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last_weight_stage_s = time.monotonic() - t0
            with self._lock:
                self._pending_params = staged
                self._pending_version = version
                if version is not None:
                    self._highest_pinned = max(self._highest_pinned, version)
        if allow_interrupt:
            self._interrupt.set()

    def cutover_params(self, params, version: int, allow_interrupt: bool = True,
                       timeout_s: float = 120.0) -> float:
        """The weight plane's cutover: swap to ``params`` (pinned to
        ``version``) and block until the serve loop has landed it, the
        whole interrupt -> host-to-device copy -> pointer flip window. The
        bytes were prefetched to host memory, so all of it is cutover
        cost. Returns the seconds, also kept as ``last_weight_cutover_s``;
        raises TimeoutError if the version never lands, RuntimeError if
        the loop died."""
        t0 = time.monotonic()
        self.update_params(params, allow_interrupt=allow_interrupt, version=int(version))
        return self._await_pinned(int(version), t0, timeout_s)

    def _await_pinned(self, version: int, t0: float, timeout_s: float) -> float:
        deadline = t0 + timeout_s
        while self._applied_pinned < version:
            if self.fatal_error is not None:
                raise RuntimeError(f"cutover v{version}: serve loop died: "
                                   f"{self.fatal_error!r}") from self.fatal_error
            if time.monotonic() > deadline:
                raise TimeoutError(f"cutover v{version} did not land within {timeout_s}s "
                                   f"(live v{self.version})")
            time.sleep(0.002)
        self.last_weight_cutover_s = time.monotonic() - t0
        return self.last_weight_cutover_s

    @property
    def queue_depth(self) -> int:
        """Requests accepted but not yet admitted to a slot (the
        loop-maintained backlog snapshot plus the submit queue)."""
        return self._queue.qsize() + self._backlog_len

    def latency_snapshot(self, reset: bool = False) -> Dict[str, Any]:
        """Raw TTFT / ITL bucket counts (base/latency.py edges) and
        percentiles; reset=True zeroes the histograms."""
        ttft = self.ttft_hist.counts(reset=reset)
        itl = self.itl_hist.counts(reset=reset)
        return {
            "ttft_counts": ttft,
            "itl_counts": itl,
            "ttft_p50_ms": percentile_from_counts(ttft, 50.0),
            "ttft_p99_ms": percentile_from_counts(ttft, 99.0),
            "itl_p50_ms": percentile_from_counts(itl, 50.0),
            "itl_p99_ms": percentile_from_counts(itl, 99.0),
        }

    def metrics(self) -> Dict[str, float]:
        """The reference engine's metrics, key for key. Features the port
        lacks read their disabled values (MoE 0.0); ``kv_tier_*`` keys
        appear with a tier. The decode control state lives on the device
        between blocks, so ``decode_resident`` reads 1.0."""
        return {
            "num_running_reqs": float(self.n_running),
            "num_used_tokens": float(self.n_used_tokens),
            "total_generated": float(self.total_generated),
            "queue_depth": float(self.queue_depth),
            "queued_prompt_tokens": float(self.queued_prompt_tokens),
            "ttft_p50_ms": self.ttft_hist.percentile(50.0),
            "ttft_p99_ms": self.ttft_hist.percentile(99.0),
            "itl_p50_ms": self.itl_hist.percentile(50.0),
            "itl_p99_ms": self.itl_hist.percentile(99.0),
            "ttft_count": float(self.ttft_hist.total()),
            "itl_count": float(self.itl_hist.total()),
            "kv_pages_free": float(self._kv_pages_free),
            "kv_pages_total": float(self.n_pages - 1),
            "h2d_transfers_total": float(self.h2d_transfers),
            "h2d_bytes_total": float(self.h2d_bytes),
            "decode_blocks_total": float(self.decode_blocks),
            "h2d_per_decode_block": float(self.h2d_transfers) / max(1.0, float(self.decode_blocks)),
            "decode_resident": 1.0,
            "moe_drop_rate": 0.0,
            "moe_router_entropy": 0.0,
            "num_preempted_reqs": float(self.n_preempted),
            "last_weight_swap_s": float(self.last_weight_swap_s),
            "last_weight_stage_s": float(self.last_weight_stage_s),
            "last_weight_cutover_s": float(self.last_weight_cutover_s),
            "prefix_cache_hits": float(self.prefix_cache_hits),
            "prefix_tokens_reused": float(self.prefix_tokens_reused),
            "prefix_cached_tokens": float(self._cached_tokens),
            "total_requests": float(self.total_requests),
            "kv_export_total": float(self.kv_exports),
            "kv_export_bytes": float(self.kv_export_bytes),
            "last_kv_export_ms": float(self.last_kv_export_ms),
            "kv_import_total": float(self.kv_imports),
            "kv_import_bytes": float(self.kv_import_bytes),
            "last_kv_import_ms": float(self.last_kv_import_ms),
            "kv_spill_total": float(self.kv_spills),
            "kv_spill_bytes": float(self.kv_spill_bytes),
            "kv_spill_tokens": float(self.kv_spill_tokens),
            "kv_restore_total": float(self.kv_restores),
            "kv_restore_host": float(self.kv_restore_host),
            "kv_restore_disk": float(self.kv_restore_disk),
            "kv_restore_tokens": float(self.kv_restore_tokens),
            "kv_prefix_lost_total": float(self._kv_lost_evict + self._kv_lost_spill),
            **{f"kv_tier_{k}": v for k, v in
               (self.kv_tier.stats() if self.kv_tier is not None else {}).items()},
            # Speculation yield: emitted tokens per decode step of an
            # active slot (1.0 = no gain; the ceiling is 1 + draft_len),
            # and its sums for the fleet's ratio.
            "spec_tokens_per_step": (float(self._spec_emitted / self._spec_steps)
                                     if self._spec_steps else 0.0),
            "spec_emitted_tokens": float(self._spec_emitted),
            "spec_active_steps": float(self._spec_steps),
        }

    # ------------------------------------------------------------------
    # Engine-thread internals
    # ------------------------------------------------------------------

    def _refresh_qparams(self):
        """(Re)build the int8 decode-weight tree from the live params, at
        init and after every weight swap."""
        if self.decode_weight_dtype is None:
            return
        self._qparams = maybe_quantize_decode_weights(
            self.params, self.cfg.tied_embeddings, self.decode_weight_dtype)

    @property
    def _decode_params(self):
        """The param tree the decode blocks run (the int8 tree when
        decode_weight_dtype is set); prefill always runs self.params."""
        return self._qparams if self._qparams is not None else self.params

    def _ensure_pool(self):
        if self._k_pages is not None:
            return
        c = self.cfg
        shape = (c.n_layers, c.n_kv_heads, self.n_pages, self.page_size, c.head_dim)

        def fresh_pool():
            if self.kv_cache_dtype == "int8":
                return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                        torch.zeros(shape[:-1], dtype=torch.float32, device=self.device))
            return torch.zeros(shape, dtype=torch_dtype(c.compute_dtype),
                               device=self.device)

        self._k_pages = fresh_pool()
        self._v_pages = fresh_pool()

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.B) if self._slot_req[i] is None]

    def _drain_queue(self):
        try:
            while True:
                self._backlog.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        self._backlog_len = len(self._backlog)

    def _pop_backlog(self, idx: int = 0) -> GenRequest:
        req = self._backlog.pop(idx)
        self._backlog_len = len(self._backlog)
        with self._fatal_lock:
            self.queued_prompt_tokens = max(0, self.queued_prompt_tokens - len(req.input_ids))
            n = self._queued_qids.get(req.qid, 0)
            if n > 1:
                self._queued_qids[req.qid] = n - 1
            else:
                self._queued_qids.pop(req.qid, None)
        return req

    def _effective_priority(self, req: GenRequest) -> int:
        if req.starved_rounds >= self.STARVATION_ROUNDS:
            return 0
        # A parked prefix marks a session continuation whatever the
        # declared class: its KV is already paid for.
        if req.qid in self._prefix_cache:
            return 0
        return req.priority

    def _order_backlog(self):
        """Class 0 (continuations, interrupted re-prefills, aged fresh
        requests) ahead of class 1; FIFO within a class (stable sort)."""
        if any(self._effective_priority(r) != 0 for r in self._backlog):
            self._backlog.sort(key=self._effective_priority)

    def _takes_chunked_path(self, req: GenRequest, plen: int,
                            cached_use: Optional[int] = None) -> bool:
        """Whether a prompt runs the one-at-a-time chunked prefill: every
        prefix-cache hit (only the delta past cached_use needs compute)
        and fresh prompts longer than prefill_chunk. With cached_use=None
        this predicts from any parked entry (the per-lap cap's guess,
        before the prefix is validated)."""
        hit = req.qid in self._prefix_cache if cached_use is None else cached_use > 0
        return hit or bool(self.prefill_chunk and plen > self.prefill_chunk)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        self.h2d_transfers += 1
        self.h2d_bytes += int(arr.nbytes)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _chunked_prefill_one(self, input_ids: List[int], pages: List[int], start: int = 0):
        """Prefill one prompt chunk by chunk into its pages from position
        ``start`` (nonzero for a prefix-cache hit: the positions below it
        already hold valid KV in ``pages``, and ``start`` may fall inside
        a page); returns the float32 [V] logits of its last token. A chunk
        is prefill_chunk tokens (the page size when chunking is off),
        padded to a whole number of pages."""
        C = self.prefill_chunk or self.page_size
        self._ensure_pool()
        prow = np.full((self.max_pages,), TRASH_PAGE, np.int32)
        prow[: len(pages)] = pages
        prow_dev = self._h2d(prow)
        last = None
        for s0 in range(start, len(input_ids), C):
            seg = input_ids[s0: s0 + C]
            toks = np.zeros((min(C, _round_up(len(seg), self.page_size)),), np.int32)
            toks[: len(seg)] = seg
            last = _chunk_prefill_body(
                self.params, self.cfg, self._h2d(toks), self._k_pages,
                self._v_pages, prow_dev, s0, len(seg),
            )
        return last

    def _admit(self):
        """Fill free slots from the backlog with one batched prefill (and
        chunked prefills for long prompts and cache hits) and one device
        state update."""
        batch = self._admit_inflight
        batch.clear()
        self._admit_impl(batch)
        batch.clear()  # the requests now live in _slot_req

    def _admit_impl(self, batch):
        # A pending non-interrupting swap stops admission so running
        # requests drain and the swap can land (before the interleave
        # counter reset: admission retries the lap after it lands).
        if self._pending_params is not None:
            return
        self._blocks_since_admit = 0
        self._drain_queue()
        self._order_backlog()
        free = self._free_slots()
        n_chunked = 0
        tok_budget = self.prefill_token_budget
        while free and self._backlog and len(batch) < self.prefill_max_batch:
            req = self._backlog[0]
            plen = len(req.input_ids)
            if self._takes_chunked_path(req, plen) and n_chunked >= self.chunked_prefill_per_lap:
                break
            # The round's budget counts uncached tokens, estimated from
            # the parked prefix before it is validated; the first
            # admission of a round always proceeds.
            est_new = plen
            if tok_budget is not None:
                ent = self._prefix_cache.get(req.qid)
                if ent is not None:
                    est_new = plen - min(len(ent[0]), plen - 1)
                est_new = max(1, est_new)
                if batch and est_new > tok_budget:
                    break
            if plen + req.max_new_tokens > self.S:
                req.max_new_tokens = max(0, self.S - plen)
            if plen >= self.S or req.max_new_tokens == 0:
                self._pop_backlog()
                self._finish_host(req, [], [], no_eos=True, interrupted=False,
                                  vstart=self.version)
                continue
            n_need = pages_needed(plen, self.page_size)
            if n_need > self.n_pages - 1:
                # The prompt alone exceeds the whole pool: reject now
                # instead of blocking everything behind it forever.
                self._pop_backlog()
                logger.warning(f"rejecting {req.qid}: prompt needs {n_need} "
                               f"pages, pool has {self.n_pages - 1}")
                self._finish_host(req, [], [], no_eos=True, interrupted=False,
                                  vstart=self.version)
                continue
            # Reserve through the first decode block, so a fresh admit is
            # not preempted before it produces a block.
            n_reserve = pages_needed(plen + self.block_steps, self.page_size)
            n_reserve = min(n_reserve, self.max_pages, self.n_pages - 1)
            # Prefix-cache lookup: a resubmission whose prompt extends the
            # parked tokens keeps those pages and prefills only the delta
            # (positions cached_use..plen-1).
            pages = None
            cached_use = 0
            ent = self._prefix_cache.pop(req.qid, None)
            if ent is not None:
                ctoks, cpages = ent
                self._cached_tokens -= len(ctoks)
                use = min(len(ctoks), plen - 1)
                if use >= self.page_size and ctoks[:use] == req.input_ids[:use]:
                    if len(cpages) < n_reserve:
                        got = self._alloc_pages(n_reserve - len(cpages))
                        if got is None:
                            # Pool pressure mid-extension: re-park the
                            # entry and stop admitting.
                            self._prefix_cache[req.qid] = ent
                            self._cached_tokens += len(ctoks)
                            break
                        cpages = cpages + got
                    pages = cpages
                    cached_use = use
                    self.prefix_cache_hits += 1
                    self.prefix_tokens_reused += use
                else:
                    self._allocator.free(cpages)
            if pages is None:
                pages = self._alloc_pages(n_reserve)
                if pages is None:
                    break  # pool pressure: wait for frees
            self._pop_backlog()
            batch.append((free.pop(0), req, plen, pages, cached_use))
            if tok_budget is not None:
                tok_budget = max(0, tok_budget - est_new)
            if self._takes_chunked_path(req, plen, cached_use):
                n_chunked += 1
        if not batch:
            return
        # Starvation aging: only requests passed over by a round that
        # admitted someone age.
        for r in self._backlog:
            r.starved_rounds += 1
        # Chunked entries first so logits rows stay aligned with `batch`.
        long = [e for e in batch if self._takes_chunked_path(e[1], e[2], e[4])]
        short = [e for e in batch if not self._takes_chunked_path(e[1], e[2], e[4])]
        batch[:] = long + short
        rows = [self._chunked_prefill_one(req.input_ids, pages, start=cu)
                for _, req, _, pages, cu in long]
        if short:
            pad = _round_up(max(p for _, _, p, _, _ in short), self.page_size)
            ids = np.zeros((len(short), pad), np.int32)
            lens = np.zeros((len(short),), np.int32)
            for i, (_, req, plen, _, _) in enumerate(short):
                ids[i, :plen] = req.input_ids
                lens[i] = plen
            short_logits, k_pref, v_pref = _prefill_batch(
                self.params, self.cfg, self._h2d(ids), self._h2d(lens))
            # Pages past a row's prompt (first-block headroom) get decode
            # writes later; prompt padding chunks go to the trash page.
            n_chunks = pad // self.page_size
            flat = np.full((len(short), n_chunks), TRASH_PAGE, np.int32)
            for i, (_, _, plen_i, pages, _) in enumerate(short):
                n_p = pages_needed(plen_i, self.page_size)
                flat[i, :n_p] = pages[:n_p]
            self._ensure_pool()
            scatter_prefill(self._k_pages, self._v_pages, k_pref, v_pref,
                            self._h2d(flat.reshape(-1)))
            rows.append(short_logits)
        last_logits = torch.cat([r.reshape(-1, self.cfg.vocab_size) for r in rows])

        # First token of each row (same warp as the decode block).
        reqs = [e[1] for e in batch]
        eos_rows = np.stack([self._eos_mask_np(r) for r in reqs])
        tps = np.asarray([r.top_p for r in reqs], np.float32)
        tks = np.asarray([r.top_k for r in reqs], np.int32)
        toks, lps = warp_sample(
            last_logits, self._gen,
            self._h2d(np.asarray([r.temperature for r in reqs], np.float32)),
            self._h2d(tps), self._h2d(tks),
            self._h2d(np.asarray([r.greedy for r in reqs], bool)),
            self._h2d(np.asarray([r.min_new_tokens > 0 for r in reqs], bool)),
            self._h2d(eos_rows),
            tier=select_tier(tps, tks, None, self.cfg.vocab_size),
        )
        first = torch.stack([toks.float(), lps], dim=1).cpu().numpy()  # one fetch
        # The first tokens are on the host: TTFT = submit -> now.
        t_first = time.monotonic()
        for slot_i, req_i, *_ in batch:
            self.ttft_hist.add((t_first - req_i.submit_time) * 1000.0)
            self._slot_emit_t[slot_i] = t_first

        adm = []  # (slot, plen, tok, budget, min_remaining, temp, top_p, top_k, greedy)
        for i, (slot, req, plen, pages, _) in enumerate(batch):
            tok_i, lp_f = int(first[i, 0]), float(first[i, 1])
            # A stale deactivation from this slot's previous request must
            # not clobber the fresh activation.
            self._pending_deact[slot] = False
            self._slot_req[slot] = req
            self._slot_out[slot] = [tok_i]
            self._slot_lp[slot] = [lp_f]
            self._slot_vstart[slot] = self.version
            self._slot_pages[slot] = pages
            self._page_table[slot, :] = TRASH_PAGE
            self._page_table[slot, : len(pages)] = pages
            self._pt_dirty = True
            # The cache fill excludes the pending next-input token: the
            # first decode step writes the first token's K/V at plen. A
            # request that finishes here still parks its prompt's KV.
            self._len[slot] = plen
            is_eos = tok_i in self._eos_set(req)
            budget_left = req.max_new_tokens - 1
            if (is_eos and req.min_new_tokens <= 1) or budget_left <= 0:
                self._finish_slot(slot, hit_eos=is_eos)
                continue
            self._host_tp[slot] = req.top_p
            self._host_tk[slot] = req.top_k
            adm.append((slot, plen, tok_i, budget_left,
                        max(0, req.min_new_tokens - 1), req.temperature,
                        req.top_p, req.top_k, req.greedy))
        if adm:
            self._apply_admits(adm)
            if self._history is not None:
                # The slot's full token history, a prefix-cache hit's cached
                # part too (drafts match against it).
                rows = np.zeros((len(adm), self.S + 1), np.int32)
                for i, a in enumerate(adm):
                    req = self._slot_req[a[0]]
                    plen = min(len(req.input_ids), self.S)
                    rows[i, :plen] = req.input_ids[:plen]
                    rows[i, plen] = self._slot_out[a[0]][0]
                set_history(self._history, self._h2d(np.asarray([a[0] for a in adm], np.int64)),
                            self._h2d(rows))

    def _apply_admits(self, adm):
        """Activate admitted slots in the device control state: one int32
        and one float32 host->device copy, then in-place index writes."""
        ints = self._h2d(np.asarray(
            [(a[0], a[1], a[2], a[3], a[4], a[7], int(a[8])) for a in adm], np.int32))
        flts = self._h2d(np.asarray([(a[5], a[6]) for a in adm], np.float32))
        slots = ints[:, 0].long()
        (lengths, next_input, active, remaining, min_remaining,
         temps, top_ps, top_ks, greedy) = self._dstate
        lengths[slots] = ints[:, 1]
        next_input[slots] = ints[:, 2]
        active[slots] = True
        remaining[slots] = ints[:, 3]
        min_remaining[slots] = ints[:, 4]
        temps[slots] = flts[:, 0]
        top_ps[slots] = flts[:, 1]
        top_ks[slots] = ints[:, 5]
        greedy[slots] = ints[:, 6] > 0

    def _evict_one_prefix(self, pinned: Optional[set] = None, spill: bool = True) -> bool:
        """Evict the least-recently-used parked prefix, skipping qids in
        ``pinned`` (a request for them is queued), spilling its KV to the
        tier first when there is one (without a tier, evicting valid KV
        counts as a prefix loss). ``spill=False`` is the weight-swap
        flush, whose KV is stale anyway. Returns False when nothing
        (unpinned) is evictable."""
        if not self._prefix_cache:
            return False
        qid = None
        if pinned:
            qid = next((q for q in self._prefix_cache if q not in pinned), None)
            if qid is None:
                return False
            toks, pages = self._prefix_cache.pop(qid)
        else:
            qid, (toks, pages) = self._prefix_cache.popitem(last=False)
        self._spill_or_lose(qid, toks, pages, spill)
        self._allocator.free(pages)
        self._cached_tokens -= len(toks)
        return True

    def _flush_prefix_cache(self):
        while self._evict_one_prefix(spill=False):
            pass

    def _pinned_qids(self) -> set:
        """Qids with an accepted, not yet admitted request: their parked
        KV is about to be consumed."""
        with self._fatal_lock:
            return set(self._queued_qids)

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate, evicting parked prefixes under pressure (those with a
        queued consumer last): speculative cache pages never cost an
        active request its admission or its next decode block."""
        got = self._allocator.alloc(n)
        if got is not None:
            return got
        pinned = self._pinned_qids()
        while got is None and self._evict_one_prefix(pinned):
            got = self._allocator.alloc(n)
        while got is None and self._evict_one_prefix():
            got = self._allocator.alloc(n)
        return got

    def _ensure_pages(self):
        """Grow each active slot's pages to cover the next decode block;
        preempt (interrupt-partial) the slot itself when the pool is dry
        even after evicting parked prefixes (the client resubmits with
        the prefix once pages free up)."""
        for slot in range(self.B):
            req = self._slot_req[slot]
            if req is None or self._pending_deact[slot]:
                continue
            # Capped at the page-table width: a slot at max_seq_len stops
            # on budget within the block. A speculative block feeds 1 +
            # draft_len rows a step, each writing KV; the device never
            # writes past len + remaining, so the slot's budget caps it.
            block_tokens = self.block_steps * (1 + self.spec_draft_len)
            remaining = max(1, req.max_new_tokens - len(self._slot_out[slot]))
            need = min(
                pages_needed(int(self._len[slot]) + min(block_tokens, remaining),
                             self.page_size),
                self.max_pages,
            )
            cur = len(self._slot_pages[slot])
            if need <= cur:
                continue
            got = self._alloc_pages(need - cur)
            if got is None:
                self.n_preempted += 1
                self._finish_slot(slot, hit_eos=False, interrupted=True)
                continue
            self._page_table[slot, cur:need] = got
            self._pt_dirty = True
            self._slot_pages[slot].extend(got)

    def _eos_set(self, req: Optional[GenRequest]) -> set:
        s = set(req.stop_token_ids) if req is not None else set()
        if self.eos_token_id is not None:
            s.add(self.eos_token_id)
        return s

    def _eos_mask_np(self, req: Optional[GenRequest] = None) -> np.ndarray:
        """[V] bool mask of stop-token columns."""
        mask = np.zeros((self.cfg.vocab_size,), bool)
        for t in self._eos_set(req):
            if 0 <= t < self.cfg.vocab_size:
                mask[t] = True
        return mask

    def _finish_host(self, req, out, lps, no_eos, interrupted, vstart):
        res = GenResult(
            qid=req.qid, output_ids=list(out), output_logprobs=list(lps),
            no_eos=no_eos, interrupted=interrupted, version_start=vstart,
            version_end=self.version, latency=time.monotonic() - req.submit_time,
        )
        self.total_generated += len(out)
        if req.done_cb:
            req.done_cb(res)

    def _finish_slot(self, slot: int, hit_eos: bool, interrupted: bool = False):
        req = self._slot_req[slot]
        self._finish_host(
            req, self._slot_out[slot], self._slot_lp[slot],
            no_eos=not hit_eos, interrupted=interrupted,
            vstart=self._slot_vstart[slot],
        )
        pages = self._slot_pages[slot]
        if pages:
            # Park the sequence's KV under its qid (budget permitting): the
            # covered tokens are the prompt plus the emitted tokens whose
            # K/V landed in the pool (_len excludes the pending input).
            covered = (list(req.input_ids) + self._slot_out[slot])[: int(self._len[slot])]
            # A pending weight swap invalidates this KV the moment it lands.
            if (self.prefix_cache_tokens and len(covered) >= self.page_size
                    and self._pending_params is None):
                old = self._prefix_cache.pop(req.qid, None)
                if old is not None:
                    self._allocator.free(old[1])
                    self._cached_tokens -= len(old[0])
                self._prefix_cache[req.qid] = (covered, pages)
                self._cached_tokens += len(covered)
                # The budget trim spares prefixes with a queued consumer
                # (only hard pool pressure takes them, in _alloc_pages).
                trim_pinned = self._pinned_qids()
                while (self._cached_tokens > self.prefix_cache_tokens
                       and self._evict_one_prefix(trim_pinned)):
                    pass
            else:
                self._allocator.free(pages)
        self._slot_req[slot] = None
        self._slot_out[slot] = []
        self._slot_lp[slot] = []
        self._slot_pages[slot] = []
        self._page_table[slot, :] = TRASH_PAGE
        self._pt_dirty = True
        # The device active mask may still have this slot on (host-side
        # stop, preemption, interrupt): deactivate before the next block
        # so its freed pages are never written again.
        self._pending_deact[slot] = True
        self._len[slot] = 0

    def _interrupt_all(self):
        for slot in range(self.B):
            if self._slot_req[slot] is not None:
                self._finish_slot(slot, hit_eos=False, interrupted=True)

    def _apply_pending_params(self):
        with self._lock:
            pending = self._pending_params
            version = self._pending_version
            self._pending_params = None
            self._pending_version = None
            # Commit the pinned version atomically with the pop.
            if pending is not None and version is not None:
                self._applied_pinned = max(self._applied_pinned, version)
        if pending is not None:
            # Parked prefixes hold KV computed under the old weights.
            self._flush_prefix_cache()
            t0 = time.monotonic()
            self.params = pending  # staged on the updater's thread
            self._refresh_qparams()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last_weight_swap_s = time.monotonic() - t0
            self.version = version if version is not None else self.version + 1
            # The tier holds KV of the old version: the spill thread
            # clears it (after the bump, so its version gate also drops
            # queued pre-swap items).
            if self.kv_tier is not None:
                self._tier_clear.set()
            logger.info(f"serving engine weights updated to v{self.version} "
                        f"in {self.last_weight_swap_s:.3f}s")
        self._interrupt.clear()

    def _flush_device_control(self):
        """Apply pending deactivations and page-table changes to the
        device (host->device copies, no device read)."""
        if self._pending_deact.any():
            active = self._dstate[2]
            active &= ~self._h2d(self._pending_deact)
            self._pending_deact[:] = False
        if self._pt_dev is None or self._pt_dirty:
            self._pt_dev = self._h2d(self._page_table)
            self._pt_dirty = False

    def _loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                with torch.cuda.stream(self._stream), torch.inference_mode():
                    self._serve()
            else:
                with torch.inference_mode():
                    self._serve()
        except Exception as e:  # serve-loop death must not strand clients
            self.fatal_error = e
            logger.exception("serving engine loop died: %s", e)
            self._fail_all(e)

    def _fail_all(self, exc: BaseException):
        """Deliver an error GenResult to every running and queued request
        so callers blocked on done_cb unwind instead of hanging."""
        msg = f"{type(exc).__name__}: {exc}"
        reqs = [r for r in self._slot_req if r is not None]
        self._slot_req = [None] * len(self._slot_req)
        reqs.extend(self._backlog)
        self._backlog.clear()
        self._backlog_len = 0
        seen = {id(r) for r in reqs}
        reqs.extend(e[1] for e in self._admit_inflight if id(e[1]) not in seen)
        self._admit_inflight.clear()
        with self._fatal_lock:
            while True:
                try:
                    reqs.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            self.queued_prompt_tokens = 0
            self._queued_qids.clear()
        for req in reqs:
            if req.done_cb:
                try:
                    req.done_cb(GenResult(
                        qid=req.qid, output_ids=[], output_logprobs=[],
                        no_eos=True, interrupted=True,
                        version_start=self.version, version_end=self.version,
                        latency=time.monotonic() - req.submit_time, error=msg,
                    ))
                except Exception:
                    logger.exception("done_cb failed during _fail_all")

    def _serve(self):
        self._ensure_pool()
        # Columns of the packed block result: a speculative block emits up
        # to 1 + draft_len tokens a step.
        n = self.block_steps * (1 + self.spec_draft_len)
        while not self._stop.is_set():
            # Handoff export / import and tier commands (loop-owned state).
            self._drain_cmds()
            # Off-thread telemetry snapshots of loop-only state.
            self._backlog_len = len(self._backlog)
            self._kv_pages_free = self._allocator.n_free
            now_lap = time.monotonic()
            if now_lap - self._parked_snap_t > 0.2:
                self._parked_qids = {q: len(e[0]) for q, e in self._prefix_cache.items()}
                self._parked_snap_t = now_lap
            if self._interrupt.is_set():
                self._interrupt_all()
                self._apply_pending_params()
            # Prefill/decode interleave: admission (prefill on this
            # thread) every decode_blocks_per_admit blocks, or when idle.
            if (self._blocks_since_admit >= self.decode_blocks_per_admit
                    or not any(r is not None for r in self._slot_req)):
                self._admit()
            if not any(r is not None for r in self._slot_req):
                # idle: apply updates immediately, then wait for work
                if self._pending_params is not None:
                    self._apply_pending_params()
                time.sleep(0.002)
                self.n_running = 0
                continue
            self._ensure_pages()
            self._flush_device_control()
            running = [r is not None for r in self._slot_req]
            if not any(running):
                continue
            self.n_running = sum(running)
            self.n_used_tokens = int(self._len.sum())

            (lengths, next_input, active, remaining, min_remaining,
             temps, top_ps, top_ks, greedy) = self._dstate
            # The warp tier for the running slots, from the host copies
            # (no device read). The reference re-picks it every step; here
            # a slot finishing inside the block keeps its tier for the
            # rest of the block, which is the same warp up to the sort
            # tier's rounded tail (ops/sampling.warp_logits).
            tier = select_tier(self._host_tp, self._host_tk, np.asarray(running),
                               self.cfg.vocab_size)
            t_blk0 = time.monotonic()
            if self.spec_draft_len > 0:
                (packed, lengths, next_input, active, remaining,
                 min_remaining) = paged_spec_decode_block(
                    self._decode_params, self.cfg, self._k_pages, self._v_pages,
                    self._pt_dev, lengths, next_input, active, remaining,
                    min_remaining, temps, top_ps, top_ks, greedy,
                    self._eos_global, self._gen, self._history,
                    n_steps=self.block_steps, draft_len=self.spec_draft_len,
                    ngram=self.spec_ngram, ngram_window=self.spec_window, tier=tier,
                )
            else:
                (packed, lengths, next_input, active, remaining,
                 min_remaining) = paged_decode_block(
                    self._decode_params, self.cfg, self._k_pages, self._v_pages,
                    self._pt_dev, lengths, next_input, active, remaining,
                    min_remaining, temps, top_ps, top_ks, greedy,
                    self._eos_global, self._gen, n_steps=n, tier=tier,
                )
            self._dstate = (lengths, next_input, active, remaining,
                            min_remaining, temps, top_ps, top_ks, greedy)
            p = packed.cpu().numpy()  # the block's single device fetch
            self._blocks_since_admit += 1
            self.decode_blocks += 1
            t_blk1 = time.monotonic()
            toks_h = p[:, :n]
            lps_h = p[:, n:2 * n]
            n_emitted = p[:, 2 * n].astype(np.int64)
            # Inter-token latency: wall time since the slot's previous
            # token delivery, spread over the tokens this block emitted,
            # so admission stalls between blocks count against the slots
            # that waited through them.
            for slot in range(self.B):
                k = int(n_emitted[slot])
                if k > 0 and self._slot_req[slot] is not None:
                    t_prev = self._slot_emit_t[slot] or t_blk0
                    self.itl_hist.add((t_blk1 - t_prev) * 1000.0 / k, count=k)
                    self._slot_emit_t[slot] = t_blk1
            if self.spec_draft_len > 0:
                # The speculative block's extra column: steps each slot was
                # active, the yield's exact denominator.
                self._spec_emitted += int(n_emitted.sum())
                self._spec_steps += int(p[:, 2 * n + 4].sum())
            hit_eos_h = p[:, 2 * n + 1] > 0.5
            active_h = p[:, 2 * n + 2] > 0.5
            # Mirror lengths for occupied slots only: the device array is
            # never reset for freed slots.
            occupied = np.asarray([r is not None for r in self._slot_req], bool)
            self._len = np.where(occupied, p[:, 2 * n + 3].astype(np.int64), 0)
            for slot in range(self.B):
                req = self._slot_req[slot]
                if req is None:
                    continue
                k = int(n_emitted[slot])
                if k:
                    self._slot_out[slot].extend(toks_h[slot, :k].astype(np.int64).tolist())
                    self._slot_lp[slot].extend(lps_h[slot, :k].tolist())
                # Per-request extra stop tokens (beyond the global EOS set)
                # are enforced on the host: trim at the first occurrence
                # after the min_new_tokens floor.
                extra = set(req.stop_token_ids) - self._eos_set(None)
                if extra:
                    for j, t in enumerate(self._slot_out[slot]):
                        if j >= req.min_new_tokens and t in extra:
                            self._slot_out[slot] = self._slot_out[slot][: j + 1]
                            self._slot_lp[slot] = self._slot_lp[slot][: j + 1]
                            self._finish_slot(slot, hit_eos=True)
                            break
                    if self._slot_req[slot] is None:
                        continue
                if not active_h[slot]:
                    self._finish_slot(slot, hit_eos=bool(hit_eos_h[slot]))
        # drain on stop
        self._interrupt_all()
