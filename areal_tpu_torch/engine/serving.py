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

Not ported yet: KV tier / handoff / export, speculative decoding, int8
weights, mesh / tensor parallelism, the staged cutover of the weight
plane and the env knobs.
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
from areal_tpu_torch.base.latency import LatencyHistogram, percentile_from_counts
from areal_tpu_torch.engine.paged import (
    TRASH_PAGE,
    PageAllocator,
    _chunk_prefill_body,
    paged_decode_block,
    pages_needed,
    scatter_prefill,
)
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import forward, lm_head
from areal_tpu_torch.ops.sampling import select_tier, warp_sample

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
    """A param tree (tensors or numpy arrays) on ``device``; each leaf keeps
    its dtype, or takes the matching leaf's dtype in ``like``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, like[k] if like is not None else None)
                for k, v in tree.items()}
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
        prefill_token_budget: Optional[int] = None,
        decode_blocks_per_admit: int = 1,
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
        # Prefixes evicted while their KV was valid (no tier to spill to).
        self._kv_lost_evict = 0
        # Off-thread snapshots of loop-only state, refreshed every lap.
        self._backlog_len = 0
        self._kv_pages_free = self._allocator.n_free

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=60)

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
        lacks read their disabled values: MoE, speculative decoding and
        the KV export / import / spill / restore counters 0.0, and no
        ``kv_tier_*`` keys (no tier). The decode control state lives on
        the device between blocks, so ``decode_resident`` reads 1.0."""
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
            "last_weight_cutover_s": 0.0,
            "prefix_cache_hits": float(self.prefix_cache_hits),
            "prefix_tokens_reused": float(self.prefix_tokens_reused),
            "prefix_cached_tokens": float(self._cached_tokens),
            "total_requests": float(self.total_requests),
            "kv_export_total": 0.0,
            "kv_export_bytes": 0.0,
            "last_kv_export_ms": 0.0,
            "kv_import_total": 0.0,
            "kv_import_bytes": 0.0,
            "last_kv_import_ms": 0.0,
            "kv_spill_total": 0.0,
            "kv_spill_bytes": 0.0,
            "kv_spill_tokens": 0.0,
            "kv_restore_total": 0.0,
            "kv_restore_host": 0.0,
            "kv_restore_disk": 0.0,
            "kv_restore_tokens": 0.0,
            "kv_prefix_lost_total": float(self._kv_lost_evict),
            "spec_tokens_per_step": 0.0,
            "spec_emitted_tokens": 0.0,
            "spec_active_steps": 0.0,
        }

    # ------------------------------------------------------------------
    # Engine-thread internals
    # ------------------------------------------------------------------

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

    def _evict_one_prefix(self, pinned: Optional[set] = None, lost: bool = True) -> bool:
        """Free the least-recently-used parked prefix, skipping qids in
        ``pinned`` (a request for them is queued). With no tier to spill
        to, evicting valid KV counts as a prefix loss; ``lost=False`` is
        the weight-swap flush, whose KV is stale anyway. Returns False
        when nothing (unpinned) is evictable."""
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
        if lost:
            self._kv_lost_evict += 1
        self._allocator.free(pages)
        self._cached_tokens -= len(toks)
        return True

    def _flush_prefix_cache(self):
        while self._evict_one_prefix(lost=False):
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
            # on budget within the block.
            remaining = max(1, req.max_new_tokens - len(self._slot_out[slot]))
            need = min(
                pages_needed(int(self._len[slot]) + min(self.block_steps, remaining),
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
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.last_weight_swap_s = time.monotonic() - t0
            self.version = version if version is not None else self.version + 1
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
        n = self.block_steps
        while not self._stop.is_set():
            # Off-thread telemetry snapshots of loop-only state.
            self._backlog_len = len(self._backlog)
            self._kv_pages_free = self._allocator.n_free
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
            (packed, lengths, next_input, active, remaining,
             min_remaining) = paged_decode_block(
                self.params, self.cfg, self._k_pages, self._v_pages,
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
