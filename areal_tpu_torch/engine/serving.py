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

Not in this slice (later ones): prefix cache, KV tier / handoff /
export, speculative decoding, int8 weights, mesh / tensor parallelism,
tracing, fault points, latency histograms and the env knobs.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch import resolve_device, torch_dtype
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
    # resolved by the engine loop:
    done_cb: Optional[Callable[["GenResult"], None]] = None
    submit_time: float = 0.0


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
    """Slot-pool continuous-batching engine driven by a background thread."""

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
        kv_cache_dtype: Optional[str] = None,
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
        # paged decode step instead of the batched packed forward.
        self.prefill_chunk = prefill_chunk
        self.chunked_prefill_per_lap = chunked_prefill_per_lap
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

        self._slot_req: List[Optional[GenRequest]] = [None] * B
        self._slot_out: List[List[int]] = [[] for _ in range(B)]
        self._slot_lp: List[List[float]] = [[] for _ in range(B)]
        self._slot_vstart: List[int] = [0] * B
        self._slot_pages: List[List[int]] = [[] for _ in range(B)]

        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        self._backlog: List[GenRequest] = []  # engine-thread only
        # The batch inside _admit_impl, reachable by _fail_all.
        self._admit_inflight: List[Tuple[int, GenRequest, int, List[int]]] = []
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
        self.decode_blocks = 0  # decode blocks run (the loop's lap count)

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
            self._queue.put(req)

    def update_params(self, params, allow_interrupt: bool = True,
                      version: Optional[int] = None):
        """Swap weights at the next block boundary. With allow_interrupt,
        running requests are interrupted and returned partially; without
        it, admission pauses and the swap happens once running requests
        drain. ``version`` pins the new weight version to the trainer's.

        The host->device copy runs HERE, on the caller's thread (leaves
        keep the live params' dtypes), so decoding continues while the
        weights stream in; the serve loop's swap is a pointer flip.
        Concurrent callers are serialized, and a pinned update not newer
        than the highest pinned version staged is dropped."""
        with self._stage_lock:
            if version is not None and version <= self._highest_pinned:
                logger.info(f"dropping stale weight update v{version} "
                            f"(highest pinned v{self._highest_pinned})")
                if allow_interrupt:
                    with self._lock:
                        if self._pending_params is not None:
                            self._interrupt.set()
                return
            with self._lock:
                # Never stack staged copies: drop a not-yet-applied one
                # first (its pinned version never went live).
                if self._pending_params is not None and self._pending_version is not None:
                    self._highest_pinned = self._applied_pinned
                self._pending_params = None
                self._pending_version = None
            staged = _to_device(params, self.device, like=self.params)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            with self._lock:
                self._pending_params = staged
                self._pending_version = version
                if version is not None:
                    self._highest_pinned = max(self._highest_pinned, version)
        if allow_interrupt:
            self._interrupt.set()

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

    def _takes_chunked_path(self, plen: int) -> bool:
        return bool(self.prefill_chunk and plen > self.prefill_chunk)

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _chunked_prefill_one(self, input_ids: List[int], pages: List[int]):
        """Prefill one prompt chunk by chunk into its pages; returns the
        float32 [V] logits of its last token."""
        C = self.prefill_chunk
        self._ensure_pool()
        prow = np.full((self.max_pages,), TRASH_PAGE, np.int32)
        prow[: len(pages)] = pages
        prow_dev = self._h2d(prow)
        last = None
        for s0 in range(0, len(input_ids), C):
            seg = input_ids[s0: s0 + C]
            toks = np.zeros((C,), np.int32)
            toks[: len(seg)] = seg
            last = _chunk_prefill_body(
                self.params, self.cfg, self._h2d(toks), self._k_pages,
                self._v_pages, prow_dev, s0, len(seg),
            )
        return last

    def _admit(self):
        """Fill free slots from the backlog with one batched prefill (and
        chunked prefills for long prompts) and one device state update."""
        batch = self._admit_inflight
        batch.clear()
        self._admit_impl(batch)
        batch.clear()  # the requests now live in _slot_req

    def _admit_impl(self, batch):
        # A pending non-interrupting swap stops admission so running
        # requests drain and the swap can land.
        if self._pending_params is not None:
            return
        self._drain_queue()
        free = self._free_slots()
        n_chunked = 0
        while free and self._backlog and len(batch) < self.prefill_max_batch:
            req = self._backlog[0]
            plen = len(req.input_ids)
            if self._takes_chunked_path(plen) and n_chunked >= self.chunked_prefill_per_lap:
                break
            if plen + req.max_new_tokens > self.S:
                req.max_new_tokens = max(0, self.S - plen)
            if plen >= self.S or req.max_new_tokens == 0:
                self._backlog.pop(0)
                self._finish_host(req, [], [], no_eos=True, interrupted=False,
                                  vstart=self.version)
                continue
            n_need = pages_needed(plen, self.page_size)
            if n_need > self.n_pages - 1:
                # The prompt alone exceeds the whole pool: reject now
                # instead of blocking everything behind it forever.
                self._backlog.pop(0)
                logger.warning(f"rejecting {req.qid}: prompt needs {n_need} "
                               f"pages, pool has {self.n_pages - 1}")
                self._finish_host(req, [], [], no_eos=True, interrupted=False,
                                  vstart=self.version)
                continue
            # Reserve through the first decode block, so a fresh admit is
            # not preempted before it produces a block.
            n_reserve = pages_needed(plen + self.block_steps, self.page_size)
            n_reserve = min(n_reserve, self.max_pages, self.n_pages - 1)
            pages = self._allocator.alloc(n_reserve)
            if pages is None:
                break  # pool pressure: wait for frees
            self._backlog.pop(0)
            batch.append((free.pop(0), req, plen, pages))
            if self._takes_chunked_path(plen):
                n_chunked += 1
        if not batch:
            return
        # Chunked entries first so logits rows stay aligned with `batch`.
        long = [e for e in batch if self._takes_chunked_path(e[2])]
        short = [e for e in batch if not self._takes_chunked_path(e[2])]
        batch[:] = long + short
        rows = [self._chunked_prefill_one(req.input_ids, pages)
                for _, req, _, pages in long]
        if short:
            pad = _round_up(max(p for _, _, p, _ in short), self.page_size)
            ids = np.zeros((len(short), pad), np.int32)
            lens = np.zeros((len(short),), np.int32)
            for i, (_, req, plen, _) in enumerate(short):
                ids[i, :plen] = req.input_ids
                lens[i] = plen
            short_logits, k_pref, v_pref = _prefill_batch(
                self.params, self.cfg, self._h2d(ids), self._h2d(lens))
            # Pages past a row's prompt (first-block headroom) get decode
            # writes later; prompt padding chunks go to the trash page.
            n_chunks = pad // self.page_size
            flat = np.full((len(short), n_chunks), TRASH_PAGE, np.int32)
            for i, (_, _, plen_i, pages) in enumerate(short):
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

        adm = []  # (slot, plen, tok, budget, min_remaining, temp, top_p, top_k, greedy)
        for i, (slot, req, plen, pages) in enumerate(batch):
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
            # first decode step writes the first token's K/V at plen.
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

    def _ensure_pages(self):
        """Grow each active slot's pages to cover the next decode block;
        preempt (interrupt-partial) the slot itself when the pool is dry
        (the client resubmits with the prefix once pages free up)."""
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
            got = self._allocator.alloc(need - cur)
            if got is None:
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
        if req.done_cb:
            req.done_cb(res)

    def _finish_slot(self, slot: int, hit_eos: bool, interrupted: bool = False):
        req = self._slot_req[slot]
        self._finish_host(
            req, self._slot_out[slot], self._slot_lp[slot],
            no_eos=not hit_eos, interrupted=interrupted,
            vstart=self._slot_vstart[slot],
        )
        if self._slot_pages[slot]:
            self._allocator.free(self._slot_pages[slot])
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
            self.params = pending  # staged on the updater's thread
            self.version = version if version is not None else self.version + 1
            logger.info(f"serving engine weights updated to v{self.version}")
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
        seen = {id(r) for r in reqs}
        reqs.extend(e[1] for e in self._admit_inflight if id(e[1]) not in seen)
        self._admit_inflight.clear()
        with self._fatal_lock:
            while True:
                try:
                    reqs.append(self._queue.get_nowait())
                except queue.Empty:
                    break
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
            if self._interrupt.is_set():
                self._interrupt_all()
                self._apply_pending_params()
            self._admit()
            if not any(r is not None for r in self._slot_req):
                # idle: apply updates immediately, then wait for work
                if self._pending_params is not None:
                    self._apply_pending_params()
                time.sleep(0.002)
                continue
            self._ensure_pages()
            self._flush_device_control()
            running = [r is not None for r in self._slot_req]
            if not any(running):
                continue

            (lengths, next_input, active, remaining, min_remaining,
             temps, top_ps, top_ks, greedy) = self._dstate
            # The warp tier for the running slots, from the host copies
            # (no device read). The reference re-picks it every step; here
            # a slot finishing inside the block keeps its tier for the
            # rest of the block, which is the same warp up to the sort
            # tier's rounded tail (ops/sampling.warp_logits).
            tier = select_tier(self._host_tp, self._host_tk, np.asarray(running),
                               self.cfg.vocab_size)
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
            self.decode_blocks += 1
            toks_h = p[:, :n]
            lps_h = p[:, n:2 * n]
            n_emitted = p[:, 2 * n].astype(np.int64)
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
