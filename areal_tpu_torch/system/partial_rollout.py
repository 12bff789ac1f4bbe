"""Chunked, interruptible generation client (the port's copy of
``areal_tpu/system/partial_rollout.py``).

Generation is issued in chunks of at most `new_tokens_per_chunk` tokens,
so a weight update only ever discards one chunk of work; an unfinished
(interrupted or chunk-exhausted) request is rescheduled through the
gserver manager, possibly onto another server with newer weights, with
the accumulated prefix, keeping the first chunk's `version_start` and
the last one's `version_end`. A server that fails a request is reported
to the manager (`failed_server_url`) and the prefix retried elsewhere; a
429 is backpressure (`Retry-After`, jittered, its own budget); a manager
that stops answering is rediscovered through `addr_resolver`. Groups of
n samples per prompt are gathered into `BundledGenerationOutputs`. The
gateway's schedule headers and their resolver are not ported.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

import aiohttp

from areal_tpu_torch.api.model_api import (
    APIGenerateOutput,
    BundledGenerationOutputs,
    GenerationHyperparameters,
)
from areal_tpu_torch.base import logging, rpc, tracing

logger = logging.getLogger("partial_rollout")


class ServerFailure(RuntimeError):
    """A generation server failed a request (connection error or 5xx).

    Retryable: the accumulated prefix is resubmitted through the manager,
    which routes around the failed server after the client reports it."""

    def __init__(self, url: str, detail: str):
        super().__init__(f"generate failed on {url}: {detail}")
        self.url = url


class PartialRolloutManager:
    def __init__(
        self,
        manager_addr: str,
        new_tokens_per_chunk: int = 1 << 30,
        request_timeout: float = 300.0,
        max_retries: int = 8,
        retry_backoff_s: float = 0.05,
        addr_resolver=None,
    ):
        self.manager_addr = manager_addr
        self.new_tokens_per_chunk = max(1, new_tokens_per_chunk)
        self.request_timeout = request_timeout
        # Failover budget per sample: a dead server costs one retry (the
        # resubmission lands on a healthy one); the cap only aborts when
        # the fleet stays unroutable through the whole backoff ramp.
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        # Declared retry disciplines (base/rpc.py): the per-sample
        # failure policy keeps this client's historical ctor knobs; the
        # manager-rediscovery policy is the FLEET-WIDE one shared with
        # rollout_worker, so a manager blip has exactly one declared
        # budget instead of two private ones.
        self.policy = rpc.RetryPolicy(
            attempts=max(1, max_retries),
            backoff_base_s=retry_backoff_s,
            backoff_max_s=2.0,
            attempt_timeout_s=request_timeout,
        )
        self.mgr_policy = rpc.rediscovery_policy(
            backoff_base_s=retry_backoff_s
        )
        # Optional () -> current manager address. A restarted gserver
        # manager re-registers at a NEW address; in-flight samples follow
        # it instead of dying with their accumulated tokens.
        self._addr_resolver = addr_resolver
        self._session: Optional[aiohttp.ClientSession] = None
        # Session continuation state: member qid -> total tokens
        # (prompt + output) the fleet has already prefilled/generated
        # for that session. A continuation turn re-prefills only the
        # delta beyond this (the parked prefix KV covers the rest via
        # the manager's sticky-qid affinity), so multi-turn agents pay
        # per-turn deltas instead of whole-conversation re-prefills.
        self._session_prefix: Dict[str, int] = {}
        self._session_prefix_cap = 4096
        # Client-side prefill accounting (successful chunks only):
        # reprefill is what the fleet actually re-prefilled, full is the
        # session-blind counterfactual — the bench's re-prefill ratio is
        # their quotient. Plain ints mutated from this client's single
        # owning loop.
        self.reprefill_tokens_total = 0
        self.full_prefill_tokens_total = 0

    def _refresh_manager_addr(self):
        if self._addr_resolver is None:
            return
        try:
            addr = self._addr_resolver()
        except Exception:
            return
        if addr and addr != self.manager_addr:
            logger.warning(
                f"gserver manager moved {self.manager_addr} -> {addr}"
            )
            self.manager_addr = addr

    async def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.request_timeout)
            )
        return self._session

    async def close(self):
        if self._session and not self._session.closed:
            await self._session.close()

    def _backoff(self, attempt: int, sched: Optional[Dict] = None) -> float:
        """Declared-policy backoff (base/rpc.py): jittered exponential,
        a 503's retry_after hint floors the wait."""
        ra = float(sched.get("retry_after", 0.0)) if sched else None
        return self.policy.backoff(attempt, retry_after=ra)

    async def _schedule(self, meta: Dict) -> Dict:
        sess = await self._sess()
        headers = rpc.Deadline.after(self.request_timeout).headers()
        async with sess.post(
            f"{self.manager_addr}/schedule_request", json=meta,
            headers=headers,
        ) as r:
            return await r.json()

    async def _generate_one(
        self,
        qid: str,
        prompt_ids: List[int],
        gconfig: GenerationHyperparameters,
        continuation: bool = False,
    ) -> APIGenerateOutput:
        """Generate one sample, chunk by chunk, resubmitting with the
        accumulated prefix after interrupts (reference _run_gen:92,
        refresh_generation:181)."""
        with tracing.span(
            "gen.sample", qid=qid, prompt_len=len(prompt_ids),
            continuation=continuation,
        ):
            return await self._generate_one_impl(
                qid, prompt_ids, gconfig, continuation
            )

    async def _generate_one_impl(
        self,
        qid: str,
        prompt_ids: List[int],
        gconfig: GenerationHyperparameters,
        continuation: bool = False,
    ) -> APIGenerateOutput:
        acc_out: List[int] = []
        acc_lp: List[float] = []
        version_start = -1
        version_end = -1
        no_eos = True
        prev_url, prev_version = "", -1
        failed_url: Optional[str] = None
        retries = 0
        # 429 load-shedding is DELIBERATE backpressure, not a failure:
        # it gets its own (generous) budget, jittered backoff around the
        # server's Retry-After, and a shed hint to the manager (which
        # spills the session's affinity instead of evicting the server).
        shed_url: Optional[str] = None
        shed_ra_hint = 0.0
        n_shed = 0
        consec_shed = 0
        shed_budget = max(32, self.max_retries * 8)
        # Manager-unreachable is a CONTROL-PLANE condition with its own
        # (generous) budget: a manager restart/failover costs seconds
        # and every sample sees it at once — burning the per-sample
        # server-failure budget on it turned one manager blip into
        # fleet-wide aborted rollouts (and, through the failure
        # reports, spurious eviction pressure). Rediscovery runs
        # against the name_resolve key on every attempt, with jittered
        # backoff so thousands of workers don't hammer the successor
        # the instant it registers.
        mgr_fails = 0
        consec_mgr_fails = 0
        mgr_budget = self.mgr_policy.attempts
        # Interruption-cost accounting: any submission carrying an
        # already-accumulated prefix makes the server (re-)prefill
        # prompt+prefix under (possibly new) weights; prefix caching may
        # discount it server-side, so this is the upper bound the
        # re-prefill report quantifies.
        reprefill_tokens = 0
        n_interruptions = 0
        # Continuation turns: the session key already generated earlier
        # turns on the fleet, so only the tokens BEYOND the known prefix
        # (the previous turn's feedback / tool output) are re-prefill
        # work — the sticky-qid route lands on the server whose prefix
        # cache holds the rest. A session this client never saw gets the
        # conservative full-prompt accounting.
        known_len = (
            self._session_prefix.get(qid, 0) if continuation else 0
        )
        budget = gconfig.max_new_tokens
        sess = await self._sess()
        while budget > 0:
            try:
                sched = await self._schedule(
                    tracing.inject_into(
                        dict(
                            # Session key for the manager's prefix-
                            # affinity routing (the server's parked KV is
                            # keyed by this same qid).
                            qid=qid,
                            prompt_len=len(prompt_ids) + len(acc_out),
                            group_size=1,
                            new_token_budget=budget,
                            previous_server_url=prev_url,
                            previous_version=prev_version,
                            # Report the server the previous attempt died
                            # on, so the manager evicts it before routing
                            # this retry.
                            failed_server_url=failed_url,
                            # A server that shed us with 429: routed
                            # around for its Retry-After window, NOT
                            # evicted.
                            shed_server_url=shed_url,
                            shed_retry_after=shed_ra_hint,
                        )
                    )
                )
            except (aiohttp.ClientError, asyncio.TimeoutError) as e:
                # The manager itself blipped (or was restarted at a new
                # address): accumulated tokens must survive a control-
                # plane failure too. Retryable REDISCOVERY, never part
                # of the server-failure budget.
                mgr_fails += 1
                consec_mgr_fails += 1
                if mgr_fails > mgr_budget:
                    raise RuntimeError(
                        f"{qid}: gserver manager unreachable after "
                        f"{mgr_fails} attempts (last: {e!r})"
                    ) from e
                logger.warning(
                    f"{qid}: schedule_request failed ({e!r}); "
                    f"rediscovering manager "
                    f"({mgr_fails}/{mgr_budget})"
                )
                self._refresh_manager_addr()
                await asyncio.sleep(
                    self.mgr_policy.backoff(consec_mgr_fails)
                )
                continue
            consec_mgr_fails = 0
            failed_url = None
            shed_url, shed_ra_hint = None, 0.0
            if "url" not in sched:
                # 503: no healthy servers right now. Back off and retry —
                # the watchdog restarting a server or the health registry
                # readmitting one unblocks us.
                retries += 1
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"{qid}: no healthy generation servers after "
                        f"{self.max_retries} retries: {sched}"
                    )
                await asyncio.sleep(self._backoff(retries, sched))
                continue
            url, server_version = sched["url"], int(sched.get("version", -1))
            # Disaggregated pairing: the manager chose a decode server
            # for this chunk; the prefill server hands the KV off to it
            # and proxies the combined result back (docs/serving.md).
            decode_url = sched.get("decode_url")
            # Tiered-KV hint: a DIFFERENT server holds this session's
            # prefix — the routed server pulls it over the /kv plane
            # before admission instead of re-prefilling.
            kv_source = sched.get("kv_source")
            chunk = min(budget, self.new_tokens_per_chunk)
            # A resubmission carries the accumulated prefix: every token
            # of prompt+prefix is prefill work the server repeats. A
            # continuation's FIRST submission repeats only the turn
            # delta past the fleet-known session prefix.
            full_prefill = len(prompt_ids) + len(acc_out)
            if acc_out:
                chunk_reprefill = full_prefill
            elif continuation:
                chunk_reprefill = max(0, len(prompt_ids) - known_len)
            else:
                chunk_reprefill = 0
            # Manual span: reprefill_tokens is stamped only on the
            # SUCCESSFUL attempt, so the trace-derived re-prefill total
            # matches the client accounting below even when failed
            # attempts are retried. Created before the payload so the
            # server's span parents under THIS chunk (per-chunk server
            # attribution in the merged timeline), not the whole sample.
            chunk_span = tracing.start_span("gen.chunk", qid=qid, server=url)
            payload = tracing.inject_ctx_into(
                dict(
                    qid=qid,
                    decode_url=decode_url,
                    kv_source=kv_source,
                    input_ids=list(prompt_ids) + acc_out,
                    # Continuations/re-prefills admit ahead of fresh
                    # requests (engine priority class 0): their prefix
                    # pages are already paid for. Session continuations
                    # (multi-turn episodes) ride the same class — an
                    # in-flight episode beats a fresh prompt.
                    priority=0 if (acc_out or continuation) else 1,
                    gconfig=dict(
                        max_new_tokens=chunk,
                        min_new_tokens=max(
                            0, gconfig.min_new_tokens - len(acc_out)
                        ),
                        greedy=gconfig.greedy,
                        temperature=gconfig.temperature,
                        top_p=gconfig.top_p,
                        top_k=gconfig.top_k,
                        stop_token_ids=list(gconfig.stop_token_ids),
                    ),
                ),
                chunk_span.ctx if chunk_span is not None else None,
            )
            shed_ra: Optional[float] = None
            try:
                # Outermost deadline mint (base/rpc.py): the server and
                # every hop it makes on our behalf (decode pairing, KV
                # pulls) inherit this chunk's remaining budget.
                chunk_dl = rpc.Deadline.after(self.request_timeout)
                async with sess.post(
                    f"{url}/generate", json=payload,
                    headers=chunk_dl.headers(),
                ) as r:
                    if r.status == 429:
                        # Deliberate load-shedding, not a failure: honor
                        # Retry-After, tell the manager (shed hint, for
                        # spill routing), and keep the retry out of the
                        # failure budget.
                        try:
                            body = await r.json()
                        except Exception:
                            body = {}
                        shed_ra = float(
                            body.get("retry_after")
                            or r.headers.get("Retry-After")
                            or 1.0
                        )
                        if chunk_span is not None:
                            chunk_span.end(shed=True)
                    elif r.status != 200:
                        raise ServerFailure(
                            url, f"{r.status} {await r.text()}"
                        )
                    else:
                        out = await r.json()
                        # Success end INSIDE the try: the finally's
                        # failed=True end is then a no-op (ManualSpan.end
                        # is idempotent).
                        if chunk_span is not None:
                            chunk_span.end(
                                reprefill_tokens=chunk_reprefill,
                                # The counterfactual: what a session-
                                # blind client would have re-prefilled.
                                # The trace e2e asserts continuation
                                # deltas stay strictly below it.
                                full_prefill_tokens=full_prefill,
                                continuation=continuation,
                                n_tokens=len(out.get("output_ids") or []),
                            )
            except (
                ServerFailure, aiohttp.ClientError, asyncio.TimeoutError,
            ) as e:
                # Server died mid-request. Work already accumulated in
                # acc_out is NOT lost: the retry resubmits the full
                # prefix to whichever healthy server the manager picks
                # (same path as a weight-update interrupt).
                retries += 1
                if retries > self.max_retries:
                    raise
                failed_url = url
                prev_url, prev_version = "", -1  # sticky hint is dead
                logger.warning(
                    f"{qid}: generate attempt failed on {url} ({e!r}); "
                    f"retry {retries}/{self.max_retries}"
                )
                await asyncio.sleep(self._backoff(retries))
                continue
            finally:
                # Covers BaseException paths too (task cancellation mid
                # POST): the server may already have recorded a child
                # span under this id, so leaving it unrecorded would be
                # a zero-drop dangling parent — fatal to the validator.
                if chunk_span is not None:
                    chunk_span.end(failed=True)
            if shed_ra is not None:
                n_shed += 1
                consec_shed += 1
                if n_shed > shed_budget:
                    raise RuntimeError(
                        f"{qid}: load-shed {n_shed} times without "
                        f"progress (last Retry-After {shed_ra:.2f}s from "
                        f"{url}); fleet persistently overloaded"
                    )
                shed_url, shed_ra_hint = url, shed_ra
                tracing.event(
                    "gen.shed", qid=qid, server=url, retry_after=shed_ra
                )
                # Jittered backoff around the server's hint (plus a mild
                # exponential ramp on consecutive sheds): synchronized
                # retries from many workers would re-create the very
                # burst that tripped the watermark (rpc.shed_backoff is
                # the one declared client-shed discipline).
                await asyncio.sleep(rpc.shed_backoff(consec_shed, shed_ra))
                continue
            consec_shed = 0
            if version_start < 0:
                version_start = int(out.get("version_start", server_version))
            version_end = int(out.get("version_end", server_version))
            reprefill_tokens += chunk_reprefill
            self.reprefill_tokens_total += chunk_reprefill
            self.full_prefill_tokens_total += full_prefill
            if out.get("interrupted", False):
                n_interruptions += 1
                tracing.event(
                    "gen.interrupted", qid=qid, server=url,
                    acc_len=len(prompt_ids) + len(acc_out),
                )
            made_progress = len(out["output_ids"]) > 0
            acc_out.extend(int(t) for t in out["output_ids"])
            acc_lp.extend(float(x) for x in out["output_logprobs"])
            budget = gconfig.max_new_tokens - len(acc_out)
            prev_url, prev_version = url, version_end
            if not out.get("no_eos", True):
                no_eos = False
                break
            if not made_progress and not out.get("interrupted", False):
                # The server cannot extend this sequence (e.g. the prefix
                # hit its cache limit): stop instead of resubmitting the
                # identical request forever.
                logger.warning(
                    f"{qid}: server returned no progress at len "
                    f"{len(prompt_ids) + len(acc_out)}; truncating"
                )
                break
            # no_eos: either interrupted (resubmit under new weights) or the
            # chunk budget ran out (continue with the next chunk).
            if budget <= 0:
                break
        # The fleet now holds prompt+output KV for this session key; a
        # continuation turn built on top pays only its delta. Bounded:
        # evict oldest entries past the cap (insertion-ordered dict).
        self._session_prefix.pop(qid, None)
        self._session_prefix[qid] = len(prompt_ids) + len(acc_out)
        while len(self._session_prefix) > self._session_prefix_cap:
            self._session_prefix.pop(
                next(iter(self._session_prefix))
            )
        return APIGenerateOutput(
            qid=qid,
            prompt_ids=list(prompt_ids),
            input_ids=list(prompt_ids),
            output_ids=acc_out,
            output_logprobs=acc_lp,
            no_eos=no_eos,
            version_start=version_start,
            version_end=version_end,
            reprefill_tokens=reprefill_tokens,
            n_interruptions=n_interruptions,
        )

    async def generate_group(
        self,
        qid: str,
        prompt_ids: List[int],
        gconfig: GenerationHyperparameters,
        continuation: bool = False,
    ) -> BundledGenerationOutputs:
        """n samples for one prompt, concurrently. ``continuation=True``
        marks a follow-up turn of a session this manager generated
        earlier (same qid): members keep their qid-stable session keys
        (``{qid}/{i}``), admit at priority 0, and account only the turn
        delta as re-prefill."""
        outs = await asyncio.gather(
            *[
                self._generate_one(
                    f"{qid}/{i}", prompt_ids, gconfig, continuation
                )
                for i in range(gconfig.n)
            ]
        )
        for o in outs:
            o.qid = qid  # group members share the prompt's qid
        return BundledGenerationOutputs.from_api_outputs(list(outs))
