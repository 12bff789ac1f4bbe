"""Remote verification clients (the port's copy of
``areal_tpu/functioncall/remote.py``).

Two clients live here:

- ``batch_verify``: the remote verifier service. With
  ``FUNCTIONCALL_SERVICE_DOMAIN`` set (e.g. "http://verifier:8080"),
  ``interfaces/reward.verify_all`` POSTs ``{domain}/{task}_verify`` with a
  JSON list of ``{"uid", "solution", "answer"/"test_cases"}`` and reads a
  list of ``{"uid", "success"}`` back, batched under a concurrency cap
  with retries. A payload whose verification fails for good scores False:
  a reward must never take the trainer down.
- ``ExecutorPoolClient``: the pooled reward-executor fleet
  (``system/reward_executor.py``). ``register_executor_pool`` installs one
  a process; the math grader's sympy path and ``ToolEnv``'s python tool
  then route their sandboxed work through it.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import env_registry, logging, name_resolve, names, rpc
from areal_tpu_torch.base.health import HealthRegistry

logger = logging.getLogger("functioncall.remote")

ENV_DOMAIN = "FUNCTIONCALL_SERVICE_DOMAIN"
DEFAULT_TIMEOUT_S = 60.0
MAX_RETRIES = 3
INITIAL_RETRY_S = 0.5
MAX_RETRY_S = 10.0
DEFAULT_CONCURRENCY = 256
DEFAULT_BATCH_SIZE = 64


def service_domain() -> Optional[str]:
    return os.environ.get(ENV_DOMAIN) or None


def remote_enabled() -> bool:
    return service_domain() is not None


async def _post_with_retries(session, url: str, batch: List[Dict],
                             timeout_s: float) -> List[Dict]:
    """One batch POST under the RPC policy: every failure is retryable,
    and exhaustion scores the whole batch False (an empty reply)."""
    import aiohttp

    async def attempt(attempt_timeout: float) -> List[Dict]:
        async with session.post(url, json=batch,
                                timeout=aiohttp.ClientTimeout(total=attempt_timeout)) as resp:
            if resp.status >= 500:
                raise OSError(f"server error {resp.status}")
            resp.raise_for_status()
            out = await resp.json()
            if not isinstance(out, list):
                raise ValueError(f"malformed response: {type(out)}")
            return out

    try:
        # No deadline: every attempt gets the full timeout_s, backoff on
        # top (a verifier answers to the trainer's patience).
        return await rpc.retry_async(
            attempt,
            policy=rpc.RetryPolicy(attempts=MAX_RETRIES + 1, backoff_base_s=INITIAL_RETRY_S,
                                   backoff_max_s=MAX_RETRY_S, attempt_timeout_s=timeout_s),
            retryable=(Exception,),
            what=f"verifier {url}",
        )
    except rpc.RpcError as e:
        logger.error(f"verifier batch failed permanently: {e!r}")
        return []


async def batch_verify_async(
    payloads: List[Dict[str, Any]],
    task: str,
    domain: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    concurrency: int = DEFAULT_CONCURRENCY,
    batch_size: int = DEFAULT_BATCH_SIZE,
) -> List[bool]:
    """Verify payloads against ``{domain}/{task}_verify`` in batches under a
    concurrency cap. Returns per-payload success in input order; failed or
    missing entries are False."""
    import aiohttp

    domain = domain or service_domain()
    assert domain, f"{ENV_DOMAIN} not configured"
    url = f"{domain.rstrip('/')}/{task}_verify"
    for i, p in enumerate(payloads):
        p.setdefault("uid", str(i))

    sem = asyncio.Semaphore(concurrency)
    results: Dict[str, bool] = {}

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=concurrency)) as session:

        async def one_batch(batch: List[Dict]):
            async with sem:
                out = await _post_with_retries(session, url, batch, timeout_s)
            for entry in out:
                if isinstance(entry, dict) and "uid" in entry:
                    results[str(entry["uid"])] = bool(entry.get("success"))

        batches = [payloads[i:i + batch_size] for i in range(0, len(payloads), batch_size)]
        await asyncio.gather(*[one_batch(b) for b in batches])

    return [results.get(str(p["uid"]), False) for p in payloads]


def batch_verify(payloads: List[Dict[str, Any]], task: str, domain: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> List[bool]:
    """Sync wrapper (called from the reward interface's thread)."""
    return asyncio.run(batch_verify_async(payloads, task, domain=domain, timeout_s=timeout_s))


# ----------------------------------------------------------------------
# Pooled reward-executor client (system/reward_executor.py)
# ----------------------------------------------------------------------


def _post_json_sync(url: str, payload: Dict[str, Any], timeout: float,
                    deadline: Optional[rpc.Deadline] = None) -> Any:
    """One POST attempt on the executor wire: 429 raises RpcShed (the
    retry loop floors its backoff on Retry-After), 5xx and connection
    errors a retryable OSError, other codes a terminal RpcError."""
    import urllib.error
    import urllib.request

    dl = deadline or rpc.Deadline.after(timeout)
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dl.headers({"Content-Type": "application/json"}), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        if e.code == 429:
            ra = e.headers.get("Retry-After") if e.headers else None
            raise rpc.RpcShed(url, float(ra or 1.0)) from e
        if e.code >= 500:
            raise OSError(f"{url}: server error {e.code}") from e
        raise rpc.RpcError(f"{url}: HTTP {e.code}") from e
    except urllib.error.URLError as e:
        raise OSError(f"{url}: {e.reason}") from e


class ExecutorPoolClient:
    """Client of the pooled reward-executor fleet.

    Discovery reads the health registry (members ``reward_executor/<id>``,
    whose payload carries the URL), with the ``names.reward_executor_url``
    records as the fallback, so a dead executor drops out of the candidate
    set within one staleness window. Submits round-robin over the live
    executors and fail over on connection errors and sheds through the
    retry loop; every retry discovers afresh and skips the executors that
    refused this submit's connection while another is listed, so a death
    mid-batch lands on a survivor even while the dead one's heartbeat is
    still fresh. When the retries run out, submit returns failed RESULTS
    and never raises: a reward must never take the trainer down."""

    def __init__(self, experiment_name: str, trial_name: str,
                 policy: Optional[rpc.RetryPolicy] = None):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self._registry = HealthRegistry(experiment_name, trial_name, prefix="reward_executor")
        self._policy = policy
        self._rr = 0
        self._lock = threading.Lock()
        self._cache: List[str] = []
        self._cache_ts = -1e9

    def discover(self, fresh: bool = False, max_age_s: float = 2.0) -> List[str]:
        """Live executor URLs, cached briefly so a hot grading path does
        not walk the registry every call; a failover retry passes
        ``fresh=True`` to look past a peer that just died."""
        now = time.monotonic()
        with self._lock:
            if not fresh and now - self._cache_ts < max_age_s:
                return list(self._cache)
        urls = self._discover_uncached()
        with self._lock:
            self._cache = list(urls)
            self._cache_ts = now
        return urls

    def _discover_uncached(self) -> List[str]:
        urls: List[str] = []
        for _m, rec in sorted(self._registry.snapshot().items()):
            u = rec.get("url")
            if u:
                urls.append(u)
        if not urls:
            root = names.reward_executor_url_root(self.experiment_name,
                                                  self.trial_name).rstrip("/")
            for key in sorted(name_resolve.find_subtree(root)):
                try:
                    urls.append(name_resolve.get(key))
                except name_resolve.NameEntryNotFoundError:
                    continue
        return urls

    def available(self) -> bool:
        return bool(self.discover())

    def submit(self, jobs: List[Dict[str, Any]], timeout_s: Optional[float] = None,
               deadline: Optional[rpc.Deadline] = None) -> List[Dict[str, Any]]:
        """Run a job batch on some live executor; results in job order."""
        if not jobs:
            return []
        timeout_s = timeout_s or env_registry.get_float("AREAL_REXEC_TIMEOUT_S")
        # The HTTP attempt must outlive the sandbox timeout of the slowest
        # wave of jobs across the pool, plus dispatch slack.
        http_timeout = timeout_s * max(1, len(jobs)) + 10.0
        policy = self._policy or rpc.default_policy(attempt_timeout_s=http_timeout)
        attempt_no = {"n": 0}
        # Executors that failed this submit (connection refused, 5xx).
        failed: set = set()

        def attempt(attempt_timeout: float) -> List[Dict[str, Any]]:
            attempt_no["n"] += 1
            urls = self.discover(fresh=attempt_no["n"] > 1)
            if not urls:
                raise OSError("no live reward executor")
            urls = [u for u in urls if u not in failed] or urls
            with self._lock:
                self._rr += 1
                url = urls[self._rr % len(urls)]
            try:
                out = _post_json_sync(url + "/rexec/submit",
                                      {"jobs": jobs, "timeout_s": timeout_s},
                                      attempt_timeout, deadline)
            except OSError:
                failed.add(url)
                raise
            results = out.get("results") if isinstance(out, dict) else None
            if not isinstance(results, list) or len(results) != len(jobs):
                raise ValueError("malformed executor reply")
            return results

        try:
            return rpc.retry_sync(attempt, policy=policy, deadline=deadline,
                                  what="rexec submit")
        except Exception as e:
            logger.error(f"executor pool submit failed permanently: {e!r}")
            return [{"ok": False, "error": f"executor unavailable: {e}"} for _ in jobs]


_executor_pool: Optional[ExecutorPoolClient] = None
_executor_pool_lock = threading.Lock()


def register_executor_pool(client: Optional[ExecutorPoolClient]):
    """Install (or clear, with None) the process-wide executor-pool
    client. The rollout worker registers one at start; the math grader and
    the tool env then route sandboxed work through it while an executor
    is live."""
    global _executor_pool
    with _executor_pool_lock:
        _executor_pool = client


def get_executor_pool() -> Optional[ExecutorPoolClient]:
    with _executor_pool_lock:
        return _executor_pool
