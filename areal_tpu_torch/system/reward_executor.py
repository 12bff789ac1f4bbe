"""Pooled sandboxed reward-execution service (the port's copy of
``areal_tpu/system/reward_executor.py``).

Every sympy equivalence and python tool call of an agentic episode runs
in a sandbox; forking a fresh interpreter per case pays a cold start and
the imports each time. This service keeps:

- a pool of WARM worker subprocesses that apply the code_verify guard
  once at spawn (``RLIMIT_AS``, neutered ``os.system`` / ``fork`` / ...)
  and are then reused across jobs over a line-delimited JSON pipe;
- kill-on-timeout per job: an overrun or a crash costs one worker
  respawn, never the pool or the caller;
- an HTTP front (``POST /rexec/submit``, batched) with a bounded pending
  queue and 429 + ``Retry-After`` past the watermark;
- a heartbeat under ``health/reward_executor/<id>`` and a URL record at
  ``names.reward_executor_url``, so clients (``functioncall/remote.py``)
  discover executors, balance over them and fail over on a death;
- the reference's ``areal:rexec_*`` ``/metrics`` lines;
- the fault points ``rexec.case`` (one job fails in the sandbox) and
  ``rexec.die`` (the whole service dies), armable through ``AREAL_FAULTS``.

Job kinds on the wire (the reference's):

- ``{"kind": "python", "code": str, "stdin": str?}``: guarded exec,
  returns ``{"ok", "stdout", "stderr"}``;
- ``{"kind": "sympy_equal", "a": str, "b": str}``: sympy equivalence
  through the port's math grader, imported once a worker, returns
  ``{"ok", "equal"}``;
- ``{"kind": "ping"}``: worker identity, returns ``{"ok", "pid", "reuse"}``.

HTTP runs on the standard library's ``ThreadingHTTPServer``, as the port's
other servers do. A sandbox worker imports no ``torch`` (the package's
``__init__`` imports it lazily) and sees no card (``CUDA_VISIBLE_DEVICES``
is empty).

Run one: ``python -m areal_tpu_torch.system.reward_executor --experiment
<exp> --trial <trial> --index 0 --name-resolve-root <dir>``;
``--selftest`` spawns the pool, runs one job, probes ``/metrics`` and
exits 0 when all of it worked.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional

from areal_tpu_torch.base import env_registry, logging, name_resolve, names, network, rpc
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.base.health import Heartbeat

logger = logging.getLogger("reward_executor")

# The warm worker program, run as ``python -c``: applies the code_verify
# guard once at spawn, then loops jobs over stdin/stdout JSON lines. It
# is stdlib-only until a sympy job imports the grader (once a worker).
_WORKER_SOURCE = r"""
import io, json, os, sys, traceback

mem_bytes = int(os.environ.get("_REXEC_MEM_MB", "1024")) << 20
try:
    import resource
    resource.setrlimit(resource.RLIMIT_AS, (mem_bytes, mem_bytes))
except Exception:
    pass
# Neuter the escape hatches (code_verify guard, paid once per worker).
for _name in ("system", "popen", "execv", "execve", "execvp", "execvpe",
              "fork", "forkpty", "killpg"):
    if hasattr(os, _name):
        setattr(os, _name, None)

_reuse = 0
_sympy_equal_raw = None


def _run_python(job):
    out, err = io.StringIO(), io.StringIO()
    ns = {"__name__": "__rexec__"}
    stdin_data = job.get("stdin") or ""
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin_data)
    try:
        from contextlib import redirect_stdout, redirect_stderr
        with redirect_stdout(out), redirect_stderr(err):
            exec(compile(job.get("code") or "", "<rexec>", "exec"), ns)
        return {"ok": True, "stdout": out.getvalue(),
                "stderr": err.getvalue()}
    except SystemExit as e:
        ok = not e.code
        return {"ok": ok, "stdout": out.getvalue(),
                "stderr": err.getvalue() + (f"exit {e.code}" if not ok
                                            else "")}
    except BaseException:
        return {"ok": False, "stdout": out.getvalue(),
                "stderr": err.getvalue() + traceback.format_exc(limit=4)}
    finally:
        sys.stdin = old_stdin


def _run_sympy(job):
    global _sympy_equal_raw
    if _sympy_equal_raw is None:
        from areal_tpu_torch.functioncall.math_grader import _sympy_equal_raw as f
        _sympy_equal_raw = f
    try:
        return {"ok": True,
                "equal": bool(_sympy_equal_raw(job.get("a", ""),
                                               job.get("b", "")))}
    except BaseException:
        return {"ok": False, "equal": False,
                "stderr": traceback.format_exc(limit=2)}


for line in sys.stdin:
    line = line.strip()
    if not line:
        continue
    _reuse += 1
    try:
        job = json.loads(line)
        kind = job.get("kind")
        if kind == "python":
            res = _run_python(job)
        elif kind == "sympy_equal":
            res = _run_sympy(job)
        elif kind == "ping":
            res = {"ok": True, "pid": os.getpid(), "reuse": _reuse}
        else:
            res = {"ok": False, "stderr": f"unknown kind {kind!r}"}
    except BaseException:
        res = {"ok": False, "stderr": traceback.format_exc(limit=2)}
    sys.stdout.write(json.dumps(res, separators=(",", ":")) + "\n")
    sys.stdout.flush()
"""

# The directory that holds the areal_tpu_torch package.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _repo_pythonpath() -> str:
    existing = os.environ.get("PYTHONPATH", "")
    if _REPO_ROOT in existing.split(os.pathsep):
        return existing
    return _REPO_ROOT + (os.pathsep + existing if existing else "")


class _Worker:
    """One warm sandbox subprocess. Owned by at most one pool thread at a
    time (the pool hands workers out through a Queue), so run() needs no
    lock."""

    def __init__(self, mem_mb: int):
        self.mem_mb = mem_mb
        env = dict(os.environ)
        env["_REXEC_MEM_MB"] = str(mem_mb)
        env["PYTHONPATH"] = _repo_pythonpath()
        # The sandbox must never take the card.
        env["CUDA_VISIBLE_DEVICES"] = ""
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _WORKER_SOURCE],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            env=env,
            text=True,
        )
        self.jobs_served = 0

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self):
        try:
            self.proc.kill()
            self.proc.wait(timeout=5)
        except Exception:
            pass

    def run(self, job: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        """One job round trip; kills the worker at the wall timeout (the
        pool respawns it). The result always holds "ok"."""
        if not self.alive():
            return {"ok": False, "error": "worker dead"}
        fired = threading.Event()

        def _on_timeout():
            fired.set()
            self.kill()

        timer = threading.Timer(timeout_s, _on_timeout)
        timer.daemon = True
        timer.start()
        try:
            self.proc.stdin.write(json.dumps(job, separators=(",", ":")) + "\n")
            self.proc.stdin.flush()
            line = self.proc.stdout.readline()
        except Exception:
            line = ""
        finally:
            timer.cancel()
        if not line:
            # EOF on the job pipe: the worker is gone. Reap it here so the
            # pool's alive() check sees the death.
            try:
                self.proc.wait(timeout=5)
            except Exception:
                self.kill()
            if fired.is_set():
                return {"ok": False, "error": "timeout", "timeout": True}
            return {"ok": False, "error": "worker died"}
        self.jobs_served += 1
        try:
            return json.loads(line)
        except ValueError:
            return {"ok": False, "error": "garbled worker reply"}


class WorkerPool:
    """Warm worker fleet with kill-on-timeout and respawn.

    submit() is synchronous and thread-safe; the HTTP handler threads
    call it directly. Its counters back ``/metrics``."""

    def __init__(
        self,
        n_workers: Optional[int] = None,
        mem_mb: Optional[int] = None,
        max_reuse: Optional[int] = None,
        default_timeout_s: Optional[float] = None,
    ):
        self.n_workers = n_workers or env_registry.get_int("AREAL_REXEC_WORKERS")
        self.mem_mb = mem_mb or env_registry.get_int("AREAL_REXEC_MEM_MB")
        self.max_reuse = (max_reuse if max_reuse is not None
                          else env_registry.get_int("AREAL_REXEC_MAX_REUSE"))
        self.default_timeout_s = (default_timeout_s
                                  or env_registry.get_float("AREAL_REXEC_TIMEOUT_S"))
        self._free: "queue.Queue[_Worker]" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.counters: Dict[str, int] = {
            "jobs_total": 0,
            "job_failures": 0,
            "timeouts": 0,
            "worker_respawns": 0,
            "warm_hits": 0,
            "pending": 0,
        }
        self._workers: List[_Worker] = []
        for _ in range(self.n_workers):
            w = _Worker(self.mem_mb)
            self._workers.append(w)
            self._free.put(w)
        self._exec = ThreadPoolExecutor(max_workers=self.n_workers,
                                        thread_name_prefix="rexec-pool")

    def _incr(self, key: str, by: int = 1):
        with self._lock:
            self.counters[key] += by

    def workers_alive(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers if w.alive())

    def _replace(self, dead: _Worker) -> _Worker:
        dead.kill()
        fresh = _Worker(self.mem_mb)
        with self._lock:
            self.counters["worker_respawns"] += 1
            try:
                self._workers.remove(dead)
            except ValueError:
                pass
            self._workers.append(fresh)
        return fresh

    def submit_one(self, job: Dict[str, Any], timeout_s: Optional[float] = None
                   ) -> Dict[str, Any]:
        """Run one job on the next free warm worker; blocking."""
        timeout_s = timeout_s or self.default_timeout_s
        worker = self._free.get()
        try:
            try:
                # Chaos: one sandboxed case fails; it must come back as a
                # failed RESULT.
                faults.maybe_fail("rexec.case")
            except Exception as e:
                self._incr("jobs_total")
                self._incr("job_failures")
                return {"ok": False, "error": f"case fault: {e}"}
            was_warm = worker.jobs_served > 0 or worker.alive()
            res = worker.run(job, timeout_s)
            self._incr("jobs_total")
            if res.get("timeout"):
                self._incr("timeouts")
            if not res.get("ok"):
                self._incr("job_failures")
            elif was_warm:
                self._incr("warm_hits")
            return res
        finally:
            if not worker.alive() or (self.max_reuse and worker.jobs_served >= self.max_reuse):
                worker = self._replace(worker)
            self._free.put(worker)

    def _queued_one(self, job: Dict[str, Any], timeout_s: Optional[float]) -> Dict[str, Any]:
        try:
            return self.submit_one(job, timeout_s)
        finally:
            self._incr("pending", -1)

    def submit(self, jobs: List[Dict[str, Any]], timeout_s: Optional[float] = None
               ) -> List[Dict[str, Any]]:
        """Batched submit: jobs fan out over the free workers.

        ``pending`` counts from ENQUEUE, not from worker pickup: the
        service's watermark must see jobs still waiting in the fan-out
        backlog, or concurrent batches would stack up unseen and the 429
        shed would never fire."""
        self._incr("pending", len(jobs))
        if len(jobs) == 1:
            return [self._queued_one(jobs[0], timeout_s)]
        futs = [self._exec.submit(self._queued_one, j, timeout_s) for j in jobs]
        return [f.result() for f in futs]

    def pending(self) -> int:
        with self._lock:
            return self.counters["pending"]

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._exec.shutdown(wait=False)
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            w.kill()


def _reply(handler: BaseHTTPRequestHandler, status: int, body, headers=None,
           ctype: str = "application/json") -> None:
    data = (json.dumps(body) if ctype == "application/json" else body).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(data)))
    for k, v in (headers or {}).items():
        handler.send_header(k, v)
    handler.end_headers()
    try:
        handler.wfile.write(data)
    except (BrokenPipeError, ConnectionResetError):
        logger.debug(f"client left before the reply to {handler.command} {handler.path}")


class RewardExecutorService:
    """One pooled executor endpoint: HTTP front, warm pool and lease.

    The supervisor loop is the service's only heartbeat producer: a
    wedged service stops beating and clients fail over."""

    def __init__(
        self,
        experiment_name: str,
        trial_name: str,
        executor_id: int = 0,
        port: int = 0,
        n_workers: Optional[int] = None,
        queue_max: Optional[int] = None,
    ):
        self.experiment_name = experiment_name
        self.trial_name = trial_name
        self.executor_id = int(executor_id)
        self.member = f"reward_executor/{self.executor_id}"
        self.queue_max = queue_max or env_registry.get_int("AREAL_REXEC_QUEUE_MAX")
        self.pool = WorkerPool(n_workers=n_workers)
        self._port = port
        self._shed_lock = threading.Lock()
        self._shed_total = 0
        self.address: Optional[str] = None
        self._heartbeat: Optional[Heartbeat] = None
        self._httpd: Optional[network.OwnedHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._sup_thread: Optional[threading.Thread] = None
        faults.set_scope(self.member)

    # -- HTTP front ----------------------------------------------------

    def _dispatch(self, handler: BaseHTTPRequestHandler, method: str):
        path = handler.path.split("?", 1)[0]
        try:
            if method == "POST" and path == "/rexec/submit":
                return self._h_submit(handler)
            if method == "GET" and path == "/metrics":
                return _reply(handler, 200, self.metrics_text(),
                              ctype="text/plain; charset=utf-8")
            if method == "GET" and path == "/health":
                return _reply(handler, 200, {"status": "ok",
                                             "workers_alive": self.pool.workers_alive()})
            return _reply(handler, 404, {"error": f"no route {method} {path}"})
        except Exception as e:
            logger.exception(f"{method} {path} failed")
            return _reply(handler, 500, {"error": repr(e)})

    def _shed(self, handler, body: Dict[str, Any], retry_after: str):
        with self._shed_lock:
            self._shed_total += 1
        return _reply(handler, 429, body, headers={"Retry-After": retry_after})

    def _h_submit(self, handler: BaseHTTPRequestHandler):
        # Chaos: the whole service dies mid-flight (an armed `die`);
        # clients must fail over on the stale lease.
        faults.maybe_fail("rexec.die")
        n = int(handler.headers.get("Content-Length") or 0)
        d = json.loads(handler.rfile.read(n) or b"{}")
        jobs = d.get("jobs") or []
        deadline = rpc.Deadline.from_headers(handler.headers)
        if deadline is not None and deadline.expired():
            return self._shed(handler, {"error": "deadline expired", "retry_after": 0.0}, "0")
        if self.pool.pending() + len(jobs) > self.queue_max:
            # Bounded queue: shed instead of letting reward latency grow
            # without bound; the client fails over or backs off.
            return self._shed(handler, {"error": "overloaded", "retry_after": 0.5,
                                        "queue_depth": self.pool.pending()}, "1")
        timeout_s = d.get("timeout_s")
        if deadline is not None:
            timeout_s = min(timeout_s or self.pool.default_timeout_s,
                            max(0.1, deadline.remaining()))
        return _reply(handler, 200, {"results": self.pool.submit(jobs, timeout_s)})

    def metrics_text(self) -> str:
        c = dict(self.pool.counters)
        lines = [
            f"areal:rexec_jobs_total {c['jobs_total']}",
            f"areal:rexec_job_failures {c['job_failures']}",
            f"areal:rexec_timeouts {c['timeouts']}",
            f"areal:rexec_shed_total {self._shed_total}",
            f"areal:rexec_queue_depth {c['pending']}",
            f"areal:rexec_workers_alive {self.pool.workers_alive()}",
            f"areal:rexec_worker_respawns {c['worker_respawns']}",
            f"areal:rexec_warm_hits {c['warm_hits']}",
        ]
        return "\n".join(lines) + "\n"

    # -- lifecycle -----------------------------------------------------

    def _supervise(self):
        ttl = self._heartbeat.ttl if self._heartbeat else 10.0
        while not self._stop.wait(max(0.05, ttl / 3)):
            # Respawn crashed workers outside the job path, then beat:
            # the lease renews only while supervision runs.
            with self.pool._lock:
                dead = [w for w in self.pool._workers if not w.alive()]
            for w in dead:
                try:
                    self.pool._free.put(self.pool._replace(w))
                except Exception:
                    logger.warning("worker respawn failed", exc_info=True)
            if self._heartbeat is not None:
                self._heartbeat.beat()

    def start(self) -> str:
        host = network.gethostip()
        self._httpd = network.OwnedHTTPServer((host, self._port), self)
        self.address = f"http://{host}:{self._httpd.server_address[1]}"
        self._http_thread = threading.Thread(target=self._httpd.serve_forever,
                                             daemon=True, name="rexec-http")
        self._http_thread.start()
        name_resolve.add(
            names.reward_executor_url(self.experiment_name, self.trial_name,
                                      str(self.executor_id)),
            self.address, delete_on_exit=True, replace=True)
        self._heartbeat = Heartbeat(self.experiment_name, self.trial_name, self.member,
                                    payload={"url": self.address,
                                             "workers": self.pool.n_workers})
        self._sup_thread = threading.Thread(target=self._supervise, daemon=True,
                                            name="rexec-supervise")
        self._sup_thread.start()
        logger.info(f"reward executor {self.member} serving at {self.address} "
                    f"({self.pool.n_workers} warm workers)")
        return self.address

    def stop(self):
        self._stop.set()
        if self._heartbeat is not None:
            self._heartbeat.stop()
        try:
            name_resolve.delete(names.reward_executor_url(
                self.experiment_name, self.trial_name, str(self.executor_id)))
        except Exception:
            pass
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
        self.pool.close()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="pooled reward executor")
    p.add_argument("--experiment", default="rexec")
    p.add_argument("--trial", default="local")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--name-resolve-root", default=None)
    p.add_argument("--selftest", action="store_true",
                   help="spawn the pool, probe /metrics and one sandboxed job, tear "
                        "down; exit 0 iff healthy")
    args = p.parse_args(argv)
    if args.name_resolve_root:
        name_resolve.reconfigure("nfs", record_root=args.name_resolve_root)
    else:
        name_resolve.reconfigure("memory")
    svc = RewardExecutorService(args.experiment, args.trial, executor_id=args.index,
                                port=args.port, n_workers=args.workers)
    url = svc.start()
    if args.selftest:
        import urllib.request

        try:
            res = svc.pool.submit([{"kind": "python", "code": "print(6*7)"}],
                                  timeout_s=10.0)[0]
            assert res.get("ok") and "42" in res.get("stdout", ""), res
            policy = rpc.default_policy()
            probe_dl = rpc.Deadline.after(policy.attempt_timeout_s)
            with urllib.request.urlopen(url + "/metrics",
                                        timeout=policy.attempt_timeout(probe_dl)) as r:
                text = r.read().decode()
            assert "areal:rexec_jobs_total" in text, text
            print(f"rexec selftest ok: {url}")
            return 0
        except Exception as e:
            print(f"rexec selftest FAILED: {e}", file=sys.stderr)
            return 1
        finally:
            svc.stop()
    print(url, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        svc.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
