"""The port's pooled reward executor and its client against the
reference's (``areal_tpu/system/reward_executor.py``,
``areal_tpu/functioncall/remote.py``).

The same jobs go to a port pool and a reference pool and come back with
the same results; the same ``/rexec/submit`` bodies to a port service and
a reference service, with the same replies, 429 sheds and ``/metrics``
line names; a port client drives a reference executor and a reference
client a port executor over one name_resolve root; a port client fails
over from a port executor armed to die (``rexec.die``). The sandbox
worker of the port imports no ``torch`` and names no module of the JAX
package, and its sympy jobs run inside its memory limit.
"""

import ast
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from areal_tpu.base import name_resolve as jname_resolve
from areal_tpu.functioncall import remote as jremote
from areal_tpu.system import reward_executor as jrexec
from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.functioncall import remote
from areal_tpu_torch.system import reward_executor as rexec

pytestmark = pytest.mark.serial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JOBS = [
    {"kind": "python", "code": "import sys; print(int(sys.stdin.read()) * 2)", "stdin": "21"},
    {"kind": "python", "code": "print(6 * 7)"},
    {"kind": "python", "code": "raise SystemExit(0)"},
    {"kind": "python", "code": "raise SystemExit(3)"},
    {"kind": "sympy_equal", "a": "x + x", "b": "2*x"},
    {"kind": "sympy_equal", "a": "x + 1", "b": "x + 2"},
    {"kind": "sympy_equal", "a": "1/2", "b": "0.5"},
    {"kind": "nonsense"},
]


@pytest.fixture(scope="module")
def pools():
    t, j = rexec.WorkerPool(n_workers=1), jrexec.WorkerPool(n_workers=1)
    yield t, j
    t.close()
    j.close()


@pytest.mark.parametrize("i", range(len(JOBS)))
def test_job_results_match_reference(pools, i):
    t, j = pools
    got = t.submit([JOBS[i]], timeout_s=60.0)[0]
    want = j.submit([JOBS[i]], timeout_s=60.0)[0]
    assert got == want


def test_failed_python_job_matches_reference(pools):
    t, j = pools
    got = t.submit([{"kind": "python", "code": "1/0"}])[0]
    want = j.submit([{"kind": "python", "code": "1/0"}])[0]
    assert got["ok"] is want["ok"] is False
    assert got["stdout"] == want["stdout"] == ""
    assert "ZeroDivisionError" in got["stderr"] and "ZeroDivisionError" in want["stderr"]


def test_ping_and_batch_shape_match_reference(pools):
    t, j = pools
    got = t.submit([{"kind": "ping"}] * 3)
    want = j.submit([{"kind": "ping"}] * 3)
    assert [sorted(r) for r in got] == [sorted(r) for r in want] == [["ok", "pid", "reuse"]] * 3
    # One warm worker served all three: the same pid, rising reuse.
    assert len({r["pid"] for r in got}) == 1
    assert [r["reuse"] for r in got] == sorted(r["reuse"] for r in got)


def test_warm_reuse_keeps_the_same_worker():
    p = rexec.WorkerPool(n_workers=1)
    try:
        r1, r2 = p.submit([{"kind": "ping"}])[0], p.submit([{"kind": "ping"}])[0]
        assert r1["pid"] == r2["pid"] and r2["reuse"] == r1["reuse"] + 1
        assert p.counters["warm_hits"] == 2 and p.counters["worker_respawns"] == 0
        assert p.submit([{"kind": "python", "code": "1/0"}])[0]["ok"] is False
        # A failed job is a result: the worker survives it.
        assert p.submit([{"kind": "ping"}])[0]["pid"] == r1["pid"]
        assert p.counters["job_failures"] == 1 and p.counters["worker_respawns"] == 0
    finally:
        p.close()


def test_timeout_kills_and_respawns():
    p = rexec.WorkerPool(n_workers=1)
    try:
        pid = p.submit([{"kind": "ping"}])[0]["pid"]
        t0 = time.monotonic()
        res = p.submit([{"kind": "python", "code": "import time; time.sleep(60)"}],
                       timeout_s=0.5)[0]
        assert time.monotonic() - t0 < 10.0
        assert res == {"ok": False, "error": "timeout", "timeout": True}
        assert p.counters["timeouts"] == 1 and p.counters["worker_respawns"] == 1
        fresh = p.submit([{"kind": "ping"}])[0]
        assert fresh["ok"] and fresh["pid"] != pid and fresh["reuse"] == 1
    finally:
        p.close()


def test_rlimit_contains_an_oversized_allocation():
    p = rexec.WorkerPool(n_workers=1, mem_mb=128)
    try:
        res = p.submit([{"kind": "python", "code": "x = bytearray(1 << 30)"}])[0]
        assert res["ok"] is False and "MemoryError" in res["stderr"]
        assert p.submit([{"kind": "ping"}])[0]["ok"]
    finally:
        p.close()


def test_case_fault_comes_back_as_a_failed_result():
    p = rexec.WorkerPool(n_workers=1)
    faults.reset()
    faults.arm("rexec.case", "raise")
    try:
        res = p.submit([{"kind": "ping"}])[0]
        assert res["ok"] is False and "case fault" in res["error"]
        assert p.submit([{"kind": "ping"}])[0]["ok"]
    finally:
        faults.reset()
        p.close()


# ----------------------------------------------------------------------
# The sandbox program
# ----------------------------------------------------------------------


def test_worker_source_names_no_jax_package_module():
    tree = ast.parse(rexec._WORKER_SOURCE)
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "areal_tpu_torch.functioncall.math_grader" in mods
    assert not [m for m in mods if m.split(".")[0] in ("areal_tpu", "jax", "torch")], mods
    assert "areal_tpu." not in rexec._WORKER_SOURCE


def test_sympy_job_in_a_real_worker_loads_no_torch():
    """The worker imports the port's grader under its 1024 MiB RLIMIT_AS:
    the package's __init__ imports torch lazily, so the sympy job runs
    and the worker holds no torch."""
    p = rexec.WorkerPool(n_workers=1)
    try:
        assert p.mem_mb == 1024
        eq = p.submit([{"kind": "sympy_equal", "a": "1/2", "b": "0.5"}], timeout_s=60.0)[0]
        assert eq == {"ok": True, "equal": True}
        probe = p.submit([{"kind": "python", "code": (
            "import sys, os\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'areal_tpu')))\n"
            "print('areal_tpu_torch.functioncall.math_grader' in sys.modules)\n"
            "print(repr(os.environ.get('CUDA_VISIBLE_DEVICES')))")}])[0]
        assert probe["ok"], probe
        assert probe["stdout"].splitlines() == ["[]", "True", "''"]
    finally:
        p.close()


# ----------------------------------------------------------------------
# The HTTP service, both packages
# ----------------------------------------------------------------------


def _post(url, payload, headers=None, timeout=60.0):
    req = urllib.request.Request(url + "/rexec/submit", json.dumps(payload).encode(),
                                 {"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _metrics(url):
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    return dict((k, float(v)) for k, v in (line.split() for line in text.splitlines() if line))


@pytest.fixture
def services():
    name_resolve.reconfigure("memory")
    jname_resolve.reconfigure("memory")
    t = rexec.RewardExecutorService("rexec-ut", "t0", executor_id=0, n_workers=1, queue_max=2)
    j = jrexec.RewardExecutorService("rexec-ut", "t0", executor_id=0, n_workers=1, queue_max=2)
    urls = t.start(), j.start()
    yield urls
    t.stop()
    j.stop()


def test_submit_bodies_health_and_metrics_match_reference(services):
    turl, jurl = services
    body = {"jobs": [{"kind": "python", "code": "print(7)"},
                     {"kind": "sympy_equal", "a": "2*y", "b": "y + y"}], "timeout_s": 60.0}
    assert _post(turl, body) == _post(jurl, body)
    with urllib.request.urlopen(turl + "/health", timeout=10) as r:
        th = json.loads(r.read())
    with urllib.request.urlopen(jurl + "/health", timeout=10) as r:
        jh = json.loads(r.read())
    assert th == jh == {"status": "ok", "workers_alive": 1}
    tm, jm = _metrics(turl), _metrics(jurl)
    assert list(tm) == list(jm) == [
        "areal:rexec_jobs_total", "areal:rexec_job_failures", "areal:rexec_timeouts",
        "areal:rexec_shed_total", "areal:rexec_queue_depth", "areal:rexec_workers_alive",
        "areal:rexec_worker_respawns", "areal:rexec_warm_hits"]
    assert tm["areal:rexec_jobs_total"] == jm["areal:rexec_jobs_total"] == 2


def test_expired_deadline_and_overload_shed_with_retry_after(services):
    for url in services:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"jobs": [{"kind": "ping"}]}, headers={"X-Areal-Deadline": "0"})
        assert ei.value.code == 429 and ei.value.headers.get("Retry-After") == "0"
        # Past the watermark (queue_max=2) the service sheds at once.
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"jobs": [{"kind": "ping"}] * 3})
        assert ei.value.code == 429 and ei.value.headers.get("Retry-After") == "1"
        assert json.loads(ei.value.read())["error"] == "overloaded"
        assert _metrics(url)["areal:rexec_shed_total"] == 2


def test_concurrent_slow_batches_shed():
    name_resolve.reconfigure("memory")
    svc = rexec.RewardExecutorService("rexec-sat", "t0", executor_id=0, n_workers=1, queue_max=2)
    url = svc.start()
    slow = {"kind": "python", "code": "import time; time.sleep(0.3); print(1)"}
    codes = []

    def fire():
        try:
            codes.append(_post(url, {"jobs": [slow, slow]})[0])
        except urllib.error.HTTPError as e:
            codes.append(e.code)

    try:
        ts = [threading.Thread(target=fire) for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert 200 in codes and 429 in codes, codes
        assert _metrics(url)["areal:rexec_shed_total"] == codes.count(429)
    finally:
        svc.stop()


@pytest.mark.parametrize("server_pkg", ["reference", "port"])
def test_client_of_one_package_drives_the_executor_of_the_other(tmp_path, server_pkg):
    """One name_resolve root: the service registers its URL record and
    heartbeat under the reference's keys, which the other package's
    client discovers."""
    root = str(tmp_path / "nr")
    name_resolve.reconfigure("nfs", record_root=root)
    jname_resolve.reconfigure("nfs", record_root=root)
    svc_mod, client_mod = (jrexec, remote) if server_pkg == "reference" else (rexec, jremote)
    svc = svc_mod.RewardExecutorService("rexec-x", "t0", executor_id=3, n_workers=1)
    url = svc.start()
    try:
        client = client_mod.ExecutorPoolClient("rexec-x", "t0")
        assert client.discover() == [url]
        got = client.submit(JOBS[:2] + JOBS[4:7], timeout_s=60.0)
        want = svc.pool.submit(JOBS[:2] + JOBS[4:7], timeout_s=60.0)
        assert got == want and all(r["ok"] for r in got)
    finally:
        svc.stop()
        name_resolve.reconfigure("memory")
        jname_resolve.reconfigure("memory")


def _spawn_executor(idx, exp, trial, nr_root, extra_env=None):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               AREAL_HEALTH_TTL="2")
    env.update(extra_env or {})
    return subprocess.Popen(
        [sys.executable, "-m", "areal_tpu_torch.system.reward_executor", "--experiment", exp,
         "--trial", trial, "--index", str(idx), "--workers", "1", "--name-resolve-root",
         nr_root],
        env=env, cwd=REPO, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)


def test_client_fails_over_when_an_executor_dies(tmp_path, monkeypatch):
    """Two port executors as processes, executor 0 armed to die on its
    first submit: the client's retries discover afresh and land every
    batch on the survivor, with no failed result."""
    monkeypatch.setenv("AREAL_HEALTH_TTL", "2")
    nr_root = str(tmp_path / "nr")
    name_resolve.reconfigure("nfs", record_root=nr_root)
    exp, trial = "rexec-chaos", "t0"
    procs = [_spawn_executor(0, exp, trial, nr_root, {"AREAL_FAULTS": "rexec.die=die"}),
             _spawn_executor(1, exp, trial, nr_root)]
    try:
        deadline, urls = time.monotonic() + 60, {}
        while len(urls) < 2 and time.monotonic() < deadline:
            for i in range(2):
                try:
                    urls[i] = name_resolve.get(names.reward_executor_url(exp, trial, str(i)))
                except name_resolve.NameEntryNotFoundError:
                    pass
            time.sleep(0.1)
        assert len(urls) == 2, "executors never registered"
        client = remote.ExecutorPoolClient(exp, trial)
        for k in range(2):
            res = client.submit([{"kind": "python", "code": f"print({k} + 40)"}],
                                timeout_s=20.0)[0]
            assert res["ok"] and res["stdout"] == f"{k + 40}\n", res
        assert procs[0].wait(timeout=30) == 1
        assert procs[1].poll() is None
        assert client.submit([{"kind": "ping"}])[0]["ok"]
        assert _metrics(urls[1])["areal:rexec_jobs_total"] >= 3
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        name_resolve.reconfigure("memory")


def test_exhausted_retries_return_failed_results(tmp_path):
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    try:
        from areal_tpu_torch.base import rpc

        client = remote.ExecutorPoolClient("nobody", "t0", policy=rpc.RetryPolicy(
            attempts=2, backoff_base_s=0.01, backoff_max_s=0.01, attempt_timeout_s=1.0))
        res = client.submit([{"kind": "ping"}, {"kind": "ping"}])
        assert [r["ok"] for r in res] == [False, False]
        assert all("executor unavailable" in r["error"] for r in res)
    finally:
        name_resolve.reconfigure("memory")


def test_shed_floors_the_retry_backoff():
    """A 429 raises RpcShed; the retry loop sleeps at least its
    Retry-After and tries again, as the reference's loop does."""
    from areal_tpu.base import rpc as jrpc
    from areal_tpu_torch.base import rpc

    for mod in (rpc, jrpc):
        calls = []

        def attempt(timeout, mod=mod):
            calls.append(time.monotonic())
            if len(calls) == 1:
                raise mod.RpcShed("peer", 0.2)
            return "ok"

        assert mod.retry_sync(attempt, policy=mod.RetryPolicy(
            attempts=2, backoff_base_s=0.001, backoff_max_s=0.001)) == "ok"
        assert calls[1] - calls[0] >= 0.2


def test_grader_routes_sympy_through_a_registered_pool(monkeypatch):
    """math_grader._sympy_equal asks the pool when one is registered and
    live, and falls back to the local child when the pooled job fails."""
    from areal_tpu_torch.functioncall import math_grader

    seen = []

    class Pool:
        def __init__(self, result):
            self.result = result

        def available(self):
            return True

        def submit(self, jobs, timeout_s=None):
            seen.append(jobs)
            return [self.result]

    try:
        remote.register_executor_pool(Pool({"ok": True, "equal": True}))
        assert math_grader._sympy_equal("x", "y") is True  # the pool's verdict
        remote.register_executor_pool(Pool({"ok": False, "error": "down"}))
        assert math_grader._sympy_equal("x + x", "2*x") is True  # the local child
        assert math_grader._sympy_equal("x", "y") is False
        assert [j[0]["kind"] for j in seen] == ["sympy_equal"] * 3
    finally:
        remote.register_executor_pool(None)


def test_retries_skip_executors_that_refused_this_submit():
    """Two dead executors listed beside a live one (their heartbeats still
    fresh), eight threads submitting at once: each submit's retries skip
    the executors that refused it, so three attempts always reach the
    live one, however the threads interleave on the round-robin."""
    import socket

    from areal_tpu_torch.base import rpc

    dead = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            dead.append(f"http://127.0.0.1:{s.getsockname()[1]}")
    name_resolve.reconfigure("memory")
    svc = rexec.RewardExecutorService("rexec-skip", "t0", executor_id=0, n_workers=2)
    live = svc.start()
    try:
        client = remote.ExecutorPoolClient("rexec-skip", "t0", policy=rpc.RetryPolicy(
            attempts=3, backoff_base_s=0.001, backoff_max_s=0.001, attempt_timeout_s=30.0))
        client.discover = lambda fresh=False, max_age_s=2.0: [dead[0], live, dead[1]]
        results = []

        def fire(k):
            results.append(client.submit([{"kind": "python", "code": f"print({k})"}])[0])

        ts = [threading.Thread(target=fire, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sorted(r["stdout"] for r in results) == [f"{k}\n" for k in range(8)]
    finally:
        svc.stop()
