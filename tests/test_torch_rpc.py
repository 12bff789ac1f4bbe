"""Port parity of the RPC substrate (``areal_tpu_torch/base/rpc.py``).

Every case of the reference's own unit tests runs against both packages
(``mod`` is the reference's ``areal_tpu.base.rpc`` or the port's): the
deadline arithmetic and wire round trip, budget-derived attempt
timeouts, retry / backoff / shed semantics, the breaker state machine
and hedged reads, sync and async. Cases that repeat each other are one
parametrised test.

Beyond those, the two packages are held to each other exactly:

- seeded numpy event scripts (``allow`` / ``record`` / ``release_probe``
  / ``drop`` and clock steps) through both packages' ``CircuitBreaker``
  and ``BreakerBoard`` under a patched monotonic clock give equal
  states, snapshots, open peers and counters at every step;
- ``hedged_sync`` over legs with seeded delays and failures gives the
  same winner, result and counters in both packages (the delays sit on
  a 0.3 s grid and the hedges launch 0.1 s apart, so any two legs end
  at least 0.1 s apart, far more than thread start-up jitter).
"""

import asyncio
import threading
import time
import types

import numpy as np
import pytest

from areal_tpu.base import rpc as ref_rpc
from areal_tpu.base.wire_routes import DEADLINE_HEADER
from areal_tpu_torch.base import rpc as port_rpc

MODS = [pytest.param(ref_rpc, id="ref"), pytest.param(port_rpc, id="port")]


@pytest.fixture(params=MODS)
def mod(request):
    request.param.stats.reset()
    yield request.param
    request.param.stats.reset()


def test_port_header_is_the_reference_wire_rule():
    assert port_rpc.DEADLINE_HEADER == DEADLINE_HEADER
    assert port_rpc.RETRYABLE_DEFAULT == ref_rpc.RETRYABLE_DEFAULT
    assert asyncio.TimeoutError in port_rpc.RETRYABLE_DEFAULT
    assert port_rpc.RpcStats.FIELDS == ref_rpc.RpcStats.FIELDS
    assert (port_rpc.STATE_CLOSED, port_rpc.STATE_OPEN, port_rpc.STATE_HALF_OPEN) == (
        ref_rpc.STATE_CLOSED, ref_rpc.STATE_OPEN, ref_rpc.STATE_HALF_OPEN)


# -- Deadline -------------------------------------------------------------

def test_deadline_remaining_and_header_roundtrip(mod):
    d = mod.Deadline.after(5.0)
    assert 4.5 < d.remaining() <= 5.0
    assert not d.expired()
    hv = d.header_value()
    assert hv is not None
    back = mod.Deadline.from_headers({DEADLINE_HEADER: hv})
    assert back is not None
    assert abs(back.remaining() - d.remaining()) < 0.5


def test_deadline_headers_merge_and_unbounded(mod):
    d = mod.Deadline.after(2.0)
    h = d.headers({"Range": "bytes=0-1"})
    assert h["Range"] == "bytes=0-1" and DEADLINE_HEADER in h
    ub = mod.Deadline.unbounded()
    assert ub.headers() == {}
    assert ub.remaining() == float("inf")
    assert mod.Deadline.from_headers({}) is None
    assert mod.Deadline.from_header_value("junk") is None


def test_deadline_cap_never_extends(mod):
    d = mod.Deadline.after(0.5)
    assert d.cap(100.0).remaining() <= 0.5 + 1e-3
    widened = mod.Deadline.unbounded().cap(1.0)
    assert widened.bounded() and widened.remaining() <= 1.0 + 1e-3


def test_ensure_deadline_prefers_callers(mod):
    d = mod.Deadline.after(1.0)
    assert mod.ensure_deadline(d, 100.0) is d
    assert mod.ensure_deadline(None, 0.25).remaining() <= 0.25 + 1e-3


# -- RetryPolicy ----------------------------------------------------------

def test_attempt_timeout_clips_to_budget(mod):
    pol = mod.RetryPolicy(attempt_timeout_s=30.0)
    assert pol.attempt_timeout(None) == 30.0
    assert pol.attempt_timeout(mod.Deadline.after(2.0)) <= 2.0


def test_expired_deadline_short_circuits_before_first_attempt(mod):
    calls = []
    with pytest.raises(mod.RpcDeadlineExceeded):
        mod.retry_sync(lambda t: calls.append(t), policy=mod.default_policy(),
                       deadline=mod.Deadline.after(-1.0))
    assert calls == []
    snap = mod.stats.snapshot()
    assert snap["deadline_expired"] == 1 and snap["attempts"] == 0


def test_backoff_floors_on_retry_after_and_caps_on_deadline(mod):
    pol = mod.RetryPolicy(backoff_base_s=0.01, backoff_max_s=0.04)
    assert pol.backoff(1, retry_after=3.0) >= 3.0
    assert pol.backoff(1, retry_after=3.0, deadline=mod.Deadline.after(0.05)) <= 0.06
    pol0 = mod.RetryPolicy(backoff_base_s=0.1, backoff_max_s=10.0, jitter=0.0)
    assert pol0.backoff(3) == pytest.approx(0.4)  # exact but for float rounding


def test_policies_read_registered_knobs(mod, monkeypatch):
    monkeypatch.setenv("AREAL_RPC_ATTEMPTS", "7")
    monkeypatch.setenv("AREAL_RPC_REDISCOVERY_ATTEMPTS", "9")
    assert mod.default_policy().attempts == 7
    assert mod.default_policy(attempts=2).attempts == 2
    assert mod.rediscovery_policy().attempts == 9


def test_shed_backoff_ramps_and_jitters(mod):
    waits = {mod.shed_backoff(1, 1.0) for _ in range(16)}
    assert all(0.5 <= w <= 1.5 for w in waits)
    assert len(waits) > 1
    assert mod.shed_backoff(10, 1.0, cap=4.0) <= 4.0 * 1.5


@pytest.mark.parametrize("knobs", [
    {},
    {"AREAL_RPC_HEDGE": "0", "AREAL_RPC_HEDGE_DELAY_S": "0.75",
     "AREAL_RPC_BREAKER_FAILS": "2", "AREAL_RPC_BREAKER_COOLDOWN_S": "5"},
], ids=["defaults", "set"])
def test_hedge_and_breaker_knobs(mod, monkeypatch, knobs):
    for k in ("AREAL_RPC_HEDGE", "AREAL_RPC_HEDGE_DELAY_S", "AREAL_RPC_BREAKER_FAILS",
              "AREAL_RPC_BREAKER_COOLDOWN_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    board = mod.BreakerBoard()
    got = (mod.hedging_enabled(), mod.hedge_delay_s(), board.fail_threshold,
           board.cooldown_s)
    want = (True, 0.25, 5, 2.0) if not knobs else (False, 0.75, 2, 5.0)
    assert got == want


# -- retry loops ----------------------------------------------------------

def test_retry_sync_flaky_then_success(mod):
    fails = {"n": 0}

    def fn(timeout):
        if fails["n"] < 2:
            fails["n"] += 1
            raise OSError("flaky")
        return "ok"

    pol = mod.RetryPolicy(attempts=4, backoff_base_s=0.001, backoff_max_s=0.002)
    assert mod.retry_sync(fn, policy=pol) == "ok"
    snap = mod.stats.snapshot()
    assert snap["attempts"] == 3 and snap["retries"] == 2 and snap["failures"] == 0


def test_retry_sync_exhaustion_raises_with_cause(mod):
    def fn(timeout):
        raise ValueError("always")

    with pytest.raises(mod.RpcError) as ei:
        mod.retry_sync(fn, policy=mod.RetryPolicy(attempts=2, backoff_base_s=0.001,
                                                  backoff_max_s=0.002))
    assert isinstance(ei.value.__cause__, ValueError)
    assert mod.stats.snapshot()["failures"] == 1


def test_retry_sync_nonretryable_propagates(mod):
    def fn(timeout):
        raise KeyError("not transient")

    with pytest.raises(KeyError):
        mod.retry_sync(fn, policy=mod.RetryPolicy(attempts=3))


def test_retry_sync_shed_never_counts_as_breaker_failure(mod):
    board = mod.BreakerBoard(fail_threshold=1, cooldown_s=60.0)

    def fn(timeout):
        raise mod.RpcShed("peer", retry_after=0.001)

    with pytest.raises(mod.RpcError):
        mod.retry_sync(fn, policy=mod.RetryPolicy(attempts=2, backoff_base_s=0.001,
                                                  backoff_max_s=0.002),
                       peer="p1", board=board)
    assert board.breaker("p1").state() == mod.STATE_CLOSED


@pytest.mark.parametrize("outcome", ["shed", "nonretryable"])
def test_probe_slot_resolves_on_shed_and_nonretryable(mod, outcome):
    board = mod.BreakerBoard(fail_threshold=1, cooldown_s=0.02)
    board.record("p", ok=False)
    time.sleep(0.03)  # half-open by time

    if outcome == "shed":
        def fn(timeout):
            raise mod.RpcShed("p", retry_after=0.0)
        with pytest.raises(mod.RpcError):
            mod.retry_sync(fn, policy=mod.RetryPolicy(attempts=1), peer="p", board=board)
        # A probe answered 429: the peer is alive, the breaker closes.
        assert board.breaker("p").state() == mod.STATE_CLOSED
    else:
        def fn(timeout):
            raise KeyError("non-retryable application bug")
        with pytest.raises(KeyError):
            mod.retry_sync(fn, policy=mod.RetryPolicy(attempts=1), peer="p", board=board)
        assert board.allow("p")  # the slot was released, not leaked


def test_retry_sync_stops_at_open_breaker(mod):
    board = mod.BreakerBoard(fail_threshold=1, cooldown_s=60.0)
    board.record("p1", ok=False)

    def fn(timeout):
        raise AssertionError("must not be called: breaker is open")

    with pytest.raises(mod.BreakerOpen):
        mod.retry_sync(fn, policy=mod.RetryPolicy(attempts=3), peer="p1", board=board)


@pytest.mark.parametrize("first_error", [OSError("flaky"), asyncio.TimeoutError("slow")],
                         ids=["oserror", "asyncio_timeout"])
def test_retry_async_matches_sync_semantics(mod, first_error):
    calls = {"n": 0}

    async def fn(timeout):
        calls["n"] += 1
        if calls["n"] == 1:
            raise first_error
        return 42

    out = asyncio.run(mod.retry_async(fn, policy=mod.RetryPolicy(
        attempts=3, backoff_base_s=0.001, backoff_max_s=0.002)))
    assert out == 42 and calls["n"] == 2


def test_retry_async_breaker_gates_and_records(mod):
    board = mod.BreakerBoard(fail_threshold=2, cooldown_s=60.0)

    async def bad(timeout):
        raise OSError("down")

    with pytest.raises(mod.BreakerOpen):
        asyncio.run(mod.retry_async(bad, policy=mod.RetryPolicy(
            attempts=4, backoff_base_s=0.001, backoff_max_s=0.002), peer="p", board=board))
    assert board.open_peers() == ["p"]
    assert mod.stats.snapshot()["attempts"] == 2


# -- breaker state machine ------------------------------------------------

def test_breaker_opens_after_threshold_and_rejects(mod):
    br = mod.CircuitBreaker("p", fail_threshold=3, cooldown_s=60.0)
    for _ in range(2):
        br.record_failure()
    assert br.state() == mod.STATE_CLOSED and br.allow()
    br.record_failure()
    assert br.state() == mod.STATE_OPEN
    assert not br.allow()
    assert br.rejections == 1
    assert mod.stats.snapshot()["breaker_rejections"] == 1
    assert mod.stats.snapshot()["breaker_opens"] == 1


@pytest.mark.parametrize("probe_ok", [True, False], ids=["probe_closes", "probe_reopens"])
def test_breaker_half_open_single_probe(mod, probe_ok):
    br = mod.CircuitBreaker("p", fail_threshold=1, cooldown_s=0.02)
    br.record_failure()
    assert br.state() == mod.STATE_OPEN
    time.sleep(0.03)
    assert br.state() == mod.STATE_HALF_OPEN
    assert br.allow()
    assert not br.allow()  # exactly one caller wins the probe slot
    if probe_ok:
        br.record_success()
        assert br.state() == mod.STATE_CLOSED and br.allow()
    else:
        br.record_failure()
        assert br.state() == mod.STATE_OPEN and br.opens == 2
        snap = br.snapshot()
        assert snap["state"] == mod.STATE_OPEN and snap["opens"] == 2


def test_breaker_record_fed_reopens_without_allow(mod):
    board = mod.BreakerBoard(fail_threshold=1, cooldown_s=0.02)
    board.record("p", ok=False)
    assert board.open_peers() == ["p"]
    time.sleep(0.03)
    assert board.open_peers() == []  # half-open: probe traffic allowed
    board.record("p", ok=False)  # the probe failed
    assert board.open_peers() == ["p"]
    assert board.breaker("p").opens == 2
    br = board.breaker("p")
    opened_at = br._opened_at
    board.record("p", ok=False)  # inside the window: the clock stays
    assert br._opened_at == opened_at
    time.sleep(0.03)
    board.record("p", ok=True)
    assert br.state() == mod.STATE_CLOSED


def test_board_tracks_peers_independently_and_drops(mod):
    board = mod.BreakerBoard(fail_threshold=1, cooldown_s=60.0)
    board.record("a", ok=False)
    board.record("b", ok=True)
    assert board.open_peers() == ["a"]
    assert not board.allow("a") and board.allow("b")
    board.drop("a")
    assert board.open_peers() == []
    assert board.allow("a")  # a fresh breaker after the drop
    assert set(board.snapshot()) == {"a", "b"}


# -- hedged reads ---------------------------------------------------------

def test_hedged_sync_primary_wins_without_hedging(mod):
    out, idx = mod.hedged_sync([lambda: "fast", lambda: "never"], hedge_delay=5.0)
    assert (out, idx) == ("fast", 0)
    snap = mod.stats.snapshot()
    assert snap["hedges"] == 0 and snap["hedge_wins"] == 0


def test_hedged_sync_slow_primary_loses_no_double_count(mod):
    primary_done = threading.Event()

    def slow():
        time.sleep(0.25)
        primary_done.set()
        return "slow"

    out, idx = mod.hedged_sync([slow, lambda: "hedge"], hedge_delay=0.02)
    assert (out, idx) == ("hedge", 1)
    snap = mod.stats.snapshot()
    assert (snap["hedges"], snap["hedge_wins"], snap["hedge_cancelled"]) == (1, 1, 1)
    primary_done.wait(2.0)


def test_hedged_sync_failed_primary_launches_hedge_immediately(mod):
    t0 = time.monotonic()

    def bad():
        raise OSError("down")

    assert mod.hedged_sync([bad, lambda: "ok"], hedge_delay=30.0) == ("ok", 1)
    assert time.monotonic() - t0 < 5.0


def test_hedge_failures_counts_whole_races_once(mod):
    def ok():
        time.sleep(0.01)
        return b"x"

    def bad():
        raise OSError("leg down")

    assert mod.hedged_sync([bad, ok], hedge_delay=0.001) == (b"x", 1)
    assert mod.stats.snapshot()["hedge_failures"] == 0
    with pytest.raises(mod.RpcError):
        mod.hedged_sync([bad, bad], hedge_delay=0.001)
    snap = mod.stats.snapshot()
    assert snap["hedge_failures"] == 1 and snap["failures"] == 1


def test_hedged_sync_deadline_expires_mid_race(mod):
    with pytest.raises(mod.RpcDeadlineExceeded):
        mod.hedged_sync([lambda: time.sleep(5.0)], hedge_delay=0.01,
                        deadline=mod.Deadline.after(0.05))


def test_hedged_async_cancels_losers(mod):
    async def run():
        cancelled = asyncio.Event()

        async def slow():
            try:
                await asyncio.sleep(30.0)
                return "slow"
            except asyncio.CancelledError:
                cancelled.set()
                raise

        async def hedge():
            return "hedge"

        out = await mod.hedged_async([slow, hedge], hedge_delay=0.02)
        await asyncio.wait_for(cancelled.wait(), 2.0)
        return out

    assert asyncio.run(run()) == ("hedge", 1)
    snap = mod.stats.snapshot()
    assert snap["hedge_wins"] == 1 and snap["hedge_cancelled"] == 1


def test_hedged_async_all_fail(mod):
    async def bad():
        raise OSError("down")

    async def run():
        with pytest.raises(mod.RpcError):
            await mod.hedged_async([bad, bad], hedge_delay=0.01)

    asyncio.run(run())
    assert mod.stats.snapshot()["hedge_failures"] == 1


# -- the two packages against each other, exactly -------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _script(seed, n_steps=160):
    rng = np.random.default_rng(seed)
    peers = ["a", "b", "c"]
    out = []
    for _ in range(n_steps):
        op = rng.choice(["allow", "ok", "fail", "tick", "release", "drop", "state"],
                        p=[0.2, 0.12, 0.3, 0.25, 0.05, 0.03, 0.05])
        out.append((str(op), peers[int(rng.integers(3))], float(rng.choice([0.3, 1.0, 2.5]))))
    return out


def _run_script(mod, script, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic,
                                                           sleep=time.sleep))
    mod.stats.reset()
    board = mod.BreakerBoard(fail_threshold=2, cooldown_s=2.0)
    single = mod.CircuitBreaker("solo", fail_threshold=3, cooldown_s=1.0)
    trace = []
    for op, peer, dt in script:
        if op == "allow":
            res = (board.allow(peer), single.allow())
        elif op in ("ok", "fail"):
            board.record(peer, ok=(op == "ok"))
            (single.record_success if op == "ok" else single.record_failure)()
            res = None
        elif op == "tick":
            clock.t += dt
            res = None
        elif op == "release":
            board.breaker(peer).release_probe()
            single.release_probe()
            res = None
        elif op == "drop":
            board.drop(peer)
            res = None
        else:
            res = (board.breaker(peer).state(), single.state())
        trace.append((op, res, board.snapshot(), board.open_peers(), single.snapshot(),
                      mod.stats.snapshot()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_scripts_agree_exactly(seed, monkeypatch):
    """Tolerance: none. Every step's return value, board snapshot, open
    peers, lone breaker snapshot and counters are equal."""
    script = _script(seed)
    ref = _run_script(ref_rpc, script, monkeypatch)
    port = _run_script(port_rpc, script, monkeypatch)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"step {i} ({script[i]}) differs"
    # The scripts do exercise every state.
    states = {s["state"] for step in ref for s in step[2].values()}
    assert states == {"closed", "open", "half-open"}
    ref_rpc.stats.reset()
    port_rpc.stats.reset()


_GRID = 0.3
_HEDGE = 0.1


def _legs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 4))
    delays = rng.integers(0, 3, size=n) * _GRID
    fails = rng.random(n) < 0.3
    return [(float(d), bool(f)) for d, f in zip(delays, fails)]


def _race(mod, legs):
    mod.stats.reset()

    def leg(i, delay, fail):
        def fn():
            time.sleep(delay)
            if fail:
                raise OSError(f"leg {i} down")
            return f"leg{i}"
        return fn

    fns = [leg(i, d, f) for i, (d, f) in enumerate(legs)]
    try:
        out = mod.hedged_sync(fns, hedge_delay=_HEDGE)
    except mod.RpcError:
        out = "all-failed"
    time.sleep(max(d for d, _ in legs) + 0.05)  # let abandoned legs drain
    return out, mod.stats.snapshot()


@pytest.mark.parametrize("seed", range(6))
def test_hedged_sync_seeded_legs_agree(seed):
    """Tolerance: none. Same winner, result and counters in both
    packages (leg delays on a 0.3 s grid, hedges 0.1 s apart: no two
    legs end closer than 0.1 s, so no race is decided by jitter)."""
    legs = _legs(seed)
    ref = _race(ref_rpc, legs)
    port = _race(port_rpc, legs)
    assert ref == port, legs
    ref_rpc.stats.reset()
    port_rpc.stats.reset()
