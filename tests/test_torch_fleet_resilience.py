"""The port's fleet survives what the reference's survives, on the CPU.

- **Breakers in routing.** A reference and a port gserver manager (each
  built by its own ``_configure`` over three server urls that nothing
  listens on) are fed the same seeded script of heartbeat records,
  client failure reports (``/schedule_request`` with
  ``failed_server_url``), health polls and breaker-clock steps; at every
  step their ``/schedule_request`` answers and their ``/status`` breaker
  board (``rpc.breakers``, ``rpc.open``), healthy and evicted sets are
  equal. Exact: no tolerance.
- **A server restarted at a new url.** In both managers a member that
  beats at a new address replaces its old url, starts evicted and is
  readmitted only once its weight re-sync succeeds (the re-sync is a
  stub that fails once); a member never seen before replaces an evicted
  url no live member claims; a stranger beyond the launch-time fleet is
  ignored.
- **Hedged chunk reads.** Both packages' ``ChunkStore`` fetch a dump from
  a slow, corrupt peer, a fast peer and the origin: the same bytes (the
  origin's), every byte from the fast peer, one hedge win each; the slow
  peer's late bytes never reach the buffer. With ``AREAL_RPC_HEDGE=0``
  the same fetch takes every chunk from the slow peer.
- **The slice.** ``main_async_ppo`` at 2 layers through the fleet
  variant of the chip phase: a server SIGKILLed mid-run with
  ``worker_restarts=1`` is restarted in place, moved, re-synced and
  serves again, and every step finishes; the reference's own
  ``run_experiment`` finishes the same run with the same kill.
"""

import asyncio
import json
import os
import time
import types
import uuid

import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu.api.system_api import GserverManagerConfig as RefManagerConfig
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import names as ref_names
from areal_tpu.base import rpc as ref_rpc
from areal_tpu.engine import weight_client as ref_wc
from areal_tpu.system import gserver_manager as rgm
from areal_tpu_torch.api.system_api import GserverManagerConfig
from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.base import rpc as port_rpc
from areal_tpu_torch.engine import weight_client as wc
from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config
from areal_tpu_torch.system import gserver_manager as tgm
from areal_tpu_torch.system import weight_plane as wp
from areal_tpu_torch.system import weight_transfer as wt

URLS = ["http://127.0.0.1:1", "http://127.0.0.1:2", "http://127.0.0.1:3"]
TRIAL = "t0"


class _Clock:
    def __init__(self):
        self.t = 5000.0

    def monotonic(self):
        return self.t


class _Request:
    def __init__(self, body):
        self._body = body

    async def json(self):
        return dict(self._body)


@pytest.fixture
def managers(tmp_path, monkeypatch):
    """One manager of each package over URLS, the breakers on a shared
    fake clock (2 failures open, 2 s cooldown)."""
    saved = ref_nr._default.repo, name_resolve._default.repo
    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    clock = _Clock()
    for mod in (ref_rpc, port_rpc):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic,
                                                               sleep=time.sleep))
    monkeypatch.setenv("AREAL_RPC_BREAKER_FAILS", "2")
    monkeypatch.setenv("AREAL_RPC_BREAKER_COOLDOWN_S", "2.0")
    run = uuid.uuid4().hex[:6]
    out = {}
    try:
        for side, cls, cfg_cls, nr, nm in (("ref", rgm.GserverManager, RefManagerConfig,
                                            ref_nr, ref_names),
                                           ("port", tgm.GserverManager, GserverManagerConfig,
                                            name_resolve, names)):
            exp = f"fleet-{side}-{run}"
            for u in URLS:
                nr.add_subentry(nm.gen_servers(exp, TRIAL), u)
            m = cls()
            # The launch-time fleet of both: the reference's elastic fleet
            # (runtime joins, the HA lease) is not ported.
            m.configure(cfg_cls(experiment_name=exp, trial_name=TRIAL, n_servers=len(URLS),
                                train_batch_size=4, max_head_offpolicyness=8,
                                elastic_fleet=False),
                        experiment_name=exp, trial_name=TRIAL, worker_name="gserver_manager")
            out[side] = types.SimpleNamespace(m=m, exp=exp, nr=nr, names=nm)
        out["clock"] = clock
        yield out
    finally:
        for side in ("ref", "port"):
            if side in out:
                out[side].m._exit_hook()
        ref_nr._default.repo.reset()
        name_resolve._default.repo.reset()
        ref_nr._default.repo, name_resolve._default.repo = saved


def _beat(env, member_urls, dead=()):
    """Write generation-server heartbeat records to both managers'
    registries: {member index: url}; members in ``dead`` beat 100 s ago."""
    for side in ("ref", "port"):
        e = env[side]
        for i, url in member_urls.items():
            rec = {"pid": 1000 + i, "url": url, "server_index": i, "role": "unified",
                   "draining": False, "ts": time.time() - (100.0 if i in dead else 0.0),
                   "ttl": 10.0}
            e.nr.add(e.names.health(e.exp, TRIAL, f"generation_server/{i}"), json.dumps(rec),
                     delete_on_exit=False, replace=True)


def _schedule(env, body):
    out = []
    for side in ("ref", "port"):
        resp = asyncio.run(env[side].m._h_schedule(_Request(body)))
        out.append((resp.status, json.loads(resp.text)))
    return out


def _status(env):
    out = []
    for side in ("ref", "port"):
        st = json.loads(asyncio.run(env[side].m._h_status(_Request({}))).text)
        out.append(dict(breakers=st["rpc"]["breakers"], open=st["rpc"]["open"],
                        healthy=st["healthy_servers"], evicted=st["evicted_servers"],
                        servers=st["servers"]))
    return out


def _poll(env):
    for side in ("ref", "port"):
        env[side].m._poll_health()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_managers_route_and_report_breakers_alike(managers, seed):
    """Tolerance: none; every answer and status is equal at every step."""
    env = managers
    rng = np.random.default_rng(seed)
    dead = set()
    _beat(env, dict(enumerate(URLS)))
    _poll(env)
    saw_open = False
    for step in range(120):
        op = rng.choice(["schedule", "fail", "tick", "poll", "die", "revive"],
                        p=[0.35, 0.25, 0.15, 0.15, 0.05, 0.05])
        if op == "schedule":
            body = {"qid": f"q{int(rng.integers(6))}", "prompt_len": 8, "new_token_budget": 8}
            ref, port = _schedule(env, body)
            assert ref == port, (step, op)
        elif op == "fail":
            body = {"qid": f"q{int(rng.integers(6))}", "prompt_len": 8,
                    "failed_server_url": URLS[int(rng.integers(3))]}
            ref, port = _schedule(env, body)
            assert ref == port, (step, op)
        elif op == "tick":
            env["clock"].t += float(rng.choice([0.5, 1.0, 2.5]))
        elif op == "poll":
            _beat(env, dict(enumerate(URLS)), dead)
            _poll(env)
        elif op == "die":
            dead.add(int(rng.integers(3)))
        else:
            dead.discard(int(rng.integers(3)))
        ref, port = _status(env)
        assert ref == port, (step, op)
        saw_open |= bool(port["open"])
    assert saw_open  # the script does open breakers


def test_open_breaker_is_routed_around_and_whole_fleet_fenced_routes(managers):
    env = managers
    _beat(env, dict(enumerate(URLS)))
    _poll(env)
    for _ in range(2):  # two client reports open URLS[0]'s breaker
        _schedule(env, {"qid": "", "failed_server_url": URLS[0]})
    _poll(env)  # readmitted by its heartbeat, but its breaker is open
    for ref, port in (_status(env),):
        assert ref == port and port["open"] == [URLS[0]] and URLS[0] in port["healthy"]
    routed = {port[1]["url"] for ref, port in (_schedule(env, {"qid": ""}) for _ in range(6))}
    assert routed == set(URLS[1:])
    for u in URLS[1:]:
        for _ in range(2):
            _schedule(env, {"qid": "", "failed_server_url": u})
    _poll(env)
    # Every server fenced: route anyway (advisory, never a second eviction).
    ref, port = _schedule(env, {"qid": ""})
    assert ref == port and port[0] == 200
    env["clock"].t += 2.5  # past the cooldown: half-open, routable again
    ref, port = _status(env)
    assert ref == port and port["open"] == []


def test_restarted_server_is_replaced_and_readmitted_after_resync(managers):
    env = managers
    _beat(env, dict(enumerate(URLS)))
    _poll(env)
    calls = {"ref": [], "port": []}
    for side in ("ref", "port"):
        m = env[side].m
        m.weight_version = 2
        for u in URLS:
            m._server_versions[u] = 2
        outcomes = iter([False, True, True, True])

        def stub(url, side=side, outcomes=outcomes):
            calls[side].append(url)
            return next(outcomes)

        m._bootstrap_server = stub
    new = "http://127.0.0.1:9"
    _beat(env, {0: URLS[0], 1: new, 2: URLS[2]})
    _poll(env)  # moved; the re-sync fails: stays evicted
    ref, port = _status(env)
    assert ref == port
    assert URLS[1] not in port["servers"] and new in port["servers"]
    assert new in port["evicted"] and new not in port["healthy"]
    for _ in range(6):
        ref, port = _schedule(env, {"qid": ""})
        assert ref == port and port[1]["url"] in (URLS[0], URLS[2])
    _poll(env)  # the re-sync succeeds: readmitted
    ref, port = _status(env)
    assert ref == port and new in port["healthy"] and not port["evicted"]
    assert calls["ref"] == calls["port"] == [new, new]
    routed = {port[1]["url"] for ref, port in (_schedule(env, {"qid": ""}) for _ in range(6))}
    assert routed == {URLS[0], new, URLS[2]}
    for side in ("ref", "port"):
        assert env[side].m._server_versions[new] == 0  # the stub re-synced nothing


def test_never_seen_member_replaces_an_evicted_url_and_strangers_are_ignored(managers):
    env = managers
    _beat(env, {0: URLS[0], 1: URLS[1]})  # member 2 died before it ever beat
    _poll(env)
    _schedule(env, {"qid": "", "failed_server_url": URLS[2]})  # a client evicts its url
    new = "http://127.0.0.1:10"
    _beat(env, {0: URLS[0], 1: URLS[1], 2: new, 5: "http://127.0.0.1:11"})
    _poll(env)
    ref, port = _status(env)
    assert ref == port
    assert port["servers"] == sorted([URLS[0], URLS[1], new])  # the joiner: ignored
    assert new in port["healthy"]  # version 0 is current: no re-sync needed


# ---------------------------------------------------------------------------
# Hedged chunk reads
# ---------------------------------------------------------------------------

CHUNK = 4096


class _SlowPeer(wp.PeerStoreServer):
    delay_s = 0.5

    def _h_chunk(self, headers, query):
        time.sleep(self.delay_s)
        return super()._h_chunk(headers, query)


@pytest.fixture
def plane(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((48, 64)).astype(np.float32),
            "b": {"x": rng.standard_normal((700,)).astype(np.float32)}}
    dump = str(tmp_path / "actor")
    wt.dump_raw_params(tree, dump, version=1, chunk_bytes=CHUNK)
    origin = wp.WeightPlaneSource(dump, CHUNK).start()
    man = wc.fetch_manifest(origin.address, version=1)
    fast, slow = wp.PeerStoreServer().start(), _SlowPeer().start()
    for peer in (fast, slow):
        peer.store = wc.ChunkStore(man)
        peer.store.fetch([origin.address], origin=origin.address, hedge=False)
    want = bytes(fast.store.buf)
    slow.store.buf[3] ^= 0xFF  # chunk 0 rots: the slow peer serves bad bytes late
    yield dict(origin=origin, fast=fast, slow=slow, man=man, want=want)
    for s in (origin, fast, slow):
        s.close()


@pytest.mark.parametrize("hedge", ["1", "0"])
def test_chunk_store_hedges_around_a_slow_peer_like_the_reference(plane, monkeypatch, hedge):
    monkeypatch.setenv("AREAL_RPC_HEDGE", hedge)
    monkeypatch.setenv("AREAL_RPC_HEDGE_DELAY_S", "0.05")
    p = plane
    if hedge == "0":
        _SlowPeer.delay_s = 0.0
        p["slow"].store.buf[3] ^= 0xFF  # heal it: the unhedged fetch stays on it
    got = {}
    try:
        for side, pkg, rpcmod in (("ref", ref_wc, ref_rpc), ("port", wc, port_rpc)):
            rpcmod.stats.reset()
            store = pkg.ChunkStore(p["man"])
            stats = store.fetch([p["slow"].address, p["fast"].address, p["origin"].address],
                                origin=p["origin"].address)
            time.sleep(2.0)  # the losing legs end (3 attempts at the corrupt chunk)
            got[side] = (bytes(store.buf), stats["bytes_from"], stats["bytes_from_origin"],
                         rpcmod.stats.snapshot()["hedge_wins"])
            rpcmod.stats.reset()
    finally:
        _SlowPeer.delay_s = 0.5
    total = p["man"]["total_bytes"]
    assert got["port"] == got["ref"]
    buf, frm, from_origin, wins = got["port"]
    assert buf == p["want"] and from_origin == 0
    if hedge == "1":
        assert frm == {p["fast"].address: total} and wins == 1
    else:
        assert frm == {p["slow"].address: total} and wins == 0


# ---------------------------------------------------------------------------
# The slice: main_async_ppo with a server killed mid-run
# ---------------------------------------------------------------------------

SLICE_SIZES = dict(n_prompts=32, prompt=(8, 32), train_batch_size=4, group=2,
                   max_new_tokens=16, offpolicy=1, steps=3, slots=8, max_seq_len=256,
                   row_len=256, max_tokens_per_mb=512, n_minibatches=2, words=60)
# One server: the run cannot finish until the killed server's successor
# serves, so gate (b) holds on any CPU load. The default heartbeat TTL:
# a loaded CPU can stall a server's poll loop past a short one's stale
# window, and the controller would take it for hung.
SLICE_FLEET = dict(chip_smoke.FLEET, servers=1, rollout_workers=1, restarts=1,
                   fail_server=None, kill_server=0, hang_worker=None, chunk_delay_s=None)


def _tiny_cfg():
    return r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                       head_dim=16, intermediate_dim=128, vocab_size=512,
                                       max_position_embeddings=4096)


def test_port_loop_finishes_every_step_with_a_server_killed():
    stats = chip_smoke.async_ppo_phase(torch, np.random.default_rng(0), torch.device("cpu"),
                                       _tiny_cfg(), 0, "cpu", sizes=SLICE_SIZES,
                                       fleet=SLICE_FLEET)
    assert stats["global_step"] == SLICE_SIZES["steps"]
    fleet = stats["fleet"]
    assert fleet["worker_restarts"] == [
        {"worker": "generation_server/0", "why": "process died", "attempt": 1}]
    restart = fleet["restart"]
    assert restart["new"] != restart["old"]
    assert restart["first_served_version"] >= restart["first_routed_at_version"]


# The reference's run, in a process of its own (its controller interrupts
# the main thread, and a run past its deadline is killed with it): the
# same prompts, tokenizer and HF weights, argv and kill as the port's.
_REF_RUN = r"""
import json, os, signal, sys, threading, time, urllib.request
sys.path.insert(0, os.getcwd())
from areal_tpu.api.cli_args import AsyncPPOMATHExpConfig, apply_overrides
from areal_tpu.base import health, name_resolve, names
from training.utils import run_experiment

argv, exp, trial, nr_root = json.loads(sys.argv[1])
seen = {}

def killer():
    registry = health.HealthRegistry(exp, trial)
    while "new_pid" not in seen:
        time.sleep(0.25)
        try:
            alive = registry.snapshot()
            mgr = name_resolve.get(names.gen_server_manager(exp, trial))
            with urllib.request.urlopen(mgr + "/status", timeout=5) as r:
                st = json.loads(r.read())
        except Exception:
            continue
        rec = alive.get("generation_server/0")
        if rec is None:
            continue
        if "pid" not in seen and st["rollout_stat"]["running"] >= 1:
            os.kill(int(rec["pid"]), signal.SIGKILL)
            seen["pid"] = int(rec["pid"])
        elif "pid" in seen and int(rec["pid"]) != seen["pid"]:
            seen["new_pid"] = int(rec["pid"])

cfg = apply_overrides(AsyncPPOMATHExpConfig(), argv)
name_resolve.reconfigure("nfs", record_root=nr_root)
threading.Thread(target=killer, daemon=True).start()
result = run_experiment("async-ppo-math", cfg)
print("RESULT " + json.dumps({"global_step": result["global_step"], **seen}), flush=True)
"""


def test_reference_loop_finishes_every_step_with_the_same_kill(tmp_path):
    import subprocess
    import sys

    rng = np.random.default_rng(0)
    hf_dir = str(tmp_path / "hf")
    words = chip_smoke.tiny_tokenizer(rng, hf_dir, SLICE_SIZES["words"])
    chip_smoke.seeded_hf_dir(torch, _tiny_cfg(), 0, torch.device("cpu"), hf_dir)
    data = str(tmp_path / "math.jsonl")
    with open(data, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in chip_smoke.math_prompt_rows(
            rng, SLICE_SIZES["n_prompts"], SLICE_SIZES["prompt"], words))
    exp, trial, nr_root = f"ref-fleet-{uuid.uuid4().hex[:6]}", "async", str(tmp_path / "nr")
    s = SLICE_SIZES
    argv = [f"experiment_name={exp}", f"trial_name={trial}", "seed=0",
            f"name_resolve_root={nr_root}", f"actor.path={hf_dir}", f"tokenizer_path={hf_dir}",
            f"dataset.path={data}", f"dataset.max_length={s['prompt'][1]}",
            f"train_batch_size={s['train_batch_size']}",
            f"ppo.gconfig.max_new_tokens={s['max_new_tokens']}",
            f"ppo.max_head_offpolicyness={s['offpolicy']}",
            f"ppo.ppo_n_minibatches={s['n_minibatches']}", f"exp_ctrl.benchmark_steps={s['steps']}",
            "actor.optimizer.lr=5e-5", "actor.optimizer.warmup_steps_proportion=0.0",
            f"mb_spec_max_tokens={s['max_tokens_per_mb']}", "n_rollout_workers=1",
            f"gen_max_concurrent_requests={s['slots']}", f"gen_max_seq_len={s['max_seq_len']}",
            f"group_size={s['group']}", "n_generation_servers=1", "worker_restarts=1",
            "recover_mode=disabled"]
    env = dict(os.environ, AREAL_FILEROOT=str(tmp_path / "fileroot"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_RUN, json.dumps([argv, exp, trial, nr_root])],
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         env=env, capture_output=True, text=True, timeout=400)
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    assert out.returncode == 0 and line, out.stderr[-3000:]
    got = json.loads(line[-1][len("RESULT "):])
    assert got["global_step"] == s["steps"]
    assert got["new_pid"] != got["pid"]  # restarted in place, beating again
