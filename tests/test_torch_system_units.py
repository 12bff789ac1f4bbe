"""Port parity of the worker system's single-process parts, against the
reference on the same inputs:

- ``build_graph``: levels, producers, parents and children for the
  async PPO, sync PPO and SFT MFC sets;
- ``AsyncIOSequenceBuffer``: the same puts (resident duplicates, a
  ledgered sequence, untagged samples without a sequence id) give the
  same batches in the same order and the same counters;
- ``SeqLedger``: marks out of order, round trip through ``to_dict``;
  ``RolloutWAL``: replay drops a torn tail exactly as the reference,
  compaction rewrites the same bytes, and each package replays the
  other's journal;
- ``RedistribPlanner`` plans and ``merge_worker_stats``;
- the control socket: a reference ``WorkerControl`` commands a port
  worker's ``WorkerServer``;
- refusals: the master and model worker refuse the options the port
  lacks (the save and evaluate frequencies and a worker's datasets, no
  longer refused, configure as the reference's), a model worker on
  "cuda" without a card raises, and
  ``LocalController.run(timeout)`` raises ``TimeoutError`` past its
  deadline, and ``RuntimeError`` with the traceback of a worker that
  raised.
"""

import asyncio
import dataclasses
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from areal_tpu.api import data_api as rdata
from areal_tpu.api import dfg as rdfg
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.system import buffer as rbuf
from areal_tpu.system import model_function_call as rmfc
from areal_tpu.system import redistributor as rred
from areal_tpu.system import wal as rwal
from areal_tpu.system import worker_base as rwb
from areal_tpu_torch.api import data_api as tdata
from areal_tpu_torch.api import dfg as tdfg
from areal_tpu_torch.api import system_api as tsys
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.system import buffer as tbuf
from areal_tpu_torch.system import model_function_call as tmfc
from areal_tpu_torch.system import redistributor as tred
from areal_tpu_torch.system import wal as twal
from areal_tpu_torch.system import worker_base as twb
from areal_tpu_torch.system.controller import LocalController
from areal_tpu_torch.system.master_worker import MasterWorker
from areal_tpu_torch.system.model_worker import ModelWorker


def _mfcs(dfg, kind):
    actor, critic, ref, rew = (dfg.ModelName(r, 0) for r in ("actor", "critic", "ref", "reward"))
    T = dfg.ModelInterfaceType
    mk = lambda name, model, itype, i, o: dfg.MFCDef(  # noqa: E731
        name=name, model_name=model, interface_type=itype, interface_impl=None,
        n_seqs=4, input_keys=i, output_keys=o)
    if kind == "async_ppo":
        return [mk("actor_train", actor, T.TRAIN_STEP,
                   ("packed_input_ids", "prompt_mask", "packed_logprobs", "rewards",
                    "seq_no_eos_mask"), ())]
    if kind == "sft":
        return [mk("trainDefault", actor, T.TRAIN_STEP, ("packed_input_ids", "prompt_mask"), ())]
    gen = ("packed_input_ids", "packed_logprobs", "prompt_mask", "seq_no_eos_mask")
    return [
        mk("actor_gen", actor, T.GENERATE, ("packed_prompts",), gen),
        mk("rew_inf", rew, T.INFERENCE, ("packed_input_ids", "prompt_mask"), ("rewards",)),
        mk("ref_inf", ref, T.INFERENCE, ("packed_input_ids",), ("packed_ref_logprobs",)),
        mk("critic_inf", critic, T.INFERENCE, ("packed_input_ids", "seq_no_eos_mask"),
           ("values",)),
        mk("actor_train", actor, T.TRAIN_STEP,
           gen + ("rewards", "packed_ref_logprobs", "values"), ()),
        mk("critic_train", critic, T.TRAIN_STEP,
           gen + ("rewards", "packed_ref_logprobs", "values"), ()),
    ]


@pytest.mark.parametrize("kind", ["async_ppo", "sync_ppo", "sft"])
def test_build_graph_matches_reference(kind):
    want, got = rdfg.build_graph(_mfcs(rdfg, kind)), tdfg.build_graph(_mfcs(tdfg, kind))
    assert got.topo_order == want.topo_order
    assert got.producers == want.producers and got.data_keys == want.data_keys
    for name, r in want.rpcs.items():
        t = got.rpcs[name]
        assert (t.parents, t.children, t.is_src, t.is_dst) == (
            r.parents, r.children, r.is_src, r.is_dst)


def _buffer_script(data_api, dfg, buffer_mod):
    """Puts and gets through one package's buffer; returns what came out."""
    rpcs = [dfg.MFCDef(name=n, model_name=dfg.ModelName("actor", 0),
                       interface_type=dfg.ModelInterfaceType.TRAIN_STEP, interface_impl=None,
                       n_seqs=3, input_keys=("x",)) for n in ("a", "b")]
    buf = buffer_mod.AsyncIOSequenceBuffer(rpcs, max_size=64)
    buf.current_train_step = 5

    def batch(ids, seqs=None):
        md = {"wal_seq": seqs} if seqs else {}
        return data_api.SequenceSample(
            ids=ids, keys={"x"}, data={"x": None}, seqlens={"x": [[2]] * len(ids)},
            metadata=md)

    out = []

    async def run():
        out.append(await buf.put_batch([batch([f"s{i}" for i in range(4)],
                                              seqs=[f"0/{i}" for i in range(4)])]))
        out.append(await buf.put_batch([batch(["s1", "s9"], seqs=["0/1", "0/9"])]))
        out.append(await buf.put_batch([batch(["m0", "m1"])]))
        for rpc in rpcs * 2:
            if await buf.poll_ready_count(rpc) >= rpc.n_seqs:
                ids, b = await buf.get_batch_for_rpc(rpc)
                out.append((rpc.name, ids, b.ids))
        out.append(await buf.put_batch([batch(["s0"], seqs=["0/0"])]))  # ledgered
        out.append((len(buf), buf.counters["areal:train_samples_duplicated_total"],
                    buf.n_ledger_filtered, buf.n_dropped_duplicates,
                    buf.seq_ledger.to_dict()))

    asyncio.run(run())
    return out


def test_sequence_buffer_matches_reference():
    assert _buffer_script(tdata, tdfg, tbuf) == _buffer_script(rdata, rdfg, rbuf)


def test_seq_ledger_round_trip_matches_reference():
    seqs = ["0/3", "0/0", "1/0", "0/1", "2/5", "0/2", "1/2", "2/0"]
    r, t = rwal.SeqLedger(), twal.SeqLedger()
    for s in seqs:
        r.mark(s)
        t.mark(s)
    assert t.to_dict() == r.to_dict()
    back = twal.SeqLedger.from_dict(t.to_dict())
    probe = seqs + ["0/4", "1/1", "2/1", "3/0"]
    assert [s in back for s in probe] == [s in r for s in probe] == \
        [True] * len(seqs) + [False] * 4


@pytest.mark.parametrize("writer,reader", [(twal, rwal), (rwal, twal), (twal, twal)])
def test_wal_replay_drops_a_torn_tail_as_the_reference(tmp_path, writer, reader):
    path = str(tmp_path / "w.wal")
    w = writer.RolloutWAL(path, fsync_ms=0)
    assert w.replay() == []
    records = [{"seq": f"0/{i}", "data": {"ids": [f"q{i}"], "x": list(range(i))}}
               for i in range(3)]
    for rec in records:
        w.append(rec)
    w.close()
    with open(path, "ab") as f:
        f.write(b'{"seq": "0/3", "da')  # torn append
    good = open(path, "rb").read()[:-len(b'{"seq": "0/3", "da')]
    got = reader.RolloutWAL(path, fsync_ms=0)
    assert got.replay() == records
    # Checkpoint-barrier compaction drops the consumed records in place.
    assert got.compact(lambda rec: rec["seq"] != "0/1") == 1
    got.close()
    compacted = open(path, "rb").read()
    assert compacted == b"\n".join(
        line for i, line in enumerate(good.split(b"\n")) if i != 2)
    again = writer.RolloutWAL(path, fsync_ms=0)
    assert again.replay() == [records[0], records[2]]
    again.close()


def test_redistrib_plans_and_stats_merge_match_reference():
    rng = np.random.default_rng(0)
    workers = [f"model_worker/{i}" for i in range(3)]
    plans = []
    for mod in (rred, tred):
        tracker = mod.GlobalStorageTracker()
        r = np.random.default_rng(1)
        for i in range(12):
            for k in ("a", "b", "c"):
                for w in r.choice(workers, size=int(r.integers(1, 3)), replace=False):
                    tracker.add(f"s{i}", k, str(w))
        planner = mod.RedistribPlanner(tracker)
        dests = {w: [f"s{i}" for i in range(12) if i % 3 == j] for j, w in enumerate(workers)}
        plans.append([dataclasses.asdict(s) for s in planner.derive_plan(dests, ["a", "b"])]
                     + [dataclasses.asdict(s) for s in planner.derive_plan(dests, ["c"])])
    assert plans[1] == plans[0] and plans[0]
    stats = [{"x/loss": float(rng.standard_normal()), "x/n_tokens": 10.0 + i,
              "perf/sec": 1.0 + i, "y/min": float(i), "__reduce_types__": {"y/min": "min"}}
             for i in range(3)]
    assert tmfc.merge_worker_stats(stats) == rmfc.merge_worker_stats(stats)


def test_reference_worker_control_commands_a_port_worker(tmp_path):
    class Idle(twb.Worker):
        def _configure(self, config):
            pass

        def _poll(self):
            return twb.PollResult(batch_count=0)

    saved = ref_nr._default.repo, name_resolve._default.repo
    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    exp = f"ctl-{uuid.uuid4().hex[:6]}"
    server = twb.WorkerServer(exp, "t0", "idle/0")
    worker = Idle(server)
    worker.configure(None, experiment_name=exp, trial_name="t0", worker_name="idle/0")
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    ctl = rwb.WorkerControl(exp, "t0", "idle/0", timeout=30)
    try:
        assert ctl.command("status", timeout_ms=30_000) == "RUNNING"
        assert ctl.command("pause", timeout_ms=30_000) is None
        assert rwb.worker_status(exp, "t0", "idle/0") == rwb.WorkerServerStatus.PAUSED
        assert ctl.command("status", timeout_ms=30_000) == "PAUSED"
        assert ctl.command("start", timeout_ms=30_000) is None
        with pytest.raises(RuntimeError, match="unknown command"):
            ctl.command("bogus", timeout_ms=30_000)
        assert ctl.command("exit", timeout_ms=30_000) is None
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert twb.worker_status(exp, "t0", "idle/0") == twb.WorkerServerStatus.COMPLETED
    finally:
        worker.exit()
        thread.join(timeout=30)
        ctl.close()
        server.close()
        ref_nr._default.repo, name_resolve._default.repo = saved


@pytest.mark.parametrize("option", [
    dict(datasets="prompt_answer"), dict(train_n_hosts=2)])
def test_model_worker_refuses_unported_options(option, tmp_path):
    """train_n_hosts > 1 is refused. A worker with datasets (refused
    before the SFT slice) loads its DP rank's share and reports that local
    size, as the reference's worker does on the same config."""
    if "datasets" not in option:
        cfg = tsys.ModelWorkerConfig(experiment_name="x", trial_name="t", device="cpu",
                                     **option)
        with pytest.raises(NotImplementedError):
            ModelWorker()._configure(cfg)
        return
    from areal_tpu.api import config as rcfg
    from areal_tpu.api import system_api as rsys
    from areal_tpu.system.model_worker import ModelWorker as RefModelWorker
    from areal_tpu_torch.api import config as tcfg
    from tests import fixtures

    rows = fixtures.make_sft_rows(11, seed=5)
    fixtures.train_tiny_tokenizer([r["prompt"] + " " + r["answer"] for r in rows],
                                  tmp_path).save_pretrained(str(tmp_path / "tok"))
    data = fixtures.write_jsonl(rows, tmp_path / "sft.jsonl")
    saved = ref_nr._default.repo, name_resolve._default.repo
    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    exp = f"mw-{uuid.uuid4().hex[:6]}"
    kw = dict(experiment_name=exp, trial_name="t0", tokenizer_path=str(tmp_path / "tok"),
              dataset_dp_rank=1, dataset_dp_size=2, train_batch_size=4)
    args = dict(dataset_path=data, max_length=12)
    workers = []
    try:
        for i, (cls, sysapi, cfgapi, extra) in enumerate((
                (ModelWorker, tsys, tcfg, dict(device="cpu")),
                (RefModelWorker, rsys, rcfg, {}))):
            w = cls()
            workers.append(w)
            w.configure(sysapi.ModelWorkerConfig(
                worker_index=i, datasets=[cfgapi.DatasetAbstraction(option["datasets"], args)],
                **kw, **extra), experiment_name=exp, trial_name="t0",
                worker_name=f"model_worker/{i}")
        got, want = (w._handle_spec(None) for w in workers)
        assert got == want == {"dataset_size": 5, "models": []}
        assert workers[0].dataloader.batch_size == workers[1].dataloader.batch_size == 2
    finally:
        for w in workers:
            w._exit_hook()
        ref_nr._default.repo, name_resolve._default.repo = saved


def test_model_worker_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelWorker()._configure(tsys.ModelWorkerConfig(experiment_name="x", trial_name="t"))


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("ctl", [dict(save_freq_steps=1), dict(ckpt_freq_epochs=1),
                                 dict(eval_freq_secs=60), dict(recover_mode="auto")])
def test_master_refuses_save_ckpt_eval_and_recover(ctl, tmp_path, monkeypatch):
    """Save, checkpoint and evaluate frequencies and recovery configure
    (each was refused before its slice). The master's save, ckpt or eval
    control hits at the same steps as the reference's on a scripted run
    (steps, epoch boundaries and a patched clock); under recover_mode
    "auto" the master resumes from a recover record at the step, control
    states, ignore-list and ledger the reference's master reads from the
    same record."""
    from areal_tpu.base import constants as rconst
    from areal_tpu.base import recover as rrec
    from areal_tpu.base import timeutil as rtime
    from areal_tpu.system.master_worker import MasterWorker as RefMaster
    from areal_tpu_torch.base import constants as tconst
    from areal_tpu_torch.base import timeutil as ttime

    mode = ctl.pop("recover_mode", "disabled")
    cfg = tsys.MasterWorkerConfig(experiment_name="x", trial_name="t", recover_mode=mode,
                                  exp_ctrl=tsys.ExperimentSaveEvalControl(**ctl))
    clock = _Clock()
    monkeypatch.setattr(ttime, "time", clock)
    monkeypatch.setattr(rtime, "time", clock)
    saved = name_resolve._default.repo, ref_nr._default.repo
    name_resolve.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    ref_nr.reconfigure("nfs", record_root=str(tmp_path / "nr"))
    master = MasterWorker()
    ref = None
    try:
        cfg.n_model_workers = 0
        if mode != "disabled":
            for mod in (tconst, rconst):
                monkeypatch.setattr(mod, "RECOVER_ROOT", str(tmp_path / "recover"))
            rrec.dump(rrec.RecoverInfo(
                last_step_info=rrec.StepInfo(epoch=1, epoch_step=2, global_step=7),
                save_ctl_info=dict(steps=0, epochs=0, total_steps=7, first=False),
                ckpt_ctl_info=dict(steps=1, epochs=0, total_steps=7, first=False),
                eval_ctl_info=dict(steps=3, epochs=1, total_steps=7, first=False),
                hash_vals_to_ignore=["a", "b"], consumed_seqs={"water": {"p0": 4}}), "x", "t")
            from areal_tpu.api import system_api as rsys

            ref = RefMaster()
            ref.configure(rsys.MasterWorkerConfig(
                experiment_name="x", trial_name="t", recover_mode=mode, n_model_workers=0),
                experiment_name="x", trial_name="t", worker_name="master")
        master.configure(cfg, experiment_name="x", trial_name="t", worker_name="master")
        if ref is not None:
            assert dataclasses.asdict(master.step_info) == dataclasses.asdict(ref.step_info)
            assert master.step_info.global_step == 8
            for c in ("save_ctl", "ckpt_ctl", "eval_ctl"):
                assert getattr(master, c).state_dict() == getattr(ref, c).state_dict()
            assert master.buffer.ignore_ids == ref.buffer.ignore_ids == {"a", "b"}
            assert master.buffer.consumed_seqs() == ref.buffer.consumed_seqs()
            return
        what = next(w for w in ("save", "ckpt", "eval") if any(k.startswith(w) for k in ctl))
        port_ctl = getattr(master, f"{what}_ctl")
        ref_ctl = rtime.FrequencyControl(
            frequency_step=ctl.get("save_freq_steps"), frequency_sec=ctl.get("eval_freq_secs"),
            frequency_epoch=ctl.get("ckpt_freq_epochs"))
        hits = []
        for i in range(12):
            clock.now += 7.0 * (i % 4)
            epochs = int(i % 5 == 4)
            hits.append((port_ctl.check(steps=1, epochs=epochs),
                         ref_ctl.check(steps=1, epochs=epochs)))
        assert [a for a, _ in hits] == [b for _, b in hits]
        assert sum(a for a, _ in hits) == {"save": 12, "eval": 2, "ckpt": 2}[what]
    finally:
        master._exit_hook()
        if ref is not None:
            ref._exit_hook()
        name_resolve._default.repo.reset()
        name_resolve._default.repo, ref_nr._default.repo = saved


def test_controller_run_raises_past_its_deadline(tmp_path):
    """A master waiting on a model worker that never comes: run(timeout)
    gives up at the deadline with TimeoutError."""
    exp = f"deadline-{uuid.uuid4().hex[:6]}"
    saved = name_resolve._default.repo
    cfg = tsys.ExperimentConfig(
        experiment_name=exp, trial_name="t0",
        master=tsys.MasterWorkerConfig(experiment_name=exp, trial_name="t0",
                                       n_model_workers=1))
    ctl = LocalController(cfg, name_resolve_cfg={"backend": "nfs",
                                                 "record_root": str(tmp_path / "nr")})
    t0 = time.monotonic()
    try:
        with pytest.raises(TimeoutError):
            ctl.run(timeout=2.0)
        assert time.monotonic() - t0 < 30
    finally:
        name_resolve._default.repo = saved


def test_controller_run_raises_when_a_worker_fails(tmp_path):
    """A spawned model worker that raises while it configures (asked for
    "cuda" where no card is visible) makes run() raise RuntimeError with
    the worker's traceback instead of waiting for its deadline."""
    exp = f"fail-{uuid.uuid4().hex[:6]}"
    saved = name_resolve._default.repo
    cfg = tsys.ExperimentConfig(
        experiment_name=exp, trial_name="t0",
        master=tsys.MasterWorkerConfig(experiment_name=exp, trial_name="t0",
                                       n_model_workers=1),
        model_workers=[tsys.ModelWorkerConfig(experiment_name=exp, trial_name="t0",
                                              device="cuda")])
    ctl = LocalController(cfg, name_resolve_cfg={"backend": "nfs",
                                                 "record_root": str(tmp_path / "nr")},
                          worker_env={"CUDA_VISIBLE_DEVICES": ""})
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctl.run(timeout=120.0)
        assert time.monotonic() - t0 < 120
    finally:
        ctl.join(timeout=30)
        name_resolve._default.repo = saved
