"""Port parity of recovery: the recover record, the recover state of the
buffer, the dataloader and the WAL, and checkpoint-and-resume end to end.

- ``RecoverInfo`` (``base/recover.py``) both ways between the packages:
  each loads the other's record, and the port's dump is byte-equal to the
  reference's; ports of the cases of tests/base/test_recover.py; the
  host generators' ``state_dict`` / ``load_state`` cross both ways.
- The buffer's ``ignore_ids``, ``consumed_this_epoch``, ledger snapshot and
  seeding and ``on_epoch_boundary`` on one scripted sequence, equal to the
  reference buffer's; ``PackedDataLoader.load_state_dict`` +
  ``restart_epoch`` give the reference's order; ``compact_wal`` drops
  what the reference's drops from the same WAL and ledger.
- End to end on the port's engine (float32 compute): the shape of the
  reference's ``test_recovery_e2e_mock`` (4 steps at ``ckpt_freq_steps=2``,
  then ``recover_mode=auto`` to 6), whose resumed step equals step 5 of an
  uninterrupted run; ``main_sft`` with a master that fails at the top of
  step 4, relaunched by the launcher's loop (chip_smoke's ``recover``
  phase rehearsed at 2 layers): step 3 runs twice, equal; with recovery
  disabled or its retries spent the launcher raises.
- Across packages: a reference SFT run checkpoints at step 2 and the
  port's master and worker resume from its recover directory; the
  resumed step is within rtol 1e-3 of the reference's own resumed step.
- Two reference behaviours the port copies, each shown in both packages:
  a restore does not set ``Model.version``, so the resumed step trains at
  the schedule's first position (its ``sft/lr`` is step 1's); a kill at
  ``train.checkpoint`` between the two renames leaves the new
  ``engine_state.pkl`` under the old manifest, and a load reads it.
"""

import asyncio
import dataclasses
import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import textwrap
import uuid

import numpy as np
import pytest
import torch

from areal_tpu.api import cli_args as rcli
from areal_tpu.api import data_api as rdata
from areal_tpu.api import dfg as rdfg
from areal_tpu.base import constants as rconst
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import recover as rrec
from areal_tpu.base import seeding as rseeding
from areal_tpu.experiments import make_experiment as ref_make_experiment
from areal_tpu.system import buffer as rbuf
from areal_tpu.system import wal as rwal
from areal_tpu_torch.api import cli_args as tcli
from areal_tpu_torch.api import data_api as tdata
from areal_tpu_torch.api import dfg as tdfg
from areal_tpu_torch.base import constants as tconst
from areal_tpu_torch.base import name_resolve
from areal_tpu_torch.base import recover as trec
from areal_tpu_torch.base import seeding as tseeding
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.experiments import make_experiment
from areal_tpu_torch.models import hf as thf
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.models.transformer import init_params
from areal_tpu_torch.system import buffer as tbuf
from areal_tpu_torch.system import wal as twal
from tests import fixtures
from tests.test_torch_workers import CFG, F32_FAMILY, PortController, RefController

pytestmark = pytest.mark.serial

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 300
STAT_RTOL = 1e-3
SFT_KEYS = ("sft/loss", "sft/grad_norm", "sft/n_tokens", "sft/lr", "sft/n_mbs")
EXP, TRIAL = "recover-test", "t0"


@pytest.fixture()
def recover_root(tmp_path, monkeypatch):
    for mod in (tconst, rconst):
        monkeypatch.setattr(mod, "RECOVER_ROOT", str(tmp_path / "recover"))
    yield tmp_path


@pytest.fixture
def restore_name_resolve():
    saved = ref_nr._default.repo, name_resolve._default.repo
    yield
    ref_nr._default.repo, name_resolve._default.repo = saved


# ---------------------------------------------------------------------------
# The recover record
# ---------------------------------------------------------------------------


def _info(mod):
    return mod.RecoverInfo(
        recover_start=mod.StepInfo(epoch=1, epoch_step=2, global_step=12),
        last_step_info=mod.StepInfo(epoch=1, epoch_step=3, global_step=13),
        save_ctl_info={"steps": 1, "epochs": 0, "total_steps": 13, "first": False},
        ckpt_ctl_info={"freq_step": 5}, data_loading_dp_idx=3,
        hash_vals_to_ignore=["r3", "r7"],
        consumed_seqs={"water": {"w0": 4, "w1": 1}, "extras": {"w0": [7]}},
        dataset_cursors={"model_worker/0": {"epoch": 0, "offset": 64}})


@pytest.mark.parametrize("writer,reader", [(trec, rrec), (rrec, trec), (trec, trec)])
def test_recover_info_crosses_packages(writer, reader, recover_root):
    writer.dump(_info(writer), EXP, TRIAL)
    got = reader.load(EXP, TRIAL)
    assert type(got) is reader.RecoverInfo and type(got.last_step_info) is reader.StepInfo
    assert dataclasses.asdict(got) == dataclasses.asdict(_info(writer))
    assert got == _info(reader)


def test_recover_dump_is_the_reference_dump_byte_for_byte(recover_root):
    trec.dump(_info(trec), EXP, "port")
    rrec.dump(_info(rrec), EXP, "ref")
    assert (open(trec.dump_path(EXP, "port"), "rb").read()
            == open(rrec.dump_path(EXP, "ref"), "rb").read())


def test_recover_dump_load_round_trip_and_schema(recover_root):
    trec.dump(trec.RecoverInfo(), EXP, TRIAL)
    with open(trec.dump_path(EXP, TRIAL), "rb") as f:
        payload = pickle.load(f)  # the reference's classes, importable here
    assert payload["schema"] == "areal-recover-info/v1"
    assert isinstance(payload["info"], rrec.RecoverInfo)
    d = os.path.dirname(trec.dump_path(EXP, TRIAL))
    assert not [f for f in os.listdir(d) if ".tmp." in f]


@pytest.mark.parametrize("pre_ledger", [False, True])
def test_load_accepts_a_legacy_raw_record(pre_ledger, recover_root):
    """A reference record from before the schema wrapper (a bare
    RecoverInfo), and one from before the ledger fields, which unpickles
    without them (dataclass defaults do not apply; the master reads them
    with getattr)."""
    info = rrec.RecoverInfo(data_loading_dp_idx=2)
    if pre_ledger:
        del info.consumed_seqs, info.dataset_cursors
    with open(trec.dump_path(EXP, TRIAL), "wb") as f:
        pickle.dump(info, f)
    got = trec.load(EXP, TRIAL)
    assert type(got) is trec.RecoverInfo and got.data_loading_dp_idx == 2
    assert getattr(got, "consumed_seqs", None) == (None if pre_ledger else {})


@pytest.mark.parametrize("payload,exc,match", [
    ({"schema": "areal-recover-info/v999", "info": None}, ValueError,
     "unsupported recover-info schema"),
    ({"schema": "areal-recover-info/v1", "info": pathlib.PurePosixPath("x")},
     pickle.UnpicklingError, "refusing to unpickle the global pathlib"),
])
def test_load_rejects_an_unknown_schema_or_class(payload, exc, match, recover_root):
    with open(trec.dump_path(EXP, TRIAL), "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(exc, match=match):
        trec.load(EXP, TRIAL)


def test_load_without_dump_raises_and_step_info_next(recover_root):
    with pytest.raises(FileNotFoundError):
        trec.load(EXP, "no-such-trial")
    n = trec.StepInfo(epoch=2, epoch_step=4, global_step=9).next()
    assert (n.epoch, n.epoch_step, n.global_step) == (2, 5, 10)


def test_discover_ckpt_picks_the_latest_step(recover_root):
    root = os.path.join(tconst.get_recover_path(EXP, TRIAL), "ckpt", "actor")
    for step in ("9", "99", "100", "tmp-partial"):
        os.makedirs(os.path.join(root, step))
    for mod in (trec, rrec):
        assert mod.discover_ckpt("actor", EXP, TRIAL) == os.path.join(root, "100")
        assert mod.discover_ckpt("critic", EXP, TRIAL) is None


@pytest.mark.parametrize("writer,reader", [(tseeding, rseeding), (rseeding, tseeding)])
def test_host_generator_state_crosses_packages(writer, reader):
    import random

    writer.set_random_seed(7, "model_worker/0")
    np.random.rand(2)
    state = writer.state_dict()
    want = (np.random.rand(3), random.random(), writer.get_shuffle_seed("data"))
    reader.set_random_seed(99, "other")
    reader.load_state(state)
    assert reader.get_seed() == 7
    got = (np.random.rand(3), random.random(), reader.get_shuffle_seed("data"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


# ---------------------------------------------------------------------------
# Buffer, dataloader, WAL
# ---------------------------------------------------------------------------


def _buffer_script(data_api, dfg, buffer_mod):
    """A recovered buffer: seeded ignore-list and ledger, puts and gets
    across an epoch boundary; returns what came out and its state."""
    rpc = dfg.MFCDef(name="train", model_name=dfg.ModelName("actor", 0),
                     interface_type=dfg.ModelInterfaceType.TRAIN_STEP, interface_impl=None,
                     n_seqs=2, input_keys=("x",))
    buf = buffer_mod.AsyncIOSequenceBuffer([rpc], max_size=64)
    buf.ignore_ids |= {"r0", "r1", "r5"}
    buf.seed_consumed_seqs({"water": {"p0": 1}})

    def batch(ids, seqs=None):
        md = {"wal_seq": seqs} if seqs else {}
        return data_api.SequenceSample(ids=ids, keys={"x"}, data={"x": None},
                                       seqlens={"x": [[2]] * len(ids)}, metadata=md)

    out = []

    async def run():
        out.append(await buf.put_batch([batch(["r0", "r1", "r2", "r3"])]))
        out.append(await buf.put_batch([batch(["r0", "r4"])]))  # r0 skipped once only
        out.append(await buf.put_batch([batch(["q0", "q1", "q2"], ["p0/0", "p0/1", "p0/2"])]))
        while await buf.poll_ready_count(rpc) >= rpc.n_seqs:
            ids, _ = await buf.get_batch_for_rpc(rpc)
            out.append(ids)
        out.append(sorted(buf.consumed_this_epoch))
        out.append(sorted(buf.ignore_ids))
        buf.on_epoch_boundary()
        out.append(sorted(buf.consumed_this_epoch))
        out.append(await buf.put_batch([batch(["r5", "r6"])]))
        out.append((len(buf), buf.n_ledger_filtered, buf.consumed_seqs()))

    asyncio.run(run())
    return out


def test_buffer_recover_state_matches_the_reference():
    got, want = _buffer_script(tdata, tdfg, tbuf), _buffer_script(rdata, rdfg, rbuf)
    assert got == want


class _Rows:
    """A map-style dataset of one-token samples."""

    def __init__(self, data_api, n):
        self.rows = [data_api.SequenceSample.from_default(
            ids=[f"r{i}"], seqlens=[1], data={"packed_input_ids": np.array([i])})
            for i in range(n)]

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _loader_order(data_api, state=None, n=10, batch=3, draws=5):
    loader = data_api.PackedDataLoader(_Rows(data_api, n), batch_size=batch, seed=4)
    if state is not None:
        loader.load_state_dict(state)
        loader.restart_epoch()
    out = []
    for _ in range(draws):
        b, last = loader.next_batch()
        out.append((list(b.ids), last))
    return out, loader.state_dict()


@pytest.mark.parametrize("state", [
    None, dict(epoch=1, cursor=6, seed=4, size=10), dict(epoch=2, cursor=3, seed=9, size=12)])
def test_dataloader_restore_gives_the_reference_order(state):
    assert _loader_order(tdata, state) == _loader_order(rdata, state)


def _compact(side, tmp, wal_mod, ledger):
    from areal_tpu.system.stream_dataset import PullerStreamDataset as RefDataset
    from areal_tpu_torch.system.stream_dataset import PullerStreamDataset

    nr_mod = name_resolve if side == "port" else ref_nr
    nr_mod.reconfigure("nfs", record_root=str(tmp / f"nr-{side}"))
    exp = f"wal-{side}-{uuid.uuid4().hex[:6]}"
    path = os.path.join(str(tmp / "recover"), exp, "t0", "wal", "puller0.wal")
    w = wal_mod.RolloutWAL(path, fsync_ms=0)
    for i in range(6):
        s = tdata.SequenceSample.from_default(ids=[f"q{i}"], seqlens=[2],
                                              data={"packed_prompts": np.arange(2)})
        w.append({"seq": f"p0/{i}", "data": tdata.sample_to_json(s)})
    w.close()
    ds = (PullerStreamDataset if side == "port" else RefDataset)(exp, "t0")
    try:
        dropped = ds.compact_wal(wal_mod.SeqLedger.from_dict(ledger))
    finally:
        ds.close()
    return dropped, [r["seq"] for r in wal_mod.RolloutWAL(path, fsync_ms=0).replay()]


def test_compact_wal_matches_the_reference(recover_root, monkeypatch, restore_name_resolve):
    monkeypatch.setenv("AREAL_WAL", "1")
    ledger = {"water": {"p0": 2}, "extras": {"p0": [4]}}
    got = _compact("port", recover_root, twal, ledger)
    assert got == _compact("ref", recover_root, rwal, ledger)
    assert got == (4, ["p0/3", "p0/5"])


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def _hf_dir(tmp, rows, family="qwen2"):
    """An HF directory of seeded float32 weights with the tiny tokenizer;
    ``family`` is written as its model_type."""
    tok = fixtures.train_tiny_tokenizer([r["prompt"] + " " + r["answer"] for r in rows], tmp)
    cfg = TransformerConfig(**CFG)
    d = str(tmp / f"hf-{family}")
    thf.save_hf_model(d, cfg, init_params(cfg, seed=0, device="cpu"), "qwen2", tokenizer=tok)
    with open(os.path.join(d, "config.json")) as f:
        hf_cfg = json.load(f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(hf_cfg, model_type=family), f)
    return d


@pytest.fixture(scope="module")
def sft_data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recover_e2e")
    rows = fixtures.make_sft_rows(48, seed=3)
    return dict(tmp=tmp, data=fixtures.write_jsonl(rows, tmp / "sft.jsonl"),
                hf=_hf_dir(tmp, rows), hf_f32=_hf_dir(tmp, rows, F32_FAMILY))


def _argv(exp, hf_dir, data, steps, **extra):
    return [f"experiment_name={exp}", "trial_name=t0", f"model.path={hf_dir}",
            f"tokenizer_path={hf_dir}", f"dataset.path={data}", "dataset.max_length=24",
            "train_batch_size=8", "model.row_len_multiple=32", "model.optimizer.lr=1e-3",
            "model.optimizer.warmup_steps_proportion=0.0", f"exp_ctrl.benchmark_steps={steps}",
            "exp_ctrl.ckpt_freq_steps=2", *(f"{k}={v}" for k, v in extra.items())]


def _run(side, exp, sft_data, steps, mode, fileroot, monkeypatch, **extra):
    """One sft experiment under the package's controller (float32-compute
    workers); returns (global step, per-step trainDefault stats)."""
    if side == "port":
        from areal_tpu_torch.system.function_executor import FunctionExecutor
        cli, mk, ctl_cls = tcli, make_experiment, PortController
    else:
        from areal_tpu.system.function_executor import FunctionExecutor
        cli, mk, ctl_cls = rcli, ref_make_experiment, RefController
    recorded = []
    inner = FunctionExecutor.execute_step_sync

    def recording(self):
        out = inner(self)
        recorded.append(out["trainDefault"])
        return out

    monkeypatch.setattr(FunctionExecutor, "execute_step_sync", recording)
    cfg = cli.SFTExpConfig()
    argv = _argv(exp, sft_data["hf_f32"], sft_data["data"], steps, recover_mode=mode, **extra)
    cli.apply_overrides(cfg, argv + (["device=cpu"] if side == "port" else []))
    monkeypatch.setenv("AREAL_FILEROOT", str(fileroot))
    ctl = ctl_cls(mk("sft", cfg), name_resolve_cfg={
        "backend": "nfs", "record_root": str(sft_data["tmp"] / f"nr-{exp}")},
        worker_env={"JAX_PLATFORMS": "cpu", "AREAL_FILEROOT": str(fileroot)})
    try:
        result = ctl.run(timeout=RUN_TIMEOUT_S)
    finally:
        ctl.join(timeout=30)
    return result["global_step"], recorded


def _assert_stats_close(got, want):
    for k in SFT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, err_msg=k)


def test_recovery_e2e_resumes_at_the_next_batch(sft_data, monkeypatch, restore_name_resolve):
    """test_recovery_e2e_mock's shape on the port's engine: 4 steps at
    ckpt_freq_steps=2, then recover_mode=auto to 6, which trains one step
    (the master resumes at last_step_info.next()) on the fifth batch,
    equal to step 5 of an uninterrupted run."""
    exp = f"e2e-rec-{uuid.uuid4().hex[:6]}"
    root = sft_data["tmp"] / exp
    g1, s1 = _run("port", exp, sft_data, 4, "disabled", root, monkeypatch)
    assert (g1, len(s1)) == (4, 4)
    assert trec.load(exp, "t0").last_step_info.global_step == 4
    g2, s2 = _run("port", exp, sft_data, 6, "auto", root, monkeypatch)
    assert (g2, len(s2)) == (6, 1)
    exp_u = f"e2e-unint-{uuid.uuid4().hex[:6]}"
    g3, s3 = _run("port", exp_u, sft_data, 5, "disabled", sft_data["tmp"] / exp_u, monkeypatch)
    assert g3 == 5
    for k in SFT_KEYS:
        assert s2[0][k] == s3[4][k], k


def test_main_sft_relaunches_and_repeats_step_3():
    """chip_smoke's recover phase at a tiny size on the CPU (the kernels'
    plain versions): main_sft's master fails at the top of step 4 (armed
    in this process), the launcher's loop relaunches once with
    recover_mode=auto, and the phase's gates hold: the relaunch finds the
    step-2 record and manifest, step 3 runs again with every sft/* stat
    equal, each worker leaves with no pending write, the record ends at
    step 5."""
    import chip_smoke
    from areal_tpu_torch.models.hf.qwen2 import r1_distill_qwen_1_5b_config

    cfg = r1_distill_qwen_1_5b_config(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2,
                                      head_dim=16, intermediate_dim=128, vocab_size=512,
                                      max_position_embeddings=4096)
    sizes = dict(chip_smoke.RECOVER_SIZES, n_rows=40, prompt=(8, 24), answer=(4, 12),
                 max_length=40, train_batch_size=4, words=40, row_len=64,
                 max_tokens_per_mb=256, lr=1e-3)
    saved = ref_nr._default.repo, name_resolve._default.repo
    try:
        stats = chip_smoke.recover_phase(torch, np.random.default_rng(0), torch.device("cpu"),
                                         cfg, 0, "cpu", sizes=sizes)
    finally:
        ref_nr._default.repo, name_resolve._default.repo = saved
    assert stats["ckpt_steps"] == [(1, 2), (2, 5)]
    assert set(stats["repeat_rel_diff"].values()) == {0.0}
    assert stats["ckpt_bytes"] > 0 and len(stats["write_s"]) == 2


@pytest.mark.parametrize("mode,attempts", [("disabled", 1), ("auto", 2)])
def test_main_sft_raises_when_recovery_is_disabled_or_spent(mode, attempts, sft_data, tmp_path,
                                                            monkeypatch, restore_name_resolve):
    """A master that fails at every step: with recovery disabled the
    launcher raises after one attempt, with recover_retries=1 after two."""
    from areal_tpu_torch.training import main_sft

    fileroot = str(tmp_path / "fileroot")
    monkeypatch.setenv("AREAL_FILEROOT", fileroot)
    faults.reset()
    faults.arm("master.step", "raise", at_hit=1, times=0)
    try:
        with pytest.raises(Exception, match="injected fault"):
            main_sft.main(
                _argv(f"spent-{uuid.uuid4().hex[:6]}", sft_data["hf"], sft_data["data"], 2,
                      recover_mode=mode, recover_retries=1, name_resolve_root=tmp_path / "nr",
                      device="cpu"),
                worker_env={"AREAL_FILEROOT": fileroot}, timeout=RUN_TIMEOUT_S)
        assert faults._hits["master.step"] == attempts
    finally:
        faults.reset()


def test_port_resumes_a_reference_checkpoint(sft_data, monkeypatch, restore_name_resolve):
    """A reference run checkpoints at step 2 (a decaying LR schedule); the
    reference and the port each resume from a copy of its recover
    directory and train one step. The two resumed steps agree within
    rtol 1e-3, and both train at the schedule's first position: a restore
    leaves Model.version at 0 (copied as it is, ROADMAP Queue C)."""
    extra = {"model.optimizer.lr_scheduler_type": "linear",
             "model.optimizer.min_lr_ratio": 0.1}
    exp = f"xresume-{uuid.uuid4().hex[:6]}"
    root = sft_data["tmp"] / exp
    g, s_ref = _run("ref", exp, sft_data, 2, "disabled", root / "ref", monkeypatch, **extra)
    assert g == 2
    src = os.path.join(root / "ref", "recover", exp)
    shutil.copytree(src, os.path.join(root / "port", "recover", exp))
    g_ref, r_ref = _run("ref", exp, sft_data, 4, "auto", root / "ref", monkeypatch, **extra)
    g_port, r_port = _run("port", exp, sft_data, 4, "auto", root / "port", monkeypatch, **extra)
    assert g_ref == g_port == 4 and len(r_ref) == len(r_port) == 1
    _assert_stats_close(r_port[0], r_ref[0])
    # The schedule decays (step 2 trained below step 1's LR), yet both
    # resumed steps train at step 1's.
    assert s_ref[1]["sft/lr"] < s_ref[0]["sft/lr"]
    np.testing.assert_allclose([r_port[0]["sft/lr"], r_ref[0]["sft/lr"]], s_ref[0]["sft/lr"],
                               rtol=1e-6)


_KILL_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    pkg = sys.argv[1]
    if pkg == "port":
        from areal_tpu_torch.engine import checkpoint
    else:
        from areal_tpu.engine import checkpoint

    class Engine:
        def __init__(self):
            self.params = {"w": np.zeros(3, np.float32)}
            self.opt_state = None
            self.version = 0
            self._lr_steps = 0

        def set_params(self, params):
            self.params = params

    eng = Engine()
    for step in (1, 2):
        eng.params = {"w": np.full(3, step, np.float32)}
        eng._lr_steps = step
        checkpoint.save_engine_state(eng, sys.argv[2])  # dies at the second commit
""")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_kill_between_the_renames_leaves_the_new_state_under_the_old_manifest(pkg, tmp_path):
    """The reference replaces engine_state.pkl before the manifest. A kill
    at train.checkpoint (the manifest's commit) in a directory that is
    saved over each time leaves step 2's state under step 1's manifest,
    and a load reads step 2's. Copied as it is (ROADMAP Queue C)."""
    from areal_tpu_torch.engine import checkpoint as tck

    d = str(tmp_path / "dp0")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, JAX_PLATFORMS="cpu",
               AREAL_FAULTS="train.checkpoint=die:k=2", AREAL_CKPT_BACKEND="pickle")
    env.pop("AREAL_CKPT_ASYNC", None)
    proc = subprocess.run([sys.executable, "-c", _KILL_CHILD, pkg, d], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0, proc.stderr[-2000:]
    assert tck.load_manifest(d)["version_steps"] == 1
    state = tck.load_state_file(d)
    assert state["version_steps"] == 2
    np.testing.assert_array_equal(state["params"]["w"], np.full(3, 2, np.float32))
    assert tck.has_engine_state(d)
