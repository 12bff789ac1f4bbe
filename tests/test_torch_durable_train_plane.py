"""Kill-anywhere recovery on the port's durable training plane (the port's
counterpart of tests/system/test_durable_train_plane.py).

A child trainer (``_child`` below, run as this file's ``__main__``) is
killed with ``AREAL_FAULTS`` ``die`` actions (``os._exit``) at each
durable-plane point of the port: the WAL append
(``system/wal.py``), the buffer's consume (``system/buffer.py``) and the
checkpoint's manifest commit (``engine/checkpoint.py``, async writer),
while the parent, one ack-mode pusher of the port, feeds samples across
all incarnations; then a clean incarnation finishes. The child folds
the integer in each sample id, so "every sample trained exactly once" is
one equality at the end: the fold sum over n samples is n(n-1)/2.
Also: no duplicate consumption (the buffer's detector stays 0), the
pusher lost nothing, resumes replayed from the WAL, and the recover
record covers every sequence.
"""

import json
import os
import sys

import pytest

pytestmark = [pytest.mark.serial, pytest.mark.chaos]

N_TOTAL = 24
BATCH = 4
# One incarnation per fault point, then a clean run to drain.
KILL_PLAN = [
    "buffer.wal_append=die:k=5",
    "buffer.consume=die:k=2",
    "train.checkpoint=die:k=2",
    "",
]
# Each incarnation's own deadline (the whole test takes ~20 s on one CPU
# worker).
INCARNATION_TIMEOUT_S = 60


class FoldEngine:
    """The smallest engine the checkpoint path accepts: params is the fold
    accumulator [sum, count], replaced (never mutated) each step."""

    def __init__(self):
        import numpy as np

        self.params = {"fold": np.zeros(2, dtype=np.float64)}
        self.opt_state = None
        self.version = 0

    def set_params(self, params):
        self.params = params

    def fold(self, values):
        import numpy as np

        f = self.params["fold"]
        self.params = {"fold": np.array([f[0] + sum(values), f[1] + len(values)],
                                        dtype=np.float64)}


def latest_committed(ckpt_root):
    """Newest version directory with a committed manifest (a kill mid-save
    leaves one without)."""
    from areal_tpu_torch.engine.checkpoint import load_manifest

    if not os.path.isdir(ckpt_root):
        return None, None
    for step in sorted((d for d in os.listdir(ckpt_root) if d.isdigit()), key=int,
                       reverse=True):
        d = os.path.join(ckpt_root, step)
        man = load_manifest(d)
        if man is not None:
            return d, man
    return None, None


def _child(spec):
    import asyncio

    from areal_tpu_torch.api.config import ModelName
    from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType, build_graph
    from areal_tpu_torch.base import constants, name_resolve, recover
    from areal_tpu_torch.base.recover import RecoverInfo, StepInfo
    from areal_tpu_torch.engine import checkpoint
    from areal_tpu_torch.system.buffer import AsyncIOSequenceBuffer
    from areal_tpu_torch.system.stream_dataset import PullerStreamDataset
    from areal_tpu_torch.system.wal import SeqLedger

    name_resolve.reconfigure("nfs", record_root=spec["nr_root"])
    constants.RECOVER_ROOT = spec["recover_root"]
    exp, trial, ckpt_root = spec["exp"], spec["trial"], spec["ckpt_root"]
    progress = open(spec["progress_path"], "a")

    def log(event, **kw):
        progress.write(json.dumps({"event": event, **kw}) + "\n")
        progress.flush()

    train = MFCDef(name="train", model_name=ModelName("actor", 0),
                   interface_type=ModelInterfaceType.TRAIN_STEP, interface_impl=None,
                   n_seqs=spec["batch"], input_keys=("packed_prompts",), output_keys=())
    build_graph([train])
    eng = FoldEngine()
    buf = AsyncIOSequenceBuffer([train])
    # The committed manifest is the one source of truth for both the fold
    # state and the consumed-seq cut.
    ckpt_dir, man = latest_committed(ckpt_root)
    if ckpt_dir is not None:
        checkpoint.load_engine_state(eng, ckpt_dir)
        buf.seed_consumed_seqs((man.get("dataset_cursors") or {}).get("consumed_seqs"))
    # Building the dataset replays the WAL (admission against the seeded
    # ledger makes over-replay harmless).
    ds = PullerStreamDataset(exp, trial, puller_index=0)
    log("resume", version=eng.version, count=int(eng.params["fold"][1]),
        replayed=ds.counters["areal:train_wal_replayed_total"])

    def barrier():
        eng.version += 1
        snap = buf.consumed_seqs()
        # One commit point (the manifest rename) covers the fold state and
        # the ledger cut it was taken at.
        checkpoint.save_engine_state(eng, os.path.join(ckpt_root, str(eng.version)),
                                     dataset_cursors={"consumed_seqs": snap})
        recover.dump(RecoverInfo(last_step_info=StepInfo(global_step=eng.version),
                                 consumed_seqs=snap), exp, trial)
        # Compact against the newest manifest committed on disk: with the
        # async writer it may lag the snapshot just taken (GC only).
        _, committed = latest_committed(ckpt_root)
        dropped = 0
        if committed is not None:
            cur = committed.get("dataset_cursors") or {}
            dropped = ds.compact_wal(SeqLedger.from_dict(cur.get("consumed_seqs")))
        log("barrier", version=eng.version, count=int(eng.params["fold"][1]),
            wal_dropped=dropped, dup=buf.counters["areal:train_samples_duplicated_total"])

    async def train_loop():
        steps = 0
        while int(eng.params["fold"][1]) < spec["n_total"]:
            batch = ds.poll_batch(max_samples=spec["batch"] * 2)
            if batch is not None:
                await buf.put_batch([batch])
            if await buf.poll_ready_count(train) >= train.n_seqs:
                ids, _ = await buf.get_batch_for_rpc(train)
                eng.fold([int(i[1:]) for i in ids])  # ids are "s<int>"
                steps += 1
                if steps % spec["ckpt_every"] == 0:
                    barrier()
            else:
                await asyncio.sleep(0.01)
        barrier()  # the final cut
        checkpoint.wait_pending_writes(timeout=60)

    asyncio.run(train_loop())
    result = {
        "fold_sum": float(eng.params["fold"][0]),
        "count": int(eng.params["fold"][1]),
        "version": eng.version,
        "replayed": ds.counters["areal:train_wal_replayed_total"],
        "duplicated_total": buf.counters["areal:train_samples_duplicated_total"],
    }
    tmp = spec["result_path"] + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, spec["result_path"])
    log("done", **result)
    ds.close()
    progress.close()


def _events(path):
    """Torn-tolerant JSONL parse: the child can die mid-write."""
    out = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    return out


@pytest.mark.timeout(300)
def test_kill_anywhere_trains_every_sample_exactly_once(tmp_path):
    import subprocess
    import time
    import uuid

    import numpy as np

    from areal_tpu_torch.api.data_api import SequenceSample, sample_to_json
    from areal_tpu_torch.base import name_resolve, recover
    from areal_tpu_torch.system import push_pull_stream as pps

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    saved = name_resolve._default.repo
    nr = str(tmp_path / "nr")
    exp, trial = f"durable-{uuid.uuid4().hex[:6]}", "t0"
    name_resolve.reconfigure("nfs", record_root=nr)
    spec = {"nr_root": nr, "exp": exp, "trial": trial, "ckpt_root": str(tmp_path / "ckpt"),
            "recover_root": str(tmp_path / "recover"),
            "progress_path": str(tmp_path / "progress.jsonl"),
            "result_path": str(tmp_path / "result.json"), "n_total": N_TOTAL,
            "batch": BATCH, "ckpt_every": 1}
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               AREAL_WAL="1", AREAL_CKPT_ASYNC="1", AREAL_CKPT_BACKEND="pickle",
               AREAL_WAL_FSYNC_MS="5")
    env.pop("AREAL_FAULTS", None)
    payloads = [sample_to_json(SequenceSample.from_default(
        ids=[f"s{i}"], seqlens=[4], data={"packed_prompts": np.arange(4, dtype=np.int32)}))
        for i in range(N_TOTAL)]
    n_pushed, pusher, exits, logs = 0, None, [], []
    try:
        for incarnation, fault in enumerate(KILL_PLAN):
            child_env = dict(env, AREAL_FAULTS=fault) if fault else env
            log_path = tmp_path / f"child{incarnation}.log"
            logs.append(log_path)
            with open(log_path, "w") as log_f:
                proc = subprocess.Popen([sys.executable, __file__, json.dumps(spec)],
                                        env=child_env, cwd=repo, stdout=log_f,
                                        stderr=subprocess.STDOUT)
            try:
                if pusher is None:
                    # Waits for the first incarnation's puller; later ones
                    # re-register the name and re_resolve follows them.
                    pusher = pps.NameResolvingZmqPusher(exp, trial, pusher_index=0,
                                                        n_pushers=1, n_pullers=1, ack=True)
                deadline = time.monotonic() + INCARNATION_TIMEOUT_S
                while proc.poll() is None:
                    assert time.monotonic() < deadline, (
                        f"incarnation {incarnation} ({fault or 'clean'}) hung:\n"
                        + log_path.read_text()[-3000:])
                    while n_pushed < len(payloads):
                        pusher.push(payloads[n_pushed], seq=f"p0/{n_pushed}")
                        n_pushed += 1
                    pusher.drain_acks()
                    if pusher.unacked():
                        pusher.re_resolve(timeout=0.2)
                        pusher.redeliver(timeout_s=0.5)
                    time.sleep(0.05)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
            exits.append(proc.returncode)
            if os.path.exists(spec["result_path"]):
                break

        assert len(exits) == len(KILL_PLAN), exits
        assert all(code != 0 for code in exits[:-1]), (exits, KILL_PLAN)
        assert exits[-1] == 0, (exits, logs[-1].read_text()[-3000:])
        with open(spec["result_path"]) as f:
            result = json.load(f)
        # Every sample trained exactly once, across three kills,
        # redelivery and WAL replay.
        assert result["count"] == N_TOTAL
        assert result["fold_sum"] == float(sum(range(N_TOTAL)))
        assert result["duplicated_total"] == 0
        assert pusher.counters["areal:train_samples_lost_total"] == 0
        events = _events(spec["progress_path"])
        resumes = [e for e in events if e["event"] == "resume"]
        assert len(resumes) == len(exits)
        assert resumes[0]["count"] == 0
        assert sum(e["replayed"] for e in resumes) > 0
        assert all(e["dup"] == 0 for e in events if e["event"] == "barrier")
        # The recover record covers every sequence.
        from areal_tpu_torch.base import constants

        saved_root, constants.RECOVER_ROOT = constants.RECOVER_ROOT, spec["recover_root"]
        try:
            info = recover.load(exp, trial)
        finally:
            constants.RECOVER_ROOT = saved_root
        assert info.last_step_info.global_step == result["version"]
        assert (info.consumed_seqs or {}).get("water", {}).get("p0") == N_TOTAL - 1
    finally:
        if pusher is not None:
            pusher.close()
        name_resolve._default.repo = saved


if __name__ == "__main__":
    _child(json.loads(sys.argv[1]))
