"""Agentic samples through the trainer side, port against reference.

A multi-turn episode is one id with one sequence a turn (1-3 here), one
``rewards`` and one ``seq_no_eos_mask`` entry a turn, turn k's prompt
being turn k-1's whole sequence plus the tool output, and the turns'
shifted behaviour logprobs concatenated. One PPO actor step (both
variants of ``test_torch_interfaces``) and one critic step on such a
batch go through both packages, advantages and returns within 1e-5 and
every stat within rtol 1e-3. The buffer's per-task staleness windows
admit and drop the same samples, counted by task, under the same
windows and version sequence.
"""

import asyncio

import numpy as np
import pytest

from areal_tpu.api.config import ModelName as JModelName
from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.dfg import MFCDef as JMFCDef
from areal_tpu.api.dfg import ModelInterfaceType as JMIT
from areal_tpu.api.dfg import build_graph as jbuild_graph
from areal_tpu.interfaces import ppo as jppo
from areal_tpu.system import buffer as jbuffer
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.dfg import MFCDef, ModelInterfaceType, build_graph
from areal_tpu_torch.api.model_api import ModelName, make_interface
from areal_tpu_torch.system import buffer as tbuffer
from tests.test_torch_interfaces import PPO_VARIANTS, assert_stats_close, make_models


def multi_turn_data(seed=0, n_ids=5, with_values=False):
    """A batch of agentic episodes as the tool-use agent packs them: id i
    holds 1-3 turns (every count present), each turn a sequence whose
    prompt is the previous turn's sequence plus a few tool-output
    tokens."""
    rng = np.random.RandomState(seed)
    seqs, pms, blps, lens_per_id, turns_per_id = [], [], [], [], []
    rewards, no_eos = [], []
    for i in range(n_ids):
        n_turns = 1 + i % 3
        prompt = list(rng.randint(1, 64, size=int(rng.randint(3, 7))))
        lens = []
        for _ in range(n_turns):
            out = list(rng.randint(1, 64, size=int(rng.randint(2, 7))))
            seq = prompt + out
            pm = np.zeros(len(seq), np.int64)
            pm[:len(prompt)] = 1
            lp = np.zeros(len(seq), np.float32)
            lp[len(prompt) - 1:len(seq) - 1] = -np.abs(rng.randn(len(out))) - 0.1
            seqs.append(np.asarray(seq, np.int32))
            pms.append(pm)
            blps.append(lp)
            lens.append(len(seq))
            prompt = seq + list(rng.randint(1, 64, size=int(rng.randint(1, 4))))
        # Turn rewards as the agent discounts them back from the answer.
        r = list(rng.choice([-5.0, 5.0], n_turns) + rng.randn(n_turns))
        rewards += r
        no_eos += list((rng.rand(n_turns) > 0.7).astype(np.float32))
        lens_per_id.append(lens)
        turns_per_id.append([1] * n_turns)
    total = sum(map(sum, lens_per_id))
    data = {
        "packed_input_ids": np.concatenate(seqs),
        "prompt_mask": np.concatenate(pms),
        "packed_logprobs": np.concatenate(blps),
        "seq_no_eos_mask": np.asarray(no_eos, np.float32),
        "rewards": np.asarray(rewards, np.float32),
    }
    data["ref_logprobs"] = (data["packed_logprobs"] + 0.01 * rng.randn(total)).astype(np.float32)
    seqlens = {k: lens_per_id for k in ("packed_input_ids", "prompt_mask", "packed_logprobs",
                                        "ref_logprobs")}
    seqlens.update(seq_no_eos_mask=turns_per_id, rewards=turns_per_id)
    if with_values:
        data["values"] = (rng.randn(total) * 0.1).astype(np.float32)
        seqlens["values"] = lens_per_id
    ids = [f"ep{i}" for i in range(n_ids)]
    meta = {"version_start": [0] * n_ids, "version_end": [0] * n_ids,
            "task": ["agentic"] * n_ids, "turns": [len(x) for x in lens_per_id]}

    def build(cls):
        return cls(ids=list(ids), keys=set(data), data={k: v.copy() for k, v in data.items()},
                   seqlens={k: [list(s) for s in v] for k, v in seqlens.items()},
                   metadata={k: list(v) for k, v in meta.items()})

    return build(JSequenceSample), build(SequenceSample)


def test_the_batch_holds_one_to_three_turns_an_id():
    _, t = multi_turn_data()
    assert [len(x) for x in t.seqlens["packed_input_ids"]] == [1, 2, 3, 1, 2]
    assert [len(x) for x in t.seqlens["rewards"]] == [1, 2, 3, 1, 2]
    assert len(t.data["rewards"]) == len(t.data["seq_no_eos_mask"]) == 9


@pytest.mark.parametrize("variant", sorted(PPO_VARIANTS))
def test_ppo_actor_step_on_multi_turn_samples_matches_reference(variant):
    kw, with_values = PPO_VARIANTS[variant]
    jmodel, tmodel = make_models(seed=4)
    jsample, tsample = multi_turn_data(seed=4, with_values=with_values)
    jitf = jppo.PPOActorInterface(n_minibatches=2, **kw)
    titf = make_interface("ppo_actor", n_minibatches=2, **kw)
    if kw.get("use_decoupled_loss"):
        jprox = jitf.inference(jmodel, jsample, JMicroBatchSpec())
        tprox = titf.inference(tmodel, tsample, MicroBatchSpec())
        np.testing.assert_allclose(tprox.data["logprobs"], jprox.data["logprobs"], atol=1e-5)
        jsample.update_(jprox)
        tsample.update_(tprox)
    want = jitf.train_step(jmodel, jsample, JMicroBatchSpec())
    got = titf.train_step(tmodel, tsample, MicroBatchSpec())
    np.testing.assert_allclose(tsample.data["advantages"], jsample.data["advantages"],
                               atol=1e-5, rtol=0)
    assert np.abs(jsample.data["advantages"]).max() > 0.1
    assert_stats_close(got, want)
    assert tmodel.version == jmodel.version == 1


def test_ppo_critic_step_on_multi_turn_samples_matches_reference():
    jmodel, tmodel = make_models(is_critic=True, seed=5)
    jsample, tsample = multi_turn_data(seed=5)
    jitf = jppo.PPOCriticInterface(n_minibatches=2)
    titf = make_interface("ppo_critic", n_minibatches=2)
    jvals = jitf.inference(jmodel, jsample, JMicroBatchSpec())
    tvals = titf.inference(tmodel, tsample, MicroBatchSpec())
    np.testing.assert_allclose(tvals.data["values"], jvals.data["values"], atol=1e-5)
    jsample.update_(jvals)
    tsample.update_(tvals)
    want = jitf.train_step(jmodel, jsample, JMicroBatchSpec())
    got = titf.train_step(tmodel, tsample, MicroBatchSpec())
    np.testing.assert_allclose(tsample.data["returns"], jsample.data["returns"], atol=1e-5)
    assert_stats_close(got, want)


# ----------------------------------------------------------------------
# Per-task staleness windows at buffer admission
# ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "", "math:2,agentic:8", " math : 0 , code:3,,",
                                  "math:x,agentic:1", "nocolon,agentic:4", "agentic:-1"])
def test_parse_task_windows_matches_reference(spec):
    assert tbuffer.parse_task_windows(spec) == jbuffer.parse_task_windows(spec)


def _rpcs(pkg):
    if pkg == "ref":
        mfc, mit, name, build = JMFCDef, JMIT, JModelName, jbuild_graph
    else:
        mfc, mit, name, build = MFCDef, ModelInterfaceType, ModelName, build_graph
    train = mfc(name="train", model_name=name("actor", 0), interface_type=mit.TRAIN_STEP,
                interface_impl=None, n_seqs=2, input_keys=("packed_input_ids",), output_keys=())
    build([train])
    return [train]


def _tagged(cls, i, task, v_end):
    meta = {"version_start": [max(0, v_end - 1)], "version_end": [v_end]}
    if task is not None:
        meta["task"] = [task]
    return cls.from_default(ids=[f"s{i}"], seqlens=[4],
                            data={"packed_input_ids": np.arange(4, dtype=np.int32)},
                            metadata=meta)


@pytest.mark.parametrize("windows", [None, "math:1,agentic:3", "math:0,agentic:-1"])
def test_buffer_admission_by_task_matches_reference(monkeypatch, windows):
    """The same batches at the same train steps: both buffers admit and
    drop the same ids, with the same per-task counts."""
    if windows is None:
        monkeypatch.delenv("AREAL_TASK_STALENESS_WINDOWS", raising=False)
    else:
        monkeypatch.setenv("AREAL_TASK_STALENESS_WINDOWS", windows)
    rng = np.random.default_rng(7)
    bufs = {"ref": jbuffer.AsyncIOSequenceBuffer(_rpcs("ref")),
            "port": tbuffer.AsyncIOSequenceBuffer(_rpcs("port"))}
    classes = {"ref": JSequenceSample, "port": SequenceSample}
    assert bufs["port"].task_windows == bufs["ref"].task_windows
    trace = {k: [] for k in bufs}
    i = 0
    for step in range(6):
        batch = []
        for _ in range(5):
            task = [None, "math", "agentic", "code"][int(rng.integers(0, 4))]
            batch.append((i, task, int(rng.integers(max(0, step - 5), step + 1))))
            i += 1
        for k, buf in bufs.items():
            buf.current_train_step = step
            n = asyncio.run(buf.put_batch([_tagged(classes[k], *b) for b in batch]))
            trace[k].append((n, sorted(buf.resident_ids([f"s{x[0]}" for x in batch])),
                             dict(buf.stale_dropped_by_task), dict(buf.counters)))
    assert trace["port"] == trace["ref"]
    dropped = bufs["port"].stale_dropped_by_task
    if windows is None:  # the reference's default, math:2,agentic:8
        assert bufs["port"].task_windows == {"math": 2, "agentic": 8}
    if windows == "math:0,agentic:-1":
        assert dropped["agentic"] > 0 and dropped["math"] > 0
        assert "code" not in dropped
    assert (bufs["port"].counters["areal:train_stale_dropped_total"]
            == sum(dropped.values()))
