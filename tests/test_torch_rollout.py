"""Port parity of generation through the rollout fleet, in one process on
the CPU: the port's stack (GenerationServer, GserverManager and
PartialRolloutManager of ``areal_tpu_torch``) against the reference's
(``areal_tpu``), on the tiny float32 model of tests/test_torch_serving.py
loaded into both servers from one raw dump, with one tokenizer whose EOS
is a token the model emits greedily.

- greedy ``generate_group`` gives equal tokens, logprobs within rtol
  1e-4 (float32 JAX against float32 torch, the server parity limit of
  tests/test_torch_generation_server.py), equal no_eos and versions;
- EOS stops generation on both (no_eos False, fewer tokens than asked);
- a chunked run (new_tokens_per_chunk=4) equals an unchunked one;
- a mixed fleet: the reference's manager and client in front of the
  port's server give the port stack's tokens, and the port's manager and
  client in front of the reference's server give the reference's;
- last, a weight update through each manager's fanout during a chunked
  generation (min_new_tokens holds the EOS off) gives version_start <
  version_end on both stacks.

Each stack runs under its own experiment name, with both packages'
name_resolve on one nfs root; a server joins a second experiment (the
mixed fleet) by its ``gen_servers`` entry alone. Managers and servers run
on threads and are stopped in the fixture's teardown.
"""

import asyncio
import json
import os
import threading
import time
import urllib.request
import uuid

import jax
import numpy as np
import pytest

from areal_tpu.api import model_api as rmodel
from areal_tpu.api.config import ModelAbstraction as RefModel
from areal_tpu.api.system_api import GenerationServerConfig as RefServerConfig
from areal_tpu.api.system_api import GserverManagerConfig as RefManagerConfig
from areal_tpu.base import name_resolve as ref_nr
from areal_tpu.base import names as ref_names
from areal_tpu.models.config import TransformerConfig as RefTransformerConfig
from areal_tpu.models.transformer import init_params
from areal_tpu.system import partial_rollout as rprm
from areal_tpu.system.weight_transfer import dump_raw_params
from areal_tpu_torch.api import model_api as tmodel
from areal_tpu_torch.api.config import ModelAbstraction
from areal_tpu_torch.api.system_api import GenerationServerConfig, GserverManagerConfig
from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.engine.serving import GenRequest, ServingEngine
from areal_tpu_torch.models.config import TransformerConfig
from areal_tpu_torch.system import partial_rollout as tprm
from tests.test_torch_serving import TINY

LOGPROB_RTOL = 1e-4
SERVER_KW = dict(max_concurrent_requests=4, max_seq_len=512, kv_page_size=16,
                 decode_block_steps=4, prompt_bucket=16, seed=0)
PROMPT = [3, 17, 42, 8, 29, 11, 50, 7]
EOS_AT = 5  # the EOS is the greedy continuation's token at this index


def _tokenizer(save_dir, eos_id):
    """A word-level tokenizer over the model's whole vocabulary ("w0" ..
    "w63", so every id decodes) whose EOS is id `eos_id`."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    vocab = {f"w{i}": i for i in range(TINY["vocab_size"])}
    tok = Tokenizer(WordLevel(vocab, unk_token="w0"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, eos_token=f"w{eos_id}",
                            pad_token=f"w{eos_id}", unk_token="w0").save_pretrained(save_dir)


def _greedy_continuation(tree, n):
    engine = ServingEngine(cfg=TransformerConfig(**TINY), params=params_from_numpy(tree, "cpu"),
                           max_batch_size=1, max_seq_len=128, decode_block_steps=4,
                           eos_token_id=None, page_size=16, device="cpu")
    engine.start()
    done = threading.Event()
    box = []
    try:
        engine.submit(GenRequest(qid="probe", input_ids=list(PROMPT), max_new_tokens=n,
                                 greedy=True,
                                 done_cb=lambda r: (box.append(r), done.set())))
        assert done.wait(60)
    finally:
        engine.stop()
    return box[0].output_ids


def _start(worker, cfg):
    worker.configure(cfg, experiment_name=cfg.experiment_name, trial_name=cfg.trial_name,
                     worker_name=cfg.worker_name)
    thread = threading.Thread(target=worker.run, daemon=True)
    thread.start()
    return worker, thread


def _post(url, path, payload):
    req = urllib.request.Request(url + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    from areal_tpu.system.generation_server import GenerationServer as RefServer
    from areal_tpu.system.gserver_manager import GserverManager as RefManager
    from areal_tpu_torch.system.generation_server import GenerationServer
    from areal_tpu_torch.system.gserver_manager import GserverManager

    import areal_tpu.engine.factories  # noqa: F401  (the reference's model registry)

    tmp = tmp_path_factory.mktemp("rollout")
    saved = ref_nr._default.repo, name_resolve._default.repo
    saved_root = os.environ.get("AREAL_FILEROOT")
    os.environ["AREAL_FILEROOT"] = str(tmp / "fileroot")
    ref_nr.reconfigure("nfs", record_root=str(tmp / "nr"))
    name_resolve.reconfigure("nfs", record_root=str(tmp / "nr"))
    run = uuid.uuid4().hex[:6]
    exps = {k: f"{k}-{run}" for k in ("ref", "port", "mix_ref_mgr", "mix_port_mgr")}
    tree = jax.tree_util.tree_map(
        np.asarray, init_params(RefTransformerConfig(**TINY), jax.random.PRNGKey(0)))
    cont = _greedy_continuation(tree, 16)
    eos = int(cont[EOS_AT])
    tok_dir = str(tmp / "tok")
    _tokenizer(tok_dir, eos)
    dump_dir = str(tmp / "dump" / "actor")
    dump_raw_params(tree, dump_dir, version=1)
    workers = []
    try:
        ref_srv, _ = _start(RefServer(), RefServerConfig(
            experiment_name=exps["ref"], trial_name="t0", tokenizer_path=tok_dir,
            model=RefModel("tpu_transformer", args=dict(config=dict(TINY))), **SERVER_KW))
        workers.append(ref_srv)
        port_srv, _ = _start(GenerationServer(), GenerationServerConfig(
            experiment_name=exps["port"], trial_name="t0", tokenizer_path=tok_dir,
            model=ModelAbstraction("tpu_transformer", args=dict(config=dict(TINY))),
            device="cpu", **SERVER_KW))
        workers.append(port_srv)
        for srv in (ref_srv, port_srv):
            reply = _post(srv.address, "/update_weights_from_disk",
                          {"model_path": dump_dir, "allow_interrupt": True, "version": 1})
            assert reply["success"], reply
        # The mixed fleets: each server also registered under the other
        # package's manager's experiment.
        ref_nr.add_subentry(ref_names.gen_servers(exps["mix_ref_mgr"], "t0"), port_srv.address)
        name_resolve.add_subentry(names.gen_servers(exps["mix_port_mgr"], "t0"), ref_srv.address)
        managers = {}
        for key, cls, cfg_cls in (("ref", RefManager, RefManagerConfig),
                                  ("mix_ref_mgr", RefManager, RefManagerConfig),
                                  ("port", GserverManager, GserverManagerConfig),
                                  ("mix_port_mgr", GserverManager, GserverManagerConfig)):
            m, _ = _start(cls(), cfg_cls(experiment_name=exps[key], trial_name="t0",
                                         n_servers=1, train_batch_size=4,
                                         max_head_offpolicyness=8))
            workers.append(m)
            managers[key] = m
        yield dict(exps=exps, tree=tree, eos=eos, cont=cont, managers=managers,
                   servers=dict(ref=ref_srv, port=port_srv))
    finally:
        for w in workers:
            w.exit()
        time.sleep(1.0)
        ref_nr._default.repo.reset()
        name_resolve._default.repo.reset()
        ref_nr._default.repo, name_resolve._default.repo = saved
        if saved_root is None:
            os.environ.pop("AREAL_FILEROOT", None)
        else:
            os.environ["AREAL_FILEROOT"] = saved_root


def _generate(fleet, stack, qid, max_new_tokens, chunk=1 << 30, n=2, prompt=PROMPT,
              min_new_tokens=0):
    """generate_group through `stack`'s manager with that manager's
    package's client ("ref"/"mix_ref_mgr": the reference's)."""
    ref_side = stack in ("ref", "mix_ref_mgr")
    prm_mod, model_mod = (rprm, rmodel) if ref_side else (tprm, tmodel)
    prm = prm_mod.PartialRolloutManager(fleet["managers"][stack].address,
                                        new_tokens_per_chunk=chunk, request_timeout=120)
    gconfig = model_mod.GenerationHyperparameters(n=n, max_new_tokens=max_new_tokens,
                                                  min_new_tokens=min_new_tokens, greedy=True)

    async def go():
        try:
            return await prm.generate_group(qid, list(prompt), gconfig)
        finally:
            await prm.close()

    return asyncio.run(go())


def _assert_same(got, want):
    assert got.seqs == want.seqs
    assert got.no_eos == want.no_eos
    assert (got.version_start, got.version_end) == (want.version_start, want.version_end)
    for a, b in zip(got.logprobs, want.logprobs):
        np.testing.assert_allclose(a, b, rtol=LOGPROB_RTOL, atol=1e-6)


def test_greedy_group_matches_reference_and_stops_at_eos(fleet):
    ref = _generate(fleet, "ref", "g0", 12)
    port = _generate(fleet, "port", "g0", 12)
    _assert_same(port, ref)
    n_out = len(port.seqs[0]) - len(PROMPT)
    # The tokenizer's EOS ends the answer: it is the last token, emitted
    # at its first occurrence in the greedy continuation.
    assert port.no_eos == [False, False]
    assert port.seqs[0][-1] == fleet["eos"]
    assert n_out == fleet["cont"].index(fleet["eos"]) + 1 < 12
    assert port.version_start == [1, 1] and port.version_end == [1, 1]


def test_chunked_generation_equals_unchunked(fleet):
    other = [5, 9, 13, 2, 44]
    for stack in ("ref", "port"):
        whole = _generate(fleet, stack, "c-whole", 20, prompt=other)
        chunked = _generate(fleet, stack, "c-chunk", 20, chunk=4, prompt=other)
        _assert_same(chunked, whole)
    _assert_same(_generate(fleet, "port", "c-x", 20, chunk=4, prompt=other),
                 _generate(fleet, "ref", "c-x", 20, chunk=4, prompt=other))


def test_mixed_fleet_both_directions(fleet):
    other = [21, 4, 33, 60, 1, 18]
    # The reference's manager and client in front of the port's server.
    port = _generate(fleet, "port", "m0", 10, chunk=3, prompt=other)
    _assert_same(_generate(fleet, "mix_ref_mgr", "m0", 10, chunk=3, prompt=other), port)
    # The port's manager and client in front of the reference's server.
    ref = _generate(fleet, "ref", "m1", 10, chunk=3, prompt=other)
    _assert_same(_generate(fleet, "mix_port_mgr", "m1", 10, chunk=3, prompt=other), ref)


def _publish_version_2(fleet, stack):
    """A trainer's hand-off, as each package's model worker leaves it:
    the raw dump of version 2 in the manager's param-realloc dir, its
    marker (the port: step.txt; the reference: engine_state.pkl), then
    the published version."""
    exp = fleet["exps"][stack]
    tree = jax.tree_util.tree_map(lambda x: x * 1.01, fleet["tree"])
    dump_dir = os.path.join(os.environ["AREAL_FILEROOT"], "param_realloc", exp, "t0", "actor")
    dump_raw_params(tree, dump_dir, version=2)
    marker = "step.txt" if stack == "port" else "engine_state.pkl"
    with open(os.path.join(dump_dir, marker), "w") as f:
        f.write("2")
    nr, nm = (name_resolve, names) if stack == "port" else (ref_nr, ref_names)
    nr.add(nm.model_version(exp, "t0", "actor"), "2", replace=True)


@pytest.mark.parametrize("stack", ["ref", "port"])
def test_weight_update_mid_generation_spans_versions(fleet, stack):
    box = {}
    gen = threading.Thread(target=lambda: box.setdefault(
        "out", _generate(fleet, stack, "w0", 160, chunk=4, n=1, min_new_tokens=160)))
    gen.start()
    time.sleep(0.5)
    _publish_version_2(fleet, stack)
    gen.join(timeout=300)
    out = box["out"]
    m = fleet["managers"][stack]
    assert m.weight_version == 2
    assert out.version_start == [1] and out.version_end == [2]
    assert len(out.seqs[0]) == len(PROMPT) + 160
