"""Port parity: TorchTrainEngine against JaxTrainEngine.

The same numpy params and the same SequenceSample go through both engines
(the port on ``device="cpu"``, float32 params and compute) with the SFT
loss of each package's interface. Limits: loss and grad norm of each of 3
steps 1e-4 relative; first-step gradients 1e-4 of max|ref| per leaf;
``forward`` logprobs 1e-5 abs. Parameters after N steps are not compared
leaf by leaf: where a gradient is near zero, Adam's update has size lr
with either sign through two different autodiffs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.engine.jax_engine import JaxTrainEngine
from areal_tpu.engine.optimizer import OptimizerConfig as JOptimizerConfig
from areal_tpu.interfaces import sft as jsft
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import TransformerConfig as JaxConfig
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.convert import params_from_numpy, params_to_numpy
from areal_tpu_torch.engine.optimizer import OptimizerConfig, tree_leaves
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.interfaces import sft as tsft
from areal_tpu_torch.models.config import TransformerConfig

CFG = dict(n_layers=2, hidden_dim=64, n_q_heads=4, n_kv_heads=2, head_dim=16,
           intermediate_dim=96, vocab_size=128, attn_bias=True,
           compute_dtype="float32", param_dtype="float32")
OPT = dict(lr=2e-3, lr_scheduler_type="linear", min_lr_ratio=0.1,
           warmup_steps_proportion=0.2, weight_decay=0.05, gradient_clipping=1.0)
TOTAL_STEPS = 10
STAT_KEYS = {"sft/loss", "sft/grad_norm", "sft/n_tokens", "sft/n_mbs", "sft/lr",
             "sft/n_response_tokens"}


def numpy_params(seed=0):
    tree = jt.init_params(JaxConfig(**CFG), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def batch_data(n=9, seed=0):
    rng = np.random.RandomState(seed)
    seqlens = rng.randint(6, 40, size=n).tolist()
    ids = rng.randint(0, CFG["vocab_size"], size=sum(seqlens))
    pm = np.concatenate([(np.arange(l) < max(1, l // 3)).astype(np.int64) for l in seqlens])
    return [f"s{i}" for i in range(n)], seqlens, {"packed_input_ids": ids, "prompt_mask": pm}


def make_engines(tree, remat="full"):
    jeng = JaxTrainEngine(
        JaxConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, tree),
        optimizer_config=JOptimizerConfig(**OPT), total_train_steps=TOTAL_STEPS,
        row_len_multiple=32)
    teng = TorchTrainEngine(
        TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
        optimizer_config=OptimizerConfig(**OPT), total_train_steps=TOTAL_STEPS,
        row_len_multiple=32, remat=remat, device="cpu")
    return jeng, teng


def samples():
    ids, seqlens, data = batch_data()
    return (JSequenceSample.from_default(ids, seqlens, dict(data)),
            SequenceSample.from_default(ids, seqlens, dict(data)))


@pytest.mark.parametrize("n_mbs", [1, 3])
@pytest.mark.parametrize("give_version", [True, False])
def test_three_sft_steps_follow_the_reference(n_mbs, give_version):
    jeng, teng = make_engines(numpy_params())
    jsample, tsample = samples()
    for step in range(3):
        vs = 2 * step if give_version else None
        want = jeng.train_batch(jsample, JMicroBatchSpec(n_mbs=n_mbs), jsft.sft_row_loss,
                                jsft.sft_loss_weight, version_steps=vs, loss_name="sft")
        got = teng.train_batch(tsample, MicroBatchSpec(n_mbs=n_mbs), tsft.sft_row_loss,
                               tsft.sft_loss_weight, version_steps=vs, loss_name="sft")
        assert set(got) == set(want) == STAT_KEYS
        for k in sorted(STAT_KEYS):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {step} {k}")
    assert got["sft/n_mbs"] == n_mbs


def test_first_step_gradients_match_the_reference():
    tree = numpy_params(seed=1)
    jeng, teng = make_engines(tree)
    jsample, tsample = samples()
    _, jrows = jeng._build_rows(jsample)
    _, trows = teng._build_rows(tsample)
    for k in jrows:
        np.testing.assert_array_equal(jrows[k], trows[k])  # the same packing
    denom = jsft.sft_loss_weight(jsample)
    assert denom == tsft.sft_loss_weight(tsample)

    def jloss(p):
        return jeng._mb_loss_fn(jsft.sft_row_loss)(p, jeng._device_rows(jrows))[0] / denom

    want = jax.tree_util.tree_leaves(jax.grad(jloss)(jeng.params))
    rows = teng._device_rows(trows)
    loss, _ = tsft.sft_row_loss(teng._model_out(rows, "logprobs", "full"), rows)
    got = torch.autograd.grad(loss / denom, tree_leaves(teng.params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - w)) <= 1e-4 * np.max(np.abs(w))


def test_remat_full_and_none_give_the_same_loss_and_gradients():
    tree = numpy_params(seed=2)
    _, tsample = samples()
    grads = {}
    for remat in ("full", "none"):
        teng = TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
                                remat=remat, row_len_multiple=32, device="cpu")
        _, trows = teng._build_rows(tsample)
        rows = teng._device_rows(trows)
        loss, _ = tsft.sft_row_loss(teng._model_out(rows, "logprobs", remat), rows)
        grads[remat] = (loss.item(), torch.autograd.grad(loss, tree_leaves(teng.params)))
    assert grads["full"][0] == grads["none"][0]
    for a, b in zip(grads["full"][1], grads["none"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        teng._model_out(rows, "logprobs", "save_attn")


def test_forward_logprobs_match_the_reference_and_keep_sample_order():
    tree = numpy_params(seed=3)
    jeng, teng = make_engines(tree)
    jsample, tsample = samples()
    want = jeng.forward(jsample, JMicroBatchSpec(n_mbs=2, max_tokens_per_mb=96))
    got = teng.forward(tsample, MicroBatchSpec(n_mbs=2, max_tokens_per_mb=96))
    assert got.keys == {"logprobs"} and got.ids == tsample.ids
    assert got.seqlens["logprobs"] == want.seqlens["logprobs"]
    np.testing.assert_allclose(got.data["logprobs"], want.data["logprobs"], atol=1e-5, rtol=0)
    logits = teng.forward(tsample, MicroBatchSpec(), output_key="logits", output="logits")
    assert logits.data["logits"].shape == (tsample.total_seqlen(), CFG["vocab_size"])


def test_params_update_in_place_and_set_params_keeps_optimizer_state():
    tree = numpy_params(seed=4)
    _, teng = make_engines(tree)
    _, tsample = samples()
    before = params_to_numpy(teng.get_params())
    teng.train_batch(tsample, MicroBatchSpec(), tsft.sft_row_loss, tsft.sft_loss_weight)
    after = params_to_numpy(teng.get_params())
    assert np.any(after["layers"]["attn"]["wq"] != before["layers"]["attn"]["wq"])
    assert teng.optimizer.count == 1
    teng.set_params(params_from_numpy(tree, device="cpu"))
    np.testing.assert_array_equal(params_to_numpy(teng.get_params())["head"]["weight"],
                                  tree["head"]["weight"])
    assert teng.optimizer.count == 1


def test_engine_refuses_bad_calls():
    tree = numpy_params(seed=5)
    _, tsample = samples()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"))
    eng = TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(tree, device="cpu"),
                           device="cpu")
    with pytest.raises(RuntimeError, match="without optimizer"):
        eng.train_batch(tsample, MicroBatchSpec(), tsft.sft_row_loss, tsft.sft_loss_weight)
    _, teng = make_engines(tree)
    with pytest.raises(ValueError, match="token_normalize_scope"):
        teng.train_batch(tsample, MicroBatchSpec(), tsft.sft_row_loss, tsft.sft_loss_weight,
                         token_normalize_scope="rank")
    got = teng.train_batch(tsample, MicroBatchSpec(), tsft.sft_row_loss, tsft.sft_loss_weight,
                           token_normalize_scope="dp")
    assert np.isfinite(got["loss/loss"])
