"""Port parity: the PPO functional suite and the PPO / SFT interfaces of
areal_tpu_torch against areal_tpu, on the same numpy inputs.

Limits: ``packed_rewards``, ``actor_loss_fn`` and ``critic_loss_fn`` 1e-5
(float32 elementwise math and one sum); one ``train_step`` of each
interface on a tiny model through both packages: advantages 1e-5 abs,
every reported stat 1e-3 relative (four or two optimizer updates through
two autodiffs lie between), KL-controller state equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.config import ModelName as JModelName
from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.data_api import SequenceSample as JSequenceSample
from areal_tpu.api.model_api import Model as JModel
from areal_tpu.engine.jax_engine import JaxTrainEngine
from areal_tpu.engine.optimizer import OptimizerConfig as JOptimizerConfig
from areal_tpu.interfaces import functional as JF
from areal_tpu.interfaces import ppo as jppo
from areal_tpu.interfaces import sft as jsft
from areal_tpu.models import transformer as jt
from areal_tpu.models.config import TransformerConfig as JaxConfig
from areal_tpu_torch.api.data_api import MicroBatchSpec, SequenceSample
from areal_tpu_torch.api.model_api import Model, ModelName, make_interface
from areal_tpu_torch.convert import params_from_numpy
from areal_tpu_torch.engine.optimizer import OptimizerConfig
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.interfaces import functional as TF
from areal_tpu_torch.interfaces import ppo as tppo
from areal_tpu_torch.interfaces import sft as tsft
from areal_tpu_torch.models.config import TransformerConfig

R, T = 3, 40
CFG = dict(n_layers=2, hidden_dim=32, n_q_heads=4, n_kv_heads=2, head_dim=8,
           intermediate_dim=64, vocab_size=64, compute_dtype="float32",
           param_dtype="float32")
OPT = dict(lr=1e-3, warmup_steps_proportion=0.0)


def J(x):
    return jnp.asarray(x)


def Tt(x):
    return torch.from_numpy(np.asarray(x))


def row_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda scale=1.0: (rng.standard_normal((R, T)) * scale).astype(np.float32)
    mask = (rng.random((R, T)) > 0.3).astype(np.float32)
    return rng, f, mask


def assert_tree_close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("mask_no_eos", [False, True])
def test_packed_rewards_match_reference(mask_no_eos):
    rng, f, mask = row_inputs(1)
    last = mask * (rng.random((R, T)) > 0.8)
    no_eos = (rng.random((R, T)) > 0.5).astype(np.float32)
    args = dict(score=f(10.0), logprobs=f(), ref_logprobs=f(), response_mask=mask,
                last_response_mask=last.astype(np.float32), no_eos_mask=no_eos)
    want = JF.packed_rewards(0.1, 5.0, mask_no_eos_with_zero=mask_no_eos,
                             **{k: J(v) for k, v in args.items()})
    got = TF.packed_rewards(0.1, 5.0, mask_no_eos_with_zero=mask_no_eos,
                            **{k: Tt(v) for k, v in args.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", ["clip", "dual_clip", "decoupled", "decoupled_capped"])
def test_actor_loss_matches_reference(variant):
    rng, f, mask = row_inputs(2)
    old = f(0.5)
    args = dict(logprobs=old + f(0.3), old_logprobs=old, advantages=f(2.0), loss_mask=mask)
    kw = dict(eps_clip=0.2)
    if variant == "dual_clip":
        kw["c_clip"] = 3.0
    if variant.startswith("decoupled"):
        args["proximal_logprobs"] = old + f(0.4)
        args["stats_mask"] = (mask > 0).astype(np.float32)
        args["loss_mask"] = mask * 1.7  # a normalization scale in the loss weights
    if variant == "decoupled_capped":
        kw["behav_imp_weight_cap"] = 1.2
    want_loss, want_stats = JF.actor_loss_fn(**{k: J(v) for k, v in args.items()}, **kw)
    got_loss, got_stats = TF.actor_loss_fn(**{k: Tt(v) for k, v in args.items()}, **kw)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert_tree_close({k: v.item() for k, v in got_stats.items()},
                      {k: float(v) for k, v in want_stats.items()})
    if variant == "decoupled_capped":
        assert got_stats["actor_denom"].item() < args["stats_mask"].sum()  # the cap dropped tokens
    # and its gradient with respect to the current logprobs
    want_g = jax.grad(lambda lp: JF.actor_loss_fn(
        **{**{k: J(v) for k, v in args.items()}, "logprobs": lp}, **kw)[0])(J(args["logprobs"]))
    lp = Tt(args["logprobs"]).requires_grad_(True)
    TF.actor_loss_fn(**{**{k: Tt(v) for k, v in args.items()}, "logprobs": lp}, **kw)[0].backward()
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(want_g), atol=1e-5, rtol=1e-5)


def test_critic_loss_matches_reference():
    rng, f, mask = row_inputs(3)
    old = f()
    args = dict(value=old + f(0.5), old_value=old, target_value=f(), loss_mask=mask)
    want_loss, want_stats = JF.critic_loss_fn(**{k: J(v) for k, v in args.items()},
                                              value_eps_clip=0.2)
    got_loss, got_stats = TF.critic_loss_fn(**{k: Tt(v) for k, v in args.items()},
                                            value_eps_clip=0.2)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    assert_tree_close({k: v.item() for k, v in got_stats.items()},
                      {k: float(v) for k, v in want_stats.items()})


def test_controllers_and_running_mean_std_match_reference():
    ja, ta = JF.AdaptiveKLController(0.1, 6.0, 100.0), TF.AdaptiveKLController(0.1, 6.0, 100.0)
    for kl, n in ((9.0, 40), (2.0, 10), (6.5, 25)):
        ja.update(kl, n)
        ta.update(kl, n)
    assert ta.value == ja.value != 0.1
    jf, tf_ = JF.FixedKLController(0.3), TF.FixedKLController(0.3)
    tf_.update(5.0, 10)
    assert tf_.value == jf.value == 0.3
    rng = np.random.default_rng(4)
    jr, tr = JF.RunningMeanStd(), TF.RunningMeanStd()
    for _ in range(3):
        x, m = rng.standard_normal(50) * 3 + 1, rng.random(50) > 0.4
        jr.update(x, mask=m)
        tr.update(x, mask=m)
    assert tr.state_dict() == jr.state_dict()
    np.testing.assert_array_equal(tr.normalize(x), jr.normalize(x))
    np.testing.assert_array_equal(tr.denormalize(x), jr.denormalize(x))


def test_masks_match_reference():
    rng = np.random.default_rng(5)
    seg = np.zeros((R, T), np.int32)
    seg[0, :15], seg[0, 15:33] = 1, 2
    seg[1, :40] = 1
    pm = np.zeros((R, T), np.int32)
    pm[0, :5], pm[0, 15:22], pm[1, :11] = 1, 1, 1
    want = jppo.response_scoring_mask(J(seg), J(pm))
    got = tppo.response_scoring_mask(Tt(seg), Tt(pm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tppo.last_response_position_mask(got).numpy(),
        np.asarray(jppo.last_response_position_mask(want)))
    assert got.sum() > 0


# ----------------------------------------------------------------------
# One train_step of each interface through both packages
# ----------------------------------------------------------------------


def numpy_params(is_critic=False, seed=0):
    cfg = JaxConfig(**CFG, is_critic=is_critic)
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                  jt.init_params(cfg, jax.random.PRNGKey(seed)))


def make_models(is_critic=False, seed=0):
    tree = numpy_params(is_critic, seed)
    jeng = JaxTrainEngine(JaxConfig(**CFG, is_critic=is_critic),
                          jax.tree_util.tree_map(jnp.asarray, tree),
                          optimizer_config=JOptimizerConfig(**OPT),
                          total_train_steps=100, row_len_multiple=32)
    teng = TorchTrainEngine(TransformerConfig(**CFG, is_critic=is_critic),
                            params_from_numpy(tree, device="cpu"),
                            optimizer_config=OptimizerConfig(**OPT),
                            total_train_steps=100, row_len_multiple=32, device="cpu")
    return (JModel(name=JModelName("m"), module=jeng, tokenizer=None),
            Model(name=ModelName("m"), module=teng, tokenizer=None))


def rollout_data(seed=0, n_prompts=4, group=2, with_values=False):
    """A grouped rollout batch as the rollout workers hand it to the
    trainer: prompt + response tokens, behaviour logprobs in the shifted
    frame, per-sequence rewards and no-EOS flags."""
    rng = np.random.RandomState(seed)
    seqs, pms, blps, group_lens = [], [], [], []
    for _ in range(n_prompts):
        plen = int(rng.randint(3, 8))
        lens = []
        for _ in range(group):
            glen = int(rng.randint(2, 11))
            n = plen + glen
            seqs.append(rng.randint(1, 64, size=n))
            pm = np.zeros(n, np.int64)
            pm[:plen] = 1
            pms.append(pm)
            lp = np.zeros(n, np.float32)
            lp[plen - 1:n - 1] = -np.abs(rng.randn(glen)) - 0.1
            blps.append(lp)
            lens.append(n)
        group_lens.append(lens)
    n_seqs = n_prompts * group
    total = sum(map(sum, group_lens))
    per_seq = [[1] * group for _ in range(n_prompts)]
    data = {
        "packed_input_ids": np.concatenate(seqs),
        "prompt_mask": np.concatenate(pms),
        "packed_logprobs": np.concatenate(blps),
        "seq_no_eos_mask": (rng.rand(n_seqs) > 0.6).astype(np.float32),
        # One good and one bad answer per group: group normalization
        # divides by the group's spread, and a group of equal rewards
        # would blow float32 rounding up past any fixed limit.
        "rewards": np.tile([5.0, -5.0], n_seqs // 2).astype(np.float32),
    }
    data["ref_logprobs"] = (data["packed_logprobs"] + 0.01 * rng.randn(total)).astype(np.float32)
    seqlens = {k: group_lens for k in ("packed_input_ids", "prompt_mask", "packed_logprobs",
                                       "ref_logprobs")}
    seqlens.update(seq_no_eos_mask=per_seq, rewards=per_seq)
    if with_values:
        data["values"] = (rng.randn(total) * 0.1).astype(np.float32)
        seqlens["values"] = group_lens
    ids = [f"p{i}" for i in range(n_prompts)]
    meta = {"version_start": [0] * n_prompts, "version_end": [0] * n_prompts}

    def build(cls):
        return cls(ids=list(ids), keys=set(data), data={k: v.copy() for k, v in data.items()},
                   seqlens={k: [list(s) for s in v] for k, v in seqlens.items()},
                   metadata={k: list(v) for k, v in meta.items()})

    return build(JSequenceSample), build(SequenceSample)


def assert_stats_close(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6, err_msg=k)


PPO_VARIANTS = {
    "grpo_adaptive_kl": (dict(adv_norm=True, adaptive_kl_ctl=True, adaptive_kl_target=0.01,
                              adaptive_kl_horizon=50.0, discount=0.99, gae_lambda=0.95), False),
    "decoupled_critic_group_norm": (dict(use_decoupled_loss=True, behav_imp_weight_cap=10.0,
                                         group_adv_norm=True, c_clip=3.0,
                                         mask_no_eos_with_zero=True), True),
}


@pytest.mark.parametrize("variant", sorted(PPO_VARIANTS))
def test_ppo_actor_train_step_matches_reference(variant):
    kw, with_values = PPO_VARIANTS[variant]
    jmodel, tmodel = make_models(seed=1)
    jsample, tsample = rollout_data(seed=1, with_values=with_values)
    jitf = jppo.PPOActorInterface(n_minibatches=2, **kw)
    titf = make_interface("ppo_actor", n_minibatches=2, **kw)
    assert isinstance(titf, tppo.PPOActorInterface)
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
    assert titf.kl_controller.value == pytest.approx(jitf.kl_controller.value, rel=1e-6)
    if kw.get("adaptive_kl_ctl"):
        assert titf.kl_controller.value != 0.1  # the controller moved
    assert tmodel.version == jmodel.version == 1
    assert tmodel.module.optimizer.count == 2


def test_ppo_critic_train_step_matches_reference():
    jmodel, tmodel = make_models(is_critic=True, seed=2)
    jsample, tsample = rollout_data(seed=2)
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
    assert titf.rms.state_dict() == pytest.approx(jitf.rms.state_dict(), rel=1e-6)


def test_sft_train_step_matches_reference():
    jmodel, tmodel = make_models(seed=3)
    jsample, tsample = rollout_data(seed=3)
    want = jsft.SFTInterface().train_step(jmodel, jsample, JMicroBatchSpec(n_mbs=2))
    got = make_interface("sft").train_step(tmodel, tsample, MicroBatchSpec(n_mbs=2))
    assert_stats_close(got, want)
    assert tsft.sft_loss_weight(tsample) == jsft.sft_loss_weight(jsample) > 0
    assert tmodel.version == 1
