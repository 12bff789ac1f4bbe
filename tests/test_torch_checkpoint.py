"""Port parity of the engine-state checkpoint (``engine/checkpoint.py``)
against ``areal_tpu/engine/checkpoint.py``.

- Both ways between the packages: an engine of each trains two SFT steps
  from the same numpy params (float32 compute); one package saves, the
  other's ``load_engine_state`` loads into an engine built from other
  params. Params, ``mu``, ``nu``, both optax counts, ``_lr_steps``, the
  call counters and the host generators come back bit-equal (the
  reference's schedule count equals its number of updates, and the
  port's Adam count is that number). The two packages' manifests of the
  same two steps are equal field by field. One more step from the
  loaded state equals the writer's uninterrupted third step: stats within
  rtol 1e-3, params within 1e-5 (absolute).
- The pickle's globals are the ones optax 0.2.6 writes, taken from a
  reference pickle; the port's reader loads a reference pickle in a
  subprocess where jax, optax, ml_dtypes and areal_tpu cannot be
  imported, and refuses a pickle that names any other class (a bfloat16
  array, whose dtype needs ml_dtypes, with an error that says so).
- The async writer: a submit followed by an in-place train step writes
  the state as of the submit (a snapshot that were a reference would be
  written torn, and fail here); overlapping submits land in order; an
  error surfaces at the next wait and the writer stays usable.
- Ports of tests/engine/test_checkpoint_durable.py: the manifest is the
  commit record, RNG counters and the LR-schedule position round-trip,
  the host generators continue their stream, a legacy pickle without
  the durable fields loads. The orbax backend is refused.
"""

import collections
import os
import pickle
import random
import subprocess
import sys
import textwrap
import threading
import time

import jax
import numpy as np
import pytest
import torch

from areal_tpu.base import seeding as rseeding
from areal_tpu.engine import checkpoint as rck
from areal_tpu_torch.base import seeding as tseeding
from areal_tpu_torch.engine import checkpoint as tck
from areal_tpu_torch.engine.optimizer import OPTAX_STATE_NAMES, tree_leaves
from tests.test_torch_train_engine import (
    JMicroBatchSpec,
    MicroBatchSpec,
    jsft,
    make_engines,
    numpy_params,
    samples,
    tsft,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-3
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _pickle_sync(monkeypatch):
    monkeypatch.setenv("AREAL_CKPT_BACKEND", "pickle")
    monkeypatch.delenv("AREAL_CKPT_ASYNC", raising=False)


def _jstep(jeng, jsample):
    return jeng.train_batch(jsample, JMicroBatchSpec(n_mbs=2), jsft.sft_row_loss,
                            jsft.sft_loss_weight, loss_name="sft")


def _tstep(teng, tsample):
    return teng.train_batch(tsample, MicroBatchSpec(n_mbs=2), tsft.sft_row_loss,
                            tsft.sft_loss_weight, loss_name="sft")


def _ref_state(jeng):
    """Params, mu, nu (flat numpy lists) and both counts of a JaxTrainEngine."""
    adam, sched = jeng.opt_state[1][0], jeng.opt_state[1][2]
    flat = lambda t: [np.array(x) for x in jax.tree_util.tree_leaves(t)]
    return (flat(jeng.params), flat(adam.mu), flat(adam.nu),
            int(np.asarray(adam.count)), int(np.asarray(sched.count)))


def _port_state(teng):
    flat = lambda xs: [x.detach().numpy().copy() for x in xs]
    opt = teng.optimizer
    return (flat(tree_leaves(teng.params)), flat(opt.mu), flat(opt.nu), opt.count, opt.count)


def _assert_states_equal(a, b):
    for xs, ys in zip(a[:3], b[:3]):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    assert a[3:] == b[3:]


def _trained():
    jeng, teng = make_engines(numpy_params())
    jsample, tsample = samples()
    for _ in range(2):
        _jstep(jeng, jsample)
        _tstep(teng, tsample)
    return jeng, teng, jsample, tsample


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_engine_state_crosses_packages(writer, tmp_path):
    jeng, teng, jsample, tsample = _trained()
    # The reference's schedule count is the number of updates, which is
    # the port's one Adam count.
    assert _ref_state(jeng)[3:] == (2, 2) == _port_state(teng)[3:]
    for s in (rseeding, tseeding):
        s.set_random_seed(5, "trainer0")
    np.random.rand(3)
    random.random()
    host_rng = tseeding.state_dict()
    # Both packages' manifests of the same two steps.
    rck.save_engine_state(jeng, str(tmp_path / "ref"))
    tck.save_engine_state(teng, str(tmp_path / "port"))
    man = {k: tck.load_manifest(str(tmp_path / k)) for k in ("ref", "port")}
    assert man["port"] == man["ref"] == dict(
        schema="areal-train-ckpt/v1", version=0, version_steps=2,
        rng=dict(gen_calls=0, train_calls=2, lr_steps=2), dataset_cursors=None,
        artifact="engine_state.pkl")

    np.random.rand(5)  # a later history, undone by the load
    src_dir = str(tmp_path / writer)
    j2, t2 = make_engines(numpy_params(seed=1))
    if writer == "port":
        rck.load_engine_state(j2, src_dir)
        _assert_states_equal(_ref_state(j2), _port_state(teng))
        loaded, counters = j2, j2.rng_state()
    else:
        tck.load_engine_state(t2, src_dir)
        _assert_states_equal(_port_state(t2), _ref_state(jeng))
        loaded, counters = t2, t2.rng_state()
    assert counters == dict(gen_calls=0, train_calls=2, lr_steps=2)
    assert loaded.version == 0 and loaded._lr_steps == 2
    got = tseeding.state_dict()
    assert got["python_random"] == host_rng["python_random"]
    for a, b in zip(got["numpy_random"], host_rng["numpy_random"]):
        np.testing.assert_array_equal(a, b)

    # One more step from the loaded state against the writer's own third step.
    if writer == "port":
        want, got = _tstep(teng, tsample), _jstep(j2, jsample)
        want_p, got_p = _port_state(teng)[0], _ref_state(j2)[0]
    else:
        want, got = _jstep(jeng, jsample), _tstep(t2, tsample)
        want_p, got_p = _ref_state(jeng)[0], _port_state(t2)[0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STAT_RTOL, err_msg=k)
    for a, b in zip(got_p, want_p):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def _globals(path):
    """(module, name) of every global a pickle names, in order (it loads
    here, where optax is installed)."""
    seen = []

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            seen.append((module, name))
            return super().find_class(module, name)

    with open(path, "rb") as f:
        Recording(f).load()
    return seen


def test_the_pickles_name_optax_classes(tmp_path):
    """The stand-ins' names are those a reference pickle holds, taken from
    one written here; the port's pickle names the same globals."""
    jeng, teng, _, _ = _trained()
    rck.save_engine_state(jeng, str(tmp_path / "ref"))
    tck.save_engine_state(teng, str(tmp_path / "port"))
    want = _globals(tmp_path / "ref" / "engine_state.pkl")
    got = _globals(tmp_path / "port" / "engine_state.pkl")
    optax_names = sorted(n for n in set(want) if n[0].startswith("optax"))
    assert optax_names == sorted(OPTAX_STATE_NAMES.values())
    assert sorted(set(got)) == sorted(set(want))
    # The reference pickle's optimizer state, read without optax, has the
    # reference's structure.
    state = tck.load_state_file(str(tmp_path / "ref"))
    opt = state["opt_state"]
    assert [type(x).__name__ for x in (opt[0], *opt[1])] == [
        "EmptyState", "ScaleByAdamState", "MaskedState", "ScaleByScheduleState"]
    assert type(opt[1][1].inner_state).__name__ == "EmptyState"
    assert opt[1][0].count.dtype == np.int32 and opt[1][0].count.shape == ()


_BLOCKED_LOAD = textwrap.dedent("""
    import sys
    for name in ("jax", "optax", "ml_dtypes", "areal_tpu"):
        sys.modules[name] = None  # any import of them raises ImportError
    from areal_tpu_torch.engine import checkpoint
    state = checkpoint.load_state_file(sys.argv[1])
    assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "optax", "ml_dtypes")
                and sys.modules[m] is not None]
    print(sorted(state), type(state["opt_state"][1][0]).__module__, state["version_steps"])
""")


def test_the_reader_loads_a_reference_pickle_without_jax(tmp_path):
    jeng, _, _, _ = _trained()
    rck.save_engine_state(jeng, str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_LOAD, str(tmp_path)],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO_ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == [
        "['host_rng',", "'opt_state',", "'params',", "'rng',", "'version',",
        "'version_steps']", "areal_tpu_torch.engine.optimizer", "2"]


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload,match", [
    (_Evil(), "refusing to unpickle the global"),
    ({"params": {"w": np.zeros(2, np.float32)}, "counts": collections.Counter("ab")},
      "refusing to unpickle the global collections.Counter"),
    ("bf16", "ml_dtypes"),
])
def test_the_reader_refuses_other_classes(payload, match, tmp_path):
    if payload == "bf16":
        import ml_dtypes

        payload = {"params": {"w": np.zeros(2, dtype=ml_dtypes.bfloat16)}}
    with open(tmp_path / "engine_state.pkl", "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(pickle.UnpicklingError, match=match):
        tck.load_state_file(str(tmp_path))


def test_a_bfloat16_param_is_refused_at_save(tmp_path):
    _, teng, _, _ = _trained()
    teng.params["final_norm"]["weight"] = teng.params["final_norm"]["weight"].bfloat16()
    with pytest.raises(NotImplementedError, match="ml_dtypes"):
        tck.save_engine_state(teng, str(tmp_path))


def test_the_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """A submit followed by an in-place train step writes the state as of
    the submit: the writer is held until the step is done."""
    _, teng, _, tsample = _trained()
    want = _port_state(teng)
    stepped = threading.Event()
    host_state = tck._state

    def after_the_step(*args):
        assert stepped.wait(60)
        return host_state(*args)

    monkeypatch.setattr(tck, "_state", after_the_step)
    writer = tck.AsyncCheckpointWriter()
    try:
        stall = writer.submit(teng, str(tmp_path))
        assert stall >= 0.0 and tck.ckpt_stats["areal:train_ckpt_stall_ms"] == stall
        _tstep(teng, tsample)  # AdamW.apply updates params and moments in place
        stepped.set()
        writer.wait(timeout=60)
    finally:
        writer.close()
    _, t2 = make_engines(numpy_params(seed=1))
    tck.load_engine_state(t2, str(tmp_path))
    _assert_states_equal(_port_state(t2), want)
    assert t2._lr_steps == 2
    assert not np.array_equal(_port_state(teng)[0][0], want[0][0])


class _Stream:
    def synchronize(self):
        pass


@pytest.mark.parametrize("shape,staging_bytes", [((3, 5), 7), ((1000,), 4000), ((2, 3, 4), 1)])
def test_the_staged_host_copy_is_exact(shape, staging_bytes):
    """The writer's copy through a small staging buffer, chunk boundaries
    falling inside elements, gives the tensor's bytes exactly (on the card
    the buffer is pinned and the stream a side stream)."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    got = tck._staged_copy(x, torch.empty(staging_bytes, dtype=torch.uint8), _Stream())
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, x.numpy())


def test_async_overlapping_submits_land_in_order(tmp_path):
    _, teng, _, tsample = _trained()
    writer = tck.AsyncCheckpointWriter()
    try:
        for v in range(1, 4):
            _tstep(teng, tsample)
            teng.version = v
            writer.submit(teng, str(tmp_path))
        writer.wait(timeout=60)
        assert writer.pending() == 0 and writer.last_write_s() > 0.0
    finally:
        writer.close()
    assert tck.load_manifest(str(tmp_path))["version"] == 3
    _, t2 = make_engines(numpy_params(seed=1))
    tck.load_engine_state(t2, str(tmp_path))
    _assert_states_equal(_port_state(t2), _port_state(teng))


def test_async_writer_error_surfaces_at_the_next_call(tmp_path):
    _, teng, _, _ = _trained()
    writer = tck.AsyncCheckpointWriter()
    try:
        blocker = tmp_path / "blocker"
        blocker.write_text("not a directory")
        writer.submit(teng, str(blocker / "sub"))
        with pytest.raises(OSError):
            writer.wait(timeout=60)
        # Consumed: the writer is usable afterwards.
        writer.submit(teng, str(tmp_path / "ok"))
        writer.wait(timeout=60)
        assert tck.load_manifest(str(tmp_path / "ok")) is not None
        # An error left pending surfaces at the next submit.
        writer.submit(teng, str(blocker / "sub"))
        while writer.pending():
            time.sleep(0.01)
        with pytest.raises(OSError):
            writer.submit(teng, str(tmp_path / "ok"))
    finally:
        writer.close()


def test_async_save_through_the_env_and_the_read_barrier(tmp_path, monkeypatch):
    monkeypatch.setenv("AREAL_CKPT_ASYNC", "1")
    _, teng, _, _ = _trained()
    teng.version = 3
    tck.save_engine_state(teng, str(tmp_path))
    assert tck.has_engine_state(str(tmp_path))  # takes the read barrier
    assert tck.load_manifest(str(tmp_path))["version"] == 3
    _, t2 = make_engines(numpy_params(seed=1))
    tck.load_engine_state(t2, str(tmp_path))
    _assert_states_equal(_port_state(t2), _port_state(teng))
    assert t2.version == 3


def test_manifest_is_the_commit_record(tmp_path):
    _, teng, _, _ = _trained()
    teng.version = 4
    cursors = {"model_worker/0": {"epoch": 1, "offset": 128}}
    tck.save_engine_state(teng, str(tmp_path), dataset_cursors=cursors)
    assert tck.ckpt_stats["areal:train_ckpt_stall_ms"] > 0.0
    man = tck.load_manifest(str(tmp_path))
    assert man["version"] == 4 and man["version_steps"] == teng._lr_steps
    assert man["rng"] == teng.rng_state() and man["dataset_cursors"] == cursors
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    assert tck.load_manifest(str(tmp_path / "none")) is None
    (tmp_path / "manifest.json").write_text('{"schema": "other/v1"}')
    assert tck.load_manifest(str(tmp_path)) is None


def test_rng_counters_and_schedule_position_round_trip(tmp_path):
    _, teng, _, _ = _trained()
    teng._gen_calls, teng._lr_steps, teng.version = 9, 17, 2
    tck.save_engine_state(teng, str(tmp_path))
    _, t2 = make_engines(numpy_params(seed=1))
    tck.load_engine_state(t2, str(tmp_path))
    assert t2.rng_state() == teng.rng_state() and t2._lr_steps == 17 and t2.version == 2


def test_host_generators_continue_after_restore(tmp_path):
    _, teng, _, _ = _trained()
    tseeding.set_random_seed(11, "trainer0")
    np.random.rand(3)
    random.random()
    tck.save_engine_state(teng, str(tmp_path))
    want_np, want_py = np.random.rand(4), random.random()
    tseeding.set_random_seed(55, "other")
    np.random.rand(7)
    _, t2 = make_engines(numpy_params(seed=1))
    tck.load_engine_state(t2, str(tmp_path))
    np.testing.assert_array_equal(np.random.rand(4), want_np)
    assert random.random() == want_py
    assert tseeding.get_seed() == 11


def test_a_legacy_pickle_without_the_durable_fields_loads(tmp_path):
    """A reference checkpoint from before the durable plane: no
    version_steps, rng or host_rng, no manifest; the schedule position
    falls back to the version."""
    jeng, teng, _, _ = _trained()
    state = {"params": rck._to_host(jeng.get_params()),
             "opt_state": rck._to_host(jeng.opt_state), "version": 5}
    with open(tmp_path / "engine_state.pkl", "wb") as f:
        pickle.dump(state, f)
    _, t2 = make_engines(numpy_params(seed=1))
    tck.load_engine_state(t2, str(tmp_path))
    assert t2.version == 5 and t2._lr_steps == 5
    _assert_states_equal(_port_state(t2), _ref_state(jeng))


def test_the_orbax_backend_is_refused(tmp_path, monkeypatch):
    _, teng, _, _ = _trained()
    with pytest.raises(NotImplementedError, match="item 7"):
        tck.save_engine_state(teng, str(tmp_path), backend="orbax")
    monkeypatch.setenv("AREAL_CKPT_BACKEND", "orbax")
    with pytest.raises(NotImplementedError, match="item 7"):
        tck.save_engine_state(teng, str(tmp_path))
    os.makedirs(tmp_path / "engine_state_orbax")
    assert tck.has_engine_state(str(tmp_path))
    with pytest.raises(NotImplementedError, match="item 7"):
        tck.load_engine_state(teng, str(tmp_path))


def test_an_engine_without_optimizer_saves_params_only(tmp_path):
    from areal_tpu_torch.convert import params_from_numpy
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.models.config import TransformerConfig
    from tests.test_torch_train_engine import CFG

    eng = TorchTrainEngine(TransformerConfig(**CFG), params_from_numpy(numpy_params(), "cpu"),
                           device="cpu")
    assert eng.get_opt_state() is None
    tck.save_engine_state(eng, str(tmp_path))
    assert tck.load_state_file(str(tmp_path))["opt_state"] is None
    # The reference's gradient-free engine loads it.
    jeng, _ = make_engines(numpy_params(seed=1))
    rck.load_engine_state(jeng, str(tmp_path))
    for a, b in zip(_ref_state(jeng)[0], [x.detach().numpy() for x in tree_leaves(eng.params)]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError):
        eng.set_opt_state(())
