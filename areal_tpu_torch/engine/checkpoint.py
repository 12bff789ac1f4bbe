"""Engine-state checkpoints for recovery (the port's copy of the pickle
backend of ``areal_tpu/engine/checkpoint.py``).

A checkpoint directory holds ``engine_state.pkl`` (params, optimizer
state in optax's layout, version, LR-schedule position, the engine's
call counters and the host generators' state) and ``manifest.json``
(``areal-train-ckpt/v1``), written LAST as the commit record. Every file
lands tmp + fsync + rename + fsync of the directory. The pickle is the
reference's: leaves are numpy arrays and the optimizer states are
written under optax's names (``base/pickle_compat.py``), so the
reference's ``load_engine_state`` loads what the port saved and the
port loads what the reference saved, without jax, optax or ml_dtypes.

``AREAL_CKPT_ASYNC`` routes saves through ``AsyncCheckpointWriter``:
the step loop pays for a snapshot (a device ``clone`` of every tensor:
``AdamW.apply`` updates params and moments in place, so a bare
reference would be written torn) and the collected metadata; the copy
to the host, pickling, fsync and the manifest commit run on the writer
thread. The host copy goes through a small pinned buffer on a side
stream (a DMA, then a host memcpy), so the trainer's stream does not
queue behind it. Errors surface at the next ``submit`` / ``wait``.

``AREAL_CKPT_BACKEND=orbax`` (the reference's sharded multi-host
backend), and an orbax directory met on load, raise
``NotImplementedError``: ROADMAP Queue A item 7.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Dict, Optional

import torch

from areal_tpu_torch.base import env_registry, logging, pickle_compat, seeding
from areal_tpu_torch.base.fault_injection import faults
from areal_tpu_torch.base.wire_schemas import TRAIN_CKPT_V1
from areal_tpu_torch.engine.optimizer import OPTAX_STATE_NAMES

logger = logging.getLogger("checkpoint")

# Bytes of the pinned buffer the writer stages each device tensor
# through: a pageable device-to-host copy is staged by the driver, and the
# train step that overlapped one ran ~10x slower on the H100.
_STAGING_BYTES = 64 << 20

_STATE_FILE = "engine_state.pkl"
_ORBAX_DIR = "engine_state_orbax"
_MANIFEST_FILE = "manifest.json"

# Step-loop stall of the most recent save on this process: the whole save
# when synchronous, the snapshot and hand-off only when async.
ckpt_stats = {"areal:train_ckpt_stall_ms": 0.0}

# The classes an engine-state pickle may name: the optax states, stood in
# for by the optimizer's NamedTuples.
_OPT_CLASSES = {names: cls for cls, names in OPTAX_STATE_NAMES.items()}


def _orbax_refused() -> NotImplementedError:
    return NotImplementedError(
        "the orbax checkpoint backend (sharded, multi-host) is not ported: "
        "use AREAL_CKPT_BACKEND=pickle (ROADMAP Queue A item 7, multi-device)")


def _map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists, tuples and
    NamedTuples; other values are leaves."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _host_leaf(x, staged=None):
    """A numpy copy of a tensor leaf (other leaves pass); ``staged`` copies
    a CUDA tensor to the host in its own way."""
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(
            "a bfloat16 leaf cannot be checkpointed: the reference's pickle holds "
            "numpy arrays, and numpy has bfloat16 only through ml_dtypes, which "
            "the port does not use; train with float32 params")
    if staged is not None and x.is_cuda:
        return staged(x)
    return x.detach().cpu().numpy()


def _to_host(tree: Any, staged=None) -> Any:
    return _map(lambda x: _host_leaf(x, staged), tree)


def _staged_copy(x: torch.Tensor, staging: torch.Tensor, stream) -> Any:
    """``x`` on the host through ``staging`` (pinned bytes), chunk by chunk:
    a DMA into the pinned buffer on ``stream``, which must be the current
    stream, then a host memcpy once the stream has finished it."""
    out = torch.empty(x.shape, dtype=x.dtype)
    src = x.detach().contiguous().view(-1).view(torch.uint8)
    dst = out.view(-1).view(torch.uint8)
    for i in range(0, src.numel(), staging.numel()):
        n = min(staging.numel(), src.numel() - i)
        staging[:n].copy_(src[i:i + n], non_blocking=True)
        stream.synchronize()
        dst[i:i + n].copy_(staging[:n])
    return out.numpy()


def _snapshot_tree(tree: Any) -> Any:
    """A copy of every tensor, taken on its device (``clone`` is enqueued
    on the current stream, so later in-place updates come after it);
    numpy leaves are replaced, never mutated, so references suffice."""
    return _map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x, tree)


def _cuda_device(tree: Any) -> Optional[torch.device]:
    """The device of the tree's first CUDA tensor, if any."""
    found = []
    _map(lambda x: found.append(x.device) if isinstance(x, torch.Tensor) and x.is_cuda
         else None, tree)
    return found[0] if found else None


def _engine_state(engine):
    params = engine.get_params() if hasattr(engine, "get_params") else engine.params
    opt = (engine.get_opt_state() if hasattr(engine, "get_opt_state")
           else getattr(engine, "opt_state", None))
    return params, opt


def _ckpt_backend(backend: Optional[str]) -> str:
    return backend or env_registry.get_str("AREAL_CKPT_BACKEND")


def _fsync_dir(path: str):
    dir_fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _collect_meta(engine, dataset_cursors: Optional[Dict] = None) -> Dict[str, Any]:
    """Everything a resume needs beyond the params and the optimizer
    state, taken on the caller's thread with the snapshot."""
    version = int(engine.version)
    return {
        "version": version,
        "version_steps": int(getattr(engine, "_lr_steps", version)),
        "rng": engine.rng_state() if hasattr(engine, "rng_state") else {},
        "host_rng": seeding.state_dict(),
        "dataset_cursors": dataset_cursors,
    }


def _write_manifest(save_dir: str, meta: Dict[str, Any], artifact: str):
    """The commit record, written LAST: a directory without a current
    manifest holds no checkpoint."""
    manifest = {
        "schema": TRAIN_CKPT_V1,
        "version": meta["version"],
        "version_steps": meta["version_steps"],
        "rng": meta["rng"],
        "dataset_cursors": meta["dataset_cursors"],
        "artifact": artifact,
    }
    path = os.path.join(save_dir, _MANIFEST_FILE)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # The commit point: a kill here leaves the old manifest or the new
    # one, never a torn file.
    faults.maybe_fail("train.checkpoint")
    os.replace(tmp, path)
    _fsync_dir(save_dir)


def load_manifest(load_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(load_dir, _MANIFEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        m = json.load(f)
    if m.get("schema") != TRAIN_CKPT_V1:
        logger.warning("ignoring manifest with schema %r at %s", m.get("schema"), load_dir)
        return None
    return m


def _write_pickle_state(save_dir: str, state: Dict[str, Any]):
    tmp = os.path.join(save_dir, f"{_STATE_FILE}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        pickle_compat.dump(state, f, OPTAX_STATE_NAMES, protocol=5)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, _STATE_FILE))
    _fsync_dir(save_dir)


def _state(params, opt, meta, staged=None) -> Dict[str, Any]:
    return {
        "params": _to_host(params, staged),
        "opt_state": _to_host(opt, staged) if opt is not None else None,
        "version": meta["version"],
        "version_steps": meta["version_steps"],
        "rng": meta["rng"],
        "host_rng": meta["host_rng"],
    }


class AsyncCheckpointWriter:
    """Background writer of pickle checkpoints (``AREAL_CKPT_ASYNC``).

    ``submit`` runs on the step loop: it snapshots params and optimizer
    state on their device, records an event after the copies and queues
    the job with the resume metadata. One writer thread then copies the
    snapshot to the host on a side stream that waits for that event,
    pickles, fsyncs and commits the manifest (one thread, so submits to
    one directory serialize). Errors surface at the next ``submit`` /
    ``wait``; ``wait`` is the read barrier a load takes first.
    """

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._cond = threading.Condition()
        self._pending = 0
        self._last_error: Optional[BaseException] = None
        self._last_write_s = 0.0
        self._last_host_s = 0.0
        self._staging: Optional[torch.Tensor] = None  # the writer thread's own
        self._thread = threading.Thread(target=self._run, daemon=True, name="ckpt-writer")
        self._thread.start()

    def submit(self, engine, save_dir: str, dataset_cursors: Optional[Dict] = None) -> float:
        """Snapshot + enqueue; returns the step-loop stall in ms."""
        t0 = time.monotonic()
        self._raise_pending_error()
        params, opt = _engine_state(engine)
        job = {
            "save_dir": save_dir,
            "params": _snapshot_tree(params),
            "opt": _snapshot_tree(opt) if opt is not None else None,
            "meta": _collect_meta(engine, dataset_cursors),
            "device": _cuda_device(params) or _cuda_device(opt),
            "event": None,
        }
        if job["device"] is not None:
            # The writer's side stream waits for the clones, nothing else.
            job["event"] = torch.cuda.Event()
            job["event"].record(torch.cuda.current_stream(job["device"]))
        with self._cond:
            self._pending += 1
        self._q.put(job)
        stall_ms = (time.monotonic() - t0) * 1e3
        ckpt_stats["areal:train_ckpt_stall_ms"] = stall_ms
        return stall_ms

    def wait(self, timeout: Optional[float] = None):
        """Block until every submitted write committed; re-raise the first
        writer error, if any."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._pending == 0, timeout=timeout):
                raise TimeoutError(f"async checkpoint writes still pending after {timeout}s")
        self._raise_pending_error()

    def _raise_pending_error(self):
        with self._cond:
            err, self._last_error = self._last_error, None
        if err is not None:
            raise err

    def pending(self) -> int:
        with self._cond:
            return self._pending

    def last_write_s(self) -> float:
        with self._cond:
            return self._last_write_s

    def last_host_s(self) -> float:
        """Seconds of the last write's host copy (the rest is pickling,
        the file writes and fsync)."""
        with self._cond:
            return self._last_host_s

    def _host_state(self, job) -> Dict[str, Any]:
        if job["event"] is None:
            return _state(job["params"], job["opt"], job["meta"])
        if self._staging is None:
            self._staging = torch.empty(_STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
        side = torch.cuda.Stream(device=job["device"])
        side.wait_event(job["event"])
        with torch.cuda.stream(side):  # the DMAs go on the side stream
            return _state(job["params"], job["opt"], job["meta"],
                          staged=lambda x: _staged_copy(x, self._staging, side))

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            err: Optional[BaseException] = None
            t0 = time.monotonic()
            host_s = 0.0
            try:
                os.makedirs(job["save_dir"], exist_ok=True)
                state = self._host_state(job)
                host_s = time.monotonic() - t0
                # The device snapshot is freed before the bytes go to disk.
                job["params"] = job["opt"] = None
                _write_pickle_state(job["save_dir"], state)
                del state
                _write_manifest(job["save_dir"], job["meta"], _STATE_FILE)
                logger.info("saved engine state (async) to %s", job["save_dir"])
            except BaseException as e:  # surfaced at the next submit()/wait()
                logger.exception("async checkpoint write failed")
                err = e
            job = None
            elapsed = time.monotonic() - t0
            with self._cond:
                self._pending -= 1
                self._last_write_s = elapsed
                self._last_host_s = host_s
                if err is not None and self._last_error is None:
                    self._last_error = err
                self._cond.notify_all()

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=30)


_ASYNC_WRITER: Optional[AsyncCheckpointWriter] = None
_WRITER_INIT_LOCK = threading.Lock()


def get_async_writer() -> AsyncCheckpointWriter:
    global _ASYNC_WRITER
    with _WRITER_INIT_LOCK:
        if _ASYNC_WRITER is None:
            _ASYNC_WRITER = AsyncCheckpointWriter()
        return _ASYNC_WRITER


def wait_pending_writes(timeout: Optional[float] = None):
    """Read barrier: block until in-flight async writes committed (a
    no-op when the writer was never created)."""
    writer = _ASYNC_WRITER
    if writer is not None:
        writer.wait(timeout)


def writer_stats() -> Optional[Dict[str, Any]]:
    """The async writer's pending writes and the seconds of its last one
    (None when no async save ran in this process)."""
    writer = _ASYNC_WRITER
    if writer is None:
        return None
    return {"pending": writer.pending(), "last_write_s": writer.last_write_s(),
            "last_host_s": writer.last_host_s()}


def save_engine_state(engine, save_dir: str, backend: Optional[str] = None,
                      dataset_cursors: Optional[Dict] = None):
    if _ckpt_backend(backend) == "orbax":
        raise _orbax_refused()
    if env_registry.get_bool("AREAL_CKPT_ASYNC"):
        get_async_writer().submit(engine, save_dir, dataset_cursors)
        return
    t0 = time.monotonic()
    os.makedirs(save_dir, exist_ok=True)
    params, opt = _engine_state(engine)
    meta = _collect_meta(engine, dataset_cursors)
    _write_pickle_state(save_dir, _state(params, opt, meta))
    _write_manifest(save_dir, meta, _STATE_FILE)
    logger.info(f"saved engine state to {save_dir}")
    ckpt_stats["areal:train_ckpt_stall_ms"] = (time.monotonic() - t0) * 1e3


def load_state_file(load_dir: str) -> Dict[str, Any]:
    """The state dict of a directory's ``engine_state.pkl`` (numpy
    leaves, optimizer states as the optimizer's stand-ins)."""
    with open(os.path.join(load_dir, _STATE_FILE), "rb") as f:
        return pickle_compat.load(f, _OPT_CLASSES)


def load_engine_state(engine, load_dir: str):
    # Read barrier: an in-flight async write must commit before the
    # artifacts are trusted.
    wait_pending_writes()
    if os.path.isdir(os.path.join(os.path.abspath(load_dir), _ORBAX_DIR)):
        raise _orbax_refused()
    state = load_state_file(load_dir)
    if hasattr(engine, "drop_offloaded_state") and state["opt_state"] is not None:
        # About to overwrite both params and optimizer state: discard any
        # offloaded host copies instead of restoring them first. A
        # params-only state keeps the offloaded moments (set_params
        # brings them back).
        engine.drop_offloaded_state()
    engine.set_params(state["params"])
    _, opt = _engine_state(engine)
    if state["opt_state"] is not None and opt is not None:
        engine.set_opt_state(state["opt_state"])
    engine.version = int(state.get("version", 0))
    if hasattr(engine, "_lr_steps"):
        vs = state.get("version_steps")
        engine._lr_steps = int(vs if vs is not None else state.get("version", 0))
    rng = state.get("rng")
    if rng and hasattr(engine, "load_rng_state"):
        engine.load_rng_state(rng)
    host_rng = state.get("host_rng")
    if host_rng:
        seeding.load_state(host_rng)
    logger.info(f"loaded engine state from {load_dir}")


def has_engine_state(load_dir: str) -> bool:
    wait_pending_writes()
    return (os.path.exists(os.path.join(load_dir, _STATE_FILE))
            or os.path.isdir(os.path.join(load_dir, _ORBAX_DIR)))
