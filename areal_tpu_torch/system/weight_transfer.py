"""Trainer -> generation-server weight transfer through raw dumps (the
port's copy of the raw-dump part of ``areal_tpu/system/weight_transfer.py``).

Format (per dump directory), the reference's byte for byte:
- ``params-v{N}.bin``: every leaf's contiguous bytes, concatenated in
  sorted-path order;
- ``params.json``: the manifest (schema, dump version N, bin name, and
  per-leaf path, dtype name, shape, offset, nbytes), written by tmp +
  rename AFTER the bin, so a reader that sees a manifest sees its whole
  bin. Older versions are garbage-collected down to the last 2.

For the same numpy tree the two packages write byte-equal files, and
each loads the other's dumps. The port also dumps a tree of torch
tensors (bfloat16 leaves included, under the dtype name ``bfloat16``).
It loads a dump as CPU tensors over the mapped file (numpy has no
bfloat16 without ml_dtypes); the serving engine copies them to its
device. The reference's chunk-index and layout sidecars, its int8 wire
and its shard-local dumps belong to the weight plane, which is not
ported; neither is loading an HF checkpoint.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.base import env_registry, logging

logger = logging.getLogger("weight_transfer")

_MANIFEST = "params.json"
_SCHEMA = 1


class WeightVersionMismatch(RuntimeError):
    """load_for_serving found weights, but not the requested version.

    Serving them anyway would pin a stale (or unverifiable, version -1
    pickle) dump under the new version label; callers fail the update
    instead."""


def shm_transfer_dir(experiment_name: str, trial_name: str, role: str) -> Optional[str]:
    """The reference's tmpfs dump directory for the same-host fast path,
    or None when /dev/shm is unavailable (then only the disk path is
    used)."""
    base = "/dev/shm"
    if not os.path.isdir(base) or not os.access(base, os.W_OK):
        return None
    return os.path.join(base, "areal_tpu", experiment_name, trial_name, role)


def _flatten(params: Any, prefix: Tuple[str, ...] = ()) -> list:
    out = []
    if isinstance(params, dict):
        for k in sorted(params.keys()):
            out.extend(_flatten(params[k], prefix + (str(k),)))
        return out
    if isinstance(params, (list, tuple)):
        raise TypeError(
            f"weight_transfer supports dict-of-array trees only; found "
            f"{type(params).__name__} at {'/'.join(prefix)}"
        )
    return [("/".join(prefix), params)]


def unflatten_leaves(leaves: Dict[str, Any]) -> Any:
    """path -> leaf mapping back into the nested-dict tree."""
    root: Dict[str, Any] = {}
    for path, arr in leaves.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return root


def _leaf_bytes(leaf) -> Tuple[str, list, bytes]:
    """(dtype name, shape, contiguous bytes) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return str(t.dtype).removeprefix("torch."), list(t.shape), data
    arr = np.ascontiguousarray(np.asarray(leaf))
    # dtype.name (not .str): ml_dtypes types like bfloat16 have .str
    # '<V2', which would round-trip to a raw void type.
    return arr.dtype.name, list(arr.shape), arr.tobytes()


def _write_json_atomic(dump_dir: str, name: str, payload: Dict) -> None:
    tmp = os.path.join(dump_dir, name + f".tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dump_dir, name))


def _gc_old_versions(dump_dir: str, keep: int = 2) -> None:
    """Remove every artifact of all but the newest ``keep`` versions."""
    versions = set()
    for b in os.listdir(dump_dir):
        if b.startswith("params-v"):
            v = b[len("params-v"):].split(".", 1)[0]
            if v.isdigit():
                versions.add(int(v))
    for v in sorted(versions)[:-keep]:
        prefix = f"params-v{v}."
        for b in os.listdir(dump_dir):
            if b.startswith(prefix):
                try:
                    os.unlink(os.path.join(dump_dir, b))
                except OSError:
                    pass


def dump_raw_params(params: Any, dump_dir: str, version: int) -> float:
    """Write the raw dump of a tree of numpy arrays or torch tensors;
    returns seconds spent. Safe against concurrent readers (see the
    module docstring); a single writer is assumed."""
    t0 = time.monotonic()
    os.makedirs(dump_dir, exist_ok=True)
    bin_name = f"params-v{version}.bin"
    manifest: Dict[str, Any] = {
        "schema": _SCHEMA, "version": int(version), "bin": bin_name, "leaves": [],
    }
    offset = 0
    tmp_bin = os.path.join(dump_dir, bin_name + f".tmp.{os.getpid()}")
    with open(tmp_bin, "wb") as f:
        for path, leaf in _flatten(params):
            dtype, shape, data = _leaf_bytes(leaf)
            f.write(data)
            manifest["leaves"].append(
                {"path": path, "dtype": dtype, "shape": shape, "offset": offset,
                 "nbytes": len(data)})
            offset += len(data)
        # fsync before the renames: a crash must never persist a manifest
        # that points at unsynced bytes.
        f.flush()
        os.fsync(f.fileno())
    manifest["total_bytes"] = offset
    os.replace(tmp_bin, os.path.join(dump_dir, bin_name))
    _write_json_atomic(dump_dir, _MANIFEST, manifest)
    _gc_old_versions(dump_dir)
    return time.monotonic() - t0


def _read_manifest(dump_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(dump_dir, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError, json.JSONDecodeError):
        return None
    if manifest.get("schema") != _SCHEMA:
        return None
    return manifest


def _tensor_view(mm: np.ndarray, offset: int, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor over ``mm[offset:]`` (no copy unless unaligned)."""
    if dtype == "bfloat16":
        np_dt, torch_dt = np.dtype(np.uint16), torch.bfloat16
    else:
        np_dt, torch_dt = np.dtype(dtype), None
    n = int(np.prod(shape)) * np_dt.itemsize
    arr = mm[offset: offset + n].view(np_dt).reshape(shape)
    if not arr.flags.aligned:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.view(torch_dt) if torch_dt is not None else t


def load_raw_params(dump_dir: str) -> Optional[Tuple[Any, int]]:
    """Map the latest raw dump: (tree of CPU tensors over the file, dump
    version), or None if absent or torn (the caller falls back). A reader
    racing the writer's GC re-reads the manifest once: that race means a
    newer dump exists."""
    for _attempt in range(2):
        manifest = _read_manifest(dump_dir)
        if manifest is None:
            return None
        if manifest.get("storage") == "sharded":
            raise NotImplementedError(
                "shard-local raw dumps belong to the weight plane, which is not ported")
        try:
            # Copy-on-write: the tensors are writable, the file never is.
            mm = np.memmap(os.path.join(dump_dir, manifest["bin"]), mode="c",
                           dtype=np.uint8)
        except FileNotFoundError:
            continue  # GC race: the refreshed manifest names the new bin
        except (OSError, ValueError, KeyError):
            return None
        try:
            if mm.size != manifest["total_bytes"]:
                return None  # torn write
            leaves = {e["path"]: _tensor_view(mm, e["offset"], e["dtype"], e["shape"])
                      for e in manifest["leaves"]}
            return unflatten_leaves(leaves), int(manifest["version"])
        except (ValueError, KeyError, TypeError):
            return None
    return None


def _load_once(
    model_path: str,
    shm_dir: Optional[str],
    t0: float,
    want_version: Optional[int] = None,
    raw_seen: Optional[Dict[str, int]] = None,
):
    """One pass down the fallback chain. With ``want_version`` pinned, a
    raw dump holding the wrong version falls through to the next source
    instead of shadowing it; mismatched raw versions are recorded in
    ``raw_seen`` for the caller's error message."""
    if shm_dir is not None:
        got = load_raw_params(shm_dir)
        if got is not None:
            params, v = got
            if want_version is None or v == want_version:
                return params, {"source": "shm_raw", "version": v,
                                "load_s": time.monotonic() - t0}
            if raw_seen is not None:
                raw_seen["shm_raw"] = v
    got = load_raw_params(model_path)
    if got is not None:
        params, v = got
        if want_version is not None and v != want_version and raw_seen is not None:
            raw_seen["disk_raw"] = v
        # A mismatched disk raw still ends the chain: the sources below
        # are version -1, and its version lets the caller's retry loop
        # wait for the right dump.
        return params, {"source": "disk_raw", "version": v,
                        "load_s": time.monotonic() - t0}
    if want_version is not None:
        # pickle / HF always report version -1: they can never satisfy a
        # pinned version, so skip them.
        return None, {"source": "no_raw_dump", "version": -1,
                      "load_s": time.monotonic() - t0}
    state_file = os.path.join(model_path, "engine_state.pkl")
    if os.path.exists(state_file):
        import pickle

        with open(state_file, "rb") as f:
            params = pickle.load(f)["params"]
        return params, {"source": "pickle", "version": -1,
                        "load_s": time.monotonic() - t0}
    raise NotImplementedError(
        f"{model_path} holds no raw dump or engine_state.pkl; loading an HF "
        "checkpoint is not ported yet (ROADMAP Queue A item 3)")


def load_for_serving(
    model_path: str,
    shm_dir: Optional[str] = None,
    want_version: Optional[int] = None,
    retries: Optional[int] = None,
    retry_s: Optional[float] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Load params for a generation server's weight update, fastest source
    first: ``shm_dir`` raw dump, ``model_path`` raw dump, ``model_path``
    pickle (``engine_state.pkl``). Returns (params, info) with the source
    and load seconds for ``/metrics``.

    With ``want_version`` set, the loaded dump's version must match it: a
    miss is retried (the dump may still be landing; AREAL_WEIGHT_LOAD_
    RETRIES x AREAL_WEIGHT_LOAD_RETRY_S, 40 x 0.25 s by default), then
    raised as :class:`WeightVersionMismatch`."""
    t0 = time.monotonic()
    if retries is None:
        retries = env_registry.get_int("AREAL_WEIGHT_LOAD_RETRIES")
    if retry_s is None:
        retry_s = env_registry.get_float("AREAL_WEIGHT_LOAD_RETRY_S")
    attempts = max(1, retries)
    last_info = None
    raw_seen: Dict[str, int] = {}
    for att in range(attempts):
        params, info = _load_once(model_path, shm_dir, t0,
                                  want_version=want_version, raw_seen=raw_seen)
        if want_version is None or info["version"] == want_version:
            return params, info
        last_info = info
        if att + 1 < attempts:
            time.sleep(retry_s)
    raise WeightVersionMismatch(
        f"requested weight version {want_version} but "
        + (
            "no raw dump was available"
            if last_info["source"] == "no_raw_dump"
            else f"{last_info['source']} dump holds version {last_info['version']}"
        )
        + f" after {attempts} attempt(s) (model_path={model_path}"
        + (f", mismatched raw dumps seen: {raw_seen}" if raw_seen else "")
        + ")"
    )
