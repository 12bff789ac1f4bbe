"""Trainer -> generation-server weight transfer through raw dumps (the
port's copy of the unsharded part of ``areal_tpu/system/weight_transfer.py``).

Format (per dump directory), the reference's byte for byte:
- ``params-v{N}.bin``: every leaf's contiguous bytes, concatenated in
  sorted-path order;
- ``params-v{N}.chunks.json``: the bin's chunk index (sha256 of each
  fixed-size chunk, hashed while the bytes stream out), which the weight
  plane (system/weight_plane.py) serves without re-reading the bin;
- ``params-v{N}.layout.json``: per-leaf path, dtype, shape and byte
  extent, so each bin describes itself (GC keeps two);
- with ``wire_dtype="int8"``: ``params-v{N}.int8.bin`` and its own two
  sidecars, each float matrix leaf as int8 data + float32
  per-output-channel scales (about a quarter of a float32 bin);
- ``params.json``: the manifest (schema, dump version N, bin name, and
  per-leaf path, dtype name, shape, offset, nbytes), written by tmp +
  rename AFTER the bins and sidecars, so a reader that sees a manifest
  sees its whole bin and the wire it advertises. Older versions are
  garbage-collected down to the last 2.

For the same numpy tree the two packages write byte-equal files, and
each loads the other's dumps. The port also dumps a tree of torch
tensors (bfloat16 leaves included, under the dtype name ``bfloat16``).
It loads a dump as CPU tensors over the mapped file (numpy has no
bfloat16 without ml_dtypes); the serving engine copies them to its
device. At the end of the load chain ``load_for_serving`` reads an HF
checkpoint directory (version -1), as the reference does. Not ported:
the reference's shard-local dumps (slabs, which wait for multi-device)
and the tmpfs mirror.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.base import env_registry, logging
from areal_tpu_torch.base.chunking import DEFAULT_CHUNK_BYTES, StreamChunker
from areal_tpu_torch.base.wire_schemas import WEIGHT_LAYOUT_V1 as LAYOUT_SCHEMA

logger = logging.getLogger("weight_transfer")

_MANIFEST = "params.json"
_SCHEMA = 1

# Telemetry of this process's most recent dump: total bytes and seconds,
# and the int8 companion's share of them.
LAST_DUMP_STATS: Dict[str, Any] = {}

# Quantized-wire convention (the reference's, after ops/wquant.py):
# symmetric int8 with per-output-channel scales reduced over axis -2,
# w ~= q * s.
_WIRE_Q = 127.0
_WIRE_QAXIS = -2

# Leaf names the int8 wire quantizes: the matmul weights and the
# embedding / LM head, the bulk of the payload. Norms, biases and
# integer leaves ship raw.
WIRE_QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in", "w_out",
    "weight", "w",
})


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


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dump's numpy dtype name."""
    return torch.bool if name == "bool" else getattr(torch, name)


def chunk_sidecar_name(bin_name: str) -> str:
    """Chunk-index sidecar for a bin (``params-v{N}.chunks.json``)."""
    return bin_name[: -len(".bin")] + ".chunks.json"


def layout_sidecar_name(bin_name: str) -> str:
    """Per-leaf layout sidecar for a bin (``params-v{N}.layout.json``)."""
    return bin_name[: -len(".bin")] + ".layout.json"


def wire_bin_name(version: int, wire_dtype: str) -> str:
    """The quantized-wire companion bin (``params-v{N}.int8.bin``)."""
    return f"params-v{version}.{wire_dtype}.bin"


def _cpu_tensor(leaf) -> torch.Tensor:
    """A numpy or torch leaf as a contiguous CPU tensor (a numpy
    bfloat16 leaf through its raw 16 bits)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    arr = np.ascontiguousarray(np.asarray(leaf))
    if not arr.flags.writeable:
        arr = arr.copy()  # torch tensors over read-only memory are undefined
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _wire_quantizable(path: str, leaf) -> bool:
    """Leaves the int8 wire quantizes: float matrices (ndim >= 2) whose
    leaf name marks a matmul weight or embedding (WIRE_QUANT_KEYS)."""
    if isinstance(leaf, torch.Tensor):
        is_float = leaf.is_floating_point()
    else:
        dt = np.asarray(leaf).dtype
        is_float = np.issubdtype(dt, np.floating) or dt.name == "bfloat16"
    return len(leaf.shape) >= 2 and path.split("/")[-1] in WIRE_QUANT_KEYS and is_float


def quantize_wire_leaf(leaf) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 data, float32 scales) of one leaf under the wire convention,
    bit-equal to the reference's numpy version: float32 abs-max over
    axis -2 (floored at 1e-8) / 127, then round-half-even of w / s,
    clipped to +-127."""
    w32 = _cpu_tensor(leaf).to(torch.float32)
    s = torch.clamp_min(w32.abs().amax(dim=_WIRE_QAXIS), 1e-8) / _WIRE_Q
    q = torch.round(w32 / s.unsqueeze(_WIRE_QAXIS)).clamp_(-_WIRE_Q, _WIRE_Q).to(torch.int8)
    return q, s


def dequantize_wire_leaf(q: torch.Tensor, s: torch.Tensor, dtype: str) -> torch.Tensor:
    """Inverse of quantize_wire_leaf: a float32 multiply, then a
    round-to-nearest-even cast to the logical dtype (a dump's dtype
    name), as the reference's numpy version. It runs on the tensors'
    device, with the same bits on any."""
    return (q.to(torch.float32) * s.unsqueeze(_WIRE_QAXIS)).to(torch_dtype(dtype))


def _dtype_name(leaf) -> str:
    """The dump's dtype name of a numpy or torch leaf: dtype.name (not
    .str: ml_dtypes types like bfloat16 have .str '<V2', which would
    round-trip to a raw void type)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def _leaf_bytes(leaf) -> Tuple[str, list, bytes]:
    """(dtype name, shape, contiguous bytes) of a numpy or torch leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        return _dtype_name(t), list(t.shape), t.reshape(-1).view(torch.uint8).numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return _dtype_name(arr), list(arr.shape), arr.tobytes()


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


def _dump_wire_bin(dump_dir: str, version: int, wire_dtype: str, leaves,
                   chunk_bytes: int) -> Dict[str, Any]:
    """Write the quantized-wire companion bin and its chunk and layout
    sidecars; returns the layout. Per leaf the int8 data is followed at
    once by its float32 scales."""
    if wire_dtype != "int8":
        raise ValueError(f"unsupported weight_wire_dtype {wire_dtype!r}")
    bin_name = wire_bin_name(version, wire_dtype)
    layout: Dict[str, Any] = {
        "schema": LAYOUT_SCHEMA, "version": int(version), "bin": bin_name,
        "wire": wire_dtype, "leaves": [],
    }
    offset = 0
    chunker = StreamChunker(chunk_bytes)
    tmp_bin = os.path.join(dump_dir, bin_name + f".tmp.{os.getpid()}")
    with open(tmp_bin, "wb") as f:

        def put(data: bytes):
            nonlocal offset
            f.write(data)
            chunker.update(data)
            offset += len(data)

        for path, leaf in leaves:
            if not _wire_quantizable(path, leaf):
                dtype, shape, data = _leaf_bytes(leaf)
                layout["leaves"].append({"path": path, "dtype": dtype, "shape": shape,
                                         "offset": offset, "wire": "raw", "nbytes": len(data)})
                put(data)
                continue
            q, sc = quantize_wire_leaf(leaf)
            qb, sb = q.numpy().tobytes(), sc.numpy().tobytes()
            layout["leaves"].append({
                "path": path, "dtype": _dtype_name(leaf), "shape": list(leaf.shape),
                "offset": offset,
                "wire": "int8", "nbytes": len(qb), "scale_offset": offset + len(qb),
                "scale_nbytes": len(sb), "scale_shape": list(sc.shape),
                "scale_dtype": "float32"})
            put(qb)
            put(sb)
        f.flush()
        os.fsync(f.fileno())
    layout["total_bytes"] = offset
    os.replace(tmp_bin, os.path.join(dump_dir, bin_name))
    _write_json_atomic(dump_dir, chunk_sidecar_name(bin_name), chunker.finish())
    _write_json_atomic(dump_dir, layout_sidecar_name(bin_name), layout)
    return layout


def dump_raw_params(params: Any, dump_dir: str, version: int,
                    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                    wire_dtype: Optional[str] = None) -> float:
    """Write the raw dump of a tree of numpy arrays or torch tensors, its
    chunk-index and layout sidecars and, with ``wire_dtype="int8"``, the
    quantized companion; returns seconds spent. ``chunk_bytes`` should
    match the plane's ``weight_chunk_bytes`` (a sidecar of another chunk
    size is ignored there). Safe against concurrent readers (see the
    module docstring); a single writer is assumed."""
    t0 = time.monotonic()
    os.makedirs(dump_dir, exist_ok=True)
    leaves = _flatten(params)
    bin_name = f"params-v{version}.bin"
    manifest: Dict[str, Any] = {
        "schema": _SCHEMA, "version": int(version), "bin": bin_name, "leaves": [],
    }
    offset = 0
    chunker = StreamChunker(chunk_bytes)
    tmp_bin = os.path.join(dump_dir, bin_name + f".tmp.{os.getpid()}")
    with open(tmp_bin, "wb") as f:
        for path, leaf in leaves:
            dtype, shape, data = _leaf_bytes(leaf)
            f.write(data)
            chunker.update(data)
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
    _write_json_atomic(dump_dir, chunk_sidecar_name(bin_name), chunker.finish())
    _write_json_atomic(
        dump_dir, layout_sidecar_name(bin_name),
        {"schema": LAYOUT_SCHEMA, "version": int(version), "bin": bin_name,
         "wire": "raw", "total_bytes": offset,
         "leaves": [dict(e, wire="raw") for e in manifest["leaves"]]},
    )
    wire_s = 0.0
    if wire_dtype not in (None, "model", "raw"):
        # Before the manifest: a reader that sees params.json advertise
        # the wire can rely on its bin.
        t_wire = time.monotonic()
        wire_layout = _dump_wire_bin(dump_dir, version, wire_dtype, leaves, chunk_bytes)
        wire_s = time.monotonic() - t_wire
        manifest["wire_dtypes"] = [wire_dtype]
        manifest["wire_total_bytes"] = {wire_dtype: wire_layout["total_bytes"]}
    _write_json_atomic(dump_dir, _MANIFEST, manifest)
    _gc_old_versions(dump_dir)
    dt = time.monotonic() - t0
    LAST_DUMP_STATS.clear()
    LAST_DUMP_STATS.update(total_bytes=int(offset), seconds=dt, wire_seconds=wire_s,
                           wire_total_bytes=int(manifest.get("wire_total_bytes", {}).get(
                               wire_dtype, 0)))
    return dt


class DumpStreamReader:
    """Positioned reads (``os.pread``) over one contiguous bin, so one
    reader serves concurrent chunk requests without a lock; an open
    reader outlives the dump's GC (its fd pins the unlinked file). The
    reference's reader also gathers shard-local slab dumps, which are not
    ported. Raises FileNotFoundError when the bin is gone."""

    def __init__(self, dump_dir: str, manifest: Dict[str, Any]):
        if manifest.get("storage") == "sharded":
            raise NotImplementedError(
                "shard-local dumps wait for multi-device (ROADMAP Queue A item 7)")
        self.total_bytes = int(manifest["total_bytes"])
        self._fd = os.open(os.path.join(dump_dir, manifest["bin"]), os.O_RDONLY)

    def read_at(self, offset: int, length: int) -> bytes:
        """``[offset, offset + length)`` of the bin; OSError on a short
        read."""
        if not (0 <= offset and offset + length <= self.total_bytes):
            raise ValueError(f"read [{offset}, {offset + length}) outside stream of "
                             f"{self.total_bytes}")
        data = os.pread(self._fd, length, offset)
        if len(data) != length:
            raise OSError(f"short stream read: wanted {length}, got {len(data)}")
        return data

    def close(self):
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def chunk_index_from_reader(reader: DumpStreamReader, total_bytes: int,
                            chunk_bytes: int) -> Dict[str, Any]:
    """Chunk index of a dump's byte stream, one 4 MiB-stride pass
    through ``reader``."""
    chunker = StreamChunker(chunk_bytes)
    pos = 0
    while pos < total_bytes:
        n = min(4 << 20, total_bytes - pos)
        chunker.update(reader.read_at(pos, n))
        pos += n
    return chunker.finish()


def read_layout_sidecar(dump_dir: str, bin_name: str) -> Optional[Dict[str, Any]]:
    """The bin's layout sidecar, or None when absent or malformed."""
    try:
        with open(os.path.join(dump_dir, layout_sidecar_name(bin_name))) as f:
            layout = json.load(f)
    except (OSError, ValueError, json.JSONDecodeError):
        return None
    if layout.get("schema") != LAYOUT_SCHEMA:
        return None
    return layout


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
    from areal_tpu_torch.models.hf import load_hf_model

    _, params = load_hf_model(model_path)
    return params, {"source": "hf", "version": -1,
                    "load_s": time.monotonic() - t0}


def load_for_serving(
    model_path: str,
    shm_dir: Optional[str] = None,
    want_version: Optional[int] = None,
    retries: Optional[int] = None,
    retry_s: Optional[float] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Load params for a generation server's weight update, fastest source
    first: ``shm_dir`` raw dump, ``model_path`` raw dump, ``model_path``
    pickle (``engine_state.pkl``), ``model_path`` as an HF checkpoint
    directory (float32 CPU tensors). Returns (params, info) with the source
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
