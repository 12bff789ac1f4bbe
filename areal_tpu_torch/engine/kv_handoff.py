"""Versioned KV-handoff wire format for disaggregated prefill/decode (the
port's copy of ``areal_tpu/engine/kv_handoff.py``).

A prefill-role engine exports a finished prompt's KV plus its first
sampled token as a *handoff blob*: a JSON meta dict describing typed
array segments inside one contiguous payload, chunk-indexed with the
content hashes of ``base/chunking.py``, so the decode-side server pulls
it over HTTP with per-chunk verification and mid-chunk Range resume.

The layout is page-agnostic and token-major (``[L, Hkv, n_tokens,
hd]``): exporter and importer may run different page sizes and pool
precisions. ``kv_wire`` is a float dtype name (the exporter's pool
precision), ``"int8"`` (``data + scales`` pairs, engine/paged.quantize_kv)
or ``"fp8"`` (e4m3 ``data + scales`` pairs, ``quantize_kv_fp8`` below).

Blobs are the reference's byte for byte. The reference names bfloat16
and float8 through ``ml_dtypes``; the port has no ``ml_dtypes`` and
moves those arrays as torch tensors viewed as raw bytes, writing the
same dtype names into ``segments``. Arrays come back as CPU tensors
over the payload. Torch only (no device): the server-side transfer code
and the tests use it without touching a card.
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from areal_tpu_torch.base.chunking import chunk_spans, hash_chunk
from areal_tpu_torch.base.wire_schemas import KV_HANDOFF_V1 as HANDOFF_SCHEMA
from areal_tpu_torch.ops.quant_const import KV_INT8_MAX

# 256 KiB: a blob is one request's KV (MB scale), so a torn transfer
# re-pays little and per-chunk HTTP overhead stays small.
DEFAULT_CHUNK_BYTES = 256 << 10


class KVHandoffError(RuntimeError):
    """Malformed / incompatible handoff blob."""


class KVHandoffVersionMismatch(KVHandoffError):
    """The blob's weight version differs from the importing engine's:
    importing would decode against KV from other weights."""


# Largest finite e4m3 value: the fp8 wire maps each (layer, head,
# token) vector's absmax onto it.
KV_FP8_MAX = 448.0

# Wire dtype names (numpy / ml_dtypes spelling) <-> torch dtypes.
_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def wire_dtype_name(dtype: torch.dtype) -> str:
    """The wire (numpy / ml_dtypes) name of a torch dtype."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise KVHandoffError(f"no wire name for {dtype}") from None


def torch_wire_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise KVHandoffError(f"unknown wire dtype {name!r}") from None


def _as_cpu_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(arr))


def quantize_kv_fp8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(data, scales) for the e4m3 wire: data is ``float8_e4m3fn [L, Hkv,
    n, hd]`` scaled so each (L, H, token) vector's absmax lands on
    KV_FP8_MAX, scales ``float32 [L, Hkv, n]``. Runs on the CPU, in the
    reference's float32 order (divide by the scale, then multiply by
    448); the cast rounds to nearest even as ``ml_dtypes`` does."""
    xh = _as_cpu_tensor(x).float()
    s = torch.clamp(xh.abs().amax(dim=-1), min=1e-8)
    w = (xh / s[..., None] * KV_FP8_MAX).to(torch.float8_e4m3fn)
    return w, s.float()


def pack_arrays(
    arrays: List[Tuple[str, object]],
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> Tuple[List[Dict], Dict, bytes]:
    """Serialize named arrays (torch tensors or numpy arrays) into
    (segments, chunk_index, payload). ``segments`` records
    name/dtype/shape/offset per array; ``chunk_index`` is the hash index
    over the whole payload ({chunk_bytes, total_bytes, n_chunks,
    hashes})."""
    segments: List[Dict] = []
    parts: List[bytes] = []
    off = 0
    for name, arr in arrays:
        t = _as_cpu_tensor(arr)
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        segments.append({
            "name": name,
            "dtype": wire_dtype_name(t.dtype),
            "shape": list(t.shape),
            "offset": off,
            "nbytes": len(raw),
        })
        parts.append(raw)
        off += len(raw)
    payload = b"".join(parts)
    index = {
        "chunk_bytes": int(chunk_bytes),
        "total_bytes": len(payload),
        "n_chunks": -(-len(payload) // chunk_bytes) if payload else 0,
        "hashes": [
            hash_chunk(payload[o: o + ln])
            for o, ln in chunk_spans(len(payload), chunk_bytes)
        ],
    }
    return segments, index, payload


def unpack_arrays(meta: Dict, payload: bytes, verify: bool = True) -> Dict[str, torch.Tensor]:
    """Segments back to named CPU tensors (views over ``payload``; read
    only). With ``verify`` the payload is re-hashed against the chunk
    index, so the blob authenticates itself whatever the transport."""
    if meta.get("schema") != HANDOFF_SCHEMA:
        raise KVHandoffError(
            f"schema {meta.get('schema')!r} != {HANDOFF_SCHEMA!r}"
        )
    index = meta.get("chunks") or {}
    if len(payload) != int(index.get("total_bytes", -1)):
        raise KVHandoffError(
            f"payload is {len(payload)} bytes, index says "
            f"{index.get('total_bytes')}"
        )
    if verify:
        cb = int(index["chunk_bytes"])
        for i, (off, ln) in enumerate(chunk_spans(len(payload), cb)):
            if hash_chunk(payload[off: off + ln]) != index["hashes"][i]:
                raise KVHandoffError(f"chunk {i} hash mismatch")
    out: Dict[str, torch.Tensor] = {}
    for seg in meta["segments"]:
        dt = torch_wire_dtype(seg["dtype"])
        off, nb = int(seg["offset"]), int(seg["nbytes"])
        itemsize = torch.empty((), dtype=dt).element_size()
        with warnings.catch_warnings():
            # bytes are immutable; the tensors are never written.
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(payload, dtype=dt, count=nb // itemsize,
                                    offset=off) if nb else torch.empty((0,), dtype=dt)
        out[seg["name"]] = flat.reshape(seg["shape"])
    return out


def build_meta(
    qid: str,
    version: int,
    tokens: List[int],
    kv_wire: str,
    cfg,
    segments: List[Dict],
    chunks: Dict,
) -> Dict:
    return {
        "schema": HANDOFF_SCHEMA,
        "qid": str(qid),
        "version": int(version),
        "n_tokens": len(tokens),
        # Prefix identity for the global prefix index: two holders of
        # the same hash hold interchangeable KV.
        "content_hash": prefix_content_hash(tokens),
        "tokens": [int(t) for t in tokens],
        "kv_wire": kv_wire,
        "n_layers": int(cfg.n_layers),
        "n_kv_heads": int(cfg.n_kv_heads),
        "head_dim": int(cfg.head_dim),
        "segments": segments,
        "chunks": chunks,
    }


def check_geometry(meta: Dict, cfg) -> None:
    """The importing engine must share the exporter's attention geometry
    (page size may differ; layer count, KV heads and head dim are baked
    into the gathered arrays)."""
    for field, want in (
        ("n_layers", cfg.n_layers),
        ("n_kv_heads", cfg.n_kv_heads),
        ("head_dim", cfg.head_dim),
    ):
        got = meta.get(field)
        if int(got) != int(want):
            raise KVHandoffError(
                f"geometry mismatch: blob {field}={got}, engine has {want}"
            )


def prefix_content_hash(tokens: List[int]) -> str:
    """Content hash of a token prefix (sha256 of its int64-LE encoding),
    stable across processes and packages."""
    return hashlib.sha256(
        np.asarray(tokens, np.int64).tobytes()
    ).hexdigest()


def unpack_kv_int8(meta: Dict, payload: bytes, verify: bool = True):
    """(k_data, k_scales, v_data, v_scales) of an int8 wire, without the
    float round trip: an int8 pool scatters them straight in
    (paged.scatter_prefill_int8), so a spill and restore of an int8 pool
    is bit-exact. Raises KVHandoffError for other wires."""
    if meta.get("kv_wire") != "int8":
        raise KVHandoffError(
            f"unpack_kv_int8 on a {meta.get('kv_wire')!r} wire"
        )
    arrs = unpack_arrays(meta, payload, verify=verify)
    return (
        arrs["k_data"].to(torch.int8),
        arrs["k_scales"].to(torch.float32),
        arrs["v_data"].to(torch.int8),
        arrs["v_scales"].to(torch.float32),
    )


def dequantize_wire(w: torch.Tensor, s: torch.Tensor, kv_max: float) -> torch.Tensor:
    """float32 ``w * (s / kv_max)``, the reference's dequantization order."""
    return w.float() * (s.float()[..., None] / kv_max)


def unpack_kv_float(meta: Dict, payload: bytes, verify: bool = True):
    """(k, v) as float32 CPU tensors [L, Hkv, n_tokens, hd], dequantizing
    an int8 wire with KV_INT8_MAX or an fp8 wire with KV_FP8_MAX."""
    arrs = unpack_arrays(meta, payload, verify=verify)
    wire = meta["kv_wire"]
    if wire in ("int8", "fp8"):
        kv_max = KV_INT8_MAX if wire == "int8" else KV_FP8_MAX
        return (
            dequantize_wire(arrs["k_data"], arrs["k_scales"], kv_max),
            dequantize_wire(arrs["v_data"], arrs["v_scales"], kv_max),
        )
    return arrs["k"].float(), arrs["v"].float()
