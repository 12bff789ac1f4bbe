"""Port parity of the KV-handoff wire (``areal-kv-handoff/v1``):
``areal_tpu_torch/engine/kv_handoff.py`` against
``areal_tpu/engine/kv_handoff.py`` on the same seeded arrays.

- ``pack_arrays`` gives byte-equal payloads and equal segments and chunk
  indexes on the float32, bfloat16, int8 and fp8 wires (the port packs
  bfloat16 and float8 as torch tensors viewed as raw bytes, the
  reference through ml_dtypes);
- a blob packed by either package unpacks in the other to equal arrays
  (bit for bit), float and int8 unpacking included;
- ``quantize_kv_fp8`` is byte-equal, exact ties of the e4m3 grid
  included; the ``prefix_content_hash`` and ``build_meta`` are equal;
- a corrupt chunk, a wrong schema, a short payload and a geometry
  mismatch raise each package's KVHandoffError with the same message.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from areal_tpu.engine import kv_handoff as ref
from areal_tpu_torch.engine import kv_handoff as port


class _Cfg:
    n_layers, n_kv_heads, head_dim = 2, 2, 16


def _kv(seed, n=37):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 2, n, 16)) * 3).astype(np.float32)


def _raw(x):
    """The bytes of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _wire_arrays(wire, seed):
    """(reference arrays, port arrays) of one wire on the same values."""
    k, v = _kv(seed), _kv(seed + 1)
    if wire == "float32":
        return [("k", k), ("v", v)], [("k", torch.from_numpy(k)), ("v", torch.from_numpy(v))]
    if wire == "bfloat16":
        return ([("k", k.astype(ml_dtypes.bfloat16)), ("v", v.astype(ml_dtypes.bfloat16))],
                [("k", torch.from_numpy(k).to(torch.bfloat16)),
                 ("v", torch.from_numpy(v).to(torch.bfloat16))])
    if wire == "int8":
        rng = np.random.default_rng(seed)
        kd = rng.integers(-127, 128, size=k.shape).astype(np.int8)
        ks = np.abs(k).max(-1).astype(np.float32)
        return ([("k_data", kd), ("k_scales", ks), ("v_data", kd[::-1].copy()),
                 ("v_scales", ks * 2)],
                [("k_data", torch.from_numpy(kd)), ("k_scales", torch.from_numpy(ks)),
                 ("v_data", torch.from_numpy(kd[::-1].copy())),
                 ("v_scales", torch.from_numpy(ks * 2))])
    kw, ks = ref.quantize_kv_fp8(k)
    vw, vs = ref.quantize_kv_fp8(v)
    pkw, pks = port.quantize_kv_fp8(torch.from_numpy(k))
    pvw, pvs = port.quantize_kv_fp8(torch.from_numpy(v))
    return ([("k_data", kw), ("k_scales", ks), ("v_data", vw), ("v_scales", vs)],
            [("k_data", pkw), ("k_scales", pks), ("v_data", pvw), ("v_scales", pvs)])


WIRES = ["float32", "bfloat16", "int8", "fp8"]


@pytest.mark.parametrize("wire", WIRES)
def test_pack_arrays_byte_equal(wire):
    r, p = _wire_arrays(wire, 3)
    rseg, ridx, rpay = ref.pack_arrays(r, chunk_bytes=4096)
    pseg, pidx, ppay = port.pack_arrays(p, chunk_bytes=4096)
    assert ppay == rpay
    assert pseg == rseg and pidx == ridx
    assert ridx["n_chunks"] > 1
    tokens = list(range(37))
    assert port.build_meta("q", 4, tokens, wire, _Cfg, pseg, pidx) == \
        ref.build_meta("q", 4, tokens, wire, _Cfg, rseg, ridx)


def _blob(pkg, wire, seed):
    r, p = _wire_arrays(wire, seed)
    arrays = r if pkg is ref else p
    seg, idx, payload = pkg.pack_arrays(arrays, chunk_bytes=4096)
    meta = pkg.build_meta("q", 0, list(range(37)), wire, _Cfg, seg, idx)
    return meta, payload


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
def test_blobs_unpack_across_packages(wire, direction):
    src, dst = (ref, port) if direction == "ref->port" else (port, ref)
    meta, payload = _blob(src, wire, 5)
    want = src.unpack_arrays(meta, payload)
    got = dst.unpack_arrays(meta, payload)
    assert list(got) == list(want)
    for name in want:
        assert _raw(got[name]) == _raw(want[name]), name
        assert tuple(got[name].shape) == tuple(want[name].shape)
    kf, vf = dst.unpack_kv_float(meta, payload)
    rk, rv = src.unpack_kv_float(meta, payload)
    np.testing.assert_array_equal(np.asarray(kf), np.asarray(rk))
    np.testing.assert_array_equal(np.asarray(vf), np.asarray(rv))
    if wire == "int8":
        for a, b in zip(dst.unpack_kv_int8(meta, payload), src.unpack_kv_int8(meta, payload)):
            assert _raw(a) == _raw(b)


def test_quantize_kv_fp8_byte_equal_with_ties():
    x = _kv(11, n=64) * np.float32(40.0)
    # Rows whose scaled values land exactly on e4m3 midpoints: with the
    # absmax at 448 the scale is 1, so x * 448 / 448 keeps x, and
    # 2**e * (1 + (2m + 1) / 16) sits halfway between two codes.
    ties = np.array([448.0] + [2.0 ** e * (1 + (2 * m + 1) / 16)
                               for e in range(-6, 8) for m in (0, 3)][:15], np.float32)
    x[0, 0, 0, :] = ties
    x[0, 1, 0, :] = -ties
    x[1, 0, 0, :] = np.array([448.0] + [2.0 ** -9 * (k + 0.5) for k in range(15)], np.float32)
    rw, rs = ref.quantize_kv_fp8(x)
    pw, ps = port.quantize_kv_fp8(torch.from_numpy(x))
    assert _raw(pw) == _raw(rw)
    assert _raw(ps) == _raw(rs)
    # The cast alone, over a dense sweep of the e4m3 range.
    v = np.linspace(-448.0, 448.0, 400001, dtype=np.float32)
    assert _raw(torch.from_numpy(v).to(torch.float8_e4m3fn)) == \
        _raw(v.astype(ml_dtypes.float8_e4m3fn))


def test_prefix_content_hash_equal():
    for toks in ([], [1], list(range(300)), [151935, 0, 7] * 50):
        assert port.prefix_content_hash(toks) == ref.prefix_content_hash(toks)


def _raises_same(fn_ref, fn_port):
    with pytest.raises(ref.KVHandoffError) as er:
        fn_ref()
    with pytest.raises(port.KVHandoffError) as ep:
        fn_port()
    assert str(ep.value) == str(er.value)
    assert type(ep.value).__name__ == type(er.value).__name__


@pytest.mark.parametrize("fault", ["corrupt_chunk", "wrong_schema", "short_payload",
                                   "geometry", "int8_on_float_wire"])
def test_faults_raise_the_same_errors(fault):
    meta, payload = _blob(ref, "float32", 7)
    if fault == "corrupt_chunk":
        bad = bytearray(payload)
        bad[5000] ^= 0xFF
        _raises_same(lambda: ref.unpack_arrays(meta, bytes(bad)),
                     lambda: port.unpack_arrays(meta, bytes(bad)))
    elif fault == "wrong_schema":
        m = dict(meta, schema="areal-kv-handoff/v0")
        _raises_same(lambda: ref.unpack_arrays(m, payload),
                     lambda: port.unpack_arrays(m, payload))
    elif fault == "short_payload":
        _raises_same(lambda: ref.unpack_arrays(meta, payload[:-1]),
                     lambda: port.unpack_arrays(meta, payload[:-1]))
    elif fault == "geometry":
        m = dict(meta, n_kv_heads=4)
        _raises_same(lambda: ref.check_geometry(m, _Cfg), lambda: port.check_geometry(m, _Cfg))
    else:
        _raises_same(lambda: ref.unpack_kv_int8(meta, payload),
                     lambda: port.unpack_kv_int8(meta, payload))
    assert issubclass(port.KVHandoffVersionMismatch, port.KVHandoffError)
