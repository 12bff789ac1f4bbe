"""The port's CUDA kernel plumbing, checked where no card and no nvcc
exist: the kernels themselves compile and run only on the GPU, where
chip_smoke.py holds each against its plain version.

- every C entry point declared in ``kernels.ENTRY_POINTS`` exists in its
  source with as many parameters as its ctypes argtypes (a mismatch
  would pass pointers as ints on the card);
- a kernel's launcher refuses a CPU tensor (the wrappers send CPU
  tensors to the plain version before they reach it), a wrong dtype, a
  non-contiguous tensor and a head_dim outside {64, 128}, all before
  ``nvcc`` is touched;
- the forward and the backward hand their kernels the tile ranges of
  the segment ids, built for the tile their library reports, in the
  order and number of the C parameters; a counting launch hands each
  kernel one zeroed slot per CTA; ranges built for another tile are
  refused; the autograd function builds the ranges once, for the tile
  both libraries report, and its backward gets the forward's;
- the paged decode wrapper hands the kernel the split plan and scratch
  of its decode mode, and none in its chunk mode (row stride 0);
- a library's path follows its source and the shared headers beside it,
  and every header a source includes is one of them;
- with no nvcc, the first launch fails with a build error.
"""

import re
import shutil

import pytest
import torch

from areal_tpu_torch import kernels
from areal_tpu_torch.engine import paged
from areal_tpu_torch.engine.paged import _paged_decode_kernel
from areal_tpu_torch.ops import attention
from areal_tpu_torch.ops.attention import _flash_bwd, _flash_fwd
from areal_tpu_torch.ops.gae import _packed_gae_kernel, _scan_kernel


def _c_params(source: str, entry: str) -> int:
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", source, re.S)
    assert m, f"{entry} not found"
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("entry", sorted(kernels.ENTRY_POINTS))
def test_entry_points_match_their_c_signatures(entry):
    lib, argtypes = kernels.ENTRY_POINTS[entry]
    src = open(kernels.CSRC_DIR / kernels.SOURCES[lib]).read()
    assert _c_params(src, entry) == len(argtypes)
    assert entry in kernels.launches


def test_every_kernel_of_the_port_is_registered():
    assert set(kernels.ENTRY_POINTS) == set(kernels.launches) == {
        "flash_attn_fwd_bf16", "paged_decode_bf16", "paged_decode_int8",
        "flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16", "gae_scan_f32",
        "packed_gae_f32"}
    assert {lib for lib, _ in kernels.ENTRY_POINTS.values()} == set(kernels.SOURCES)
    assert kernels.ENTRY_POINTS["flash_attn_bwd_dq_bf16"][0] == "flash_attn_bwd"
    assert kernels.ENTRY_POINTS["flash_attn_bwd_dkv_bf16"][0] == "flash_attn_bwd"
    assert kernels.ENTRY_POINTS["gae_scan_f32"][0] == "gae_scan"
    assert kernels.ENTRY_POINTS["packed_gae_f32"][0] == "gae_scan"
    on_disk = {p.name for p in kernels.CSRC_DIR.glob("*.cu")}
    assert on_disk == set(kernels.SOURCES.values())


def test_sources_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in " ".join(kernels.NVCC_FLAGS)
    for src in kernels.SOURCES.values():
        text = open(kernels.CSRC_DIR / src).read()
        assert "Replaces" in text or "Takes the role" in text or "replaces" in text


def test_library_path_tracks_the_source():
    paths = {kernels._lib_path(n) for n in kernels.SOURCES}
    assert len(paths) == len(kernels.SOURCES)
    assert all(p.parent == kernels.BUILD_DIR for p in paths)


def test_library_path_tracks_the_shared_headers(monkeypatch, tmp_path):
    """Editing a header under csrc/ renames every library (a source may
    include it), so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    assert "mma_tiles.cuh" in {p.name for p in csrc.glob("*.cuh")}
    assert '#include "mma_tiles.cuh"' in (csrc / "flash_attn_bwd.cu").read_text()
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    before = {n: kernels._lib_path(n) for n in kernels.SOURCES}
    with open(csrc / "mma_tiles.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: kernels._lib_path(n) for n in kernels.SOURCES}
    assert all(before[n] != after[n] for n in kernels.SOURCES)
    (csrc / "flash_attn_bwd.cu").write_text((csrc / "flash_attn_bwd.cu").read_text() + "\n")
    assert kernels._lib_path("flash_attn_bwd") != after["flash_attn_bwd"]
    assert kernels._lib_path("gae_scan") == after["gae_scan"]


def test_every_included_header_is_a_shared_header():
    """Each `#include "..."` of a source names a header under csrc/, so the
    library names hash it (the flash forward and the paged chunk mode share
    flash_tile.cuh)."""
    headers = {p.name for p in kernels.CSRC_DIR.glob("*.cuh")}
    assert {"mma_tiles.cuh", "flash_tile.cuh"} <= headers
    included = set()
    for path in [*kernels.CSRC_DIR.glob("*.cu"), *kernels.CSRC_DIR.glob("*.cuh")]:
        included |= set(re.findall(r'#include "([^"]+)"', path.read_text()))
    assert included <= headers
    for src in ("flash_attn.cu", "paged_decode.cu"):
        assert '#include "flash_tile.cuh"' in (kernels.CSRC_DIR / src).read_text()


def test_reset_launches():
    kernels.launches["paged_decode_bf16"] += 3
    kernels.reset_launches()
    assert set(kernels.launches.values()) == {0}


def _flash_args(dtype=torch.bfloat16):
    q = torch.zeros((1, 8, 4, 64), dtype=dtype)
    kv = torch.zeros((1, 8, 2, 64), dtype=dtype)
    ids = torch.zeros((1, 8), dtype=torch.int32)
    return q, kv, kv.clone(), ids, ids.clone()


def test_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _flash_fwd(*_flash_args(), scale=0.125)
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    pool = torch.zeros((2, 3, 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _paged_decode_kernel(q, pool, pool, torch.ones(2, dtype=torch.int32),
                             torch.ones((2, 1), dtype=torch.int32), 0.125)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the checks a
    wrapper makes after the device check, where there is no card."""

    @staticmethod
    def __new__(cls, data):
        return torch.Tensor._make_subclass(cls, data)

    @property
    def device(self):
        return torch.device("cuda", 0)


def _bwd_args(hd=64, dtype=torch.bfloat16):
    q = _FakeCuda(torch.zeros((1, 8, 4, hd), dtype=dtype))
    kv = _FakeCuda(torch.zeros((1, 8, 2, hd), dtype=dtype))
    ids = _FakeCuda(torch.zeros((1, 8), dtype=torch.int32))
    lse = _FakeCuda(torch.zeros((1, 4, 8), dtype=torch.float32))
    return dict(q=q, k=kv, v=kv, segment_ids=ids, positions=ids, out=q, lse=lse,
                dout=q, scale=0.125)


def test_backward_and_scan_wrappers_refuse_cpu_tensors(monkeypatch):
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("reached the launcher"))
    q, kv, v, ids, pos = _flash_args()
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _flash_bwd(q, kv, v, ids, pos, q, lse, q, 0.125)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _scan_kernel(torch.zeros(2, 8), torch.zeros(2, 8))


@pytest.mark.parametrize("bad,match", [
    (dict(dout=torch.float32), "dout: expected torch.bfloat16"),
    (dict(lse=torch.bfloat16), "lse: expected torch.float32"),
    (dict(noncontiguous="dout"), "dout: expected a contiguous"),
    (dict(hd=32), "head_dim 64 or 128"),
    (dict(lse_shape=(1, 8, 4)), "lse \\[R, Hq, T\\]"),
])
def test_backward_wrapper_refuses_what_the_kernels_do_not_take(monkeypatch, bad, match):
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("reached the launcher"))
    args = _bwd_args(hd=bad.get("hd", 64))
    if "dout" in bad:
        args["dout"] = _FakeCuda(torch.zeros((1, 8, 4, 64), dtype=bad["dout"]))
    if "lse" in bad:
        args["lse"] = _FakeCuda(torch.zeros((1, 4, 8), dtype=bad["lse"]))
    if "noncontiguous" in bad:
        args["dout"] = _FakeCuda(torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16).transpose(1, 2))
    if "lse_shape" in bad:
        args["lse"] = _FakeCuda(torch.zeros(bad["lse_shape"], dtype=torch.float32))
    with pytest.raises(ValueError, match=match):
        _flash_bwd(**args)


def test_backward_hands_both_kernels_the_tile_ranges(monkeypatch):
    """The launch arguments of the two backward kernels, recorded in place
    of the launcher: tensors then ints then the scale, as many as the C
    parameters less the stream, with the tile ranges of the segment ids
    after delta, built for the tile the library reports (4 rows here), and
    a null tile-pair counter last among the pointers."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(attention, "bwd_tile", lambda: 4)
    args = _bwd_args(hd=64)
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 0, 0]], dtype=torch.int32)
    args["segment_ids"] = _FakeCuda(seg)
    _flash_bwd(**args)
    assert [c[0] for c in calls] == ["flash_attn_bwd_dq_bf16", "flash_attn_bwd_dkv_bf16"]
    for entry, a in calls:
        argtypes = kernels.ENTRY_POINTS[entry][1]
        assert len(a) + 1 == len(argtypes)  # + the stream
        n_ptr = argtypes.index(kernels.I)
        assert all(isinstance(x, torch.Tensor) for x in a[:n_ptr - 1])
        assert a[n_ptr - 1] is None
        assert a[n_ptr:] == (1, 8, 4, 2, 64, 0.125)
        ranges = a[8]
        assert ranges.dtype == torch.int32 and ranges.is_contiguous()
        assert torch.equal(ranges, attention.tile_segment_ranges(seg, 4))
        assert ranges.tolist() == [[[1, 2], [2, 2]]]


def _launch_inputs(tile):
    a = _bwd_args(hd=64)
    ranges = _FakeCuda(attention.tile_segment_ranges(torch.zeros((1, 8), dtype=torch.int32),
                                                     tile))
    delta = _FakeCuda(torch.zeros((1, 4, 8)))
    return (a["q"], a["k"], a["v"], a["dout"], a["segment_ids"], a["positions"], a["lse"],
            delta, ranges, 0.125)


def test_counting_launches_hand_each_kernel_one_zeroed_slot_per_cta(monkeypatch):
    """With count_pairs, each launcher passes an int32 counter of one slot
    per CTA of its grid (tiles x heads x rows: q heads for dq, kv heads for
    dk/dv) in the counter's place, and returns it."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(attention, "bwd_tile", lambda: 4)
    _, dq_pairs = attention._launch_dq(*_launch_inputs(4), count_pairs=True)
    *_, dkv_pairs = attention._launch_dkv(*_launch_inputs(4), count_pairs=True)
    for (entry, a), pairs, heads in zip(calls, (dq_pairs, dkv_pairs), (4, 2)):
        slot = kernels.ENTRY_POINTS[entry][1].index(kernels.I) - 1
        assert a[slot] is pairs
        assert pairs.dtype == torch.int32 and pairs.shape == (2 * heads,)
        assert not pairs.any()
    dq = attention._launch_dq(*_launch_inputs(4))
    assert calls[2][1][9] is dq and calls[2][1][10] is None


def test_launchers_refuse_ranges_built_for_another_tile(monkeypatch):
    """The kernels take their tile count from the grid; ranges of another
    block never reach them."""
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("reached the launcher"))
    monkeypatch.setattr(attention, "bwd_tile", lambda: 4)
    for launcher in (attention._launch_dq, attention._launch_dkv):
        with pytest.raises(ValueError, match="not built for the kernels' 4-row tile"):
            launcher(*_launch_inputs(8))


def _fwd_inputs(seg=None):
    a = _bwd_args(hd=64)
    seg = a["segment_ids"] if seg is None else _FakeCuda(seg)
    return (a["q"], a["k"], a["v"], seg, a["positions"], 0.125)


def test_forward_hands_the_kernel_the_tile_ranges(monkeypatch):
    """The forward's launch arguments, recorded in place of the launcher:
    tensors then ints then the scale, as many as the C parameters less the
    stream, with the tile ranges of the segment ids after the positions,
    built for the tile its library reports (4 rows here), and a null
    tile-pair counter last among the pointers."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(attention, "fwd_tile", lambda: 4)
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 0, 0]], dtype=torch.int32)
    out, lse = _flash_fwd(*_fwd_inputs(seg))
    [(entry, a)] = calls
    assert entry == "flash_attn_fwd_bf16"
    argtypes = kernels.ENTRY_POINTS[entry][1]
    assert len(a) + 1 == len(argtypes)  # + the stream
    n_ptr = argtypes.index(kernels.I)
    assert all(isinstance(x, torch.Tensor) for x in a[:n_ptr - 1])
    assert a[n_ptr - 1] is None
    assert a[n_ptr:] == (1, 8, 4, 2, 64, 0.125)
    ranges = a[5]
    assert ranges.dtype == torch.int32 and ranges.is_contiguous()
    assert torch.equal(ranges, attention.tile_segment_ranges(seg, 4))
    assert ranges.tolist() == [[[1, 2], [2, 2]]]
    assert a[6] is out and a[7] is lse
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 8)


def test_forward_takes_given_ranges_and_counts_one_zeroed_slot_per_cta(monkeypatch):
    """Ranges handed in reach the kernel as they are; with count_pairs the
    counter has one int32 slot per CTA of the (q tile, q head, row) grid."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(attention, "fwd_tile", lambda: 4)
    seg = torch.tensor([[1, 1, 2, 2, 2, 2, 2, 2]], dtype=torch.int32)
    ranges = _FakeCuda(attention.tile_segment_ranges(seg, 4))
    out, lse, pairs = _flash_fwd(*_fwd_inputs(seg), ranges=ranges, count_pairs=True)
    a = calls[0][1]
    assert a[5] is ranges and a[8] is pairs
    assert pairs.dtype == torch.int32 and pairs.shape == (2 * 4,) and not pairs.any()


def test_forward_refuses_ranges_built_for_another_tile(monkeypatch):
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("reached the launcher"))
    monkeypatch.setattr(attention, "fwd_tile", lambda: 4)
    seg = torch.zeros((1, 8), dtype=torch.int32)
    ranges = _FakeCuda(attention.tile_segment_ranges(seg, 8))
    with pytest.raises(ValueError, match="not built for the kernels' 4-row tile"):
        _flash_fwd(*_fwd_inputs(seg), ranges=ranges)


def test_shared_tile_ranges_need_one_tile_for_both_libraries(monkeypatch):
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 0, 0]], dtype=torch.int32)
    monkeypatch.setattr(attention, "fwd_tile", lambda: 4)
    monkeypatch.setattr(attention, "bwd_tile", lambda: 4)
    assert torch.equal(attention.shared_tile_ranges(seg), attention.tile_segment_ranges(seg, 4))
    monkeypatch.setattr(attention, "bwd_tile", lambda: 8)
    with pytest.raises(RuntimeError, match="forward tile 4 != backward tile 8"):
        attention.shared_tile_ranges(seg)


def test_fwd_tile_is_what_the_library_reports(monkeypatch):
    class _Lib:
        @staticmethod
        def flash_attn_fwd_tile():
            return 64

    asked = []
    monkeypatch.setattr(kernels, "library", lambda name: asked.append(name) or _Lib)
    attention.fwd_tile.cache_clear()
    try:
        assert attention.fwd_tile() == 64 and attention.fwd_tile() == 64
        assert asked == ["flash_attn"]  # asked once
    finally:
        attention.fwd_tile.cache_clear()


def test_bwd_tile_is_what_the_library_reports(monkeypatch):
    class _Lib:
        @staticmethod
        def flash_attn_bwd_tile():
            return 64

    asked = []
    monkeypatch.setattr(kernels, "library", lambda name: asked.append(name) or _Lib)
    attention.bwd_tile.cache_clear()
    try:
        assert attention.bwd_tile() == 64 and attention.bwd_tile() == 64
        assert asked == ["flash_attn_bwd"]  # asked once
    finally:
        attention.bwd_tile.cache_clear()


@pytest.mark.parametrize("a,b,match", [
    (torch.zeros(2, 8, dtype=torch.float64), torch.zeros(2, 8), "a: expected torch.float32"),
    (torch.zeros(8, 2).T, torch.zeros(2, 8), "a: expected a contiguous"),
    (torch.zeros(2, 8), torch.zeros(2, 9), "scan shapes"),
    (torch.zeros(16), torch.zeros(16), "expected 2 dims"),
])
def test_scan_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, a, b, match):
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("reached the launcher"))
    with pytest.raises(ValueError, match=match):
        _scan_kernel(_FakeCuda(a), _FakeCuda(b))


@pytest.mark.parametrize("bad,match", [
    (dict(seg=torch.int64), "segment_ids: expected torch.int32"),
    (dict(seg_shape=(2, 9)), "differ in shape"),
    (dict(shape=(16,)), "expected 2 dims"),
])
def test_packed_gae_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, bad, match):
    """The fused GAE entry takes float inputs of any float type (cast to
    float32, made contiguous) and int32 segment ids of the same shape."""
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("reached the launcher"))
    shape = bad.get("shape", (2, 8))
    floats = [_FakeCuda(torch.zeros(shape, dtype=torch.bfloat16)) for _ in range(3)]
    seg = _FakeCuda(torch.zeros(bad.get("seg_shape", shape), dtype=bad.get("seg", torch.int32)))
    with pytest.raises(ValueError, match=match):
        _packed_gae_kernel(floats[0], floats[1], seg, floats[2], 1.0, 0.95)


def test_gae_wrappers_pass_arguments_of_their_c_types(monkeypatch):
    """Both GAE entries' launch arguments, recorded in place of the
    launcher: one per C parameter less the stream, a tensor for each
    pointer, ints for ints, floats for floats (gamma and gamma * lam), the
    plan and scratch of ``_plan_args`` last."""
    from areal_tpu_torch.ops import gae

    calls = []
    monkeypatch.setattr(kernels, "launch", lambda entry, *a: calls.append((entry, a)))
    scratch = [_FakeCuda(torch.zeros(k, dtype=torch.int32)) for k in (8, 4, 1)]
    monkeypatch.setattr(gae, "_plan_args", lambda dev, R, T, plan: (1024, 4, *scratch, 9))
    a = _FakeCuda(torch.zeros((2, 8)))
    seg = _FakeCuda(torch.ones((2, 8), dtype=torch.int32))
    x = _scan_kernel(a, a)
    adv, ret = _packed_gae_kernel(a, a, seg, a, 0.97, 0.95)
    assert [c[0] for c in calls] == ["gae_scan_f32", "packed_gae_f32"]
    c_type = {kernels.P: torch.Tensor, kernels.I: int, kernels.F: float, kernels.U: int}
    for entry, args in calls:
        argtypes = kernels.ENTRY_POINTS[entry][1]
        assert len(args) + 1 == len(argtypes)  # + the stream
        assert all(isinstance(v, c_type[t]) for v, t in zip(args, argtypes))
        assert args[-6:-4] == (1024, 4) and args[-1] == 9
    assert calls[0][1][2] is x and calls[1][1][4:6] == (adv, ret)
    assert calls[1][1][6:10] == (0.97, 0.97 * 0.95, 2, 8)


def test_autograd_function_hands_the_forward_residuals_to_the_backward(monkeypatch):
    """The wiring of the torch.autograd.Function that a CUDA tensor takes,
    with the two launchers replaced by the plain versions: the forward gets
    tile ranges built once for the tile both libraries report, the backward
    receives the forward's out, logsumexp and those ranges, and the
    gradients equal autograd through the plain attention."""
    seen = []
    monkeypatch.setattr(attention, "fwd_tile", lambda: 4)
    monkeypatch.setattr(attention, "bwd_tile", lambda: 4)

    def fake_fwd(q, k, v, seg, pos, scale, ranges):
        seen.append(("fwd", ranges.clone()))
        assert torch.equal(ranges, attention.tile_segment_ranges(seg, 4))
        out = attention.reference_packed_attention(q, k, v, seg, pos, softmax_scale=scale)
        mask = attention.segment_causal_mask(seg, pos)[:, None]
        s = torch.einsum("rqhd,rkhd->rhqk", q, k.repeat_interleave(2, dim=2)) * scale
        lse = torch.logsumexp(torch.where(mask, s, attention.NEG_INF), dim=-1)
        return out, lse

    def fake_bwd(q, k, v, seg, pos, out, lse, dout, scale, ranges):
        seen.append(("bwd", ranges.clone()))
        assert out.shape == q.shape and lse.shape == (1, 4, 8) and dout.is_contiguous()
        return attention.reference_packed_attention_bwd(
            q, k, v, seg, pos, dout, softmax_scale=scale, out=out, lse=lse)

    monkeypatch.setattr(attention, "_flash_fwd", fake_fwd)
    monkeypatch.setattr(attention, "_flash_bwd", fake_bwd)
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 4, 64), generator=g)
    k = torch.randn((1, 8, 2, 64), generator=g)
    v = torch.randn((1, 8, 2, 64), generator=g)
    w = torch.randn((1, 8, 4, 64), generator=g)
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 0]], dtype=torch.int32)
    pos = torch.tensor([[0, 1, 2, 0, 1, 2, 3, 0]], dtype=torch.int32)
    grads = []
    for fn in (lambda *a: attention._FlashAttention.apply(*a, 0.125),
               lambda *a: attention.reference_packed_attention(*a, softmax_scale=0.125)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, seg, pos) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    assert [name for name, _ in seen] == ["fwd", "bwd"]
    assert torch.equal(seen[0][1], seen[1][1])
    assert seen[1][1].tolist() == [[[1, 2], [2, 2]]]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_wrapper_hands_the_kernel_its_mode(monkeypatch, int8):
    """Decode mode (a page row per sequence): the split plan of the shapes
    and the SM count, and f32 scratch for the splits' partials. Chunk mode
    (one page row expanded, row stride 0): one split, no scratch."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda entry, *a: calls.append((entry, a)))
    monkeypatch.setattr(paged, "_sm_count", lambda index: 132)
    B, Hq, Hkv, hd, N, pg, P = 16, 12, 2, 64, 40, 16, 32
    q = _FakeCuda(torch.zeros((B, Hq, hd), dtype=torch.bfloat16))
    if int8:
        pool = (_FakeCuda(torch.zeros((Hkv, N, pg, hd), dtype=torch.int8)),
                _FakeCuda(torch.ones((Hkv, N, pg))))
    else:
        pool = _FakeCuda(torch.zeros((Hkv, N, pg, hd), dtype=torch.bfloat16))
    lens = _FakeCuda(torch.ones(B, dtype=torch.int32))
    rows = _FakeCuda(torch.zeros((B, P), dtype=torch.int32))
    splits, per = paged.split_plan(B, Hkv, P, 132)
    assert splits > 1
    for pi, stride, want_splits, want_per in ((rows, P, splits, per),
                                              (rows[:1].expand(B, P), 0, 1, P)):
        calls.clear()
        out = _paged_decode_kernel(q, pool, pool, lens, pi, 0.125)
        [(entry, a)] = calls
        assert entry == ("paged_decode_int8" if int8 else "paged_decode_bf16")
        argtypes = kernels.ENTRY_POINTS[entry][1]
        assert len(a) + 1 == len(argtypes)
        at = argtypes.index(kernels.I)  # the row stride, then out and the scratch
        assert a[at] == stride and a[at + 1] is out
        if want_splits > 1:
            assert a[at + 2].dtype == torch.float32
            assert a[at + 2].numel() == B * Hq * want_splits * (hd + 2)
        else:
            assert a[at + 2] is None
        assert a[at + 3:] == (B, Hq, Hkv, N, pg, hd, P, want_splits, want_per, 0.125)


def test_missing_nvcc_is_a_build_error(monkeypatch, tmp_path):
    if any(kernels._lib_path(n).exists() for n in kernels.SOURCES):
        pytest.skip("kernel libraries already built in this checkout")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all()
    assert not any(kernels._lib_path(n).exists() for n in kernels.SOURCES)
