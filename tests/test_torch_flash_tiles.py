"""The backward kernels' segment-aware tile skip, checked on the CPU.

``tile_segment_ranges`` gives each tile of each packed row its lowest and
highest positive segment id, and ``live_tile_pairs`` is the predicate the
two CUDA kernels of ``csrc/flash_attn_bwd.cu`` apply to a (q tile, kv tile)
pair: causal, and the two ranges meet. On seeded numpy packings:

- the ranges equal a per-tile loop over the ids (a tile of padding gets
  the empty range);
- safe: every pair the predicate skips is an all-false block of
  ``segment_causal_mask``, so skipping it changes no output;
- tight: for rows built by ``models/packing.pack_sequences`` (contiguous
  sequences, ascending positions) every pair it keeps holds a live entry.
"""

import zlib

import numpy as np
import pytest
import torch

from areal_tpu_torch.models.packing import pack_sequences
from areal_tpu_torch.ops.attention import (
    live_tile_pairs,
    segment_causal_mask,
    tile_segment_ranges,
)


def _packed(lens, row_len, n_rows_multiple=1):
    seqs = [np.zeros(int(n), np.int32) for n in lens]
    b = pack_sequences(seqs, row_len=row_len, n_rows_multiple=n_rows_multiple)
    return b.segment_ids, b.positions


def _scattered(rng, T, n_seg):
    """Ids in no order along the row, each sequence's positions ascending
    with the row index (the kernels' causal tile rule needs only that)."""
    seg = rng.integers(0, n_seg + 1, size=(1, T)).astype(np.int32)
    pos = np.zeros_like(seg)
    for s in range(1, n_seg + 1):
        at = seg[0] == s
        pos[0, at] = np.arange(at.sum())
    return seg, pos


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "many_short":  # ~6600 tokens of 20-90-token sequences in rows of 4096
        return _packed(rng.integers(20, 90, size=120), 4096), True
    if name == "ends_mid_tile":
        return _packed([100, 37, 250, 61, 1, 63, 65, 129, 700, 300], 2048), True
    if name == "one_long":
        return _packed([4096, 4096], 4096), True
    if name == "padding_tiles":  # one short row and one row of padding only
        return _packed([70, 30], 4096, n_rows_multiple=2), True
    if name == "ragged_T":  # T = 1000: the last tile is cut
        return _packed(rng.integers(30, 300, size=12), 1000), True
    if name == "scattered_ids":  # not a packer layout: safety only
        return _scattered(rng, 700, 5), False
    raise KeyError(name)


def _loop_ranges(seg, block):
    R, T = seg.shape
    n = -(-T // block)
    out = np.zeros((R, n, 2), np.int64)
    for r in range(R):
        for t in range(n):
            ids = seg[r, t * block:(t + 1) * block]
            ids = ids[ids > 0]
            out[r, t] = (ids.min(), ids.max()) if ids.size else (np.iinfo(np.int32).max, 0)
    return out


CASES = ["many_short", "ends_mid_tile", "one_long", "padding_tiles", "ragged_T",
         "scattered_ids"]


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("name", CASES)
def test_tile_skip_is_safe_and_tight(name, block):
    (seg, pos), packer_layout = _case(name)
    R, T = seg.shape
    n = -(-T // block)
    ranges = tile_segment_ranges(torch.from_numpy(seg), block)
    assert ranges.dtype == torch.int32 and ranges.shape == (R, n, 2)
    np.testing.assert_array_equal(ranges.numpy(), _loop_ranges(seg, block))

    keep = live_tile_pairs(ranges)
    assert keep.shape == (R, n, n)
    # Which (q tile, kv tile) blocks of the mask hold a live entry.
    mask = segment_causal_mask(torch.from_numpy(seg), torch.from_numpy(pos))
    mask = torch.nn.functional.pad(mask, (0, n * block - T, 0, n * block - T))
    live = mask.reshape(R, n, block, n, block).any(dim=4).any(dim=2)

    assert not (live & ~keep).any(), "a skipped tile pair holds a live entry"
    if packer_layout:
        assert not (keep & ~live).any(), "a kept tile pair is all mask"
    # A tile of padding only is never computed, as q tile or as kv tile.
    empty = ranges[..., 0] > ranges[..., 1]
    assert not keep[empty[:, :, None].expand(R, n, n)].any()
    assert not keep.transpose(1, 2)[empty[:, :, None].expand(R, n, n)].any()
    if name == "one_long":  # nothing to skip but the causal rule
        assert keep.sum().item() == R * n * (n + 1) // 2
    if name == "padding_tiles":
        assert empty[1].all() and not keep[1].any()
