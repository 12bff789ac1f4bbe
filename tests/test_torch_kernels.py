"""The port's CUDA kernel plumbing, checked where no card and no nvcc
exist: the kernels themselves compile and run only on the GPU, where
chip_smoke.py holds each against its plain version.

- every C entry point declared in ``kernels.ENTRY_POINTS`` exists in its
  source with as many parameters as its ctypes argtypes (a mismatch
  would pass pointers as ints on the card);
- a kernel's launcher refuses a CPU tensor (the wrappers send CPU
  tensors to the plain version before they reach it);
- with no nvcc, the first launch fails with a build error.
"""

import re

import pytest
import torch

from areal_tpu_torch import kernels
from areal_tpu_torch.engine.paged import _paged_decode_kernel
from areal_tpu_torch.ops.attention import _flash_fwd


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


def test_sources_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in " ".join(kernels.NVCC_FLAGS)
    for src in kernels.SOURCES.values():
        text = open(kernels.CSRC_DIR / src).read()
        assert "Replaces" in text or "Takes the role" in text or "replaces" in text


def test_library_path_tracks_the_source():
    paths = {kernels._lib_path(n) for n in kernels.SOURCES}
    assert len(paths) == len(kernels.SOURCES)
    assert all(p.parent == kernels.BUILD_DIR for p in paths)


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


def test_missing_nvcc_is_a_build_error(monkeypatch, tmp_path):
    if any(kernels._lib_path(n).exists() for n in kernels.SOURCES):
        pytest.skip("kernel libraries already built in this checkout")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all()
    assert not any(kernels._lib_path(n).exists() for n in kernels.SOURCES)
