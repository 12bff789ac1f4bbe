"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``areal_tpu_torch/csrc/`` has a plain C interface. At
first use it is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library under ``areal_tpu_torch/build/`` (named by a hash of the source
and of the shared ``*.cuh`` headers beside it, so an edited source or
header is rebuilt) and loaded with ``ctypes``. All sources build in
parallel, one ``nvcc`` each. Nothing here runs at import: the CPU tests
import every module of the port on a machine with no ``nvcc``.

The wrappers (``ops/attention.flash_packed_attention`` and its backward,
``engine/paged.paged_decode_attention``, ``ops/gae.segment_scan_reverse``
and ``ops/gae.packed_gae``)
pass tensor pointers and the
current CUDA stream, raise if the C entry point returns a CUDA error,
and add one to ``launches[name]`` per call of the entry point (one call
may run more than one CUDA kernel: the split-K paged decode runs its
splits, then a combine), so a run can show that its main path went
through each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# library name -> source file under csrc/
SOURCES = {
    "flash_attn": "flash_attn.cu",
    "paged_decode": "paged_decode.cu",
    "flash_attn_bwd": "flash_attn_bwd.cu",
    "gae_scan": "gae_scan.cu",
}

# Kernel launch counts by kernel name (the C entry points).
launches: Dict[str, int] = {
    "flash_attn_fwd_bf16": 0,
    "paged_decode_bf16": 0,
    "paged_decode_int8": 0,
    "flash_attn_bwd_dq_bf16": 0,
    "flash_attn_bwd_dkv_bf16": 0,
    "gae_scan_f32": 0,
    "packed_gae_f32": 0,
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
# ptxas register / shared-memory report of each build, by library name.
build_logs: Dict[str, str] = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
U = ctypes.c_uint

# C entry point -> (library, argtypes); every entry returns a cudaError_t.
ENTRY_POINTS = {
    "flash_attn_fwd_bf16": (
        "flash_attn", [P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P]),
    "paged_decode_bf16": (
        "paged_decode", [P, P, P, P, P, I, P, P, I, I, I, I, I, I, I, I, I, F, P]),
    "paged_decode_int8": (
        "paged_decode", [P, P, P, P, P, P, P, I, P, P, I, I, I, I, I, I, I, I, I, F, P]),
    "flash_attn_bwd_dq_bf16": (
        "flash_attn_bwd", [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P]),
    "flash_attn_bwd_dkv_bf16": (
        "flash_attn_bwd", [P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P]),
    "gae_scan_f32": ("gae_scan", [P, P, P, I, I, I, I, P, P, P, U, P]),
    "packed_gae_f32": ("gae_scan", [P, P, P, P, P, P, F, F, I, I, I, I, P, P, P, U, P]),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from areal_tpu_torch/csrc at first use"
    )


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, of every shared
    header under csrc/ (a source may include any of them) and of the flags."""
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Sequence[str] = tuple(SOURCES)) -> float:
    """Compile every missing library in parallel; return the seconds
    spent. Raises with the compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if need be."""
    with _lock:
        if name not in _libs:
            build_all([name])
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def _function(entry: str):
    fn = _fns.get(entry)
    if fn is None:
        lib_name, argtypes = ENTRY_POINTS[entry]
        fn = getattr(library(lib_name), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def launch(entry: str, *args) -> None:
    """Call C entry point ``entry`` with ``args`` (tensors become their
    data pointers, None a null pointer) on the current CUDA stream, count
    the launch, and raise on a CUDA error."""
    fn = _function(entry)
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):  # the runtime launches on this device
        rc = fn(*c_args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed: cudaError_t {rc}")
    launches[entry] += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """The checks every wrapper makes before passing a pointer."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
