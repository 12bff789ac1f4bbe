"""The port imports neither JAX nor the JAX package, nor ml_dtypes (the
KV wire moves bfloat16 and float8 as torch tensors).

areal_tpu_torch and chip_smoke.py keep their own copies of what they
need from areal_tpu (config, quantization constants, ...): an AST scan
finds no ``import jax`` / ``import areal_tpu`` anywhere in them, and a
fresh interpreter that imports the port's modules has no ``jax`` in
``sys.modules`` (the pattern of tests/lint/test_areal_lint.py)."""

import ast
import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "areal_tpu", "ml_dtypes")


def _port_files():
    files = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO_ROOT, "areal_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("areal_tpu.models.config")
    assert not _forbidden("areal_tpu_torch.models.config")


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 10, files
    bad = [f"{os.path.relpath(p, REPO_ROOT)}:{line} imports {mod}"
           for p in files for line, mod in _imported_modules(p) if _forbidden(mod)]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("modules", [
    "areal_tpu_torch.engine.serving",
    "areal_tpu_torch.engine.serving, areal_tpu_torch.convert, "
    "areal_tpu_torch.models.hf.qwen2, areal_tpu_torch.kernels, chip_smoke",
    "areal_tpu_torch.engine.torch_engine, areal_tpu_torch.engine.optimizer, "
    "areal_tpu_torch.interfaces.ppo, areal_tpu_torch.interfaces.sft, "
    "areal_tpu_torch.ops.gae, areal_tpu_torch.ops.loss",
    "areal_tpu_torch.system.controller, areal_tpu_torch.system.master_worker, "
    "areal_tpu_torch.system.model_worker, areal_tpu_torch.system.stream_dataset, "
    "areal_tpu_torch.engine.factories, areal_tpu_torch.models.hf",
    "areal_tpu_torch.engine.kv_handoff, areal_tpu_torch.engine.kv_tier, "
    "areal_tpu_torch.system.generation_server, areal_tpu_torch.system.gserver_manager",
    "areal_tpu_torch.engine.weight_client, areal_tpu_torch.system.weight_plane, "
    "areal_tpu_torch.base.chunking, areal_tpu_torch.system.weight_transfer",
    "areal_tpu_torch.training.main_sft, areal_tpu_torch.experiments.sft_exp, "
    "areal_tpu_torch.datasets.prompt_answer, areal_tpu_torch.base.timeutil, "
    "areal_tpu_torch.models.hf.gemma, areal_tpu_torch.models.hf.gpt2, "
    "areal_tpu_torch.models.hf.mistral, areal_tpu_torch.models.hf.qwen3",
    "areal_tpu_torch.training.main_sync_ppo, areal_tpu_torch.experiments.ppo_math_exp, "
    "areal_tpu_torch.models.generation, areal_tpu_torch.interfaces, "
    "areal_tpu_torch.interfaces.reward, areal_tpu_torch.interfaces.fused, "
    "areal_tpu_torch.datasets.prompt",
])
def test_importing_the_port_loads_no_jax(modules):
    code = (
        "import sys\n"
        f"import {modules}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
