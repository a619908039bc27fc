"""The PyTorch port stands alone: it imports neither jax nor any module of
``repro``, and its host-side copies have not drifted from their originals.

The drift guard compares each copied module's code with its original's:
the syntax trees, once import lines are normalised (``repro_torch.`` ->
``repro.``) and docstrings dropped (comments never reach the tree), must
be equal.  Docstrings and comments may speak for the port; every
statement must match.  A repair to one side must be made to both; this
test fails until it is.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
ORIG = REPO / "src" / "repro"

# modules the port copies (imports rewritten; docstrings may differ)
VERBATIM = [
    "core/profiler.py",
    "core/knowledge_tree.py",
    "core/controller.py",
    "core/reorder.py",
    "core/speculative.py",
    "serving/config.py",
    "serving/scheduler.py",
    "serving/metrics.py",
    "retrieval/corpus.py",
    "retrieval/traffic.py",
    "serving/router.py",
    "serving/frontdoor.py",
    "configs/qwen2_0p5b.py",
    "configs/mistral_7b.py",
    "configs/llama2_7b.py",
    "configs/mixtral_8x7b.py",
    "configs/phi35_moe_42b.py",
    "configs/internvl2_1b.py",
    "configs/xlstm_1p3b.py",
    "configs/hymba_1p5b.py",
    "configs/musicgen_large.py",
    "configs/gemma3_12b.py",
    "configs/gemma2_27b.py",
    "configs/yi_34b.py",
    "configs/llama2_70b.py",
    "serving/backend.py",
    "core/fault_tolerance.py",
    "core/iterative.py",
    "serving/simulator.py",
    "training/data.py",
]

JAX_IMPORT = re.compile(r"^\s*(import|from)\s+jax(\.|\s|$)", re.M)
REPRO_IMPORT = re.compile(r"^\s*(import|from)\s+repro(\.|\s|$)", re.M)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# modules each slice of the port added; every one is imported and scanned
SLICE_MODULES = [
    "repro_torch.kernels.paged_attention",
    "repro_torch.kernels.paged_prefill",
    "repro_torch.kernels.prefix_attention",
    "repro_torch.kernels.ref",
    "repro_torch.kernels.ops",
    "repro_torch.models.model",
    "repro_torch.models.layers",
    "repro_torch.serving.runtime",
    "repro_torch.serving.engine",
    "repro_torch.launch.serve",
    "repro_torch.serving.router",
    "repro_torch.serving.frontdoor",
    "repro_torch.retrieval.traffic",
    "repro_torch.configs.mistral_7b",
    "repro_torch.configs.llama2_7b",
    "repro_torch.configs.mixtral_8x7b",
    "repro_torch.configs.phi35_moe_42b",
    "repro_torch.configs.internvl2_1b",
    "repro_torch.configs.xlstm_1p3b",
    "repro_torch.configs.hymba_1p5b",
    "repro_torch.configs.musicgen_large",
    "repro_torch.configs.gemma3_12b",
    "repro_torch.configs.gemma2_27b",
    "repro_torch.configs.yi_34b",
    "repro_torch.configs.llama2_70b",
    "repro_torch.configs",
    "repro_torch.serving.backend",
    "repro_torch.core.fault_tolerance",
    "repro_torch.core.iterative",
    "repro_torch.serving.simulator",
    "repro_torch.training.data",
    "repro_torch.training.optimizer",
    "repro_torch.training.train_lib",
    "repro_torch.training.checkpoint",
    "repro_torch.launch.train",
    "repro_torch.launch.mesh",
    "repro_torch.launch.sharding",
    "repro_torch.launch.op_analysis",
    "repro_torch.launch.specs",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.perf_probe",
]


@pytest.mark.parametrize("mod", SLICE_MODULES)
def test_slice_module_is_guarded(mod):
    """The guards above cover every module of the port's slices."""
    assert mod in _port_modules()


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")]
    + [str(p.relative_to(REPO))
       for p in (REPO / "examples").glob("torch_*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_repro_import_in_source(path):
    src = (REPO / path).read_text()
    assert not JAX_IMPORT.search(src), f"{path} imports jax"
    assert not REPRO_IMPORT.search(src), f"{path} imports the JAX package"


def _code(text: str) -> str:
    """The module's syntax tree without docstrings, imports normalised."""
    text = re.sub(r"^(\s*(?:from|import)\s+)repro_torch\.", r"\1repro.",
                  text, flags=re.M)
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and body \
                and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_copy_matches_original(rel):
    """Drift guard: a fix on either side must land on both."""
    port = _code((PORT / rel).read_text())
    orig = _code((ORIG / rel).read_text())
    assert port == orig, (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}; apply the "
        f"same change to both copies")
