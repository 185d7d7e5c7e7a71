"""The PyTorch port stands alone: no module of it (the HPO harness, a numpy
module, included), and neither chip_smoke.py
nor scripts/torch_wide_probe.py, torch_determinism_probe.py,
torch_node_phases.py, torch_k18_variants.py, torch_parallel_probe.py,
torch_rows_bwd_variants.py or torch_ab_summary.py, imports jax,
jaxlib or the JAX package, nor sklearn, pandas or networkx (the card's
machine has none of them); importing it builds nothing and does not import
triton."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "graph_transformer_tpu"}
NOT_ON_CARD = {"sklearn", "networkx", "pandas"}
# the modules of the multiplex pipeline and the node baselines; the batch
# assembler, profiling, prefetch, torch-convention weights, the graph-level
# GCN baseline, OrthoNet and the HPO harness and CLI; the parallel layer
NEW_MODULES = ("data/multiplex.py", "models/multilayer.py", "models/gcn.py",
               "models/gat.py", "train/ml_node_trainer.py",
               "utils/laplacian.py", "cli/node_classification.py",
               "native/batcher.py", "utils/profiling.py",
               "train/prefetch.py", "utils/torch_compat.py",
               "models/gcn_unsup_graphs.py", "models/orthonet.py",
               "exp/__init__.py", "exp/hpo.py", "cli/hpo.py",
               "parallel/__init__.py", "parallel/mesh.py",
               "parallel/bootstrap.py", "parallel/launch.py",
               "parallel/spmd.py", "parallel/edge_partition.py",
               "parallel/dryrun.py")
FILES = sorted(ROOT.glob("graph_transformer_tpu_torch/**/*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_wide_probe.py",
    ROOT / "scripts" / "torch_determinism_probe.py",
    ROOT / "scripts" / "torch_node_phases.py",
    ROOT / "scripts" / "torch_k18_variants.py",
    ROOT / "scripts" / "torch_parallel_probe.py",
    ROOT / "scripts" / "torch_rows_bwd_variants.py",
    ROOT / "scripts" / "torch_ab_summary.py"]


def imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules():
    assert len(FILES) > 20
    for rel in NEW_MODULES:
        assert ROOT / "graph_transformer_tpu_torch" / rel in FILES, rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_sklearn_or_networkx_imports(path):
    bad = NOT_ON_CARD.intersection(imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


IMPORT_ALL = r"""
import importlib, pkgutil, subprocess, sys

def refuse(*a, **k):
    raise AssertionError(f"a process was started at import: {a!r}")

subprocess.Popen = subprocess.run = subprocess.call = refuse
import graph_transformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
for bad in ("triton", "jax", "jaxlib", "graph_transformer_tpu"):
    assert bad not in sys.modules, bad
print("imported", len(names))
"""


def test_import_builds_nothing():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 15


@pytest.mark.parametrize("name,binding", [
    ("log_uniform", "log_uniform_native.py"), ("batcher", "batcher.py")])
def test_native_loader_resolves_under_build(name, binding):
    """The port's native sampler and batch assembler load their own builds
    under ``build/`` (``native/build.py``), never the JAX package's
    libraries, and the port keeps its own copy of each C++ source."""
    from graph_transformer_tpu_torch.native import build

    path = build.lib_path(name)
    assert path.is_relative_to(ROOT / "build" / "native")
    assert "graph_transformer_tpu/native" not in str(path)
    native = ROOT / "graph_transformer_tpu_torch" / "native"
    assert (native / build.TARGETS[name]).is_file()
    src = (native / binding).read_text()
    assert "graph_transformer_tpu_torch.native.build import ensure" in src
