"""The PyTorch port stands alone: no module of it, and neither chip_smoke.py
nor scripts/torch_wide_probe.py or torch_determinism_probe.py, imports jax,
jaxlib or the JAX package;
importing it builds nothing and does not import triton."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "graph_transformer_tpu"}
FILES = sorted(ROOT.glob("graph_transformer_tpu_torch/**/*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_wide_probe.py",
    ROOT / "scripts" / "torch_determinism_probe.py"]


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


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(imported_roots(path))
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


def test_native_loader_resolves_under_build():
    """The port's native sampler loads its own build under ``build/``
    (``native/build.py``), never the JAX package's library."""
    from graph_transformer_tpu_torch.native import build

    path = build.lib_path("log_uniform")
    assert path.is_relative_to(ROOT / "build" / "native")
    assert "graph_transformer_tpu/native" not in str(path)
    src = (ROOT / "graph_transformer_tpu_torch" / "native"
           / "log_uniform_native.py").read_text()
    assert "graph_transformer_tpu_torch.native.build import ensure" in src
