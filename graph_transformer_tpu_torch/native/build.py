"""Build the port's native host code with g++ (C ABI, loaded with ctypes).

    python -m graph_transformer_tpu_torch.native.build

compiles each source of :data:`TARGETS` into ``build/native/`` at the root
of the checkout (listed in ``.gitignore``), as ``lib<name>-<hash>.so``
where ``<hash>`` covers the source and the flags: an edited source rebuilds,
an unchanged one is reused.  Nothing is built when the package is imported;
the wrappers call :func:`ensure` at their first use.  A failed build raises
with the compiler's message: no caller falls back to another path.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "native"
TARGETS = {"log_uniform": "log_uniform.cpp", "batcher": "batcher.cpp"}
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def lib_path(name: str) -> Path:
    src = HERE / TARGETS[name]
    h = hashlib.sha256(" ".join(FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = True) -> str:
    """Compile ``name`` into :func:`lib_path` (through a temporary file
    moved into place, so a concurrent reader never loads half a library)."""
    out = lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    cmd = ["g++", *FLAGS, str(HERE / TARGETS[name]), "-o", str(tmp)]
    if verbose:
        print("+", " ".join(cmd))
    done = subprocess.run(cmd, capture_output=not verbose, text=True)
    if done.returncode:
        raise RuntimeError(f"g++ failed ({done.returncode}) building "
                           f"{TARGETS[name]}:\n{done.stderr or ''}")
    os.replace(tmp, out)
    return str(out)


def ensure(name: str) -> str:
    """The library's path, built if it is not there."""
    out = lib_path(name)
    return str(out) if out.exists() else build(name, verbose=False)


def main() -> int:
    for name in TARGETS:
        print(f"built {build(name)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
