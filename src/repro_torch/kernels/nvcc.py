"""Builds the port's CUDA C++ kernels (no reference counterpart).

Each ``csrc/*.cu`` source has a plain C entry point.  It is compiled with
``nvcc`` into a shared library under the gitignored ``kernels/_build/`` at
first use — never at import — and loaded with ``ctypes`` by its wrapper
module.  A library is named by a hash of its source and flags, so an edit
rebuilds and an unchanged source is compiled once.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the port's kernels are built "
                       "from source at first use")


def build(source: Path, flags: Sequence[str]) -> Tuple[Path, str]:
    """Compile ``source`` with ``flags`` (once per source and flag set).
    Returns the shared library's path and what nvcc printed (its ptxas
    report; empty when the library was already built)."""
    tag = hashlib.sha256(source.read_bytes() +
                         " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, lib)
    return lib, log
