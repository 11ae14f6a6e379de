"""Build a CUDA source of ``ops/csrc`` into a shared library and load it.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``easydl_tpu_torch/_build/`` (git-ignored), under a name that carries the hash
of the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. The library has a plain C interface and is loaded
with ``ctypes``: no PyTorch headers, so a build takes seconds.

Nothing here runs at import time; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the CUDA "
        "kernels of easydl_tpu_torch need the CUDA toolkit to build")


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` unless a build of this exact text exists.

    Returns the library's path and ``nvcc``'s output (``-Xptxas -v``:
    registers, shared memory and spills of each kernel); the output is
    empty when the library was already built."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    path, _ = build(source)
    return ctypes.CDLL(str(path))
