"""Build the CUDA sources of ``ops/csrc`` into one shared library and load it.

Each source is compiled by its own ``nvcc`` for Hopper (``sm_90a``), all of
them at once, and the objects are linked into one library in
``easydl_tpu_torch/_build/`` (git-ignored), under a name that carries the
hash of every source and header and of the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. The library has a plain C
interface and is loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds.

Nothing here runs at import time; the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _digest(sources: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / src for src in sources]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _run(procs, what: str) -> str:
    """Wait for every process; raise naming the first that failed."""
    logs, failed = [], None
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed on {src} (exit {proc.returncode}):\n{out}"
    if failed:
        raise RuntimeError(f"{what}: {failed}")
    return "".join(logs)


def build(sources: Sequence[str]) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` for each source and link them into one
    library, unless a build of these exact texts exists.

    Returns the library's path and ``nvcc``'s output (``-Xptxas -v``:
    registers, shared memory and spills of each kernel); the output is
    empty when the library was already built."""
    out = BUILD_DIR / f"{Path(sources[0]).stem}-{_digest(sources)}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{out.name}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in sources]
    try:
        log = _run([(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in zip(sources, objs)], "compile")
        tmp = out.with_name(f"{tag}.tmp")
        log += _run([("link", subprocess.Popen(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs), "-ldl"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))], "link")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        for path in objs + [out.with_name(f"{tag}.tmp")]:
            path.unlink(missing_ok=True)
    return out, log


def load(sources: Sequence[str]) -> ctypes.CDLL:
    path, _ = build(sources)
    return ctypes.CDLL(str(path))
