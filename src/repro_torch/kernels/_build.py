"""Build and load the port's CUDA kernels (nvcc into a shared library, ctypes).

Every source under ``csrc/`` (:data:`SOURCES`) is compiled on first use into
``build/repro_torch_kernels/`` at the repository root, by a plain ``nvcc``
call for ``sm_90a``; the first :func:`load` builds all of them, one ``nvcc``
process per source, in parallel.  The library's file name carries a hash of
the source and the flags, so an edited source is rebuilt and a stale library
is never loaded.  A file lock a source serialises the first build across
processes (the ranks of a mesh, ``launch.mesh.spawn``, load at once): one
compiles, the others wait and load its library.  Nothing here runs at
import: this module imports on a machine without ``nvcc`` or a GPU, and
only :func:`load` needs them.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
from concurrent.futures import ThreadPoolExecutor
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("paired_matmul", "decode_attention", "flash_attention")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(str(Path(CUDA_HOME) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def nvcc_version() -> str:
    out = subprocess.run(
        [_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout
    return out.strip().splitlines()[-1]


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.

    Returns ``{"path", "built", "seconds", "log"}``: ``built`` is False when
    the library was already there; ``log`` is nvcc's output (``-Xptxas -v``
    lists registers, shared memory and spills for each kernel).
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return {"path": lib, "built": False, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _locked(BUILD_DIR / f"{name}.lock"):
        if lib.exists():  # another process built it while this one waited
            return {"path": lib, "built": False, "seconds": 0.0, "log": ""}
        return _compile(src, lib)


@contextlib.contextmanager
def _locked(path: Path):
    """An exclusive lock on ``path`` between processes, held inside the block."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(src: Path, lib: Path) -> dict:
    t0 = time.perf_counter()
    # compile to a private name, then rename: concurrent builds never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {
        "path": lib,
        "built": True,
        "seconds": time.perf_counter() - t0,
        "log": proc.stdout + proc.stderr,
    }


@functools.cache
def build_all() -> dict[str, dict]:
    """:func:`build` every source in :data:`SOURCES` at once (one ``nvcc``
    each, in parallel); once per process.  Raises if any build fails."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {name: pool.submit(build, name) for name in SOURCES}
        return {name: f.result() for name, f in futures.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build_all()[name]["path"]))
