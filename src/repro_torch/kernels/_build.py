"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes
``build/repro_torch/lib<name>-<hash>.so`` at the repository root, keyed on a
hash of the flags, the source and every file of ``csrc/`` that it includes
(``source_digest``), so that one process builds once and a source whose
header was edited is rebuilt, never served from a stale library.  PyTorch's headers are never included: the build
takes seconds, not minutes.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

__all__ = ["BuildInfo", "build", "load_library", "source_digest", "BUILD_DIR", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: Path       # the shared library
    log: str         # nvcc's output, including ptxas' register and smem report
    seconds: float   # wall time of this call's build, 0.0 if it was built already
    cached: bool


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_digest(src: Path) -> str:
    """Hash of the flags, ``src`` and every file it includes with quotes
    from its own directory, followed through their own includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [src], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text + b"\0")
        todo += [src.parent / m.decode() for m in _INCLUDE.findall(text)
                 if (src.parent / m.decode()).is_file()]
    return h.hexdigest()[:16]


# One lock a library name: threads of one process that reach a kernel first
# at the same moment build it once (the concurrent executor's trials do).
_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.Lock())


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    one thread at a time for a name."""
    with _lock(name):
        return _build(name)


def _build(name: str) -> BuildInfo:
    src = CSRC_DIR / f"{name}.cu"
    digest = source_digest(src)
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(lib, log, 0.0, True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # pid and thread id: no two builders, in this process or another, share
    # a temp file
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    return BuildInfo(lib, log, seconds, False)


_LIBS: dict = {}


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one load per process,
    under the name's lock."""
    with _lock(name):
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_build(name).path))
        return _LIBS[name]
