"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/`` at the root of the checkout, under a
name that carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built when a module is
imported: the first launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: source name → (build seconds, nvcc's ptxas report) of builds made by this process
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then ``/usr/local/cuda``."""
    candidates: List[str] = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the port's CUDA kernels are built from source at first use"
    )


def library_path(source: str) -> Path:
    """Where the shared library built from ``csrc/<source>`` lives."""
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash exists."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    start = time.perf_counter()
    # Compile to a private name and rename into place, so that two processes
    # building at once never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)],
            capture_output=True,
            text=True,
            check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOG[source] = (time.perf_counter() - start, proc.stderr)
    return target


def load_library(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; cached per process."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LIBS[source] = lib
        return lib
