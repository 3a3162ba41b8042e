"""Build and load the port's CUDA kernels (nvcc + ctypes, no PyTorch headers).

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled with
``nvcc`` into a shared library at first use, under ``_build/`` in the package
(git-ignored). The library name carries a hash of the source and the flags,
so editing the source rebuilds it. A failed build or load raises: there is
no fallback. Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when loaded from the cache), "log": ptxas output}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its cached build is missing, then load it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True,
            text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": str(so)}
    return lib
