"""Build the package's CUDA sources with nvcc at first use and load them
with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (pointers and the stream
as ``void*``), so it compiles in seconds without PyTorch's headers. The
shared library goes to ``sayuri_tpu_torch/_build/`` (git-ignored) and is
rebuilt when the source or any shared header ``csrc/*.cuh`` is newer than
it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIBS: dict = {}
# seconds each library took to build in this process (0.0 when reused)
BUILD_SECONDS: dict = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def compile_library(src: Path, out: Path) -> None:
    """nvcc `src` (its headers beside it) into the shared library `out`; the
    ptxas report goes to out's directory as lib<name>.ptxas.txt."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (rc={res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    (out.parent / f"lib{src.stem}.ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """Build (if stale) and load csrc/<name>.cu; cached per process."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    t0 = time.monotonic()
    newest = max(f.stat().st_mtime for f in (src, *CSRC_DIR.glob("*.cuh")))
    if not out.exists() or out.stat().st_mtime < newest:
        compile_library(src, out)
    BUILD_SECONDS[name] = time.monotonic() - t0
    lib = ctypes.CDLL(str(out))
    _LIBS[name] = lib
    return lib
