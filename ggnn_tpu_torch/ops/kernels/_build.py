"""Builds the package's CUDA kernels at first use and loads them.

Each source under `ggnn_tpu_torch/csrc/` has a plain C interface and is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under
`build/kernels/` at the repository root, then loaded with `ctypes`. The
library's file name carries a hash of its source, so an edited source is
rebuilt and a stale library is never loaded. Nothing is compiled when a
module is imported: the first launch builds.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, compiler output); empty when a
# library from an earlier process was loaded as it was.
build_info: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of ggnn_tpu_torch are compiled on first use")


def _source(name: str, source=None) -> Path:
    return Path(source) if source is not None else CSRC / f"{name}.cu"


def library_path(name: str, source=None) -> Path:
    source = _source(name, source)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str, source=None) -> Path:
    """Compile `csrc/<name>.cu` (or `source`, another tree's copy of it)
    unless its library is already built."""
    target = library_path(name, source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_source(name, source))]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    build_info[name if source is None else str(source)] = (
        seconds, proc.stdout + proc.stderr)
    return target


def build_all(names: Sequence[str]) -> None:
    """Compile several sources at once, one `nvcc` for each, so that a
    script that needs them all (`chip_smoke.py`) waits for the slowest
    build, not for their sum."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        list(pool.map(build, names))


def load(name: str, source=None) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` (or of `source`), built if
    needed."""
    key = str(_source(name, source))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, source)))
            _libs[key] = lib
        return lib
