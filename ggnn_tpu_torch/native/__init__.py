"""The native (C++) host libraries: the batch packer of the host pipeline
(the port of `ggnn_tpu/native/__init__.py`) and the zstd decoder of the
Orbax checkpoints (`zstd.cpp`, `codec.py`), their builds and `ctypes`
bindings.

`packer.cpp` and `zstd.cpp` are host code. Each is compiled with g++
(`-O3 -march=native -shared -fPIC`) into `build/native/` at the
repository root on first use, never when a module is imported. A
library's file name carries a hash of its source and of the host's CPU
(the build is `-march=native`, so a checkout shared between machines
must not reuse it), so an edited source or another CPU builds anew.
Builders in several threads or processes (pytest workers) take a file
lock under `build/native/`; g++ writes a private file that is renamed
into place, so no process loads a half-written library. Old libraries
are never deleted here: another process may still be loading one.

Set GGNN_TPU_NO_NATIVE=1 (or true/yes/on) to pack with the numpy
packers; the variable is the JAX package's, so one launcher switches
both packages. A failed build of the packer warns once, with the
compiler's message, and the packers fall back to numpy as the JAX
package's do. The zstd decoder has no fallback (`codec.py`).
"""

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "packer.cpp"
ZSTD_SOURCE = SOURCE.with_name("zstd.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LOAD_ERROR: Optional[str] = None
_BUILD_LOCK = threading.Lock()
# What the last build or load did: "path", and "seconds" the g++ run took
# (None when a library built earlier was loaded as it was).
build_info: Dict = {}


class NativeBuildError(RuntimeError):
    """g++ failed to build a native source; the message holds its
    output."""


def _no_native_env() -> bool:
    """GGNN_TPU_NO_NATIVE parsed as a boolean: '0', 'false' or '' keep
    the native packer on (a launcher exporting =0 to mean 'enabled' must
    not turn it off)."""
    return os.environ.get("GGNN_TPU_NO_NATIVE", "").strip().lower() in (
        "1", "true", "yes", "on")


def _host_salt() -> str:
    """The CPU's identity, for the library's name: x86 names the part in
    /proc/cpuinfo's 'model name'; aarch64 has no 'model name' and names
    it by 'CPU implementer' and 'CPU part', so both families are read (a
    salt of platform.machine() alone would reuse a Neoverse-V2 build on
    an N1, which dies of an illegal instruction)."""
    parts = [platform.machine(), platform.processor() or ""]
    try:
        with open("/proc/cpuinfo") as f:
            seen = set()
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "Model", "CPU implementer",
                           "CPU part", "CPU variant", "CPU revision",
                           "cpu", "machine") and key not in seen:
                    seen.add(key)
                    parts.append(line.split(":", 1)[1].strip())
    except OSError:
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:8]


def library_path(source: Path = None) -> Path:
    source = SOURCE if source is None else source
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}_{digest[:16]}_{_host_salt()}.so"


def build(source: Path = None) -> Path:
    """Compile `source` (`packer.cpp` by default) unless this source's
    library for this CPU is already built; the path of the library."""
    source = SOURCE if source is None else source
    target = library_path(source)
    if target.exists():
        build_info.update(path=str(target), seconds=None)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # flock conflicts between two open() calls of one process too, so the
    # lock serialises threads as well as processes.
    with open(BUILD_DIR / ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if target.exists():
                build_info.update(path=str(target), seconds=None)
                return target
            fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
            os.close(fd)
            cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(source)]
            start = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError:
                os.unlink(tmp)
                raise
            if proc.returncode != 0:
                os.unlink(tmp)
                raise NativeBuildError(
                    f"g++ failed to build {source.name} (exit "
                    f"{proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
            build_info.update(path=str(target),
                              seconds=time.perf_counter() - start)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of the five entry points, the JAX package's ABI:
    `ndpointer` for the batch packers, raw pointers for the one-graph
    pack (the serving latency path, where `ndpointer`'s check of each of
    its 12 arrays costs more than the pack)."""
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.pack_dense_batch.restype = None
    lib.pack_dense_batch.argtypes = [
        p_i32, p_i64, p_f32, p_i64, p_i32,
        i32, i32, i32, i32, i32, i32,
        p_f32, p_f32, p_f32,
    ]
    lib.pack_gcn_dense_batch.restype = None
    lib.pack_gcn_dense_batch.argtypes = [
        p_i32, p_i64, p_f32, p_i64, p_i32,
        i32, i32, i32, i32,
        p_f32, p_f32, p_f32,
    ]
    lib.pack_sparse_batch.restype = i32
    lib.pack_sparse_batch.argtypes = [
        p_i32, p_i64, p_f32, p_i64, p_i32,
        i32, i32, i32, i32, i32, i32,
        p_i32, p_i32, p_f32, p_f32, p_f32, p_i32, p_i64,
    ]
    lib.pack_gcn_batch.restype = i64
    lib.pack_gcn_batch.argtypes = [
        p_i32, p_i64, p_f32, p_i64, p_i32,
        i32, i64, i32, i32,
        p_i32, p_i32, p_f32, p_f32, p_i32,
    ]
    vp = ctypes.c_void_p
    lib.pack_single_sparse.restype = i32
    lib.pack_single_sparse.argtypes = [
        vp, i64, vp, i32, i32, i32, i32, i32, i32, i64, i32, i32,
        vp, vp, vp, vp, vp, vp, vp,
        vp, vp, vp,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use; None when
    GGNN_TPU_NO_NATIVE is set or the build failed (which warns once,
    with the compiler's message)."""
    global _LIB, _LOAD_ERROR
    if _no_native_env():
        return None
    if _LIB is None and _LOAD_ERROR is None:
        with _BUILD_LOCK:
            if _LIB is None and _LOAD_ERROR is None:
                try:
                    _LIB = _bind(ctypes.CDLL(str(build())))
                except (OSError, NativeBuildError) as e:
                    _LOAD_ERROR = str(e)
                    warnings.warn(
                        "ggnn_tpu_torch: the native packer did not build "
                        "or load; packing falls back to numpy: "
                        f"{_LOAD_ERROR}", RuntimeWarning, stacklevel=2)
    return _LIB


def native_available() -> bool:
    return get_lib() is not None


def require_lib() -> ctypes.CDLL:
    """Like `get_lib()`, but raises a descriptive error instead of
    returning None, for the entry points that need the native packer
    (data/native_pack.py)."""
    lib = get_lib()
    if lib is None:
        reason = ("disabled via GGNN_TPU_NO_NATIVE" if _no_native_env()
                  else f"build/load failed: {_LOAD_ERROR}")
        raise RuntimeError(
            "native packer library unavailable (%s); use the numpy "
            "packers in ggnn_tpu_torch.data.packing instead" % reason)
    return lib
