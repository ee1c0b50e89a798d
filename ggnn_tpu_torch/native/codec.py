"""The byte codecs of the Orbax directory checkpoints: zstd frames and
crc32c.

Reading decodes zstd frames with the port's own decoder (`zstd.cpp`,
RFC 8878), built by g++ into `build/native/` at first use as the packer
is (`native/__init__.py`) and bound with `ctypes`. It has no fallback:
when the build fails, `decompress` raises with the compiler's message.

Writing needs no entropy coder: `compress` makes a valid zstd frame of
raw blocks, and of RLE blocks where a block is one byte repeated, which
any zstd decoder reads.
"""

import ctypes
import threading
from typing import Optional

import numpy as np

from ggnn_tpu_torch import native

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
BLOCK = 128 << 10  # the largest block a frame may hold

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The decoder's library, built on first use; raises
    `native.NativeBuildError` with g++'s output when it does not build."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(native.build(native.ZSTD_SOURCE)))
                vp, size = ctypes.c_void_p, ctypes.c_size_t
                lib.zstd_decompress.restype = ctypes.c_int
                lib.zstd_decompress.argtypes = [
                    vp, size, ctypes.POINTER(vp), ctypes.POINTER(size),
                    ctypes.c_char_p, size]
                lib.zstd_free.restype = None
                lib.zstd_free.argtypes = [vp]
                lib.ggnn_crc32c.restype = ctypes.c_uint32
                lib.ggnn_crc32c.argtypes = [ctypes.c_uint32, vp, size]
                _LIB = lib
    return _LIB


class ZstdError(ValueError):
    """The input is not a sequence of zstd frames this decoder reads."""


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in `data`, in order (skippable
    frames skipped; a frame's content checksum verified when present)."""
    data = bytes(data)
    lib = _lib()
    out, out_len = ctypes.c_void_p(), ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    rc = lib.zstd_decompress(data, len(data),
                             ctypes.byref(out), ctypes.byref(out_len), err,
                             len(err))
    if rc != 0:
        raise ZstdError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out.value, out_len.value)
    finally:
        lib.zstd_free(out)


def crc32c(data: bytes) -> int:
    """The crc32c (Castagnoli) of `data`, as OCDBT's files end with."""
    data = bytes(data)
    return _lib().ggnn_crc32c(0, data, len(data))


def _frame_header(size: int) -> bytes:
    """A single-segment frame header that states the content size (the
    window is then the content)."""
    if size < 256:
        return ZSTD_MAGIC + bytes([0x20, size])
    if size < 65536 + 256:
        return ZSTD_MAGIC + bytes([0x60]) + (size - 256).to_bytes(2, "little")
    if size < 1 << 32:
        return ZSTD_MAGIC + bytes([0xA0]) + size.to_bytes(4, "little")
    return ZSTD_MAGIC + bytes([0xE0]) + size.to_bytes(8, "little")


def compress(data) -> bytes:
    """One zstd frame of `data`: raw blocks of up to 128 KiB, and an RLE
    block where a block is one byte repeated. No checksum."""
    view = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    n = view.shape[0]
    parts = [_frame_header(n)]
    starts = range(0, n, BLOCK) if n else [0]
    for start in starts:
        block = view[start:start + BLOCK]
        size = block.shape[0]
        last = 1 if start + BLOCK >= n else 0
        if size > 1 and (block == block[0]).all():
            parts.append(((size << 3) | (1 << 1) | last).to_bytes(3, "little"))
            parts.append(block[:1].tobytes())
        else:
            parts.append(((size << 3) | last).to_bytes(3, "little"))
            parts.append(block.tobytes())
    return b"".join(parts)
