"""Row gather, the gather-floor probe's kernel: the hand-written CUDA
kernel (`csrc/gather_floor.cu`), its wrapper, its plain PyTorch version
and its launch counter.

B3 computes

    out[nb, k, :] = h[src[nb, k], :]

the function of the Pallas TPU kernel `_gather_kernel`
(`benchmarks/probes/gather_floor.py:52`), with the row loads unrolled 1,
4 or 8 times and the stores plain or streaming (`__stcs`, evict-first).
It is a pure copy, so the kernel equals its plain version bit for bit.
Only the probe (`ggnn_tpu_torch/probes/gather_floor.py`)
calls it; the serving and training paths do not.

A CPU tensor takes the plain version (`index_select`); a CUDA tensor
launches the kernel or raises. `launches` counts the kernel's launches.
"""

import ctypes

import torch

from ggnn_tpu_torch.ops.kernels import _build

UNROLLS = (1, 4, 8)

launches = 0

_entries = {}
_ARGTYPES = {
    # (h, src, out, num_rows, hidden, unroll, streaming, device, stream)
    "gather_rows_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p],
    # (h, out, hidden)
    "gather_rows_vectorized": [ctypes.c_void_p] * 2 + [ctypes.c_int],
    # (vectorized_path, unroll, streaming, device, regs)
    "gather_rows_registers": [ctypes.c_int] * 4
                             + [ctypes.POINTER(ctypes.c_int)],
}


def _kernel(name: str):
    """The C entry point `name` of csrc/gather_floor.cu, built at first
    use."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("gather_floor"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check(h, src, unroll):
    if h.dtype != torch.float32:
        raise TypeError(f"h must be float32, got {h.dtype}")
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    if h.dim() != 2 or src.dim() != 2:
        raise ValueError(f"expected h [NP, H] and src [NB, KE]; got shapes "
                         f"{tuple(h.shape)} and {tuple(src.shape)}")
    if not (h.is_contiguous() and src.is_contiguous()):
        raise ValueError("h and src must be contiguous")
    if h.device != src.device:
        raise ValueError(f"h and src lie on different devices: {h.device}, "
                         f"{src.device}")
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    if src.shape[1] % unroll != 0:
        raise ValueError(f"KE = {src.shape[1]} is not a multiple of unroll "
                         f"= {unroll}")


def gather_rows_reference(h: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    nb, ke = src.shape
    return h.index_select(0, src.reshape(-1)).view(nb, ke, h.shape[1])


def gather_rows(h: torch.Tensor, src: torch.Tensor, unroll: int,
                streaming: bool = False) -> torch.Tensor:
    """B3: out [NB, KE, H] f32 with out[nb, k] = h[src[nb, k]], the kernel
    issuing `unroll` row loads before it stores them, with streaming
    (evict-first) stores if `streaming`. h [NP, H] f32, src [NB, KE]
    int32, KE a multiple of `unroll`. Ids must lie in [0, NP): the
    kernel does not check."""
    global launches
    _check(h, src, unroll)
    nb, ke = src.shape
    if nb * ke == 0 or h.shape[1] == 0:
        return torch.empty(nb, ke, h.shape[1], dtype=torch.float32,
                           device=h.device)
    if h.device.type == "cpu":
        return gather_rows_reference(h, src)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    out = torch.empty(nb, ke, h.shape[1], dtype=torch.float32,
                      device=h.device)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    rc = _kernel("gather_rows_f32")(
        h.data_ptr(), src.data_ptr(), out.data_ptr(), nb * ke, h.shape[1],
        unroll, int(streaming), h.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows_f32 kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def vectorized(h: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel takes its float4 path for h and its output
    `out`, by the rule the kernel's launcher applies."""
    return bool(_kernel("gather_rows_vectorized")(
        h.data_ptr(), out.data_ptr(), h.shape[1]))


def registers(unroll: int, vectorized_path: bool, streaming: bool = False,
              device=None) -> int:
    """Registers a thread of the kernel's (vectorized_path, unroll,
    streaming) instance uses on the card `device`, as the compiler
    allotted them."""
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    regs = ctypes.c_int(0)
    rc = _kernel("gather_rows_registers")(int(vectorized_path), unroll,
                                          int(streaming), index,
                                          ctypes.byref(regs))
    if rc != 0:
        raise RuntimeError(f"gather_rows_registers failed: CUDA error {rc}")
    return regs.value
