"""Row gather, the gather-floor probe's kernel: the hand-written CUDA
kernel (`csrc/gather_floor.cu`), its wrapper, its plain PyTorch version
and its launch counter.

B3 computes

    out[nb, k, :] = h[src[nb, k], :]

the function of the Pallas TPU kernel `_gather_kernel`
(`benchmarks/probes/gather_floor.py:52`), with the row loads unrolled 1,
4 or 8 times and the stores plain or streaming (`__stcs`, evict-first).
It is a pure copy, so the kernel equals its plain version bit for bit.
Rows are f32 or, on the per-edge route under `compute_dtype: bfloat16`,
bf16 (the kernel's bf16 instance); the probe runs f32.
The gather-floor probe (`ggnn_tpu_torch/probes/gather_floor.py`) calls it
at every unroll, and the sparse GGNN's per-edge route
(`aggregate_first: false`) gathers its source rows with it through
`GatherRows`, whose backward is B2 (`ell_spmm.segment_scatter_sum`).

The entry point is the op `torch.ops.ggnn_tpu_torch.gather_rows`
(`_library.register`). A CPU tensor takes the plain version
(`index_select`); a CUDA tensor launches the kernel or raises. `launches` counts the kernel's launches, `launches_bf16` those of its bf16
instance.
"""

import ctypes

import torch

from ggnn_tpu_torch.ops.kernels import _build, _library, ell_spmm

UNROLLS = (1, 4, 8)

launches = 0
launches_bf16 = 0


_entries = {}
_ARGTYPES = {
    # (h, src, out, num_rows, hidden, unroll, streaming, device, stream)
    **{f"gather_rows_{suffix}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                + [ctypes.c_void_p]
       for suffix in _library.DTYPES.values()},
    # (h, out, hidden, bf16)
    "gather_rows_vector_elems": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2,
    # (elems, unroll, streaming, bf16, device, regs)
    "gather_rows_registers": [ctypes.c_int] * 5
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
    if h.dtype not in _library.DTYPES:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
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


def _gather_rows_cpu(h, src, unroll, streaming):
    _check(h, src, unroll)
    return gather_rows_reference(h, src)


def _gather_rows_cuda(h, src, unroll, streaming):
    global launches, launches_bf16
    _check(h, src, unroll)
    nb, ke = src.shape
    out = torch.empty(nb, ke, h.shape[1], dtype=h.dtype, device=h.device)
    if nb * ke == 0 or h.shape[1] == 0:
        return out
    stream = torch.cuda.current_stream(h.device).cuda_stream
    entry = f"gather_rows_{_library.DTYPES[h.dtype]}"
    rc = _kernel(entry)(
        h.data_ptr(), src.data_ptr(), out.data_ptr(), nb * ke, h.shape[1],
        unroll, int(streaming), h.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_bf16 += h.dtype == torch.bfloat16
    return out


def _gather_rows_fake(h, src, unroll, streaming):
    return h.new_empty(src.shape[0], src.shape[1], h.shape[1])


_gather_rows = _library.register(
    "gather_rows(Tensor h, Tensor src, int unroll, bool streaming) -> "
    "Tensor", _gather_rows_cpu, _gather_rows_cuda, _gather_rows_fake)


def gather_rows(h: torch.Tensor, src: torch.Tensor, unroll: int,
                streaming: bool = False) -> torch.Tensor:
    """B3: out [NB, KE, H] of h's dtype with out[nb, k] = h[src[nb, k]],
    the kernel issuing `unroll` row loads before it stores them, with
    streaming (evict-first) stores if `streaming`. h [NP, H] f32 or bf16,
    src [NB, KE]
    int32, KE a multiple of `unroll`. Ids must lie in [0, NP): the
    kernel does not check. The op `torch.ops.ggnn_tpu_torch.gather_rows`."""
    return _gather_rows(h, src, unroll, streaming)


def vector_elems(h: torch.Tensor, out: torch.Tensor) -> int:
    """The values of a row a lane copies at once (f32: 4 or 1; bf16: 8,
    4 or 1) for h and its output `out`, by the rule the kernel's
    launcher applies."""
    return _kernel("gather_rows_vector_elems")(
        h.data_ptr(), out.data_ptr(), h.shape[1],
        int(h.dtype == torch.bfloat16))


def vectorized(h: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether the kernel takes a vector path (more than one value a
    lane) for h and its output `out`."""
    return vector_elems(h, out) > 1


def registers(unroll: int, vectorized_path, streaming: bool = False,
              device=None, dtype: torch.dtype = torch.float32) -> int:
    """Registers a thread of the kernel's (vectorized_path, unroll,
    streaming) instance of `dtype` uses on the card `device`, as the
    compiler allotted them; `vectorized_path` True is float4 for f32 and
    8 values for bf16, False one, and for bf16 also 4."""
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    regs = ctypes.c_int(0)
    rc = _kernel("gather_rows_registers")(
        _library.lane_elems(vectorized_path, dtype), unroll,
        int(streaming), int(dtype == torch.bfloat16), index,
        ctypes.byref(regs))
    if rc != 0:
        raise RuntimeError(f"gather_rows_registers failed: CUDA error {rc}")
    return regs.value


def widest_unroll(ke: int) -> int:
    """The largest unroll of 8, 4 and 1 that divides KE."""
    return next(u for u in sorted(UNROLLS, reverse=True) if ke % u == 0)


class GatherRows(torch.autograd.Function):
    """The differentiable row gather of the per-edge route: B3 forward,
    out [T, E, H] with out[t, e] = h[src[t, e]] at the widest unroll that
    divides E; backward B2 over the transpose, dh[n] = sum of the rows
    g[t, e] of the real edges with source n.

    `apply(h, src, bgather, boff)`: (bgather, boff) are
    `ell_spmm.transpose_layout` of the edges' flat positions t*E + e
    keyed by source, the pads keyed past the last node, or None where
    no gradient will be asked for."""

    @staticmethod
    def forward(ctx, h, src, bgather, boff):
        ctx.num_nodes = h.shape[0]
        ctx.save_for_backward(bgather, boff)
        ctx.has_transpose = bgather is not None
        return gather_rows(h, src, widest_unroll(src.shape[1]))

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if not ctx.has_transpose:
            raise RuntimeError(
                "the row gather's gradient needs its transpose layout "
                "(bgather, boff); none was given to the forward")
        bgather, boff = ctx.saved_tensors
        dh = ell_spmm.segment_scatter_sum(
            g.reshape(-1, g.shape[-1]).contiguous(), bgather, boff,
            ctx.num_nodes)
        return dh, None, None, None
