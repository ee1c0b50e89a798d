"""Per-edge dot product of two gathered rows: the hand-written CUDA kernel
(`csrc/edge_dot.cu`), its wrapper, its plain PyTorch version and its
launch counter.

    out[e] = <x[a[e]], y[b[e]]>, and 0 where b[e] lies outside [0, len(y))

A port-only kernel: it replaces no TPU kernel, since the JAX package
computes both of its uses in XLA. Those uses are the sparse GGNN's
propagation attention scores <h[src], h[tgt]> (`ggnn_tpu/ops/messages.py:
56-70`), and the gradient of the attention weights of the weighted
aggregation; `ops/attention.py` holds the autograd Functions of both.
The pads of the packers' lanes point one past the last row of y (target
N, composite id N*T), so they get 0 without a clamp.

x and y are f32 or, under `compute_dtype: bfloat16`, bf16 (the kernel's
bf16 instance); the dots are f32 either way, each the f32 sum of exact
products (the JAX package rounds each product to bf16 first,
`ggnn_tpu/ops/messages.py:68`).

The entry point is the op `torch.ops.ggnn_tpu_torch.edge_dot`
(`_library.register`). A CPU tensor takes the plain version (two
`index_select`s and a sum); a CUDA tensor launches the kernel or raises. `launches` counts the
kernel's launches, `launches_bf16` those of its bf16 instance; a call
with no edge launches nothing.
"""

import ctypes

import torch

from ggnn_tpu_torch.ops.kernels import _build, _library

launches = 0
launches_bf16 = 0


_entries = {}
_ARGTYPES = {
    # (x, a, y, b, out, num_edges, rows_y, hidden, device, stream)
    **{f"edge_dot_{suffix}": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                             + [ctypes.c_void_p]
       for suffix in _library.DTYPES.values()},
    # (x, y, hidden, bf16)
    "edge_dot_vector_elems": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2,
    # (elems, bf16, device, regs)
    "edge_dot_registers": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
}


def _kernel(name: str):
    """The C entry point `name` of csrc/edge_dot.cu, built at first use."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("edge_dot"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check(x, a, y, b):
    if x.dtype not in _library.DTYPES or y.dtype != x.dtype:
        raise TypeError(f"x and y must both be float32 or both bfloat16, "
                        f"got {x.dtype} and {y.dtype}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"a and b must be int32, got {a.dtype} and "
                        f"{b.dtype}")
    if (x.dim() != 2 or y.dim() != 2 or a.dim() != 1 or a.shape != b.shape
            or x.shape[1] != y.shape[1]):
        raise ValueError(
            f"expected x [NX, H], y [NY, H], a and b [E]; got shapes "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(a.shape)}, "
            f"{tuple(b.shape)}")
    if not all(t.is_contiguous() for t in (x, a, y, b)):
        raise ValueError("x, a, y and b must be contiguous")
    if not x.device == a.device == y.device == b.device:
        raise ValueError(f"x, a, y and b lie on different devices: "
                         f"{x.device}, {a.device}, {y.device}, {b.device}")


def edge_dot_reference(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device; bf16 rows
    are widened to f32 first."""
    real = (b >= 0) & (b < y.shape[0])
    if y.shape[0] == 0:
        return torch.zeros(b.shape, dtype=torch.float32, device=b.device)
    rows = torch.where(real, b, 0).long()
    dots = (x.index_select(0, a.long()).float()
            * y.index_select(0, rows).float()).sum(-1)
    return torch.where(real, dots, 0.0)


def _edge_dot_cpu(x, a, y, b):
    _check(x, a, y, b)
    return edge_dot_reference(x, a, y, b)


def _edge_dot_cuda(x, a, y, b):
    global launches, launches_bf16
    _check(x, a, y, b)
    num_edges, h_dim = a.shape[0], x.shape[1]
    if num_edges == 0 or h_dim == 0:
        return torch.zeros(num_edges, dtype=torch.float32, device=x.device)
    out = torch.empty(num_edges, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    entry = f"edge_dot_{_library.DTYPES[x.dtype]}"
    rc = _kernel(entry)(
        x.data_ptr(), a.data_ptr(), y.data_ptr(), b.data_ptr(),
        out.data_ptr(), num_edges, y.shape[0], h_dim, x.device.index,
        stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    launches += 1
    launches_bf16 += x.dtype == torch.bfloat16
    return out


def _edge_dot_fake(x, a, y, b):
    return x.new_empty(a.shape[0], dtype=torch.float32)


_edge_dot = _library.register(
    "edge_dot(Tensor x, Tensor a, Tensor y, Tensor b) -> Tensor",
    _edge_dot_cpu, _edge_dot_cuda, _edge_dot_fake)


def edge_dot(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """out [E] f32 with out[e] = <x[a[e]], y[b[e]]>, 0 where b[e] lies
    outside [0, len(y)). x [NX, H] and y [NY, H] both f32 or both bf16,
    a and b [E] int32;
    a[e] must lie in [0, NX): the kernel does not check it. The op
    `torch.ops.ggnn_tpu_torch.edge_dot`."""
    return _edge_dot(x, a, y, b)


def vector_elems(x: torch.Tensor, y: torch.Tensor) -> int:
    """The values of a row a lane loads at once (f32: 4 or 1; bf16: 8,
    4 or 1) for x and y, by the rule the kernel's launcher applies."""
    return _kernel("edge_dot_vector_elems")(
        x.data_ptr(), y.data_ptr(), x.shape[1], int(x.dtype == torch.bfloat16))


def vectorized(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether the kernel takes a vector path (more than one value a
    lane load) for x and y."""
    return vector_elems(x, y) > 1


def registers(vectorized_path, device=None,
              dtype: torch.dtype = torch.float32) -> int:
    """Registers a thread of the kernel's instance of `dtype` loading the
    values `vectorized_path` gives (True: float4 for f32, 8 bf16 values;
    False: one; for bf16 also 4) uses on the card `device`, as the
    compiler allotted them."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    regs = ctypes.c_int(0)
    rc = _kernel("edge_dot_registers")(
        _library.lane_elems(vectorized_path, dtype),
        int(dtype == torch.bfloat16), index, ctypes.byref(regs))
    if rc != 0:
        raise RuntimeError(f"edge_dot_registers failed: CUDA error {rc}")
    return regs.value
