"""The TF1 GRU cell's gate and update math: four hand-written CUDA kernels
(`csrc/gru.cu`), their wrappers, their plain PyTorch versions, their
launch counters and `FusedGRU`, the autograd Function that joins them to
the cell's products.

With xs = x @ [Wg_x | Wc_x] ([N, 3H]: r, u and candidate columns), a
step of `ops/cells.py:GRUCell` is

    hg = h @ Ug;  g, rh = gru_gates(xs, hg, b_g, h)        K1
    hc = rh @ Uc; c, h' = gru_update(xs, hc, b_c, g, h)    K2

    g = [r | u] = sigmoid((xs[:, :2H] + hg) + b_g),  rh = r * h
    c = act((xs[:, 2H:] + hc) + b_c),                h' = u * h + (1 - u) * c

and its backward

    dxs, dh, partials = gru_update_bwd(dh', g, h, c)       K3
    d(rh) = dxs[:, 2H:] @ Uc^T
    gru_gates_bwd(d(rh), h, g, dxs, dh, partials)           K4
    dh = dh + dxs[:, :2H] @ Ug^T  (one addmm)

where dxs [N, 3H] holds the gradients of the three pre-activations
(da_r, da_u, da_c) and partials [B, 3H] the column sums of dxs over each
of the kernels' B row blocks, whose sum over B is the biases' gradient.
The products stay on `torch.matmul` (f32; TF32 as the caller set it).

A port-only kernel set: the JAX package leaves this math to XLA, which
fuses it into its products (`ggnn_tpu/ops/cells.py:gru_apply`, no Pallas
kernel). Each kernel is an op of the `ggnn_tpu_torch` namespace
(`_library.register`; `torch.ops.ggnn_tpu_torch.gru_gates`,
`gru_update`, `gru_update_bwd`, `gru_gates_bwd`), so an exported program
records the call. A CPU tensor takes the plain version, the same
arithmetic in the same order, which is what `FusedGRU` runs on the CPU;
a CUDA tensor launches the kernel or raises. Rows are f32 on the card
(the configurations' precision); the plain versions take any float
dtype. `launches` counts K1 and K2, `backward_launches` K3 and K4: 2 and
2 a propagation step of a train step. Zero rows launch nothing and count
nothing.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from ggnn_tpu_torch.ops.kernels import _build, _library

launches = 0
backward_launches = 0

# The activations the kernels have (`make_cell` allows these for GRU),
# by the code their entry points take.
ACTIVATIONS = {"tanh": 0, "relu": 1}
_ACT_FNS = {code: getattr(torch, name) for name, code in ACTIVATIONS.items()}

# A block is ROW_THREADS rows of threads by up to COL_THREADS column
# units; a thread walks `rows_per_thread` rows ROW_THREADS apart.
ROW_THREADS = 8
COL_THREADS = 32
MAX_ROWS_PER_THREAD = 16
# Blocks a launch aims for on each SM: 8 blocks of up to 256 threads
# fill an SM's 2,048.
BLOCKS_PER_SM = 8


class Plan(NamedTuple):
    vec: int              # floats a thread loads at once: 4 or 1
    col_threads: int      # blockDim.x
    col_chunks: int       # gridDim.y
    row_blocks: int       # gridDim.x: the partials' rows
    rows_per_thread: int


def rows_per_thread(rows: int, sms: int) -> int:
    """The rows a thread walks: enough blocks for BLOCKS_PER_SM on every
    SM, 1 to MAX_ROWS_PER_THREAD."""
    want = math.ceil(rows / (ROW_THREADS * BLOCKS_PER_SM * max(sms, 1)))
    return min(max(want, 1), MAX_ROWS_PER_THREAD)


def row_blocks(rows: int, sms: int) -> int:
    """The kernels' row blocks for `rows` rows on a card of `sms` SMs; K3
    and K4 of one step share it, whatever their vector widths."""
    return math.ceil(rows / (ROW_THREADS * rows_per_thread(rows, sms)))


def launch_plan(rows: int, hidden: int, vec: int, sms: int) -> Plan:
    """The launch of one kernel over `rows` x `hidden` at `vec` floats a
    load, on a card of `sms` SMs: from the shape alone, so that one design
    serves 100,000 rows and 1,024."""
    width = hidden // vec
    col_threads = min(width, COL_THREADS)
    return Plan(vec, col_threads, math.ceil(width / col_threads),
                row_blocks(rows, sms), rows_per_thread(rows, sms))


def vector_width(hidden: int, *tensors: torch.Tensor) -> int:
    """4 (float4 loads) where H % 4 == 0 and every tensor's data is
    16-byte aligned, else 1: the rule the kernels take."""
    if hidden % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return 4
    return 1


_sms = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    count = _sms.get(index)
    if count is None:
        count = torch.cuda.get_device_properties(index).multi_processor_count
        _sms[index] = count
    return count


_entries = {}
# The plan (vec, col_threads, col_chunks, row_blocks, rows_per_thread),
# the device and the stream, after each entry point's own arguments.
_PLAN_ARGS = [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ROWS = [ctypes.c_int64, ctypes.c_int]   # rows, hidden
_ARGTYPES = {
    # (xs, hg, bias, h, g, rh, rows, hidden, plan...)
    "gru_gates_f32": [ctypes.c_void_p] * 6 + _ROWS + _PLAN_ARGS,
    # (xs, hc, bias, g, h, c, h_new, rows, hidden, act, plan...)
    "gru_update_f32": [ctypes.c_void_p] * 7 + _ROWS + [ctypes.c_int]
                      + _PLAN_ARGS,
    # (dh_new, g, h, c, dxs, dh, partials, rows, hidden, act, plan...)
    "gru_update_bwd_f32": [ctypes.c_void_p] * 7 + _ROWS + [ctypes.c_int]
                          + _PLAN_ARGS,
    # (drh, h, g, dxs, dh, partials, rows, hidden, plan...)
    "gru_gates_bwd_f32": [ctypes.c_void_p] * 6 + _ROWS + _PLAN_ARGS,
}


def _kernel(name: str):
    """The C entry point `name` of csrc/gru.cu, built at first use."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("gru"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _launch(name: str, pointers, rows: int, hidden: int, extra, plan: Plan,
            device: torch.device) -> None:
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _kernel(name)(*pointers, rows, hidden, *extra, plan.vec,
                       plan.col_threads, plan.col_chunks, plan.row_blocks,
                       plan.rows_per_thread, device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _check(name: str, shapes, **tensors) -> None:
    """Every tensor 2-D of its shape in `shapes` (rows N, "H" the hidden
    width), contiguous, of one float dtype and on one device."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if not t.is_floating_point() or t.dtype != first.dtype:
            raise TypeError(f"{name}: {key} must be a float tensor of the "
                            f"others' dtype {first.dtype}, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: {key} lies on {t.device}, not "
                             f"{first.device}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must have shape {shapes[key]}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32 rows, got "
                        f"{t.dtype}")


def activation_code(fn) -> int:
    """The ACTIVATIONS code of the activation function `fn`."""
    for code, known in _ACT_FNS.items():
        if fn is known:
            return code
    raise ValueError(f"GRUCell's kernels have tanh and relu, not {fn!r}")


def _act_code(act: int) -> int:
    if act not in _ACT_FNS:
        raise ValueError(f"unknown GRU activation code {act}: expected one "
                         f"of {sorted(_ACT_FNS)} ({ACTIVATIONS})")
    return act


# ------------------------------------------------------------------ K1

def gates_reference(xs, hg, bias, h):
    """Plain PyTorch version of K1: (g, rh)."""
    hidden = h.shape[1]
    g = torch.sigmoid((xs[:, :2 * hidden] + hg) + bias)
    return g, g[:, :hidden] * h


def _gates_shapes(xs, h):
    n, hidden = h.shape
    return {"xs": (n, 3 * hidden), "hg": (n, 2 * hidden),
            "bias": (2 * hidden,), "h": (n, hidden)}


def _gates_cpu(xs, hg, bias, h):
    _check("gru_gates", _gates_shapes(xs, h), xs=xs, hg=hg, bias=bias, h=h)
    return gates_reference(xs, hg, bias, h)


def _gates_cuda(xs, hg, bias, h):
    global launches
    _check("gru_gates", _gates_shapes(xs, h), xs=xs, hg=hg, bias=bias, h=h)
    _check_f32("gru_gates", xs)
    n, hidden = h.shape
    g = torch.empty_like(hg)
    rh = torch.empty_like(h)
    if n == 0 or hidden == 0:
        return g, rh
    vec = vector_width(hidden, xs, hg, bias, h, g, rh)
    plan = launch_plan(n, hidden, vec, _sm_count(h.device))
    _launch("gru_gates_f32", (xs.data_ptr(), hg.data_ptr(), bias.data_ptr(),
                              h.data_ptr(), g.data_ptr(), rh.data_ptr()),
            n, hidden, (), plan, h.device)
    launches += 1
    return g, rh


def _gates_fake(xs, hg, bias, h):
    return torch.empty_like(hg), torch.empty_like(h)


# ------------------------------------------------------------------ K2

def update_reference(xs, hc, bias, g, h, act):
    """Plain PyTorch version of K2: (c, h')."""
    hidden = h.shape[1]
    c = _ACT_FNS[_act_code(act)]((xs[:, 2 * hidden:] + hc) + bias)
    u = g[:, hidden:]
    return c, u * h + (1.0 - u) * c


def _update_shapes(xs, h):
    n, hidden = h.shape
    return {"xs": (n, 3 * hidden), "hc": (n, hidden), "bias": (hidden,),
            "g": (n, 2 * hidden), "h": (n, hidden)}


def _update_cpu(xs, hc, bias, g, h, act):
    _check("gru_update", _update_shapes(xs, h), xs=xs, hc=hc, bias=bias,
           g=g, h=h)
    return update_reference(xs, hc, bias, g, h, act)


def _update_cuda(xs, hc, bias, g, h, act):
    global launches
    _check("gru_update", _update_shapes(xs, h), xs=xs, hc=hc, bias=bias,
           g=g, h=h)
    _check_f32("gru_update", xs)
    act = _act_code(act)
    n, hidden = h.shape
    c = torch.empty_like(h)
    h_new = torch.empty_like(h)
    if n == 0 or hidden == 0:
        return c, h_new
    vec = vector_width(hidden, xs, hc, bias, g, h, c, h_new)
    plan = launch_plan(n, hidden, vec, _sm_count(h.device))
    _launch("gru_update_f32", (xs.data_ptr(), hc.data_ptr(), bias.data_ptr(),
                               g.data_ptr(), h.data_ptr(), c.data_ptr(),
                               h_new.data_ptr()),
            n, hidden, (act,), plan, h.device)
    launches += 1
    return c, h_new


def _update_fake(xs, hc, bias, g, h, act):
    return torch.empty_like(h), torch.empty_like(h)


# ------------------------------------------------------------------ K3

def _act_backward(grad, c, act):
    """PyTorch's tanh_backward and threshold_backward, from the output."""
    if act == ACTIVATIONS["tanh"]:
        return grad * (1.0 - c * c)
    return torch.where(c <= 0, torch.zeros_like(grad), grad)


def update_bwd_reference(dh_new, g, h, c, act):
    """Plain PyTorch version of K3: (dxs, dh, partials), dxs's r columns
    left for K4 (zero here), partials one row: dxs's column sums, its r
    columns zero."""
    hidden = h.shape[1]
    u = g[:, hidden:]
    du = dh_new * h - dh_new * c
    dxs = torch.zeros(h.shape[0], 3 * hidden, dtype=h.dtype, device=h.device)
    dxs[:, hidden:2 * hidden] = du * (1.0 - u) * u
    dxs[:, 2 * hidden:] = _act_backward(dh_new * (1.0 - u), c, act)
    partials = dxs.sum(0, keepdim=True)
    return dxs, dh_new * u, partials


def _update_bwd_shapes(h):
    n, hidden = h.shape
    return {"dh_new": (n, hidden), "g": (n, 2 * hidden), "h": (n, hidden),
            "c": (n, hidden)}


def _update_bwd_cpu(dh_new, g, h, c, act):
    _check("gru_update_bwd", _update_bwd_shapes(h), dh_new=dh_new, g=g,
           h=h, c=c)
    return update_bwd_reference(dh_new, g, h, c, _act_code(act))


def _update_bwd_cuda(dh_new, g, h, c, act):
    global backward_launches
    _check("gru_update_bwd", _update_bwd_shapes(h), dh_new=dh_new, g=g,
           h=h, c=c)
    _check_f32("gru_update_bwd", h)
    act = _act_code(act)
    n, hidden = h.shape
    dxs = h.new_empty(n, 3 * hidden)
    dh = torch.empty_like(h)
    if n == 0 or hidden == 0:
        return dxs, dh, h.new_zeros(0, 3 * hidden)
    sms = _sm_count(h.device)
    partials = h.new_empty(row_blocks(n, sms), 3 * hidden)
    vec = vector_width(hidden, dh_new, g, h, c, dxs, dh, partials)
    plan = launch_plan(n, hidden, vec, sms)
    _launch("gru_update_bwd_f32", (dh_new.data_ptr(), g.data_ptr(),
                                   h.data_ptr(), c.data_ptr(),
                                   dxs.data_ptr(), dh.data_ptr(),
                                   partials.data_ptr()),
            n, hidden, (act,), plan, h.device)
    backward_launches += 1
    return dxs, dh, partials


def _update_bwd_fake(dh_new, g, h, c, act):
    n, hidden = h.shape
    # The partials' rows depend on the card: an unbacked size.
    rows = torch.library.get_ctx().new_dynamic_size()
    return (h.new_empty(n, 3 * hidden), torch.empty_like(h),
            h.new_empty(rows, 3 * hidden))


# ------------------------------------------------------------------ K4

def gates_bwd_reference(drh, h, g, dxs, dh, partials):
    """Plain PyTorch version of K4, in place: dxs's r columns, dh, and
    partials' r columns (its one row: their column sums)."""
    hidden = h.shape[1]
    r = g[:, :hidden]
    dar = drh * h * (1.0 - r) * r
    dxs[:, :hidden] = dar
    dh.add_(drh * r)
    partials[:, :hidden] = dar.sum(0, keepdim=True)


def _gates_bwd_shapes(h, partials):
    n, hidden = h.shape
    return {"drh": (n, hidden), "h": (n, hidden), "g": (n, 2 * hidden),
            "dxs": (n, 3 * hidden), "dh": (n, hidden),
            "partials": (partials.shape[0], 3 * hidden)}


def _gates_bwd_cpu(drh, h, g, dxs, dh, partials):
    _check("gru_gates_bwd", _gates_bwd_shapes(h, partials), drh=drh, h=h,
           g=g, dxs=dxs, dh=dh, partials=partials)
    gates_bwd_reference(drh, h, g, dxs, dh, partials)


def _gates_bwd_cuda(drh, h, g, dxs, dh, partials):
    global backward_launches
    _check("gru_gates_bwd", _gates_bwd_shapes(h, partials), drh=drh, h=h,
           g=g, dxs=dxs, dh=dh, partials=partials)
    _check_f32("gru_gates_bwd", h)
    n, hidden = h.shape
    if n == 0 or hidden == 0:
        return
    sms = _sm_count(h.device)
    if partials.shape[0] != row_blocks(n, sms):
        raise ValueError(f"gru_gates_bwd: partials has {partials.shape[0]} "
                         f"rows, not the {row_blocks(n, sms)} row blocks "
                         "of gru_update_bwd's launch")
    vec = vector_width(hidden, drh, h, g, dxs, dh, partials)
    plan = launch_plan(n, hidden, vec, sms)
    _launch("gru_gates_bwd_f32", (drh.data_ptr(), h.data_ptr(),
                                  g.data_ptr(), dxs.data_ptr(),
                                  dh.data_ptr(), partials.data_ptr()),
            n, hidden, (), plan, h.device)
    backward_launches += 1


def _gates_bwd_fake(drh, h, g, dxs, dh, partials):
    return None


_gates = _library.register(
    "gru_gates(Tensor xs, Tensor hg, Tensor bias, Tensor h) "
    "-> (Tensor, Tensor)",
    _gates_cpu, _gates_cuda, _gates_fake)
_update = _library.register(
    "gru_update(Tensor xs, Tensor hc, Tensor bias, Tensor g, Tensor h, "
    "int act) -> (Tensor, Tensor)",
    _update_cpu, _update_cuda, _update_fake)
_update_bwd = _library.register(
    "gru_update_bwd(Tensor dh_new, Tensor g, Tensor h, Tensor c, int act) "
    "-> (Tensor, Tensor, Tensor)",
    _update_bwd_cpu, _update_bwd_cuda, _update_bwd_fake)
_gates_bwd = _library.register(
    "gru_gates_bwd(Tensor drh, Tensor h, Tensor g, Tensor(a!) dxs, "
    "Tensor(b!) dh, Tensor(c!) partials) -> ()",
    _gates_bwd_cpu, _gates_bwd_cuda, _gates_bwd_fake)


def gru_gates(xs, hg, bias, h):
    """K1: (g, rh), g = sigmoid((xs[:, :2H] + hg) + bias) [N, 2H] and
    rh = g[:, :H] * h. The op `torch.ops.ggnn_tpu_torch.gru_gates`."""
    return _gates(xs, hg, bias, h)


def gru_update(xs, hc, bias, g, h, act: int):
    """K2: (c, h'), c = act((xs[:, 2H:] + hc) + bias) and
    h' = u * h + (1 - u) * c with u = g[:, H:]; act an ACTIVATIONS code.
    The op `torch.ops.ggnn_tpu_torch.gru_update`."""
    return _update(xs, hc, bias, g, h, act)


def gru_update_bwd(dh_new, g, h, c, act: int):
    """K3: (dxs [N, 3H] with its u and candidate columns, dh = dh' * u,
    partials [B, 3H] with the column sums of those columns). The op
    `torch.ops.ggnn_tpu_torch.gru_update_bwd`."""
    return _update_bwd(dh_new, g, h, c, act)


def gru_gates_bwd(drh, h, g, dxs, dh, partials) -> None:
    """K4, in place: dxs's r columns, dh += drh * r, partials' r columns.
    The op `torch.ops.ggnn_tpu_torch.gru_gates_bwd`."""
    _gates_bwd(drh, h, g, dxs, dh, partials)


# ------------------------------------------------------------- Function

def gru_forward(x, h, gates_kernel, gates_bias, candidate_kernel,
                candidate_bias, act: int):
    """One GRU step over 2-D x [N, D] and h [N, H]: (h', xs-side kernel
    [D, 3H], g, rh, c). The products on `torch.matmul`, the gate and
    update math in K1 and K2."""
    d_in, hidden = x.shape[1], h.shape[1]
    w_x = torch.cat([gates_kernel[:d_in], candidate_kernel[:d_in]], dim=1)
    xs = torch.matmul(x, w_x)
    g, rh = gru_gates(xs, torch.matmul(h, gates_kernel[d_in:]), gates_bias,
                      h)
    c, h_new = gru_update(xs, torch.matmul(rh, candidate_kernel[d_in:]),
                          candidate_bias, g, h, act)
    return h_new, w_x, g, rh, c


class FusedGRU(torch.autograd.Function):
    """A GRU step with the hand-derived backward: K3, the candidate
    product's transpose, K4, then one GEMM for each product's gradient,
    dh's recurrent product added into K3/K4's dh by `addmm`."""

    @staticmethod
    def forward(ctx, x, h, gates_kernel, gates_bias, candidate_kernel,
                candidate_bias, act):
        h_new, w_x, g, rh, c = gru_forward(x, h, gates_kernel, gates_bias,
                                           candidate_kernel, candidate_bias,
                                           act)
        ctx.act = act
        ctx.save_for_backward(x, h, gates_kernel, candidate_kernel, w_x, g,
                              rh, c)
        return h_new

    @staticmethod
    def backward(ctx, dh_new):
        x, h, gates_kernel, candidate_kernel, w_x, g, rh, c = \
            ctx.saved_tensors
        d_in, hidden = x.shape[1], h.shape[1]
        need = ctx.needs_input_grad
        dxs, dh, partials = gru_update_bwd(dh_new.contiguous(), g, h, c,
                                           ctx.act)
        da_c = dxs[:, 2 * hidden:]
        drh = torch.matmul(da_c, candidate_kernel[d_in:].t())
        gru_gates_bwd(drh, h, g, dxs, dh, partials)
        da_g = dxs[:, :2 * hidden]
        dx = torch.matmul(dxs, w_x.t()) if need[0] else None
        if need[1]:
            dh = torch.addmm(dh, da_g, gates_kernel[d_in:].t())
        else:
            dh = None
        d_gk = d_gb = d_ck = d_cb = None
        if need[2] or need[4]:
            d_wx = torch.matmul(x.t(), dxs)
            if need[2]:
                d_gk = torch.cat([d_wx[:, :2 * hidden],
                                  torch.matmul(h.t(), da_g)])
            if need[4]:
                d_ck = torch.cat([d_wx[:, 2 * hidden:],
                                  torch.matmul(rh.t(), da_c)])
        if need[3] or need[5]:
            d_bias = partials.sum(0)
            d_gb = d_bias[:2 * hidden] if need[3] else None
            d_cb = d_bias[2 * hidden:] if need[5] else None
        return dx, dh, d_gk, d_gb, d_ck, d_cb, None


def gru_step(x, h, gates_kernel, gates_bias, candidate_kernel,
             candidate_bias, act: int):
    """h' of a GRU step; x [..., D] and h [..., H] with the same leading
    dims. Through `FusedGRU` where a gradient is wanted, else the forward
    ops alone (which is what a `torch.export` program records)."""
    lead = h.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    h2 = h.reshape(-1, h.shape[-1]).contiguous()
    args = (x2, h2, gates_kernel, gates_bias, candidate_kernel,
            candidate_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        h_new = FusedGRU.apply(*args, act)
    else:
        h_new = gru_forward(*args, act)[0]
    return h_new.reshape(*lead, h.shape[-1])
