"""Gather + segment-sum aggregation and its transpose: the hand-written
CUDA kernels (`csrc/ell_spmm.cu`), their wrappers, their plain PyTorch
versions, their launch counters and the autograd Function that joins
them.

B1 computes a sorted-segment gather-sum,

    out[s, :] = sum over e in [offsets[s], offsets[s+1]) of h[src[e], :]

the function of the Pallas TPU kernel `_agg_kernel`
(`ggnn_tpu/ops/pallas/ell_spmm.py:51`). B2 is its transpose, the same
gather-sum over the edges sorted by source,

    dh[n, :] = sum over e in [boff[n], boff[n+1]) of g[bgather[e], :]

the function of `_scatter_kernel` (`ggnn_tpu/ops/pallas/ell_spmm.py:101`).
Each has two entry points:

  * `gather_segment_sum` / `segment_scatter_sum` — the training and
    serving path's aggregation over the type-combined edge lane
    (ops/messages.py), composite id `target * T + type`;
  * `ell_aggregate_by_type` / `ell_scatter_sum` — the named counterparts
    of `ggnn_tpu.ops.pallas` over the blocked-ELL layouts.

`GatherSegmentSum` is the differentiable aggregation, the counterpart of
`ell_aggregate_by_type.defvjp`: B1 forward, B2 backward.

The weighted instance of the same kernel body,

    out[s, :] = sum over e in [offsets[s], offsets[s+1]) of w[e] * h[src[e], :]

is the edge-list GCN's Â·H over its target-sorted COO list
(`weighted_gather_segment_sum`) and, over the list's source-sorted
transpose, its gradient (`weighted_segment_scatter_sum`);
`WeightedGatherSegmentSum` joins the two. It replaces no TPU kernel: the
JAX GCN computes Â·H with XLA's sorted `segment_sum`
(`ggnn_tpu/models/gcn.py:73-75`). With propagation attention it is also
the sparse GGNN's weighted aggregation, out[s] = sum of a[e] * h[src[e]]
(`ggnn_tpu/ops/messages.py:121-131`, `:178-183`), whose weights get a
gradient through `ops/attention.py:AttentionGatherSegmentSum`.

Each entry point is an op of the `ggnn_tpu_torch` namespace
(`_library.register`; `torch.ops.ggnn_tpu_torch.gather_segment_sum`,
`segment_scatter_sum`, `weighted_gather_segment_sum`,
`weighted_segment_scatter_sum`), so an exported program records the
kernel call. A CPU tensor takes the plain version (`index_select` +
`index_add_`); a CUDA tensor launches the kernel or raises.
`launches` counts B1's kernel
launches, `scatter_launches` B2's, `weighted_launches` and
`weighted_scatter_launches` the weighted instance's forward and
transpose, so a run can show that its path went through the kernels; a
call with an empty output launches nothing and counts nothing. The
counters count the f32 and the bf16 instances alike; `launches_bf16`,
`scatter_launches_bf16`, `weighted_launches_bf16` and
`weighted_scatter_launches_bf16` count the bf16 instances alone.

Rows (and the weighted instance's weights) are f32 or bf16
(`compute_dtype: bfloat16`), the output of the rows' dtype. Sums are
f32 either way: a bf16 output is the f32 sum rounded once, in the
kernel and in the plain version, where the JAX package on the CPU adds
bf16 rows in bf16 (`ggnn_tpu/ops/segment.py:18-23`; see
`tests/test_torch_bf16.py`). The
kernel cuts segments of more than `split_edges()` edges across warps and
hands their partial sums over through scratch (tickets and partial
rows), which the wrapper keeps per device and stream (`_scratch_for`).
"""

import ctypes
from typing import NamedTuple, Optional

import torch

from ggnn_tpu_torch.ops.kernels import _build, _library
from ggnn_tpu_torch.ops.segment import segment_offsets, source_order

launches = 0
scatter_launches = 0
weighted_launches = 0
weighted_scatter_launches = 0
launches_bf16 = 0
scatter_launches_bf16 = 0
weighted_launches_bf16 = 0
weighted_scatter_launches_bf16 = 0

# (x, idx, offsets, out, tickets, partials, num_segments, num_edges,
#  hidden, device, stream)
_UNWEIGHTED = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# (x, idx, weights, offsets, out, tickets, partials, num_segments,
#  num_edges, hidden, device, stream)
_WEIGHTED = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

_entries = {}
_ARGTYPES = {
    **{f"{entry}_{suffix}": argtypes
       for suffix in _library.DTYPES.values()
       for entry, argtypes in (("gather_segment_sum", _UNWEIGHTED),
                               ("segment_scatter_sum", _UNWEIGHTED),
                               ("weighted_gather_segment_sum", _WEIGHTED))},
    # (num_segments, num_edges, hidden, tickets, partials)
    "ell_spmm_scratch": [ctypes.c_int] * 3
                        + [ctypes.POINTER(ctypes.c_int64)] * 2,
    "ell_spmm_split": [],
    # (h, out, hidden, bf16)
    "ell_spmm_vector_elems": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2,
    # (elems, weighted, bf16, device, regs)
    "ell_spmm_registers": [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
    # (device, stream)
    "ell_spmm_empty_launch": [ctypes.c_int, ctypes.c_void_p],
}
# (device index, stream) -> (tickets, partial rows): the kernel's scratch,
# its int32 tickets 0 between calls (the kernel resets those it takes).
_scratch = {}


def _kernel(name: str):
    """The C entry point `name` of csrc/ell_spmm.cu, built at first use."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("ell_spmm"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check(h, src, offsets, num_segments):
    if h.dtype not in _library.DTYPES:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if src.dtype != torch.int32 or offsets.dtype != torch.int32:
        raise TypeError(f"src and offsets must be int32, got {src.dtype} "
                        f"and {offsets.dtype}")
    if h.dim() != 2 or src.dim() != 1 or offsets.dim() != 1:
        raise ValueError(
            f"expected h [N, H], src [E], offsets [S+1]; got shapes "
            f"{tuple(h.shape)}, {tuple(src.shape)}, {tuple(offsets.shape)}")
    if offsets.shape[0] != num_segments + 1:
        raise ValueError(f"offsets has {offsets.shape[0]} entries, "
                         f"expected num_segments + 1 = {num_segments + 1}")
    if not (h.is_contiguous() and src.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("h, src and offsets must be contiguous")
    if not h.device == src.device == offsets.device:
        raise ValueError(f"h, src and offsets lie on different devices: "
                         f"{h.device}, {src.device}, {offsets.device}")


def _check_weights(h, src, weights):
    if weights.dtype != h.dtype:
        raise TypeError(f"weights must have the rows' dtype {h.dtype}, got "
                        f"{weights.dtype}")
    if weights.shape != src.shape:
        raise ValueError(f"weights {tuple(weights.shape)} and src "
                         f"{tuple(src.shape)} must have one entry an edge")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    if weights.device != src.device:
        raise ValueError(f"weights and src lie on different devices: "
                         f"{weights.device}, {src.device}")


def _segment_sum_plain(h: torch.Tensor, src: torch.Tensor, weights,
                       offsets: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Row h[src[e]] (times weights[e]) of each edge added into its
    edge's segment by `index_add_`; edges outside [off[0], off[S]),
    whose ids the kernel never reads, go to a dump row and read row 0.
    bf16 rows and weights are widened to f32, summed in f32 and the sums
    rounded once, as the kernel does."""
    positions = torch.arange(src.shape[0], device=src.device)
    seg = torch.searchsorted(offsets.long(), positions, right=True) - 1
    outside = (seg < 0) | (seg >= num_segments)
    seg = torch.where(outside, num_segments, seg)
    rows = h.index_select(0, torch.where(outside, 0, src.long())).float()
    if weights is not None:
        rows = rows * weights.float()[:, None]
    out = torch.zeros(num_segments + 1, h.shape[1], dtype=torch.float32,
                      device=h.device)
    out.index_add_(0, seg, rows)
    return out[:num_segments].to(h.dtype)


def gather_segment_sum_reference(h: torch.Tensor, src: torch.Tensor,
                                 offsets: torch.Tensor,
                                 num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: each edge's
    segment from the offsets, then `index_select` + `index_add_` in
    int64. Edges outside [off[0], off[S]) go to a dump row."""
    return _segment_sum_plain(h, src, None, offsets, num_segments)


def weighted_gather_segment_sum_reference(h: torch.Tensor,
                                          src: torch.Tensor,
                                          weights: torch.Tensor,
                                          offsets: torch.Tensor,
                                          num_segments: int) -> torch.Tensor:
    """Plain PyTorch version of the weighted instance, on any device:
    `index_select` * weights, then `index_add_` into a dump-slotted
    output."""
    return _segment_sum_plain(h, src, weights, offsets, num_segments)


def _scratch_for(device: torch.device, stream: int, num_tickets: int,
                 num_partials: int):
    """(tickets, partials) for a launch on `stream`: at least
    `num_tickets` int32 tickets, all 0, and `num_partials` f32, kept
    between calls. The kernel leaves its tickets at 0, so they are zeroed
    only when made or grown."""
    key = (device.index, stream)
    tickets, partials = _scratch.get(key, (None, None))
    if tickets is None or tickets.numel() < num_tickets:
        tickets = torch.zeros(num_tickets, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < num_partials:
        partials = torch.empty(num_partials, dtype=torch.float32,
                               device=device)
    _scratch[key] = (tickets, partials)
    return tickets, partials


def _launch(entry: str, h, src, offsets, num_segments, weights=None):
    """(out, launched): one launch of the f32 or bf16 instance (by h's
    dtype) of a kernel of csrc/ell_spmm.cu on a CUDA tensor, none when
    the output is empty; the caller has run `_check` (and
    `_check_weights` for the weighted entry point)."""
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    entry = f"{entry}_{_library.DTYPES[h.dtype]}"
    out = torch.empty(num_segments, h.shape[1], dtype=h.dtype,
                      device=h.device)
    if num_segments == 0 or h.shape[1] == 0:
        return out, False
    num_edges, h_dim = src.shape[0], h.shape[1]
    num_tickets, num_partials = ctypes.c_int64(0), ctypes.c_int64(0)
    if _kernel("ell_spmm_scratch")(num_segments, num_edges, h_dim,
                                   ctypes.byref(num_tickets),
                                   ctypes.byref(num_partials)) != 0:
        raise ValueError(f"{num_segments} segments and {num_edges} edges "
                         "overflow the kernel's int32 warp count")
    stream = torch.cuda.current_stream(h.device).cuda_stream
    tickets, partials = _scratch_for(h.device, stream, num_tickets.value,
                                     num_partials.value)
    inputs = [h, src] + ([] if weights is None else [weights]) + [offsets]
    rc = _kernel(entry)(
        *(x.data_ptr() for x in inputs), out.data_ptr(), tickets.data_ptr(),
        partials.data_ptr(), num_segments, num_edges, h_dim, h.device.index,
        stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out, True


def _register(schema: str, entry: str, counter: str, weighted: bool):
    """The op `schema` over the kernel entry point `entry` of
    csrc/ell_spmm.cu: on a CPU tensor the plain version, on a CUDA one a
    launch (none for an empty output), counted in the module's
    `counter`, and a bf16 launch also in `counter`_bf16."""

    def checked(args):
        """(h, src, weights or None, offsets, num_segments), checked."""
        if not weighted:
            h, src, offsets, num_segments = args
            args = (h, src, None, offsets, num_segments)
        h, src, weights, offsets, num_segments = args
        _check(h, src, offsets, num_segments)
        if weighted:
            _check_weights(h, src, weights)
        return args

    def cpu(*args):
        return _segment_sum_plain(*checked(args))

    def cuda(*args):
        h, src, weights, offsets, num_segments = checked(args)
        out, launched = _launch(entry, h, src, offsets, num_segments,
                                weights)
        globals()[counter] += launched
        if h.dtype == torch.bfloat16:
            globals()[counter + "_bf16"] += launched
        return out

    def fake(h, *rest):
        return h.new_empty(rest[-1], h.shape[1])

    return _library.register(schema, cpu, cuda, fake)


_gather_segment_sum = _register(
    "gather_segment_sum(Tensor h, Tensor src, Tensor offsets, "
    "int num_segments) -> Tensor", "gather_segment_sum", "launches",
    False)
_segment_scatter_sum = _register(
    "segment_scatter_sum(Tensor g, Tensor bgather, Tensor boff, "
    "int num_nodes) -> Tensor", "segment_scatter_sum",
    "scatter_launches", False)
_weighted_gather_segment_sum = _register(
    "weighted_gather_segment_sum(Tensor h, Tensor src, Tensor weights, "
    "Tensor offsets, int num_segments) -> Tensor",
    "weighted_gather_segment_sum", "weighted_launches", True)
_weighted_segment_scatter_sum = _register(
    "weighted_segment_scatter_sum(Tensor g, Tensor bgather, "
    "Tensor bweights, Tensor boff, int num_nodes) -> Tensor",
    "weighted_gather_segment_sum", "weighted_scatter_launches", True)


def gather_segment_sum(h: torch.Tensor, src: torch.Tensor,
                       offsets: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """B1: out [S, H] of h's dtype (f32 or bf16) with out[s] = sum of
    h[src[e]] over the edges of segment s (`offsets` from
    `segment_offsets`), summed in f32. Indices must lie in
    [0, N): the packers guarantee it, and the kernel does not check. The
    op `torch.ops.ggnn_tpu_torch.gather_segment_sum`."""
    return _gather_segment_sum(h, src, offsets, num_segments)


def segment_scatter_sum_reference(g: torch.Tensor, bgather: torch.Tensor,
                                  boff: torch.Tensor,
                                  num_nodes: int) -> torch.Tensor:
    """Plain PyTorch version of B2 on any device: the sorted-segment
    gather-sum of B1's plain version, over the source-sorted edges."""
    return gather_segment_sum_reference(g, bgather, boff, num_nodes)


def segment_scatter_sum(g: torch.Tensor, bgather: torch.Tensor,
                        boff: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """B2: dh [N, H] of g's dtype with dh[n] = sum of g[bgather[e]] over the
    edges e of source n, `bgather` the edges' forward composite ids in
    source order and `boff` [N+1] their CSR offsets over sources (see
    `transpose_layout`). Indices must lie in [0, len(g)): pads must be
    dropped before, and the kernel does not check. The op
    `torch.ops.ggnn_tpu_torch.segment_scatter_sum`."""
    return _segment_scatter_sum(g, bgather, boff, num_nodes)


def weighted_gather_segment_sum(h: torch.Tensor, src: torch.Tensor,
                                weights: torch.Tensor, offsets: torch.Tensor,
                                num_segments: int) -> torch.Tensor:
    """The weighted instance: out [S, H] of h's dtype with out[s] = sum
    of weights[e] * h[src[e]] (weights of h's dtype) over the edges of
    segment s (`offsets` from
    `segment_offsets`), the GCN's Â·H over its target-sorted COO list.
    Indices must lie in [0, N): the packers guarantee it, and the kernel
    does not check. The op
    `torch.ops.ggnn_tpu_torch.weighted_gather_segment_sum`."""
    return _weighted_gather_segment_sum(h, src, weights, offsets,
                                        num_segments)


def weighted_segment_scatter_sum(g: torch.Tensor, bgather: torch.Tensor,
                                 bweights: torch.Tensor, boff: torch.Tensor,
                                 num_nodes: int) -> torch.Tensor:
    """The weighted instance over a source-sorted transpose (see
    `weighted_transpose_layout`): dh [N, H] of g's dtype with dh[n] = sum of
    bweights[e] * g[bgather[e]] over the out-edges e of n, the gradient
    of `weighted_gather_segment_sum`. Counted apart from the forward. The
    op `torch.ops.ggnn_tpu_torch.weighted_segment_scatter_sum`."""
    return _weighted_segment_scatter_sum(g, bgather, bweights, boff,
                                         num_nodes)


def split_edges() -> int:
    """The most edges of a segment that the kernel does not cut, and the
    edges of each further piece of a cut one: a constant of
    csrc/ell_spmm.cu."""
    return _kernel("ell_spmm_split")()


def vector_elems(h: torch.Tensor, out: torch.Tensor) -> int:
    """The values of a row a lane loads at once (1, 4 or 8) for rows h
    and the output `out`, by the rule the kernel's launcher applies."""
    return _kernel("ell_spmm_vector_elems")(
        h.data_ptr(), out.data_ptr(), h.shape[1],
        int(h.dtype == torch.bfloat16))


def registers(vectorized_path, device=None, weighted: bool = False,
              dtype: torch.dtype = torch.float32) -> int:
    """Registers a thread of the kernel's instance of `dtype` (f32 or
    bf16) loading the values `vectorized_path` gives (True: float4 for
    f32, 8 bf16 values; False: one; for bf16 also 4), of B1 and B2 or
    `weighted`, uses on the card `device`, as the compiler allotted them;
    B1 and B2 share their instances."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    regs = ctypes.c_int(0)
    rc = _kernel("ell_spmm_registers")(
        _library.lane_elems(vectorized_path, dtype), int(weighted),
        int(dtype == torch.bfloat16), index, ctypes.byref(regs))
    if rc != 0:
        raise RuntimeError(f"ell_spmm_registers failed: CUDA error {rc}")
    return regs.value


def empty_launch(device=None) -> None:
    """Launch an empty kernel through the path every kernel of
    csrc/ell_spmm.cu takes, on the current stream of the card `device`:
    timed, the launch floor that each kernel's time includes. Counted
    nowhere."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    rc = _kernel("ell_spmm_empty_launch")(index, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm_empty_launch failed: CUDA error {rc}")


class SortedEdges(NamedTuple):
    """Edges stably sorted by a key, for a weighted launch over them:
    `perm` (int64; None when the edges are already in key order), `ids`
    [E] int32 the rows the sorted edges read, and `offsets` [K + 1]
    int32 their CSR offsets over the keys. Edges whose key is K (pads)
    sort past offsets[K] and are never read; a launch takes its weights
    as `w[perm]`."""
    perm: Optional[torch.Tensor]
    ids: torch.Tensor
    offsets: torch.Tensor


def transpose_layout(sources: torch.Tensor, gather_ids: torch.Tensor,
                     num_nodes: int):
    """(bgather, boff) for B2 from the REAL edges of an aggregation:
    `sources` [E] their source nodes, `gather_ids` [E] the rows of the
    aggregation's output they feed."""
    perm, boff = source_order(sources, num_nodes)
    return gather_ids[perm].to(torch.int32).contiguous(), boff


def weighted_transpose_layout(sources: torch.Tensor,
                              gather_ids: torch.Tensor,
                              weights: torch.Tensor, num_nodes: int):
    """(bgather, bweights, boff) for `weighted_segment_scatter_sum`: as
    `transpose_layout`, with the edges' weights permuted by the same
    stable sort. Edges with source `num_nodes` (pads) sort past boff[N]
    and are never read."""
    perm, boff = source_order(sources, num_nodes)
    return (gather_ids[perm].to(torch.int32).contiguous(),
            weights[perm].contiguous(), boff)


class GatherSegmentSum(torch.autograd.Function):
    """The differentiable aggregation: B1 forward, B2 backward.

    `apply(h, src, offsets, num_segments, bgather, boff)`; the index
    tensors are not differentiable, and (bgather, boff) is the transpose
    layout of `transpose_layout`, or None where no gradient will be
    asked for."""

    @staticmethod
    def forward(ctx, h, src, offsets, num_segments, bgather, boff):
        ctx.num_nodes = h.shape[0]
        ctx.save_for_backward(bgather, boff)
        ctx.has_transpose = bgather is not None
        return gather_segment_sum(h, src, offsets, num_segments)

    @staticmethod
    def backward(ctx, dper):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        if not ctx.has_transpose:
            raise RuntimeError(
                "the aggregation's gradient needs its transpose layout "
                "(bgather, boff); none was given to the forward")
        bgather, boff = ctx.saved_tensors
        dh = segment_scatter_sum(dper.contiguous(), bgather, boff,
                                 ctx.num_nodes)
        return dh, None, None, None, None, None


class WeightedGatherSegmentSum(torch.autograd.Function):
    """The GCN's differentiable Â·H: the weighted instance over the
    target-sorted edges forward, the weighted instance over their
    source-sorted transpose backward.

    `apply(h, src, weights, offsets, num_segments, bgather, bweights,
    boff)`; the weights and indices are data and get no gradient, and
    (bgather, bweights, boff) is `weighted_transpose_layout` of the
    edges, or None where no gradient will be asked for. The transpose is
    the real one: Â need not be symmetric."""

    @staticmethod
    def forward(ctx, h, src, weights, offsets, num_segments, bgather,
                bweights, boff):
        ctx.num_nodes = h.shape[0]
        ctx.save_for_backward(bgather, bweights, boff)
        ctx.has_transpose = bgather is not None
        return weighted_gather_segment_sum(h, src, weights, offsets,
                                           num_segments)

    @staticmethod
    def backward(ctx, dout):
        if not ctx.needs_input_grad[0]:
            return (None,) * 8
        if not ctx.has_transpose:
            raise RuntimeError(
                "the weighted aggregation's gradient needs its transpose "
                "layout (bgather, bweights, boff); none was given to the "
                "forward")
        bgather, bweights, boff = ctx.saved_tensors
        dh = weighted_segment_scatter_sum(dout.contiguous(), bgather,
                                          bweights, boff, ctx.num_nodes)
        return (dh,) + (None,) * 7


def ell_aggregate_by_type_reference(h: torch.Tensor, fwd_src: torch.Tensor,
                                    fwd_tgt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `ell_aggregate_by_type` on any device:
    gather every slot's source row and `index_add_` it into row
    t * NP + tgt, with the padded slots (tgt == NP) sent to a dump row."""
    t_dim = fwd_src.shape[0]
    np_total, h_dim = h.shape
    tgt = fwd_tgt.reshape(t_dim, -1).long()
    types = torch.arange(t_dim, device=h.device).unsqueeze(1)
    seg = torch.where(tgt < np_total, types * np_total + tgt,
                      t_dim * np_total).reshape(-1)
    out = torch.zeros(t_dim * np_total + 1, h_dim, dtype=torch.float32,
                      device=h.device)
    out.index_add_(0, seg,
                   h.index_select(0, fwd_src.reshape(-1).long()).float())
    return out[:-1].view(t_dim, np_total, h_dim).to(h.dtype)


def _check_ell(name, a, b):
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"{name} must share a [T, NB, KE] shape; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"{name} must be int32")


def _real_slots(keys: torch.Tensor, others: torch.Tensor, np_total: int):
    """(key, other, type) of the real slots of a [T, NB, KE] ELL layout
    whose pads sit at key NP, flattened in slot order. The pads are
    dropped before any offsetting: t*NP + NP would collide with type
    t+1's first row."""
    t_dim = keys.shape[0]
    flat = keys.reshape(t_dim, -1).long()
    real = flat < np_total
    types = torch.arange(t_dim, device=keys.device).unsqueeze(1)
    return (flat[real], others.reshape(t_dim, -1).long()[real],
            types.expand_as(flat)[real])


def ell_transpose_layout(bwd_tgt: torch.Tensor, bwd_src: torch.Tensor,
                         np_total: int):
    """(bgather, boff) of B2 from the source-block-major ELL backward
    layout (`data/ell.py:build_ell_layout`): composite gather ids
    t * NP + tgt of the real slots, stably sorted by source across
    types, and CSR offsets over the NP sources."""
    _check_ell("bwd_tgt and bwd_src", bwd_tgt, bwd_src)
    sources, targets, types = _real_slots(bwd_src, bwd_tgt, np_total)
    return transpose_layout(sources, types * np_total + targets, np_total)


def ell_scatter_sum_reference(g: torch.Tensor, bwd_tgt: torch.Tensor,
                              bwd_src: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `ell_scatter_sum` on any device, straight
    from the ELL arrays: gather every slot's row g[t, bwd_tgt] and
    `index_add_` it into row bwd_src, the pads (bwd_src == NP) sent to
    a dump row."""
    t_dim, np_total, h_dim = g.shape
    types = torch.arange(t_dim, device=g.device).view(t_dim, 1, 1)
    rows = (types * np_total + bwd_tgt.long()).reshape(-1)
    dh = torch.zeros(np_total + 1, h_dim, dtype=torch.float32,
                     device=g.device)
    dh.index_add_(0, bwd_src.reshape(-1).long(),
                  g.reshape(t_dim * np_total, h_dim).index_select(
                      0, rows).float())
    return dh[:np_total].to(g.dtype)


def ell_scatter_sum(g: torch.Tensor, bwd_tgt: torch.Tensor,
                    bwd_src: torch.Tensor) -> torch.Tensor:
    """The transpose of `ell_aggregate_by_type`: dh [NP, H] with
    dh[n] = sum of g[t, bwd_tgt[t, nb, k]] over the slots with
    bwd_src[t, nb, k] == n, the counterpart of
    `ggnn_tpu.ops.pallas.ell_scatter_sum`. g [T, NP, H] f32. One B2
    launch: the pads are dropped and the types merged in source order."""
    t_dim, np_total, h_dim = g.shape
    bgather, boff = ell_transpose_layout(bwd_tgt, bwd_src, np_total)
    return segment_scatter_sum(g.reshape(t_dim * np_total, h_dim),
                               bgather, boff, np_total)


def ell_aggregate_by_type(h: torch.Tensor, fwd_src: torch.Tensor,
                          fwd_tgt: torch.Tensor,
                          bwd_tgt: torch.Tensor = None,
                          bwd_src: torch.Tensor = None) -> torch.Tensor:
    """Per-type aggregation out[t, n] = sum of h[source] over the edges of
    type t with target n, over the target-block-major ELL forward layout
    (`data/ell.py:build_ell_layout`). h [NP, H] f32; fwd_src and fwd_tgt
    [T, NB, KE] int32 with padded slots at tgt == NP. Returns
    [T, NP, H] f32.

    Within a block the slots are target-sorted and the blocks ascend, so
    once the padded slots are dropped each type's targets are sorted and
    `t * NP + tgt` is a sorted segment id for B1. Differentiable in h
    through B2 over the source-block-major backward layout (bwd_tgt,
    bwd_src), which must be given when h needs a gradient."""
    _check_ell("fwd_src and fwd_tgt", fwd_src, fwd_tgt)
    t_dim = fwd_src.shape[0]
    np_total = h.shape[0]
    targets, sources, types = _real_slots(fwd_tgt, fwd_src, np_total)
    num_segments = t_dim * np_total
    src = sources.to(torch.int32)
    offsets = segment_offsets(types * np_total + targets, num_segments)
    bgather = boff = None
    if torch.is_grad_enabled() and h.requires_grad:
        if bwd_tgt is None or bwd_src is None:
            raise ValueError(
                "ell_aggregate_by_type needs the backward layout "
                "(bwd_tgt, bwd_src) when h requires a gradient")
        bgather, boff = ell_transpose_layout(bwd_tgt, bwd_src, np_total)
    out = GatherSegmentSum.apply(h, src, offsets, num_segments, bgather,
                                 boff)
    return out.view(t_dim, np_total, h.shape[1])
