"""Segment reductions over padded node and edge arrays.

Padded rows follow the GraphBatch convention: their segment id points at
a dump slot one past the real capacity, so reductions allocate
`num_segments = capacity + 1` and the caller slices the dump row off.
The readout's graph pooling uses `segment_sum`; propagation attention
uses `segment_softmax`; a gather from a small table whose gradient is a
sum (the attention's type factors, the async model's buffers) uses
`sorted_gather`; the message aggregation has its own kernels
(ops/kernels/ell_spmm.py).

Every sum here runs `torch.segment_reduce` over the ids in sorted order
(CSR offsets), never `index_add_`: on the card `index_add_` (and the
backward of `index_select`, which is one) adds with atomics in an order
that changes from call to call, while a sorted reduction adds each
segment in a fixed order, so two calls give the same bits. Ids that are
not sorted are sorted once by a stable `argsort` (`sorted_segments`),
which a forward makes once and reuses for every step; the permuted data
is read by `index_select`, and the gradients of these sums are gathers
(`SortedSegmentSum`, `SortedGather`), so no backward adds with atomics
either. `segment_offsets` and `source_order` make those CSR layouts for
the segment sums here and for the kernels' wrappers.
"""

from typing import NamedTuple, Optional

import torch

F32_MIN = torch.finfo(torch.float32).min


def segment_offsets(segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """CSR offsets [num_segments + 1] int32 of a SORTED segment-id
    vector: segment s owns positions [off[s], off[s+1]). Ids at or past
    `num_segments` (dump-slot padding) lie past off[num_segments]."""
    bounds = torch.arange(num_segments + 1, device=segment_ids.device,
                          dtype=segment_ids.dtype)
    return torch.searchsorted(segment_ids, bounds).to(torch.int32)


def source_order(sources: torch.Tensor, num_nodes: int):
    """(perm, boff): the stable sort of the edges by source, which keeps
    each source's edges in their forward order, and the CSR offsets over
    the sources. An edge whose source is num_nodes sorts past boff[N]."""
    perm = torch.argsort(sources, stable=True)
    return perm, segment_offsets(sources[perm], num_nodes)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = max of the 1-D data[i] over segment_ids[i] == s, -inf for
    an empty segment (as `jax.ops.segment_max`). A maximum does not
    depend on the order it is taken in, so the result is the same from
    call to call on any device."""
    out = torch.full((num_segments,), -torch.inf, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, segment_ids.long(), data, "amax",
                              include_self=True)


class SortedSegments(NamedTuple):
    """A stable sort of 1-D segment ids and the CSR offsets of the sorted
    ids: `perm` (int64, None when the ids are already sorted) and
    `offsets` [num_segments + 1] int32, segment s owning the sorted
    positions [offsets[s], offsets[s+1])."""
    perm: Optional[torch.Tensor]
    offsets: torch.Tensor


def sorted_segments(segment_ids: torch.Tensor, num_segments: int,
                    indices_are_sorted: bool = False) -> SortedSegments:
    """The `SortedSegments` of `segment_ids` (every id in
    [0, num_segments)). Index preparation: make it once, reuse it."""
    ids = segment_ids.long()
    if indices_are_sorted:
        return SortedSegments(None, segment_offsets(ids, num_segments))
    return SortedSegments(*source_order(ids, num_segments))


def sorted_segment_sum(data: torch.Tensor,
                       layout: SortedSegments) -> torch.Tensor:
    """out[s] = sum of `data`'s rows over segment s of `layout`, in the
    fixed order of the sorted ids (no gradient; `segment_sum` has one).
    A bf16 input is summed in f32 and rounded once."""
    if layout.perm is not None:
        data = data.index_select(0, layout.perm)
    out = torch.segment_reduce(
        data.float() if data.dtype == torch.bfloat16 else data, "sum",
        offsets=layout.offsets, unsafe=True)
    return out.to(data.dtype)


class SortedSegmentSum(torch.autograd.Function):
    """`apply(data, segment_ids, layout)`: `sorted_segment_sum` with its
    gradient, each row's the gradient of its segment (a gather)."""

    @staticmethod
    def forward(ctx, data, segment_ids, layout):
        ctx.save_for_backward(segment_ids)
        return sorted_segment_sum(data, layout)

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        return g.index_select(0, ids.long()), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                indices_are_sorted: bool = False) -> torch.Tensor:
    """out[s] = sum of data[i] over segment_ids[i] == s, every id in
    [0, num_segments); the result is [num_segments, ...], each segment
    summed in the fixed order of the sorted ids."""
    layout = sorted_segments(segment_ids, num_segments, indices_are_sorted)
    return SortedSegmentSum.apply(data, segment_ids, layout)


class SortedGather(torch.autograd.Function):
    """`apply(table, ids, layout)`: `table.index_select(0, ids)`, whose
    gradient sums each row's cotangents over `layout` (`sorted_segments
    (ids, table rows)`) in a fixed order, where `index_select`'s own
    backward adds them with `index_add_`."""

    @staticmethod
    def forward(ctx, table, ids, layout):
        ctx.layout = layout
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        return sorted_segment_sum(g, ctx.layout), None, None


def sorted_gather(table: torch.Tensor, ids: torch.Tensor,
                  layout: Optional[SortedSegments] = None) -> torch.Tensor:
    """`table.index_select(0, ids)` with a gradient summed in a fixed
    order; `layout` (`sorted_segments(ids, table.shape[0])`) is made here
    when not given, and only when a gradient is to be taken. Every id
    must lie in [0, table.shape[0])."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table.index_select(0, ids)
    if layout is None:
        layout = sorted_segments(ids, table.shape[0])
    return SortedGather.apply(table, ids, layout)


class SegmentSoftmax(torch.autograd.Function):
    """`apply(scores, segment_ids, mask, layout, epsilon, axis)`: the
    softmax of `segment_softmax`, its gradient in closed form. With the
    shift detached, a_e = x_e / (S_seg + eps), x_e = exp(s_e - max) *
    mask_e, S_seg the sum of x over e's segment, so
        ds_e = a_e * (g_e - sum over e's segment of a * g),
    masked lanes included (their a_e is 0). Over a mesh `axis` each rank
    holds some of a segment's lanes: the max and S_seg are taken over
    the axis, and so is the backward's segment sum of a * g, since every
    rank's lanes share S_seg."""

    @staticmethod
    def forward(ctx, scores, segment_ids, mask, layout, epsilon, axis):
        ids = segment_ids.long()
        num_segments = layout.offsets.shape[0] - 1
        masked = torch.where(mask > 0, scores, F32_MIN)
        seg_max = segment_max(masked, ids, num_segments)
        if axis is not None:
            seg_max = axis.all_reduce(seg_max, "max")
        # Segments with no real lane come back as -inf or F32_MIN: clamped.
        seg_max = seg_max.clamp_min(F32_MIN / 2)
        exped = torch.exp(masked - seg_max[ids]) * mask
        seg_sum = sorted_segment_sum(exped, layout)
        if axis is not None:
            seg_sum = axis.all_reduce(seg_sum)
        attention = exped / (seg_sum[ids] + epsilon)
        ctx.layout, ctx.axis = layout, axis
        ctx.save_for_backward(attention, ids)
        return attention

    @staticmethod
    def backward(ctx, g):
        attention, ids = ctx.saved_tensors
        ag = attention * g
        total = sorted_segment_sum(ag, ctx.layout)
        if ctx.axis is not None:
            total = ctx.axis.all_reduce(total)
        return ag - attention * total[ids], None, None, None, None, None


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: torch.Tensor, epsilon: float,
                    indices_are_sorted: bool = False,
                    layout: Optional[SortedSegments] = None,
                    axis_name=None) -> torch.Tensor:
    """Softmax over ragged incoming-message groups, max-shifted, the
    counterpart of `ggnn_tpu.ops.segment.segment_softmax`
    (chem_tensorflow_sparse.py:177-194): per-segment max shift, exp,
    per-segment sum, normalise with `epsilon` in the denominator. `mask`
    (1.0 = real lane) keeps padded lanes out of both reductions: masked
    lanes take the f32 minimum into the max and 0 into the sum. The max
    is detached (JAX's stop_gradient) and clamped at half the f32
    minimum. 1-D scores; `layout` is `sorted_segments(segment_ids,
    num_segments, indices_are_sorted)`, made here when not given.

    `axis_name` (a mesh `Axis`, parallel/mesh.py) is JAX's: the lanes
    of one segment are spread over the axis's ranks, and the max (still
    detached) and the sums are taken over it, so the softmax is exact
    over the whole segment (`ggnn_tpu/ops/segment.py:37-73`)."""
    if layout is None:
        layout = sorted_segments(segment_ids, num_segments,
                                 indices_are_sorted)
    if layout.offsets.shape[0] != num_segments + 1:
        raise ValueError(f"layout has {layout.offsets.shape[0] - 1} "
                         f"segments, expected {num_segments}")
    return SegmentSoftmax.apply(scores, segment_ids, mask, layout, epsilon,
                                axis_name)
