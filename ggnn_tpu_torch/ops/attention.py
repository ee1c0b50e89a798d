"""The autograd Functions of propagation attention, each joining the
`edge_dot` kernel (ops/kernels/edge_dot.py) with the weighted instance
of the segment-sum kernel (ops/kernels/ell_spmm.py):

  * `EdgeDot`, the scores <h[src], h[tgt]> (`ggnn_tpu/ops/messages.py:
    56-70`): `edge_dot` forward, two weighted launches backward;
  * `AttentionGatherSegmentSum`, the attention-weighted sum of source
    rows (`ggnn_tpu/ops/messages.py:121-131`, `:178-183`): the weighted
    instance forward, the weighted instance over the transpose and
    `edge_dot` for the weights' gradient backward.

Under `compute_dtype: bfloat16` the rows and the aggregation's weights
are bf16 (the JAX model casts the attention weights to bf16); the
scores and the weights' gradient from `edge_dot` are f32 and are cast
back to the dtype of the tensor they are the gradient of, and the
scores' f32 cotangent is rounded to bf16 to weight the rows in the
backward.
"""

import torch

from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm


def _weighted_sum(table, ds, order):
    """The weighted instance over `order` (an `ell_spmm.SortedEdges`) with
    the weights ds, in the table's dtype."""
    ds = ds.to(table.dtype)
    weights = ds if order.perm is None else ds[order.perm]
    return ell_spmm.weighted_segment_scatter_sum(
        table, order.ids, weights.contiguous(), order.offsets,
        order.offsets.shape[0] - 1)


class EdgeDot(torch.autograd.Function):
    """The differentiable `edge_dot`: the kernel forward; backward two
    launches of the weighted instance (`ell_spmm.
    weighted_segment_scatter_sum`),

        dx[n] = sum of ds[e] * y[b[e]] over the pairs with a[e] = n,
        dy[m] = sum of ds[e] * x[a[e]] over the pairs with b[e] = m,

    `apply(x, a, y, b, by_a, by_b)`: `by_a` is the pairs'
    `ell_spmm.SortedEdges` by a with ids b (the pads, whose b is out of
    range, sorted past the end), `by_b` by b with ids a, each None where
    that gradient will not be asked for. With x and y the same tensor
    (the attention scores), autograd adds the two."""

    @staticmethod
    def forward(ctx, x, a, y, b, by_a, by_b):
        ctx.by_a, ctx.by_b = by_a, by_b
        ctx.save_for_backward(x, y)
        return edge_dot.edge_dot(x, a, y, b)

    @staticmethod
    def backward(ctx, ds):
        x, y = ctx.saved_tensors
        ds = ds.contiguous()
        dx = dy = None
        for wanted, order, name in ((ctx.needs_input_grad[0], ctx.by_a, "a"),
                                    (ctx.needs_input_grad[2], ctx.by_b, "b")):
            if wanted and order is None:
                raise RuntimeError(f"edge_dot's gradient needs the pairs "
                                   f"sorted by {name}; none was given to "
                                   "the forward")
        if ctx.needs_input_grad[0]:
            dx = _weighted_sum(y, ds, ctx.by_a)
        if ctx.needs_input_grad[2]:
            dy = _weighted_sum(x, ds, ctx.by_b)
        return dx, None, dy, None, None, None


class AttentionGatherSegmentSum(torch.autograd.Function):
    """The weighted aggregation with a gradient for its weights, the
    sparse GGNN's attention-weighted sum of source rows: the weighted
    instance forward,

        out[s] = sum over the edges e of segment s of w[e] * h[src[e]],

    and backward dh by the weighted instance over the edges sorted by
    source, dw[e] = <h[src[e]], g[seg[e]]> by `edge_dot`.

    `apply(h, src, w, offsets, num_segments, seg, by_source)`: `seg` [E]
    int32 is each edge's segment (the pads' at or past num_segments, or
    in a dump segment whose gradient the caller drops), and `by_source`
    the edges' `ell_spmm.SortedEdges` by source with ids `seg` (pads
    past the end), or None where h will not need a gradient."""

    @staticmethod
    def forward(ctx, h, src, w, offsets, num_segments, seg, by_source):
        ctx.by_source = by_source
        ctx.save_for_backward(h, src, w, seg)
        return ell_spmm.weighted_gather_segment_sum(h, src, w, offsets,
                                                    num_segments)

    @staticmethod
    def backward(ctx, dout):
        h, src, w, seg = ctx.saved_tensors
        dout = dout.contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            order = ctx.by_source
            if order is None:
                raise RuntimeError(
                    "the attention aggregation's gradient in h needs the "
                    "edges sorted by source; none was given to the forward")
            weights = w if order.perm is None else w[order.perm]
            dh = ell_spmm.weighted_segment_scatter_sum(dout, order.ids,
                                                       weights.contiguous(),
                                                       order.offsets,
                                                       h.shape[0])
        if ctx.needs_input_grad[2]:
            dw = edge_dot.edge_dot(h, src, dout, seg).to(w.dtype)
        return dh, None, dw, None, None, None, None
