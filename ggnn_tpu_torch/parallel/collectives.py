"""The collectives of the mesh steps, each with the backward it needs.

JAX writes no gradient synchronisation: under `shard_map` every `psum`
transposes so that gradients arrive summed (`ggnn_tpu/parallel/step.py:
11-20`). Under torch each collective's backward is chosen by hand
(Megatron-LM's "f" and "g" operators):

  * `reduce_to_replicated` (g): a sum over the axis whose result feeds
    computation every rank of the axis repeats (the readout's partial
    pools, type-TP's incoming messages). Each rank then holds the whole
    cotangent, so the backward is the identity.
  * `copy_to_shards` (f): replicated input entering each rank's own
    share of the work (type-TP's node states entering the rank's edge
    types). The backward sums the ranks' cotangents.
  * `exchange` / `ring_shift`: rows sent between ranks; the backward
    sends the cotangents back the way the rows came;
  * `ragged_exchange`: the gather of a rank's boundary rows and their
    ragged all-to-all through peer memory (nccl axes on cards,
    `Axis.ragged_exchange`); the backward pulls each slice's cotangent
    back from the peer that received it into the pack, and the pack's
    rows are summed into h's by the gather's transpose, a sorted sum in
    a fixed order (several pack rows may name one row of h).

A loss never goes through any of these: each rank backpropagates its
own share and the step sums the gradients (parallel/step.py).
"""

from typing import Sequence

import torch

from ggnn_tpu_torch.ops import segment
from ggnn_tpu_torch.parallel.mesh import Axis


class _ReduceToReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.clone()), None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, out_splits, in_splits):
        ctx.axis, ctx.splits = axis, (out_splits, in_splits)
        return axis.all_to_all(x, out_splits, in_splits)

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        return ctx.axis.all_to_all(g, in_splits, out_splits), None, None, \
            None


class _RaggedExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, spec, axis):
        ctx.spec, ctx.axis = spec, axis
        # The gather's transpose: `spec.gather` sorted once a call, made
        # only where a gradient will be asked for.
        ctx.layout = (segment.sorted_segments(spec.gather, h.shape[0])
                      if ctx.needs_input_grad[0] else None)
        table, ctx.routes = axis.ragged_exchange(h.contiguous(), spec)
        return table

    @staticmethod
    def backward(ctx, g):
        # Pushed by the routes this forward received: a step runs the
        # forwards of several batches before their backwards.
        pack = ctx.axis.ragged_exchange_backward(g.contiguous(), ctx.spec,
                                                 ctx.routes)
        return segment.sorted_segment_sum(pack, ctx.layout), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, k):
        ctx.axis, ctx.k = axis, k
        return axis.shift(x, k)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.shift(g, -ctx.k), None, None


def reduce_to_replicated(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of `x` over the axis; identity backward (g)."""
    if axis.size == 1:
        return x
    return _ReduceToReplicated.apply(x, axis)


def copy_to_shards(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """`x` itself; its cotangent summed over the axis (f)."""
    if axis.size == 1:
        return x
    return _CopyToShards.apply(x, axis)


def exchange(x: torch.Tensor, axis: Axis, out_splits: Sequence[int],
             in_splits: Sequence[int]) -> torch.Tensor:
    """`Axis.all_to_all` of the rows of x, differentiable: the backward is
    the reverse all-to-all."""
    return _Exchange.apply(x, axis, tuple(out_splits), tuple(in_splits))


def ragged_exchange(h: torch.Tensor, spec, axis: Axis) -> torch.Tensor:
    """The table [recv_cap, H] that this rank receives in the ragged
    exchange of h's rows `h[spec.gather]` (`Axis.ragged_exchange`),
    differentiable: the backward is the reverse transfer, then the
    gather's transpose."""
    return _RaggedExchange.apply(h, spec, axis)


def ring_shift(x: torch.Tensor, axis: Axis, k: int) -> torch.Tensor:
    """`Axis.shift` of x by k, differentiable: the backward shifts the
    cotangent by -k."""
    return _RingShift.apply(x, axis, k)
