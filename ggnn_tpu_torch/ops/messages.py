"""Typed-edge message passing — the sparse model's hot path.

One propagation step of the sparse GGNN (chem_tensorflow_sparse.py:
153-216), the counterpart of `ggnn_tpu/ops/messages.py`, on three routes:

  * aggregate-before-transform over the type-combined edge lane: the
    source rows summed per (target, type) over the composite id
    target*T + type (kernel B1 forward, its transpose B2 backward), then
    one [N, T*H] x [T*H, H] product (`aggregate_then_transform_combined`);
  * the same over the per-type lanes, flattened [T*E] with the composite
    id t*(N+1) + target, whose dump segments take the pads
    (`aggregate_then_transform`);
  * per edge, the reference's order: every source row gathered (kernel
    B3, `GatherRows`), transformed by its type's [H, H] weight (`bmm`)
    and summed into its target (B1 over the targets in stable order;
    `typed_edge_messages`, `aggregate_messages`).

The transform is linear, so sum_e H[src_e] @ W_t == (sum_e H[src_e]) @ W_t:
aggregating first shrinks the product from [T,E,H] x [T,H,H] to
[N,T*H] x [T*H,H]. Float summation order differs from the reference
within normal f32 tolerance.

Optional propagation attention (chem_tensorflow_sparse.py:170-196): a
score <h[src], h[tgt]> per edge (kernel `edge_dot`), scaled by a
per-type factor and softmaxed over each target's incoming edges. The
aggregate-first routes scale the gathered source rows by the weights
(the weighted instance of B1's body, `AttentionGatherSegmentSum`); the
per-edge route scales the messages, as JAX does.

Under `compute_dtype: bfloat16` the model hands these functions its node
states and edge weights in bf16, as the JAX model does
(`ggnn_tpu/models/sparse_ggnn.py:211-259`): the gathers and segment sums
run on the kernels' bf16 instances (f32 sums, each output rounded
once), the transforms are `matmul_f32` (bf16 in, f32 out, the
counterpart of `preferred_element_type=jnp.float32`), the scores are
f32 dots and the softmax runs in f32. The per-edge route's messages are
f32, as JAX's are, so its aggregation runs B1 in f32.

Index preparation (sorts, CSR offsets, transposes) lives in `EdgeLanes`,
which a forward makes once and every step reuses; each function below
makes its own when none is given.
"""

from functools import cached_property
from typing import Optional

import torch

from ggnn_tpu_torch.ops.attention import AttentionGatherSegmentSum, EdgeDot
from ggnn_tpu_torch.ops.kernels.ell_spmm import (GatherSegmentSum,
                                                 SortedEdges,
                                                 transpose_layout)
from ggnn_tpu_torch.ops.kernels.gather_floor import GatherRows
from ggnn_tpu_torch.ops.precision import matmul_f32
from ggnn_tpu_torch.ops.segment import (SortedSegments, segment_offsets,
                                        segment_softmax, sorted_gather,
                                        sorted_segments, source_order)
from ggnn_tpu_torch.utils.constants import SMALL_NUMBER


def _needs_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class EdgeLanes:
    """One forward's index preparation over an edge list: the
    type-combined lane [EA], or the per-type lanes [T, E] flattened in
    lane order. Each sort, CSR offset array and transpose is made at its
    first use and reused by every later step of the forward.

    sources, targets: int32 (pads: source 0, target N; no sources where
    only messages are aggregated). `segments`
    (int32, sorted; None where no aggregation over them runs) are the
    aggregate-first route's segment ids out of `num_segments`, the pads
    at or past num_segments or in dump segments; `targets_sorted` says
    whether the flat targets are sorted already. The sources index
    `num_sources` rows (default: the node capacity; a node shard's
    boundary lane reads the received table instead)."""

    def __init__(self, sources, targets, node_capacity: int,
                 segments=None, num_segments: int = 0,
                 targets_sorted: bool = False, types=None,
                 num_sources: Optional[int] = None, num_types: int = 0):
        self.src = None if sources is None else sources.reshape(-1)
        self.tgt = targets.reshape(-1)
        self.node_capacity = node_capacity
        self.num_sources = (node_capacity if num_sources is None
                            else num_sources)
        self.segments = None if segments is None else segments.reshape(-1)
        self.num_segments = num_segments
        self.targets_sorted = targets_sorted
        self.types = types
        self.num_types = num_types

    @classmethod
    def combined(cls, src_all, type_all, tgt_all, num_edge_types: int,
                 node_capacity: int,
                 num_sources: Optional[int] = None) -> "EdgeLanes":
        """The type-combined lane, (target, type)-sorted by the packers:
        segments target*T + type out of N*T, the pads (target N) past
        them. A node shard's local and boundary lanes have this layout
        over its Nl rows (parallel/node_shard.py)."""
        types = type_all.long()
        composite = (tgt_all.long() * num_edge_types + types).to(torch.int32)
        return cls(src_all, tgt_all, node_capacity, composite,
                   node_capacity * num_edge_types, True, types, num_sources,
                   num_edge_types)

    @classmethod
    def typed(cls, edge_sources, edge_targets,
              node_capacity: int) -> "EdgeLanes":
        """The per-type lanes [T, E], each sorted by target (the packers'
        contract; `sort_typed_lanes` sorts hand-built ones): segments
        t*(N+1) + target out of T*(N+1), globally sorted because the pads
        sit at target N, the dump segment of their type."""
        t_dim = edge_sources.shape[0]
        types = torch.arange(t_dim, device=edge_targets.device)[:, None]
        composite = (types * (node_capacity + 1)
                     + edge_targets.long()).to(torch.int32)
        return cls(edge_sources, edge_targets, node_capacity, composite,
                   t_dim * (node_capacity + 1), False)

    @cached_property
    def real(self) -> torch.Tensor:
        return self.tgt < self.node_capacity

    @cached_property
    def offsets(self) -> torch.Tensor:
        """CSR offsets [S + 1] of the segments (B1's and the weighted
        instance's forward)."""
        return segment_offsets(self.segments, self.num_segments)

    @cached_property
    def _by_source(self):
        """(perm, boff): the edges stably sorted by source, the pads
        (target N) keyed past the last source row."""
        n = self.num_sources
        return source_order(torch.where(self.real, self.src, n).long(), n)

    def _source_sorted(self, ids) -> SortedEdges:
        perm, boff = self._by_source
        return SortedEdges(perm, ids[perm].to(torch.int32).contiguous(),
                           boff)

    @cached_property
    def segment_transpose(self) -> SortedEdges:
        """The real edges by source, reading their segments' rows: B2's
        (bgather, boff), and the attention aggregation's transpose."""
        return self._source_sorted(self.segments)

    @cached_property
    def source_pairs(self) -> SortedEdges:
        """The real edges by source, reading their targets' rows: the
        scores' gradient in their sources."""
        return self._source_sorted(self.tgt)

    @cached_property
    def gather_transpose(self):
        """(bgather, boff) of `GatherRows`: the real edges' flat positions
        by source."""
        perm, boff = self._by_source
        return perm.to(torch.int32), boff

    @cached_property
    def type_segments(self) -> SortedSegments:
        """The edges of a combined lane by type (pads of type 0): the
        gradient of the type factors' gather."""
        return sorted_segments(self.types, self.num_types)

    @cached_property
    def target_segments(self) -> SortedSegments:
        """The edges by target over N + 1 segments (the last the pads'
        dump): the softmax's sums."""
        return sorted_segments(self.tgt, self.node_capacity + 1,
                               self.targets_sorted)

    def _target_sorted(self, ids) -> SortedEdges:
        perm, offsets = self.target_segments
        if perm is not None:
            ids = ids[perm]
        return SortedEdges(perm, ids.to(torch.int32).contiguous(),
                           offsets[:self.node_capacity + 1])

    @cached_property
    def target_pairs(self) -> SortedEdges:
        """The edges by target, reading their sources' rows (the pads past
        offsets[N]): the scores' gradient in their targets."""
        return self._target_sorted(self.src)

    @cached_property
    def message_order(self) -> SortedEdges:
        """The edges by target, reading their own message rows: the
        per-edge route's aggregation."""
        return self._target_sorted(torch.arange(self.tgt.shape[0],
                                                device=self.tgt.device))

    @cached_property
    def message_transpose(self):
        """(bgather, boff) of the per-edge aggregation's gradient: each
        real message reads its target's row, a pad reads none."""
        e = self.tgt.shape[0]
        positions = torch.arange(e, device=self.tgt.device)
        return transpose_layout(torch.where(self.real, positions, e),
                                self.tgt.long(), e)


def sort_typed_lanes(edge_targets, *lanes):
    """The per-type targets [T, E] and each of `lanes` (of their shape;
    None passes through) stably sorted by target, each type's lane
    apart: for hand-built batches (`edges_sorted_by_target: false`).
    Index preparation: once per forward."""
    perm = torch.argsort(edge_targets, dim=1, stable=True)
    return tuple(None if x is None else torch.gather(x, 1, perm).contiguous()
                 for x in (edge_targets,) + lanes)


def aggregate_lanes(node_states, lanes: EdgeLanes, attention=None):
    """[S, H]: the per-segment sums over `lanes` of the source rows of
    node_states, weighted by `attention` [E] if given (B1, or the
    weighted instance); the transpose is built only when node_states
    needs a gradient."""
    transpose = (lanes.segment_transpose if _needs_grad(node_states)
                 else None)
    if attention is None:
        bgather, boff = (None, None) if transpose is None else transpose[1:]
        return GatherSegmentSum.apply(node_states, lanes.src, lanes.offsets,
                                      lanes.num_segments, bgather, boff)
    return AttentionGatherSegmentSum.apply(
        node_states, lanes.src, attention.reshape(-1).contiguous(),
        lanes.offsets, lanes.num_segments, lanes.segments, transpose)


def typed_edge_messages(node_states: torch.Tensor,
                        edge_sources: torch.Tensor,
                        edge_weights: torch.Tensor,
                        lanes: Optional[EdgeLanes] = None) -> torch.Tensor:
    """Gather + transform: per-type messages [T, E, H] f32, the source
    rows gathered by B3 (`GatherRows`) and multiplied by their type's
    weight (`matmul_f32`). node_states [N, H]; edge_sources [T, E] int32;
    edge_weights [T, H, H], of node_states' dtype.
    Given `lanes`, the gather's gradient skips the pads (their messages
    reach only the dump slot)."""
    transpose = (None, None)
    if _needs_grad(node_states):
        if lanes is not None:
            transpose = lanes.gather_transpose
        else:
            flat = edge_sources.reshape(-1).long()
            transpose = transpose_layout(
                flat, torch.arange(flat.shape[0], device=flat.device),
                node_states.shape[0])
    gathered = GatherRows.apply(node_states, edge_sources, *transpose)
    return matmul_f32(gathered, edge_weights)


def aggregate_messages(messages: torch.Tensor, edge_targets: torch.Tensor,
                       node_capacity: int,
                       lanes: Optional[EdgeLanes] = None) -> torch.Tensor:
    """Segment-sum flattened typed messages [T, E, H] into nodes: [N, H].
    B1 over the messages in stable target order; `edge_targets` use the
    dump-slot convention (padding -> N), so the pads sort past every
    node and are never read."""
    t, e, h = messages.shape
    if lanes is None:
        lanes = EdgeLanes(None, edge_targets, node_capacity)
    order = lanes.message_order
    bgather, boff = (lanes.message_transpose if _needs_grad(messages)
                     else (None, None))
    return GatherSegmentSum.apply(messages.reshape(t * e, h), order.ids,
                                  order.offsets, node_capacity, bgather,
                                  boff)


def _edge_scores(node_states, sources, targets, node_capacity,
                 per_edge_factor, lanes: Optional[EdgeLanes] = None):
    """<src, tgt> dot-product score per edge (kernel `edge_dot`), scaled
    by a per-edge factor. JAX clamps a pad's target (the dump slot N,
    which has no state row) to N - 1; `edge_dot` gives a pad 0 instead.
    Either way the pads' scores are masked out of the softmax, and the
    two agree on every real edge."""
    if lanes is None:
        lanes = EdgeLanes(sources, targets, node_capacity)
    need = _needs_grad(node_states)
    dots = EdgeDot.apply(node_states, lanes.src, node_states, lanes.tgt,
                         lanes.source_pairs if need else None,
                         lanes.target_pairs if need else None)
    return dots.view(sources.shape) * per_edge_factor


def propagation_attention_weights(node_states: torch.Tensor,
                                  edge_sources: torch.Tensor,
                                  edge_targets: torch.Tensor,
                                  edge_mask: torch.Tensor,
                                  type_factors: torch.Tensor,
                                  node_capacity: int,
                                  edge_axis: Optional[str] = None,
                                  lanes: Optional[EdgeLanes] = None
                                  ) -> torch.Tensor:
    """Per-edge attention weights [T, E] over the per-type lanes: the
    segment softmax, over each target's incoming edges of every type, of
    the <src, tgt> scores scaled per type (chem_tensorflow_sparse.py:
    170-196). Under type-TP (`edge_axis`, the mesh's edge `Axis`) the
    lanes hold this rank's types and the softmax's max and sums run over
    the axis, so it is exact over every type's edges (JAX's
    `ggnn_tpu/ops/messages.py:79-94`)."""
    if lanes is None:
        lanes = EdgeLanes(edge_sources, edge_targets, node_capacity)
    t, e = edge_sources.shape
    scores = _edge_scores(node_states, edge_sources, edge_targets,
                          node_capacity, type_factors[:, None], lanes)
    attention = segment_softmax(
        scores.reshape(t * e), lanes.tgt, node_capacity + 1,
        edge_mask.reshape(t * e), SMALL_NUMBER,
        layout=lanes.target_segments, axis_name=edge_axis)
    return attention.view(t, e)


def aggregate_then_transform(node_states: torch.Tensor,
                             edge_sources: torch.Tensor,
                             edge_targets: torch.Tensor,
                             edge_weights: torch.Tensor,
                             node_capacity: int,
                             attention: Optional[torch.Tensor] = None,
                             targets_sorted: bool = False,
                             lanes: Optional[EdgeLanes] = None
                             ) -> torch.Tensor:
    """One propagation step's incoming activations [N, H] over the
    per-type lanes, aggregate-before-transform: B1 (or, with attention
    [T, E], the weighted instance) over the flattened lanes with
    composite ids t*(N+1) + target, the result viewed [T, N+1, H] with
    its dump rows dropped, then einsum("tnh,thd->nd") as one [N, T*H] x
    [T*H, H] product (`matmul_f32`: f32 out). Unless
    `targets_sorted` (the packers' contract), each type's lane is sorted
    by target first; `lanes` (`EdgeLanes.typed` of sorted lanes) skips
    that."""
    t_dim, h_dim, d_dim = edge_weights.shape
    if lanes is None:
        src, tgt = edge_sources, edge_targets
        if not targets_sorted:
            tgt, src, attention = sort_typed_lanes(tgt, src, attention)
        lanes = EdgeLanes.typed(src, tgt, node_capacity)
    per = aggregate_lanes(node_states, lanes, attention)
    per = per.view(t_dim, node_capacity + 1, h_dim)[:, :node_capacity]
    return matmul_f32(per.transpose(0, 1).reshape(node_capacity,
                                                  t_dim * h_dim),
                      edge_weights.reshape(t_dim * h_dim, d_dim))


def propagation_attention_weights_combined(node_states: torch.Tensor,
                                           src_all: torch.Tensor,
                                           tgt_all: torch.Tensor,
                                           mask_all: torch.Tensor,
                                           type_all: torch.Tensor,
                                           type_factors: torch.Tensor,
                                           node_capacity: int,
                                           lanes: Optional[EdgeLanes] = None
                                           ) -> torch.Tensor:
    """Per-edge attention weights [EA] on the type-combined lane: the
    same math as `propagation_attention_weights` (the softmax groups by
    target only, so combining types changes nothing). The lane is
    (target, type)-sorted, so the softmax's sums need no sort."""
    if lanes is None:
        lanes = EdgeLanes.combined(src_all, type_all, tgt_all,
                                   type_factors.shape[0], node_capacity)
    # The gather's gradient sums each factor's edges in the fixed order of
    # the lane's type sort (index_select's would add them with atomics).
    scores = _edge_scores(node_states, src_all, tgt_all, node_capacity,
                          sorted_gather(type_factors, lanes.types,
                                        lanes.type_segments), lanes)
    return segment_softmax(scores, tgt_all, node_capacity + 1, mask_all,
                           SMALL_NUMBER, layout=lanes.target_segments)


def aggregate_then_transform_combined(node_states: torch.Tensor,
                                      src_all: torch.Tensor,
                                      type_all: torch.Tensor,
                                      tgt_all: torch.Tensor,
                                      edge_weights: torch.Tensor,
                                      node_capacity: int,
                                      attention: Optional[torch.Tensor] = None,
                                      lanes: Optional[EdgeLanes] = None
                                      ) -> torch.Tensor:
    """One propagation step's incoming activations [N, H] over the
    type-COMBINED edge lane (GraphBatch.edge_*_all): the per-(target,
    type) sums of the source rows, weighted by `attention` [EA] if given
    (of node_states' dtype), then one [N, T*H] x [T*H, H] product with an
    f32 output. `lanes` is the lane's
    `EdgeLanes.combined`, made here when not given."""
    t_dim, h_dim, d_dim = edge_weights.shape
    if lanes is None:
        lanes = EdgeLanes.combined(src_all, type_all, tgt_all, t_dim,
                                   node_capacity)
    per = aggregate_lanes(node_states, lanes, attention)          # [N*T, H]
    # Row n of the [N, T*H] view is [per(n, 0) | ... | per(n, T-1)], and
    # row t*H + k of the [T*H, H] view is edge_weights[t, k]: the
    # product is einsum("nth,thd->nd"), f32 out.
    return matmul_f32(per.view(node_capacity, t_dim * h_dim),
                      edge_weights.reshape(t_dim * h_dim, d_dim))


def propagation_attention(messages: torch.Tensor, node_states: torch.Tensor,
                          edge_sources: torch.Tensor,
                          edge_targets: torch.Tensor, edge_mask: torch.Tensor,
                          type_factors: torch.Tensor, node_capacity: int,
                          edge_axis: Optional[str] = None,
                          lanes: Optional[EdgeLanes] = None) -> torch.Tensor:
    """Segment-softmax attention over incoming messages [T, E, H]: the
    messages reweighted by `propagation_attention_weights`
    (chem_tensorflow_sparse.py:170-196), whose softmax runs over
    `edge_axis` under type-TP (JAX's `ggnn_tpu/ops/messages.py:193-211`)."""
    attention = propagation_attention_weights(
        node_states, edge_sources, edge_targets, edge_mask, type_factors,
        node_capacity, edge_axis, lanes)
    return messages * attention[..., None]


def average_by_in_degree(incoming: torch.Tensor,
                         in_degrees: torch.Tensor) -> torch.Tensor:
    """Divide aggregated messages by total in-degree (+ epsilon), the
    reference's `use_edge_msg_avg_aggregation`
    (chem_tensorflow_sparse.py:206-209)."""
    num_incoming = in_degrees.sum(dim=-1, keepdim=True)        # [N, 1]
    return incoming / (num_incoming + SMALL_NUMBER)


def edge_bias_term(in_degrees: torch.Tensor,
                   edge_biases: torch.Tensor) -> torch.Tensor:
    """Per-node bias: in-degree counts [N, T] @ biases [T, H] -> [N, H],
    the reference's `use_edge_bias` (chem_tensorflow_sparse.py:202-204)."""
    return torch.matmul(in_degrees, edge_biases)
