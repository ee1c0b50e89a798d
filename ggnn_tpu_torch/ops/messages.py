"""Typed-edge message passing — the sparse model's hot path.

One propagation step of the sparse GGNN (chem_tensorflow_sparse.py:
153-216), aggregate-before-transform over the type-combined edge lane:

  1. gather source rows and sum them per (target, type) — the
     differentiable GatherSegmentSum over the composite id
     target*T + type: kernel B1 forward, its transpose B2 backward;
  2. one dense product [N, T*H] x [T*H, H] with the edge weights;
  3. optional edge bias and in-degree averaging.

The transform is linear, so sum_e H[src_e] @ W_t == (sum_e H[src_e]) @ W_t:
the reference transforms each edge then aggregates; aggregating first
shrinks the product to one [N, T*H] x [T*H, H] matmul. Float summation
order differs from the reference within normal f32 tolerance.
"""

from typing import Optional

import torch

from ggnn_tpu_torch.ops.kernels.ell_spmm import (GatherSegmentSum,
                                                 segment_offsets,
                                                 transpose_layout)
from ggnn_tpu_torch.utils.constants import SMALL_NUMBER


def combined_lane_offsets(tgt_all: torch.Tensor, type_all: torch.Tensor,
                          num_edge_types: int,
                          node_capacity: int) -> torch.Tensor:
    """CSR offsets [N*T + 1] of the combined lane's composite ids
    target*T + type. The packers sort the lane by (target, type), and
    pads (target = N) sit past every real id, so they are never read.
    Index preparation: compute once per forward, reuse for every step."""
    seg = tgt_all.long() * num_edge_types + type_all.long()
    return segment_offsets(seg, node_capacity * num_edge_types)


def combined_lane_transpose(src_all: torch.Tensor, type_all: torch.Tensor,
                            tgt_all: torch.Tensor, num_edge_types: int,
                            node_capacity: int):
    """(bgather, boff): the combined lane's transpose layout for B2, the
    real edges' composite ids target*T + type in source order and CSR
    offsets [N + 1] over sources. The pads (source 0, target N) are
    dropped first: in source order they would land among node 0's edges
    with an id past the end of the aggregation's output. Index
    preparation: compute once per forward, and only when a gradient is
    needed."""
    real = tgt_all < node_capacity
    composite = (tgt_all.long() * num_edge_types + type_all.long())[real]
    return transpose_layout(src_all.long()[real], composite, node_capacity)


def aggregate_then_transform_combined(node_states: torch.Tensor,
                                      src_all: torch.Tensor,
                                      type_all: torch.Tensor,
                                      tgt_all: torch.Tensor,
                                      edge_weights: torch.Tensor,
                                      node_capacity: int,
                                      attention: Optional[torch.Tensor] = None,
                                      offsets: Optional[torch.Tensor] = None,
                                      transpose=None) -> torch.Tensor:
    """One propagation step's incoming activations [N, H] over the
    type-COMBINED edge lane (GraphBatch.edge_*_all). `offsets` are the
    lane's `combined_lane_offsets`, computed here when not given;
    `transpose` is its `combined_lane_transpose`, needed when
    node_states needs a gradient."""
    if attention is not None:
        raise NotImplementedError(
            "propagation attention is not ported yet (ROADMAP A14)")
    t_dim, h_dim, d_dim = edge_weights.shape
    if offsets is None:
        offsets = combined_lane_offsets(tgt_all, type_all, t_dim,
                                        node_capacity)
    bgather, boff = (None, None) if transpose is None else transpose
    per = GatherSegmentSum.apply(node_states, src_all, offsets,
                                 node_capacity * t_dim, bgather,
                                 boff)                      # [N*T, H]
    # Row n of the [N, T*H] view is [per(n, 0) | ... | per(n, T-1)], and
    # row t*H + k of the [T*H, H] view is edge_weights[t, k]: the
    # product is einsum("nth,thd->nd").
    return torch.matmul(per.view(node_capacity, t_dim * h_dim),
                        edge_weights.reshape(t_dim * h_dim, d_dim))


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
