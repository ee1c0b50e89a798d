"""Static-shape graph-batch containers: sparse (typed edge lists), dense
(bucketed adjacency stacks), GCN (one weighted COO list) and async
(scheduled propagation, with its segments).

The packers emit a `GraphBatch` (an `ELLGraphBatch` with `ell_block`),
`DenseGraphBatch`, `GCNGraphBatch` or `AsyncGraphBatch` of numpy arrays;
`.to(device)` turns it into torch tensors on the device the model runs
on. Fields, shapes and padding conventions are those of
`ggnn_tpu/graph.py`, so a batch from either package's packer compares
leaf for leaf.

Padding conventions:
  * nodes: rows `[num_nodes, node_capacity)` are zero features; their
    `node_graph_ids` point at the dump graph slot `graph_capacity`, so a
    segment-sum readout over `graph_capacity + 1` segments discards them.
  * edges: padded lanes have `source = 0` (any valid row) and
    `target = node_capacity` (the dump node slot); `edge_mask` is 0.
  * LAYOUT CONTRACT: each per-type lane is sorted by target, and the
    type-combined lane (`edge_*_all`) by (target, type), so the composite
    id `target * T + type` is monotone along it. Pads sit at the end of
    the combined lane with target = node_capacity, past every real
    composite id. The aggregation kernel relies on this order.
"""

import dataclasses
from typing import Any

import numpy as np
import torch

# Scalar leaves: kept as python ints on the device copy, so reading them
# never waits for the device.
_SCALARS = ("num_graphs", "num_nodes")


def _move(value, device):
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(_move(v, device) for v in value)
    if dataclasses.is_dataclass(value):
        return _to_device(value, device)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)


def _to_device(batch, device):
    """The same batch (a dataclass of numpy leaves, tuples of them or of
    nested dataclasses) as torch tensors on `device`; scalar leaves
    become python ints."""
    moved = {}
    for field in dataclasses.fields(batch):
        value = getattr(batch, field.name)
        if field.name in _SCALARS:
            moved[field.name] = int(value)
        else:
            moved[field.name] = _move(value, device)
    return type(batch)(**moved)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A packed multi-graph batch in sparse (typed edge list) form.

    Shapes (T = num edge types, N = node capacity, E = per-type edge
    capacity, EA = combined-lane capacity, G = graph capacity, K = task
    count, H = feature width):
      node_features  [N, H]   float32 — annotations zero-padded to H
      node_graph_ids [N]      int32   — graph slot per node; padding -> G
      edge_sources   [T, E]   int32   — padding -> 0
      edge_targets   [T, E]   int32   — padding -> N (dump slot)
      edge_mask      [T, E]   float32 — 1.0 for real edges
      in_degrees     [N, T]   float32 — incoming-edge counts per type
      targets        [K, G]   float32
      target_mask    [K, G]   float32
      num_graphs     []       int32   — real graph count
      num_nodes      []       int32   — real node count
      edge_sources_all / edge_types_all / edge_targets_all [EA] int32,
      edge_mask_all [EA] float32 — the type-combined lane (pads: src 0,
      type 0, target N, mask 0); None when no combined capacity was
      planned.
    """

    node_features: Any
    node_graph_ids: Any
    edge_sources: Any
    edge_targets: Any
    edge_mask: Any
    in_degrees: Any
    targets: Any
    target_mask: Any
    num_graphs: Any
    num_nodes: Any
    edge_sources_all: Any = None
    edge_types_all: Any = None
    edge_targets_all: Any = None
    edge_mask_all: Any = None

    @property
    def num_edge_types(self) -> int:
        return self.edge_sources.shape[0]

    @property
    def node_capacity(self) -> int:
        return self.node_features.shape[0]

    @property
    def graph_capacity(self) -> int:
        return self.targets.shape[1]

    def to(self, device) -> "GraphBatch":
        """The same batch as torch tensors on `device`."""
        return _to_device(self, device)


@dataclasses.dataclass(frozen=True)
class ELLGraphBatch(GraphBatch):
    """A GraphBatch plus blocked-ELL layouts of its per-type edges
    (`data/ell.py:build_ell_layout`), the input of
    `ops/kernels/ell_spmm.py:ell_aggregate_by_type` and
    `ell_scatter_sum`. The edge lists stay as they are: the ELL arrays
    are a second layout of the same edges, keyed by target block (fwd)
    and by source block (bwd). The models read the GraphBatch fields
    only.

    Shapes [T, NB, KE], int32: NB = the padded node count over the ELL
    block, KE = the planned slots a (type, block).
      ell_fwd_src / ell_bwd_tgt — gather indices, pads 0
      ell_fwd_tgt / ell_bwd_src — key indices, pads NB * block
    """

    ell_fwd_src: Any = None
    ell_fwd_tgt: Any = None
    ell_bwd_tgt: Any = None
    ell_bwd_src: Any = None


@dataclasses.dataclass(frozen=True)
class DenseGraphBatch:
    """A dense-adjacency batch, one graph per row (the dense and blocked
    variants).

    Shapes (B = batch, T = edge types, V = the bucket's vertex count):
      node_features [B, V, H]    float32 — annotations zero-padded to H
      adjacency     [B, T, V, V] float32 — adjacency[b, t, dst, src] = 1
      node_mask     [B, V]       float32 — 1.0 for real vertices
      targets       [K, B]       float32
      target_mask   [K, B]       float32
      num_graphs    []           int32   — real graph count; rows
                                           [num_graphs, B) are all zero
    """

    node_features: Any
    adjacency: Any
    node_mask: Any
    targets: Any
    target_mask: Any
    num_graphs: Any

    @property
    def num_vertices(self) -> int:
        return self.node_features.shape[1]

    def to(self, device) -> "DenseGraphBatch":
        """The same batch as torch tensors on `device`."""
        return _to_device(self, device)


@dataclasses.dataclass(frozen=True)
class GCNGraphBatch:
    """A packed batch for the single-edge-type GCN variant: the
    pre-normalised symmetric adjacency D^-1/2 (A+I) D^-1/2 as a weighted
    COO edge list (reference: chem_tensorflow_gcn.py:116-142), sorted by
    target, padding as in `GraphBatch` (source 0, target N, weight 0).

    Shapes (N = node capacity, E = COO capacity, G = graph capacity):
      node_features  [N, H] float32
      node_graph_ids [N]    int32   — padding -> G
      edge_sources   [E]    int32   — padding -> 0
      edge_targets   [E]    int32   — padding -> N (dump slot)
      edge_weights   [E]    float32 — 0.0 on padding
      targets        [K, G] float32
      target_mask    [K, G] float32
      num_graphs     []     int32
      num_nodes      []     int32
    """

    node_features: Any
    node_graph_ids: Any
    edge_sources: Any
    edge_targets: Any
    edge_weights: Any
    targets: Any
    target_mask: Any
    num_graphs: Any
    num_nodes: Any

    @property
    def node_capacity(self) -> int:
        return self.node_features.shape[0]

    @property
    def graph_capacity(self) -> int:
        return self.targets.shape[1]

    def to(self, device) -> "GCNGraphBatch":
        """The same batch as torch tensors on `device`."""
        return _to_device(self, device)


@dataclasses.dataclass(frozen=True)
class AsyncGraphBatch:
    """A packed batch with per-round scheduled-propagation tensors (the
    async GGNN, chem_tensorflow_async.py): each round r has
    S = propagation_substeps steps; at step s the edges whose receiver
    sits at schedule depth s fire, and each receiver is updated once a
    round.

    Shapes (R = rounds, S = substeps, T = edge types, I / SE / RC = the
    capacities of initial nodes, sending edges per (step, type) and
    receiving nodes per step):
      initial_nodes   [R, I]        int32 — pad -> N (dump)
      sending_nodes   [R, S, T, SE] int32 — global node ids, pad -> 0
      msg_targets     [R, S, T, SE] int32 — step-local receiver ids,
                                            pad -> RC (dump)
      receiving_nodes [R, S, RC]    int32 — global node ids, pad -> N

    The segmented compact-state layout (data/async_schedule.py), None
    without a segment plan: round states live in a compact slot space,
    [0, I) the initial nodes, [I, I + cumulative receivers) the
    receivers, the dump at M = I + N + the widest RC; the steps are
    grouped into segments with type-combined, (target, type)-sorted send
    lanes sized to each segment.
      seg_rounds    tuple(R) of tuple(AsyncSegment)
      init_prev     [R, I] int32 — previous-round slots (round 0: node ids)
      final_compact [N]    int32 — the last round's slot of each node
    """

    node_features: Any
    node_graph_ids: Any
    initial_nodes: Any
    sending_nodes: Any
    msg_targets: Any
    receiving_nodes: Any
    targets: Any
    target_mask: Any
    num_graphs: Any
    num_nodes: Any
    seg_rounds: Any = None
    init_prev: Any = None
    final_compact: Any = None

    @property
    def node_capacity(self) -> int:
        return self.node_features.shape[0]

    @property
    def graph_capacity(self) -> int:
        return self.targets.shape[1]

    def to(self, device) -> "AsyncGraphBatch":
        """The same batch as torch tensors on `device`, each segment's
        `recv_base` too (JAX keeps it a traced array)."""
        return _to_device(self, device)


@dataclasses.dataclass(frozen=True)
class AsyncSegment:
    """One segment of one async round (n = the steps it covers).

      send_compact [n, SEA] int32 — compact slots of the senders,
          type-combined lane sorted by (target, type); pads -> the dump
      msg_type     [n, SEA] int32 — edge type of each slot, pad -> 0
      msg_target   [n, SEA] int32 — step-local receiver ids, pad -> RC
      old_compact  [n, RC]  int32 — the receivers' previous-round slots
          (round 0: node ids into the feature buffer)
      recv_base    [n]      int32 — round-cumulative receiver offsets
    """

    send_compact: Any
    msg_type: Any
    msg_target: Any
    old_compact: Any
    recv_base: Any
