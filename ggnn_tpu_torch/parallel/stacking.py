"""Host-side batch stacks for the (data, edge) mesh: the port of
`ggnn_tpu/parallel/stacking.py`.

In JAX a stack is one pytree whose leading axis `shard_map` splits over
the data axis. Here a stack is a list of batches, its length a multiple
of n_data; data rank d takes the contiguous rows `rows_of(stack, mesh)`
(the JAX split), b_local = len(stack) / n_data of them. Short stacks are
topped up with explicit empty batches (all-masked, so their loss and
gradient contribution is exactly zero) rather than repeating data, as
in JAX (chem_tensorflow.py:229-247's graph-weighted accounting under a
fixed step shape).

JAX's PartitionSpec functions (`stacked_batch_specs`,
`stacked_dense_batch_specs`, `data_parallel_specs`) and
`stack_from_process_local` have no counterpart: each rank takes its own
rows and never sees another rank's.
"""

import dataclasses
from typing import List

import numpy as np
import torch

from ggnn_tpu_torch.graph import DenseGraphBatch, GraphBatch


def repad_edges(batch: GraphBatch, edge_capacity: int) -> GraphBatch:
    """Grow the per-type edge capacity to `edge_capacity`. Padding
    follows the GraphBatch dump-slot convention: source 0, target
    `node_capacity`, mask 0; every other leaf is kept."""
    t, e = batch.edge_sources.shape
    if edge_capacity < e:
        raise ValueError(f"cannot shrink edge capacity {e} -> {edge_capacity}")
    if edge_capacity == e:
        return batch
    pad = edge_capacity - e
    return dataclasses.replace(
        batch,
        edge_sources=np.concatenate(
            [batch.edge_sources, np.zeros((t, pad), np.int32)], axis=1),
        edge_targets=np.concatenate(
            [batch.edge_targets,
             np.full((t, pad), batch.node_capacity, np.int32)], axis=1),
        edge_mask=np.concatenate(
            [batch.edge_mask, np.zeros((t, pad), np.float32)], axis=1),
    )


def empty_batch_like(batch: GraphBatch) -> GraphBatch:
    """An all-padding batch with the same capacities: zero graphs, zero
    masked targets — a no-op under the masked loss and metrics."""
    n_cap = batch.node_capacity
    g_cap = batch.graph_capacity
    t, e = batch.edge_sources.shape
    k = batch.targets.shape[0]
    h = batch.node_features.shape[1]
    extra = {}
    if batch.edge_sources_all is not None:
        # The combined lane's padding conventions (graph.py): fillers
        # carry the same leaves as real batches.
        ea = batch.edge_sources_all.shape[0]
        extra = {
            "edge_sources_all": np.zeros((ea,), np.int32),
            "edge_types_all": np.zeros((ea,), np.int32),
            "edge_targets_all": np.full((ea,), n_cap, np.int32),
            "edge_mask_all": np.zeros((ea,), np.float32),
        }
    return dataclasses.replace(
        batch,
        node_features=np.zeros((n_cap, h), np.float32),
        node_graph_ids=np.full((n_cap,), g_cap, np.int32),
        edge_sources=np.zeros((t, e), np.int32),
        edge_targets=np.full((t, e), n_cap, np.int32),
        edge_mask=np.zeros((t, e), np.float32),
        in_degrees=np.zeros((n_cap, t), np.float32),
        targets=np.zeros((k, g_cap), np.float32),
        target_mask=np.zeros((k, g_cap), np.float32),
        num_graphs=np.int32(0),
        num_nodes=np.int32(0),
        **extra,
    )


def _strip_combined(b: GraphBatch) -> GraphBatch:
    """Drop the type-combined edge lane (type-TP partitions the per-type
    lanes instead)."""
    if b.edge_sources_all is None:
        return b
    return dataclasses.replace(b, edge_sources_all=None,
                               edge_types_all=None, edge_targets_all=None,
                               edge_mask_all=None)


def _top_up(batches: List, n_data: int, filler) -> List:
    short = -len(batches) % n_data
    return list(batches) + [filler] * short


def stack_batches(batches: List[GraphBatch], n_data: int,
                  n_edge: int = 1, edge_capacity: int = None,
                  keep_combined: bool = False) -> List[GraphBatch]:
    """The stack of per-step batches, its length a multiple of `n_data`
    (short stacks topped up with empty batches), every batch's per-type
    edge capacity repadded to `edge_capacity` (default: the largest).

    `keep_combined=True` keeps the type-combined edge lane when every
    batch has it (the data-parallel mesh runs the single-device layout);
    type-TP leaves it False. `n_edge` is kept for JAX's signature and
    pads nothing: type-TP shards the type axis, not the capacity."""
    del n_edge
    if not batches:
        raise ValueError("no batches to stack")
    if not (keep_combined
            and all(b.edge_sources_all is not None for b in batches)):
        batches = [_strip_combined(b) for b in batches]
    e_cap = (edge_capacity if edge_capacity is not None
             else max(b.edge_sources.shape[1] for b in batches))
    batches = [repad_edges(b, e_cap) for b in batches]
    return _top_up(batches, n_data, empty_batch_like(batches[0]))


def _zeros_like(x):
    """Zeros of a numpy leaf, or of a host torch tensor (the dense
    family's bf16 adjacency: numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros_like(np.asarray(x))


def empty_dense_batch_like(batch: DenseGraphBatch) -> DenseGraphBatch:
    """All-masked dense batch (a loss and gradient no-op filler)."""
    return DenseGraphBatch(
        node_features=_zeros_like(batch.node_features),
        adjacency=_zeros_like(batch.adjacency),
        node_mask=_zeros_like(batch.node_mask),
        targets=_zeros_like(batch.targets),
        target_mask=_zeros_like(batch.target_mask),
        num_graphs=np.int32(0),
    )


def stack_dense_batches(batches: List[DenseGraphBatch],
                        n_data: int) -> List[DenseGraphBatch]:
    """The stack of same-shape dense batches (one bucket: set
    `dense_bucket_sizes` to one entry for mesh runs), topped up with
    empty fillers to a multiple of `n_data`."""
    if not batches:
        raise ValueError("no batches to stack")
    shapes = {tuple(b.node_features.shape) for b in batches}
    if len(shapes) != 1:
        raise ValueError(
            f"mesh dense stacking needs one bucket shape, got {shapes}; "
            "set dense_bucket_sizes to a single entry")
    return _top_up(batches, n_data, empty_dense_batch_like(batches[0]))


def stack_any_batches(batches: List, n_data: int, empty_fn=None) -> List:
    """The stack of same-shape batches, topped up to a multiple of
    `n_data` with `empty_fn(batches[0])` (required when the count is not
    divisible)."""
    if not batches:
        raise ValueError("no batches to stack")
    if len(batches) % n_data != 0 and empty_fn is None:
        raise ValueError(
            f"{len(batches)} batches not divisible by n_data={n_data} "
            "and no empty_fn provided")
    if len(batches) % n_data == 0:
        return list(batches)
    return _top_up(batches, n_data, empty_fn(batches[0]))


def empty_masked_batch_like(batch):
    """Generic all-masked filler: zero targets, target mask and graph
    count, every other leaf copied (their compute reaches nothing through
    the masked loss). For the GCN and async batches, whose padding keeps
    every index leaf valid."""
    return dataclasses.replace(
        batch,
        targets=np.zeros_like(np.asarray(batch.targets)),
        target_mask=np.zeros_like(np.asarray(batch.target_mask)),
        num_graphs=np.int32(0),
    )


def rows_of(stack: List, mesh) -> List:
    """This rank's rows of a stack: data rank d of n_data takes the d-th
    of n_data contiguous blocks, as `shard_map` splits a leading axis."""
    n_data = mesh.shape["data"]
    if len(stack) % n_data != 0:
        raise ValueError(f"a stack of {len(stack)} batches does not split "
                         f"over n_data={n_data}")
    b_local = len(stack) // n_data
    d = mesh.data.index
    return stack[d * b_local:(d + 1) * b_local]
