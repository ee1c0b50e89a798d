"""Tensor parallelism over the [T, H, H] edge-transform weights: the port
of `ggnn_tpu/parallel/tp.py`.

The sparse GGNN's per-layer, per-edge-type transforms (`edge_weights`
[T, H, H], chem_tensorflow_sparse.py:88-90) and attention factors
(`attention` [T]) are split along their type axis over the mesh's edge
axis, together with the batch's per-type edge lanes: each rank holds
T/P types' weights, their Adam moments and their lanes, and transforms
only those types' messages. Then:

  * the partial incoming sums are completed by one sum over the edge
    axis whose result feeds the replicated cell (`reduce_to_replicated`,
    identity backward); the node states enter each rank's types through
    `copy_to_shards`, whose backward sums the ranks' cotangents;
  * the propagation attention's softmax takes its max and sums over the
    edge axis (ops/segment.py);
  * a sharded leaf's gradient is complete on its rank; every leaf's
    gradient is summed over the data axis only (parallel/step.py);
  * the per-leaf clip-by-norm takes the global norm of a sharded leaf
    from its squared norm summed over the edge axis
    (training/optimizer.py), as the reference clips the whole variable.

Selection: config `"edge_parallelism": "type_tp"` (default
"node_shard", parallel/node_shard.py).
"""

import contextlib
import dataclasses

import torch

from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.parallel.mesh import Axis

# The layer leaves split along their type axis (edge biases stay whole:
# [T, H] is small and keeps the bias product local).
_SHARDED_LEAVES = ("edge_weights", "attention")


def is_tp_sharded_path(path) -> bool:
    """True for the sparse model's per-layer `edge_weights` and
    `attention` leaves. `path` is a parameter name
    (`graph.layers.0.edge_weights`) or a sequence of keys, and must pass
    through the graph model's layers: a leaf merely NAMED `attention`
    elsewhere (an attention readout head) is not sharded."""
    keys = path.split(".") if isinstance(path, str) else [
        str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
    return ("graph" in keys and "layers" in keys
            and any(k in _SHARDED_LEAVES for k in keys))


def validate_tp(num_edge_types: int, n_tp: int) -> None:
    if num_edge_types % n_tp != 0:
        raise ValueError(
            f"type-TP needs num_edge_types ({num_edge_types}) divisible "
            f"by the edge-axis size ({n_tp})")


def type_range(num_edge_types: int, axis: Axis) -> slice:
    """The types rank `axis.index` of the edge axis holds."""
    validate_tp(num_edge_types, axis.size)
    per = num_edge_types // axis.size
    return slice(axis.index * per, (axis.index + 1) * per)


def shard_lanes(batch: GraphBatch, axis: Axis) -> GraphBatch:
    """This rank's per-type lanes of a (combined-lane-free) batch:
    `edge_sources`, `edge_targets` and `edge_mask` [T/P, E]; the node
    arrays and `in_degrees` [N, T] stay whole (the averaging needs
    every type)."""
    if batch.edge_sources_all is not None:
        raise ValueError("type-TP partitions the per-type lanes; stack the "
                         "batches without the combined lane "
                         "(stack_batches(keep_combined=False))")
    types = type_range(batch.edge_sources.shape[0], axis)
    return dataclasses.replace(
        batch, edge_sources=batch.edge_sources[types],
        edge_targets=batch.edge_targets[types],
        edge_mask=batch.edge_mask[types])


@torch.no_grad()
def shard_parameters(params: torch.nn.Module, optimizer, axis: Axis,
                     num_edge_types: int) -> None:
    """Keep this rank's [T/P, ...] slice of every sharded parameter and of
    its Adam moments, in place (the Parameter objects stay the ones the
    optimizer holds)."""
    types = type_range(num_edge_types, axis)
    for name, p in params.named_parameters():
        if not is_tp_sharded_path(name):
            continue
        p.data = p.data[types].clone()
        if optimizer is not None and name in optimizer.mu:
            optimizer.mu[name] = optimizer.mu[name][types].clone()
            optimizer.nu[name] = optimizer.nu[name][types].clone()


@contextlib.contextmanager
def full_leaves(params: torch.nn.Module, optimizer, axis: Axis):
    """Every sharded parameter and Adam moment swapped for the whole
    [T, ...] tensor, gathered over the edge axis, for the body of the
    `with` (a checkpoint, a collective-free forward); the slices are put
    back after it. Collective: every rank of the axis enters it
    together."""
    named = {n: p for n, p in params.named_parameters()
             if is_tp_sharded_path(n)}
    saved = {n: p.data for n, p in named.items()}
    stores = [] if optimizer is None else [optimizer.mu, optimizer.nu]
    saved_moments = [{n: s[n] for n in named if n in s} for s in stores]
    with torch.no_grad():
        for n, data in saved.items():
            named[n].data = axis.all_gather(data)
        for store, sharded in zip(stores, saved_moments):
            store.update({n: axis.all_gather(t) for n, t in sharded.items()})
    try:
        yield
    finally:
        for n, data in saved.items():
            named[n].data = data
        for store, sharded in zip(stores, saved_moments):
            store.update(sharded)
