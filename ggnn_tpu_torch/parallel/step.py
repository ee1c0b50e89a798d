"""Training and evaluation steps over the (data, edge) mesh: the port of
`ggnn_tpu/parallel/step.py`.

One step consumes this rank's rows of a stack (`local_batches`) and
treats the whole stack as one global batch with the reference's loss
(chem_tensorflow.py:158-170): each rank sums, per task, |diff|,
0.5*diff^2 and the target mask over its batches; the sums are added
over the data axis and normalised by the GLOBAL masked target count —
what the reference computes had it seen the union of the shards' graphs
as one batch (JAX's `global_loss`, `ggnn_tpu/parallel/step.py:114-127`).

Gradient synchronisation, which JAX gets from `psum`'s transpose, is
written out (parallel/collectives.py gives each collective its
backward):

  * the counts are summed over the data axis with no gradient, and each
    rank backpropagates its own share, sum_k sq_k / count_k * rescale_k,
    never a loss that went through a collective (that would count each
    term once per rank);
  * data parallelism and node shards: every leaf is replicated and each
    rank's gradient holds what its own batches and shard contributed, so
    the gradients are summed over every rank (a node shard's readout sum
    has an identity backward: every edge rank of a row computes the same
    loss from it);
  * type-TP: the edge ranks of a row compute the replicated part of the
    step on equal inputs, so a replicated leaf's gradient is already the
    row's on each of them, and a sharded leaf's is complete on its rank;
    every gradient is summed over the data axis only (a replicated
    leaf's copies are averaged over the edge axis as they are summed,
    so that every rank holds the same bits: the readout pools with
    atomics on the card, and two edge ranks' copies can differ in their
    last bits). The step's sums are averaged over the edge axis alike.

Then the per-leaf clip (the global norm for a type-sharded leaf) and
the TF1 Adam step, alike on every rank. Dropout: each rank draws from
its own `torch.Generator` (`rank_generator`): JAX's key folding
(`ggnn_tpu/parallel/step.py:94-104`) as seeds — the data index always,
the edge index for node shards (disjoint node rows need their own
masks), and none for type-TP (the replicated node states need one mask
on every edge rank).
"""

from typing import Dict, List, Sequence, Tuple

import torch

from ggnn_tpu_torch.models.base import task_rescale
from ggnn_tpu_torch.parallel import node_shard
from ggnn_tpu_torch.parallel.mesh import EDGE_AXIS, Mesh
from ggnn_tpu_torch.parallel.stacking import (empty_masked_batch_like,
                                              rows_of, stack_any_batches,
                                              stack_batches,
                                              stack_dense_batches)
from ggnn_tpu_torch.parallel.tp import is_tp_sharded_path, shard_lanes
from ggnn_tpu_torch.utils.constants import SMALL_NUMBER

BATCH_KINDS = ("sparse", "sparse_tp", "gcn", "dense", "data_only")
# Seed strides of `rank_generator`'s fold.
_DATA_STRIDE = 1_000_003
_EDGE_STRIDE = 7_919


def _node_sharded(batch_kind: str, mesh: Mesh) -> bool:
    return batch_kind in ("sparse", "gcn") and mesh.shape[EDGE_AXIS] > 1


def rank_generator(seed: int, mesh: Mesh, batch_kind: str
                   ) -> torch.Generator:
    """This rank's dropout generator, on its device: `seed` folded with
    its data index, and with its edge index for node shards. Data rank 0
    of a row that shares the stream draws the single-device stream."""
    fold = seed + _DATA_STRIDE * mesh.data.index
    if _node_sharded(batch_kind, mesh):
        fold += _EDGE_STRIDE * mesh.edge.index
    return torch.Generator(device=mesh.device).manual_seed(fold)


def plan_caps(batch_kind: str, batches, n_shards: int, **kwargs):
    """The node-shard capacities of `batches` for a node-sharded kind:
    `plan_gcn_shard_caps` for "gcn", `plan_node_shard_caps` otherwise
    (`kwargs`: their margin and nodes_local)."""
    plan = (node_shard.plan_gcn_shard_caps if batch_kind == "gcn"
            else node_shard.plan_node_shard_caps)
    return plan(batches, n_shards, **kwargs)


def stack_for(batch_kind: str, batches: List, n_data: int, caps=None,
              exchange: str = "alltoall",
              keep_combined: bool = False) -> List:
    """The stack of `batches` for a step of `batch_kind`, topped up to a
    multiple of n_data: node-sharded under `caps` (the node-sharded
    kinds pass them), one dense bucket, any fixed-shape batch
    ("data_only"), or the sparse stack (`keep_combined` on a
    data-parallel mesh; type-TP strips the lane)."""
    if caps is not None:
        shard = (node_shard.gcn_shard_and_stack if batch_kind == "gcn"
                 else node_shard.shard_and_stack)
        return shard(batches, caps, n_data, exchange)
    if batch_kind == "dense":
        return stack_dense_batches(batches, n_data)
    if batch_kind == "data_only":
        return stack_any_batches(batches, n_data, empty_masked_batch_like)
    return stack_batches(batches, n_data, keep_combined=keep_combined)


def local_rows(stack: List, mesh: Mesh, batch_kind: str) -> Tuple:
    """This rank's rows of a stack, on the host: node-sharded batches as
    this rank's shard (`local_view`), type-TP batches with this rank's
    per-type lanes. Their shapes follow from the stack's alone, so ranks
    whose stacks share their shapes hold rows of one shape; the ragged
    exchange's routing rows are arrays among them, whose values no graph
    key reads."""
    rows = rows_of(stack, mesh)
    if _node_sharded(batch_kind, mesh):
        return tuple(b.local_view(mesh.edge.index) for b in rows)
    if batch_kind == "sparse_tp":
        return tuple(shard_lanes(b, mesh.edge) for b in rows)
    return tuple(rows)


def local_batches(stack: List, mesh: Mesh, batch_kind: str) -> List:
    """`local_rows` on this rank's device."""
    return [b.to(mesh.device)
            for b in local_rows(stack, mesh, batch_kind)]


def make_parallel_steps(params, optimizer, config: Dict,
                        task_ids: Sequence[int], mesh: Mesh,
                        return_grads: bool = False,
                        batch_kind: str = "sparse") -> Tuple:
    """(train_step, eval_step) over `mesh` for `params` (a
    `models.base.ModelParams`, its graph model built with `edge_axis=
    mesh.axis(EDGE_AXIS)` where the edge axis has more than one rank)
    and `optimizer` (a `TFAdam` over them, `tp_axis` set for type-TP).

    `batch_kind` is JAX's: "sparse" (GraphBatch, node-sharded when the
    edge axis is on), "sparse_tp", "gcn" (node-sharded GCN), "dense"
    and "data_only" (any fixed-shape batch; both data-parallel only).

    `train_step(batches, generator)` and `eval_step(batches)` take this
    rank's batches on its device (`local_batches`) and return
    {loss [], accuracies [K], num_graphs []}, global and alike on every
    rank; the train step updates the parameters in place and, with
    `return_grads`, adds "grads": {name: the synchronised gradient}
    (before the clip; a type-sharded leaf's is this rank's slice).
    Each counts this rank's graphs from its batches' host counts, or
    takes them as `num_graphs`, a float32 [1] tensor on the device: a
    step captured into a CUDA graph reads nothing from the host."""
    if batch_kind not in BATCH_KINDS:
        raise ValueError(f"unknown batch_kind {batch_kind!r}; one of "
                         f"{BATCH_KINDS}")
    model = params.graph
    n_edge = mesh.shape[EDGE_AXIS]
    if batch_kind in ("dense", "data_only") and n_edge > 1:
        raise ValueError(f"{batch_kind} mesh training is data-parallel "
                         "only (use n_edge=1)")
    axis = getattr(model, "edge_axis", None)
    if n_edge > 1 and getattr(axis, "name", None) != EDGE_AXIS:
        raise ValueError(
            "mesh has edge-parallelism but the model was not built with "
            "edge_axis='edge'")
    if batch_kind == "sparse_tp" and n_edge > 1 and \
            getattr(optimizer, "tp_axis", None) is None:
        raise ValueError("batch_kind='sparse_tp' needs an optimizer with "
                         "tp_axis (the clip of a sharded leaf takes its "
                         "global norm)")

    use_graph = config["use_graph"]
    keep_prob = config["out_layer_dropout_keep_prob"]
    rescale = task_rescale(task_ids, config["task_sample_ratios"],
                           mesh.device)
    names = list(optimizer.params)
    leaves = [optimizer.params[n] for n in names]
    type_tp = batch_kind == "sparse_tp" and n_edge > 1
    sharded = [i for i, n in enumerate(names)
               if type_tp and is_tp_sharded_path(n)]
    replicated = [i for i in range(len(names)) if i not in sharded]

    def batch_sums(batch, generator, is_training):
        """Per-task (abs, sq, mask) sums of one local batch."""
        if use_graph:
            final = model(batch, is_training=is_training,
                          generator=generator)
        else:
            final = torch.zeros_like(batch.node_features)
        kp = keep_prob if is_training else 1.0
        computed = model.readout(params.heads, list(task_ids), final, batch,
                                 keep_prob=kp, generator=generator)
        diff = (computed - batch.targets) * batch.target_mask
        return (diff.abs().sum(dim=1), (0.5 * diff.square()).sum(dim=1),
                batch.target_mask.sum(dim=1))

    def sums(batches, generator, is_training, num_graphs):
        """(abs, sq, mask) [K] each over this rank's batches, and the
        global (abs, sq, mask, num_graphs) summed over the data axis."""
        per = [batch_sums(b, generator, is_training) for b in batches]
        abs_s, sq_s, mask_s = (torch.stack(x).sum(dim=0) for x in zip(*per))
        k = abs_s.shape[0]
        if num_graphs is None:
            graphs = abs_s.new_tensor([float(sum(int(b.num_graphs)
                                                 for b in batches))])
        else:
            graphs = num_graphs.to(abs_s.dtype)
        packed = torch.cat([abs_s.detach(), sq_s.detach(), mask_s.detach(),
                            graphs])
        if n_edge > 1:
            # Every edge rank of a row holds the row's sums: the mean of
            # the copies over the world is the data axis's sum, the same
            # bits on every rank (the copies may differ in their last
            # bits where the replicated readout pools with atomics).
            mesh.world.all_reduce(packed).div_(n_edge)
        else:
            mesh.data.all_reduce(packed)
        return (abs_s, sq_s, mask_s), (packed[:k], packed[k:2 * k],
                                       packed[2 * k:3 * k], packed[3 * k])

    def metrics_of(glob):
        abs_g, sq_g, mask_g, graphs = glob
        target_num = mask_g + SMALL_NUMBER
        return {"loss": (sq_g / target_num * rescale).sum(),
                "accuracies": abs_g / target_num, "num_graphs": graphs}

    def reduced(grads, axis, scale=None):
        """`grads` summed over `axis` in one flat reduction (then divided
        by `scale`)."""
        if axis.group is None or not grads:
            return grads
        flat = axis.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        if scale is not None:
            flat.div_(scale)
        return [part.view_as(g) for part, g in
                zip(flat.split([g.numel() for g in grads]), grads)]

    def sync(grads) -> List[torch.Tensor]:
        """Each leaf's gradient (zeros where it got none) summed over the
        ranks that computed a share of it. Under type-TP a sharded leaf's
        over the data axis; a replicated leaf's copies, one an edge rank,
        averaged over the world: the data axis's sum, the same bits on
        every rank, where the copies may differ in their last bits."""
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        if not type_tp:
            return reduced(grads, mesh.world)
        out = list(grads)
        for pick, axis, scale in ((sharded, mesh.data, None),
                                  (replicated, mesh.world, n_edge)):
            for i, g in zip(pick, reduced([grads[i] for i in pick], axis,
                                          scale)):
                out[i] = g
        return out

    def train_step(batches, generator=None, num_graphs=None) -> Dict:
        (_, sq_l, _), glob = sums(batches, generator, True, num_graphs)
        target_num = glob[2] + SMALL_NUMBER
        share = (sq_l / target_num * rescale).sum()
        grads = sync(torch.autograd.grad(share, leaves, allow_unused=True))
        metrics = metrics_of(glob)
        if return_grads:
            metrics["grads"] = dict(zip(names, grads))
        optimizer.step(dict(zip(names, grads)))
        return metrics

    def eval_step(batches, generator=None, num_graphs=None) -> Dict:
        with torch.no_grad():
            return metrics_of(sums(batches, None, False, num_graphs)[1])

    return train_step, eval_step
