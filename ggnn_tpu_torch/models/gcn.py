"""GCN (Kipf & Welling) over a pre-normalised adjacency — the `gcn` and
`gcn_blocked` variants.

Port of `ggnn_tpu/models/gcn.py` (chem_tensorflow_gcn.py:28-199). The
packer normalises D^-1/2 (A+I) D^-1/2 (data/packing.py); per layer l of
`num_timesteps` layers the model computes

    H <- Â · H
    H <- H · W_l (+ b_l when gcn_use_bias)
    ReLU and state dropout on every layer but the last

with no RNN cell; edge types are discarded.

  * `GCN` (`gcn`) computes Â·H over the batch's target-sorted weighted
    COO list with the weighted instance of the sorted-segment kernel
    (ops/kernels/ell_spmm.py, `WeightedGatherSegmentSum`): the kernel over
    the target-sorted edges forward, over their source-sorted transpose
    backward. The list's CSR offsets and its transpose layout are built
    once per forward and shared by every layer. The JAX model runs the
    same sum through XLA's sorted `segment_sum`.
  * `BlockedGCN` (`gcn_blocked`) computes it as one `torch.bmm` of the
    bucket's [B, V, V] float adjacency, on cuBLAS. Under `compute_dtype:
    bfloat16` it casts as the JAX model does (`ggnn_tpu/models/gcn.py:
    174-189`): the adjacency, H, Â·H and W go to bf16 and both products
    are bf16-in, f32-out (`ops/precision.py:matmul_f32`). `GCN` has no
    `compute_dtype`, as in JAX, and runs f32 whatever the key says.

On a mesh's edge axis (`edge_axis`, the mesh's edge `Axis`; ROADMAP A11)
`GCN` runs JAX's node-sharded branch (`ggnn_tpu/models/gcn.py:88-122`,
parallel/node_shard.py's GCN layout): per layer one boundary exchange,
then the weighted instance over the shard's local lane against H and
over its boundary lane against the received table, the two sums added;
the readout sums its partial pools over the axis.

Parameter names are the JAX key paths (`layers.{i}.W`, `layers.{i}.b`), so
the checkpoint bridge is a rename. Dropout masks come from an explicit
`torch.Generator`.
"""

from typing import Dict

import torch
from torch import nn

from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.models.dense_ggnn import resolve_lane_pad
from ggnn_tpu_torch.models.sparse_ggnn import (check_edge_axis,
                                               compute_dtype)
from ggnn_tpu_torch.ops.dropout import dropout
from ggnn_tpu_torch.ops.kernels.ell_spmm import (WeightedGatherSegmentSum,
                                                 weighted_transpose_layout)
from ggnn_tpu_torch.ops.precision import matmul_f32
from ggnn_tpu_torch.ops.segment import segment_offsets
from ggnn_tpu_torch.parallel.node_shard import (exchange_boundary,
                                                table_rows)
from ggnn_tpu_torch.utils.init import glorot_init, zeros_init


class GCNLayer(nn.Module):
    def __init__(self, hidden_size: int, use_bias: bool,
                 generator: torch.Generator):
        super().__init__()
        self.W = nn.Parameter(glorot_init(generator, (hidden_size,
                                                      hidden_size)))
        if use_bias:
            self.b = nn.Parameter(zeros_init(generator, (hidden_size,)))


def weighted_lane(src, tgt, weights, node_capacity: int,
                  edges_sorted: bool, with_transpose: bool,
                  num_sources: int = None):
    """(src, weights, offsets, transpose) of a weighted COO lane for
    `WeightedGatherSegmentSum`, made once per forward: the edges sorted by
    target (a stable sort on the device unless `edges_sorted`), the CSR
    offsets over the targets, past which the pads (target N) lie, and,
    when `with_transpose`, the (bgather, bweights, boff) of the lane's
    transpose, whose pads get source `num_sources` (default N) and
    gather row 0 so that they sort past boff[num_sources] and read a
    valid row in the plain version. A node shard's boundary lane reads
    the received table, whose rows are its `num_sources`."""
    if not edges_sorted:
        perm = torch.argsort(tgt, stable=True)
        src, tgt, weights = src[perm], tgt[perm], weights[perm]
    offsets = segment_offsets(tgt, node_capacity)
    transpose = (None, None, None)
    if with_transpose:
        n_src = node_capacity if num_sources is None else num_sources
        real = tgt < node_capacity
        transpose = weighted_transpose_layout(
            torch.where(real, src, n_src),
            torch.where(real, tgt, 0), weights, n_src)
    return src.contiguous(), weights.contiguous(), offsets, transpose


def gcn_edges(batch, node_capacity: int, edges_sorted: bool,
              with_transpose: bool):
    """`weighted_lane` of a GCN batch's COO list."""
    return weighted_lane(batch.edge_sources, batch.edge_targets,
                         batch.edge_weights, node_capacity, edges_sorted,
                         with_transpose)


class GCN(nn.Module):
    """`forward(batch)` -> final node states [N, H];
    `readout(heads, task_ids, last_h, batch)` -> predictions [K, G]."""

    def __init__(self, config: Dict, generator: torch.Generator,
                 edge_axis: str = None):
        super().__init__()
        self.edge_axis = check_edge_axis(edge_axis)
        self.config = config
        # The edge-list GCN reads no compute_dtype (as in JAX).
        self.compute_dtype = torch.float32
        self.hidden_size = config["hidden_size"]
        self.num_layers = config["num_timesteps"]
        self.use_bias = config["gcn_use_bias"]
        self.state_keep_prob = config["graph_state_dropout_keep_prob"]
        # The packer emits the COO list sorted by target, pads last.
        self.edges_sorted = bool(config.get("edges_sorted_by_target", True))
        self.layers = nn.ModuleList(
            GCNLayer(self.hidden_size, self.use_bias, generator)
            for _ in range(self.num_layers))

    def _check_generator(self, is_training, generator):
        if is_training and self.state_keep_prob < 1.0 and generator is None:
            raise ValueError(
                "state dropout requires a torch.Generator (is_training=True "
                "with graph_state_dropout_keep_prob < 1 and generator=None)")

    def _layer_out(self, layer_idx, mixed, is_training, generator):
        """H · W (+ b), the product's inputs in the compute dtype and its
        output f32, then ReLU and state dropout but on the last layer."""
        layer = self.layers[layer_idx]
        cdt = self.compute_dtype
        new_h = matmul_f32(mixed.to(cdt), layer.W.to(cdt))
        if self.use_bias:
            new_h = new_h + layer.b
        if layer_idx < self.num_layers - 1:
            new_h = torch.relu(new_h)
            if is_training:
                new_h = dropout(new_h, self.state_keep_prob, generator)
        return new_h

    def forward(self, batch, is_training: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """Final node representations [N, H]. Training draws its dropout
        masks from `generator`, on the batch's device."""
        self._check_generator(is_training, generator)
        if getattr(batch, "send_idx", None) is not None:
            return self._forward_node_sharded(batch, is_training, generator)
        n_cap = batch.node_capacity
        src, weights, offsets, transpose = gcn_edges(
            batch, n_cap, self.edges_sorted, self._wants_transpose())
        h = batch.node_features
        for layer_idx in range(self.num_layers):
            mixed = WeightedGatherSegmentSum.apply(h, src, weights, offsets,
                                                   n_cap, *transpose)
            h = self._layer_out(layer_idx, mixed, is_training, generator)
        return h

    def _wants_transpose(self) -> bool:
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

    def _forward_node_sharded(self, batch, is_training: bool,
                              generator: torch.Generator) -> torch.Tensor:
        """This shard's final node states [Nl, H] (JAX's
        `_forward_node_sharded`, `ggnn_tpu/models/gcn.py:88-122`): per
        layer the boundary exchange, the weighted instance over the local
        lane (against H) and over the boundary lane (against the received
        table), the two partial sums of Â[i, j]·H[j] split by the owner
        of j added, then H · W as the single-device forward."""
        nl = batch.local_node_capacity
        want = self._wants_transpose()
        l_src, l_w, l_off, l_t = weighted_lane(
            batch.loc_src, batch.loc_tgt, batch.loc_w, nl, self.edges_sorted,
            want)
        b_src, b_w, b_off, b_t = weighted_lane(
            batch.bnd_src, batch.bnd_tgt, batch.bnd_w, nl, self.edges_sorted,
            want, table_rows(batch.send_idx))
        h = batch.node_features
        for layer_idx in range(self.num_layers):
            recv = exchange_boundary(h, batch.send_idx, self.edge_axis,
                                     h.shape[-1])
            mixed = (WeightedGatherSegmentSum.apply(h, l_src, l_w, l_off, nl,
                                                    *l_t)
                     + WeightedGatherSegmentSum.apply(recv, b_src, b_w,
                                                      b_off, nl, *b_t))
            h = self._layer_out(layer_idx, mixed, is_training, generator)
        return h

    def readout(self, heads: nn.ModuleDict, task_ids, last_h: torch.Tensor,
                batch, *, keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        """Gated segment-sum pooling [K, G] (chem_tensorflow_gcn.py:84-93);
        a node shard's partial pools are summed over the edge axis."""
        node_sharded = getattr(batch, "send_idx", None) is not None
        return base.segment_readout(
            heads, task_ids, last_h, batch.node_features,
            batch.node_graph_ids, batch.graph_capacity, keep_prob=keep_prob,
            generator=generator,
            psum_axis=self.edge_axis if node_sharded else None)


class BlockedGCN(GCN):
    """GCN math over bucketed dense normalised adjacency (`gcn_blocked`):
    the same D^-1/2 (A+I) D^-1/2 as `GCN`, with Â·H as one [B, V, V] x
    [B, V, H] `torch.bmm` a layer. Consumes a DenseGraphBatch whose
    adjacency is [B, 1, V, V] (packing.preprocess_gcn_dense).

    `lane_pad` (JAX's zero-padding of H to 128 TPU lanes, skipped when
    training with state dropout) is validated as JAX validates it and
    pads nothing: the pad lanes stay zero through the linear layers and
    ReLU, so the numbers are the same either way."""

    def __init__(self, config: Dict, generator: torch.Generator):
        super().__init__(config, generator)
        self.compute_dtype = compute_dtype(config)
        self.lane_pad = resolve_lane_pad(config, self.hidden_size)

    def forward(self, batch, is_training: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """Final node representations [B, V, H]."""
        self._check_generator(is_training, generator)
        cdt = self.compute_dtype
        adjacency = batch.adjacency[:, 0].to(cdt)              # [B, V, V]
        h = batch.node_features                                # [B, V, H]
        for layer_idx in range(self.num_layers):
            h = self._layer_out(layer_idx, matmul_f32(adjacency, h.to(cdt)),
                                is_training, generator)
        return h

    def readout(self, heads: nn.ModuleDict, task_ids, last_h: torch.Tensor,
                batch, *, keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        """Gated node outputs, masked by node_mask, summed per graph."""
        return base.dense_readout(heads, task_ids, last_h,
                                  batch.node_features, batch.node_mask,
                                  keep_prob=keep_prob, generator=generator)
