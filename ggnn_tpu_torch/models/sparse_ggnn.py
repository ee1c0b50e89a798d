"""Sparse GGNN — the serving and training model, and the R-GCN host.

Port of the single-device branch of `ggnn_tpu/models/sparse_ggnn.py`
(chem_tensorflow_sparse.py:36-376). Per layer (`layer_timesteps` gives
the layer count and per-layer step count), each propagation step does,
over the packed batch:

  1. optional propagation attention: per-edge <src, tgt> scores scaled
     by the layer's per-type factors, segment-softmaxed over each
     target's incoming edges (chem_tensorflow_sparse.py:170-196);
  2. the typed messages aggregated into their targets, on one of three
     routes chosen as the JAX model chooses them: aggregate-then-transform
     over the type-combined lane (the default, when the batch has the
     lane and `aggregate_first` and `edges_sorted_by_target` are on),
     over the per-type lanes (`combined_edge_lanes: false`, a batch
     without the lane, or `edges_sorted_by_target: false`, whose lanes
     are sorted by target once per forward), or per edge, transform
     before aggregation (`aggregate_first: false`);
  3. optional edge bias (in-degree counts x [T, H] biases) and optional
     in-degree averaging (default on);
  4. residual concatenation of earlier layers' node states
     (`residual_connections`, default {"2":[0],"4":[0,2]});
  5. RNN cell update (GRU / cuDNN-GRU / basic RNN, tanh or ReLU).

The R-GCN of README.md:48-52 is this model with RGCN_CONFIG.

Training (`is_training=True`, with a `torch.Generator`) adds TF1
dropout: on each layer's edge weights, drawn ONCE per layer and shared
by all its steps (`edge_weight_dropout_keep_prob`, the JAX model's
per-layer `rng_w`), and on the cell's new state at every step
(`graph_state_dropout_keep_prob`). The attention factors are not
dropped. The forward's index preparation (`ops/messages.py:EdgeLanes`:
CSR offsets, sorts, transposes) is made once and reused by every step.

`compute_dtype: bfloat16` runs the message path in bf16 as the JAX model
does (`ggnn_tpu/models/sparse_ggnn.py:211-259`): each layer's (dropped)
edge weights are cast to bf16 once, the node states at every step; the
gathers, segment sums and attention-weighted sums run on the kernels'
bf16 instances (f32 sums, each output rounded once), the transform is a
bf16-in, f32-out product (`ops/precision.py`), the attention scores and
softmax are f32 and the weights cast to bf16 on the aggregate-first
routes, and the incoming messages are cast back to f32 before the edge
bias, the averaging and the cell. Parameters, the cell, the readout and
the loss stay f32.

On a mesh (parallel/, ROADMAP A11) the model is built with `edge_axis`,
the mesh's edge `Axis`, and runs the JAX model's two edge-axis branches:

  * a node-sharded batch (parallel/node_shard.py) takes
    `_forward_node_sharded`: per step the boundary exchange, then B1 over
    the local lane (h[loc_src] by loc_tgt*T + loc_type) and over the
    boundary lane (the received table), the two [Nl*T, H] sums added and
    transformed; under attention the two lanes' scores share one
    segment softmax. The readout sums its partial pools over the axis;
  * a plain batch is type-TP (parallel/tp.py): this rank's [T/P, H, H]
    weights over its T/P per-type lanes (the combined lane is off), the
    node states entering through `copy_to_shards` and the incoming sums
    completed by `reduce_to_replicated` before the replicated bias,
    averaging and cell. Edge-weight dropout draws the whole [T, H, H]
    mask from the generator the edge ranks share and keeps this rank's
    slice, so every type's mask is its own (JAX folds the edge index
    into the key for the same end).
"""

from typing import Dict

import torch
from torch import nn

from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.ops.attention import EdgeDot
from ggnn_tpu_torch.ops.cells import make_cell
from ggnn_tpu_torch.ops.dropout import dropout
from ggnn_tpu_torch.ops.messages import (
    EdgeLanes, aggregate_lanes, aggregate_messages,
    aggregate_then_transform, aggregate_then_transform_combined,
    average_by_in_degree, edge_bias_term,
    propagation_attention, propagation_attention_weights,
    propagation_attention_weights_combined, sort_typed_lanes,
    typed_edge_messages)
from ggnn_tpu_torch.ops.precision import matmul_f32
from ggnn_tpu_torch.ops.segment import (segment_softmax, sorted_gather,
                                        sorted_segments)
from ggnn_tpu_torch.parallel.collectives import (copy_to_shards,
                                                 reduce_to_replicated)
from ggnn_tpu_torch.parallel.mesh import Axis
from ggnn_tpu_torch.parallel.node_shard import (exchange_boundary,
                                                table_rows)
from ggnn_tpu_torch.parallel.tp import type_range
from ggnn_tpu_torch.utils.constants import SMALL_NUMBER
from ggnn_tpu_torch.utils.init import glorot_init, zeros_init


def _validate_residual_connections(residuals: Dict, n_layers: int) -> None:
    """Config-time validation: a residual source must be an EARLIER
    layer state (index 0 = the input annotations, k = layer k-1's
    output; at layer k indices 0..k exist). Layer KEYS beyond the layer
    count stay silently ignored — reference parity: the default config
    carries {"2":[0],"4":[0,2]}, and overriding layer_timesteps alone
    must not error."""
    for k, lst in residuals.items():
        if k < 0:
            raise ValueError(f"residual_connections layer key {k} < 0")
        if k >= n_layers:
            continue  # reference behavior: unknown layers are ignored
        for i in lst:
            if not 0 <= i <= k:
                raise ValueError(
                    f"residual_connections[{k}] references layer state "
                    f"{i}; valid sources at layer {k} are [0, {k}] "
                    "(earlier layers only)")


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config: Dict) -> torch.dtype:
    """The `compute_dtype` key ("float32", the default, or "bfloat16")
    as a torch dtype; other values raise, as `jnp.dtype` does for a name
    it does not know."""
    name = config.get("compute_dtype", "float32")
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(_COMPUTE_DTYPES)}, got {name!r}")
    return _COMPUTE_DTYPES[name]


class SparseGGNNLayer(nn.Module):
    def __init__(self, num_edge_types: int, hidden_size: int,
                 input_size: int, new_cell, use_edge_bias: bool,
                 use_attention: bool, generator: torch.Generator):
        super().__init__()
        t, h = num_edge_types, hidden_size
        # The reference draws one glorot [T*H, H] matrix and reshapes
        # (chem_tensorflow_sparse.py:88-90) — fan-in T*H, kept.
        self.edge_weights = nn.Parameter(
            glorot_init(generator, (t * h, h)).reshape(t, h, h))
        self.cell = new_cell(input_size, h, generator)
        if use_attention:
            # Per-type score factors, initialised to ones as the JAX
            # model's init_params does.
            self.attention = nn.Parameter(torch.ones(t))
        if use_edge_bias:
            self.edge_biases = nn.Parameter(zeros_init(generator, (t, h)))


def check_edge_axis(edge_axis):
    """`edge_axis` as a model takes it: None, or the mesh's edge `Axis`
    (`mesh.axis(EDGE_AXIS)`), whose process group the model's collectives
    run over. JAX's models take the axis's name; a name alone names no
    group here, so it raises."""
    if edge_axis is not None and not isinstance(edge_axis, Axis):
        raise TypeError(
            f"edge_axis must be a mesh Axis (mesh.axis('edge')), got "
            f"{edge_axis!r}")
    return edge_axis


class SparseGGNN(nn.Module):
    """`forward(batch)` -> final node states [N, H] ([Nl, H] of a node
    shard); `readout(heads, task_ids, last_h, batch)` -> predictions
    [K, G]."""

    def __init__(self, config: Dict, num_edge_types: int,
                 generator: torch.Generator, edge_axis: str = None):
        super().__init__()
        self.edge_axis = check_edge_axis(edge_axis)
        self.config = config
        self.compute_dtype = compute_dtype(config)
        self.num_edge_types = num_edge_types
        self.hidden_size = config["hidden_size"]
        self.layer_timesteps = list(config["layer_timesteps"])
        self.residual_connections = {
            int(k): list(v) for k, v in config["residual_connections"].items()
        }
        _validate_residual_connections(self.residual_connections,
                                       len(self.layer_timesteps))
        self.use_edge_bias = config["use_edge_bias"]
        self.use_propagation_attention = config["use_propagation_attention"]
        self.aggregate_first = bool(config.get("aggregate_first", True))
        self.edges_sorted = bool(config.get("edges_sorted_by_target", True))
        self.combined_lanes = bool(config.get("combined_edge_lanes", True))
        self.use_edge_msg_avg_aggregation = \
            config["use_edge_msg_avg_aggregation"]
        self.edge_weight_dropout_keep_prob = \
            config["edge_weight_dropout_keep_prob"]
        new_cell = make_cell(config["graph_rnn_cell"],
                                 config["graph_rnn_activation"],
                                 config["graph_state_dropout_keep_prob"])
        self.layers = nn.ModuleList(
            SparseGGNNLayer(num_edge_types, self.hidden_size,
                            self._layer_input_size(i), new_cell,
                            self.use_edge_bias,
                            self.use_propagation_attention, generator)
            for i in range(len(self.layer_timesteps)))

    def _layer_input_size(self, layer_idx: int) -> int:
        n_res = len(self.residual_connections.get(layer_idx, []))
        return self.hidden_size * (1 + n_res)

    def forward(self, batch: GraphBatch, is_training: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """Final node representations [N, H]. Training draws its dropout
        masks from `generator`, on the batch's device."""
        if getattr(batch, "send_idx", None) is not None:
            return self._forward_node_sharded(batch, is_training, generator)
        n_cap = batch.node_capacity
        axis = self.edge_axis
        # JAX's routing (ggnn_tpu/models/sparse_ggnn.py:214-258): the
        # combined lane only when the batch has it, `aggregate_first` is
        # on and the lanes are target-sorted (its sums assume the order);
        # never under type-TP, which shards the per-type lanes.
        use_combined = (self.combined_lanes
                        and batch.edge_sources_all is not None
                        and axis is None
                        and self.aggregate_first and self.edges_sorted)
        src, tgt, mask = batch.edge_sources, batch.edge_targets, \
            batch.edge_mask
        if use_combined:
            lanes = EdgeLanes.combined(
                batch.edge_sources_all, batch.edge_types_all,
                batch.edge_targets_all, self.num_edge_types, n_cap)
        else:
            if self.aggregate_first and not self.edges_sorted:
                tgt, src, mask = sort_typed_lanes(tgt, src, mask)
            lanes = EdgeLanes.typed(src, tgt, n_cap)
        cdt = self.compute_dtype
        node_states_per_layer = [batch.node_features]
        for layer_idx, num_timesteps in enumerate(self.layer_timesteps):
            layer = self.layers[layer_idx]
            edge_weights = layer.edge_weights
            if is_training:
                edge_weights = self._dropped(edge_weights, generator)
            w_c = edge_weights.to(cdt)
            residual_states = [
                node_states_per_layer[i]
                for i in self.residual_connections.get(layer_idx, [])
            ]
            h = node_states_per_layer[-1]
            for _step in range(num_timesteps):
                h_c = h.to(cdt)
                if axis is not None:
                    h_c = copy_to_shards(h_c, axis)
                attn = None
                if use_combined:
                    if self.use_propagation_attention:
                        attn = propagation_attention_weights_combined(
                            h_c, batch.edge_sources_all,
                            batch.edge_targets_all, batch.edge_mask_all,
                            batch.edge_types_all, layer.attention, n_cap,
                            lanes).to(cdt)
                    incoming = aggregate_then_transform_combined(
                        h_c, batch.edge_sources_all, batch.edge_types_all,
                        batch.edge_targets_all, w_c, n_cap, attn, lanes)
                elif self.aggregate_first:
                    if self.use_propagation_attention:
                        attn = propagation_attention_weights(
                            h_c, src, tgt, mask, layer.attention, n_cap,
                            edge_axis=axis, lanes=lanes).to(cdt)
                    incoming = aggregate_then_transform(
                        h_c, src, tgt, w_c, n_cap, attn,
                        targets_sorted=True, lanes=lanes)
                else:
                    messages = typed_edge_messages(h_c, src, w_c, lanes)
                    if self.use_propagation_attention:
                        messages = propagation_attention(
                            messages, h_c, src, tgt, mask, layer.attention,
                            n_cap, edge_axis=axis, lanes=lanes)
                    incoming = aggregate_messages(messages, tgt, n_cap,
                                                  lanes)
                incoming = incoming.to(torch.float32)
                if axis is not None:
                    # Type-TP: each rank summed its own types' messages.
                    incoming = reduce_to_replicated(incoming, axis)
                if self.use_edge_bias:
                    incoming = incoming + edge_bias_term(
                        batch.in_degrees, layer.edge_biases)
                if self.use_edge_msg_avg_aggregation:
                    incoming = average_by_in_degree(incoming,
                                                    batch.in_degrees)
                incoming_info = torch.cat(residual_states + [incoming],
                                          dim=-1)
                h = layer.cell(incoming_info, h, is_training=is_training,
                               generator=generator)
            node_states_per_layer.append(h)
        return node_states_per_layer[-1]

    def _dropped(self, edge_weights, generator):
        """The layer's edge weights under TF1 dropout. Under type-TP the
        whole [T, H, H] mask is drawn and this rank's slice kept."""
        keep = self.edge_weight_dropout_keep_prob
        if self.edge_axis is None or keep >= 1.0:
            return dropout(edge_weights, keep, generator)
        full = (self.num_edge_types,) + tuple(edge_weights.shape[1:])
        mask = dropout(edge_weights.new_ones(full), keep, generator)
        return edge_weights * mask[type_range(self.num_edge_types,
                                              self.edge_axis)]

    def _forward_node_sharded(self, batch, is_training: bool,
                              generator: torch.Generator) -> torch.Tensor:
        """This shard's final node states [Nl, H] (JAX's
        `_forward_node_sharded`, `ggnn_tpu/models/sparse_ggnn.py:282-384`).

        Per step: the exchange of the boundary rows (`exchange_boundary`),
        B1 over the local lane against h and over the boundary lane
        against the received table, both into the composite segments
        target*T + type of the shard's Nl rows; the two [Nl*T, H] sums
        added, viewed [Nl, T*H] and multiplied by the [T*H, H] weights;
        then the bias, the averaging and the cell, all local. With
        attention the two lanes' scores (edge_dot, the boundary lane's
        sources read from the table) share one segment softmax over the
        shard's targets, and each lane is aggregated by the weighted
        instance."""
        nl = batch.local_node_capacity
        t_dim = self.num_edge_types
        axis, cdt = self.edge_axis, self.compute_dtype
        loc = EdgeLanes.combined(batch.loc_src, batch.loc_type,
                                 batch.loc_tgt, t_dim, nl)
        bnd = EdgeLanes.combined(batch.bnd_src, batch.bnd_type,
                                 batch.bnd_tgt, t_dim, nl,
                                 num_sources=table_rows(batch.send_idx))
        el = batch.loc_src.shape[0]
        if self.use_propagation_attention:
            # One softmax over both lanes' targets (two sorted runs),
            # sorted once a forward.
            joint_tgt = torch.cat([batch.loc_tgt, batch.bnd_tgt])
            joint = sorted_segments(joint_tgt, nl + 1)
            joint_mask = torch.cat([batch.loc_mask, batch.bnd_mask])
        node_states_per_layer = [batch.node_features]
        for layer_idx, num_timesteps in enumerate(self.layer_timesteps):
            layer = self.layers[layer_idx]
            edge_weights = layer.edge_weights
            if is_training:
                edge_weights = dropout(edge_weights,
                                       self.edge_weight_dropout_keep_prob,
                                       generator)
            w_c = edge_weights.to(cdt)
            residual_states = [
                node_states_per_layer[i]
                for i in self.residual_connections.get(layer_idx, [])
            ]
            h = node_states_per_layer[-1]
            h_dim = h.shape[-1]
            for _step in range(num_timesteps):
                h_c = h.to(cdt)
                recv = exchange_boundary(h_c, batch.send_idx, axis, h_dim)
                attn_l = attn_b = None
                if self.use_propagation_attention:
                    scores = torch.cat([
                        _lane_scores(h_c, h_c, loc, layer.attention),
                        _lane_scores(recv, h_c, bnd, layer.attention)])
                    attn = segment_softmax(scores, joint_tgt, nl + 1,
                                           joint_mask, SMALL_NUMBER,
                                           layout=joint).to(cdt)
                    attn_l, attn_b = attn[:el], attn[el:]
                per = (aggregate_lanes(h_c, loc, attn_l)
                       + aggregate_lanes(recv, bnd, attn_b))   # [Nl*T, H]
                incoming = matmul_f32(
                    per.view(nl, t_dim * h_dim),
                    w_c.reshape(t_dim * h_dim, w_c.shape[-1]))
                if self.use_edge_bias:
                    incoming = incoming + edge_bias_term(
                        batch.in_degrees, layer.edge_biases)
                if self.use_edge_msg_avg_aggregation:
                    incoming = average_by_in_degree(incoming,
                                                    batch.in_degrees)
                incoming_info = torch.cat(residual_states + [incoming],
                                          dim=-1)
                h = layer.cell(incoming_info, h, is_training=is_training,
                               generator=generator)
            node_states_per_layer.append(h)
        return node_states_per_layer[-1]

    def readout(self, heads: nn.ModuleDict, task_ids, last_h: torch.Tensor,
                batch: GraphBatch, *, keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        """Per-task graph predictions [K, G] via gated segment-sum pooling
        (chem_tensorflow_sparse.py:220-231); a node shard's partial pools
        are summed over the edge axis."""
        node_sharded = getattr(batch, "send_idx", None) is not None
        return base.segment_readout(
            heads, task_ids, last_h, batch.node_features,
            batch.node_graph_ids, batch.graph_capacity, keep_prob=keep_prob,
            generator=generator,
            psum_axis=self.edge_axis if node_sharded else None)


def _lane_scores(x, y, lanes: EdgeLanes, factors):
    """<x[src], y[tgt]> of a node shard's lane (kernel `edge_dot`; a pad,
    whose target is the dump row Nl, scores 0 and is masked out of the
    softmax) times each edge's type factor."""
    grad = torch.is_grad_enabled()
    dots = EdgeDot.apply(x, lanes.src, y, lanes.tgt,
                         lanes.source_pairs if grad and x.requires_grad
                         else None,
                         lanes.target_pairs if grad and y.requires_grad
                         else None)
    return dots * sorted_gather(factors, lanes.types, lanes.type_segments)
