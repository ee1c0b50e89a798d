"""Sparse GGNN — the serving and training model, and the R-GCN host.

Port of the single-device, type-combined-lane branch of
`ggnn_tpu/models/sparse_ggnn.py` (chem_tensorflow_sparse.py:36-376).
Per layer (`layer_timesteps` gives the layer count and per-layer step
count), each propagation step does, over the packed batch:

  1. aggregate source rows per (target, type) with the gather +
     segment-sum kernel, then one [N, T*H] x [T*H, H] transform;
  2. optional edge bias (in-degree counts x [T, H] biases) and optional
     in-degree averaging (default on);
  3. residual concatenation of earlier layers' node states
     (`residual_connections`, default {"2":[0],"4":[0,2]});
  4. RNN cell update (GRU / cuDNN-GRU / basic RNN, tanh or ReLU).

The R-GCN of README.md:48-52 is this model with RGCN_CONFIG.

Training (`is_training=True`, with a `torch.Generator`) adds TF1
dropout: on each layer's edge weights, drawn ONCE per layer and shared
by all its steps (`edge_weight_dropout_keep_prob`, the JAX model's
per-layer `rng_w`), and on the cell's new state at every step
(`graph_state_dropout_keep_prob`). When a gradient will be asked for,
the forward builds the combined lane's transpose layout once, for B2 in
every step's backward.

Not ported yet, each raising NotImplementedError with its ROADMAP item:
propagation attention (A14), the per-type and per-edge paths
(`aggregate_first: false`, `combined_edge_lanes: false`,
`edges_sorted_by_target: false`; A15), `compute_dtype: bfloat16` (A16),
and the edge-partitioned and node-sharded branches (`edge_axis`; A11).
"""

from typing import Dict

import torch
from torch import nn

from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.ops.cells import make_cell
from ggnn_tpu_torch.ops.dropout import dropout
from ggnn_tpu_torch.ops.messages import (aggregate_then_transform_combined,
                                         average_by_in_degree,
                                         combined_lane_offsets,
                                         combined_lane_transpose,
                                         edge_bias_term)
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


def _check_ported(config: Dict, edge_axis) -> None:
    unported = [
        (config["use_propagation_attention"],
         "use_propagation_attention: true", "A14"),
        (not config.get("aggregate_first", True),
         "aggregate_first: false", "A15"),
        (not config.get("combined_edge_lanes", True),
         "combined_edge_lanes: false", "A15"),
        (not config.get("edges_sorted_by_target", True),
         "edges_sorted_by_target: false", "A15"),
        (config.get("compute_dtype", "float32") != "float32",
         f"compute_dtype: {config.get('compute_dtype')}", "A16"),
        (edge_axis is not None, "edge_axis (edge-partitioned graphs)",
         "A11"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(
                f"SparseGGNN with {what} is not ported yet (ROADMAP {item})")


class SparseGGNNLayer(nn.Module):
    def __init__(self, num_edge_types: int, hidden_size: int,
                 input_size: int, new_cell, use_edge_bias: bool,
                 generator: torch.Generator):
        super().__init__()
        t, h = num_edge_types, hidden_size
        # The reference draws one glorot [T*H, H] matrix and reshapes
        # (chem_tensorflow_sparse.py:88-90) — fan-in T*H, kept.
        self.edge_weights = nn.Parameter(
            glorot_init(generator, (t * h, h)).reshape(t, h, h))
        self.cell = new_cell(input_size, h, generator)
        if use_edge_bias:
            self.edge_biases = nn.Parameter(zeros_init(generator, (t, h)))


class SparseGGNN(nn.Module):
    """`forward(batch)` -> final node states [N, H];
    `readout(heads, task_ids, last_h, batch)` -> predictions [K, G]."""

    def __init__(self, config: Dict, num_edge_types: int,
                 generator: torch.Generator, edge_axis: str = None):
        super().__init__()
        _check_ported(config, edge_axis)
        self.config = config
        self.num_edge_types = num_edge_types
        self.hidden_size = config["hidden_size"]
        self.layer_timesteps = list(config["layer_timesteps"])
        self.residual_connections = {
            int(k): list(v) for k, v in config["residual_connections"].items()
        }
        _validate_residual_connections(self.residual_connections,
                                       len(self.layer_timesteps))
        self.use_edge_bias = config["use_edge_bias"]
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
                            self.use_edge_bias, generator)
            for i in range(len(self.layer_timesteps)))

    def _layer_input_size(self, layer_idx: int) -> int:
        n_res = len(self.residual_connections.get(layer_idx, []))
        return self.hidden_size * (1 + n_res)

    def forward(self, batch: GraphBatch, is_training: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """Final node representations [N, H]. Training draws its dropout
        masks from `generator`, on the batch's device."""
        if batch.edge_sources_all is None:
            raise NotImplementedError(
                "batch has no type-combined edge lane (caps.edges_all = 0); "
                "the per-type lanes are not ported yet (ROADMAP A15)")
        n_cap = batch.node_capacity
        # The lane's CSR offsets: index preparation, once per forward.
        offsets = combined_lane_offsets(batch.edge_targets_all,
                                        batch.edge_types_all,
                                        self.num_edge_types, n_cap)
        transpose = None
        if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()):
            transpose = combined_lane_transpose(
                batch.edge_sources_all, batch.edge_types_all,
                batch.edge_targets_all, self.num_edge_types, n_cap)
        node_states_per_layer = [batch.node_features]
        for layer_idx, num_timesteps in enumerate(self.layer_timesteps):
            layer = self.layers[layer_idx]
            edge_weights = layer.edge_weights
            if is_training:
                edge_weights = dropout(edge_weights,
                                       self.edge_weight_dropout_keep_prob,
                                       generator)
            residual_states = [
                node_states_per_layer[i]
                for i in self.residual_connections.get(layer_idx, [])
            ]
            h = node_states_per_layer[-1]
            for _step in range(num_timesteps):
                incoming = aggregate_then_transform_combined(
                    h, batch.edge_sources_all, batch.edge_types_all,
                    batch.edge_targets_all, edge_weights, n_cap,
                    offsets=offsets, transpose=transpose)
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
        (chem_tensorflow_sparse.py:220-231)."""
        return base.segment_readout(
            heads, task_ids, last_h, batch.node_features,
            batch.node_graph_ids, batch.graph_capacity, keep_prob=keep_prob,
            generator=generator)
