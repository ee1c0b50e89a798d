"""Dense GGNN over bucketed per-edge-type adjacency stacks — the `dense`
and `blocked` variants.

Port of `ggnn_tpu/models/dense_ggnn.py` (chem_tensorflow_dense.py:52-129).
A batch is B graphs of one bucket, its adjacency [B, T, V, V] oriented
A[b, t, dst, src] = 1. One propagation step, in the reassociated order
of the JAX model (reference math: acts = sum_t A_t @ (h @ W_t)):

    gathered = A2 @ h                 bmm [B, V*T, V] x [B, V, H]
    acts     = gathered @ W_cat       [B*V, T*H] x [T*H, H]
    h        = cell(acts (+ bias), h)

with A2 the adjacency transposed to (v, t) row order and W_cat the
[T, H, H] weights viewed as [T*H, H], both made once, outside the step
loop, so `gathered` reshapes to [B*V, T*H] with no per-step transpose.
The products run on cuBLAS: the JAX model computes them with
`jnp.matmul` outside any Pallas kernel, so this path has no hand kernel.

Two modes, as in JAX:

  * reference (`num_timesteps`, no `layer_timesteps` key): one TF1 tanh
    GRU shared by every step (chem_tensorflow_dense.py:88-115), per-type
    edge biases [T, 1, H] entering as indeg_t (x) b_t (hoisted), edge
    weight dropout drawn afresh at every step;
  * extended (the `blocked` variant, `layer_timesteps` present): the
    sparse model's feature surface — per-layer weights and cells (GRU,
    cuDNN-GRU, RNN; tanh or ReLU), residual connections, edge biases
    [T, H], in-degree averaging and dense propagation attention — with
    edge weight dropout drawn once per layer and shared by its steps.

Parameter names are the JAX key paths (`edge_weights`, `cell.*`,
`edge_biases`; `layers.{i}.edge_weights`, `.cell.*`, `.attention`,
`.edge_biases`), so the checkpoint bridge is a rename.

`lane_pad` (the JAX model's zero-padding of H to 128 TPU lanes) is
validated as JAX validates it and changes nothing here: the pad lanes
provably stay zero (`ggnn_tpu/ops/lanes.py:12-26`), so the padded and
the unpadded results are equal.

`compute_dtype: bfloat16` casts as the JAX model casts
(`ggnn_tpu/models/dense_ggnn.py:173-224`, `:290-316`): the adjacency (or
its attention-weighted form), the node states and W_cat go to bf16, both
products are bf16-in, f32-out (`ops/precision.py:matmul_f32`, cuBLAS on
the tensor cores), and `gathered` is cast to bf16 again before the
second. The attention scores, the cell, the biases and the readout stay
f32. The native packer gives such a model a bf16 adjacency (as JAX's
does); its in-degrees are then summed in bf16 (exact: small integers)
and promoted where they meet an f32 operand, as JAX's are.
"""

from typing import Dict

import torch
from torch import nn

from ggnn_tpu_torch.graph import DenseGraphBatch
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.models.sparse_ggnn import (
    _validate_residual_connections, compute_dtype)
from ggnn_tpu_torch.ops.cells import make_cell
from ggnn_tpu_torch.ops.dropout import dropout
from ggnn_tpu_torch.ops.precision import matmul_f32
from ggnn_tpu_torch.utils.constants import SMALL_NUMBER
from ggnn_tpu_torch.utils.init import glorot_init, ones_init, zeros_init

LANE = 128


def resolve_lane_pad(config: Dict, hidden_size: int) -> bool:
    """The `lane_pad` key: true, false or "auto" (the default: pad when
    H is off the 128-lane grid). Other values raise: bool("false") is
    True, so a typo must not pass silently (`ggnn_tpu/ops/lanes.py:126`)."""
    mode = config.get("lane_pad", "auto")
    if mode == "auto":
        return hidden_size % LANE != 0
    if not isinstance(mode, bool):
        raise ValueError(
            f"lane_pad must be true, false, or \"auto\"; got {mode!r}")
    return mode


def _promoted(x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """`x` in the type it promotes to beside `other` (a bf16 in-degree
    count meeting f32 biases becomes f32, as jnp.einsum promotes)."""
    return x.to(torch.promote_types(x.dtype, other.dtype))


def dense_attention(h: torch.Tensor, adjacency: torch.Tensor,
                    type_factors: torch.Tensor) -> torch.Tensor:
    """Attention weights [B, T, V, W]: per target v a softmax over every
    (type, source) pair with an adjacency entry, of the scores
    (h_v . h_w) * factor_t — the dense form of the sparse segment softmax
    (chem_tensorflow_sparse.py:170-196). The max is taken under
    stop-gradient and clamped at finfo.min / 2, masked lanes are zeroed
    after exp, and SMALL_NUMBER joins the denominator, so a vertex with
    no in-edge (isolated or padding) gets zeros, not NaN, forward and
    backward."""
    b, t, v, w = adjacency.shape
    scores = torch.bmm(h, h.transpose(1, 2))                  # [B, V, W]
    scores = scores[:, None] * type_factors[None, :, None, None]
    mask = adjacency > 0
    neg_inf = torch.finfo(scores.dtype).min
    flat = scores.masked_fill(~mask, neg_inf).transpose(1, 2).reshape(
        b, v, t * w)
    s_max = flat.amax(dim=-1, keepdim=True).clamp_min(neg_inf / 2).detach()
    flat_mask = mask.transpose(1, 2).reshape(b, v, t * w).to(flat.dtype)
    exped = torch.exp(flat - s_max) * flat_mask
    denom = exped.sum(dim=-1, keepdim=True) + SMALL_NUMBER
    return (exped / denom).reshape(b, v, t, w).transpose(1, 2)


def _type_major_rows(a: torch.Tensor) -> torch.Tensor:
    """[B, T, V, W] -> [B, V*T, W] in (v, t) row order: the product with
    h then views as [B*V, T*H], type blocks side by side."""
    b, t, v, w = a.shape
    return a.transpose(1, 2).reshape(b, v * t, w)


class DenseGGNNLayer(nn.Module):
    """One extended-mode layer's parameters."""

    def __init__(self, num_edge_types: int, hidden_size: int,
                 input_size: int, new_cell, use_attention: bool,
                 use_edge_bias: bool, generator: torch.Generator):
        super().__init__()
        t, h = num_edge_types, hidden_size
        # The sparse variant's init layout: one glorot [T*H, H] draw.
        self.edge_weights = nn.Parameter(
            glorot_init(generator, (t * h, h)).reshape(t, h, h))
        self.cell = new_cell(input_size, h, generator)
        if use_attention:
            self.attention = nn.Parameter(ones_init(generator, (t,)))
        if use_edge_bias:
            self.edge_biases = nn.Parameter(zeros_init(generator, (t, h)))


class DenseGGNN(nn.Module):
    """`forward(batch)` -> final node states [B, V, H];
    `readout(heads, task_ids, last_h, batch)` -> predictions [K, B]."""

    def __init__(self, config: Dict, num_edge_types: int,
                 generator: torch.Generator):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype(config)
        self.num_edge_types = num_edge_types
        self.hidden_size = h = config["hidden_size"]
        self.lane_pad = resolve_lane_pad(config, h)
        self.use_edge_bias = config["use_edge_bias"]
        self.edge_weight_dropout_keep_prob = \
            config["edge_weight_dropout_keep_prob"]
        state_keep = config["graph_state_dropout_keep_prob"]
        self.extended = "layer_timesteps" in config
        if not self.extended:
            self.num_timesteps = config["num_timesteps"]
            # The reference hard-codes a tanh GRU (dense.py:88), one cell
            # for every step.
            self.edge_weights = nn.Parameter(
                glorot_init(generator, (num_edge_types, h, h)))
            self.cell = make_cell("gru", "tanh", state_keep)(h, h, generator)
            if self.use_edge_bias:
                self.edge_biases = nn.Parameter(
                    zeros_init(generator, (num_edge_types, 1, h)))
            return
        self.layer_timesteps = list(config["layer_timesteps"])
        self.residual_connections = {
            int(k): list(v)
            for k, v in config.get("residual_connections", {}).items()
        }
        _validate_residual_connections(self.residual_connections,
                                       len(self.layer_timesteps))
        self.use_propagation_attention = config.get(
            "use_propagation_attention", False)
        self.use_edge_msg_avg_aggregation = config.get(
            "use_edge_msg_avg_aggregation", False)
        new_cell = make_cell(config.get("graph_rnn_cell", "GRU"),
                             config.get("graph_rnn_activation", "tanh"),
                             state_keep)
        self.layers = nn.ModuleList(
            DenseGGNNLayer(
                num_edge_types, h,
                h * (1 + len(self.residual_connections.get(i, []))),
                new_cell, self.use_propagation_attention,
                self.use_edge_bias, generator)
            for i in range(len(self.layer_timesteps)))

    def forward(self, batch: DenseGraphBatch, is_training: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        """Final node representations [B, V, H]. Training draws its
        dropout masks from `generator`, on the batch's device."""
        if self.extended:
            return self._forward_extended(batch, is_training, generator)
        return self._forward_reference(batch, is_training, generator)

    def _forward_reference(self, batch, is_training, generator):
        """chem_tensorflow_dense.py:93-117, reassociated (see the module
        docstring); the edge bias A_t @ (m + b_t) adds indeg_t (x) b_t,
        constant across steps."""
        h = batch.node_features
        adjacency = batch.adjacency
        b, t, v, _ = adjacency.shape
        d = h.shape[-1]
        cdt = self.compute_dtype
        a2 = _type_major_rows(adjacency).to(cdt)
        bias = None
        if self.use_edge_bias:
            indeg_t = adjacency.sum(dim=3)                     # [B, T, V]
            bias = torch.matmul(
                _promoted(indeg_t, self.edge_biases).transpose(1, 2),
                self.edge_biases[:, 0, :]).reshape(b * v, d)
        w_flat = self.edge_weights.reshape(t * d, d)
        for _step in range(self.num_timesteps):
            # A fresh mask at every step (dense.py:104); the identity
            # outside training or at keep probability 1.
            w_cat = (dropout(w_flat, self.edge_weight_dropout_keep_prob,
                             generator) if is_training else w_flat)
            gathered = matmul_f32(a2, h.to(cdt))              # [B, V*T, H]
            acts = matmul_f32(gathered.reshape(b * v, t * d).to(cdt),
                              w_cat.to(cdt))
            if bias is not None:
                acts = acts + bias
            h = self.cell(acts, h.reshape(b * v, d), is_training=is_training,
                          generator=generator).reshape(b, v, d)
        return h

    def _forward_extended(self, batch, is_training, generator):
        adjacency = batch.adjacency                            # [B, T, V, W]
        b, t, v, _ = adjacency.shape
        d = self.hidden_size
        indeg_t = adjacency.sum(dim=3)                         # [B, T, V]
        in_deg = indeg_t.sum(dim=1)                            # [B, V]
        cdt = self.compute_dtype
        a2_const = (None if self.use_propagation_attention
                    else _type_major_rows(adjacency).to(cdt))
        node_states_per_layer = [batch.node_features]
        for layer_idx, num_timesteps in enumerate(self.layer_timesteps):
            layer = self.layers[layer_idx]
            edge_weights = layer.edge_weights
            if is_training:
                # Drawn once per layer, shared by its steps.
                edge_weights = dropout(edge_weights,
                                       self.edge_weight_dropout_keep_prob,
                                       generator)
            w_cat = edge_weights.reshape(t * d, d).to(cdt)
            bias = None
            if self.use_edge_bias:
                # sum_t indeg_t[v] * bias_t, the sparse model's
                # in-degree counts @ edge_biases.
                bias = torch.matmul(
                    _promoted(indeg_t, layer.edge_biases).transpose(1, 2),
                    layer.edge_biases)                         # [B, V, H]
            residual_states = [
                node_states_per_layer[i]
                for i in self.residual_connections.get(layer_idx, [])
            ]
            h = node_states_per_layer[-1]
            for _step in range(num_timesteps):
                a2 = a2_const
                if a2 is None:
                    a2 = _type_major_rows(adjacency * dense_attention(
                        h, adjacency, layer.attention)).to(cdt)
                gathered = matmul_f32(a2, h.to(cdt))          # [B, V*T, H]
                incoming = matmul_f32(
                    gathered.reshape(b, v, t * d).to(cdt), w_cat)
                if bias is not None:
                    incoming = incoming + bias
                if self.use_edge_msg_avg_aggregation:
                    incoming = incoming / (in_deg[..., None] + SMALL_NUMBER)
                incoming_info = torch.cat(residual_states + [incoming],
                                          dim=-1)
                h = layer.cell(
                    incoming_info.reshape(b * v, incoming_info.shape[-1]),
                    h.reshape(b * v, d), is_training=is_training,
                    generator=generator).reshape(b, v, d)
            node_states_per_layer.append(h)
        return node_states_per_layer[-1]

    def readout(self, heads: nn.ModuleDict, task_ids, last_h: torch.Tensor,
                batch: DenseGraphBatch, *, keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        """Per-task graph predictions [K, B]: gated node outputs, masked
        by node_mask, summed per graph (chem_tensorflow_dense.py:119-129)."""
        return base.dense_readout(heads, task_ids, last_h,
                                  batch.node_features, batch.node_mask,
                                  keep_prob=keep_prob, generator=generator)
