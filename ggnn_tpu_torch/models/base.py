"""Model-agnostic output heads, the gated segment-sum readout and the
loss.

Reproduces the reference's per-task gated regression + masked loss
(chem_tensorflow.py:133-170):

  head(task):  sigmoid(MLP_gate([h_final ‖ h_init])) * MLP_transform(h_final)
  pooled per graph by segment-sum over the packed batch's graph slots
  (sparse), or by a node-masked sum over each graph's row (dense)
  accuracy = Σ|masked diff| / (Σ mask + ε)            # masked MAE
  loss     = Σ 0.5 · (masked diff)² / (Σ mask + ε)    # per task, then
             × 1 / (task_sample_ratios.get(task_id) or 1.0), summed

The rescale looks the ratio up by *integer* task id
(chem_tensorflow.py:168) while the samplers blank labels by *string* id,
a reference quirk kept as `ggnn_tpu/models/base.py:12-16` keeps it (JSON
configs always produce string keys, so the rescale is 1.0 for them).
In training the heads' weight matrices go through TF1 dropout with
`out_layer_dropout_keep_prob`.

`ModelParams` is the root of a model's parameters, the counterpart of the
JAX state tree's `params` entry: `graph` (the propagation model) and
`heads`. Its parameter names are the JAX key paths written with dots
(`graph.layers.0.cell.gates_kernel` is
`['params']['graph']['layers'][0]['cell']['gates_kernel']`), which is
what the checkpoint bridge relies on (training/checkpoint.py).
"""

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from ggnn_tpu_torch.ops.mlp import mlp_apply, mlp_init
from ggnn_tpu_torch.ops.segment import segment_sum
from ggnn_tpu_torch.utils.constants import SMALL_NUMBER


class ModelParams(nn.Module):
    def __init__(self, graph: nn.Module, heads: nn.ModuleDict):
        super().__init__()
        self.graph = graph
        self.heads = heads


def init_output_heads(generator: torch.Generator, hidden_size: int,
                      task_ids: Sequence[int]) -> nn.ModuleDict:
    """One gate + transform MLP pair per task (chem_tensorflow.py:149-157).

    Defaults are single linear layers: gate sees [h_final ‖ h_init] (2H),
    transform sees h_final (H); both map to 1.
    """
    heads = nn.ModuleDict()
    for task_id in task_ids:
        heads[f"task{task_id}"] = nn.ModuleDict({
            "gate": mlp_init(generator, 2 * hidden_size, 1),
            "transform": mlp_init(generator, hidden_size, 1),
        })
    return heads


def gated_regression_nodes(head: nn.ModuleDict, last_h: torch.Tensor,
                           initial_h: torch.Tensor, *,
                           keep_prob: float = 1.0,
                           generator: torch.Generator = None
                           ) -> torch.Tensor:
    """Per-node gated output [..., 1]."""
    gate_input = torch.cat([last_h, initial_h], dim=-1)
    gate = torch.sigmoid(mlp_apply(head["gate"], gate_input,
                                   keep_prob=keep_prob, generator=generator))
    transform = mlp_apply(head["transform"], last_h, keep_prob=keep_prob,
                          generator=generator)
    return gate * transform


def pool_nodes_to_graphs(gated: torch.Tensor, node_graph_ids: torch.Tensor,
                         graph_capacity: int) -> torch.Tensor:
    """Segment-sum node outputs into graph scalars [G]. Padded nodes carry
    the dump graph id `graph_capacity`; that extra segment is dropped."""
    pooled = segment_sum(gated, node_graph_ids, graph_capacity + 1)
    return pooled[:graph_capacity, 0]


def segment_readout(heads: nn.ModuleDict, task_ids, last_h: torch.Tensor,
                    init_features: torch.Tensor,
                    node_graph_ids: torch.Tensor, graph_capacity: int, *,
                    keep_prob: float = 1.0,
                    generator: torch.Generator = None) -> torch.Tensor:
    """Per-task gated segment-sum pooling [K, G] — the readout of the
    edge-list variants. The JAX package's `psum_axis` (node-sharded
    batches) waits for multi-GPU (ROADMAP A11)."""
    outs = []
    for task_id in task_ids:
        gated = gated_regression_nodes(heads[f"task{task_id}"], last_h,
                                       init_features, keep_prob=keep_prob,
                                       generator=generator)
        outs.append(pool_nodes_to_graphs(gated, node_graph_ids,
                                         graph_capacity))
    return torch.stack(outs, dim=0)


def dense_readout(heads: nn.ModuleDict, task_ids, last_h: torch.Tensor,
                  init_features: torch.Tensor, node_mask: torch.Tensor, *,
                  keep_prob: float = 1.0,
                  generator: torch.Generator = None) -> torch.Tensor:
    """Per-task gated masked-sum pooling [K, B] — the readout of the
    dense-path variants (chem_tensorflow_dense.py:119-129): padded
    vertices, and the all-zero rows past `num_graphs`, carry node_mask 0."""
    b, v, d = last_h.shape
    flat_last = last_h.reshape(b * v, d)
    flat_init = init_features.reshape(b * v, d)
    outs = []
    for task_id in task_ids:
        gated = gated_regression_nodes(heads[f"task{task_id}"], flat_last,
                                       flat_init, keep_prob=keep_prob,
                                       generator=generator)   # [B*V, 1]
        outs.append((gated.reshape(b, v) * node_mask).sum(dim=1))
    return torch.stack(outs, dim=0)


def task_rescale(task_ids: Sequence[int], task_sample_ratios: Dict,
                 device) -> torch.Tensor:
    """The per-task loss weights [K], 1 / the task's sample ratio (ratios
    looked up by integer task id), on `device`."""
    return torch.tensor(
        [1.0 / (task_sample_ratios.get(task_id) or 1.0)
         for task_id in task_ids],
        dtype=torch.float32, device=device)


def masked_regression_loss(computed: torch.Tensor, targets: torch.Tensor,
                           target_mask: torch.Tensor,
                           task_ids: Sequence[int],
                           task_sample_ratios: Dict,
                           rescale: torch.Tensor = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total loss [] and per-task masked MAE [K] over a [K, G] prediction
    block. `rescale` is `task_rescale(task_ids, task_sample_ratios,
    computed.device)`, made here when None: a caller that steps many
    times passes it, since making it copies from the host, which a CUDA
    graph capture refuses."""
    diff = (computed - targets) * target_mask
    task_target_num = target_mask.sum(dim=1) + SMALL_NUMBER
    accuracies = diff.abs().sum(dim=1) / task_target_num
    task_losses = (0.5 * diff.square()).sum(dim=1) / task_target_num
    if rescale is None:
        rescale = task_rescale(task_ids, task_sample_ratios, computed.device)
    return (task_losses * rescale).sum(), accuracies
