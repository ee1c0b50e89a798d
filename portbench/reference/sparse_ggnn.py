"""The sparse GGNN of chem_tensorflow_sparse.py, in plain PyTorch.

Per layer, its [T, H, H] edge weights (under training dropout, one mask a
layer), and per step every message h[src] @ W[type] summed into its
target; with `use_edge_bias` each target adds its per-type in-degrees @
the layer's [T, H] biases; with `use_edge_msg_avg_aggregation` the sum
is divided by the target's in-degree + SMALL_NUMBER. The layer's
residual states and the messages, concatenated, are the input of its
cell (GRU or RNN, tanh or ReLU) with h.

Batches: the published pipeline's greedy packing under the node budget
(`data.sparse_epoch`, `data.pack_greedy`).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import flops
from portbench.molecules import Corpus
from portbench.reference import common, data

NAME = "sparse_ggnn"

# Every key of a configuration's `model`, and the values implemented.
KEYS = {
    "batch_size": common.number(1, 10**9),
    "hidden_size": common.number(1, 10**6),
    "layer_timesteps": lambda v: (isinstance(v, list) and len(v) > 0
                                  and all(isinstance(s, int) and s > 0
                                          for s in v)),
    "residual_connections": lambda v: isinstance(v, dict),
    "graph_rnn_cell": common.one_of("GRU", "RNN"),
    "graph_rnn_activation": common.one_of("tanh", "ReLU"),
    "use_edge_bias": common.one_of(True, False),
    "use_edge_msg_avg_aggregation": common.one_of(True, False),
    "use_propagation_attention": common.one_of(False),
    "edge_weight_dropout_keep_prob": common.number(1e-6, 1.0),
    "graph_state_dropout_keep_prob": common.one_of(1.0),
    "out_layer_dropout_keep_prob": common.one_of(1.0),
    "learning_rate": common.number(0.0, 1.0),
    "clamp_gradient_norm": common.number(1e-12, 1e12),
    "tie_fwd_bkwd": common.one_of(True),
    "task_ids": lambda v: v == [0],
    "task_sample_ratios": lambda v: v == {},
    "compute_dtype": common.one_of("float32"),
}


def _layer_inputs(model: Dict, layer: int, hidden: int) -> int:
    return hidden * (1 + len(model["residual_connections"].get(str(layer),
                                                               [])))


def parameter_shapes(model: Dict, hidden: int,
                     edge_types: int) -> Dict[str, Tuple[int, ...]]:
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i in range(len(model["layer_timesteps"])):
        shapes[f"graph.layers.{i}.edge_weights"] = (edge_types, hidden,
                                                    hidden)
        common.cell_shapes(shapes, f"graph.layers.{i}.cell",
                           model["graph_rnn_cell"],
                           _layer_inputs(model, i, hidden), hidden)
        if model["use_edge_bias"]:
            shapes[f"graph.layers.{i}.edge_biases"] = (edge_types, hidden)
    common.head_shapes(shapes, hidden)
    return shapes


def forward(p: common.Products, w: Dict, model: Dict,
            batch: data.SparseBatch, train: bool = False,
            gen=None) -> torch.Tensor:
    """Predictions [G] of a batch."""
    x = batch.features
    n, hd = x.shape
    t_dim = w["graph.layers.0.edge_weights"].shape[0]
    by_type = [(batch.etype == t).nonzero().squeeze(1) for t in range(t_dim)]
    type_deg = torch.zeros(n, t_dim, device=x.device)
    type_deg.index_put_((batch.dst, batch.etype),
                        torch.ones_like(batch.dst, dtype=torch.float32),
                        accumulate=True)
    in_deg = type_deg.sum(1)
    residuals = model["residual_connections"]
    states = [x]
    for i, steps in enumerate(model["layer_timesteps"]):
        weights = w[f"graph.layers.{i}.edge_weights"]
        if train:
            weights = common.dropout(
                weights, model["edge_weight_dropout_keep_prob"], gen)
        res = [states[j] for j in residuals.get(str(i), [])]
        h = states[-1]
        for _ in range(steps):
            incoming = torch.zeros(n, hd, device=x.device)
            for t, edges in enumerate(by_type):
                msg = p.mm(h[batch.src[edges]], weights[t])
                incoming = incoming.index_add(0, batch.dst[edges], msg)
            if model["use_edge_bias"]:
                incoming = incoming + p.mm(type_deg,
                                           w[f"graph.layers.{i}.edge_biases"])
            if model["use_edge_msg_avg_aggregation"]:
                incoming = incoming / (in_deg[:, None] + common.SMALL_NUMBER)
            h = common.cell(p, w, f"graph.layers.{i}.cell",
                            model["graph_rnn_cell"],
                            model["graph_rnn_activation"],
                            torch.cat(res + [incoming], -1), h)
        states.append(h)
    nodes = common.gated_nodes(p, w, states[-1], x)[:, 0]
    return torch.zeros(batch.num_graphs, device=x.device).index_add(
        0, batch.graph_of, nodes)


def epoch(num_atoms: np.ndarray, model: Dict,
          random_seed: int) -> List[Tuple[np.ndarray, Optional[int]]]:
    """(molecule ids, None) of each batch of the first training epoch."""
    return [(ids, None) for ids in data.sparse_epoch(
        num_atoms, model["batch_size"], random_seed)]


def pack(num_atoms: np.ndarray, ids: np.ndarray,
         node_budget: int) -> List[Tuple[np.ndarray, Optional[int]]]:
    """`ids` in batches whose atoms stay under `node_budget`."""
    return [(b, None) for b in data.pack_greedy(num_atoms, ids, node_budget)]


def make_batch(corpus: Corpus, vertices: Optional[int], hidden: int,
               device) -> data.SparseBatch:
    return data.sparse_batch(corpus, hidden, device)


def work(model: Dict, hidden: int, edge_types: int, stats: Dict,
         batches, train: bool) -> Dict[str, int]:
    """FLOPs of the products and bytes of the aggregations of `batches`
    (each (ids, None)), as steps or as forwards: each step's forward
    aggregations (B1) and, in training, the transposes (B2) of all but
    the first step's (whose input, the annotations, needs no
    gradient)."""
    ids = np.concatenate([b for b, _ in batches]) if batches else \
        np.zeros(0, np.int64)
    atoms = int(stats["atoms"][ids].sum())
    edges = int(stats["edges"][ids].sum())
    used = int(stats["segments_used"][ids].sum())
    forward = flops.sparse_forward_flops(model, hidden, edge_types, atoms,
                                         edges)
    agg = flops.aggregation_bytes(atoms, edges, used, len(batches),
                                  edge_types, hidden)
    steps = sum(model["layer_timesteps"])
    agg_bytes = steps * agg["forward"]
    if train:
        agg_bytes += (steps - 1) * agg["transpose"]
    return {"flops": flops.step_flops(forward, train),
            "agg_bytes": agg_bytes}
