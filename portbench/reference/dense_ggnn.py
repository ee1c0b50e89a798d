"""The dense GGNN of chem_tensorflow_dense.py, in plain PyTorch: per step
acts = sum_t A_t @ (h @ W_t + b_t), one GRU for every step, no dropout
(the published dense configuration keeps every weight).

Batches: the published buckets by atom count, each bucket's remainder
dropped, grouped by shape as the device epoch runs them
(`data.dense_epoch`).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import flops
from portbench.molecules import Corpus
from portbench.reference import common, data

NAME = "dense_ggnn"

# Every key of a configuration's `model`, and the values implemented.
KEYS = {
    "batch_size": common.number(1, 10**9),
    "hidden_size": common.number(1, 10**6),
    "num_timesteps": common.number(1, 10**3),
    "use_edge_bias": common.one_of(True),
    "edge_weight_dropout_keep_prob": common.one_of(1.0),
    "graph_state_dropout_keep_prob": common.one_of(1.0),
    "out_layer_dropout_keep_prob": common.one_of(1.0),
    "learning_rate": common.number(0.0, 1.0),
    "clamp_gradient_norm": common.number(1e-12, 1e12),
    "tie_fwd_bkwd": common.one_of(True),
    "task_ids": lambda v: v == [0],
    "task_sample_ratios": lambda v: v == {},
    "compute_dtype": common.one_of("float32"),
}


def parameter_shapes(model: Dict, hidden: int,
                     edge_types: int) -> Dict[str, Tuple[int, ...]]:
    shapes = {"graph.edge_weights": (edge_types, hidden, hidden),
              "graph.edge_biases": (edge_types, 1, hidden)}
    common.cell_shapes(shapes, "graph.cell", "gru", hidden, hidden)
    common.head_shapes(shapes, hidden)
    return shapes


def forward(p: common.Products, w: Dict, model: Dict,
            batch: data.DenseBatch, train: bool = False,
            gen=None) -> torch.Tensor:
    """Predictions [B] of a batch."""
    x = batch.features
    b, v, hd = x.shape
    h = x.reshape(b * v, hd)
    for _ in range(model["num_timesteps"]):
        acts = 0.0
        for t in range(w["graph.edge_weights"].shape[0]):
            m = (p.mm(h, w["graph.edge_weights"][t])
                 + w["graph.edge_biases"][t]).reshape(b, v, hd)
            acts = acts + p.mm(batch.adjacency[:, t], m)
        h = common.cell(p, w, "graph.cell", "gru", "tanh",
                        acts.reshape(b * v, hd), h)
    nodes = common.gated_nodes(p, w, h, x.reshape(b * v, hd))[:, 0]
    return (nodes.reshape(b, v) * batch.mask).sum(1)


def epoch(num_atoms: np.ndarray, model: Dict,
          random_seed: int) -> List[Tuple[np.ndarray, Optional[int]]]:
    """(molecule ids, bucket size) of each batch of the first training
    epoch, in the order the device epoch runs them."""
    return data.dense_epoch(num_atoms, model["batch_size"], random_seed)


def make_batch(corpus: Corpus, vertices: Optional[int], hidden: int,
               device) -> data.DenseBatch:
    return data.dense_batch(corpus, vertices, hidden, device)


def work(model: Dict, hidden: int, edge_types: int, stats: Dict,
         batches, train: bool) -> Dict[str, int]:
    """FLOPs of the products of `batches` (each (ids, bucket size)), as
    steps or as forwards; the dense model has no sparse aggregation."""
    total = sum(flops.dense_forward_flops(len(ids), v, edge_types, hidden,
                                          model["num_timesteps"])
                for ids, v in batches)
    return {"flops": flops.step_flops(total, train), "agg_bytes": 0}
