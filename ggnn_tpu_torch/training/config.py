"""Layered configuration with the reference's exact keys and defaults.

Resolution order (chem_tensorflow.py:56-65): variant defaults <-
`--config-file` JSON <- `--config` inline JSON. The resolved dict is part
of the checkpoint contract: restore compares whole configs (except
task_ids/num_epochs), so the key set here is exactly that of
`ggnn_tpu/training/config.py` and a checkpoint written by either package
restores in the other.
"""

import copy
import json
from typing import Dict, Optional

# chem_tensorflow.py:19-37
BASE_DEFAULTS: Dict = {
    "num_epochs": 3000,
    "patience": 25,
    "learning_rate": 0.001,
    "clamp_gradient_norm": 1.0,
    "out_layer_dropout_keep_prob": 1.0,
    "hidden_size": 100,
    "num_timesteps": 4,
    "use_graph": True,
    "tie_fwd_bkwd": True,
    "task_ids": [0],
    "random_seed": 0,
    "train_file": "molecules_train.json",
    "valid_file": "molecules_valid.json",
}

# chem_tensorflow_sparse.py:40-61
SPARSE_DEFAULTS: Dict = {
    **BASE_DEFAULTS,
    "batch_size": 100000,  # nodes
    "use_edge_bias": False,
    "use_propagation_attention": False,
    "use_edge_msg_avg_aggregation": True,
    "residual_connections": {"2": [0], "4": [0, 2]},
    "layer_timesteps": [2, 2, 1, 2, 1],
    "graph_rnn_cell": "GRU",
    "graph_rnn_activation": "tanh",
    "graph_state_dropout_keep_prob": 1.0,
    "task_sample_ratios": {},
    "edge_weight_dropout_keep_prob": 0.8,
    # Extras beyond the reference surface (models/sparse_ggnn.py):
    # aggregate-before-transform (identical math by linearity) and the
    # compute dtype of the message path.
    "aggregate_first": True,
    "compute_dtype": "float32",
    # Optional keys READ but deliberately not defaulted (a new default
    # key would break the config-compat check of checkpoints written
    # before it existed): "edges_sorted_by_target" and
    # "combined_edge_lanes", the layout-contract switches read by
    # models/sparse_ggnn.py.
}

# chem_tensorflow_dense.py:56-66
DENSE_DEFAULTS: Dict = {
    **BASE_DEFAULTS,
    "batch_size": 256,  # graphs
    "graph_state_dropout_keep_prob": 1.0,
    "task_sample_ratios": {},
    "use_edge_bias": True,
    "edge_weight_dropout_keep_prob": 1,
}

# chem_tensorflow_async.py:41-57
ASYNC_DEFAULTS: Dict = {
    **BASE_DEFAULTS,
    "num_nodes": 100000,  # node budget
    "use_edge_bias": False,
    "propagation_rounds": 4,
    "propagation_substeps": 15,
    "graph_rnn_cell": "GRU",
    "graph_rnn_activation": "tanh",
    "graph_state_dropout_keep_prob": 1.0,
    "task_sample_ratios": {},
    # Optional keys READ but not defaulted (a new default key would break
    # the config check of checkpoints written before it existed):
    #   "pack_margin" (float, 1.05) — capacity headroom of the planner;
    #   "async_remat" (bool, unset = auto) — recompute each substep in the
    #       backward; auto turns it on when the estimate of the saved
    #       activations passes a sixth of the device's free memory at the
    #       first forward (2.5 GiB where the device reports none);
    #   "async_compact" (bool, True) — the segmented path for batches with
    #       a segment plan (models/async_ggnn.py);
    #   "async_epoch_shuffle" ("graphs" | "batches") — "batches" packs
    #       each split once and shuffles the batch order every epoch;
    #       "graphs" re-packs every epoch after a graph shuffle;
    #   "async_pack_cache" (bool, True) — pack each corpus through its
    #       corpus-level AsyncPackCache (data/async_schedule.py); false
    #       packs with the flat packer (the same batches, bit for bit).
}

# The JAX package's own variant: the sparse model's feature surface
# (layers, residuals, attention, averaging, cells) computed on the dense
# bucketed path (models/dense_ggnn.py, extended mode).
BLOCKED_DEFAULTS: Dict = {
    **BASE_DEFAULTS,
    "batch_size": 256,  # graphs (dense bucketed batching)
    "use_edge_bias": False,
    "use_propagation_attention": False,
    "use_edge_msg_avg_aggregation": True,
    "residual_connections": {"2": [0], "4": [0, 2]},
    "layer_timesteps": [2, 2, 1, 2, 1],
    "graph_rnn_cell": "GRU",
    "graph_rnn_activation": "tanh",
    "graph_state_dropout_keep_prob": 1.0,
    "task_sample_ratios": {},
    "edge_weight_dropout_keep_prob": 0.8,
    # Coarse buckets: the same math (padding is masked), fewer shapes.
    "dense_bucket_sizes": [8, 16, 24, 32],
}

# chem_tensorflow_gcn.py:32-40
GCN_DEFAULTS: Dict = {
    **BASE_DEFAULTS,
    "batch_size": 100000,  # nodes
    "task_sample_ratios": {},
    "gcn_use_bias": False,
    "graph_state_dropout_keep_prob": 1.0,
}

# The JAX package's own variant: GCN math (models/gcn.py:BlockedGCN) on
# the dense bucketed path.
GCN_BLOCKED_DEFAULTS: Dict = {
    **BASE_DEFAULTS,
    "batch_size": 256,  # graphs (dense bucketed batching)
    "task_sample_ratios": {},
    "gcn_use_bias": False,
    "graph_state_dropout_keep_prob": 1.0,
    # Coarse buckets: the same math (padding is masked), fewer shapes.
    "dense_bucket_sizes": [8, 16, 24, 32],
}

# README.md:48-52 — R-GCN is the sparse model under this config.
RGCN_CONFIG: Dict = {
    "use_edge_bias": False,
    "use_edge_msg_avg_aggregation": True,
    "residual_connections": {},
    "layer_timesteps": [1, 1, 1, 1, 1, 1, 1, 1],
    "graph_rnn_cell": "RNN",
    "graph_rnn_activation": "ReLU",
}

_VARIANT_DEFAULTS = {
    "sparse": SPARSE_DEFAULTS,
    "rgcn": {**SPARSE_DEFAULTS, **RGCN_CONFIG},
    "dense": DENSE_DEFAULTS,
    "blocked": BLOCKED_DEFAULTS,
    "gcn": GCN_DEFAULTS,
    "gcn_blocked": GCN_BLOCKED_DEFAULTS,
    "async": ASYNC_DEFAULTS,
}


def default_params_for(variant: str) -> Dict:
    if variant in _VARIANT_DEFAULTS:
        # DEEP copy: the defaults hold nested mutables that a caller
        # must not be able to change for every later config.
        return copy.deepcopy(_VARIANT_DEFAULTS[variant])
    raise ValueError(f"unknown model variant '{variant}'")


def resolve_config(variant: str, config_file: Optional[str] = None,
                   config_json: Optional[str] = None) -> Dict:
    params = default_params_for(variant)
    if config_file is not None:
        with open(config_file, "r") as f:
            params.update(json.load(f))
    if config_json is not None:
        params.update(json.loads(config_json))
    return params
