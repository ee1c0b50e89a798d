"""Import weights from the reference TF1 implementation: the port's
numpy-only copy of `ggnn_tpu/compat/tf1.py`.

The reference checkpoints (chem_tensorflow.py:309-323) are pickles of
`{"params": config, "weights": {tf_variable_name: ndarray}, ...}`. This
module converts such a name->ndarray dict into the JAX package's params
pytree of float32 numpy arrays, {'graph': ..., 'heads': ...}, which
`training/checkpoint.py:weights_from_tree` names by their JAX key paths
for `params_from_jax_weights` to load into a `ModelParams`:
reference-trained models serve (serving.py) and keep training
(training/runner.py) in the port.

Variable naming observed from the reference graphs:
  sparse (chem_tensorflow_sparse.py:63-115):
    graph_model/gnn_layer_{i}/gnn_edge_weights_{i}            [T*H, H]
    graph_model/gnn_layer_{i}/edge_type_attention_weights_{i} [T]
    graph_model/gnn_layer_{i}/gnn_edge_biases_{i}             [T, H]
    graph_model/gnn_layer_{i}/timestep_0/gru_cell/gates/kernel      [I+H, 2H]
    graph_model/gnn_layer_{i}/timestep_0/gru_cell/gates/bias        [2H]
    graph_model/gnn_layer_{i}/timestep_0/gru_cell/candidate/kernel  [I+H, H]
    graph_model/gnn_layer_{i}/timestep_0/gru_cell/candidate/bias    [H]
    (BasicRNNCell: .../timestep_0/basic_rnn_cell/{kernel,bias})
  dense (chem_tensorflow_dense.py:68-91):
    graph_model/Variable        [T, H, H]   (edge weights)
    graph_model/Variable_1      [T, 1, H]   (edge biases)
    graph_model/gru_scope/gru_cell/{gates,candidate}/{kernel,bias}
  gcn (chem_tensorflow_gcn.py:42-66):
    graph_model/gcn_scope/gcn_weights_{i} [H, H], gcn_bias_{i} [H]
  heads (chem_tensorflow.py:149-157, utils.py:50-53):
    out_layer_task{k}/regression_gate/MLP_W_layer{j}, MLP_b_layer{j}
    out_layer_task{k}/regression/MLP_W_layer{j}, MLP_b_layer{j}
"""

import pickle
from typing import Dict, List, Sequence

import numpy as np


def _norm(weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip the ':0' tensor suffix TF appends to variable names."""
    return {k.split(":")[0]: np.asarray(v) for k, v in weights.items()}


def _a(weights: Dict[str, np.ndarray], name: str) -> np.ndarray:
    if name not in weights:
        raise KeyError(
            f"TF1 weight '{name}' not found; available: "
            f"{sorted(weights)[:8]}...")
    return np.asarray(weights[name], np.float32)


def _cell_from_tf1(weights, scope: str, cell_type: str) -> Dict:
    ct = cell_type.lower()
    if ct in ("gru", "cudnncompatiblegrucell"):
        prefix = f"{scope}/gru_cell"
        if ct == "cudnncompatiblegrucell":
            prefix = f"{scope}/cudnn_compatible_gru_cell"
            return {
                "gates_kernel": _a(weights, f"{prefix}/gates/kernel"),
                "gates_bias": _a(weights, f"{prefix}/gates/bias"),
                "candidate_input_kernel": _a(
                    weights, f"{prefix}/candidate/input_projection/kernel"),
                "candidate_input_bias": _a(
                    weights, f"{prefix}/candidate/input_projection/bias"),
                "candidate_hidden_kernel": _a(
                    weights, f"{prefix}/candidate/hidden_projection/kernel"),
                "candidate_hidden_bias": _a(
                    weights, f"{prefix}/candidate/hidden_projection/bias"),
            }
        return {
            "gates_kernel": _a(weights, f"{prefix}/gates/kernel"),
            "gates_bias": _a(weights, f"{prefix}/gates/bias"),
            "candidate_kernel": _a(weights, f"{prefix}/candidate/kernel"),
            "candidate_bias": _a(weights, f"{prefix}/candidate/bias"),
        }
    if ct == "rnn":
        return {
            "kernel": _a(weights, f"{scope}/basic_rnn_cell/kernel"),
            "bias": _a(weights, f"{scope}/basic_rnn_cell/bias"),
        }
    raise ValueError(f"unknown cell type '{cell_type}'")


def _mlp_from_tf1(weights, scope: str) -> List[Dict]:
    layers = []
    j = 0
    while f"{scope}/MLP_W_layer{j}" in weights:
        layers.append({
            "W": _a(weights, f"{scope}/MLP_W_layer{j}"),
            "b": _a(weights, f"{scope}/MLP_b_layer{j}"),
        })
        j += 1
    if not layers:
        raise KeyError(f"no MLP layers under '{scope}'")
    return layers


def heads_from_tf1(weights: Dict[str, np.ndarray],
                   task_ids: Sequence[int],
                   fallback: Dict = None, log=None) -> Dict:
    """Output heads by task id. Tasks absent from the checkpoint keep
    their `fallback` (freshly initialized) head — the reference's
    partial-restore semantics (chem_tensorflow.py:330-359 exempts
    task_ids from the config check precisely so new task heads can be
    trained on top of a restored model)."""
    weights = _norm(weights)
    heads = {}
    for k in task_ids:
        # A head is "absent" only when BOTH its MLPs are missing
        # entirely; a PARTIALLY present head (truncated/renamed save —
        # gate without transform or vice versa) must raise, not be
        # silently swapped for fresh weights (checking the gate alone
        # would let a gate-missing/transform-present head slip through
        # to fresh init).
        gate_present = (f"out_layer_task{k}/regression_gate/MLP_W_layer0"
                        in weights)
        transform_present = (f"out_layer_task{k}/regression/MLP_W_layer0"
                             in weights)
        if gate_present != transform_present:
            raise KeyError(
                f"TF1 checkpoint has a PARTIAL task{k} head (gate "
                f"{'present' if gate_present else 'missing'}, transform "
                f"{'present' if transform_present else 'missing'}) — "
                "refusing to mix saved and fresh weights in one head")
        present = gate_present
        if not present and fallback is not None and f"task{k}" in fallback:
            if log is not None:
                log(f"Freshly initializing task{k} head (not in the TF1 "
                    "checkpoint).")
            heads[f"task{k}"] = fallback[f"task{k}"]
            continue
        heads[f"task{k}"] = {
            "gate": _mlp_from_tf1(
                weights, f"out_layer_task{k}/regression_gate"),
            "transform": _mlp_from_tf1(
                weights, f"out_layer_task{k}/regression"),
        }
    return heads


def sparse_graph_params_from_tf1(weights: Dict[str, np.ndarray],
                                 config: Dict, num_edge_types: int) -> Dict:
    weights = _norm(weights)
    h = config["hidden_size"]
    t = num_edge_types
    layers = []
    for i in range(len(config["layer_timesteps"])):
        scope = f"graph_model/gnn_layer_{i}"
        layer = {
            "edge_weights": _a(
                weights, f"{scope}/gnn_edge_weights_{i}").reshape(t, h, h),
            "cell": _cell_from_tf1(weights, f"{scope}/timestep_0",
                                   config["graph_rnn_cell"]),
        }
        if config["use_propagation_attention"]:
            layer["attention"] = _a(
                weights, f"{scope}/edge_type_attention_weights_{i}")
        if config["use_edge_bias"]:
            layer["edge_biases"] = _a(weights, f"{scope}/gnn_edge_biases_{i}")
        layers.append(layer)
    return {"layers": layers}


def dense_graph_params_from_tf1(weights: Dict[str, np.ndarray],
                                config: Dict) -> Dict:
    weights = _norm(weights)
    params = {
        "edge_weights": _a(weights, "graph_model/Variable"),
        "cell": _cell_from_tf1(weights, "graph_model/gru_scope", "gru"),
    }
    if config["use_edge_bias"]:
        params["edge_biases"] = _a(weights, "graph_model/Variable_1")
    return params


def async_graph_params_from_tf1(weights: Dict[str, np.ndarray],
                                config: Dict, num_edge_types: int,
                                slots: str = "effective") -> Dict:
    """Async GGNN weights (chem_tensorflow_async.py:112-129):
    per-type variables `graph_model/gnn_edge_weights_typ{t}` [H, H]
    (+ `gnn_edge_biases_typ{t}` [H]) and ONE cell created inside the
    round-0 scope (`graph_model/prop_round0/gru_cell/...`) and reused
    across rounds.

    The reference's off-by-one type quirk (async.py:264-266 — raw
    1-based bond types filtered UNSHIFTED against range(num_edge_types))
    means its effective routing is raw type r -> typ{r}, with typ0 never
    receiving an edge and the max raw type's messages silently dropped
    (targets stay receivers). `slots` picks how to reproduce that:

    * "effective" (default — every real restore/serving path): this
      framework's packers map raw type r to slot r-1, so slot t takes
      typ{t+1}; the max type's slot has no reference variable and is
      filled with ZEROS, making its messages vanish exactly like the
      reference's drop. A standard 1-based corpus then replays the
      reference's effective math with no graph rewriting.
    * "raw": slot t takes typ{t} — for corpora whose edge types were
      shifted up by one to mirror the reference host-side (the TF1
      golden fixtures, tests/test_tf1_golden.py:_async_quirk_mirror,
      which also grow num_edge_types by one so slot T_ref is the
      zero-weight dropped type)."""
    if slots not in ("effective", "raw"):
        raise ValueError(f"slots must be 'effective' or 'raw': {slots!r}")
    weights = _norm(weights)
    h = config["hidden_size"]
    shift = 1 if slots == "effective" else 0
    edge_weights, edge_biases = [], []
    for t in range(num_edge_types):
        # ONLY the top slot (num_edge_types - 1) may legitimately be
        # absent — it is the reference-dropped type whose messages
        # vanish by design (zero weights). Any OTHER missing per-type
        # variable means the checkpoint's edge-type count does not
        # match this corpus (num_edge_types is DATASET-derived and
        # invisible to the config-equality check) — zero-filling those
        # would silently erase real edge types' messages.
        may_be_absent = (t == num_edge_types - 1)
        name = f"graph_model/gnn_edge_weights_typ{t + shift}"
        if name in weights:
            edge_weights.append(_a(weights, name))
        elif may_be_absent:
            edge_weights.append(np.zeros((h, h), np.float32))
        else:
            raise KeyError(
                f"TF1 async checkpoint is missing '{name}' — its edge-"
                f"type count does not cover this corpus's "
                f"num_edge_types={num_edge_types}")
        bias_name = f"graph_model/gnn_edge_biases_typ{t + shift}"
        if bias_name in weights:
            edge_biases.append(_a(weights, bias_name))
        else:
            # Biases may be absent wholesale (use_edge_bias=False saves
            # none) — only consumed below when the config wants them,
            # and then the same top-slot rule applies.
            if config["use_edge_bias"] and not may_be_absent:
                raise KeyError(
                    f"TF1 async checkpoint is missing '{bias_name}' "
                    f"(use_edge_bias=True, num_edge_types="
                    f"{num_edge_types})")
            edge_biases.append(np.zeros((h,), np.float32))
    params = {
        "edge_weights": edge_weights,
        "cell": _cell_from_tf1(weights, "graph_model/prop_round0",
                               config["graph_rnn_cell"]),
    }
    if config["use_edge_bias"]:
        params["edge_biases"] = edge_biases
    return params


def gcn_graph_params_from_tf1(weights: Dict[str, np.ndarray],
                              config: Dict) -> Dict:
    weights = _norm(weights)
    layers = []
    for i in range(config["num_timesteps"]):
        scope = "graph_model/gcn_scope"
        layer = {"W": _a(weights, f"{scope}/gcn_weights_{i}")}
        if config.get("gcn_use_bias", False):
            layer["b"] = _a(weights, f"{scope}/gcn_bias_{i}")
        layers.append(layer)
    return {"layers": layers}


def _dense_family_from_tf1(weights, cfg, t):
    """The dense-path models pick their params tree by mode:
    reference dense mode ({'edge_weights','cell',...}) vs extended mode
    ({'layers': [...]} — the sparse structure, selected whenever the
    config carries layer_timesteps, which BLOCKED_DEFAULTS always does;
    see models/dense_ggnn.py:54). The converter must match, or the
    restored tree is silently incompatible with the model's forward."""
    if "layer_timesteps" in cfg:
        return sparse_graph_params_from_tf1(weights, cfg, t)
    return dense_graph_params_from_tf1(weights, cfg)


_GRAPH_CONVERTERS = {
    "sparse": lambda w, cfg, t: sparse_graph_params_from_tf1(w, cfg, t),
    "rgcn": lambda w, cfg, t: sparse_graph_params_from_tf1(w, cfg, t),
    "dense": _dense_family_from_tf1,
    "blocked": _dense_family_from_tf1,
    "gcn": lambda w, cfg, t: gcn_graph_params_from_tf1(w, cfg),
    # Same params tree as gcn (models/gcn.py:BlockedGCN subclasses GCN).
    "gcn_blocked": lambda w, cfg, t: gcn_graph_params_from_tf1(w, cfg),
    # NOTE: async dispatches through the explicit branch in
    # params_from_tf1_weights (it needs the extra `slots` argument);
    # this entry exists for the membership check only.
    "async": None,
}


def params_from_tf1_weights(variant: str, weights: Dict[str, np.ndarray],
                            config: Dict, num_edge_types: int,
                            fallback_heads: Dict = None, log=None,
                            async_slots: str = "effective") -> Dict:
    """Full params pytree {'graph': ..., 'heads': ...} from a TF1
    name->ndarray dict (e.g. the 'weights' entry of a reference pickle).

    `fallback_heads` (the skeleton's freshly initialized heads) covers
    task ids missing from the checkpoint — the reference's new-task
    partial-restore semantics. `async_slots` (async variant only) picks
    the per-type slot mapping — see async_graph_params_from_tf1."""
    if variant not in _GRAPH_CONVERTERS:
        raise ValueError(f"no TF1 converter for variant '{variant}'")
    if variant == "async":
        graph = async_graph_params_from_tf1(weights, config,
                                            num_edge_types,
                                            slots=async_slots)
    else:
        graph = _GRAPH_CONVERTERS[variant](weights, config, num_edge_types)
    return {
        "graph": graph,
        "heads": heads_from_tf1(weights, config["task_ids"],
                                fallback=fallback_heads, log=log),
    }


def load_tf1_checkpoint(path: str):
    """Read a reference pickle checkpoint -> (config, weights dict).

    Format: chem_tensorflow.py:309-323 `{"params", "weights",
    "train_step", "valid_step"}`.
    """
    with open(path, "rb") as f:
        data = pickle.load(f)
    return data["params"], _norm(data["weights"])
