"""The port's SparseGGNN (ggnn_tpu_torch/models/sparse_ggnn.py) against
the JAX SparseGGNN with bridged weights, and against the TF1 goldens, at
2e-5 (the tolerance tests/test_tf1_golden.py pins)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.compat.tf1 import params_from_tf1_weights
from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.loader import infer_metadata as jax_infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models.base import init_output_heads as jax_init_heads
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu_torch.data import packing
from ggnn_tpu_torch.data.loader import infer_metadata
from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tf1")
SMALL = {"hidden_size": 16, "layer_timesteps": [2, 1, 1],
         "residual_connections": {"2": [0]}}


def _port_params(config, num_edge_types, jax_params):
    """A port ModelParams holding the JAX params, through the bridge."""
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(
        SparseGGNN(config, num_edge_types, gen),
        init_output_heads(gen, config["hidden_size"], config["task_ids"]))
    params.load_state_dict(
        params_from_jax_weights(_flatten_named({"params": jax_params})),
        strict=True)
    return params.eval()


def _port_batch(jax_batch) -> GraphBatch:
    return GraphBatch(**{
        f.name: getattr(jax_batch, f.name)
        for f in dataclasses.fields(GraphBatch)}).to("cpu")


def _jax_batches(data, tie, budget, hidden):
    meta = jax_infer_metadata([data], tie)
    proc = jax_packing.preprocess_sparse(data, meta.num_edge_types, tie,
                                         [0], {}, False)
    caps = jax_packing.plan_capacities(proc, meta.num_edge_types, budget)
    return meta, list(jax_packing.pack_sparse_batches(
        proc, meta.num_edge_types, budget, caps, hidden,
        meta.annotation_size, False, None))


MODEL_CASES = {
    "default_gru": ("sparse", {}),
    "rgcn": ("rgcn", {}),
    "edge_bias": ("sparse", {"use_edge_bias": True}),
    "cudnn_gru": ("sparse", {"graph_rnn_cell": "CudnnCompatibleGRUCell"}),
    "untied": ("sparse", {"tie_fwd_bkwd": False}),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_sparse_ggnn_matches_jax(case):
    variant, extra = MODEL_CASES[case]
    overrides = {**SMALL, **extra} if variant == "sparse" else {
        "hidden_size": 16, **extra}
    jax_config = jax_resolve_config(variant,
                                    config_json=json.dumps(overrides))
    config = resolve_config(variant, config_json=json.dumps(overrides))
    assert config == jax_config
    data = synthetic_molecules(50, seed=13)
    meta, batches = _jax_batches(data, config["tie_fwd_bkwd"], 300, 16)
    t_dim = meta.num_edge_types
    jax_model = JaxSparseGGNN(jax_config, t_dim)
    key = jax.random.PRNGKey(1)
    jax_params = {"graph": jax_model.init_params(key),
                  "heads": jax_init_heads(key, 16, config["task_ids"])}
    if config["use_edge_bias"]:
        # Non-zero biases, so the bias term is exercised.
        rng = np.random.RandomState(2)
        for layer in jax_params["graph"]["layers"]:
            layer["edge_biases"] = rng.randn(
                *layer["edge_biases"].shape).astype(np.float32)
    port = _port_params(config, t_dim, jax_params)
    assert len(batches) > 1
    for jb in batches:
        want = jax_model.forward(jax_params["graph"], jb)
        want_out = jax_model.readout(jax_params["heads"], [0], want, jb)
        batch = _port_batch(jb)
        with torch.no_grad():
            final = port.graph(batch)
            out = port.graph.readout(port.heads, [0], final, batch)
        np.testing.assert_allclose(final.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)


GOLDEN_CASES = ["sparse_default", "sparse_one_step", "sparse_three_steps",
                "rgcn"]


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_sparse_ggnn_matches_tf1_golden(case):
    data = np.load(os.path.join(FIXTURE_DIR, f"{case}.npz"))
    meta = json.loads(str(data["meta"]))
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w/")}
    corpus = meta["corpus"]
    train = synthetic_molecules(corpus["n_train"], seed=corpus["seed"],
                                num_targets=corpus["num_targets"])
    valid = synthetic_molecules(corpus["n_valid"], seed=corpus["seed"] + 1,
                                num_targets=corpus["num_targets"])
    config = resolve_config(meta["variant"],
                            config_json=json.dumps(meta["config"]))
    # The corpus metadata and the first validation batch, as the JAX
    # Runner derives them (train then valid; node budget batch_size).
    dmeta = infer_metadata([train, valid], config["tie_fwd_bkwd"])
    assert dmeta.num_edge_types == meta["num_edge_types"]
    assert dmeta.annotation_size == meta["annotation_size"]
    t_dim = dmeta.num_edge_types
    proc = packing.preprocess_sparse(valid, t_dim, config["tie_fwd_bkwd"],
                                     config["task_ids"], {}, False)
    caps = packing.plan_capacities(proc, t_dim, config["batch_size"])
    batch = next(packing.pack_sparse_batches(
        proc, t_dim, config["batch_size"], caps, config["hidden_size"],
        dmeta.annotation_size, False, None)).to("cpu")
    port = _port_params(config, t_dim, params_from_tf1_weights(
        meta["variant"], weights, config, t_dim))

    with torch.no_grad():
        final = port.graph(batch)
        out = port.graph.readout(port.heads, config["task_ids"], final,
                                 batch)
    ref_states = np.asarray(data["final_states"], np.float32)
    np.testing.assert_allclose(final[:ref_states.shape[0]].numpy(),
                               ref_states, **TOL)
    g = meta["batch_num_graphs"]
    np.testing.assert_allclose(out[-1, :g].numpy(),
                               np.asarray(data["output"]).reshape(-1)[:g],
                               **TOL)


@pytest.mark.parametrize("extra,item", [
    ({"use_propagation_attention": True}, "A14"),
    ({"aggregate_first": False}, "A15"),
    ({"combined_edge_lanes": False}, "A15"),
    ({"compute_dtype": "bfloat16"}, "A16"),
])
def test_unported_options_raise(extra, item):
    config = resolve_config("sparse", config_json=json.dumps(
        {**SMALL, **extra}))
    with pytest.raises(NotImplementedError, match=item):
        SparseGGNN(config, 4, torch.Generator().manual_seed(0))


def test_edge_axis_and_training_dropout_raise():
    config = resolve_config("sparse", config_json=json.dumps(SMALL))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="A11"):
        SparseGGNN(config, 4, gen, edge_axis="edge")
    model = SparseGGNN(config, 4, gen)
    batch = next(packing.pack_sparse_batches(
        packing.preprocess_sparse(synthetic_molecules(3), 4, True, [0], {},
                                  False),
        4, 100, packing.PackCapacities(96, 128, 8, 128), 16, 5, False,
        None)).to("cpu")
    # Edge-weight dropout (keep 0.8 by default, now ported) changes the
    # training forward only, and draws its masks from the generator.
    assert model.edge_weight_dropout_keep_prob == 0.8
    with torch.no_grad():
        served = model(batch)
        trained = model(batch, is_training=True,
                        generator=torch.Generator().manual_seed(1))
        again = model(batch, is_training=True,
                      generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(trained).all() and torch.equal(trained, again)
    assert not torch.allclose(trained, served)
    with pytest.raises(ValueError, match="Generator"):
        model(batch, is_training=True)


@pytest.mark.parametrize("residuals,ok", [
    ({"1": [0, 1]}, True), ({"2": [3]}, False), ({"1": [-1]}, False),
    ({"7": [6]}, True),   # keys past the layer count are ignored
])
def test_residual_validation_matches_jax(residuals, ok):
    config = resolve_config("sparse", config_json=json.dumps(
        {**SMALL, "residual_connections": residuals}))
    jax_config = jax_resolve_config("sparse", config_json=json.dumps(
        {**SMALL, "residual_connections": residuals}))
    gen = torch.Generator().manual_seed(0)
    if ok:
        SparseGGNN(config, 4, gen)
        JaxSparseGGNN(jax_config, 4)
    else:
        with pytest.raises(ValueError, match="residual_connections"):
            SparseGGNN(config, 4, gen)
        with pytest.raises(ValueError, match="residual_connections"):
            JaxSparseGGNN(jax_config, 4)
