"""The port's DenseGGNN (ggnn_tpu_torch/models/dense_ggnn.py), both
modes, against the JAX DenseGGNN with bridged weights, against the TF1
golden `dense_default.npz`, and the `blocked` variant against the port's
SparseGGNN.

Tolerances: node states and readout 2e-5 (tests/test_tf1_golden.py pins
2e-5 for the JAX model); gradients 1e-4 (f32 products in another
order); blocked against sparse rtol 1e-4 / atol 1e-5, as
tests/test_models.py holds the two JAX models (the dense path sums the
same messages as products over padded blocks).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.compat.tf1 import params_from_tf1_weights
from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models import base as jax_base
from ggnn_tpu.models.dense_ggnn import DenseGGNN as JaxDenseGGNN
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu_torch.data import packing
from ggnn_tpu_torch.data.loader import infer_metadata
from ggnn_tpu_torch.graph import DenseGraphBatch
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.models import dense_ggnn as dense_module
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN, resolve_lane_pad
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tf1")
BUCKETS = [16, 32]
DENSE_SMALL = {"hidden_size": 16, "dense_bucket_sizes": BUCKETS}
BLOCKED_SMALL = {"hidden_size": 16, "layer_timesteps": [2, 1, 1],
                 "residual_connections": {"2": [0]},
                 "dense_bucket_sizes": BUCKETS}
# An edgeless graph and one with an isolated trailing vertex: vertices
# with no in-edge, whose attention must be zeros, not NaN.
ODD_GRAPHS = [
    {"targets": [[0.5]], "graph": [],
     "node_features": [[1, 0, 0, 0, 0]]},
    {"targets": [[-0.2]], "graph": [[0, 1, 1], [1, 2, 2]],
     "node_features": [[1, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 1, 0, 0],
                       [0, 0, 0, 1, 0]]},
]

MODEL_CASES = {
    # reference mode (`dense`): one shared tanh GRU, edge bias [T, 1, H]
    "dense_default": ("dense", {}),
    "dense_no_bias_untied": ("dense", {"use_edge_bias": False,
                                       "tie_fwd_bkwd": False}),
    # extended mode (`blocked`)
    "blocked_gru": ("blocked", {}),
    "blocked_cudnn_gru_bias": ("blocked", {
        "graph_rnn_cell": "CudnnCompatibleGRUCell", "use_edge_bias": True}),
    "blocked_rnn_relu_no_avg": ("blocked", {
        "graph_rnn_cell": "RNN", "graph_rnn_activation": "ReLU",
        "use_edge_msg_avg_aggregation": False, "residual_connections": {}}),
    "blocked_attention_bias": ("blocked", {
        "use_propagation_attention": True, "use_edge_bias": True}),
    "blocked_attention_rnn_residuals": ("blocked", {
        "use_propagation_attention": True, "graph_rnn_cell": "RNN",
        "use_edge_msg_avg_aggregation": False,
        "residual_connections": {"1": [0], "2": [0, 1]}}),
}


def _configs(variant, extra):
    small = DENSE_SMALL if variant == "dense" else BLOCKED_SMALL
    overrides = json.dumps({**small, **extra})
    config = resolve_config(variant, config_json=overrides)
    assert config == jax_resolve_config(variant, config_json=overrides)
    return config


def _jax_batches(data, config, batch_size=8):
    t_dim = infer_metadata([data], config["tie_fwd_bkwd"]).num_edge_types
    bucketed, sizes = jax_packing.preprocess_dense(
        data, t_dim, config["tie_fwd_bkwd"], [0], {}, False,
        bucket_sizes=np.asarray(config["dense_bucket_sizes"]))
    batches = list(jax_packing.pack_dense_batches(
        bucketed, sizes, batch_size, config["hidden_size"], 5, False,
        drop_remainder=False))
    return t_dim, batches


def _port_batch(jax_batch) -> DenseGraphBatch:
    return DenseGraphBatch(**{
        f.name: getattr(jax_batch, f.name)
        for f in dataclasses.fields(DenseGraphBatch)}).to("cpu")


def _jax_params(config, t_dim, seed=1):
    """JAX init_params and heads, with non-zero edge biases and attention
    factors off 1.0, so both terms are exercised."""
    model = JaxDenseGGNN(config, t_dim)
    key = jax.random.PRNGKey(seed)
    params = {"graph": model.init_params(key),
              "heads": jax_base.init_output_heads(key, config["hidden_size"],
                                                  config["task_ids"])}
    rng = np.random.RandomState(seed)
    graph = params["graph"]
    for holder in graph.get("layers", [graph]):
        if "edge_biases" in holder:
            holder["edge_biases"] = (0.3 * rng.randn(
                *holder["edge_biases"].shape)).astype(np.float32)
        if "attention" in holder:
            holder["attention"] = rng.uniform(
                0.5, 1.5, holder["attention"].shape).astype(np.float32)
    return model, params


def _port_params(config, t_dim, jax_params):
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(
        DenseGGNN(config, t_dim, gen),
        init_output_heads(gen, config["hidden_size"], config["task_ids"]))
    params.load_state_dict(
        params_from_jax_weights(_flatten_named({"params": jax_params})),
        strict=True)
    return params


def _data():
    return synthetic_molecules(24, seed=13) + ODD_GRAPHS


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_dense_ggnn_matches_jax(case):
    """Node states and outputs of every batch against the JAX model, and
    the gradients of the masked regression loss for every parameter of
    the model and the heads against jax.grad."""
    variant, extra = MODEL_CASES[case]
    config = _configs(variant, extra)
    t_dim, batches = _jax_batches(_data(), config)
    assert len({b.num_vertices for b in batches}) == len(BUCKETS)
    jax_model, jax_params = _jax_params(config, t_dim)
    port = _port_params(config, t_dim, jax_params)
    names = [n for n, _ in port.named_parameters()]

    def jax_loss(p, jb):
        final = jax_model.forward(p["graph"], jb)
        computed = jax_model.readout(p["heads"], [0], final, jb)
        loss = jax_base.masked_regression_loss(
            computed, jb.targets, jb.target_mask, [0], {})[0]
        return loss, (final, computed)

    jax_step = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    for jb in batches:
        (want_loss, (want, want_out)), jax_grads = jax_step(jax_params, jb)
        want_grads = params_from_jax_weights(_flatten_named(
            {"params": jax_grads}))
        assert sorted(names) == sorted(want_grads)
        batch = _port_batch(jb)
        final = port.graph(batch)
        out = port.graph.readout(port.heads, [0], final, batch)
        loss, _ = base.masked_regression_loss(
            out, batch.targets, batch.target_mask, [0], {})
        grads = torch.autograd.grad(loss, list(port.parameters()))
        assert torch.isfinite(final).all()
        np.testing.assert_allclose(final.detach().numpy(), np.asarray(want),
                                   **TOL)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(want_out), **TOL)
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=1e-5)
        for name, grad in zip(names, grads):
            assert torch.isfinite(grad).all(), name
            np.testing.assert_allclose(grad.numpy(),
                                       want_grads[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


def test_attention_of_vertices_without_in_edges_is_zero():
    adjacency = torch.zeros(2, 3, 4, 4)
    adjacency[0, 1, 2, 0] = adjacency[0, 2, 2, 3] = 1.0   # v 2: two edges
    h = torch.randn(2, 4, 5, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    factors = torch.tensor([1.0, 0.5, 2.0], requires_grad=True)
    attn = dense_module.dense_attention(h, adjacency, factors)
    torch.testing.assert_close(attn.sum(dim=(1, 3))[0],
                               torch.tensor([0.0, 0.0, 1.0, 0.0]))
    assert not attn[1].any()
    grads = torch.autograd.grad((attn * torch.randn(attn.shape)).sum(),
                                (h, factors))
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("variant", ["dense", "blocked"])
def test_lane_pad_true_equals_false_and_matches_jax(variant):
    """JAX pads H to 128 lanes under lane_pad true and not under false;
    the port pads neither way: all four agree."""
    t_dim, batches = _jax_batches(_data(), _configs(variant, {}))
    outs = []
    for mode in (True, False):
        config = _configs(variant, {"lane_pad": mode})
        jax_model, jax_params = _jax_params(config, t_dim)
        assert jax_model.lane_pad is mode
        port = _port_params(config, t_dim, jax_params).eval()
        assert port.graph.lane_pad is mode
        jb = batches[0]
        with torch.no_grad():
            outs.append(port.graph(_port_batch(jb)).numpy())
        np.testing.assert_allclose(
            outs[-1],
            np.asarray(jax.jit(jax_model.forward)(jax_params["graph"], jb)),
            **TOL)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("mode", ["off", "false", "True", 1, None])
def test_invalid_lane_pad_raises_as_in_jax(mode):
    from ggnn_tpu.ops.lanes import resolve_lane_pad as jax_resolve
    for resolve in (resolve_lane_pad, jax_resolve):
        with pytest.raises(ValueError, match="lane_pad"):
            resolve({"lane_pad": mode}, 100)
    assert resolve_lane_pad({}, 100) is True
    assert resolve_lane_pad({}, 128) is False


@pytest.mark.parametrize("variant", ["dense", "blocked"])
def test_bfloat16_runs(variant):
    """compute_dtype: bfloat16 builds and runs in both modes, f32 states
    out (its numbers against JAX in tests/test_torch_bf16.py)."""
    config = _configs(variant, {"compute_dtype": "bfloat16"})
    model = DenseGGNN(config, 4, torch.Generator().manual_seed(0))
    assert model.compute_dtype == torch.bfloat16
    _, batches = _jax_batches(_data(), config)
    with torch.no_grad():
        out = model(_port_batch(batches[0]))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


@pytest.mark.parametrize("variant,draws", [("dense", 4), ("blocked", 3)])
def test_edge_weight_dropout_draws(monkeypatch, variant, draws):
    """Reference mode draws a fresh edge-weight mask at every step
    (dense.py:104), extended mode one per layer, shared by its steps."""
    config = _configs(variant, {"edge_weight_dropout_keep_prob": 0.5,
                                "graph_state_dropout_keep_prob": 1.0})
    model = DenseGGNN(config, 4, torch.Generator().manual_seed(0))
    _, batches = _jax_batches(_data(), config)
    seen = []
    real = dense_module.dropout

    def recording(x, keep, generator):
        out = real(x, keep, generator)
        seen.append(out)
        return out

    monkeypatch.setattr(dense_module, "dropout", recording)
    batch = _port_batch(batches[0])
    with torch.no_grad():
        trained = model(batch, is_training=True,
                        generator=torch.Generator().manual_seed(3))
        again = model(batch, is_training=True,
                      generator=torch.Generator().manual_seed(3))
        served = model(batch)
    assert len(seen) == 2 * draws
    assert torch.equal(trained, again) and not torch.equal(trained, served)
    masks = [(w != 0) for w in seen[:draws]]
    assert all(not torch.equal(masks[0], m) for m in masks[1:])
    with pytest.raises(ValueError, match="Generator"):
        model(batch, is_training=True)


def test_blocked_matches_port_sparse_ggnn():
    """`blocked` and the port's SparseGGNN under the same parameters
    (no attention, which the sparse port lacks: A14): the same node
    states and outputs for every graph, in request order."""
    config = _configs("blocked", {"use_edge_bias": True,
                                  "edge_weight_dropout_keep_prob": 1.0})
    # The shared domain: the dense adjacency counts a repeated (src,
    # type, dst) pair once, the sparse lanes twice (a known, reference-
    # faithful divergence, ggnn_tpu/models/dense_ggnn.py:32-40).
    data = [g for g in _data()
            if len({frozenset((s, d)) for s, _, d in g["graph"]})
            == len(g["graph"])]
    assert len(data) > 15
    t_dim, dense_batches = _jax_batches(data, config)
    gen = torch.Generator().manual_seed(4)
    sparse = ModelParams(SparseGGNN(config, t_dim, gen),
                         init_output_heads(gen, 16, [0])).eval()
    with torch.no_grad():
        for layer in sparse.graph.layers:
            layer.edge_biases.normal_(generator=gen)
    blocked = ModelParams(DenseGGNN(config, t_dim, gen),
                          init_output_heads(gen, 16, [0])).eval()
    blocked.load_state_dict(sparse.state_dict(), strict=True)

    proc = packing.preprocess_sparse(data, t_dim, True, [0], {}, False)
    caps = packing.plan_capacities(proc, t_dim, 2000)
    sb = next(packing.pack_sparse_batches(proc, t_dim, 2000, caps, 16, 5,
                                          False, None)).to("cpu")
    assert int(sb.num_graphs) == len(data)
    bucketed, _ = packing.preprocess_dense(
        data, t_dim, True, [0], {}, False, bucket_sizes=np.asarray(BUCKETS))
    order = [g["graph_id"] for b in bucketed.values() for g in b]
    with torch.no_grad():
        s_final = sparse.graph(sb)
        s_out = sparse.graph.readout(sparse.heads, [0], s_final, sb)
        d_states, d_out = [], []
        for jb in dense_batches:
            batch = _port_batch(jb)
            final = blocked.graph(batch)
            n = int(batch.num_graphs)
            d_out.append(blocked.graph.readout(blocked.heads, [0], final,
                                               batch)[:, :n])
            d_states += [final[i, :int(batch.node_mask[i].sum())]
                         for i in range(n)]
    d_out = torch.cat(d_out, dim=1)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d_out.numpy(),
                               s_out[:, np.asarray(order)].numpy(), **tol)
    starts = np.concatenate([[0], np.cumsum(
        [len(g["node_features"]) for g in data])])
    for states, graph_id in zip(d_states, order):
        np.testing.assert_allclose(
            states.numpy(),
            s_final[starts[graph_id]:starts[graph_id + 1]].numpy(), **tol)


def test_dense_ggnn_matches_tf1_golden():
    """The reference's own dense GGNN (chem_tensorflow_dense.py) on its
    first validation batch: final node states and per-graph outputs at
    2e-5, from the reference's weights."""
    data = np.load(os.path.join(FIXTURE_DIR, "dense_default.npz"))
    meta = json.loads(str(data["meta"]))
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w/")}
    corpus = meta["corpus"]
    train = synthetic_molecules(corpus["n_train"], seed=corpus["seed"],
                                num_targets=corpus["num_targets"])
    valid = synthetic_molecules(corpus["n_valid"], seed=corpus["seed"] + 1,
                                num_targets=corpus["num_targets"])
    config = resolve_config("dense", config_json=json.dumps(meta["config"]))
    dmeta = infer_metadata([train, valid], config["tie_fwd_bkwd"])
    t_dim = dmeta.num_edge_types
    assert t_dim == meta["num_edge_types"]
    bucketed, sizes = packing.preprocess_dense(
        valid, t_dim, config["tie_fwd_bkwd"], config["task_ids"], {}, False)
    batch = next(packing.pack_dense_batches(
        bucketed, sizes, config["batch_size"], config["hidden_size"],
        dmeta.annotation_size, False)).to("cpu")
    port = _port_params(config, t_dim, params_from_tf1_weights(
        "dense", weights, config, t_dim)).eval()
    with torch.no_grad():
        final = port.graph(batch)
        out = port.graph.readout(port.heads, config["task_ids"], final,
                                 batch)
    b_real = meta["batch_num_graphs"]
    ref_states = np.asarray(data["final_states"], np.float32)
    assert final.shape[1:] == ref_states.shape[1:]
    np.testing.assert_allclose(final[:b_real].numpy(), ref_states[:b_real],
                               **TOL)
    np.testing.assert_allclose(out[-1, :b_real].numpy(),
                               np.asarray(data["output"]).reshape(-1)[:b_real],
                               **TOL)


def test_dense_readout_matches_jax_and_ignores_padding():
    rng = np.random.RandomState(5)
    last = rng.randn(3, 6, 8).astype(np.float32)
    init = rng.randn(3, 6, 8).astype(np.float32)
    mask = np.zeros((3, 6), np.float32)
    mask[0, :4] = mask[1, :6] = 1.0                   # row 2: a padded row
    heads = jax_base.init_output_heads(jax.random.PRNGKey(0), 8, [0, 2])
    want = jax_base.dense_readout(heads, [0, 2], jnp.asarray(last),
                                  jnp.asarray(init), jnp.asarray(mask))
    port_heads = init_output_heads(torch.Generator().manual_seed(0), 8,
                                   [0, 2])
    port_heads.load_state_dict({
        k[len("heads."):]: v for k, v in params_from_jax_weights(
            _flatten_named({"params": {"heads": heads}})).items()})
    with torch.no_grad():
        got = base.dense_readout(port_heads, [0, 2], torch.from_numpy(last),
                                 torch.from_numpy(init),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[:, 2].any()
