"""The port's Predictor (ggnn_tpu_torch/serving.py) against the JAX
Predictor, with pickle checkpoints written by either package, at 2e-5."""

import json

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.models.base import init_output_heads as jax_init_heads
from ggnn_tpu.models.dense_ggnn import DenseGGNN as JaxDenseGGNN
from ggnn_tpu.models.gcn import BlockedGCN as JaxBlockedGCN
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
from ggnn_tpu_torch.models.gcn import BlockedGCN
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training import checkpoint
from ggnn_tpu_torch.training.config import resolve_config

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = {"hidden_size": 16, "layer_timesteps": [2, 1, 1],
         "residual_connections": {"2": [0]}, "native_pack": False}
ENVELOPE = dict(max_nodes=64, max_graphs=8)


def _jax_checkpoint(path, variant, overrides, seed=0):
    """A JAX skeleton (init_params + init_output_heads) with Adam-like
    optimizer entries beside it, written by JAX's save_checkpoint."""
    config = jax_resolve_config(variant, config_json=json.dumps(overrides))
    model = JaxSparseGGNN(config, 4)
    key = jax.random.PRNGKey(seed)
    params = {"graph": model.init_params(key),
              "heads": jax_init_heads(key, config["hidden_size"],
                                      config["task_ids"])}
    state = {"params": params,
             "opt_state": jax.tree_util.tree_map(np.zeros_like, params)}
    jax_save(str(path), config, state, 3, 1)
    return str(path)


def _port_checkpoint(path, variant, overrides, seed=0):
    config = resolve_config(variant, config_json=json.dumps(overrides))
    gen = torch.Generator().manual_seed(seed)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, config["hidden_size"],
                                           config["task_ids"]))
    checkpoint.save_checkpoint(str(path), config, params, 3, 1)
    return str(path), params


@pytest.mark.parametrize("variant,overrides", [
    ("sparse", SMALL), ("rgcn", {"hidden_size": 16, "native_pack": False})])
@pytest.mark.parametrize("n_graphs", [1, 40])
def test_predictor_matches_jax_on_jax_checkpoint(tmp_path, variant,
                                                 overrides, n_graphs):
    path = _jax_checkpoint(tmp_path / "jax.pickle", variant, overrides)
    want_pred = JaxPredictor.from_checkpoint(path, variant, **ENVELOPE)
    port = Predictor.from_checkpoint(path, variant, device="cpu",
                                     **ENVELOPE)
    assert port.device == torch.device("cpu")
    request = synthetic_molecules(n_graphs, seed=20 + n_graphs)
    got = port(request)
    want = want_pred(request)
    assert got.shape == want.shape == (1, n_graphs)
    np.testing.assert_allclose(got, want, **TOL)


def test_micro_batched_request_spans_several_envelopes(tmp_path):
    path = _jax_checkpoint(tmp_path / "jax.pickle", "sparse", SMALL)
    port = Predictor.from_checkpoint(path, "sparse", device="cpu",
                                     **ENVELOPE)
    request = synthetic_molecules(40, seed=60)
    batches = list(port._batches(request, 5))
    assert len(batches) > 1
    assert sum(int(b.num_graphs) for b in batches) == 40
    # Each graph answered alone equals its answer inside the big request.
    together = port(request)
    alone = np.concatenate([port([g]) for g in request[:5]], axis=1)
    np.testing.assert_allclose(together[:, :5], alone, **TOL)


def test_port_checkpoint_serves_in_jax_predictor(tmp_path):
    path, _ = _port_checkpoint(tmp_path / "port.pickle", "sparse", SMALL)
    want_pred = JaxPredictor.from_checkpoint(path, "sparse", **ENVELOPE)
    port = Predictor.from_checkpoint(path, "sparse", device="cpu",
                                     **ENVELOPE)
    request = synthetic_molecules(40, seed=61)
    np.testing.assert_allclose(port(request), want_pred(request), **TOL)
    np.testing.assert_allclose(port(request[:1]), want_pred(request[:1]),
                               **TOL)


def test_checkpoint_round_trip_and_bridge(tmp_path):
    path, params = _port_checkpoint(tmp_path / "port.pickle", "sparse",
                                    SMALL, seed=5)
    config = resolve_config("sparse", config_json=json.dumps(SMALL))
    gen = torch.Generator().manual_seed(6)
    fresh = ModelParams(SparseGGNN(config, 4, gen),
                        init_output_heads(gen, 16, [0]))
    restored, train_step, valid_step = checkpoint.restore_checkpoint(
        path, config, fresh, log=lambda *a: None)
    assert (train_step, valid_step) == (3, 1)
    for name, value in params.state_dict().items():
        torch.testing.assert_close(restored.state_dict()[name], value,
                                   rtol=0, atol=0)
    weights = checkpoint.jax_weights_from_params(params)
    assert "['params']['graph']['layers'][0]['cell']['gates_kernel']" \
        in weights
    assert "['params']['heads']['task0']['gate'][0]['W']" in weights
    back = checkpoint.params_from_jax_weights(weights)
    assert set(back) == set(params.state_dict())


def test_restore_reports_unused_and_fresh_leaves(tmp_path):
    path = _jax_checkpoint(tmp_path / "jax.pickle", "sparse", SMALL)
    config = resolve_config("sparse", config_json=json.dumps(
        {**SMALL, "task_ids": [0, 1]}))
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, 16, [0, 1]))
    before = params.heads["task1"].state_dict()
    lines = []
    checkpoint.restore_checkpoint(path, config, params, log=lines.append)
    # The new task's head keeps its fresh weights; the optimizer
    # entries are reported as unused.
    assert any("Freshly initializing ['params']['heads']['task1']" in s
               for s in lines)
    assert any("['opt_state']" in s and "not used" in s for s in lines)
    for name, value in before.items():
        torch.testing.assert_close(params.heads["task1"].state_dict()[name],
                                   value)


@pytest.mark.parametrize("change,error", [
    ({"hidden_size": 8}, AssertionError),
    ({"use_edge_bias": True}, AssertionError),
])
def test_restore_rejects_mismatched_config(tmp_path, change, error):
    path = _jax_checkpoint(tmp_path / "jax.pickle", "sparse", SMALL)
    config = resolve_config("sparse", config_json=json.dumps(
        {**SMALL, **change}))
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 4, gen),
                         init_output_heads(gen, config["hidden_size"], [0]))
    with pytest.raises(error):
        checkpoint.restore_checkpoint(path, config, params,
                                      log=lambda *a: None)


def test_restore_rejects_wrong_leaf_shape(tmp_path):
    path = _jax_checkpoint(tmp_path / "jax.pickle", "sparse", SMALL)
    config = resolve_config("sparse", config_json=json.dumps(SMALL))
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, 3, gen),     # T = 3, not 4
                         init_output_heads(gen, 16, [0]))
    with pytest.raises(ValueError, match="num_edge_types"):
        checkpoint.restore_checkpoint(path, config, params,
                                      log=lambda *a: None)


def test_from_checkpoint_without_device_needs_cuda(tmp_path, monkeypatch):
    path = _jax_checkpoint(tmp_path / "jax.pickle", "sparse", SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint(path, "sparse")


@pytest.mark.parametrize("variant,error", [
    ("async", None), ("nonsense", ValueError)])
def test_unserved_variants_raise(tmp_path, variant, error):
    """An unknown variant raises; `async`, the last variant ported,
    serves (tests/test_torch_async.py holds it to the JAX Predictor)."""
    if error is not None:
        path = _jax_checkpoint(tmp_path / "jax.pickle", "sparse", SMALL)
        with pytest.raises(error):
            Predictor.from_checkpoint(path, variant, device="cpu")
        return
    config = resolve_config(variant, config_json=json.dumps(
        {"hidden_size": 16, "propagation_rounds": 2,
         "propagation_substeps": 40}))
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(AsyncGGNN(config, 4, gen),
                         init_output_heads(gen, 16, config["task_ids"]))
    path = str(tmp_path / "async.pickle")
    checkpoint.save_checkpoint(path, config, params, 0, 0)
    out = Predictor.from_checkpoint(path, variant, device="cpu",
                                    **ENVELOPE)(synthetic_molecules(3))
    assert out.shape == (1, 3) and np.isfinite(out).all()


@pytest.mark.parametrize("request_graphs,message", [
    ([], "empty prediction request"),
    ([{"graph": [], "node_features": []}], "node_features"),
    ([{"graph": [[0, 1, 5]], "node_features": [[1, 0, 0, 0, 0]]}],
     "out of range"),
    ([{"graph": [], "node_features": [[1, 0, 0, 0, 0]]},
      {"graph": [], "node_features": [[1, 0]]}], "consistent width"),
])
def test_predictor_validates_requests(tmp_path, request_graphs, message):
    path = _jax_checkpoint(tmp_path / "jax.pickle", "sparse", SMALL)
    port = Predictor.from_checkpoint(path, "sparse", device="cpu",
                                     **ENVELOPE)
    with pytest.raises(ValueError, match=message):
        port(request_graphs)


# ------------------------------------------------------ dense family

DENSE_OVERRIDES = {
    "dense": {"hidden_size": 16, "batch_size": 8, "native_pack": False,
              "dense_bucket_sizes": [16, 32]},
    "blocked": {"hidden_size": 16, "batch_size": 8, "native_pack": False,
                "layer_timesteps": [2, 1], "residual_connections": {"1": [0]},
                "use_edge_bias": True},
    "gcn_blocked": {"hidden_size": 16, "batch_size": 8, "native_pack": False,
                    "num_timesteps": 3, "gcn_use_bias": True},
}


def _jax_dense_checkpoint(path, variant):
    config = jax_resolve_config(variant, config_json=json.dumps(
        DENSE_OVERRIDES[variant]))
    key = jax.random.PRNGKey(4)
    model = (JaxBlockedGCN(config) if variant == "gcn_blocked"
             else JaxDenseGGNN(config, 4))
    params = {"graph": model.init_params(key),
              "heads": jax_init_heads(key, 16, config["task_ids"])}
    jax_save(str(path), config, {"params": params}, 5, 2)
    return str(path)


@pytest.mark.parametrize("n_graphs", [1, 40])
@pytest.mark.parametrize("variant", ["dense", "blocked", "gcn_blocked"])
def test_dense_predictor_matches_jax_in_request_order(tmp_path, variant,
                                                      n_graphs):
    path = _jax_dense_checkpoint(tmp_path / "jax.pickle", variant)
    want_pred = JaxPredictor.from_checkpoint(path, variant)
    port = Predictor.from_checkpoint(path, variant, device="cpu")
    request = synthetic_molecules(n_graphs, seed=70 + n_graphs)
    got = port(request)
    want = want_pred(request)
    assert got.shape == want.shape == (1, n_graphs)
    np.testing.assert_allclose(got, want, **TOL)
    if n_graphs > 1:
        # Column i answers graph i: the 1-graph path agrees.
        alone = np.concatenate([port([g]) for g in request[:4]], axis=1)
        np.testing.assert_allclose(got[:, :4], alone, **TOL)


@pytest.mark.parametrize("variant", ["dense", "blocked", "gcn_blocked"])
def test_port_dense_checkpoint_serves_in_jax_predictor(tmp_path, variant):
    config = resolve_config(variant, config_json=json.dumps(
        DENSE_OVERRIDES[variant]))
    gen = torch.Generator().manual_seed(9)
    model = (BlockedGCN(config, gen) if variant == "gcn_blocked"
             else DenseGGNN(config, 4, gen))
    params = ModelParams(model,
                         init_output_heads(gen, 16, config["task_ids"]))
    path = str(tmp_path / "port.pickle")
    checkpoint.save_checkpoint(path, config, params, 3, 1)
    want_pred = JaxPredictor.from_checkpoint(path, variant)
    port = Predictor.from_checkpoint(path, variant, device="cpu")
    request = synthetic_molecules(20, seed=62)
    np.testing.assert_allclose(port(request), want_pred(request), **TOL)
