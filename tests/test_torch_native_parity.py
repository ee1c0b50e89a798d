"""The port's Runner, Predictor and ExportedPredictor under the default
config, so that both packages pack natively (ggnn_tpu_torch/native and
the JAX package's native packer), against the JAX package, on the CPU.

Tolerances, each with its reason:
  * Runner losses, MAE and error ratio per epoch: rtol 5e-4, the bound of
    the numpy-packer Runner parities (tests/test_torch_training.py: two
    epochs of f32 training in another summation order);
  * Predictor answers: 2e-5, tests/test_torch_serving.py's;
  * the bf16 dense Predictor: 7e-4 absolute, tests/test_torch_bf16.py's
    TOL_PREDICTOR (bf16 products rounded in another order);
  * an artifact against the live Predictor: 1e-6, the artifact bound of
    tests/test_torch_export.py.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from ggnn_tpu.data.loader import DatasetMeta as JaxDatasetMeta
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models.base import init_output_heads as jax_init_heads
from ggnn_tpu.native import native_available as jax_native_available
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu.training.variants import make_adapter as jax_make_adapter
from ggnn_tpu_torch import native
from ggnn_tpu_torch.data import native_pack
from ggnn_tpu_torch.export import export_predictor, load_predictor
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _native_library():
    """The libraries build on first use, here, not when the module is
    imported."""
    if not (native.native_available() and jax_native_available()):
        pytest.skip("g++ could not build a native packer")


NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
TOL = dict(rtol=2e-5, atol=2e-5)
TOL_BF16_ANSWERS = 7e-4
ENVELOPE = dict(max_nodes=128, max_graphs=16)

# ----------------------------------------------------- Runner parity

RUNS = {
    "sparse": ({"hidden_size": 16, "layer_timesteps": [2, 1],
                "residual_connections": {"1": [0]}, "batch_size": 300},
               native_pack.SparseProcessed),
    "dense": ({"hidden_size": 16, "batch_size": 4,
               "dense_bucket_sizes": [16, 32]}, native_pack.DenseProcessed),
    "gcn": ({"hidden_size": 16, "num_timesteps": 3, "batch_size": 300,
             "gcn_use_bias": True}, native_pack.GCNProcessed),
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def native_pair(request, tmp_path_factory):
    """The JAX Runner and the port's under the default config (no
    "native_pack" key: native packers in both), same seed, same corpus,
    the JAX weights injected, no dropout, each trained for 2 epochs."""
    variant = request.param
    overrides, kind = RUNS[variant]
    config_json = json.dumps({**overrides, **NO_DROPOUT, "num_epochs": 2,
                              "random_seed": 3})
    train = synthetic_molecules(40, seed=11)
    valid = synthetic_molecules(12, seed=12)
    jax_runner = JaxRunner(variant, jax_resolve_config(
        variant, config_json=config_json), train_data=train,
        valid_data=valid, log_dir=str(tmp_path_factory.mktemp("jax_run")),
        quiet=True, tensorboard=False)
    port_runner = Runner(variant, resolve_config(variant,
                                                 config_json=config_json),
                         train_data=train, valid_data=valid,
                         log_dir=str(tmp_path_factory.mktemp("port_run")),
                         quiet=True, device="cpu")
    assert "native_pack" not in port_runner.config
    assert isinstance(port_runner.train_processed, kind)
    assert type(jax_runner.train_processed).__name__ == kind.__name__
    port_runner.params.load_state_dict(params_from_jax_weights(
        _flatten_named({"params": jax_runner.state["params"]})), strict=True)
    return variant, jax_runner, jax_runner.train(), port_runner, \
        port_runner.train()


def test_native_runner_matches_jax_runner_over_two_epochs(native_pair):
    variant, jax_runner, jax_log, port_runner, port_log = native_pair
    assert len(port_log) == len(jax_log) == 2
    assert port_runner.train_step_id == jax_runner.train_step_id > 2
    assert port_runner.valid_step_id == jax_runner.valid_step_id
    for got, want in zip(port_log, jax_log):
        for split in ("train_results", "valid_results"):
            for i in range(3):   # loss, MAE, error_ratio
                np.testing.assert_allclose(
                    np.asarray(got[split][i]), np.asarray(want[split][i]),
                    rtol=5e-4, err_msg=f"{variant} epoch {got['epoch']} "
                                       f"{split} {i}")


# -------------------------------------------------- Predictor parity

SERVED = {
    "sparse": {"hidden_size": 16, "layer_timesteps": [2, 1, 1],
               "residual_connections": {"2": [0]}},
    "rgcn": {"hidden_size": 16},
    "dense": {"hidden_size": 16, "batch_size": 8,
              "dense_bucket_sizes": [16, 32]},
    "blocked": {"hidden_size": 16, "batch_size": 8,
                "layer_timesteps": [2, 1], "use_edge_bias": True},
    "gcn": {"hidden_size": 16, "num_timesteps": 3, "gcn_use_bias": True},
    "gcn_blocked": {"hidden_size": 16, "batch_size": 8, "num_timesteps": 3},
    "async": {"hidden_size": 16, "propagation_rounds": 2,
              "propagation_substeps": 20},
}


def _jax_checkpoint(path, variant, overrides):
    """JAX initial weights of `variant` under the default config plus
    `overrides`, written by JAX's save_checkpoint."""
    config = jax_resolve_config(variant, config_json=json.dumps(overrides))
    t_dim = 1 if variant in ("gcn", "gcn_blocked") else 4
    model = jax_make_adapter(variant, config,
                             JaxDatasetMeta(64, t_dim, 16)).build_model()
    key = jax.random.PRNGKey(4)
    params = {"graph": model.init_params(key),
              "heads": jax_init_heads(key, 16, config["task_ids"])}
    jax_save(str(path), config, {"params": params}, 5, 2)
    return str(path)


@pytest.mark.parametrize("n_graphs", [1, 40])
@pytest.mark.parametrize("variant", sorted(SERVED))
def test_native_predictor_matches_jax(tmp_path, variant, n_graphs):
    path = _jax_checkpoint(tmp_path / "jax.pickle", variant,
                           SERVED[variant])
    want_pred = JaxPredictor.from_checkpoint(path, variant, **ENVELOPE)
    port = Predictor.from_checkpoint(path, variant, device="cpu",
                                     **ENVELOPE)
    assert "native_pack" not in port.config
    request = synthetic_molecules(n_graphs, seed=80 + n_graphs)
    got, want = port(request), np.asarray(want_pred(request))
    assert got.shape == want.shape == (1, n_graphs)
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------ bf16 dense serving

BF16_DENSE = {"hidden_size": 16, "batch_size": 8, "compute_dtype": "bfloat16",
              "dense_bucket_sizes": [16, 32], "use_edge_bias": True}
# The extended mode with the bf16 adjacency's other readers: attention
# (adjacency times f32 weights) and in-degree averaging.
BF16_BLOCKED = {**BF16_DENSE, "layer_timesteps": [2, 1],
                "use_propagation_attention": True,
                "use_edge_msg_avg_aggregation": True}


@pytest.fixture(scope="module", params=["dense", "blocked"])
def bf16_dense(request, tmp_path_factory):
    variant = request.param
    path = _jax_checkpoint(tmp_path_factory.mktemp("bf16") / "m.pickle",
                           variant,
                           BF16_DENSE if variant == "dense" else BF16_BLOCKED)
    return path, Predictor.from_checkpoint(path, variant, device="cpu")


def _adjacency_bits(adjacency):
    if isinstance(adjacency, torch.Tensor):
        assert adjacency.dtype == torch.bfloat16
        return adjacency.view(torch.int16).numpy().view(np.uint16)
    assert adjacency.dtype == np.dtype(ml_dtypes.bfloat16)
    return adjacency.view(np.uint16)


def test_bf16_dense_predictor_matches_jax(bf16_dense):
    """The native bf16 adjacency in both packages: the same bits in the
    one-graph and the bucket batches, answers within TOL_BF16_ANSWERS."""
    path, port = bf16_dense
    assert port.params.graph.compute_dtype == torch.bfloat16
    jax_pred = JaxPredictor.from_checkpoint(path, port.variant)
    request = synthetic_molecules(30, seed=9)
    np.testing.assert_array_equal(
        _adjacency_bits(port._pack_single_dense(request[0], 5).adjacency),
        _adjacency_bits(jax_pred._pack_single_dense(request[0], 5)
                        .adjacency))
    order, batches = port._dense_batches(request, 5)
    adapter = jax_make_adapter(port.variant, jax_pred.config, JaxDatasetMeta(
        64, 4, 5), drop_remainder=False)
    want_batches = adapter.batches(adapter.preprocess(request, False), False)
    for got, want in zip(batches, want_batches):
        np.testing.assert_array_equal(_adjacency_bits(got.adjacency),
                                      _adjacency_bits(want.adjacency))
    for mols in (request[:1], request):
        got, want = port(mols), np.asarray(jax_pred(mols))
        assert got.shape == want.shape
        assert float(np.max(np.abs(got - want))) <= TOL_BF16_ANSWERS


@pytest.mark.parametrize("export_native", [True, False])
@pytest.mark.parametrize("serve_native", [True, False])
def test_bf16_dense_artifact_dispatches_with_or_without_native(
        bf16_dense, tmp_path, monkeypatch, export_native, serve_native):
    """The artifact's signature fixes the adjacency dtype (bf16 when the
    exporting host packed natively, else f32); a serving host with or
    without the native library feeds it that dtype and answers as the
    live Predictor of the exporting host."""
    path, served = bf16_dense
    variant = served.variant
    if not export_native:
        monkeypatch.setenv("GGNN_TPU_NO_NATIVE", "1")
    live = Predictor.from_checkpoint(path, variant, device="cpu")
    artifact = str(tmp_path / "dense_bf16.ggnnx")
    export_predictor(live, artifact)
    mols = synthetic_molecules(12, seed=6)
    want = live(mols), live(mols[:1])
    if serve_native:
        monkeypatch.delenv("GGNN_TPU_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("GGNN_TPU_NO_NATIVE", "1")
    exported = load_predictor(artifact, device="cpu")
    assert exported._dense_adjacency_dtype() == (
        torch.bfloat16 if export_native else np.float32)
    for got, ref in zip((exported(mols), exported(mols[:1])), want):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
