"""Training and serving `configs/sparse_attention.json` in the port on the
CPU, against the JAX package: the Runner over two epochs, a checkpoint
with the per-layer `attention` leaves that round-trips JAX -> port ->
JAX with its Adam moments, the Predictor on it, and the CLI with the
attention config and the per-type and per-edge keys.

Tolerances: Runner parity per epoch rtol 5e-4 (two epochs of f32
training in another summation order, as tests/test_torch_training.py);
serving 2e-5 (the TF1 golden bound); a checkpoint's arrays exactly.
Dropout is off (keep probabilities 1.0): the two packages draw their
masks from different generators.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training.checkpoint import (optimizer_entries,
                                                params_from_jax_weights)
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILE = os.path.join(ROOT, "configs", "sparse_attention.json")
OVERRIDES = {"hidden_size": 16, "batch_size": 300, "num_epochs": 2,
             "native_pack": False, "random_seed": 3,
             "edge_weight_dropout_keep_prob": 1.0,
             "graph_state_dropout_keep_prob": 1.0,
             "out_layer_dropout_keep_prob": 1.0}


def _flat(tree, prefix):
    return {k: np.asarray(v) for k, v in _flatten_named({prefix: tree})
            .items()}


@pytest.fixture(scope="module")
def attention_pair(tmp_path_factory):
    """The JAX Runner and the port's on configs/sparse_attention.json at
    hidden 16, same seed, corpus and injected weights, each trained for
    2 epochs."""
    config_json = json.dumps(OVERRIDES)
    train = synthetic_molecules(40, seed=11)
    valid = synthetic_molecules(12, seed=12)
    jax_config = jax_resolve_config("sparse", CONFIG_FILE, config_json)
    config = resolve_config("sparse", CONFIG_FILE, config_json)
    assert config == jax_config and config["use_propagation_attention"]
    jax_runner = JaxRunner("sparse", jax_config, train_data=train,
                           valid_data=valid,
                           log_dir=str(tmp_path_factory.mktemp("jax")),
                           quiet=True, tensorboard=False)
    port_runner = Runner("sparse", config, train_data=train,
                         valid_data=valid,
                         log_dir=str(tmp_path_factory.mktemp("port")),
                         quiet=True, device="cpu")
    port_runner.params.load_state_dict(params_from_jax_weights(
        _flatten_named({"params": jax_runner.state["params"]})), strict=True)
    jax_log = jax_runner.train()
    port_log = port_runner.train()
    return jax_runner, jax_log, port_runner, port_log, train, valid


def test_attention_runner_matches_jax_runner_over_two_epochs(
        attention_pair):
    jax_runner, jax_log, port_runner, port_log, _, _ = attention_pair
    names = [n for n, _ in port_runner.params.named_parameters()]
    assert sum(n.endswith(".attention") for n in names) == 5
    assert len(port_log) == len(jax_log) == 2
    assert port_runner.train_step_id == jax_runner.train_step_id > 2
    for got, want in zip(port_log, jax_log):
        for split in ("train_results", "valid_results"):
            for i in range(3):   # loss, MAE, error_ratio
                np.testing.assert_allclose(
                    np.asarray(got[split][i]), np.asarray(want[split][i]),
                    rtol=5e-4, err_msg=f"epoch {got['epoch']} {split} {i}")
    # The factors moved from their initial ones in both packages, alike.
    jax_att = np.asarray(jax_runner.state["params"]["graph"]["layers"][2]
                         ["attention"])
    port_att = port_runner.params.graph.layers[2].attention.detach().numpy()
    assert not np.allclose(port_att, 1.0)
    np.testing.assert_allclose(port_att, jax_att, rtol=5e-4, atol=1e-6)


def test_attention_checkpoint_round_trips_jax_port_jax(attention_pair,
                                                       tmp_path):
    """JAX's best checkpoint restores in the port's Runner (weights and
    Adam moments, the attention leaves among them); the port writes it
    again, and JAX restores that with the same arrays."""
    jax_runner, _, _, _, train, valid = attention_pair
    with open(jax_runner.best_model_file, "rb") as f:
        want = pickle.load(f)["weights"]
    assert any(k.endswith("['attention']") for k in want)
    port = Runner("sparse", dict(jax_runner.config), train_data=train,
                  valid_data=valid, log_dir=str(tmp_path / "port"),
                  quiet=True, device="cpu",
                  restore=jax_runner.best_model_file)
    got_opt = optimizer_entries(port.optimizer)
    assert any("['attention']" in k for k in got_opt)
    for key, value in got_opt.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    again = str(tmp_path / "again.pickle")
    port._save(again)
    restored = JaxRunner("sparse", dict(jax_runner.config), train_data=train,
                         valid_data=valid, log_dir=str(tmp_path / "jax"),
                         quiet=True, tensorboard=False, restore=again)
    got = {**_flat(restored.state["params"], "params"),
           **_flat(restored.state["opt_state"], "opt_state")}
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_attention_checkpoint_serves_as_jax_serves_it(attention_pair):
    jax_runner, _, _, _, _, valid = attention_pair
    path = jax_runner.best_model_file
    envelope = dict(max_nodes=64, max_graphs=8)
    want = JaxPredictor.from_checkpoint(path, "sparse", **envelope)(valid)
    port = Predictor.from_checkpoint(path, "sparse", device="cpu",
                                     **envelope)
    got = port(valid)
    assert got.shape == want.shape == (1, len(valid))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("extra", [
    {}, {"aggregate_first": False}, {"combined_edge_lanes": False},
    {"edges_sorted_by_target": False}])
def test_cli_trains_the_attention_config_on_the_cpu(tmp_path, extra):
    config = json.dumps({"num_epochs": 1, "hidden_size": 16,
                         "batch_size": 400, **extra})
    proc = subprocess.run(
        [sys.executable, "-m", "ggnn_tpu_torch.cli", "sparse",
         "--config-file", CONFIG_FILE, "--synthetic", "40", "--device",
         "cpu", "--quiet", "--config", config, "--log_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    params = [n for n in os.listdir(tmp_path) if n.endswith("_params.json")]
    assert len(params) == 1
    with open(tmp_path / params[0]) as f:
        saved = json.load(f)
    assert saved["use_propagation_attention"] is True
    for key, value in extra.items():
        assert saved[key] == value
    assert any(n.endswith("_model_best.pickle") for n in os.listdir(tmp_path))
