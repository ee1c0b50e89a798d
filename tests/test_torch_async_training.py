"""The port's async training path (Runner, TF1 goldens, checkpoints, CLI)
against the JAX package and the reference's own execution, on the CPU,
where the receiver sums run the plain versions of kernels B1 and B2.

Tolerances, each with its reason (those tests/test_tf1_golden.py pins for
the JAX package's async model):
  * per-round node states and outputs of the TF1 goldens: 2e-5;
  * the validation epoch: loss and MAE rtol 3e-5, error ratio rtol 3e-4;
  * one Adam step against the reference's `p/`: rtol 5e-5 / atol 5e-6;
  * the reference's recorded gradients through clip and Adam: rtol 1e-4 /
    atol 2e-6; ten recomputed steps: rtol 2e-3 / atol 6e-3 (Adam turns
    f32 noise on near-zero gradients into O(lr) steps, and the async net
    has the most such elements; tests/test_tf1_golden.py measures 4.4e-3);
  * the Runner against the JAX Runner per epoch: rtol 5e-4 (two epochs of
    f32 training in another summation order).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from ggnn_tpu.compat.tf1 import params_from_tf1_weights
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch import cli
from ggnn_tpu_torch.data.synthetic import async_fixture_molecules
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training.checkpoint import (optimizer_entries,
                                                params_from_jax_weights)
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.optimizer import TFAdam
from ggnn_tpu_torch.training.runner import Runner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tf1")
TOL = dict(rtol=2e-5, atol=2e-5)
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
# The synthetic corpus reaches schedule depth 17; the default 15 raises.
SMALL = {"hidden_size": 16, "propagation_rounds": 2,
         "propagation_substeps": 40, "num_nodes": 200,
         "use_edge_bias": True}


def _bridge(jax_params):
    """{port parameter name: tensor} of a JAX params tree."""
    return params_from_jax_weights(_flatten_named({"params": jax_params}))


def _flat(tree, prefix):
    return {k: np.asarray(v) for k, v in _flatten_named({prefix: tree})
            .items()}


# -------------------------------------------------------- TF1 goldens

def _load_fixture(case):
    data = np.load(os.path.join(FIXTURE_DIR, f"{case}.npz"))
    return json.loads(str(data["meta"])), data


def _group(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def _quirk_mirror(data):
    """The reference async model's effective graph, as
    tests/test_tf1_golden.py:_async_quirk_mirror feeds it to the JAX
    package: every type shifted up by one (the reference leaves slot 0
    empty and drops the largest type's messages), so num_edge_types grows
    by one and the converter fills the new last slot with zeros."""
    return [{"targets": d["targets"],
             "graph": [[a, t + 1, b] for (a, t, b) in d["graph"]],
             "node_features": d["node_features"]} for d in data]


def _golden_runner(meta, tmp_path):
    corpus = meta["corpus"]
    train, valid = (_quirk_mirror(async_fixture_molecules(
        corpus[f"n_{split}"], seed=corpus["seed"] + i,
        num_targets=corpus["num_targets"]))
        for i, split in enumerate(("train", "valid")))
    config = resolve_config("async", config_json=json.dumps(meta["config"]))
    runner = Runner("async", config, train_data=train, valid_data=valid,
                    log_dir=str(tmp_path), quiet=True, device="cpu")
    assert runner.meta.num_edge_types == meta["num_edge_types"] + 1
    assert runner.meta.annotation_size == meta["annotation_size"]
    return runner, config


def _tf1_params(weights, config, t_dim):
    return _bridge(params_from_tf1_weights("async", weights, config, t_dim,
                                           async_slots="raw"))


def _assert_params(got, want, dropped, err, **tol):
    """Every parameter but the dropped type's slot, which has no
    reference counterpart."""
    compared = 0
    for name, value in want.items():
        if (name.startswith(("graph.edge_weights.", "graph.edge_biases."))
                and name.endswith(f".{dropped}")):
            continue
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   value.numpy(), err_msg=f"{err}: {name}",
                                   **tol)
        compared += 1
    return compared


@pytest.mark.parametrize("case", ["async_default", "async_bias_rnn"])
def test_tf1_golden_async(case, tmp_path):
    """The reference's async model (chem_tensorflow_async.py) from its
    weights `w/`: per-round node states of the first validation batch
    (the plain path), the per-graph output, the validation epoch (the
    segmented path), one train step to the reference's `p/` and, where
    the fixture records them, its ten steps `t/`: through its recorded
    gradients, and recomputing them."""
    meta, data = _load_fixture(case)
    runner, config = _golden_runner(meta, tmp_path)
    t_dim = runner.meta.num_edge_types
    dropped = meta["num_edge_types"]
    runner.params.load_state_dict(
        _tf1_params(_group(data, "w/"), config, t_dim), strict=True)
    batch = next(iter(runner.adapter.batches(runner.valid_processed,
                                             False))).to("cpu")
    assert batch.seg_rounds is not None
    with torch.no_grad():
        rounds = runner.model(batch, return_all_rounds=True)
        for r in range(config["propagation_rounds"]):
            want = np.asarray(data[f"round_states_{r}"], np.float32)
            np.testing.assert_allclose(rounds[r].numpy()[:want.shape[0]],
                                       want, err_msg=f"round {r}", **TOL)
        np.testing.assert_allclose(
            runner.model(batch).numpy(), rounds[-1].numpy(), **TOL)
        out = runner.model.readout(runner.params.heads, runner.task_ids,
                                   rounds[-1], batch)
    g = meta["batch_num_graphs"]
    np.testing.assert_allclose(out[-1, :g].numpy(), np.asarray(
        data["output"], np.float32).reshape(-1)[:g], **TOL)

    loss, accs, ratios, _, steps = runner.run_epoch(
        "golden", runner.valid_processed, False)
    assert steps == meta["valid_steps"]
    np.testing.assert_allclose(loss, meta["valid_loss"], rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(accs, meta["valid_accuracies"], rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ratios, meta["valid_error_ratios"],
                               rtol=3e-4, atol=1e-6)

    runner.train_step(batch)
    got = dict(runner.params.named_parameters())
    assert _assert_params(got, _tf1_params(_group(data, "p/"), config,
                                           t_dim), dropped,
                          f"{case} one step", rtol=5e-5,
                          atol=5e-6) >= meta["num_edge_types"] + 4

    k_steps = meta.get("trajectory_steps", 0)
    if not k_steps:
        return
    want = _tf1_params(_group(data, "t/"), config, t_dim)
    for _ in range(k_steps - 1):
        runner.train_step(batch)
    assert runner.optimizer.count == k_steps
    _assert_params(got, want, dropped, f"{case} step {k_steps}", rtol=2e-3,
                   atol=6e-3)
    # The recorded pre-clip gradients through clip and Adam: the
    # converter maps the dropped slot's missing gradient to zeros.
    runner.params.load_state_dict(
        _tf1_params(_group(data, "w/"), config, t_dim), strict=True)
    opt = TFAdam(runner.params, config["learning_rate"],
                 config["clamp_gradient_norm"])
    for k in range(1, k_steps + 1):
        opt.step(_tf1_params(_group(data, f"gt{k}/"), config, t_dim))
    _assert_params(dict(runner.params.named_parameters()), want, dropped,
                   f"{case} gradient replay", rtol=1e-4, atol=2e-6)


# ------------------------------------------------------ Runner parity

@pytest.fixture(scope="module", params=["graphs", "batches"])
def trained_async_pair(request, tmp_path_factory):
    """The JAX Runner and the port's for `async`, same seed, same corpus,
    injected weights, no dropout, each trained for 2 epochs, with the
    graph shuffle or the batch-order shuffle."""
    config_json = json.dumps({**SMALL, **NO_DROPOUT, "num_epochs": 2,
                              "random_seed": 3,
                              "async_epoch_shuffle": request.param})
    train = synthetic_molecules(40, seed=11)
    valid = synthetic_molecules(12, seed=12)
    jax_runner = JaxRunner("async", resolve_config(
        "async", config_json=config_json), train_data=train,
        valid_data=valid, log_dir=str(tmp_path_factory.mktemp("jax_run")),
        quiet=True, tensorboard=False)
    port_runner = Runner("async", resolve_config(
        "async", config_json=config_json), train_data=train,
        valid_data=valid, log_dir=str(tmp_path_factory.mktemp("port_run")),
        quiet=True, device="cpu")
    port_runner.params.load_state_dict(
        _bridge(jax_runner.state["params"]), strict=True)
    jax_log = jax_runner.train()
    port_log = port_runner.train()
    return jax_runner, jax_log, port_runner, port_log, train, valid


def test_async_runner_matches_jax_runner_over_two_epochs(trained_async_pair):
    jax_runner, jax_log, port_runner, port_log, _, _ = trained_async_pair
    assert len(port_log) == len(jax_log) == 2
    assert port_runner.train_step_id == jax_runner.train_step_id > 2
    assert port_runner.valid_step_id == jax_runner.valid_step_id
    assert port_runner.prop_steps == jax_runner.prop_steps == 2
    assert dataclasses.asdict(port_runner.adapter.caps) == \
        dataclasses.asdict(jax_runner.adapter.caps)
    for got, want in zip(port_log, jax_log):
        for split in ("train_results", "valid_results"):
            for i in range(3):   # loss, MAE, error_ratio
                np.testing.assert_allclose(
                    np.asarray(got[split][i]), np.asarray(want[split][i]),
                    rtol=5e-4, err_msg=f"epoch {got['epoch']} {split} {i}")
    assert port_runner.last_edge_msg_per_sec > 0


def test_async_checkpoints_restore_across_packages(trained_async_pair,
                                                  tmp_path):
    """The final weights and Adam state of each Runner, saved by its own
    package, restore in the other's Runner, and the port's checkpoint
    serves in the JAX Predictor as in the port's."""
    jax_runner, _, port_runner, _, train, valid = trained_async_pair
    port_path = str(tmp_path / "port.pickle")
    port_runner._save(port_path)
    with open(port_path, "rb") as f:
        assert pickle.load(f)["train_step"] == port_runner.train_step_id
    restored = JaxRunner("async", dict(port_runner.config), train_data=train,
                         valid_data=valid, log_dir=str(tmp_path / "jax"),
                         quiet=True, tensorboard=False, restore=port_path)
    want = optimizer_entries(port_runner.optimizer)
    got = _flat(restored.state["opt_state"], "opt_state")
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    for name, value in _bridge(restored.state["params"]).items():
        np.testing.assert_array_equal(
            value.numpy(),
            dict(port_runner.params.named_parameters())[name].detach()
            .numpy())
    request = valid[:5]
    np.testing.assert_allclose(
        Predictor.from_checkpoint(port_path, "async", device="cpu",
                                  max_nodes=128, max_graphs=8)(request),
        np.asarray(JaxPredictor.from_checkpoint(
            port_path, "async", max_nodes=128, max_graphs=8)(request)),
        **TOL)

    jax_path = str(tmp_path / "jax.pickle")
    jax_save(jax_path, jax_runner.config, jax_runner.state,
             jax_runner.train_step_id, jax_runner.valid_step_id)
    port = Runner("async", dict(jax_runner.config), train_data=train,
                  valid_data=valid, log_dir=str(tmp_path / "port"),
                  quiet=True, device="cpu", restore=jax_path)
    assert port.optimizer.count == jax_runner.train_step_id
    want = _flat(jax_runner.state["opt_state"], "opt_state")
    for key, value in optimizer_entries(port.optimizer).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


# ----------------------------------------------------------------- CLI

def test_cli_trains_async_on_the_cpu(tmp_path):
    config = json.dumps({"num_epochs": 2, "hidden_size": 16,
                         "propagation_substeps": 40, "num_nodes": 400})
    proc = subprocess.run(
        [sys.executable, "-m", "ggnn_tpu_torch.cli", "async",
         "--synthetic", "60", "--device", "cpu", "--quiet", "--config",
         config, "--log_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = os.listdir(tmp_path)
    for suffix in ("_log.json", "_params.json", "_model_best.pickle"):
        assert sum(n.endswith(suffix) for n in names) == 1, suffix
    best = [n for n in names if n.endswith("_model_best.pickle")][0]
    out = np.asarray(JaxPredictor.from_checkpoint(
        str(tmp_path / best), "async", max_nodes=128, max_graphs=8)(
            synthetic_molecules(5, seed=2)))
    assert out.shape == (1, 5) and np.isfinite(out).all()


def test_cli_async_without_cuda_exits_nonzero(monkeypatch, tmp_path,
                                              capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["async", "--synthetic", "20", "--quiet", "--log_dir",
                     str(tmp_path)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
