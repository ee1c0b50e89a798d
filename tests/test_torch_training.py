"""The port's training path (dropout, loss, optimizer, Runner, checkpoints,
CLI) against the JAX package and the TF1 goldens, on the CPU.

Tolerances, each with its reason:
  * optimizer vs optax over 10 steps of the same gradients: rtol 1e-5 /
    atol 1e-6 (f32 arithmetic in another order);
  * grad replay of the reference's recorded gradients: rtol 1e-4 /
    atol 2e-6, and TF1 one-step goldens `p/`: rtol 5e-5 / atol 5e-6, the
    bounds tests/test_tf1_golden.py pins for the JAX package;
  * the 10-step trajectory: rtol 5e-4 / atol 5e-5 (compounding f32
    steps, as tests/test_tf1_golden.py:_assert_trajectory explains);
  * loss vs JAX: 1e-6; Runner parity per epoch: rtol 5e-4 (two epochs of
    f32 training in another summation order).
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.compat.tf1 import params_from_tf1_weights
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models import base as jax_base
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.optimizer import make_optimizer
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch import cli
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.ops import dropout as port_dropout
from ggnn_tpu_torch.ops import mlp
from ggnn_tpu_torch.training.checkpoint import (optimizer_entries,
                                                params_from_jax_weights)
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.optimizer import TFAdam, clip_by_norm
from ggnn_tpu_torch.training.runner import Runner

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tf1")
GOLDEN_CASES = ["sparse_default", "sparse_one_step", "sparse_three_steps",
                "rgcn", "sparse_freeze", "sparse_multitask", "dense_default",
                "sparse_attention_bias"]
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
SMALL = {"hidden_size": 16, "layer_timesteps": [2, 1],
         "residual_connections": {"1": [0]}, "batch_size": 300}


def _bridge(jax_params):
    """{port parameter name: tensor} of a JAX params tree."""
    return params_from_jax_weights(_flatten_named({"params": jax_params}))


def _flat(tree, prefix):
    return {k: np.asarray(v) for k, v in _flatten_named({prefix: tree})
            .items()}


# ------------------------------------------------------------- dropout

def test_dropout_identity_raise_and_scaling():
    x = torch.arange(1.0, 7.0)
    gen = torch.Generator().manual_seed(0)
    assert port_dropout.dropout(x, 1.0, gen) is x
    assert port_dropout.dropout(x, 1.5, None) is x
    for bad in (0.0, -0.5):
        with pytest.raises(ValueError, match="keep_prob"):
            port_dropout.dropout(x, bad, gen)
    y = port_dropout.dropout(x, 0.25, gen)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * 4)


def test_dropout_mask_density_and_seeding():
    n, keep = 200_000, 0.8
    x = torch.ones(n)
    y = port_dropout.dropout(x, keep, torch.Generator().manual_seed(1))
    density = float((y != 0).float().mean())
    # Five standard deviations of a binomial(n, keep) share.
    assert abs(density - keep) < 5 * np.sqrt(keep * (1 - keep) / n)
    y_again = port_dropout.dropout(x, keep, torch.Generator().manual_seed(1))
    y_other = port_dropout.dropout(x, keep, torch.Generator().manual_seed(2))
    assert torch.equal(y, y_again) and not torch.equal(y, y_other)


def test_mlp_weight_dropout_masks_the_weights():
    layers = mlp.mlp_init(torch.Generator().manual_seed(0), 6, 3, (5,))
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
    got = mlp.mlp_apply(layers, x, keep_prob=0.5,
                        generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    acts, hid = x, x
    for layer in layers:
        w = port_dropout.dropout(layer.W, 0.5, gen)
        hid = acts @ w + layer.b
        acts = torch.relu(hid)
    torch.testing.assert_close(got, hid, rtol=0, atol=0)
    assert not torch.equal(got, mlp.mlp_apply(layers, x))


def _tiny_batch(config, t_dim=4):
    from ggnn_tpu_torch.data import packing
    proc = packing.preprocess_sparse(synthetic_molecules(6, seed=3), t_dim,
                                     True, [0], {}, False)
    return next(packing.pack_sparse_batches(
        proc, t_dim, 200, packing.PackCapacities(192, 256, 8, 256),
        config["hidden_size"], 5, False, None)).to("cpu")


def test_edge_weight_masks_are_shared_by_all_steps_of_a_layer(monkeypatch):
    import ggnn_tpu_torch.models.sparse_ggnn as sparse_module
    config = resolve_config("sparse", config_json=json.dumps(
        {"hidden_size": 16, "layer_timesteps": [3, 2],
         "residual_connections": {}, "edge_weight_dropout_keep_prob": 0.5,
         "graph_state_dropout_keep_prob": 1.0}))
    model = SparseGGNN(config, 4, torch.Generator().manual_seed(0))
    seen = []
    real = sparse_module.aggregate_then_transform_combined
    monkeypatch.setattr(
        sparse_module, "aggregate_then_transform_combined",
        lambda h, s, ty, tg, w, *a, **k: seen.append(w) or real(
            h, s, ty, tg, w, *a, **k))
    with torch.no_grad():
        model(_tiny_batch(config), is_training=True,
              generator=torch.Generator().manual_seed(5))
    assert len(seen) == 5
    for layer_idx, steps in ((0, range(0, 3)), (1, range(3, 5))):
        for i in steps:
            assert torch.equal(seen[i], seen[steps[0]])
        w = model.layers[layer_idx].edge_weights
        kept = seen[steps[0]] != 0
        assert 0.3 < float(kept.float().mean()) < 0.7
        torch.testing.assert_close(seen[steps[0]][kept], 2 * w[kept])
    assert not torch.equal(seen[0] != 0, seen[3] != 0)


def test_training_forward_is_reproducible_from_the_generator_seed():
    config = resolve_config("sparse", config_json=json.dumps(
        {"hidden_size": 16, "layer_timesteps": [2],
         "residual_connections": {}, "graph_state_dropout_keep_prob": 0.7}))
    model = SparseGGNN(config, 4, torch.Generator().manual_seed(0))
    batch = _tiny_batch(config)

    def run(seed):
        with torch.no_grad():
            return model(batch, is_training=True,
                         generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    with torch.no_grad():
        assert torch.equal(model(batch), model(batch))  # eval: no dropout
    with pytest.raises(ValueError, match="Generator"):
        model(batch, is_training=True)


# ---------------------------------------------------------------- loss

@pytest.mark.parametrize("ratios", [{}, {0: 0.5, "2": 0.25},
                                    {2: 0.2, "0": 0.9}])
def test_masked_regression_loss_matches_jax(ratios):
    """The rescale looks ratios up by INTEGER task id: string keys (what
    JSON configs give) leave it at 1.0."""
    rng = np.random.RandomState(0)
    computed = rng.randn(2, 7).astype(np.float32)
    targets = rng.randn(2, 7).astype(np.float32)
    mask = (rng.rand(2, 7) < 0.7).astype(np.float32)
    want_loss, want_acc = jax_base.masked_regression_loss(
        jnp.asarray(computed), jnp.asarray(targets), jnp.asarray(mask),
        [0, 2], ratios)
    loss, acc = base.masked_regression_loss(
        torch.from_numpy(computed), torch.from_numpy(targets),
        torch.from_numpy(mask), [0, 2], ratios)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), rtol=1e-6)


# ----------------------------------------------------------- optimizer

def _jax_and_port_params(seed=0):
    config = resolve_config("sparse", config_json=json.dumps(
        {"hidden_size": 8, "layer_timesteps": [1, 1],
         "residual_connections": {}}))
    key = jax.random.PRNGKey(seed)
    jax_params = {
        "graph": JaxSparseGGNN(config, 3).init_params(key),
        "heads": jax_base.init_output_heads(key, 8, [0, 1])}
    gen = torch.Generator().manual_seed(0)
    port = ModelParams(SparseGGNN(config, 3, gen),
                       init_output_heads(gen, 8, [0, 1]))
    port.load_state_dict(_bridge(jax_params), strict=True)
    return jax_params, port


@pytest.mark.parametrize("freeze", [False, True])
def test_optimizer_matches_jax_over_ten_steps(freeze):
    """Per-leaf clip + TF1 Adam against the JAX package's optax chain on
    the same random gradients: parameters and Adam state, compared under
    the JAX key names the checkpoint uses."""
    jax_params, port = _jax_and_port_params()
    opt = make_optimizer(0.01, 0.5, freeze)
    state = opt.init(jax_params)
    port_opt = TFAdam(port, 0.01, 0.5, freeze)
    graph_before = {n: p.clone() for n, p in port.named_parameters()
                    if n.startswith("graph.")}
    rng = np.random.RandomState(1)
    for _ in range(10):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * rng.choice([0.01, 3.0]))
            .astype(np.float32), jax_params)
        updates, state = opt.update(grads, state, jax_params)
        jax_params = jax.tree_util.tree_map(lambda p, u: p + u, jax_params,
                                            updates)
        port_opt.step({n: g for n, g in _bridge(grads).items()
                       if n in port_opt.params})
    for name, value in _bridge(jax_params).items():
        np.testing.assert_allclose(dict(port.named_parameters())[name]
                                   .detach().numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    if freeze:
        for name, before in graph_before.items():
            assert torch.equal(dict(port.named_parameters())[name], before)
        assert not any(n.startswith("graph.") for n in port_opt.mu)
    want_state = _flat(state, "opt_state")
    got_state = optimizer_entries(port_opt)
    assert sorted(got_state) == sorted(want_state)
    for key, value in want_state.items():
        np.testing.assert_allclose(got_state[key], value, rtol=1e-5,
                                   atol=1e-7, err_msg=key)


def test_clip_by_norm_is_per_tensor():
    g = torch.tensor([3.0, 4.0])
    torch.testing.assert_close(clip_by_norm(g, 1.0),
                               torch.tensor([0.6, 0.8]))
    torch.testing.assert_close(clip_by_norm(g, 10.0), g)


# ------------------------------------------------------- TF1 goldens

def _load_fixture(case):
    data = np.load(os.path.join(FIXTURE_DIR, f"{case}.npz"))
    meta = json.loads(str(data["meta"]))
    return meta, data


def _group(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def _fixture_runner(meta, tmp_path):
    corpus = meta["corpus"]
    train = synthetic_molecules(corpus["n_train"], seed=corpus["seed"],
                                num_targets=corpus["num_targets"])
    valid = synthetic_molecules(corpus["n_valid"], seed=corpus["seed"] + 1,
                                num_targets=corpus["num_targets"])
    config = resolve_config(meta["variant"],
                            config_json=json.dumps(meta["config"]))
    runner = Runner(meta["variant"], config, train_data=train,
                    valid_data=valid, log_dir=str(tmp_path), quiet=True,
                    freeze_graph_model=meta.get("freeze_graph_model", False),
                    device="cpu")
    assert runner.meta.num_edge_types == meta["num_edge_types"]
    return runner, config


def _tf1_params(meta, weights, config, t_dim):
    return _bridge(params_from_tf1_weights(meta["variant"], weights, config,
                                           t_dim, async_slots="raw"))


def _assert_params(runner, want, err, **tol):
    got = dict(runner.params.named_parameters())
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   value.numpy(), err_msg=f"{err}: {name}",
                                   **tol)


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_tf1_golden_train_step(case, tmp_path):
    """A port train step from the reference's initial weights `w/` on the
    first validation batch gives the reference's post-step weights `p/`
    (gradients of every parameter, clip-by-norm, TF1 Adam, freeze)."""
    meta, data = _load_fixture(case)
    runner, config = _fixture_runner(meta, tmp_path)
    t_dim = runner.meta.num_edge_types
    runner.params.load_state_dict(
        _tf1_params(meta, _group(data, "w/"), config, t_dim), strict=True)

    loss, accs, ratios, _, steps = runner.run_epoch(
        "golden", runner.valid_processed, False)
    assert steps == meta["valid_steps"]
    np.testing.assert_allclose(loss, meta["valid_loss"], rtol=3e-5,
                               atol=1e-6)
    np.testing.assert_allclose(accs, meta["valid_accuracies"], rtol=3e-5,
                               atol=1e-6)

    batch = next(iter(runner.adapter.batches(runner.valid_processed,
                                             False))).to("cpu")
    runner.train_step(batch)
    _assert_params(runner, _tf1_params(meta, _group(data, "p/"), config,
                                       t_dim),
                   f"{case} one step", rtol=5e-5, atol=5e-6)

    k_steps = meta.get("trajectory_steps", 0)
    if k_steps:
        for _ in range(k_steps - 1):
            runner.train_step(batch)
        assert runner.optimizer.count == k_steps
        _assert_params(runner, _tf1_params(meta, _group(data, "t/"), config,
                                           t_dim),
                       f"{case} step {k_steps}", rtol=5e-4, atol=5e-5)


def _grad_replay(case, model_cls):
    """The reference's recorded pre-clip gradients gt1/..gt10/ through the
    port's clip -> Adam from `w/` give the reference's step-10 weights
    `t/`: optimizer semantics alone, chaos-free."""
    meta, data = _load_fixture(case)
    config = resolve_config(meta["variant"],
                            config_json=json.dumps(meta["config"]))
    t_dim = meta["num_edge_types"]
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(model_cls(config, t_dim, gen),
                         init_output_heads(gen, config["hidden_size"],
                                           config["task_ids"]))
    params.load_state_dict(_tf1_params(meta, _group(data, "w/"), config,
                                       t_dim), strict=True)
    opt = TFAdam(params, config["learning_rate"],
                 config["clamp_gradient_norm"])
    k_steps = meta["trajectory_steps"]
    for k in range(1, k_steps + 1):
        opt.step(_tf1_params(meta, _group(data, f"gt{k}/"), config, t_dim))
    want = _tf1_params(meta, _group(data, "t/"), config, t_dim)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=2e-6, err_msg=name)


def test_tf1_grad_replay(tmp_path):
    _grad_replay("sparse_default", SparseGGNN)


def test_tf1_grad_replay_dense():
    _grad_replay("dense_default", DenseGGNN)


# ------------------------------------------- Runner parity, checkpoints

@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """The JAX Runner and the port's, same seed, same corpus, same
    injected weights, numpy packers and no dropout, each trained for 2
    epochs."""
    config_json = json.dumps({**SMALL, **NO_DROPOUT, "num_epochs": 2,
                              "native_pack": False, "random_seed": 3})
    train = synthetic_molecules(40, seed=11)
    valid = synthetic_molecules(12, seed=12)
    jax_dir = str(tmp_path_factory.mktemp("jax_run"))
    port_dir = str(tmp_path_factory.mktemp("port_run"))
    jax_config = resolve_config("sparse", config_json=config_json)
    jax_runner = JaxRunner("sparse", jax_config, train_data=train,
                           valid_data=valid, log_dir=jax_dir, quiet=True,
                           tensorboard=False)
    port_runner = Runner("sparse", resolve_config(
        "sparse", config_json=config_json), train_data=train,
        valid_data=valid, log_dir=port_dir, quiet=True, device="cpu")
    port_runner.params.load_state_dict(
        _bridge(jax_runner.state["params"]), strict=True)
    jax_log = jax_runner.train()
    port_log = port_runner.train()
    return jax_runner, jax_log, port_runner, port_log, train, valid


def test_runner_matches_jax_runner_over_two_epochs(trained_pair):
    jax_runner, jax_log, port_runner, port_log, _, _ = trained_pair
    assert len(port_log) == len(jax_log) == 2
    assert port_runner.train_step_id == jax_runner.train_step_id > 2
    assert port_runner.valid_step_id == jax_runner.valid_step_id
    assert port_runner.optimizer.count == port_runner.train_step_id
    for got, want in zip(port_log, jax_log):
        assert got["epoch"] == want["epoch"]
        for split in ("train_results", "valid_results"):
            for i in range(3):   # loss, MAE, error_ratio
                np.testing.assert_allclose(
                    np.asarray(got[split][i]), np.asarray(want[split][i]),
                    rtol=5e-4, err_msg=f"epoch {got['epoch']} {split} {i}")
    assert port_runner.last_edge_msg_per_sec > 0
    with open(port_runner.log_file) as f:
        assert len(json.load(f)) == 2
    params_file = port_runner.log_file.replace("_log.json", "_params.json")
    with open(params_file) as f:
        assert json.load(f) == port_runner.config


def test_port_checkpoint_restores_in_jax_runner_and_predictor(trained_pair,
                                                             tmp_path):
    _, _, port_runner, _, train, valid = trained_pair
    path = port_runner.best_model_file
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["train_step"] == port_runner.train_step_id
    restored = JaxRunner("sparse", dict(port_runner.config),
                         train_data=train, valid_data=valid,
                         log_dir=str(tmp_path), quiet=True,
                         tensorboard=False, restore=path)
    assert int(restored.state["opt_state"][1]["count"]) == \
        port_runner.optimizer.count
    want = optimizer_entries(port_runner.optimizer)
    got = _flat(restored.state["opt_state"], "opt_state")
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    for name, value in _bridge(restored.state["params"]).items():
        np.testing.assert_array_equal(
            value.numpy(),
            dict(port_runner.params.named_parameters())[name].detach()
            .numpy())
    predictor = JaxPredictor.from_checkpoint(path, "sparse")
    out = np.asarray(predictor(valid[:5]))
    assert out.shape == (1, 5) and np.isfinite(out).all()


def test_jax_checkpoint_restores_in_port_runner(trained_pair, tmp_path):
    jax_runner, _, _, _, train, valid = trained_pair
    messages = []
    port = Runner("sparse", dict(jax_runner.config), train_data=train,
                  valid_data=valid, log_dir=str(tmp_path), quiet=True,
                  device="cpu", restore=jax_runner.best_model_file)
    assert port.optimizer.count == \
        int(jax_runner.state["opt_state"][1]["count"])
    assert port.train_step_id == jax_runner.train_step_id
    want = _flat(jax_runner.state["opt_state"], "opt_state")
    for key, value in optimizer_entries(port.optimizer).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    # A checkpoint without Adam state restores the weights and warns.
    from ggnn_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    bare = str(tmp_path / "bare.pickle")
    save_checkpoint(bare, port.config, port.params, 1, 1)
    restore_checkpoint(bare, port.config, port.params,
                       log=messages.append, optimizer=port.optimizer)
    assert any("['opt_state'][1]['count']" in m and "Freshly" in m
               for m in messages)


# ----------------------------------------------------------------- CLI

def test_cli_trains_on_the_cpu(tmp_path):
    config = json.dumps({"num_epochs": 2, "hidden_size": 16,
                         "batch_size": 400, "layer_timesteps": [1, 1],
                         "residual_connections": {}})
    proc = subprocess.run(
        [sys.executable, "-m", "ggnn_tpu_torch.cli", "sparse",
         "--synthetic", "60", "--device", "cpu", "--quiet", "--config",
         config, "--log_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = os.listdir(tmp_path)
    logs = [n for n in names if n.endswith("_log.json")]
    assert len(logs) == 1
    assert any(n.endswith("_model_best.pickle") for n in names)
    with open(tmp_path / logs[0]) as f:
        assert len(json.load(f)) == 2


def test_cli_without_cuda_or_with_unported_options_exits_nonzero(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--synthetic", "20", "--quiet", "--log_dir", str(tmp_path)]
    assert cli.main(["sparse", *args]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["async", *args]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    # --evaluate is ported (ROADMAP A9): it runs on the GPU as training
    # does, and without CUDA it fails the same way.
    assert cli.main(["rgcn", "--evaluate", *args]) != 0
    assert "no CUDA device" in capsys.readouterr().err


# ------------------------------------------------------ dense family

DENSE_RUNS = {
    "dense": {"hidden_size": 16, "batch_size": 4,
              "dense_bucket_sizes": [16, 32]},
    "blocked": {"hidden_size": 16, "batch_size": 8,
                "dense_bucket_sizes": [16, 32], "layer_timesteps": [2, 1],
                "residual_connections": {"1": [0]}},
}


@pytest.fixture(scope="module", params=sorted(DENSE_RUNS))
def trained_dense_pair(request, tmp_path_factory):
    """The JAX Runner and the port's for a dense-family variant, as
    `trained_pair` (numpy packers, no dropout, injected weights), each
    trained for 2 epochs."""
    variant = request.param
    config_json = json.dumps({**DENSE_RUNS[variant], **NO_DROPOUT,
                              "num_epochs": 2, "native_pack": False,
                              "random_seed": 3})
    train = synthetic_molecules(40, seed=11)
    valid = synthetic_molecules(12, seed=12)
    jax_runner = JaxRunner(variant, resolve_config(variant, config_json=
                                                   config_json),
                           train_data=train, valid_data=valid,
                           log_dir=str(tmp_path_factory.mktemp("jax_run")),
                           quiet=True, tensorboard=False)
    port_runner = Runner(variant, resolve_config(variant,
                                                 config_json=config_json),
                         train_data=train, valid_data=valid,
                         log_dir=str(tmp_path_factory.mktemp("port_run")),
                         quiet=True, device="cpu")
    port_runner.params.load_state_dict(
        _bridge(jax_runner.state["params"]), strict=True)
    jax_log = jax_runner.train()
    port_log = port_runner.train()
    return variant, jax_runner, jax_log, port_runner, port_log, train, valid


def test_dense_runner_matches_jax_runner_over_two_epochs(trained_dense_pair):
    variant, jax_runner, jax_log, port_runner, port_log, _, _ = \
        trained_dense_pair
    assert port_runner.adapter.drop_remainder is (variant == "dense")
    assert len(port_log) == len(jax_log) == 2
    assert port_runner.train_step_id == jax_runner.train_step_id > 4
    assert port_runner.valid_step_id == jax_runner.valid_step_id
    assert port_runner.prop_steps == jax_runner.prop_steps
    for got, want in zip(port_log, jax_log):
        for split in ("train_results", "valid_results"):
            for i in range(3):   # loss, MAE, error_ratio
                np.testing.assert_allclose(
                    np.asarray(got[split][i]), np.asarray(want[split][i]),
                    rtol=5e-4, err_msg=f"epoch {got['epoch']} {split} {i}")
    assert port_runner.last_edge_msg_per_sec > 0


def test_dense_checkpoints_restore_across_packages(trained_dense_pair,
                                                   tmp_path):
    """The final weights and Adam state of each Runner, saved by its own
    package, restore in the other's Runner."""
    from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
    variant, jax_runner, _, port_runner, _, train, valid = \
        trained_dense_pair
    port_path = str(tmp_path / "port.pickle")
    port_runner._save(port_path)
    jax_path = str(tmp_path / "jax.pickle")
    jax_save(jax_path, jax_runner.config, jax_runner.state,
             jax_runner.train_step_id, jax_runner.valid_step_id)
    restored = JaxRunner(variant, dict(port_runner.config), train_data=train,
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
    port = Runner(variant, dict(jax_runner.config), train_data=train,
                  valid_data=valid, log_dir=str(tmp_path / "port"),
                  quiet=True, device="cpu", restore=jax_path)
    assert port.optimizer.count == jax_runner.train_step_id == \
        int(jax_runner.state["opt_state"][1]["count"])
    want = _flat(jax_runner.state["opt_state"], "opt_state")
    for key, value in optimizer_entries(port.optimizer).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_dense_empty_epoch_raises_with_the_remainder_hint(tmp_path):
    config = resolve_config("dense", config_json=json.dumps(
        {**DENSE_RUNS["dense"], "batch_size": 64}))
    runner = Runner("dense", config, train_data=synthetic_molecules(20),
                    valid_data=synthetic_molecules(5, seed=1),
                    log_dir=str(tmp_path), quiet=True, device="cpu")
    with pytest.raises(RuntimeError, match="drop_remainder"):
        runner.run_epoch("epoch 1 (training)", runner.train_processed, True)


@pytest.mark.parametrize("variant", ["dense", "blocked"])
def test_cli_trains_the_dense_family_on_the_cpu(tmp_path, variant):
    config = json.dumps({**DENSE_RUNS[variant], "num_epochs": 2,
                         "drop_remainder": False})
    proc = subprocess.run(
        [sys.executable, "-m", "ggnn_tpu_torch.cli", variant,
         "--synthetic", "60", "--device", "cpu", "--quiet", "--config",
         config, "--log_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = os.listdir(tmp_path)
    for suffix in ("_log.json", "_params.json", "_model_best.pickle"):
        assert sum(n.endswith(suffix) for n in names) == 1, suffix
    best = [n for n in names if n.endswith("_model_best.pickle")][0]
    out = np.asarray(JaxPredictor.from_checkpoint(
        str(tmp_path / best), variant)(synthetic_molecules(5, seed=2)))
    assert out.shape == (1, 5) and np.isfinite(out).all()


@pytest.mark.parametrize("flag,item", [
    # Ported (ROADMAP A9): the example evaluation of an untrained model,
    # the targets then the predictions.
    pytest.param(["--evaluate"], "A9", id="flag0-A9"),
    # Ported (ROADMAP A10): without --restore it is a usage error.
    pytest.param(["--export-artifact", "x"], "requires --restore",
                 id="flag1-A10")])
def test_cli_unported_variants_exit_2(capsys, tmp_path, flag, item):
    """Every variant is ported, and so are the flags of ROADMAP A9 and
    A10, for the last variant ported as for the others: `--evaluate`
    prints predictions and exits 0, and a flag used without the flag it
    needs exits 2 naming it."""
    rc = cli.main(["async", *flag, "--synthetic", "20", "--device", "cpu",
                   "--log_dir", str(tmp_path), "--config",
                   json.dumps({"propagation_substeps": 40})])
    out, err = capsys.readouterr()
    if item == "A9":
        assert rc == 0, err
        # The 2 validation molecules' targets, then their predictions.
        assert len([line for line in out.splitlines()
                    if line.startswith("[[")]) == 3
    else:
        assert rc == 2
        assert item in err


@pytest.mark.parametrize("variant", ["gcn", "gcn_blocked"])
def test_cli_trains_the_gcn_variants_on_the_cpu(tmp_path, variant):
    config = json.dumps({"num_epochs": 1, "hidden_size": 16})
    proc = subprocess.run(
        [sys.executable, "-m", "ggnn_tpu_torch.cli", variant,
         "--synthetic", "40", "--device", "cpu", "--quiet", "--config",
         config, "--log_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = os.listdir(tmp_path)
    for suffix in ("_log.json", "_params.json", "_model_best.pickle"):
        assert sum(n.endswith(suffix) for n in names) == 1, suffix
    best = [n for n in names if n.endswith("_model_best.pickle")][0]
    out = np.asarray(JaxPredictor.from_checkpoint(
        str(tmp_path / best), variant)(synthetic_molecules(5, seed=2)))
    assert out.shape == (1, 5) and np.isfinite(out).all()
