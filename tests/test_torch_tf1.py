"""Reference TF1 pickles in the port (ggnn_tpu_torch/compat/tf1.py, the
TF1 branches of training/checkpoint.py and serving.py) against the JAX
package and the TF1 golden fixtures, on the CPU.

  * the converter: bit for bit against `ggnn_tpu.compat.tf1.
    params_from_tf1_weights`, both trees then loaded by
    `params_from_jax_weights`, for every model fixture;
  * serving: `Predictor.from_checkpoint` of each fixture written as a
    reference pickle, against the fixture's outputs at 2e-5 (the bound
    tests/test_tf1_golden.py pins), or, where a fixture holds no output
    (the GCN cases), its validation epoch's masked MAE at rtol 3e-5;
  * training: `Runner(restore=...)` of a TF1 pickle against the JAX
    Runner's restored parameters, exactly.
"""

import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from ggnn_tpu.compat import tf1 as jax_tf1
from ggnn_tpu.data.synthetic import \
    async_fixture_molecules as jax_async_fixture
from ggnn_tpu.data.synthetic import synthetic_molecules as jax_molecules
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch.compat import tf1
from ggnn_tpu_torch.data.synthetic import (async_fixture_molecules,
                                            synthetic_molecules)
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training import checkpoint
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner

torch.set_num_threads(1)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tf1")
# The model fixtures (the cudnn_gru_cell ones hold a lone cell).
CASES = sorted(os.path.basename(p)[:-4]
               for p in glob.glob(os.path.join(FIXTURE_DIR, "*.npz"))
               if not os.path.basename(p).startswith("cudnn_gru_cell"))
SERVED = [c for c in CASES if not c.startswith("async")]
TOL = dict(rtol=2e-5, atol=2e-5)


def _fixture(case):
    data = np.load(os.path.join(FIXTURE_DIR, f"{case}.npz"))
    meta = json.loads(str(data["meta"]))
    weights = {k[2:]: data[k] for k in data.files if k.startswith("w/")}
    return meta, weights, data


def _pickle(case, tmp_path):
    """The fixture's weights as a reference TF1 pickle
    (chem_tensorflow.py:309-323)."""
    meta, weights, data = _fixture(case)
    path = str(tmp_path / f"{case}.pickle")
    with open(path, "wb") as f:
        pickle.dump({"params": meta["config"], "weights": weights,
                     "train_step": 0, "valid_step": 0}, f)
    return path, meta, data


def _assert_same(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        torch.testing.assert_close(got[name], value, rtol=0, atol=0,
                                   msg=name)


@pytest.mark.parametrize("case", CASES)
def test_converter_matches_jax_bit_for_bit(case):
    meta, weights, _ = _fixture(case)
    variant = meta["variant"]
    config = jax_resolve_config(variant,
                                config_json=json.dumps(meta["config"]))
    port_config = resolve_config(variant,
                                 config_json=json.dumps(meta["config"]))
    t_dim = meta["num_edge_types"]
    slots = ["effective", "raw"] if variant == "async" else ["effective"]
    for slot in slots:
        t = t_dim + (slot == "raw")
        want = jax_tf1.params_from_tf1_weights(variant, weights, config, t,
                                               async_slots=slot)
        got = tf1.params_from_tf1_weights(variant, weights, port_config, t,
                                          async_slots=slot)
        _assert_same(
            checkpoint.params_from_jax_weights(
                checkpoint.weights_from_tree(got)),
            checkpoint.params_from_jax_weights(_flatten_named({"params": want})))


def test_async_slot_mappings():
    """The converter's two corpus conventions for the reference async
    model's per-type variables (`ggnn_tpu/compat/tf1.py:176-240`):
    'effective' puts typ{t+1} at slot t and zeros the top slot, 'raw'
    puts typ{t} at slot t."""
    h = 3
    rng = np.random.RandomState(0)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    weights = {f"graph_model/gnn_edge_weights_typ{t}": r(h, h)
               for t in range(4)}
    weights.update({
        "graph_model/prop_round0/gru_cell/gates/kernel": r(2 * h, 2 * h),
        "graph_model/prop_round0/gru_cell/gates/bias": r(2 * h),
        "graph_model/prop_round0/gru_cell/candidate/kernel": r(2 * h, h),
        "graph_model/prop_round0/gru_cell/candidate/bias": r(h),
    })
    cfg = {"hidden_size": h, "use_edge_bias": False,
           "graph_rnn_cell": "GRU"}
    eff = tf1.async_graph_params_from_tf1(weights, cfg, 4)["edge_weights"]
    for t in range(3):
        np.testing.assert_array_equal(
            eff[t], weights[f"graph_model/gnn_edge_weights_typ{t + 1}"])
    assert np.all(eff[3] == 0)
    raw = tf1.async_graph_params_from_tf1(weights, cfg, 5,
                                          slots="raw")["edge_weights"]
    for t in range(4):
        np.testing.assert_array_equal(
            raw[t], weights[f"graph_model/gnn_edge_weights_typ{t}"])
    assert np.all(raw[4] == 0)
    with pytest.raises(ValueError, match="slots"):
        tf1.async_graph_params_from_tf1(weights, cfg, 4, slots="bogus")
    del weights["graph_model/gnn_edge_weights_typ1"]
    with pytest.raises(KeyError, match="typ1"):
        tf1.async_graph_params_from_tf1(weights, cfg, 4)


def test_partial_head_is_refused():
    _, weights, _ = _fixture("sparse_default")
    del weights["out_layer_task0/regression/MLP_W_layer0:0"]
    with pytest.raises(KeyError, match="PARTIAL task0"):
        tf1.heads_from_tf1(weights, [0])


def _valid(meta):
    corpus = meta["corpus"]
    return synthetic_molecules(corpus["n_valid"], seed=corpus["seed"] + 1,
                               num_targets=corpus["num_targets"])


def _first_batch_graphs(predictor, valid):
    """The request indices of the graphs of the first validation batch
    (the dense family buckets the graphs)."""
    if predictor.variant not in ("dense", "blocked", "gcn_blocked"):
        return list(range(len(valid)))
    order, _ = predictor._dense_batches(valid, 5)
    return order[:int(predictor.config["batch_size"])]


@pytest.mark.parametrize("case", SERVED)
def test_predictor_serves_tf1_pickle(case, tmp_path):
    path, meta, data = _pickle(case, tmp_path)
    predictor = Predictor.from_checkpoint(path, meta["variant"],
                                          max_nodes=512, max_graphs=64,
                                          annotation_size=5, device="cpu")
    assert predictor.meta.num_edge_types == (
        1 if meta["variant"].startswith("gcn") else meta["num_edge_types"])
    valid = _valid(meta)
    out = predictor(valid)
    assert out.shape == (len(predictor.task_ids), len(valid))
    ref_out = np.asarray(data["output"], np.float32).reshape(-1)
    if ref_out.size:
        # The reference caches the last task's outputs of its first
        # validation batch.
        g = meta["batch_num_graphs"]
        graphs = _first_batch_graphs(predictor, valid)[:g]
        np.testing.assert_allclose(out[-1, graphs], ref_out[:g], **TOL)
    else:
        targets = np.asarray([[g["targets"][k][0] for g in valid]
                              for k in predictor.task_ids], np.float32)
        mae = np.abs(out - targets).mean(axis=1)
        np.testing.assert_allclose(mae, meta["valid_accuracies"],
                                   rtol=3e-5, atol=1e-6)


def test_async_pickle_serves_with_effective_routing(tmp_path):
    """A reference async pickle on a standard corpus: typ{t+1} at slot
    t, the top slot zero (the reference drops the max raw type's
    messages), finite answers (tests/test_serving.py:256-295)."""
    path, meta, _ = _pickle("async_bias_rnn", tmp_path)
    _, weights, _ = _fixture("async_bias_rnn")
    predictor = Predictor.from_checkpoint(path, "async", max_nodes=256,
                                          max_graphs=16, annotation_size=5,
                                          device="cpu")
    graph = predictor.params.graph
    t_ref = meta["num_edge_types"]
    assert len(graph.edge_weights) == t_ref
    for t in range(t_ref - 1):
        np.testing.assert_array_equal(
            graph.edge_weights[t].detach().numpy(),
            weights[f"graph_model/gnn_edge_weights_typ{t + 1}:0"])
        np.testing.assert_array_equal(
            graph.edge_biases[t].detach().numpy(),
            weights[f"graph_model/gnn_edge_biases_typ{t + 1}:0"])
    assert not graph.edge_weights[t_ref - 1].detach().any()
    assert not graph.edge_biases[t_ref - 1].detach().any()
    out = predictor(async_fixture_molecules(4, seed=3, num_targets=1))
    assert out.shape == (1, 4) and np.isfinite(out).all()


def test_restore_needs_variant_and_edge_types(tmp_path):
    path, meta, _ = _pickle("sparse_default", tmp_path)
    config = resolve_config("sparse", config_json=json.dumps(meta["config"]))
    predictor = Predictor.from_checkpoint(path, "sparse", max_nodes=64,
                                          max_graphs=8, annotation_size=5,
                                          device="cpu")
    with pytest.raises(ValueError, match="TF1 reference checkpoint"):
        checkpoint.restore_checkpoint(path, config, predictor.params,
                                      log=lambda *a: None)
    with pytest.raises(AssertionError, match="hidden_size"):
        checkpoint.restore_checkpoint(
            path, {**config, "hidden_size": 32}, predictor.params,
            log=lambda *a: None, variant="sparse", num_edge_types=4)


RUNNER_CASES = ["sparse_default", "sparse_multitask", "dense_default",
                "gcn_default", "async_default"]


def _runner_data(meta, jax_side):
    corpus = meta["corpus"]
    kw = dict(num_targets=corpus["num_targets"])
    if corpus.get("kind") == "async_fixture":
        make = jax_async_fixture if jax_side else async_fixture_molecules
    else:
        make = jax_molecules if jax_side else synthetic_molecules
    return (make(corpus["n_train"], seed=corpus["seed"], **kw),
            make(corpus["n_valid"], seed=corpus["seed"] + 1, **kw))


@pytest.mark.parametrize("case", RUNNER_CASES)
def test_runner_restores_tf1_pickle_as_jax(case, tmp_path, capsys):
    """`Runner(restore=<TF1 pickle>)` of the port holds exactly the
    parameters the JAX Runner restores (a new task's head, as in
    sparse_multitask with a third task, keeps its fresh weights in
    both); it logs the import and trains on."""
    path, meta, _ = _pickle(case, tmp_path)
    variant = meta["variant"]
    overrides = dict(meta["config"])
    if case == "sparse_multitask":
        overrides["task_ids"] = [0, 1]
    text = json.dumps(overrides)
    jax_train, jax_valid = _runner_data(meta, True)
    jax_runner = JaxRunner(variant, jax_resolve_config(variant,
                                                       config_json=text),
                           log_dir=str(tmp_path / "jax"), restore=path,
                           train_data=jax_train, valid_data=jax_valid,
                           quiet=True, tensorboard=False)
    train, valid = _runner_data(meta, False)
    capsys.readouterr()
    runner = Runner(variant, resolve_config(variant, config_json=text),
                    log_dir=str(tmp_path / "port"), restore=path,
                    train_data=train, valid_data=valid, quiet=True,
                    device="cpu")
    assert "Imported TF1 reference checkpoint" in capsys.readouterr().out
    assert runner.optimizer.count == 0
    _assert_same({k: v.detach() for k, v in
                  runner.params.named_parameters()},
                 checkpoint.params_from_jax_weights(
                     _flatten_named({"params": jax_runner.state["params"]})))
    if case == "sparse_default":
        runner.train()
        assert os.path.exists(runner.best_model_file)


def test_geometry_from_tf1_names():
    """`_infer_geometry` reads T from the reference's variable names: the
    layered models' first layer [T*H, H], the dense model's Variable."""
    from ggnn_tpu_torch.serving import _infer_geometry

    for case, variant in (("sparse_default", "sparse"), ("rgcn", "rgcn"),
                          ("dense_default", "dense")):
        meta, weights, _ = _fixture(case)
        config = resolve_config(variant,
                                config_json=json.dumps(meta["config"]))
        assert _infer_geometry({"weights": weights}, variant, config) == (
            meta["num_edge_types"], 16)
