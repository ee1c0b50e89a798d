"""The plain reference against the port, at a CPU test's size: every
cell's run, the window included, must come out correct, with its numbers
at rounding's size; the reference's own packing must give the port's
batches; each option the reference implements must match the port's;
and a configuration the reference does not implement is refused."""

import copy

import numpy as np
import pytest
import torch

from portbench import reference, run, windows
from portbench.reference import data as ref_data

CELLS = ["dense_qm9.train_resident", "sparse_qm9.train_resident",
         "sparse_qm9.train_stream", "sparse_qm9.score_batch"]


def _matches(cell, seed=2**31 + 17):
    result = run.run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                          started=0.0)
    assert result["correct"], result["checks"]
    for c in result["checks"].values():
        assert c["value"] < 1e-5
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(tiny_cell, name):
    _matches(tiny_cell(name))


@pytest.mark.parametrize("options", [
    {"graph_rnn_cell": "RNN", "graph_rnn_activation": "ReLU",
     "residual_connections": {}, "layer_timesteps": [1, 1, 1]},
    {"use_edge_bias": True},
    {"use_edge_msg_avg_aggregation": False},
], ids=["rnn_relu", "edge_bias", "sum_aggregation"])
def test_reference_options_match_the_port(tiny_cell, options):
    cell = tiny_cell("sparse_qm9.train_resident")
    cell.config["model"].update(options)
    _matches(cell, 2**31 + 41)


@pytest.mark.parametrize("name", ["dense_qm9.train_resident",
                                  "sparse_qm9.train_resident"])
def test_reference_packs_the_ports_epoch(tiny_cell, name):
    cell = tiny_cell(name)
    run_ = windows.Run(cell.config, cell.traffic, 99, torch.device("cpu"),
                       windows.log_dir())
    driver = run.driver_class(cell)(run_)
    ported = [(int(b.num_graphs), int(b.node_features.shape[1])
               if b.node_features.dim() == 3 else None)
              for g in driver.groups for b in g]
    mine = [(len(ids), v) for ids, v in run_.reference.epoch(
        driver.train.num_atoms, cell.config["model"], run_.random_seed)]
    assert ported == mine
    assert sum(n for n, _ in mine) <= driver.train.num_graphs


def test_greedy_pack_keeps_under_the_budget():
    atoms = np.array([5, 5, 5, 4, 9])
    batches = ref_data.pack_greedy(atoms, np.arange(5), 11)
    # 5 + 5 = 10 < 11, + 5 = 15 no; 5 + 4 = 9, + 9 no; 9.
    assert [b.tolist() for b in batches] == [[0, 1], [2, 3], [4]]


def _sparse_config():
    return copy.deepcopy(run.Cell("sparse_qm9.train_resident").config)


@pytest.mark.parametrize("change", [
    ("model", "use_propagation_attention", True),
    ("model", "graph_rnn_cell", "CudnnCompatibleGRUCell"),
    ("model", "graph_state_dropout_keep_prob", 0.9),
    ("model", "a_key_the_reference_does_not_know", 1),
    ("model", "use_edge_bias", None),
    ("top", "tf32", True),
    ("top", "precision", "bfloat16"),
    ("top", "reference", "no_such_model"),
], ids=["attention", "cudnn_gru", "state_dropout", "unknown_key",
        "missing_key", "tf32", "bfloat16", "no_model"])
def test_reference_refuses_what_it_does_not_implement(change):
    where, key, value = change
    config = _sparse_config()
    target = config["model"] if where == "model" else config
    if value is None:
        del target[key]
    else:
        target[key] = value
    with pytest.raises((ValueError, ModuleNotFoundError)):
        reference.model_for(config)


def test_reference_implements_each_configuration():
    for name in ("dense_qm9.train_resident", "sparse_qm9.train_resident"):
        config = run.Cell(name).config
        assert reference.model_for(config).NAME == config["reference"]
