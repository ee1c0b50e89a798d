"""Replayed mesh steps (ROADMAP A21): a mesh Runner's train and
validation steps and its `predict` go through its graph caches, one
graph set a rank, on 2 gloo ranks on the CPU (`RankPool`, workers running
tests/torch_mesh_replay_ranks.py). Each capture there is a fake graph
(tests/torch_fake_card.py): a replay runs the step eagerly on a copy of
the rank's rows whose counts are None, into the same output buffers.
CUDA graphs over nccl are held to eager twins on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 21,
tools/torch_mesh_nccl.py).

Tolerances, each with its reason:
  * replayed against eager: exact (the same operations on the same
    inputs; the graph count enters the step as a device leaf of the
    same value);
  * an edge-mesh `predict` against the JAX mesh Runner's from the same
    checkpoint: 2e-5 (f32 sums in another order through 3 propagation
    steps, tests/test_torch_parallel.py's forward bound).
"""

import json
import os

import jax
import numpy as np
import pytest

from ggnn_tpu.parallel import make_mesh as jax_make_mesh
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.parallel.launch import RankPool
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import mesh_eager_reason

import torch_mesh_replay_ranks as ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
SPARSE = {"hidden_size": 8, "layer_timesteps": [2, 1],
          "residual_connections": {"1": [0]}, "batch_size": 150,
          "native_pack": False, "random_seed": 3, "num_epochs": 2}
# (variant, config overrides, n_data, n_edge): every kind `mesh_kind`
# gives, under each boundary exchange. The sparse cases keep their
# dropout (edge weights kept at 0.8): each rank's generator is
# registered with its graphs.
CASES = {
    "sparse 2x1": ("sparse", {}, 2, 1),
    "sparse 1x2 alltoall": ("sparse", {"boundary_exchange": "alltoall"},
                            1, 2),
    "sparse 1x2 ragged": ("sparse", {"boundary_exchange": "ragged"}, 1, 2),
    "sparse 1x2 shift": ("sparse", {"boundary_exchange": "shift",
                                    "use_propagation_attention": True},
                         1, 2),
    "sparse_tp 1x2": ("sparse", {"edge_parallelism": "type_tp"}, 1, 2),
    "gcn 1x2": ("gcn", {"num_timesteps": 2}, 1, 2),
    "dense 2x1": ("dense", {"num_timesteps": 2, "batch_size": 8,
                            "dense_bucket_sizes": [32]}, 2, 1),
}
@pytest.fixture(scope="module")
def pools():
    """The module's 2 ranks, spawned at first use and again after a
    rank's failure stopped them."""
    kept = []

    def get() -> RankPool:
        if not kept or not kept[0].alive:
            kept[:] = [RankPool(2, "gloo", python_path=[TESTS],
                                timeout=300)]
        return kept[0]

    yield get
    if kept:
        kept[0].close()


@pytest.fixture
def pool(pools):
    return pools()


def _config(variant, over):
    base = {k: v for k, v in SPARSE.items()
            if variant == "sparse" or k not in ("layer_timesteps",
                                                "residual_connections")}
    return resolve_config(variant, config_json=json.dumps({**base, **over}))


def _corpus():
    return synthetic_molecules(40, seed=0), synthetic_molecules(12, seed=1)


@pytest.mark.parametrize("label", sorted(CASES))
def test_replayed_mesh_epochs_equal_eager_epochs(pool, tmp_path, label):
    """2 epochs of `train()` whose steps replay equal 2 whose steps run
    eagerly: every step's loss and MAE and every parameter after each
    epoch, bit for bit. Every rank holds the same keys: one train and one
    validation key for each shape of a step's stack, the same after
    epoch 2 as after epoch 1."""
    variant, over, n_data, n_edge = CASES[label]
    config = _config(variant, over)
    results = pool.run(ranks.replayed_and_eager, variant, config,
                       *_corpus(), n_data, n_edge, str(tmp_path))
    for rank, out in enumerate(results):
        got, want = out["replayed"], out["eager"]
        assert got["step_mode"] == {"mode": "replayed", "reason": None}
        assert want["graph_counts"] == {"train": 0, "validation": 0,
                                        "predict": 0}
        assert out["eager_captured"] == 0
        for split in ("train", "validation"):
            assert len(got["steps"][split]) == len(want["steps"][split]) > 1
            for (loss, accs), (loss_e, accs_e) in zip(
                    got["steps"][split], want["steps"][split]):
                assert loss == loss_e, (label, rank, split)
                np.testing.assert_array_equal(accs, accs_e)
        assert len(got["weights"]) == 2
        for epoch, (w, w_e) in enumerate(zip(got["weights"],
                                             want["weights"])):
            for name in w_e:
                np.testing.assert_array_equal(
                    w[name], w_e[name], err_msg=f"{label} rank {rank} "
                    f"epoch {epoch + 1} {name}")
        train_keys, valid_keys = got["keys"][0]
        assert got["keys"][1] == got["keys"][0]
        assert train_keys == got["stack_keys"]["train"]
        assert valid_keys == got["stack_keys"]["validation"]
        assert got["graph_counts"] == {"train": len(train_keys),
                                       "validation": len(valid_keys),
                                       "predict": 0}
        assert out["captured"] == results[0]["captured"]
    # Both ranks hold the same keys and the same whole weights.
    assert results[0]["replayed"]["keys"] == results[1]["replayed"]["keys"]
    for name, w in results[0]["replayed"]["weights"][-1].items():
        np.testing.assert_array_equal(
            w, results[1]["replayed"]["weights"][-1][name])


def test_a_capacity_regrow_adds_one_key_on_every_rank(pool, tmp_path):
    """Lanes planned for the epoch's first batch regrow mid-epoch on both
    ranks at once: each training step's stack adds a train key exactly
    when it regrew the capacities (or is the first), the same on every
    rank."""
    config = _config("sparse", {**NO_DROPOUT, "num_epochs": 1,
                                "layer_timesteps": [1],
                                "residual_connections": {}})
    results = pool.run(ranks.regrown, config, *_corpus(), 1, 2,
                       str(tmp_path))
    assert results[0] == results[1]
    steps = results[0]["steps"]
    assert not steps[0][0] and any(regrew for regrew, _ in steps[1:])
    after = [keys for _, keys in steps[1:]] + [results[0]["keys_after"]]
    for i, ((regrew, before), keys) in enumerate(zip(steps, after)):
        assert keys - before == (1 if regrew or i == 0 else 0), steps


def test_ragged_and_gloo_on_a_card_run_eagerly(pool, tmp_path):
    """The eager rule: gloo on a card, and only it, runs its mesh steps
    eagerly, and says why; the ragged exchange replays on nccl cards
    (its split sizes stay on the card); a ragged (and an "auto") mesh
    Runner of gloo CPU ranks goes through its graph caches, its reason
    None, and trains."""
    assert "gloo" in mesh_eager_reason("gloo", "cuda")
    for backend, device in (("nccl", "cuda"), ("gloo", "cpu"),
                            (None, "cuda"), (None, "cpu")):
        assert mesh_eager_reason(backend, device) is None
    for over in ({"boundary_exchange": "ragged"},
                 {"boundary_exchange": "auto"}):
        config = _config("sparse", {**over, "num_epochs": 1})
        results = pool.run(ranks.eager_by_rule, "sparse", config,
                           *_corpus(), 1, 2, str(tmp_path))
        for out in results:
            assert out["step_mode"] == {"mode": "replayed", "reason": None}
            assert out["exchange"] == "ragged"
            assert out["graph_counts"]["train"] >= 1
            assert out["graph_counts"]["validation"] >= 1
            assert out["captured"] >= 2 and np.isfinite(out["loss"])


@pytest.mark.parametrize("label", ["sparse 2x1", "sparse 1x2 shift",
                                   "gcn 1x2"])
def test_mesh_steps_read_no_host_scalar(pool, tmp_path, label):
    """A replayed mesh train and validation step reads nothing of a
    tensor's value on the host (`aten._local_scalar_dense` refused) nor a
    batch's host count (None in a captured step)."""
    variant, over, n_data, n_edge = CASES[label]
    config = _config(variant, {**over, "num_epochs": 1})
    results = pool.run(ranks.no_host_read, variant, config, *_corpus(),
                       n_data, n_edge, str(tmp_path))
    for out in results:
        assert out["step_mode"]["mode"] == "replayed"
        assert out["steps"] > 2 and np.isfinite(out["loss"])


def test_edge_mesh_predict_keeps_one_copy_and_matches_jax(pool, tmp_path):
    """A type-TP (1, 2) Runner's `predict` builds its collective-free copy
    once: after a training epoch the same copy, refreshed, answers, and
    matches the JAX mesh Runner's `predict` restored from that epoch's
    checkpoint at 2e-5."""
    config = _config("sparse", {**NO_DROPOUT, "num_epochs": 1,
                                "edge_parallelism": "type_tp",
                                "use_propagation_attention": True})
    train, valid = _corpus()
    mesh = jax_make_mesh(1, 2)
    start_runner = JaxRunner("sparse", dict(config), train_data=train,
                             valid_data=valid,
                             log_dir=str(tmp_path / "jax"), quiet=True,
                             tensorboard=False, mesh=mesh)
    start = str(tmp_path / "start.pickle")
    jax_save(start, dict(config), jax.device_get(start_runner.state), 0, 0)
    mols = synthetic_molecules(6, seed=2)
    results = pool.run(ranks.predicted_twice, "sparse", config, train,
                       valid, 1, 2, str(tmp_path / "port"), mols, start)
    first = results[0]
    assert first["same_copy"] and not first["copy_is_runner"]
    assert first["predict_graphs"] >= 1
    before = np.concatenate(first["before"], axis=1)
    got = np.concatenate(first["after"], axis=1)
    assert got.shape == (1, 6) and not np.array_equal(got, before)
    trained = JaxRunner("sparse", dict(config), train_data=train,
                        valid_data=valid, log_dir=str(tmp_path / "jax2"),
                        quiet=True, tensorboard=False, mesh=mesh,
                        restore=first["best"])
    want = np.concatenate([np.asarray(o) for o in trained.predict(mols)],
                          axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for out in results[1:]:
        np.testing.assert_array_equal(np.concatenate(out["after"], 1), got)
