"""The port's mesh training (ggnn_tpu_torch.parallel, ROADMAP A11) in
ranks of a `torch.distributed` gloo group on the CPU, against the JAX
package's mesh steps on the 8 virtual CPU devices of tests/conftest.py
and against the port's own single-device global-batch oracle.

The ranks (`RankPool`, workers running tests/torch_mesh_ranks.py) are
spawned once for all cases of a world size. Every case starts from the
same weights (the JAX model's, bridged by name) and the same batches
(each package's packer, bit-equal), every keep probability 1.0.

Tolerances, as tests/test_parallel.py holds the JAX mesh to its
oracle: the loss and MAE at rtol 1e-5 (f32 sums in another order), every
gradient leaf at rtol 2e-4 / atol 1e-6; the 2-epoch Runner against the
JAX mesh Runner at rtol 5e-4 (tests/test_torch_training.py's bound for
two epochs of f32 training); across ranks, bit-equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.data.loader import infer_metadata as jax_infer_metadata
from ggnn_tpu.models.base import init_output_heads as jax_heads
from ggnn_tpu.parallel import make_mesh as jax_make_mesh
from ggnn_tpu.parallel import make_parallel_steps as jax_parallel_steps
from ggnn_tpu.parallel import node_shard as jax_node_shard
from ggnn_tpu.parallel import stacking as jax_stacking
from ggnn_tpu.parallel.mesh import EDGE_AXIS
from ggnn_tpu.parallel.tp import is_tp_sharded_path as jax_is_tp_sharded
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.optimizer import make_optimizer
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu.training.variants import make_adapter as jax_make_adapter
from ggnn_tpu_torch.data.loader import infer_metadata
from ggnn_tpu_torch.data.synthetic import (synthetic_giant_graph,
                                           synthetic_molecules)
from ggnn_tpu_torch.parallel import node_shard
from ggnn_tpu_torch.parallel.launch import RankError, RankPool
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.variants import make_adapter

import torch_mesh_ranks as ranks

TESTS = os.path.dirname(os.path.abspath(__file__))
NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
SMALL = {"hidden_size": 8, "layer_timesteps": [2, 1],
         "residual_connections": {"1": [0]}, "native_pack": False}
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)


class _Pools:
    """A RankPool for each world size the module's cases use, each spawned
    at its first use (and again after a rank's failure stopped it)."""

    def __init__(self):
        self.pools = {}

    def get(self, world: int) -> RankPool:
        pool = self.pools.get(world)
        if pool is None or not pool.alive:
            pool = self.pools[world] = RankPool(
                world, "gloo", python_path=[TESTS], timeout=300)
        return pool

    def close(self):
        for pool in self.pools.values():
            pool.close()


@pytest.fixture(scope="module")
def pools():
    p = _Pools()
    yield p
    p.close()


# ------------------------------------------------------------ the cases

def _config(variant, over):
    return resolve_config(variant, config_json=json.dumps(
        {**SMALL, **NO_DROPOUT, **over}))


def _setup(variant, over, n_mols=48, seed=3):
    """(config, port meta, port batches, JAX batches, JAX adapter) of
    `n_mols` synthetic molecules, packed by each package in eval mode."""
    config = _config(variant, over)
    data = synthetic_molecules(n_mols, seed=seed)
    meta = infer_metadata([data], config["tie_fwd_bkwd"])
    adapter = make_adapter(variant, config, meta)
    processed = adapter.preprocess(data, False)
    adapter.plan(processed)
    jmeta = jax_infer_metadata([data], config["tie_fwd_bkwd"])
    jadapter = jax_make_adapter(variant, dict(config), jmeta)
    jprocessed = jadapter.preprocess(data, False)
    jadapter.plan(jprocessed)
    return (config, meta, list(adapter.batches(processed, False)),
            list(jadapter.batches(jprocessed, False)), jadapter)


def _jax_params(jadapter, config, edge_axis=None):
    model = (jadapter.build_model(edge_axis=edge_axis) if edge_axis
             else jadapter.build_model())
    key = jax.random.PRNGKey(7)
    return model, {"graph": model.init_params(key),
                   "heads": jax_heads(key, config["hidden_size"],
                                      config["task_ids"])}


def _port_names(tree, prefix="params"):
    """{port parameter name: array} of a JAX tree under `prefix`."""
    flat = _flatten_named({prefix: tree})
    if prefix != "params":
        flat = {k.replace(f"['{prefix}']", "['params']", 1): v
                for k, v in flat.items()}
    return {n: t.numpy() for n, t in params_from_jax_weights(flat).items()}


def _jax_stack(kind, jbatches, n_data, n_edge, exchange, combined):
    if kind in ("sparse", "gcn") and n_edge > 1:
        # XLA:CPU has no ragged all-to-all: JAX validates the ragged
        # layout through its emulation, which the port's "ragged" shares.
        jex = "ragged_emulated" if exchange == "ragged" else exchange
        if kind == "gcn":
            caps = jax_node_shard.plan_gcn_shard_caps(jbatches, n_edge)
            return jax_node_shard.gcn_shard_and_stack(jbatches, caps,
                                                      n_data, jex)
        caps = jax_node_shard.plan_node_shard_caps(jbatches, n_edge)
        return jax_node_shard.shard_and_stack(jbatches, caps, n_data, jex)
    if kind == "dense":
        return jax_stacking.stack_dense_batches(jbatches, n_data)
    if kind == "data_only":
        return jax_stacking.stack_any_batches(
            jbatches, n_data, jax_stacking.empty_masked_batch_like)
    return jax_stacking.stack_batches(jbatches, n_data,
                                      keep_combined=combined)


def _jax_step(variant, config, jadapter, jbatches, n_data, n_edge, kind,
              exchange, combined):
    """JAX's make_parallel_steps at the same mesh shape: (eval metrics,
    train metrics with the synchronised gradients by port name), and
    the starting weights by port name."""
    edge = EDGE_AXIS if n_edge > 1 and kind != "dense" else None
    model, params = _jax_params(jadapter, config, edge)
    tp_kwargs = ({"tp_axis": EDGE_AXIS, "tp_is_sharded": jax_is_tp_sharded}
                 if kind == "sparse_tp" else {})
    opt = make_optimizer(config["learning_rate"],
                         config["clamp_gradient_norm"], **tp_kwargs)
    state = {"params": params, "opt_state": opt.init(params)}
    train, evaluate = jax_parallel_steps(
        model, opt, config, config["task_ids"],
        jax_make_mesh(n_data, n_edge), return_grads=True, batch_kind=kind,
        batch_template=jbatches[0], state_template=state,
        combined_lanes=combined)
    stack = _jax_stack(kind, jbatches, n_data, n_edge, exchange, combined)
    weights = _port_names(params)
    _, emetrics = evaluate(state, stack, None)
    _, tmetrics = train(state, stack, jax.random.PRNGKey(0))
    grads = _port_names(tmetrics["grads"])
    return ({k: np.asarray(emetrics[k]) for k in ("loss", "accuracies")},
            float(tmetrics["loss"]), grads, weights)


def _check_step(pools, variant, over, n_data, n_edge, kind,
                exchange="alltoall", combined=False, n_batches=None,
                n_mols=48, data=None):
    config, meta, batches, jbatches, jadapter = (
        data if data is not None else _setup(variant, over, n_mols))
    if n_batches is not None:
        batches, jbatches = batches[:n_batches], jbatches[:n_batches]
    j_eval, j_train_loss, j_grads, weights = _jax_step(
        variant, config, jadapter, jbatches, n_data, n_edge, kind,
        exchange, combined)
    o_loss, o_acc, o_grads = ranks.oracle(variant, config, meta, weights,
                                          batches)
    np.testing.assert_allclose(float(j_eval["loss"]), o_loss, **LOSS_TOL)
    case = ranks.StepCase(variant, config, meta, weights, batches, n_data,
                          n_edge, kind, exchange, combined)
    results = pools.get(n_data * n_edge).run(ranks.step_case, case)
    for rank, out in enumerate(results):
        for metrics in (out["eval"], out["train"]):
            np.testing.assert_allclose(float(metrics["loss"]), o_loss,
                                       **LOSS_TOL)
            np.testing.assert_allclose(float(metrics["loss"]),
                                       float(j_eval["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(out["eval"]["accuracies"], o_acc,
                                   **LOSS_TOL)
        np.testing.assert_allclose(out["eval"]["accuracies"],
                                   j_eval["accuracies"], **LOSS_TOL)
        assert int(out["eval"]["num_graphs"]) == sum(
            int(b.num_graphs) for b in batches)
        assert set(out["grads"]) == set(o_grads) == set(j_grads)
        for name, got in out["grads"].items():
            want, jwant = o_grads[name], j_grads[name]
            if out["types"] is not None and ranks.is_tp_sharded_path(name):
                lo, hi = out["types"]
                want, jwant = want[lo:hi], jwant[lo:hi]
            msg = f"rank {rank} {name}"
            np.testing.assert_allclose(got, want, err_msg=msg, **GRAD_TOL)
            np.testing.assert_allclose(got, jwant, err_msg=msg, **GRAD_TOL)
    for out in results[1:]:
        for name in out["grads"]:
            if out["types"] is None:
                np.testing.assert_array_equal(out["grads"][name],
                                              results[0]["grads"][name])
    return results


ATTENTION = {"batch_size": 160, "use_propagation_attention": True,
             "use_edge_bias": True}


@pytest.mark.parametrize("n_data,n_edge,exchange", [
    (2, 1, None), (1, 2, "alltoall"), (2, 2, "shift"), (1, 4, "ragged"),
    (2, 2, "ragged_emulated"), (1, 4, "alltoall")])
def test_sparse_steps_match_jax_and_oracle(pools, n_data, n_edge,
                                           exchange):
    """The sparse GGNN with attention and edge biases: data parallelism
    on the combined lane, and node shards under each exchange."""
    _check_step(pools, "sparse", ATTENTION, n_data, n_edge, "sparse",
                exchange or "alltoall", combined=n_edge == 1)


@pytest.mark.parametrize("n_data,n_edge", [(1, 2), (2, 2)])
def test_type_tp_steps_match_jax_and_oracle(pools, n_data, n_edge):
    """Type-TP: this rank's types' weights and lanes, the softmax over the
    edge axis and the global-norm clip of the sharded leaves."""
    _check_step(pools, "sparse", ATTENTION, n_data, n_edge, "sparse_tp")


@pytest.mark.parametrize("n_data,n_edge,exchange", [
    (1, 2, "alltoall"), (2, 2, "ragged"), (1, 4, "shift")])
def test_gcn_node_sharded_steps_match_jax_and_oracle(pools, n_data, n_edge,
                                                     exchange):
    _check_step(pools, "gcn", {"batch_size": 160}, n_data, n_edge, "gcn",
                exchange)


@pytest.mark.parametrize("variant,over,kind", [
    ("gcn", {"batch_size": 160}, "data_only"),
    ("dense", {"batch_size": 8, "dense_bucket_sizes": [32],
               "drop_remainder": False}, "dense"),
    ("blocked", {"batch_size": 8, "dense_bucket_sizes": [32]}, "dense"),
    ("gcn_blocked", {"batch_size": 8, "dense_bucket_sizes": [32]}, "dense"),
    ("async", {"num_nodes": 160, "propagation_substeps": 40}, "data_only")])
def test_data_parallel_variants_match_jax_and_oracle(pools, variant, over,
                                                     kind):
    """Every other variant, data-parallel at (2, 1); five batches, so the
    stack ends with a filler."""
    _check_step(pools, variant, over, 2, 1, kind, n_batches=5)


def test_empty_batch_is_a_noop(pools):
    """Three batches over two data ranks: the stack's filler adds no
    loss, no count and no gradient."""
    results = _check_step(pools, "sparse", {"batch_size": 160}, 2, 1,
                          "sparse", n_batches=3)
    assert len(results) == 2


def test_use_graph_false_on_mesh(pools):
    """The use_graph=False ablation on node shards: the readout over
    zeroed states, its partial pools still summed over the edge axis."""
    _check_step(pools, "sparse", {"batch_size": 160, "use_graph": False},
                1, 2, "sparse")


def test_node_sharded_giant_graph_parity(pools):
    """One large connected graph split over 4 shards (heavily used
    boundary lanes), under the ragged exchange."""
    over = {"batch_size": 420, "use_propagation_attention": True,
            "use_edge_bias": True}
    config = _config("sparse", over)
    data = synthetic_giant_graph(400, seed=5)
    meta = infer_metadata([data], config["tie_fwd_bkwd"])
    adapter = make_adapter("sparse", config, meta)
    processed = adapter.preprocess(data, False)
    adapter.plan(processed)
    jadapter = jax_make_adapter("sparse", dict(config), jax_infer_metadata(
        [data], config["tie_fwd_bkwd"]))
    jprocessed = jadapter.preprocess(data, False)
    jadapter.plan(jprocessed)
    batches = list(adapter.batches(processed, False))
    assert len(batches) == 1
    caps = node_shard.plan_node_shard_caps(batches, 4)
    stack = node_shard.shard_batch(batches[0], caps, "ragged")
    assert float(np.asarray(stack.bnd_mask).sum()) > 100
    _check_step(pools, "sparse", over, 1, 4, "sparse", "ragged",
                data=(config, meta, batches,
                      list(jadapter.batches(jprocessed, False)), jadapter))


# --------------------------------------------------------------- Runner

RUNNER = {"num_epochs": 2, "hidden_size": 16, "batch_size": 120,
          "layer_timesteps": [2, 1], "residual_connections": {"1": [0]},
          "use_propagation_attention": True, "use_edge_bias": True,
          "native_pack": False, "random_seed": 3}


@pytest.mark.parametrize("n_data,n_edge,over", [
    (2, 2, {}),
    (2, 2, {"edge_parallelism": "type_tp"}),
    (1, 2, {"boundary_exchange": "shift"})])
def test_mesh_runner_matches_jax_mesh_runner(pools, tmp_path, n_data,
                                             n_edge, over):
    """Two epochs through `Runner(mesh=)` against the JAX mesh Runner from
    the same weights (a JAX checkpoint both restore): every epoch's
    losses and MAE, the weights bit-equal across ranks, and predictions
    from the collective-free copy equal to a single-device Runner's."""
    from ggnn_tpu_torch.training.runner import Runner
    config = resolve_config("sparse", config_json=json.dumps(
        {**RUNNER, **NO_DROPOUT, **over}))
    train = synthetic_molecules(60, seed=0)
    valid = synthetic_molecules(16, seed=1)
    jax_runner = JaxRunner("sparse", dict(config), train_data=train,
                           valid_data=valid, log_dir=str(tmp_path / "jax"),
                           quiet=True, tensorboard=False,
                           mesh=jax_make_mesh(n_data, n_edge))
    start = str(tmp_path / "start.pickle")
    jax_save(start, dict(config), jax.device_get(jax_runner.state), 0, 0)
    jax_runner = JaxRunner("sparse", dict(config), train_data=train,
                           valid_data=valid, log_dir=str(tmp_path / "jax"),
                           quiet=True, tensorboard=False,
                           mesh=jax_make_mesh(n_data, n_edge), restore=start)
    jax_log = jax_runner.train()
    mols = synthetic_molecules(5, seed=2)
    results = pools.get(n_data * n_edge).run(
        ranks.mesh_runner, "sparse", config, train, valid, n_data, n_edge,
        str(tmp_path / "port"), predict=mols, restore=start)
    first = results[0]
    assert first["kind"] == ("sparse_tp" if over.get("edge_parallelism")
                             else "sparse")
    assert first["train_step_id"] == jax_runner.train_step_id
    for got, want in zip(first["log"], jax_log):
        for split in ("train_results", "valid_results"):
            for i in range(3):
                np.testing.assert_allclose(
                    np.asarray(got[split][i]), np.asarray(want[split][i]),
                    rtol=5e-4, err_msg=f"epoch {got['epoch']} {split} {i}")
    for out in results[1:]:
        for name, w in out["weights"].items():
            np.testing.assert_array_equal(w, first["weights"][name])
        for a, b in zip(out["log"], first["log"]):
            assert a["train_results"][:3] == b["train_results"][:3]
    # Only rank 0 writes: one log, one parameters file, a best checkpoint.
    written = sorted(os.listdir(tmp_path / "port"))
    assert [n for n in written if n.endswith("_log.json")] == [
        os.path.basename(first["best"]).replace("_model_best.pickle",
                                                "_log.json")]
    assert len([n for n in written if n.endswith("_model_best.pickle")]) \
        == 1
    single = Runner("sparse", dict(config), train_data=train[:8],
                    valid_data=valid[:4], log_dir=str(tmp_path / "one"),
                    quiet=True, tensorboard=False, device="cpu")
    single.params.load_state_dict(
        {n: torch.from_numpy(w) for n, w in first["weights"].items()})
    got = np.concatenate(first["predict"], axis=1)
    want = np.concatenate(single.predict(mols), axis=1)
    assert got.shape == (1, 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for out in results[1:]:
        np.testing.assert_array_equal(np.concatenate(out["predict"], 1),
                                      got)


def test_gcn_runner_trains_node_sharded(pools, tmp_path):
    """The GCN node-sharded Runner (plan, stack, shift exchange) at
    (2, 2): two epochs, finite, the ranks agree."""
    config = resolve_config("gcn", config_json=json.dumps(
        {"num_epochs": 2, "hidden_size": 16, "batch_size": 120,
         "boundary_exchange": "shift", "native_pack": False}))
    results = pools.get(4).run(
        ranks.mesh_runner, "gcn", config, synthetic_molecules(64, seed=0),
        synthetic_molecules(16, seed=1), 2, 2, str(tmp_path))
    assert results[0]["kind"] == "gcn" and results[0]["caps"] is not None
    log = results[0]["log"]
    assert len(log) == 2 and np.isfinite(log[-1]["train_results"][0])
    for out in results[1:]:
        for name, w in out["weights"].items():
            np.testing.assert_array_equal(w, results[0]["weights"][name])


def test_node_shard_overflow_regrows_caps_mid_epoch(pools, tmp_path):
    config = resolve_config("sparse", config_json=json.dumps(
        {"num_epochs": 1, "hidden_size": 8, "batch_size": 120,
         "layer_timesteps": [1], "residual_connections": {},
         **NO_DROPOUT}))
    results = pools.get(2).run(
        ranks.regrow_case, config, synthetic_molecules(48, seed=0),
        synthetic_molecules(12, seed=1), 1, 2, str(tmp_path))
    for sabotaged, grown, loss in results:
        assert grown > sabotaged and np.isfinite(loss)
    assert results[0] == results[1]


def test_boundary_exchange_auto_resolves_and_trains(pools, tmp_path):
    """"auto" on gloo ranks on the CPU resolves to the ragged exchange
    (gloo's all-to-all takes per-pair splits there) and trains."""
    config = resolve_config("sparse", config_json=json.dumps(
        {"num_epochs": 1, "hidden_size": 16, "batch_size": 150,
         "boundary_exchange": "auto", "native_pack": False}))
    results = pools.get(4).run(
        ranks.mesh_runner, "sparse", config, synthetic_molecules(48, seed=0),
        synthetic_molecules(12, seed=1), 2, 2, str(tmp_path))
    assert {out["exchange"] for out in results} == {"ragged"}
    assert np.isfinite(results[0]["log"][0]["train_results"][0])


def test_mesh_runner_refuses_what_jax_refuses(pools, tmp_path):
    """A dense-family edge axis, a mid-epoch iterator state and
    `train_on_device` raise on a mesh, as in the JAX package."""
    pool = pools.get(2)
    train, valid = synthetic_molecules(40, seed=0), synthetic_molecules(
        8, seed=1)
    blocked = resolve_config("blocked", config_json='{"num_epochs": 1}')
    errors = pool.run(ranks.runner_raises, "blocked", blocked, train, valid,
                      1, 2, str(tmp_path / "b"))
    assert all(e[0] == "ValueError" and "data-parallel" in e[1]
               for e in errors)
    sparse = resolve_config("sparse", config_json=json.dumps(
        {"num_epochs": 1, "hidden_size": 8, "batch_size": 150,
         "native_pack": False}))
    errors = pool.run(ranks.runner_raises, "sparse", sparse, train, valid,
                      2, 1, str(tmp_path / "d"), call="train_on_device")
    assert all(e == ("ValueError", "train_on_device is single-device; "
                     "mesh training uses train()") for e in errors)
    # A rolling checkpoint whose iterator state stops after the first
    # step of epoch 1, as a single-device run writes it.
    from ggnn_tpu_torch.training.runner import Runner
    one = Runner("sparse", dict(sparse), train_data=train,
                 valid_data=valid, log_dir=str(tmp_path / "one"),
                 quiet=True, tensorboard=False, device="cpu")
    rolling = str(tmp_path / "rolling.pickle")
    one._save(rolling, 1, iterator_state={
        "epoch": 1, "steps_done": 1,
        "np_rng_state": np.random.RandomState(3).get_state()})
    errors = pool.run(ranks.runner_raises, "sparse", sparse, train, valid,
                      2, 1, str(tmp_path / "r"), restore=rolling)
    assert all(e[0] == "ValueError" and "mid-epoch iterator state" in e[1]
               for e in errors)


def test_rank_pool_reports_a_task_a_rank_cannot_import(pools, tmp_path,
                                                       monkeypatch):
    """A function of a module the ranks cannot import (as a script's own
    functions are) fails as a RankError naming the cause, and the pool
    stops; the next case spawns a new one."""
    (tmp_path / "only_here.py").write_text("def f():\n    return 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import only_here
    pool = pools.get(2)
    with pytest.raises(RankError, match="No module named 'only_here'"):
        pool.run(only_here.f)
    assert not pool.alive
    assert pools.get(2).run(ranks.rank) == [0, 1]
