"""Replayed steps where the JAX package jits them (`utils/timing.py`
`StepCache`): the Runner's train and validation steps and `predict`'s
forward, the Predictor's and an artifact's forward, and the async model
with its `recv_base` offsets on the device, on the CPU.

On the CPU a cache runs each step eagerly. To hold its replay path here,
the `card` fixture stands a fake graph in for each capture
(tests/torch_fake_card.py): a replay runs the step eagerly on a copy of
the batch whose counts are None, as a captured step sees them, and
writes into the same output buffers every time, as a CUDA graph's
static outputs are written, so that a caller that kept a replay's
outputs without a copy would see the next replay's values. CUDA graphs themselves are held to eager steps on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 23).

Tolerances, each with its reason:
  * replayed against eager, on the CPU: exact (the same operations);
  * the async model against JAX's `AsyncGGNN`: node states 2e-5,
    gradients 1e-4 of each leaf's largest entry (tests/test_torch_async.py:
    f32 sums in another order through R rounds of substeps).
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import async_schedule as jax_async
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models.async_ggnn import AsyncGGNN as JaxAsyncGGNN
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu_torch.data import async_schedule
from ggnn_tpu_torch.export import export_predictor, load_predictor
from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.server import PredictionServer
from ggnn_tpu_torch.training import checkpoint
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.training.variants import make_adapter
from ggnn_tpu_torch.utils.timing import StepCache, graph_key

import torch_fake_card

torch.set_num_threads(1)

NO_DROPOUT = {"edge_weight_dropout_keep_prob": 1.0,
              "graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
# Small configurations (2-3 layers, H 16) whose 60-molecule corpus packs
# into several batches, and for the dense family several buckets.
SMALL = {
    "sparse": {"hidden_size": 16, "layer_timesteps": [2, 1],
               "residual_connections": {"1": [0]}, "batch_size": 300},
    "rgcn": {"hidden_size": 16, "layer_timesteps": [1, 1, 1],
             "batch_size": 300},
    "dense": {"hidden_size": 16, "num_timesteps": 2, "batch_size": 8,
              "drop_remainder": False},
    "blocked": {"hidden_size": 16, "layer_timesteps": [2, 1],
                "residual_connections": {"1": [0]}, "batch_size": 8},
    "gcn": {"hidden_size": 16, "num_timesteps": 2, "batch_size": 300},
    "gcn_blocked": {"hidden_size": 16, "num_timesteps": 2, "batch_size": 8},
    # The synthetic corpus reaches schedule depth 17; the default 15
    # raises. The default `async_epoch_shuffle` ("graphs") repacks the
    # corpus every epoch.
    "async": {"hidden_size": 16, "propagation_rounds": 2,
              "propagation_substeps": 40, "num_nodes": 200},
}


def _runner(variant, tmp_path, name="run", overrides=None, n_train=60):
    config = resolve_config(variant, config_json=json.dumps(
        {**SMALL[variant], "random_seed": 3, **(overrides or {})}))
    return Runner(variant, config,
                  train_data=synthetic_molecules(n_train, seed=11),
                  valid_data=synthetic_molecules(20, seed=12),
                  log_dir=str(tmp_path / name), quiet=True,
                  tensorboard=False, device="cpu")


@pytest.fixture
def card(monkeypatch):
    """Every cache takes its replay path, with a fake graph a capture
    (tests/torch_fake_card.py); yields the captures, (cache name, key)
    in order."""
    captured = []
    for obj, name, value in torch_fake_card.patches(captured):
        monkeypatch.setattr(obj, name, value)
    return captured


# ------------------------------------------------------------- keys

def test_host_and_device_batches_share_a_key_and_counts_are_not_in_it():
    """A packed numpy batch and its tensors share a key, for every batch
    type; the counts are left out, a shape or a dtype is not."""
    for variant in ("sparse", "dense", "gcn", "async"):
        config = resolve_config(variant, config_json=json.dumps(
            SMALL[variant]))
        from ggnn_tpu_torch.data.loader import infer_metadata
        raw = synthetic_molecules(20, seed=1)
        meta = infer_metadata([raw], config["tie_fwd_bkwd"])
        adapter = make_adapter(variant, config, meta)
        processed = adapter.preprocess(raw, False)
        adapter.plan(processed, processed)
        batch = next(iter(adapter.batches(processed, False)))
        assert graph_key(batch) == graph_key(batch.to("cpu")), variant
        fewer = dataclasses.replace(batch, num_graphs=np.int32(0))
        assert graph_key(fewer) == graph_key(batch), variant
        wider = dataclasses.replace(
            batch, targets=np.zeros((2,) + batch.targets.shape[1:],
                                    np.float32))
        assert graph_key(wider) != graph_key(batch), variant
        as_f64 = dataclasses.replace(
            batch, targets=np.asarray(batch.targets, np.float64))
        assert graph_key(as_f64) != graph_key(batch), variant


def test_train_validation_and_predict_never_share_a_graph(card, tmp_path):
    """A sparse training batch and a validation batch have the same
    shapes, so one key: each of the three steps still replays its own
    graph."""
    runner = _runner("sparse", tmp_path, overrides={"num_epochs": 1})
    runner.train()
    runner.predict(synthetic_molecules(5, seed=13))
    caches = {"train step": runner.train_graphs,
              "validation step": runner.eval_graphs,
              "prediction forward": runner.predict_graphs}
    assert {name for name, _ in card} == set(caches)
    assert runner.graph_counts() == {"train": 1, "validation": 1,
                                     "predict": 1}
    (train_key,) = runner.train_graphs.graphs
    assert train_key in runner.eval_graphs.graphs
    assert train_key in runner.predict_graphs.graphs
    graphs = [c.graphs[train_key] for c in caches.values()]
    assert len({id(g) for g in graphs}) == 3
    for name, cache in caches.items():
        assert graphs[list(caches).index(name)].cache is cache


@pytest.mark.parametrize("variant", sorted(SMALL))
def test_train_keys_after_epoch_2_equal_those_after_epoch_1(card, variant,
                                                            tmp_path):
    """Over 2 epochs of `train()` each variant captures its train graphs
    in epoch 1 only. For `async` (its default `async_epoch_shuffle`,
    "graphs", repacks every epoch) the batches replayed differ in their
    `recv_base` offsets, which no longer split a key."""
    runner = _runner(variant, tmp_path, overrides={"num_epochs": 2})
    keys, run_epoch = [], runner.run_epoch

    def recorded(name, processed, is_training):
        out = run_epoch(name, processed, is_training)
        if is_training:
            keys.append(set(runner.train_graphs.graphs))
        return out

    runner.run_epoch = recorded
    runner.train()
    assert len(keys) == 2
    assert keys[0] and keys[1] == keys[0]
    if variant == "async":
        assert runner.config.get("async_epoch_shuffle", "graphs") == "graphs"
        bases = {tuple(tuple(np.asarray(s.recv_base).tolist())
                       for r in b.seg_rounds for s in r)
                 for g in runner.train_graphs.graphs.values()
                 for b in g.batches}
        assert len(bases) > len(keys[0])
    if variant in ("dense", "blocked", "gcn_blocked"):
        assert len(keys[0]) > 1   # one graph a bucket


# --------------------------------------------------------- aliasing

def test_run_epoch_and_predict_keep_each_replays_outputs(card, tmp_path):
    """The replayed epoch's per-step losses and MAEs, each a copy of its
    replay's, equal the eager steps' over the same batches; so do
    `predict`'s outputs, distinct tensors a batch."""
    replayed = _runner("sparse", tmp_path, "replayed", NO_DROPOUT,
                       n_train=120)
    eager = _runner("sparse", tmp_path, "eager", NO_DROPOUT, n_train=120)
    seen = {"train": [], "validation": []}
    replayed.summaries.add_batch = (
        lambda split, step, loss, accs, tasks:
        seen[split].append((loss, np.asarray(accs).copy())))
    rng_state = replayed.np_rng.get_state()
    replayed.run_epoch("train", replayed.train_processed, True)
    replayed.run_epoch("valid", replayed.valid_processed, False)

    eager.np_rng.set_state(rng_state)
    want = {"train": [], "validation": []}
    for split, processed, step in (
            ("train", eager.train_processed, eager.train_step),
            ("validation", eager.valid_processed, eager.eval_step)):
        rng = eager.np_rng if split == "train" else None
        for batch in eager.adapter.batches(processed, split == "train", rng):
            loss, accs = step(batch.to("cpu"))
            want[split].append((float(loss), accs.detach().numpy()))
    for split in want:
        assert len(seen[split]) == len(want[split]) > 1
        assert len({loss for loss, _ in seen[split]}) > 1
        for (got_loss, got_accs), (loss, accs) in zip(seen[split],
                                                      want[split]):
            assert got_loss == loss
            np.testing.assert_array_equal(got_accs, accs)
    for name, p in replayed.params.named_parameters():
        assert torch.equal(p, dict(eager.params.named_parameters())[name])

    raw = synthetic_molecules(40, seed=14)
    processed = replayed.adapter.preprocess(raw, False)
    batches = list(replayed.adapter.batches(processed, False))
    assert len(batches) > 1
    outs = [replayed.predict_graphs(b) for b in batches]
    assert len({id(o) for o in outs}) == len(outs)
    for out, batch in zip(outs, batches):
        with torch.no_grad():
            want_out = eager._outputs(batch.to("cpu"), False)
        assert torch.equal(out, want_out)
    got = np.concatenate(replayed.predict(raw), axis=1)
    np.testing.assert_array_equal(
        got, np.concatenate(eager.predict(raw), axis=1))


# ---------------------------------------------------------- serving

def _predictor(variant, tmp_path, max_nodes=256, max_graphs=32):
    config = resolve_config(variant, config_json=json.dumps(SMALL[variant]))
    from ggnn_tpu_torch.data.loader import DatasetMeta
    # The GCN variants discard edge types (`serving._infer_geometry`).
    meta = DatasetMeta(max_nodes, 1 if variant.startswith("gcn") else 4, 5)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(
        graph=make_adapter(variant, config, meta).build_model(gen),
        heads=init_output_heads(gen, config["hidden_size"],
                                config["task_ids"]))
    return Predictor(variant, config, meta, params, max_nodes=max_nodes,
                     max_graphs=max_graphs, device="cpu")


@pytest.mark.parametrize("variant", ["sparse", "dense", "async"])
def test_predictor_threads_answer_as_serial_calls(card, variant, tmp_path):
    """16 threads calling one Predictor at once, each request copied in,
    replayed and read back under the Predictor's lock, get the answers
    of serial calls."""
    predictor = _predictor(variant, tmp_path)
    requests = [synthetic_molecules(n, seed=20 + n) for n in
                (1, 3, 7, 12) * 4]
    serial = [predictor(r) for r in requests]
    results = [None] * len(requests)
    start = threading.Barrier(len(requests))

    def call(i):
        start.wait()
        results[i] = predictor(requests[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got, want in zip(results, serial):
        np.testing.assert_array_equal(got, want)
    assert predictor.graph_count() >= 1


@pytest.mark.parametrize("variant", ["sparse", "dense", "async"])
def test_replayed_predictor_and_artifact_equal_eager(card, variant,
                                                     tmp_path):
    """The replayed forward answers as `serve_forward` run eagerly, for
    the live Predictor and for its artifact, whose forward dispatches to
    the program of the batch's shape."""
    predictor = _predictor(variant, tmp_path)
    path = export_predictor(predictor, str(tmp_path / f"{variant}.ggnnx"))
    artifact = load_predictor(path, device="cpu")
    request = synthetic_molecules(40, seed=5)
    want = _predictor(variant, tmp_path)
    eager = [want._serve(b.to("cpu")) for b in (
        want._batches(request, 5) if variant != "dense"
        else want._dense_batches(request, 5)[1])]
    assert eager
    for served in (predictor, artifact):
        got = served(request)
        assert got.shape == (1, 40)
    np.testing.assert_array_equal(predictor(request), want(request))
    np.testing.assert_allclose(artifact(request), want(request),
                               rtol=1e-6, atol=1e-6)
    assert artifact.graph_count() == predictor.graph_count() >= 1


@pytest.mark.parametrize("variant", ["sparse", "dense", "gcn_blocked"])
def test_server_warmup_captures_each_batch_shape(card, variant, tmp_path):
    """The server's warm-up sends one request a batch shape traffic will
    use: the envelope's, or each dense bucket's, each captured before the
    first client; traffic then captures nothing."""
    predictor = _predictor(variant, tmp_path)
    server = PredictionServer(predictor, port=0)
    try:
        server.warmup()
        shapes = len(predictor.example_graphs())
        assert predictor.graph_count() == shapes
        assert shapes > 1 if variant != "sparse" else shapes == 1
        captured = len(card)
        server.predict(synthetic_molecules(30, seed=6))
        server.predict(synthetic_molecules(1, seed=7))
        assert len(card) == captured
    finally:
        server._httpd.server_close()


# ------------------------------------------------ async recv_base

H, T, S = 16, 4, 40


def _graph_state(jax_params):
    named = checkpoint.params_from_jax_weights(
        _flatten_named({"params": {"graph": jax_params}}))
    return {k[len("graph."):]: v for k, v in named.items()}


@pytest.fixture(scope="module")
def async_pair():
    """(port batch, JAX batch) of one training pack whose segments write
    at non-zero `recv_base` offsets (the JAX flat packer, the same plan
    and RandomState)."""
    raw = synthetic_molecules(30, seed=9)
    args = (raw, T, True, 2, S, [0], {}, True)
    port_proc = async_schedule.preprocess_async(*args,
                                                np.random.RandomState(1))
    jax_proc = jax_async.preprocess_async(*args, np.random.RandomState(1))
    caps = async_schedule.plan_async_capacities(port_proc, T, 200, 2)
    jax_caps = jax_async.AsyncCapacities(**dataclasses.asdict(caps))
    port = list(async_schedule.pack_async_batches(
        port_proc, T, 200, caps, 2, S, H, 5, True, np.random.RandomState(3)))
    want = list(jax_async.pack_async_batches(
        jax_proc, T, 200, jax_caps, 2, S, H, 5, True,
        np.random.RandomState(3), use_flat=True))
    return port[0], want[0]


@pytest.mark.parametrize("remat", [False, True])
def test_async_device_recv_base_matches_jax(async_pair, remat):
    """The segmented path, each substep's rows written through device
    indices at i_cap + recv_base[k], against JAX's dynamic_update_slice:
    node states at 2e-5 and every gradient at 1e-4, remat on and off."""
    port_batch, jax_batch = async_pair
    assert port_batch.seg_rounds is not None
    bases = [int(v) for r in port_batch.seg_rounds for s in r
             for v in np.asarray(s.recv_base)]
    assert max(bases) > 0
    on_cpu = port_batch.to("cpu")
    assert all(isinstance(s.recv_base, torch.Tensor)
               for r in on_cpu.seg_rounds for s in r)
    config = {"hidden_size": H, "propagation_rounds": 2,
              "propagation_substeps": S, "use_edge_bias": True,
              "graph_rnn_cell": "GRU", "graph_rnn_activation": "tanh",
              "graph_state_dropout_keep_prob": 1.0, "async_remat": remat}
    jax_model = JaxAsyncGGNN(dict(config), T)
    params = jax_model.init_params(jax.random.PRNGKey(3))
    rng = np.random.RandomState(3)
    params["edge_biases"] = [jnp.asarray(rng.randn(H).astype(np.float32)
                                         * 0.3) for _ in range(T)]
    model = AsyncGGNN(dict(config), T, torch.Generator().manual_seed(0))
    model.load_state_dict(_graph_state(params), strict=True)
    weights = np.random.RandomState(0).randn(
        port_batch.node_capacity, H).astype(np.float32)
    _, grads = jax.value_and_grad(lambda p: jnp.sum(
        jax_model.forward(p, jax_batch) * weights))(params)
    out = model(on_cpu)
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jax_model.forward(params, jax_batch)),
        rtol=2e-5, atol=2e-5)
    (out * torch.from_numpy(weights)).sum().backward()
    want = _graph_state(grads)
    for name, p in model.named_parameters():
        scale = float(want[name].abs().max()) + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   want[name].numpy() / scale, rtol=0,
                                   atol=1e-4, err_msg=name)


def test_a_cache_on_the_cpu_runs_the_step_eagerly():
    """Without a card nothing is captured: each call runs the step on the
    batch moved to the cache's device, and `read` sees its outputs."""
    calls = []

    def step(batch):
        calls.append(batch)
        return batch * 2, batch.sum()

    cache = StepCache(step, "cpu")
    doubled, total = cache(np.arange(3, dtype=np.float32))
    assert isinstance(calls[0], torch.Tensor)
    assert doubled.tolist() == [0.0, 2.0, 4.0] and float(total) == 3.0
    assert cache(torch.ones(2), read=lambda out: float(out[1])) == 2.0
    assert cache.graphs == {}
