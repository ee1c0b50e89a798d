"""The port's GCN slice (ggnn_tpu_torch: the GCN half of the packer, the
weighted aggregation, models/gcn.py, the adapters, the Runner and the
Predictor for `gcn` and `gcn_blocked`) against the JAX package, on the
CPU, where the weighted aggregation runs its plain version.

Tolerances, each with its reason:
  * the packer: bit for bit;
  * the weighted aggregation against JAX's segment_sum: 1e-5, its
    gradient against jax.grad 1e-4 (f32 sums in another order);
  * node states and readout against the JAX models and the TF1 goldens:
    2e-5 (tests/test_tf1_golden.py pins 2e-5 for the JAX models), their
    gradients 1e-4;
  * TF1 one-step goldens `p/`: rtol 5e-5 / atol 5e-6, the validation
    epoch rtol 3e-5, the bounds tests/test_tf1_golden.py pins;
  * Runner parity per epoch: rtol 5e-4 (two epochs of f32 training in
    another summation order).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.compat.tf1 import params_from_tf1_weights
from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.graph import GCNGraphBatch as JaxGCNGraphBatch
from ggnn_tpu.models import base as jax_base
from ggnn_tpu.models.gcn import GCN as JaxGCN
from ggnn_tpu.models.gcn import BlockedGCN as JaxBlockedGCN
from ggnn_tpu.ops.segment import segment_sum as jax_segment_sum
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.checkpoint import save_checkpoint as jax_save
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu.training.runner import Runner as JaxRunner
from ggnn_tpu_torch.data import native_pack, packing
from ggnn_tpu_torch.data.loader import DatasetMeta
from ggnn_tpu_torch.graph import DenseGraphBatch, GCNGraphBatch
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.gcn import GCN, BlockedGCN, gcn_edges
from ggnn_tpu_torch.ops.kernels import ell_spmm
from ggnn_tpu_torch.ops.segment import segment_offsets
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training import checkpoint
from ggnn_tpu_torch.training.config import (GCN_BLOCKED_DEFAULTS,
                                            GCN_DEFAULTS, resolve_config)
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tf1")
BUCKETS = [16, 32]
SMALL = {"hidden_size": 16, "num_timesteps": 3, "native_pack": False}
GCN_SMALL = {**SMALL, "batch_size": 300}
BLOCKED_SMALL = {**SMALL, "batch_size": 8, "dense_bucket_sizes": BUCKETS}
NO_DROPOUT = {"graph_state_dropout_keep_prob": 1.0,
              "out_layer_dropout_keep_prob": 1.0}
# An edgeless graph and one with an isolated trailing vertex.
ODD_GRAPHS = [
    {"targets": [[0.5]], "graph": [],
     "node_features": [[1, 0, 0, 0, 0]]},
    {"targets": [[-0.2]], "graph": [[0, 1, 1], [1, 2, 2]],
     "node_features": [[1, 0, 0, 0, 0], [0, 1, 0, 0, 0], [0, 0, 1, 0, 0],
                       [0, 0, 0, 1, 0]]},
]


def _data(n=30, seed=13):
    return synthetic_molecules(n, seed=seed) + ODD_GRAPHS


def _assert_identical(got, want):
    for field in dataclasses.fields(got):
        a = np.asarray(getattr(got, field.name))
        b = np.asarray(getattr(want, field.name))
        assert a.dtype == b.dtype, (field.name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=field.name)


def _jax_caps(caps):
    return jax_packing.PackCapacities(**dataclasses.asdict(caps))


# ------------------------------------------------------------- packer

def test_config_key_sets_equal_jax():
    for variant in ("gcn", "gcn_blocked"):
        assert resolve_config(variant) == jax_resolve_config(variant)
    assert GCN_DEFAULTS["batch_size"] == 100000
    assert GCN_BLOCKED_DEFAULTS["dense_bucket_sizes"] == [8, 16, 24, 32]


def test_normalized_adjacency_identical_to_jax():
    for g in _data(8, seed=4):
        n = len(g["node_features"])
        got = packing.graph_to_normalized_adjacency(g["graph"], n)
        want = jax_packing.graph_to_normalized_adjacency(g["graph"], n)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        coo = got[0]
        # Row-major: sorted by target, then source; self-loops present.
        assert np.all(np.diff(coo[:, 0] * n + coo[:, 1]) > 0)
        assert {(i, i) for i in range(n)} <= set(map(tuple, coo.tolist()))


@pytest.mark.parametrize("is_training", [False, True])
def test_pack_gcn_batches_identical_to_jax(is_training):
    """preprocess_gcn (with the training shuffle and the corpus-wide
    task-ratio blanking), the capacity plan and two epochs of packing,
    leaf for leaf; every batch keeps the layout the kernel needs: targets
    sorted, pads (target N, source 0, weight 0) at the end."""
    data = _data(60, seed=5)
    ratios = {"0": 0.5} if is_training else {}
    rngs = [np.random.RandomState(3) if is_training else None
            for _ in range(2)]
    proc = packing.preprocess_gcn(data, [0], ratios, is_training, rngs[0])
    jax_proc = jax_packing.preprocess_gcn(data, [0], ratios, is_training,
                                          rngs[1])
    caps = packing.plan_gcn_capacities(proc, 200)
    assert dataclasses.asdict(caps) == dataclasses.asdict(
        jax_packing.plan_gcn_capacities(jax_proc, 200))
    order = [len(g["init"]) for g in proc]
    for _epoch in range(2):
        got = list(packing.pack_gcn_batches(proc, 200, caps, 16, 5,
                                            is_training, rngs[0]))
        want = list(jax_packing.pack_gcn_batches(
            jax_proc, 200, _jax_caps(caps), 16, 5, is_training, rngs[1]))
        assert len(got) == len(want) > 2
        for a, b in zip(got, want):
            assert isinstance(a, GCNGraphBatch)
            _assert_identical(a, b)
            tgt = a.edge_targets
            assert np.all(np.diff(tgt) >= 0)
            pads = tgt == caps.nodes
            k = int((~pads).sum())
            assert pads[k:].all() and not a.edge_sources[k:].any()
            assert not a.edge_weights[k:].any() and a.edge_weights[:k].all()
    assert [len(g["init"]) for g in proc] == order  # copies were shuffled


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("is_training", [False, True])
def test_pack_gcn_dense_batches_identical_to_jax(is_training, drop_remainder):
    data = _data(70, seed=8)
    ratios = {"0": 0.5} if is_training else {}
    rngs = [np.random.RandomState(3) if is_training else None
            for _ in range(2)]
    sizes = np.asarray(BUCKETS)
    bucketed, got_sizes = packing.preprocess_gcn_dense(
        data, [0], ratios, is_training, rngs[0], bucket_sizes=sizes)
    jax_bucketed, want_sizes = jax_packing.preprocess_gcn_dense(
        data, [0], ratios, is_training, rngs[1], bucket_sizes=sizes)
    np.testing.assert_array_equal(got_sizes, want_sizes)
    for b in jax_bucketed:
        assert [g["graph_id"] for g in bucketed[b]] == \
            [g["graph_id"] for g in jax_bucketed[b]]
        assert [g["labels"] for g in bucketed[b]] == \
            [g["labels"] for g in jax_bucketed[b]]
    got = list(packing.pack_dense_batches(bucketed, got_sizes, 8, 16, 5,
                                          is_training, rngs[0],
                                          drop_remainder))
    want = list(jax_packing.pack_dense_batches(
        jax_bucketed, want_sizes, 8, 16, 5, is_training, rngs[1],
        drop_remainder))
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        assert isinstance(a, DenseGraphBatch) and a.adjacency.shape[1] == 1
        _assert_identical(a, b)


def test_empty_gcn_splits_pack_to_nothing():
    assert list(packing.pack_gcn_batches([], 100, packing.PackCapacities(
        104, 64, 8), 16, 5, True, np.random.RandomState(0))) == []
    assert packing.preprocess_gcn_dense([], [0], {}, True)[0] == {}


@pytest.mark.parametrize("graph,message", [
    ({"graph": [[0, 1, 2]], "node_features": [[1], [0]]}, "vertex id"),
    ({"graph": [[-1, 1, 0]], "node_features": [[1], [0]]}, "vertex id"),
])
def test_preprocess_gcn_rejects_what_jax_rejects(graph, message):
    raw = [{**graph, "targets": [[0.0]]}]
    for pkg in (jax_packing, packing):
        for preprocess in (pkg.preprocess_gcn, pkg.preprocess_gcn_dense):
            with pytest.raises(ValueError, match=message):
                preprocess(raw, [0], {}, False)


def test_plan_gcn_capacities_rejects_an_oversized_graph():
    proc = packing.preprocess_gcn(_data(4), [0], {}, False)
    with pytest.raises(ValueError, match="batch_size"):
        packing.plan_gcn_capacities(proc, 5)


# ------------------------------------------------ weighted aggregation

def _gcn_batch(data, hidden=16, budget=400, shuffle_seed=None):
    """The first packed GCN batch of `data` (numpy leaves); with
    `shuffle_seed`, its COO rows (pads included) in random order."""
    proc = packing.preprocess_gcn(data, [0], {}, False)
    caps = packing.plan_gcn_capacities(proc, budget)
    batch = next(packing.pack_gcn_batches(proc, budget, caps, hidden, 5,
                                          False))
    if shuffle_seed is not None:
        perm = np.random.RandomState(shuffle_seed).permutation(
            len(batch.edge_targets))
        batch = dataclasses.replace(
            batch, edge_sources=batch.edge_sources[perm],
            edge_targets=batch.edge_targets[perm],
            edge_weights=batch.edge_weights[perm])
    return batch


@pytest.mark.parametrize("sorted_edges", [True, False])
def test_weighted_aggregation_and_gradient_match_jax(sorted_edges):
    """The weighted aggregation (plain version on the CPU) against JAX's
    segment_sum(h[src] * w, tgt, N + 1)[:N], and its gradient, through the
    source-sorted transpose, against jax.grad; the batch's COO is shuffled
    when not `sorted_edges` (edges_sorted_by_target: false)."""
    batch = _gcn_batch(_data(), shuffle_seed=None if sorted_edges else 1)
    n_cap = batch.node_capacity
    rng = np.random.RandomState(2)
    h = rng.randn(n_cap, 16).astype(np.float32)
    probe = rng.randn(n_cap, 16).astype(np.float32)

    def jax_loss(x):
        mixed = jax_segment_sum(
            x[batch.edge_sources] * batch.edge_weights[:, None],
            jnp.asarray(batch.edge_targets), n_cap + 1,
            indices_are_sorted=sorted_edges)[:n_cap]
        return jnp.sum(jnp.tanh(mixed) * probe), mixed

    (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(h))
    b = batch.to("cpu")
    src, weights, offsets, transpose = gcn_edges(b, n_cap, sorted_edges,
                                                 True)
    x = torch.from_numpy(h).requires_grad_(True)
    before = (ell_spmm.weighted_launches, ell_spmm.weighted_scatter_launches)
    got = ell_spmm.WeightedGatherSegmentSum.apply(x, src, weights, offsets,
                                                  n_cap, *transpose)
    (grad,) = torch.autograd.grad(
        (torch.tanh(got) * torch.from_numpy(probe)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **KERNEL_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               **GRAD_TOL)
    # The CPU takes the plain version: nothing launches, nothing counts.
    assert (ell_spmm.weighted_launches,
            ell_spmm.weighted_scatter_launches) == before
    # The transpose holds every real edge once, pads past boff[N].
    bgather, bweights, boff = transpose
    real = int((b.edge_targets < n_cap).sum())
    assert int(boff[-1]) == real and int(boff[0]) == 0
    np.testing.assert_array_equal(
        np.sort(bweights[:real].numpy()),
        np.sort(batch.edge_weights[batch.edge_targets < n_cap]))


def test_weighted_transpose_uses_the_real_transpose():
    """A non-symmetric weighted list: the gradient is Âᵀ·g, not Â·g."""
    src = torch.tensor([1, 2, 0, 2], dtype=torch.int32)
    tgt = torch.tensor([0, 0, 1, 2], dtype=torch.int64)
    w = torch.tensor([0.5, 2.0, -1.0, 3.0])
    offsets = segment_offsets(tgt, 3)
    bgather, bweights, boff = ell_spmm.weighted_transpose_layout(
        src.long(), tgt, w, 3)
    h = torch.randn(3, 4, requires_grad=True)
    out = ell_spmm.WeightedGatherSegmentSum.apply(h, src, w, offsets, 3,
                                                  bgather, bweights, boff)
    dense = torch.zeros(3, 3)
    dense[tgt, src.long()] = w
    torch.testing.assert_close(out, dense @ h)
    g = torch.randn(3, 4)
    (grad,) = torch.autograd.grad(out, h, g)
    torch.testing.assert_close(grad, dense.T @ g)


def test_weighted_aggregation_validates_and_needs_its_transpose():
    h = torch.randn(4, 8, requires_grad=True)
    src = torch.tensor([0, 3], dtype=torch.int32)
    offsets = torch.tensor([0, 2], dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        ell_spmm.weighted_gather_segment_sum(
            h, src, torch.ones(2, dtype=torch.float64), offsets, 1)
    with pytest.raises(ValueError, match="one entry an edge"):
        ell_spmm.weighted_gather_segment_sum(h, src, torch.ones(3),
                                             offsets, 1)
    out = ell_spmm.WeightedGatherSegmentSum.apply(
        h, src, torch.ones(2), offsets, 1, None, None, None)
    with pytest.raises(RuntimeError, match="transpose"):
        out.sum().backward()


# -------------------------------------------------------------- models

MODEL_CASES = {"no_bias": {}, "bias": {"gcn_use_bias": True}}


def _configs(variant, extra):
    small = GCN_SMALL if variant == "gcn" else BLOCKED_SMALL
    overrides = json.dumps({**small, **extra})
    config = resolve_config(variant, config_json=overrides)
    assert config == jax_resolve_config(variant, config_json=overrides)
    return config


def _jax_params(config, jax_model, seed=1):
    """JAX init_params and heads, with non-zero biases when the config
    has them."""
    key = jax.random.PRNGKey(seed)
    params = {"graph": jax_model.init_params(key),
              "heads": jax_base.init_output_heads(key, config["hidden_size"],
                                                  config["task_ids"])}
    rng = np.random.RandomState(seed)
    for layer in params["graph"]["layers"]:
        if "b" in layer:
            layer["b"] = (0.3 * rng.randn(*layer["b"].shape)).astype(
                np.float32)
    return params


def _port_params(model, config, jax_params):
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(model, init_output_heads(
        gen, config["hidden_size"], config["task_ids"]))
    params.load_state_dict(checkpoint.params_from_jax_weights(
        _flatten_named({"params": jax_params})), strict=True)
    return params


def _port_batch(jax_batch, cls):
    return cls(**{f.name: getattr(jax_batch, f.name)
                  for f in dataclasses.fields(cls)}).to("cpu")


def _jax_gcn_batches(data, config):
    proc = jax_packing.preprocess_gcn(data, [0], {}, False)
    caps = jax_packing.plan_gcn_capacities(proc, config["batch_size"])
    return list(jax_packing.pack_gcn_batches(
        proc, config["batch_size"], caps, config["hidden_size"], 5, False))


def _jax_dense_batches(data, config):
    bucketed, sizes = jax_packing.preprocess_gcn_dense(
        data, [0], {}, False,
        bucket_sizes=np.asarray(config["dense_bucket_sizes"]))
    return list(jax_packing.pack_dense_batches(
        bucketed, sizes, config["batch_size"], config["hidden_size"], 5,
        False, drop_remainder=False))


def _assert_matches_jax(port, jax_model, jax_params, batches, cls):
    """Node states, outputs, the loss and every gradient of each batch
    against the JAX model's."""
    names = [n for n, _ in port.named_parameters()]

    def jax_loss(p, jb):
        final = jax_model.forward(p["graph"], jb)
        computed = jax_model.readout(p["heads"], [0], final, jb)
        loss = jax_base.masked_regression_loss(
            computed, jb.targets, jb.target_mask, [0], {})[0]
        return loss, (final, computed)

    jax_step = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    for jb in batches:
        (want_loss, (want, want_out)), jax_grads = jax_step(jax_params, jb)
        want_grads = checkpoint.params_from_jax_weights(_flatten_named(
            {"params": jax_grads}))
        assert sorted(names) == sorted(want_grads)
        batch = _port_batch(jb, cls)
        final = port.graph(batch)
        out = port.graph.readout(port.heads, [0], final, batch)
        loss, _ = base.masked_regression_loss(
            out, batch.targets, batch.target_mask, [0], {})
        grads = torch.autograd.grad(loss, list(port.parameters()))
        np.testing.assert_allclose(final.detach().numpy(), np.asarray(want),
                                   **TOL)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(want_out), **TOL)
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=1e-5)
        for name, grad in zip(names, grads):
            np.testing.assert_allclose(grad.numpy(),
                                       want_grads[name].numpy(),
                                       err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_gcn_matches_jax(case):
    config = _configs("gcn", MODEL_CASES[case])
    jax_model = JaxGCN(config)
    jax_params = _jax_params(config, jax_model)
    port = _port_params(GCN(config, torch.Generator().manual_seed(0)),
                        config, jax_params)
    batches = _jax_gcn_batches(_data(), config)
    assert len(batches) > 1
    _assert_matches_jax(port, jax_model, jax_params, batches, GCNGraphBatch)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_blocked_gcn_matches_jax(case):
    config = _configs("gcn_blocked", MODEL_CASES[case])
    jax_model = JaxBlockedGCN(config)
    jax_params = _jax_params(config, jax_model)
    port = _port_params(BlockedGCN(config, torch.Generator().manual_seed(0)),
                        config, jax_params)
    batches = _jax_dense_batches(_data(), config)
    assert len({b.node_features.shape[1] for b in batches}) == len(BUCKETS)
    _assert_matches_jax(port, jax_model, jax_params, batches,
                        DenseGraphBatch)


def test_gcn_with_unsorted_edges_matches_jax():
    """`edges_sorted_by_target: false`: a batch whose COO rows are
    shuffled, stable-sorted on the device before the kernel; the same
    numbers as JAX's unsorted segment_sum, and as the sorted batch."""
    config = _configs("gcn", {"gcn_use_bias": True,
                              "edges_sorted_by_target": False})
    jax_model = JaxGCN(config)
    jax_params = _jax_params(config, jax_model)
    port = _port_params(GCN(config, torch.Generator().manual_seed(0)),
                        config, jax_params)
    shuffled = _gcn_batch(_data(), budget=300, shuffle_seed=5)
    _assert_matches_jax(port, jax_model, jax_params,
                        [JaxGCNGraphBatch(**dataclasses.asdict(shuffled))],
                        GCNGraphBatch)
    with torch.no_grad():
        np.testing.assert_allclose(
            port.graph(shuffled.to("cpu")).numpy(),
            port.graph(_gcn_batch(_data(), budget=300).to("cpu")).numpy(),
            **TOL)


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_gcn_and_blocked_gcn_agree_graph_for_graph(case):
    """The same parameters through `gcn` (one packed COO batch) and
    `gcn_blocked` (bucketed dense batches): the same node states and
    outputs for every graph, in corpus order."""
    data = _data()
    gcn_config = _configs("gcn", {**MODEL_CASES[case], "batch_size": 2000})
    blocked_config = _configs("gcn_blocked", MODEL_CASES[case])
    gen = torch.Generator().manual_seed(4)
    edge = ModelParams(GCN(gcn_config, gen),
                       init_output_heads(gen, 16, [0])).eval()
    with torch.no_grad():
        for name, p in edge.graph.named_parameters():
            if name.endswith(".b"):
                p.normal_(generator=gen)
    blocked = ModelParams(BlockedGCN(blocked_config, gen),
                          init_output_heads(gen, 16, [0])).eval()
    blocked.load_state_dict(edge.state_dict(), strict=True)
    sb = _gcn_batch(data, budget=2000).to("cpu")
    assert int(sb.num_graphs) == len(data)
    bucketed, _ = packing.preprocess_gcn_dense(
        data, [0], {}, False, bucket_sizes=np.asarray(BUCKETS))
    order = [g["graph_id"] for b in bucketed.values() for g in b]
    with torch.no_grad():
        s_final = edge.graph(sb)
        s_out = edge.graph.readout(edge.heads, [0], s_final, sb)
        d_states, d_out = [], []
        for jb in _jax_dense_batches(data, blocked_config):
            batch = _port_batch(jb, DenseGraphBatch)
            final = blocked.graph(batch)
            n = int(batch.num_graphs)
            d_out.append(blocked.graph.readout(blocked.heads, [0], final,
                                               batch)[:, :n])
            d_states += [final[i, :int(batch.node_mask[i].sum())]
                         for i in range(n)]
    np.testing.assert_allclose(torch.cat(d_out, dim=1).numpy(),
                               s_out[:, np.asarray(order)].numpy(), **TOL)
    starts = np.concatenate([[0], np.cumsum(
        [len(g["node_features"]) for g in data])])
    for states, graph_id in zip(d_states, order):
        np.testing.assert_allclose(
            states.numpy(),
            s_final[starts[graph_id]:starts[graph_id + 1]].numpy(), **TOL)


def test_state_dropout_needs_a_generator_and_follows_its_seed():
    config = _configs("gcn", {"graph_state_dropout_keep_prob": 0.5})
    model = GCN(config, torch.Generator().manual_seed(0))
    batch = _gcn_batch(_data(8)).to("cpu")

    def run(seed):
        with torch.no_grad():
            return model(batch, is_training=True,
                         generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    with torch.no_grad():
        assert not torch.equal(run(3), model(batch))
    with pytest.raises(ValueError, match="Generator"):
        model(batch, is_training=True)
    # keep probability 1: no generator needed, the same as serving.
    plain = GCN(_configs("gcn", {}), torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(plain(batch, is_training=True), plain(batch))


def test_unported_options_raise_naming_their_item():
    gen = torch.Generator().manual_seed(0)
    # The node-sharded branch is ported (ROADMAP A11): edge_axis is the
    # mesh's edge Axis, and JAX's bare axis name names no process group.
    from ggnn_tpu_torch.parallel.mesh import Axis
    with pytest.raises(TypeError, match="mesh Axis"):
        GCN(_configs("gcn", {}), gen, edge_axis="edge")
    axis = Axis("edge", 2, 0, (0, 1))
    assert GCN(_configs("gcn", {}), gen, edge_axis=axis).edge_axis is axis
    # compute_dtype: bfloat16 is ported: BlockedGCN computes in it, the
    # edge-list GCN ignores it, as in JAX (tests/test_torch_bf16.py).
    bf16 = {"compute_dtype": "bfloat16"}
    assert BlockedGCN(_configs("gcn_blocked", bf16),
                      gen).compute_dtype == torch.bfloat16
    assert GCN(_configs("gcn", bf16), gen).compute_dtype == torch.float32
    with pytest.raises(ValueError, match="lane_pad"):
        BlockedGCN(_configs("gcn_blocked", {"lane_pad": "false"}), gen)
    assert BlockedGCN(_configs("gcn_blocked", {}), gen).lane_pad is True


def test_parameter_names_are_the_jax_key_paths():
    config = _configs("gcn", {"gcn_use_bias": True})
    params = ModelParams(GCN(config, torch.Generator().manual_seed(0)),
                         init_output_heads(torch.Generator(), 16, [0]))
    weights = checkpoint.jax_weights_from_params(params)
    jax_keys = set(_flatten_named({"params": _jax_params(
        config, JaxGCN(config))}))
    assert set(weights) == jax_keys
    assert "['params']['graph']['layers'][2]['b']" in weights


# -------------------------------------------------------- TF1 goldens

GOLDENS = ["gcn_default", "gcn_bias"]


def _load_fixture(case):
    data = np.load(os.path.join(FIXTURE_DIR, f"{case}.npz"))
    return json.loads(str(data["meta"])), data


def _group(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files
            if k.startswith(prefix)}


def _golden_runner(meta, variant, tmp_path):
    """A CPU Runner of `variant` over the fixture's corpus. `gcn_blocked`
    puts every validation graph into one bucket batch, as the
    reference's one edge-list batch holds them, so that its one Adam
    step is the reference's."""
    corpus = meta["corpus"]
    train = synthetic_molecules(corpus["n_train"], seed=corpus["seed"],
                                num_targets=corpus["num_targets"])
    valid = synthetic_molecules(corpus["n_valid"], seed=corpus["seed"] + 1,
                                num_targets=corpus["num_targets"])
    extra = ({"dense_bucket_sizes": [32], "batch_size": 16}
             if variant == "gcn_blocked" else {})
    config = resolve_config(variant, config_json=json.dumps(
        {**meta["config"], **extra}))
    runner = Runner(variant, config, train_data=train, valid_data=valid,
                    log_dir=str(tmp_path), quiet=True, device="cpu")
    return runner, config, valid


def _tf1_params(variant, weights, config):
    return checkpoint.params_from_jax_weights(_flatten_named(
        {"params": params_from_tf1_weights(variant, weights, config, 1)}))


@pytest.mark.parametrize("variant", ["gcn", "gcn_blocked"])
@pytest.mark.parametrize("case", GOLDENS)
def test_tf1_golden(case, variant, tmp_path):
    """The reference's own GCN (chem_tensorflow_gcn.py) from its weights
    `w/`: final node states of the first validation batch at 2e-5, the
    validation epoch's loss and MAE, and one train step, which must give
    the reference's post-step weights `p/`."""
    meta, data = _load_fixture(case)
    runner, config, valid = _golden_runner(meta, variant, tmp_path)
    runner.params.load_state_dict(
        _tf1_params(variant, _group(data, "w/"), config), strict=True)
    batches = list(runner.adapter.batches(runner.valid_processed, False))
    assert len(batches) == 1
    batch = batches[0].to("cpu")
    ref_states = np.asarray(data["final_states"], np.float32)
    with torch.no_grad():
        final = runner.model(batch).numpy()
    if variant == "gcn":
        np.testing.assert_allclose(final[:ref_states.shape[0]], ref_states,
                                   **TOL)
    else:
        processed = runner.valid_processed
        if isinstance(processed, native_pack.DenseProcessed):
            # The native packer (the default) keeps each bucket's ids.
            order = [int(i) for ids in processed.bucket_order for i in ids]
        else:
            order = [g["graph_id"] for b in processed.values() for g in b]
        starts = np.concatenate([[0], np.cumsum(
            [len(g["node_features"]) for g in valid])])
        for row, graph_id in enumerate(order):
            n = starts[graph_id + 1] - starts[graph_id]
            np.testing.assert_allclose(
                final[row, :n],
                ref_states[starts[graph_id]:starts[graph_id + 1]], **TOL)
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
    want = _tf1_params(variant, _group(data, "p/"), config)
    got = dict(runner.params.named_parameters())
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   rtol=5e-5, atol=5e-6,
                                   err_msg=f"{case} {variant}: {name}")


# ------------------------------------------------------ Runner parity

RUNS = {
    "gcn": {**GCN_SMALL, "gcn_use_bias": True},
    "gcn_blocked": {**BLOCKED_SMALL, "gcn_use_bias": True},
}


@pytest.fixture(scope="module", params=sorted(RUNS))
def trained_gcn_pair(request, tmp_path_factory):
    """The JAX Runner and the port's for a GCN variant, same seed, same
    corpus, injected weights, numpy packers, no dropout, each trained for
    2 epochs."""
    variant = request.param
    config_json = json.dumps({**RUNS[variant], **NO_DROPOUT,
                              "num_epochs": 2, "random_seed": 3})
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
    port_runner.params.load_state_dict(
        checkpoint.params_from_jax_weights(_flatten_named(
            {"params": jax_runner.state["params"]})), strict=True)
    jax_log = jax_runner.train()
    port_log = port_runner.train()
    return variant, jax_runner, jax_log, port_runner, port_log, train, valid


def test_gcn_runner_matches_jax_runner_over_two_epochs(trained_gcn_pair):
    variant, jax_runner, jax_log, port_runner, port_log, _, _ = \
        trained_gcn_pair
    if variant == "gcn":
        assert dataclasses.asdict(port_runner.adapter.caps) == \
            dataclasses.asdict(jax_runner.adapter.caps)
    else:
        assert port_runner.adapter.drop_remainder is False
    assert len(port_log) == len(jax_log) == 2
    assert port_runner.train_step_id == jax_runner.train_step_id > 2
    assert port_runner.valid_step_id == jax_runner.valid_step_id
    assert port_runner.prop_steps == jax_runner.prop_steps == 3
    for got, want in zip(port_log, jax_log):
        for split in ("train_results", "valid_results"):
            for i in range(3):   # loss, MAE, error_ratio
                np.testing.assert_allclose(
                    np.asarray(got[split][i]), np.asarray(want[split][i]),
                    rtol=5e-4, err_msg=f"epoch {got['epoch']} {split} {i}")
    assert port_runner.last_edge_msg_per_sec > 0


def test_gcn_checkpoints_restore_across_packages(trained_gcn_pair,
                                                 tmp_path):
    """Each Runner's final weights and Adam state, saved by its own
    package, restore in the other's Runner."""
    variant, jax_runner, _, port_runner, _, train, valid = trained_gcn_pair
    port_path = str(tmp_path / "port.pickle")
    port_runner._save(port_path)
    restored = JaxRunner(variant, dict(port_runner.config), train_data=train,
                         valid_data=valid, log_dir=str(tmp_path / "jax"),
                         quiet=True, tensorboard=False, restore=port_path)
    assert int(restored.state["opt_state"][1]["count"]) == \
        port_runner.optimizer.count
    for name, value in checkpoint.params_from_jax_weights(_flatten_named(
            {"params": restored.state["params"]})).items():
        np.testing.assert_array_equal(
            value.numpy(),
            dict(port_runner.params.named_parameters())[name].detach()
            .numpy())
    jax_path = str(tmp_path / "jax.pickle")
    jax_save(jax_path, jax_runner.config, jax_runner.state,
             jax_runner.train_step_id, jax_runner.valid_step_id)
    port = Runner(variant, dict(jax_runner.config), train_data=train,
                  valid_data=valid, log_dir=str(tmp_path / "port"),
                  quiet=True, device="cpu", restore=jax_path)
    assert port.optimizer.count == jax_runner.train_step_id


# ----------------------------------------------------------- serving

def _jax_checkpoint(path, variant):
    config = jax_resolve_config(variant, config_json=json.dumps(
        {**RUNS[variant]}))
    model = JaxGCN(config) if variant == "gcn" else JaxBlockedGCN(config)
    params = _jax_params(config, model, seed=6)
    jax_save(str(path), config, {"params": params}, 5, 2)
    return str(path)


# `gcn_blocked` is served in tests/test_torch_serving.py with the dense
# family.
ENVELOPE = dict(max_nodes=64, max_graphs=8)


@pytest.mark.parametrize("n_graphs", [1, 40])
def test_predictor_serves_a_jax_gcn_checkpoint(tmp_path, n_graphs):
    """A JAX-written `gcn` checkpoint served by both Predictors over the
    same envelope: the same answers, micro-batched the same way, and each
    graph answered alone as inside the request."""
    path = _jax_checkpoint(tmp_path / "jax.pickle", "gcn")
    want_pred = JaxPredictor.from_checkpoint(path, "gcn", **ENVELOPE)
    port = Predictor.from_checkpoint(path, "gcn", device="cpu", **ENVELOPE)
    assert port.meta.num_edge_types == 1
    request = synthetic_molecules(n_graphs, seed=80 + n_graphs)
    got = port(request)
    want = want_pred(request)
    assert got.shape == want.shape == (1, n_graphs)
    np.testing.assert_allclose(got, want, **TOL)
    assert len(list(port._batches(request, 5))) == len(
        list(want_pred._batches(request, 5)))
    if n_graphs > 1:
        alone = np.concatenate([port([g]) for g in request[:4]], axis=1)
        np.testing.assert_allclose(got[:, :4], alone, **TOL)


def test_port_gcn_checkpoint_serves_in_jax_predictor(tmp_path):
    config = resolve_config("gcn", config_json=json.dumps(RUNS["gcn"]))
    gen = torch.Generator().manual_seed(9)
    adapter = make_adapter("gcn", config, DatasetMeta(64, 1, 16))
    params = ModelParams(adapter.build_model(gen),
                         init_output_heads(gen, 16, config["task_ids"]))
    path = str(tmp_path / "port.pickle")
    checkpoint.save_checkpoint(path, config, params, 3, 1)
    want_pred = JaxPredictor.from_checkpoint(path, "gcn", **ENVELOPE)
    port = Predictor.from_checkpoint(path, "gcn", device="cpu", **ENVELOPE)
    request = synthetic_molecules(20, seed=62)
    np.testing.assert_allclose(port(request), want_pred(request), **TOL)


def test_pack_single_gcn_blocked_identical_to_jax(tmp_path):
    """The 1-graph latency pack of `gcn_blocked` equals JAX's and the
    corpus pack of a 1-graph request, leaf for leaf."""
    path = _jax_checkpoint(tmp_path / "jax.pickle", "gcn_blocked")
    jax_pred = JaxPredictor.from_checkpoint(path, "gcn_blocked")
    port = Predictor.from_checkpoint(path, "gcn_blocked", device="cpu")
    for g in synthetic_molecules(4, seed=6) + ODD_GRAPHS:
        got = port._pack_single_dense(g, 5)
        _assert_identical(got, jax_pred._pack_single_dense(g, 5))
        order, batches = port._dense_batches([g], 5)
        assert order == [0]
        _assert_identical(got, next(iter(batches)))
