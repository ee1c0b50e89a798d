"""The port's host pipeline (ggnn_tpu_torch/data, serving single-graph
pack) against the JAX package's: the same corpus must give bit-identical
numpy leaves."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.loader import DatasetMeta as JaxDatasetMeta
from ggnn_tpu.data.loader import infer_metadata as jax_infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules as jax_synthetic
from ggnn_tpu.models.base import init_output_heads as jax_init_heads
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.serving import Predictor as JaxPredictor
from ggnn_tpu.training.config import default_params_for as jax_defaults
from ggnn_tpu_torch.data import packing
from ggnn_tpu_torch.data.loader import DatasetMeta, infer_metadata
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.serving import Predictor
from ggnn_tpu_torch.training.config import default_params_for

torch.set_num_threads(1)


def _assert_batches_identical(got, want):
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)
                     if f.name in names]
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed,num_targets,normalize",
                         [(0, 1, True), (7, 3, True), (3, 2, False)])
def test_synthetic_molecules_identical_to_jax(seed, num_targets, normalize):
    got = synthetic_molecules(40, seed=seed, num_targets=num_targets,
                              normalize=normalize)
    want = jax_synthetic(40, seed=seed, num_targets=num_targets,
                         normalize=normalize)
    assert got == want


@pytest.mark.parametrize("tie", [True, False])
def test_pack_sparse_batches_bit_identical_to_jax(tie):
    data = synthetic_molecules(120, seed=1)
    meta = infer_metadata([data], tie)
    jax_meta = jax_infer_metadata([data], tie)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jax_meta)
    t_dim = meta.num_edge_types
    proc = packing.preprocess_sparse(data, t_dim, tie, [0], {}, False)
    jax_proc = jax_packing.preprocess_sparse(data, t_dim, tie, [0], {},
                                             False)
    caps = packing.plan_capacities(proc, t_dim, 400)
    assert dataclasses.asdict(caps) == dataclasses.asdict(
        jax_packing.plan_capacities(jax_proc, t_dim, 400))
    got = list(packing.pack_sparse_batches(proc, t_dim, 400, caps, 16,
                                           meta.annotation_size, False,
                                           None))
    want = list(jax_packing.pack_sparse_batches(
        jax_proc, t_dim, 400, jax_packing.PackCapacities(
            **dataclasses.asdict(caps)), 16, meta.annotation_size, False,
        None))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert a.edge_sources_all is not None
        _assert_batches_identical(a, b)


def test_pack_sparse_batches_shuffled_training_identical_to_jax():
    data = synthetic_molecules(60, seed=2)
    proc = packing.preprocess_sparse(data, 4, True, [0], {"0": 0.5}, True,
                                     np.random.RandomState(3))
    jax_proc = jax_packing.preprocess_sparse(data, 4, True, [0], {"0": 0.5},
                                             True, np.random.RandomState(3))
    caps = packing.plan_capacities(proc, 4, 300)
    got = packing.pack_sparse_batches(proc, 4, 300, caps, 8, 5, True,
                                      np.random.RandomState(4))
    want = jax_packing.pack_sparse_batches(
        jax_proc, 4, 300, jax_packing.PackCapacities(
            **dataclasses.asdict(caps)), 8, 5, True,
        np.random.RandomState(4))
    for a, b in zip(got, want, strict=True):
        _assert_batches_identical(a, b)


@pytest.mark.parametrize("graph,message", [
    ({"graph": [[0, 5, 1]], "node_features": [[1], [0]]}, "edge type"),
    ({"graph": [[0, 1, 2]], "node_features": [[1], [0]]}, "vertex id"),
    ({"graph": [[-1, 1, 0]], "node_features": [[1], [0]]}, "vertex id"),
])
def test_preprocess_sparse_rejects_what_jax_rejects(graph, message):
    raw = [{**graph, "targets": [[0.0]]}]
    with pytest.raises(ValueError, match=message):
        jax_packing.preprocess_sparse(raw, 4, True, [0], {}, False)
    with pytest.raises(ValueError, match=message):
        packing.preprocess_sparse(raw, 4, True, [0], {}, False)


def _predictors(tie, max_nodes=64, max_graphs=16):
    """A JAX and a port Predictor over the same envelope; the JAX one on
    its numpy single-graph pack ("native_pack": false)."""
    t_dim = 4 if tie else 8
    config = {**default_params_for("sparse"), "hidden_size": 16,
              "tie_fwd_bkwd": tie, "native_pack": False}
    jax_config = {**jax_defaults("sparse"), "hidden_size": 16,
                  "tie_fwd_bkwd": tie, "native_pack": False}
    jax_model = JaxSparseGGNN(jax_config, t_dim)
    key = jax.random.PRNGKey(0)
    jax_state = {"params": {"graph": jax_model.init_params(key),
                            "heads": jax_init_heads(key, 16, [0])}}
    jax_pred = JaxPredictor("sparse", jax_config,
                            JaxDatasetMeta(max_nodes, t_dim, 16), jax_state,
                            max_nodes=max_nodes, max_graphs=max_graphs)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(SparseGGNN(config, t_dim, gen),
                         init_output_heads(gen, 16, [0]))
    port = Predictor("sparse", config, DatasetMeta(max_nodes, t_dim, 16),
                     params, max_nodes=max_nodes, max_graphs=max_graphs,
                     device="cpu")
    return jax_pred, port


@pytest.mark.parametrize("tie", [True, False])
def test_pack_single_sparse_bit_identical_to_jax(tie):
    jax_pred, port = _predictors(tie)
    assert port.caps == packing.PackCapacities(
        **dataclasses.asdict(jax_pred.caps))
    for g in synthetic_molecules(6, seed=5) + [
            {"graph": [], "node_features": [[0, 1, 0, 0, 0]]}]:
        got = port._pack_single_sparse(g, 5)
        _assert_batches_identical(got, jax_pred._pack_single_sparse(g, 5))
        # ... and the same batch as the multi-graph packer's for a
        # 1-graph request.
        if "targets" in g:
            _assert_batches_identical(got, next(iter(port._batches([g], 5))))


# ------------------------------------------------------------- dense


def _dense_processed(pkg, data, tie, is_training, rng_seed=None,
                     ratios=None, bucket_sizes=None):
    t_dim = 4 if tie else 8
    rng = None if rng_seed is None else np.random.RandomState(rng_seed)
    return pkg.preprocess_dense(data, t_dim, tie, [0], ratios or {},
                                is_training, rng, bucket_sizes=bucket_sizes)


@pytest.mark.parametrize("bucket_sizes", [None, [16, 32]])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("tie", [True, False])
def test_pack_dense_batches_bit_identical_to_jax(tie, drop_remainder,
                                                 bucket_sizes):
    data = synthetic_molecules(70, seed=8)
    sizes = None if bucket_sizes is None else np.asarray(bucket_sizes)
    bucketed, got_sizes = _dense_processed(packing, data, tie, False,
                                           bucket_sizes=sizes)
    jax_bucketed, want_sizes = _dense_processed(jax_packing, data, tie,
                                                False, bucket_sizes=sizes)
    np.testing.assert_array_equal(got_sizes, want_sizes)
    assert list(bucketed) == list(jax_bucketed)
    for b in bucketed:
        assert [g["graph_id"] for g in bucketed[b]] == \
            [g["graph_id"] for g in jax_bucketed[b]]
    got = list(packing.pack_dense_batches(bucketed, got_sizes, 8, 16, 5,
                                          False, None, drop_remainder))
    want = list(jax_packing.pack_dense_batches(
        jax_bucketed, want_sizes, 8, 16, 5, False, None, drop_remainder))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _assert_batches_identical(a, b)
    total = sum(int(b.num_graphs) for b in got)
    assert (total < 70) if drop_remainder else (total == 70)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_pack_dense_batches_shuffled_training_identical_to_jax(
        drop_remainder):
    """Per-bucket shuffles and the per-bucket task_sample_ratios quirk in
    preprocessing, the step and bucket shuffles of each epoch's pack, on
    copies: the caller's lists keep their order for the next epoch."""
    data = synthetic_molecules(60, seed=9)
    ratios = {"0": 0.5}
    bucketed, sizes = _dense_processed(packing, data, True, True, 3, ratios,
                                       np.asarray([16, 32]))
    jax_bucketed, _ = _dense_processed(jax_packing, data, True, True, 3,
                                       ratios, np.asarray([16, 32]))
    before = {b: [g["graph_id"] for g in gs] for b, gs in bucketed.items()}
    rng, jax_rng = np.random.RandomState(4), np.random.RandomState(4)
    for _epoch in range(2):
        got = packing.pack_dense_batches(bucketed, sizes, 8, 8, 5, True,
                                         rng, drop_remainder)
        want = jax_packing.pack_dense_batches(jax_bucketed, sizes, 8, 8, 5,
                                              True, jax_rng, drop_remainder)
        for a, b in zip(got, want, strict=True):
            _assert_batches_identical(a, b)
    assert {b: [g["graph_id"] for g in gs]
            for b, gs in bucketed.items()} == before
    labels = [g["labels"][0] for gs in bucketed.values() for g in gs]
    assert any(v is None for v in labels) and any(v is not None
                                                  for v in labels)


@pytest.mark.parametrize("graph,message", [
    ({"graph": [[0, 5, 1]], "node_features": [[1], [0]]}, "edge type"),
    ({"graph": [[0, 1, 2]], "node_features": [[1], [0]]}, "vertex id 2"),
    ({"graph": [[-1, 1, 0]], "node_features": [[1], [0]]}, "vertex id"),
    ({"graph": [], "node_features": [[1]] * 30}, "largest bucket"),
])
def test_preprocess_dense_rejects_what_jax_rejects(graph, message):
    raw = [{**graph, "targets": [[0.0]]}]
    for pkg in (jax_packing, packing):
        with pytest.raises(ValueError, match=message):
            pkg.preprocess_dense(raw, 4, True, [0], {}, False)


def test_empty_dense_split_packs_to_nothing():
    bucketed, sizes = packing.preprocess_dense([], 4, True, [0], {}, True)
    assert bucketed == {}
    assert list(packing.pack_dense_batches(bucketed, sizes, 8, 8, 5, True,
                                           np.random.RandomState(0))) == []


def _dense_predictors(variant, tie):
    t_dim = 4 if tie else 8
    overrides = {"hidden_size": 16, "batch_size": 8, "tie_fwd_bkwd": tie,
                 "native_pack": False}
    config = {**default_params_for(variant), **overrides}
    jax_config = {**jax_defaults(variant), **overrides}
    from ggnn_tpu.models.dense_ggnn import DenseGGNN as JaxDenseGGNN
    from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
    key = jax.random.PRNGKey(0)
    jax_state = {"params": {
        "graph": JaxDenseGGNN(jax_config, t_dim).init_params(key),
        "heads": jax_init_heads(key, 16, [0])}}
    jax_pred = JaxPredictor(variant, jax_config,
                            JaxDatasetMeta(64, t_dim, 16), jax_state)
    gen = torch.Generator().manual_seed(0)
    params = ModelParams(DenseGGNN(config, t_dim, gen),
                         init_output_heads(gen, 16, [0]))
    port = Predictor(variant, config, DatasetMeta(64, t_dim, 16), params,
                     device="cpu")
    return jax_pred, port


@pytest.mark.parametrize("variant,tie", [("dense", True), ("dense", False),
                                         ("blocked", True)])
def test_pack_single_dense_bit_identical_to_jax(variant, tie):
    """The 1-graph latency pack equals JAX's and the port's own corpus
    pack of a 1-graph request, leaf for leaf."""
    jax_pred, port = _dense_predictors(variant, tie)
    for g in synthetic_molecules(5, seed=6) + [
            {"graph": [], "node_features": [[0, 1, 0, 0, 0]]},
            {"graph": [[0, 1, 1]], "node_features": [[1, 0, 0, 0, 0]] * 3,
             "targets": [[0.25]]}]:
        got = port._pack_single_dense(g, 5)
        _assert_batches_identical(got, jax_pred._pack_single_dense(g, 5))
        if "targets" in g:
            order, batches = port._dense_batches([g], 5)
            assert order == [0]
            _assert_batches_identical(got, next(iter(batches)))
