"""Sums in a fixed order on every path of the port, on the CPU: no train
step adds with atomics outside the hand-written kernels, and each site
that did (the readout's pooling, the attention's type factors, the async
model's buffers) matches the JAX function it ports.

On the card `index_add_`, `scatter_add_`, `index_put_(accumulate=True)`
and the backward of `index_select` (an `index_add_`) add floats with
atomics, in an order that changes from call to call, so two runs part in
their last bits. The port sums by `torch.segment_reduce` over sorted ids
(`ops/segment.py`); the audit below records every aten op a training run
dispatches (the port's own kernel ops are one op each: their CPU plain
versions run inside them) and refuses those.

Tolerances: forward 1e-5, gradients 1e-4 (f32 sums in another order,
the kernel tests' bounds).
"""

import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ggnn_tpu.models import base as jax_base
from ggnn_tpu.ops import messages as jax_messages
from ggnn_tpu.ops.segment import segment_sum as jax_segment_sum
from ggnn_tpu_torch.data.loader import infer_metadata
from ggnn_tpu_torch.data.reorder import dfs_reorder
from ggnn_tpu_torch.data.synthetic import synthetic_molecules
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.models.sparse_ggnn import _lane_scores
from ggnn_tpu_torch.ops import messages
from ggnn_tpu_torch.ops.messages import EdgeLanes
from ggnn_tpu_torch.ops.segment import segment_sum, sorted_gather
from ggnn_tpu_torch.training.config import resolve_config
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
H = 8
ATOMIC = ("index_add", "index_add_", "scatter_add", "scatter_add_",
          "index_reduce", "index_reduce_", "embedding_dense_backward")
PUTS = ("index_put", "index_put_", "_index_put_impl", "_index_put_impl_",
        "put", "put_")


class AtomicAdds(TorchDispatchMode):
    """Counts the aten ops that add with atomics on the card."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        name = func.__name__.split(".")[0]
        if func.namespace == "aten":
            if name in ATOMIC:
                self.found[str(func)] += 1
            elif name in PUTS:
                accumulate = kwargs.get(
                    "accumulate", args[3] if len(args) > 3 else False)
                if accumulate:
                    self.found[str(func)] += 1
        return func(*args, **kwargs)


ROUTES = {"per-type": {"combined_edge_lanes": False},
          "per-edge": {"aggregate_first": False},
          "unsorted": {"edges_sorted_by_target": False}}
CASES = {
    "sparse": ("sparse", {}),
    "sparse_attention": ("sparse", {"use_propagation_attention": True,
                                    "use_edge_bias": True}),
    "rgcn": ("rgcn", {}),
    "gcn": ("gcn", {}),
    "async": ("async", {}),
    "async plain": ("async", {"async_compact": False}),
    "dense": ("dense", {}),
    "blocked": ("blocked", {}),
    "gcn_blocked": ("gcn_blocked", {}),
    "sparse_wide_bf16 attention": ("sparse", {
        "compute_dtype": "bfloat16", "use_propagation_attention": True}),
    **{f"sparse {route} attention": ("sparse", {
        **keys, "use_propagation_attention": True})
       for route, keys in ROUTES.items()},
}


def _config(variant, extra):
    cfg = {"hidden_size": H, "num_epochs": 1, "random_seed": 0,
           "edge_weight_dropout_keep_prob": 0.9}
    if variant in ("sparse", "rgcn", "gcn"):
        cfg["batch_size"] = 300
    if variant in ("dense", "blocked", "gcn_blocked"):
        cfg.update(batch_size=8, drop_remainder=False)
    if variant == "async":
        cfg.update(propagation_substeps=40, num_nodes=400)
    cfg.update(extra)
    return resolve_config(variant, config_json=json.dumps(cfg))


@pytest.mark.parametrize("label", sorted(CASES))
def test_training_adds_with_no_atomics(label, tmp_path):
    """A training epoch and its validation, forward, backward and update:
    no aten op of it adds with atomics."""
    variant, extra = CASES[label]
    runner = Runner(variant, _config(variant, extra),
                    train_data=synthetic_molecules(24, seed=0),
                    valid_data=synthetic_molecules(8, seed=1),
                    log_dir=str(tmp_path), quiet=True, device="cpu",
                    tensorboard=False)
    with AtomicAdds() as mode:
        runner.train()
    assert mode.ops > 100
    assert not mode.found, dict(mode.found)


# ----------------------------------------------------------- the sites

def _graph_ids(rng, n, g_cap, used, dump):
    ids = np.sort(rng.randint(0, used, size=n)).astype(np.int32)
    ids[n - dump:] = g_cap
    return ids


def test_readout_pooling_matches_jax_with_its_gradient():
    task_ids = [0, 3]
    heads = jax_base.init_output_heads(jax.random.PRNGKey(6), H, task_ids)
    port_heads = base.init_output_heads(torch.Generator().manual_seed(0), H,
                                        task_ids)
    flat = {}
    for task, layers in heads.items():
        for part, mlp in layers.items():
            for i, layer in enumerate(mlp):
                for name in ("W", "b"):
                    flat[f"{task}.{part}.{i}.{name}"] = np.asarray(
                        layer[name])
    port_heads.load_state_dict({k: torch.from_numpy(v.copy())
                                for k, v in flat.items()})
    rng = np.random.RandomState(8)
    n, g_cap = 29, 6
    last_h = rng.randn(n, H).astype(np.float32)
    init = rng.randn(n, H).astype(np.float32)
    ids = _graph_ids(rng, n, g_cap, 5, 4)
    g = rng.randn(len(task_ids), g_cap).astype(np.float32)

    def jax_fn(a, b):
        return jax_base.segment_readout(heads, task_ids, a, b,
                                        jnp.asarray(ids), g_cap)

    want = np.asarray(jax_fn(jnp.asarray(last_h), jnp.asarray(init)))
    want_a, want_b = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b) * g),
                              argnums=(0, 1))(jnp.asarray(last_h),
                                              jnp.asarray(init))
    a = torch.from_numpy(last_h).requires_grad_()
    b = torch.from_numpy(init).requires_grad_()
    got = base.segment_readout(port_heads, task_ids, a, b,
                               torch.from_numpy(ids), g_cap)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_a),
                               **GRAD_TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want_b),
                               **GRAD_TOL)


@pytest.mark.parametrize("ids_sorted", [True, False])
def test_segment_sum_matches_jax_with_its_gradient(ids_sorted):
    rng = np.random.RandomState(9)
    data = rng.randn(31, 3).astype(np.float32)
    ids = rng.randint(0, 7, size=31).astype(np.int32)
    if ids_sorted:
        ids = np.sort(ids)
    g = rng.randn(7, 3).astype(np.float32)
    want = jax_segment_sum(jnp.asarray(data), jnp.asarray(ids), 7)
    want_g = jax.grad(lambda d: jnp.sum(
        jax_segment_sum(d, jnp.asarray(ids), 7) * g))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    got = segment_sum(x, torch.from_numpy(ids), 7, ids_sorted)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               **GRAD_TOL)


def _lane_batch(seed=13):
    from ggnn_tpu.data import packing as jax_packing
    from ggnn_tpu.data.loader import infer_metadata as jax_meta
    from ggnn_tpu.data.synthetic import synthetic_molecules as jax_mols
    data = jax_mols(30, seed=seed)
    meta = jax_meta([data], True)
    t_dim = meta.num_edge_types
    proc = jax_packing.preprocess_sparse(data, t_dim, True, [0], {}, False)
    caps = jax_packing.plan_capacities(proc, t_dim, 300)
    batch = next(jax_packing.pack_sparse_batches(
        proc, t_dim, 300, caps, H, meta.annotation_size, False, None))
    return batch, t_dim


def test_attention_type_factors_match_jax_with_their_gradient():
    """The combined lane's attention weights: the type factors' gather,
    whose gradient now sums each type's edges in sorted order."""
    b, t_dim = _lane_batch()
    rng = np.random.RandomState(3)
    n = b.node_capacity
    h = rng.randn(n, H).astype(np.float32)
    factors = rng.uniform(0.5, 1.5, t_dim).astype(np.float32)
    g = rng.randn(b.edge_sources_all.shape[0]).astype(np.float32)
    lane = (b.edge_sources_all, b.edge_targets_all, b.edge_mask_all,
            b.edge_types_all)

    def jax_fn(hh, ff):
        return jax_messages.propagation_attention_weights_combined(
            hh, *lane, ff, n)

    want = np.asarray(jax_fn(jnp.asarray(h), jnp.asarray(factors)))
    want_h, want_f = jax.grad(lambda a, c: jnp.sum(jax_fn(a, c) * g),
                              argnums=(0, 1))(jnp.asarray(h),
                                              jnp.asarray(factors))
    th = torch.from_numpy(h).requires_grad_()
    tf = torch.from_numpy(factors).requires_grad_()
    got = messages.propagation_attention_weights_combined(
        th, torch.from_numpy(lane[0]), torch.from_numpy(lane[1]),
        torch.from_numpy(lane[2]), torch.from_numpy(lane[3]), tf, n)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_f),
                               **GRAD_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_h),
                               **GRAD_TOL)


def test_node_shard_lane_scores_match_jax_with_their_gradient():
    """A node shard's lane scores (`models/sparse_ggnn.py:_lane_scores`)
    against JAX's `_edge_scores` with the factors gathered per edge."""
    b, t_dim = _lane_batch(seed=14)
    rng = np.random.RandomState(4)
    n = b.node_capacity
    h = rng.randn(n, H).astype(np.float32)
    factors = rng.uniform(0.5, 1.5, t_dim).astype(np.float32)
    g = rng.randn(b.edge_sources_all.shape[0]).astype(np.float32)
    src, tgt, types = b.edge_sources_all, b.edge_targets_all, \
        b.edge_types_all

    def jax_fn(hh, ff):
        return jax_messages._edge_scores(hh, src, tgt, n, ff[types])

    real = tgt < n
    want = np.asarray(jax_fn(jnp.asarray(h), jnp.asarray(factors)))
    want_h, want_f = jax.grad(
        lambda a, c: jnp.sum(jnp.where(real, jax_fn(a, c), 0) * g),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(factors))
    th = torch.from_numpy(h).requires_grad_()
    tf = torch.from_numpy(factors).requires_grad_()
    lanes = EdgeLanes.combined(torch.from_numpy(src), torch.from_numpy(types),
                               torch.from_numpy(tgt), t_dim, n)
    got = _lane_scores(th, th, lanes, tf)
    np.testing.assert_allclose(got.detach().numpy()[real], want[real], **TOL)
    (got * torch.from_numpy(np.where(real, g, 0))).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_f),
                               **GRAD_TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_h),
                               **GRAD_TOL)


def test_async_buffer_gather_matches_jax_with_its_gradient():
    """The async model's buffer reads (`models/async_ggnn.py`): a gather
    of rows with repeats, as JAX's `buf[idx]`, the gradient summed per
    row in sorted order."""
    rng = np.random.RandomState(5)
    table = rng.randn(40, H).astype(np.float32)
    ids = rng.randint(0, 40, size=(300,)).astype(np.int32)
    g = rng.randn(300, H).astype(np.float32)
    want = np.asarray(jnp.asarray(table)[ids])
    want_g = jax.grad(lambda t: jnp.sum(t[ids] * g))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    got = sorted_gather(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want_g),
                               **GRAD_TOL)
    with torch.no_grad():
        assert torch.equal(sorted_gather(tt, torch.from_numpy(ids)),
                           got.detach())


# ------------------------------------------- the readout's sorted ids

def _is_pooled_sorted(ids, g_cap):
    ids = np.asarray(ids).reshape(-1)
    return bool((np.diff(ids) >= 0).all() and ids.max() <= g_cap)


@pytest.mark.parametrize("variant,native", [
    ("sparse", False), ("sparse", True), ("gcn", False), ("gcn", True),
    ("async", False)])
def test_packers_emit_sorted_graph_ids(variant, native):
    """`pool_nodes_to_graphs` passes indices_are_sorted: every packer
    emits the node graph ids ascending, the dump id last, also after
    `dfs_reorder`'s relabelling."""
    cfg = _config(variant, {"native_pack": native})
    data = synthetic_molecules(40, seed=2)
    for graphs in (data, [dfs_reorder(g) for g in data]):
        meta = infer_metadata([graphs], cfg["tie_fwd_bkwd"])
        adapter = make_adapter(variant, cfg, meta)
        processed = adapter.preprocess(graphs, True)
        adapter.plan(processed, processed)
        count = 0
        for batch in adapter.batches(processed, True,
                                     np.random.RandomState(0)):
            assert _is_pooled_sorted(batch.node_graph_ids,
                                     batch.graph_capacity)
            count += 1
        assert count > 0


def test_node_shards_emit_sorted_graph_ids():
    from ggnn_tpu_torch.parallel import node_shard
    cfg = _config("sparse", {"native_pack": False})
    data = synthetic_molecules(40, seed=3)
    meta = infer_metadata([data], True)
    adapter = make_adapter("sparse", cfg, meta)
    processed = adapter.preprocess(data, False)
    adapter.plan(processed, processed)
    batch = next(adapter.batches(processed, False))
    caps = node_shard.plan_node_shard_caps([batch], 2)
    sharded = node_shard.shard_batch(batch, caps)
    ids = np.asarray(sharded.node_graph_ids)
    assert ids.shape[0] == 2
    for row in ids:
        assert _is_pooled_sorted(row, batch.graph_capacity)
