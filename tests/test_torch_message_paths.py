"""The sparse GGNN's message paths in the port (ops/messages.py and the
routing of models/sparse_ggnn.py) against the JAX package on the CPU:
the per-type and per-edge functions with and without propagation
attention, every route of `SparseGGNN` x attention with bridged weights,
and the port's own combined-vs-per-type agreement.

Tolerances: 1e-5 for a function's forward, rtol 1e-4 / atol 1e-5 for its
gradients; 2e-5 for a model forward (the TF1 golden bound) and rtol
1e-4 / atol 1e-5 for the model's parameter gradients (f32 sums in
another order over the GRU steps).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.loader import infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models.sparse_ggnn import SparseGGNN as JaxSparseGGNN
from ggnn_tpu.ops import messages as jax_messages
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu.training.config import resolve_config as jax_resolve_config
from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN
from ggnn_tpu_torch.ops import messages
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.training.config import resolve_config

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=2e-5, atol=2e-5)
H = 16


def _batch(seed=13, n_graphs=30, budget=300, lane=True):
    data = synthetic_molecules(n_graphs, seed=seed)
    meta = infer_metadata([data], True)
    t_dim = meta.num_edge_types
    proc = jax_packing.preprocess_sparse(data, t_dim, True, [0], {}, False)
    caps = jax_packing.plan_capacities(proc, t_dim, budget)
    if not lane:
        caps = dataclasses.replace(caps, edges_all=0)
    batch = next(jax_packing.pack_sparse_batches(
        proc, t_dim, budget, caps, H, meta.annotation_size, False, None))
    return batch, t_dim


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(batch, t_dim, seed=3):
    rng = np.random.RandomState(seed)
    n = batch.node_capacity
    return (rng.randn(n, H).astype(np.float32),
            (0.3 * rng.randn(t_dim, H, H)).astype(np.float32),
            rng.uniform(0.5, 1.5, t_dim).astype(np.float32))


def _permuted_lanes(batch, seed=0):
    """The batch with each type's lane (pads included) permuted by a
    seeded permutation: no longer target-sorted."""
    rng = np.random.RandomState(seed)
    perms = np.stack([rng.permutation(batch.edge_sources.shape[1])
                      for _ in range(batch.edge_sources.shape[0])])
    return dataclasses.replace(batch, **{
        name: np.take_along_axis(getattr(batch, name), perms, axis=1)
        for name in ("edge_sources", "edge_targets", "edge_mask")})


def test_edge_scores_match_jax_on_real_edges():
    batch, t_dim = _batch()
    h, _, factors = _inputs(batch, t_dim)
    n = batch.node_capacity
    want = np.asarray(jax_messages._edge_scores(
        jnp.asarray(h), batch.edge_sources, batch.edge_targets, n,
        jnp.asarray(factors)[:, None]))
    got = messages._edge_scores(_t(h), _t(batch.edge_sources),
                                _t(batch.edge_targets), n,
                                _t(factors)[:, None]).numpy()
    real = batch.edge_targets < n
    np.testing.assert_allclose(got[real], want[real], **TOL)
    assert (got[~real] == 0).all()         # pads: 0, JAX's clamped dot


@pytest.mark.parametrize("lanes", ["sorted", "permuted"])
def test_propagation_attention_weights_match_jax(lanes):
    batch, t_dim = _batch(seed=14)
    if lanes == "permuted":
        batch = _permuted_lanes(batch, seed=1)
    h, _, factors = _inputs(batch, t_dim, seed=4)
    n = batch.node_capacity
    g = np.random.RandomState(5).randn(*batch.edge_sources.shape).astype(
        np.float32)
    lane = (batch.edge_sources, batch.edge_targets, batch.edge_mask)

    def jax_fn(hh, ff):
        return jax_messages.propagation_attention_weights(hh, *lane, ff, n)

    want = np.asarray(jax_fn(jnp.asarray(h), jnp.asarray(factors)))
    want_h, want_f = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b) * g),
                              argnums=(0, 1))(jnp.asarray(h),
                                              jnp.asarray(factors))
    ht, ft = _t(h).requires_grad_(True), _t(factors).requires_grad_(True)
    got = messages.propagation_attention_weights(
        ht, *(_t(a) for a in lane), ft, n)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    got_h, got_f = torch.autograd.grad((got * _t(g)).sum(), (ht, ft))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **GRAD_TOL)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **GRAD_TOL)
    # Over an edge axis (ROADMAP A11, type-TP) the softmax's max and sums
    # run over the axis; over an axis of one rank they are this rank's.
    from ggnn_tpu_torch.parallel.mesh import Axis
    one = messages.propagation_attention_weights(
        _t(h), *(_t(a) for a in lane), _t(factors), n,
        edge_axis=Axis("edge", 1, 0, (0,)))
    assert torch.equal(one, got.detach())


@pytest.mark.parametrize("lanes", ["sorted", "permuted"])
@pytest.mark.parametrize("attention", [False, True])
def test_aggregate_then_transform_matches_jax(attention, lanes):
    """The per-type aggregate-first step, forward and the gradients in h,
    W and the attention weights; permuted lanes take targets_sorted
    False."""
    batch, t_dim = _batch(seed=15)
    if lanes == "permuted":
        batch = _permuted_lanes(batch, seed=2)
    h, w, _ = _inputs(batch, t_dim, seed=6)
    n = batch.node_capacity
    rng = np.random.RandomState(7)
    att = (rng.rand(*batch.edge_sources.shape).astype(np.float32)
           * batch.edge_mask)
    g = rng.randn(n, H).astype(np.float32)
    sorted_ = lanes == "sorted"

    def jax_fn(hh, ww, aa):
        return jax_messages.aggregate_then_transform(
            hh, batch.edge_sources, batch.edge_targets, ww, n,
            aa if attention else None, targets_sorted=sorted_)

    args = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(att))
    want = np.asarray(jax_fn(*args))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * g),
                          argnums=(0, 1, 2))(*args)
    ht, wt, at = (_t(a).requires_grad_(True) for a in (h, w, att))
    got = messages.aggregate_then_transform(
        ht, _t(batch.edge_sources), _t(batch.edge_targets), wt, n,
        at if attention else None, targets_sorted=sorted_)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    leaves = (ht, wt, at) if attention else (ht, wt)
    got_grads = torch.autograd.grad((got * _t(g)).sum(), leaves)
    for got_g, want_g in zip(got_grads, want_grads):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   **GRAD_TOL)


@pytest.mark.parametrize("with_lanes", [False, True])
@pytest.mark.parametrize("attention", [False, True])
def test_per_edge_messages_match_jax(attention, with_lanes):
    """typed_edge_messages (B3 gather, bmm), propagation_attention and
    aggregate_messages (B1 over the targets in stable order), forward
    and the gradients in h, W and the factors; with the forward's
    EdgeLanes the gather's gradient skips the pads."""
    batch, t_dim = _batch(seed=16)
    h, w, factors = _inputs(batch, t_dim, seed=8)
    n = batch.node_capacity
    g = np.random.RandomState(9).randn(n, H).astype(np.float32)
    lane = (batch.edge_sources, batch.edge_targets, batch.edge_mask)

    def jax_fn(hh, ww, ff):
        msgs = jax_messages.typed_edge_messages(hh, batch.edge_sources, ww)
        if attention:
            msgs = jax_messages.propagation_attention(msgs, hh, *lane, ff, n)
        return jax_messages.aggregate_messages(msgs, batch.edge_targets, n)

    args = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(factors))
    want = np.asarray(jax_fn(*args))
    want_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * g),
                          argnums=(0, 1, 2))(*args)
    ht, wt, ft = (_t(a).requires_grad_(True) for a in (h, w, factors))
    src, tgt, mask = (_t(a) for a in lane)
    lanes = messages.EdgeLanes.typed(src, tgt, n) if with_lanes else None
    msgs = messages.typed_edge_messages(ht, src, wt, lanes)
    if attention:
        msgs = messages.propagation_attention(msgs, ht, src, tgt, mask, ft,
                                              n, lanes=lanes)
    got = messages.aggregate_messages(msgs, tgt, n, lanes)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    leaves = (ht, wt, ft) if attention else (ht, wt)
    got_grads = torch.autograd.grad((got * _t(g)).sum(), leaves)
    for got_g, want_g in zip(got_grads, want_grads):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   **GRAD_TOL)


# Each route of SparseGGNN.forward: the config and how the batch is made.
ROUTES = {
    "combined": ({}, {}),
    "per-type": ({"combined_edge_lanes": False}, {}),
    "no lane": ({}, {"lane": False}),
    "per-edge": ({"aggregate_first": False}, {}),
    "unsorted": ({"edges_sorted_by_target": False}, {"permuted": True}),
}


def _bridged(jax_params):
    return {k[len("graph."):]: v for k, v in params_from_jax_weights(
        _flatten_named({"params": {"graph": jax_params}})).items()}


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sparse_ggnn_route_matches_jax(route, attention):
    extra, how = ROUTES[route]
    overrides = {"hidden_size": H, "layer_timesteps": [2, 1, 1],
                 "residual_connections": {"2": [0]}, "use_edge_bias": True,
                 "use_propagation_attention": attention, **extra}
    jax_config = jax_resolve_config("sparse",
                                    config_json=json.dumps(overrides))
    config = resolve_config("sparse", config_json=json.dumps(overrides))
    assert config == jax_config
    batch, t_dim = _batch(seed=17, lane=how.get("lane", True))
    assert (batch.edge_sources_all is None) == (route == "no lane")
    if how.get("permuted"):
        batch = _permuted_lanes(batch, seed=3)
        assert (np.diff(batch.edge_targets, axis=1) < 0).any()
    jax_model = JaxSparseGGNN(jax_config, t_dim)
    params = jax_model.init_params(jax.random.PRNGKey(1))
    rng = np.random.RandomState(2)
    for layer in params["layers"]:
        layer["edge_biases"] = rng.randn(t_dim, H).astype(np.float32)
        if attention:
            layer["attention"] = rng.uniform(0.5, 1.5, t_dim).astype(
                np.float32)
    model = SparseGGNN(config, t_dim, torch.Generator().manual_seed(0))
    model.load_state_dict(_bridged(params), strict=True)
    port_batch = GraphBatch(**{f.name: getattr(batch, f.name)
                               for f in dataclasses.fields(GraphBatch)}
                            ).to("cpu")

    want = np.asarray(jax_model.forward(params, batch))
    want_grads = _bridged(jax.grad(
        lambda p: jnp.sum(jnp.tanh(jax_model.forward(p, batch))))(params))
    out = model(port_batch)
    np.testing.assert_allclose(out.detach().numpy(), want, **MODEL_TOL)
    torch.tanh(out).sum().backward()
    names = dict(model.named_parameters())
    assert sorted(names) == sorted(want_grads)
    assert any(n.endswith("attention") for n in names) == attention
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("attention", [False, True])
def test_combined_lane_matches_typed_lanes(attention):
    """The port's own agreement of the combined lane with the per-type
    lanes (a pure re-layout), forward and gradients, as
    tests/test_models.py holds the JAX model's."""
    config = resolve_config("sparse", config_json=json.dumps({
        "hidden_size": H, "use_propagation_attention": attention,
        "use_edge_bias": True}))
    batch, t_dim = _batch(seed=18, n_graphs=40)
    port_batch = GraphBatch(**{f.name: getattr(batch, f.name)
                               for f in dataclasses.fields(GraphBatch)}
                            ).to("cpu")
    comb = SparseGGNN(dict(config, combined_edge_lanes=True), t_dim,
                      torch.Generator().manual_seed(5))
    typed = SparseGGNN(dict(config, combined_edge_lanes=False), t_dim,
                       torch.Generator().manual_seed(6))
    typed.load_state_dict(comb.state_dict())
    outs = []
    for model in (comb, typed):
        out = model(port_batch)
        (out ** 2).sum().backward()
        outs.append(out.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    for (name, a), b in zip(comb.named_parameters(), typed.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-6,
                                   msg=name)
