"""The port's ops (ggnn_tpu_torch/ops, models/base.py) against the JAX
package's functions on the same numpy inputs and weights, at 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.loader import infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.models import base as jax_base
from ggnn_tpu.ops import cells as jax_cells
from ggnn_tpu.ops import messages as jax_messages
from ggnn_tpu.ops import mlp as jax_mlp
from ggnn_tpu.ops.segment import segment_sum as jax_segment_sum
from ggnn_tpu.training.checkpoint import _flatten_named
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.ops import cells, messages, mlp
from ggnn_tpu_torch.ops.segment import segment_sum
from ggnn_tpu_torch.training.checkpoint import params_from_jax_weights
from ggnn_tpu_torch.utils.init import glorot_init

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
H = 16


def _randomized(tree, seed):
    """The JAX parameter tree with every leaf redrawn from numpy (so the
    biases are not their constant initial values)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda leaf: (0.5 * rng.randn(*np.shape(leaf))).astype(np.float32),
        tree)


def _load(module, jax_tree, prefix=""):
    """Load a JAX parameter (sub)tree into a port module through the
    checkpoint bridge."""
    named = params_from_jax_weights(_flatten_named({"params": jax_tree}))
    state = {k[len(prefix):]: v for k, v in named.items()
             if k.startswith(prefix)}
    module.load_state_dict(state, strict=True)
    return module


CELL_CASES = [("GRU", "tanh"), ("GRU", "ReLU"),
              ("CudnnCompatibleGRUCell", "tanh"), ("RNN", "tanh"),
              ("RNN", "ReLU")]


@pytest.mark.parametrize("cell_type,activation", CELL_CASES)
@pytest.mark.parametrize("input_mult", [1, 3])
def test_cell_matches_jax(cell_type, activation, input_mult):
    d_in = input_mult * H   # residual concatenation widens the input
    jax_init, jax_apply = jax_cells.make_cell(cell_type, activation)
    params = _randomized(jax_init(jax.random.PRNGKey(0), d_in, H), seed=1)
    port = _load(cells.make_cell(cell_type, activation)(
        d_in, H, torch.Generator().manual_seed(0)), params)
    rng = np.random.RandomState(2)
    x = rng.randn(11, d_in).astype(np.float32)
    h = rng.randn(11, H).astype(np.float32)
    want = jax_apply(params, jnp.asarray(x), jnp.asarray(h))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cell_type,activation,message", [
    ("LSTM", "tanh", "Unknown RNN cell type"),
    ("GRU", "sigmoid", "Unknown activation"),
    ("CudnnCompatibleGRUCell", "ReLU", "requires tanh"),
])
def test_make_cell_validation_matches_jax(cell_type, activation, message):
    with pytest.raises(ValueError, match=message):
        jax_cells.make_cell(cell_type, activation)
    with pytest.raises(ValueError, match=message):
        cells.make_cell(cell_type, activation)


def test_cell_state_dropout_in_training_is_not_ported():
    """State dropout (now ported): in training the cell's new state goes
    through TF1 dropout, kept entries scaled by 1/keep; inference ignores
    it."""
    cell = cells.make_cell("GRU", "tanh", state_keep_prob=0.5)(
        H, H, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(64, H).astype(np.float32))
    h = torch.from_numpy(rng.randn(64, H).astype(np.float32))
    with torch.no_grad():
        plain = cell(x, h)
        got = cell(x, h, is_training=True,
                   generator=torch.Generator().manual_seed(1))
        again = cell(x, h, is_training=True,
                     generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(cell.step(x, h), plain, rtol=0, atol=0)
    kept = got != 0
    assert 0.4 < float(kept.float().mean()) < 0.6
    torch.testing.assert_close(got[kept], 2 * plain[kept], **TOL)
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="Generator"):
        cell(x, h, is_training=True)


@pytest.mark.parametrize("hid_sizes", [(), (8,), (8, 5)])
def test_mlp_apply_matches_jax(hid_sizes):
    params = _randomized(jax_mlp.mlp_init(jax.random.PRNGKey(3), 2 * H, 1,
                                          hid_sizes), seed=4)
    port = mlp.mlp_init(torch.Generator().manual_seed(0), 2 * H, 1,
                        hid_sizes)
    port.load_state_dict({
        f"{i}.{name}": torch.from_numpy(layer[name])
        for i, layer in enumerate(params) for name in ("W", "b")})
    x = np.random.RandomState(5).randn(9, 2 * H).astype(np.float32)
    want = jax_mlp.mlp_apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = mlp.mlp_apply(port, torch.from_numpy(x))
    # The last layer stays linear: negative outputs survive.
    assert (got < 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_readout_matches_jax():
    task_ids = [0, 3]
    heads = _randomized(jax_base.init_output_heads(jax.random.PRNGKey(6),
                                                   H, task_ids), seed=7)
    port_heads = base.init_output_heads(torch.Generator().manual_seed(0),
                                        H, task_ids)
    _load(port_heads, {"heads": heads}, prefix="heads.")
    rng = np.random.RandomState(8)
    n, g_cap = 23, 5
    last_h = rng.randn(n, H).astype(np.float32)
    init = rng.randn(n, H).astype(np.float32)
    # Graph slots 0..3 in use, the padded nodes at the dump slot g_cap.
    ids = np.sort(rng.randint(0, 4, size=n)).astype(np.int32)
    ids[-4:] = g_cap
    want = jax_base.segment_readout(heads, task_ids, jnp.asarray(last_h),
                                    jnp.asarray(init), jnp.asarray(ids),
                                    g_cap)
    with torch.no_grad():
        got = base.segment_readout(port_heads, task_ids,
                                   torch.from_numpy(last_h),
                                   torch.from_numpy(init),
                                   torch.from_numpy(ids), g_cap)
    assert got.shape == (2, g_cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_segment_sum_matches_jax():
    rng = np.random.RandomState(9)
    data = rng.randn(17, 3).astype(np.float32)
    ids = rng.randint(0, 6, size=17).astype(np.int32)
    want = jax_segment_sum(jnp.asarray(data), jnp.asarray(ids), 6)
    got = segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_average_by_in_degree_and_edge_bias_match_jax():
    rng = np.random.RandomState(10)
    incoming = rng.randn(13, H).astype(np.float32)
    in_degrees = rng.randint(0, 3, size=(13, 4)).astype(np.float32)
    in_degrees[:3] = 0.0          # nodes without incoming edges
    biases = rng.randn(4, H).astype(np.float32)
    np.testing.assert_allclose(
        messages.average_by_in_degree(torch.from_numpy(incoming),
                                      torch.from_numpy(in_degrees)).numpy(),
        np.asarray(jax_messages.average_by_in_degree(incoming, in_degrees)),
        **TOL)
    np.testing.assert_allclose(
        messages.edge_bias_term(torch.from_numpy(in_degrees),
                                torch.from_numpy(biases)).numpy(),
        np.asarray(jax_messages.edge_bias_term(in_degrees, biases)), **TOL)


def test_aggregate_then_transform_combined_matches_jax():
    data = synthetic_molecules(25, seed=11)
    meta = infer_metadata([data], True)
    t_dim = meta.num_edge_types
    proc = jax_packing.preprocess_sparse(data, t_dim, True, [0], {}, False)
    caps = jax_packing.plan_capacities(proc, t_dim, 150)
    b = next(jax_packing.pack_sparse_batches(proc, t_dim, 150, caps, H,
                                             meta.annotation_size, False,
                                             None))
    rng = np.random.RandomState(12)
    h = rng.randn(b.node_capacity, H).astype(np.float32)
    w = rng.randn(t_dim, H, H).astype(np.float32)
    want = jax_messages.aggregate_then_transform_combined(
        jnp.asarray(h), b.edge_sources_all, b.edge_types_all,
        b.edge_targets_all, jnp.asarray(w), b.node_capacity)
    lane = [torch.from_numpy(a) for a in (b.edge_sources_all,
                                          b.edge_types_all,
                                          b.edge_targets_all)]
    got = messages.aggregate_then_transform_combined(
        torch.from_numpy(h), *lane, torch.from_numpy(w), b.node_capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # With propagation attention (ported): the weights of the combined
    # lane and the attention-weighted aggregation.
    factors = rng.uniform(0.5, 1.5, t_dim).astype(np.float32)
    want_att = jax_messages.propagation_attention_weights_combined(
        jnp.asarray(h), b.edge_sources_all, b.edge_targets_all,
        b.edge_mask_all, b.edge_types_all, jnp.asarray(factors),
        b.node_capacity)
    want = jax_messages.aggregate_then_transform_combined(
        jnp.asarray(h), b.edge_sources_all, b.edge_types_all,
        b.edge_targets_all, jnp.asarray(w), b.node_capacity, want_att)
    att = messages.propagation_attention_weights_combined(
        torch.from_numpy(h), lane[0], lane[2],
        torch.from_numpy(b.edge_mask_all), lane[1],
        torch.from_numpy(factors), b.node_capacity)
    np.testing.assert_allclose(att.numpy(), np.asarray(want_att), **TOL)
    got = messages.aggregate_then_transform_combined(
        torch.from_numpy(h), *lane, torch.from_numpy(w), b.node_capacity,
        attention=att)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_glorot_init_limit_and_generator():
    gen = torch.Generator().manual_seed(0)
    w = glorot_init(gen, (3 * H, H))
    limit = math.sqrt(6.0 / (3 * H + H))
    assert w.dtype == torch.float32 and w.shape == (3 * H, H)
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.9 * limit
    torch.testing.assert_close(
        w, glorot_init(torch.Generator().manual_seed(0), (3 * H, H)))
