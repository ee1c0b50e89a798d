"""The aggregation's transpose (kernel B2) and the differentiable
aggregation (ggnn_tpu_torch/ops/kernels/ell_spmm.py) against the JAX
package, on the CPU.

On the CPU the wrappers run their plain PyTorch versions; these tests
hold them, the transpose layouts they share with the CUDA kernel, and
the autograd Function's gradients against JAX's Pallas kernels
(interpret mode), their jnp references and `jax.grad`. Tolerances:
1e-5 for the transpose itself (f32 sums in another order), rtol 1e-4 /
atol 1e-5 for gradients (the test_pallas.py VJP tolerance: a tanh and a
product between the sums). The kernel is held against its plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.ell import build_ell_layout as jax_build_ell_layout
from ggnn_tpu.data.ell import padded_node_count
from ggnn_tpu.data.loader import infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.ops import messages as jax_messages
from ggnn_tpu.ops.pallas import ell_aggregate_by_type as jax_ell_aggregate
from ggnn_tpu.ops.pallas import ell_scatter_sum as jax_ell_scatter_sum
from ggnn_tpu.ops.pallas import ell_scatter_sum_reference
from ggnn_tpu_torch.data.ell import build_ell_layout, plan_ell_k
from ggnn_tpu_torch.ops import messages
from ggnn_tpu_torch.ops.kernels import ell_spmm

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BN = 8  # ELL block, as in tests/test_pallas.py


def _random_ell_problem(seed, n_nodes=40, t_dim=3, n_edges=90, h_dim=16):
    """The random problem of tests/test_pallas.py:_random_problem, laid
    out by the port's own data/ell.py."""
    rng = np.random.RandomState(seed)
    np_total = padded_node_count(n_nodes, BN)
    src = rng.randint(0, n_nodes, size=(t_dim, n_edges)).astype(np.int32)
    tgt = rng.randint(0, n_nodes, size=(t_dim, n_edges)).astype(np.int32)
    mask = (rng.rand(t_dim, n_edges) < 0.8).astype(np.float32)
    h = rng.randn(np_total, h_dim).astype(np.float32)
    return h, (src, tgt, mask, n_nodes), np_total


def _packed_batch(n_graphs=30, seed=4, budget=200, hidden=16):
    data = synthetic_molecules(n_graphs, seed=seed)
    meta = infer_metadata([data], True)
    proc = jax_packing.preprocess_sparse(data, meta.num_edge_types, True,
                                         [0], {}, False)
    caps = jax_packing.plan_capacities(proc, meta.num_edge_types, budget)
    batch = next(jax_packing.pack_sparse_batches(
        proc, meta.num_edge_types, budget, caps, hidden,
        meta.annotation_size, False, None))
    return batch, meta.num_edge_types


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ell_layout_matches_jax(seed):
    _, (src, tgt, mask, n_nodes), _ = _random_ell_problem(seed)
    got = build_ell_layout(src, tgt, mask, n_nodes, BN)
    want = jax_build_ell_layout(src, tgt, mask, n_nodes, BN)
    for name in ("fwd_src", "fwd_tgt", "bwd_tgt", "bwd_src"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    assert got.ell_k == plan_ell_k(tgt, mask, BN, edge_sources=src)


@pytest.mark.parametrize("seed", [0, 11])
def test_ell_scatter_sum_matches_jax_pallas_and_reference(seed):
    _, (src, tgt, mask, n_nodes), np_total = _random_ell_problem(
        seed, n_nodes=32, t_dim=2, n_edges=60, h_dim=8)
    layout = build_ell_layout(src, tgt, mask, n_nodes, BN)
    g = np.random.RandomState(seed + 2).randn(2, np_total, 8).astype(
        np.float32)
    gat, oh = jnp.asarray(layout.bwd_tgt), jnp.asarray(layout.bwd_src)
    want = jax_ell_scatter_sum(jnp.asarray(g), gat, oh, BN, True)
    ref = ell_scatter_sum_reference(jnp.asarray(g), gat, oh, np_total)
    got = ell_spmm.ell_scatter_sum(torch.from_numpy(g),
                                   torch.from_numpy(layout.bwd_tgt),
                                   torch.from_numpy(layout.bwd_src))
    assert got.shape == (np_total, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    plain = ell_spmm.ell_scatter_sum_reference(
        torch.from_numpy(g), torch.from_numpy(layout.bwd_tgt),
        torch.from_numpy(layout.bwd_src))
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)


def test_segment_scatter_sum_on_combined_lane_matches_jax_transpose():
    """B2 over the combined lane's transpose layout is the VJP of the
    JAX combined aggregation's segment-sum: dh = sum of g[tgt*T + type]
    over each source's edges. The batch's pads (src 0, tgt N) must not
    reach node 0."""
    batch, t_dim = _packed_batch()
    n_cap = batch.node_capacity
    assert (batch.edge_mask_all == 0).any()        # the lane has pads
    g = np.random.RandomState(3).randn(n_cap * t_dim, 16).astype(np.float32)

    def per_fn(h):
        comp = batch.edge_targets_all * t_dim + batch.edge_types_all
        return jax.ops.segment_sum(
            h[batch.edge_sources_all], comp, (n_cap + 1) * t_dim,
            indices_are_sorted=True)[:n_cap * t_dim]

    _, vjp = jax.vjp(per_fn, jnp.zeros((n_cap, 16), jnp.float32))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    _, bgather, boff = messages.EdgeLanes.combined(
        *(torch.from_numpy(a) for a in (batch.edge_sources_all,
                                        batch.edge_types_all,
                                        batch.edge_targets_all)),
        t_dim, n_cap).segment_transpose
    assert bgather.dtype == boff.dtype == torch.int32
    assert boff.shape == (n_cap + 1,)
    assert int(boff[-1]) == int((batch.edge_mask_all > 0).sum())
    # The pads are keyed past the last source: B2 reads no id past boff[N].
    assert int(bgather[:int(boff[-1])].max()) < n_cap * t_dim
    got = ell_spmm.segment_scatter_sum(torch.from_numpy(g), bgather, boff,
                                       n_cap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        ell_spmm.segment_scatter_sum_reference(torch.from_numpy(g), bgather,
                                               boff, n_cap).numpy(),
        want, **TOL)


def test_segment_scatter_sum_matches_a_loop():
    rng = np.random.RandomState(6)
    n_nodes, rows, h_dim = 9, 20, 5
    counts = np.array([0, 3, 1, 0, 0, 5, 2, 0, 4])     # empty sources too
    bgather = rng.randint(0, rows, counts.sum()).astype(np.int32)
    boff = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    g = rng.randn(rows, h_dim).astype(np.float32)
    want = np.zeros((n_nodes, h_dim), np.float32)
    for n in range(n_nodes):
        for e in range(boff[n], boff[n + 1]):
            want[n] += g[bgather[e]]
    got = ell_spmm.segment_scatter_sum(torch.from_numpy(g),
                                       torch.from_numpy(bgather),
                                       torch.from_numpy(boff), n_nodes)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[counts == 0].any()


def test_ell_aggregate_gradient_matches_jax_grad():
    """The counterpart of test_pallas.py's VJP test: the port's
    differentiable ELL aggregation against jax.grad of the JAX one
    (interpret mode) under the same tanh-of-transform loss."""
    h, (src, tgt, mask, n_nodes), np_total = _random_ell_problem(
        7, n_nodes=24, t_dim=2, n_edges=40, h_dim=8)
    layout = build_ell_layout(src, tgt, mask, n_nodes, BN)
    w = np.random.RandomState(0).randn(2, 8, 8).astype(np.float32)
    fwd = (jnp.asarray(layout.fwd_src), jnp.asarray(layout.fwd_tgt))
    bwd = (jnp.asarray(layout.bwd_tgt), jnp.asarray(layout.bwd_src))

    def loss_jax(x):
        out = jax_ell_aggregate(x, fwd, bwd, BN, True)
        return jnp.sum(jnp.tanh(jnp.einsum("tnh,thd->nd", out, w)))

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(h)))
    x = torch.from_numpy(h).requires_grad_(True)
    out = ell_spmm.ell_aggregate_by_type(
        x, *(torch.from_numpy(a) for a in (layout.fwd_src, layout.fwd_tgt,
                                          layout.bwd_tgt, layout.bwd_src)))
    loss = torch.tanh(torch.einsum("tnh,thd->nd", out,
                                   torch.from_numpy(w))).sum()
    (got,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def test_ell_aggregate_needs_its_backward_layout_for_a_gradient():
    h, (src, tgt, mask, n_nodes), _ = _random_ell_problem(8)
    layout = build_ell_layout(src, tgt, mask, n_nodes, BN)
    fwd = (torch.from_numpy(layout.fwd_src), torch.from_numpy(layout.fwd_tgt))
    ell_spmm.ell_aggregate_by_type(torch.from_numpy(h), *fwd)   # no grad
    with pytest.raises(ValueError, match="backward layout"):
        ell_spmm.ell_aggregate_by_type(
            torch.from_numpy(h).requires_grad_(True), *fwd)


def _combined_inputs(batch):
    return [torch.from_numpy(a) for a in (batch.edge_sources_all,
                                          batch.edge_types_all,
                                          batch.edge_targets_all)]


@pytest.mark.parametrize("seed", [0, 1])
def test_combined_path_gradient_matches_jax_and_plain_autograd(seed):
    """The combined path's h- and W-gradients through the autograd
    Function (B1 forward, B2 backward) against jax.grad of the JAX
    combined path and against PyTorch's autograd of the plain version.
    The batch carries pads (src 0, tgt N): node 0's gradient pins that
    they are dropped from the transpose."""
    batch, t_dim = _packed_batch(seed=4 + seed)
    n_cap = batch.node_capacity
    rng = np.random.RandomState(seed)
    h = rng.randn(n_cap, 16).astype(np.float32)
    w = (0.3 * rng.randn(t_dim, 16, 16)).astype(np.float32)
    # Node 0 is a source of real edges, and pads point at it too.
    assert (batch.edge_sources_all[batch.edge_mask_all > 0] == 0).any()
    assert (batch.edge_mask_all == 0).any()

    def loss_jax(x, wt):
        out = jax_messages.aggregate_then_transform_combined(
            x, batch.edge_sources_all, batch.edge_types_all,
            batch.edge_targets_all, wt, n_cap)
        return jnp.sum(jnp.tanh(out))

    want_h, want_w = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(h),
                                                        jnp.asarray(w))
    src, typ, tgt = _combined_inputs(batch)
    lanes = messages.EdgeLanes.combined(src, typ, tgt, t_dim, n_cap)
    x = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = messages.aggregate_then_transform_combined(
        x, src, typ, tgt, wt, n_cap, lanes=lanes)
    got_h, got_w = torch.autograd.grad(torch.tanh(out).sum(), (x, wt))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               **GRAD_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               **GRAD_TOL)
    assert np.abs(got_h[0].numpy()).sum() > 0

    # The plain version is differentiable by PyTorch's own autograd.
    x2 = torch.from_numpy(h).requires_grad_(True)
    per = ell_spmm.gather_segment_sum_reference(x2, src, lanes.offsets,
                                                n_cap * t_dim)
    plain = torch.matmul(per.view(n_cap, -1), wt.detach().reshape(-1, 16))
    (plain_h,) = torch.autograd.grad(torch.tanh(plain).sum(), x2)
    np.testing.assert_allclose(got_h.numpy(), plain_h.numpy(), **GRAD_TOL)


def test_pads_left_in_the_transpose_would_corrupt_node_0():
    """What the pad drop protects: the lane's pads point at node 0 with
    composite ids past the end of g. Left in (the ids clamped into range
    so the plain version can read them), they change node 0's gradient
    and no other."""
    batch, t_dim = _packed_batch()
    n_cap = batch.node_capacity
    src, typ, tgt = _combined_inputs(batch)
    g = torch.from_numpy(np.random.RandomState(9).randn(
        n_cap * t_dim, 16).astype(np.float32))
    _, bgather, boff = messages.EdgeLanes.combined(
        src, typ, tgt, t_dim, n_cap).segment_transpose
    good = ell_spmm.segment_scatter_sum(g, bgather, boff, n_cap)
    composite = torch.clamp(tgt.long() * t_dim + typ.long(),
                            max=n_cap * t_dim - 1)
    bad = ell_spmm.segment_scatter_sum(
        g, *ell_spmm.transpose_layout(src.long(), composite, n_cap), n_cap)
    assert not torch.allclose(bad[0], good[0])
    torch.testing.assert_close(bad[1:], good[1:], rtol=0, atol=0)


def test_backward_skips_b2_when_h_needs_no_gradient(monkeypatch):
    """Only the weights need a gradient: the Function's backward must not
    run B2 (layer 0, step 0 of the model aggregates node features)."""
    calls = []
    real = ell_spmm.segment_scatter_sum
    monkeypatch.setattr(ell_spmm, "segment_scatter_sum",
                        lambda *a: calls.append(1) or real(*a))
    batch, t_dim = _packed_batch()
    n_cap = batch.node_capacity
    src, typ, tgt = _combined_inputs(batch)
    lanes = messages.EdgeLanes.combined(src, typ, tgt, t_dim, n_cap)
    wt = torch.randn(t_dim, 16, 16, requires_grad=True)
    h = torch.randn(n_cap, 16)
    out = messages.aggregate_then_transform_combined(
        h, src, typ, tgt, wt, n_cap, lanes=lanes)
    out.sum().backward()
    assert calls == [] and wt.grad is not None
    h.requires_grad_(True)
    out = messages.aggregate_then_transform_combined(
        h, src, typ, tgt, wt, n_cap, lanes=lanes)
    out.sum().backward()
    assert calls == [1]


def test_backward_without_transpose_layout_raises():
    batch, t_dim = _packed_batch()
    n_cap = batch.node_capacity
    src, typ, tgt = _combined_inputs(batch)
    h = torch.randn(n_cap, 16, requires_grad=True)
    # The message functions build their own transpose when h needs one;
    # the Function given none raises on the backward.
    lanes = messages.EdgeLanes.combined(src, typ, tgt, t_dim, n_cap)
    out = ell_spmm.GatherSegmentSum.apply(h, src, lanes.offsets,
                                          n_cap * t_dim, None, None)
    with pytest.raises(RuntimeError, match="transpose layout"):
        out.sum().backward()


@pytest.mark.parametrize("bad", ["g_dtype", "bgather_dtype", "boff_len"])
def test_segment_scatter_sum_rejects_bad_inputs(bad):
    g = torch.randn(6, 4)
    bgather = torch.tensor([0, 5, 2], dtype=torch.int32)
    boff = torch.tensor([0, 1, 3], dtype=torch.int32)
    num_nodes = 2
    if bad == "g_dtype":
        g = g.to(torch.float64)
    elif bad == "bgather_dtype":
        bgather = bgather.long()
    else:
        num_nodes = 3
    with pytest.raises((TypeError, ValueError)):
        ell_spmm.segment_scatter_sum(g, bgather, boff, num_nodes)
