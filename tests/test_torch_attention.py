"""Propagation attention's pieces in the port against the JAX package on
the CPU: the segment softmax (ops/segment.py), the per-edge dot product
`EdgeDot` (ops/attention.py), the attention-weighted aggregation
`AttentionGatherSegmentSum` and the per-edge row gather `GatherRows`,
each on its plain path, forward and gradient.

On the CPU the wrappers run their plain PyTorch versions; the kernels
are held against those on the card by tests/test_torch_cuda.py and
chip_smoke.py. Tolerances: 1e-5 forward (f32 sums in another order),
rtol 1e-4 / atol 1e-5 for gradients, the bounds the kernel tests of the
JAX package pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.loader import infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.ops import segment as jax_segment
from ggnn_tpu_torch.ops import attention, messages, segment
from ggnn_tpu_torch.ops.kernels import edge_dot, ell_spmm, gather_floor

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
EPS = 1e-7


def _softmax_problem(scores_kind, seed=0, n=12, e=70):
    """(scores, ids, mask, N): e edges into n nodes plus the dump slot n.
    Node 3 has no in-edge; every in-edge of node 5 is masked; the pads
    (masked) point at n."""
    rng = np.random.RandomState(seed)
    ids = rng.choice([i for i in range(n) if i != 3], e).astype(np.int32)
    ids[-8:] = n
    mask = (rng.rand(e) < 0.8).astype(np.float32)
    mask[ids == 5] = 0.0
    mask[ids == n] = 0.0
    if scores_kind == "equal":
        scores = np.full(e, 0.7, np.float32)
    elif scores_kind == "large":
        scores = (80.0 * rng.randn(e)).astype(np.float32)
    else:
        scores = rng.randn(e).astype(np.float32)
    return scores, ids, mask, n


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("scores_kind", ["random", "equal", "large"])
def test_segment_softmax_matches_jax_forward_and_grad(scores_kind, sort):
    scores, ids, mask, n = _softmax_problem(scores_kind)
    if sort:
        order = np.argsort(ids, kind="stable")
        scores, ids, mask = scores[order], ids[order], mask[order]
    g = np.random.RandomState(1).randn(len(ids)).astype(np.float32)

    def jax_fn(s):
        return jax_segment.segment_softmax(s, jnp.asarray(ids), n + 1,
                                           jnp.asarray(mask), EPS,
                                           indices_are_sorted=sort)

    want = np.asarray(jax_fn(jnp.asarray(scores)))
    want_grad = np.asarray(jax.grad(
        lambda s: jnp.sum(jax_fn(s) * g))(jnp.asarray(scores)))
    x = torch.from_numpy(scores).requires_grad_(True)
    got = segment.segment_softmax(x, torch.from_numpy(ids), n + 1,
                                  torch.from_numpy(mask), EPS,
                                  indices_are_sorted=sort)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(g)).sum(), x)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, **GRAD_TOL)
    # Masked lanes (node 5's, the pads) get weight 0 and no gradient; a
    # target's real weights sum to 1 up to the epsilon.
    assert (got.detach().numpy()[mask == 0] == 0).all()
    assert (got_grad.numpy()[mask == 0] == 0).all()
    sums = np.zeros(n + 1)
    np.add.at(sums, ids, got.detach().numpy())
    real = np.unique(ids[mask > 0])
    np.testing.assert_allclose(sums[real], 1.0, rtol=1e-5)


def test_segment_softmax_layout_is_reused_and_checked():
    scores, ids, mask, n = _softmax_problem("random", seed=2)
    layout = segment.sorted_segments(torch.from_numpy(ids), n + 1)
    args = (torch.from_numpy(scores), torch.from_numpy(ids), n + 1,
            torch.from_numpy(mask), EPS)
    torch.testing.assert_close(segment.segment_softmax(*args, layout=layout),
                               segment.segment_softmax(*args), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="segments"):
        segment.segment_softmax(torch.from_numpy(scores),
                                torch.from_numpy(ids), n,
                                torch.from_numpy(mask), EPS, layout=layout)


@pytest.mark.parametrize("sort", [True, False])
def test_segment_max_and_sorted_sum_match_jax(sort):
    scores, ids, _, n = _softmax_problem("random", seed=3)
    if sort:
        order = np.argsort(ids, kind="stable")
        scores, ids = scores[order], ids[order]
    want_max = np.asarray(jax_segment.segment_max(
        jnp.asarray(scores), jnp.asarray(ids), n + 2))
    got_max = segment.segment_max(torch.from_numpy(scores),
                                  torch.from_numpy(ids), n + 2)
    np.testing.assert_array_equal(got_max.numpy(), want_max)   # -inf too
    want_sum = np.asarray(jax_segment.segment_sum(
        jnp.asarray(scores), jnp.asarray(ids), n + 2))
    got_sum = segment.sorted_segment_sum(
        torch.from_numpy(scores),
        segment.sorted_segments(torch.from_numpy(ids), n + 2, sort))
    np.testing.assert_allclose(got_sum.numpy(), want_sum, **TOL)


def _packed_batch(seed=4, budget=200, n_graphs=30):
    data = synthetic_molecules(n_graphs, seed=seed)
    meta = infer_metadata([data], True)
    proc = jax_packing.preprocess_sparse(data, meta.num_edge_types, True,
                                         [0], {}, False)
    caps = jax_packing.plan_capacities(proc, meta.num_edge_types, budget)
    batch = next(jax_packing.pack_sparse_batches(
        proc, meta.num_edge_types, budget, caps, 16, meta.annotation_size,
        False, None))
    return batch, meta.num_edge_types


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("tables", ["same table", "two tables"])
def test_edge_dot_matches_jax_forward_and_grad(tables):
    """EdgeDot on the combined lane's (src, tgt) pairs, forward and both
    gradients, against JAX autodiff of the gathered dot product; the
    pads (tgt = N) give 0."""
    batch, _ = _packed_batch()
    n = batch.node_capacity
    rng = np.random.RandomState(5)
    x = rng.randn(n, 16).astype(np.float32)
    y = x if tables == "same table" else rng.randn(n, 16).astype(np.float32)
    src, tgt = batch.edge_sources_all, batch.edge_targets_all
    real = tgt < n
    g = rng.randn(len(src)).astype(np.float32)

    def jax_dots(xa, yb):
        dots = jnp.sum(xa[src] * yb[np.minimum(tgt, n - 1)], axis=-1)
        return jnp.where(jnp.asarray(real), dots, 0.0)

    want = np.asarray(jax_dots(jnp.asarray(x), jnp.asarray(y)))
    lanes = messages.EdgeLanes(_t(src), _t(tgt), n, targets_sorted=True)
    xt = _t(x).requires_grad_(True)
    yt = xt if tables == "same table" else _t(y).requires_grad_(True)
    got = attention.EdgeDot.apply(xt, lanes.src, yt, lanes.tgt,
                                 lanes.source_pairs, lanes.target_pairs)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert (got.detach().numpy()[~real] == 0).all()
    np.testing.assert_allclose(
        edge_dot.edge_dot_reference(_t(x), lanes.src, _t(y),
                                    lanes.tgt).numpy(), want, **TOL)
    if tables == "same table":
        want_x = np.asarray(jax.grad(lambda a: jnp.sum(jax_dots(a, a) * g))(
            jnp.asarray(x)))
        (got_x,) = torch.autograd.grad((got * _t(g)).sum(), xt)
        np.testing.assert_allclose(got_x.numpy(), want_x, **GRAD_TOL)
    else:
        want_x, want_y = jax.grad(
            lambda a, b: jnp.sum(jax_dots(a, b) * g), argnums=(0, 1))(
                jnp.asarray(x), jnp.asarray(y))
        got_x, got_y = torch.autograd.grad((got * _t(g)).sum(), (xt, yt))
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   **GRAD_TOL)


def test_edge_dot_without_sorted_pairs_raises_on_backward():
    x = torch.randn(5, 4, requires_grad=True)
    ids = torch.tensor([0, 1, 4], dtype=torch.int32)
    out = attention.EdgeDot.apply(x, ids, x, ids, None, None)
    with pytest.raises(RuntimeError, match="sorted by"):
        out.sum().backward()


@pytest.mark.parametrize("bad", ["x_dtype", "ids_dtype", "widths",
                                 "lengths", "non_contiguous"])
def test_edge_dot_rejects_bad_inputs(bad):
    x, y = torch.randn(6, 4), torch.randn(5, 4)
    a = torch.tensor([0, 5, 2], dtype=torch.int32)
    b = torch.tensor([1, 4, 5], dtype=torch.int32)
    if bad == "x_dtype":
        x = x.double()
    elif bad == "ids_dtype":
        b = b.long()
    elif bad == "widths":
        y = torch.randn(5, 3)
    elif bad == "lengths":
        b = b[:2].contiguous()
    else:
        x = torch.randn(4, 6).t()
    with pytest.raises((TypeError, ValueError)):
        edge_dot.edge_dot(x, a, y, b)


def test_edge_dot_counts_no_launch_on_the_cpu():
    before = edge_dot.launches
    x = torch.randn(6, 4)
    ids = torch.tensor([0, 5, 2], dtype=torch.int32)
    out = edge_dot.edge_dot(x, ids, x, ids)
    torch.testing.assert_close(out, (x[ids.long()] ** 2).sum(-1))
    assert edge_dot.launches == before


@pytest.mark.parametrize("lane", ["combined", "per-type"])
def test_attention_gather_segment_sum_matches_jax(lane):
    """The attention-weighted aggregation out[s] = sum w[e] h[src[e]] over
    the combined lane (segments target*T + type, pads past them) or the
    flattened per-type lanes (segments t*(N+1) + target, pads in the
    dump segments), forward and the gradients in h and w, against JAX
    autodiff of the gather, scale and segment_sum."""
    batch, t_dim = _packed_batch(seed=6)
    n = batch.node_capacity
    rng = np.random.RandomState(7)
    h = rng.randn(n, 16).astype(np.float32)
    if lane == "combined":
        src, tgt = batch.edge_sources_all, batch.edge_targets_all
        seg = tgt * t_dim + batch.edge_types_all
        num_segments, kept = n * t_dim, n * t_dim
        lanes = messages.EdgeLanes.combined(
            _t(src), _t(batch.edge_types_all), _t(tgt), t_dim, n)
    else:
        src = batch.edge_sources.reshape(-1)
        tgt = batch.edge_targets.reshape(-1)
        seg = (np.arange(t_dim)[:, None] * (n + 1)
               + batch.edge_targets).reshape(-1)
        num_segments, kept = t_dim * (n + 1), t_dim * (n + 1)
        lanes = messages.EdgeLanes.typed(_t(batch.edge_sources),
                                         _t(batch.edge_targets), n)
    w = rng.rand(len(src)).astype(np.float32)
    w[tgt == n] = 0.0                      # pads: the softmax's zeros
    g = rng.randn(num_segments, 16).astype(np.float32)
    if lane == "per-type":   # the caller drops the dump rows
        g.reshape(t_dim, n + 1, 16)[:, n] = 0.0

    def jax_fn(hh, ww):
        return jax.ops.segment_sum(hh[src] * ww[:, None], jnp.asarray(seg),
                                   num_segments + t_dim + 1,
                                   indices_are_sorted=True)[:kept]

    want = np.asarray(jax_fn(jnp.asarray(h), jnp.asarray(w)))
    want_h, want_w = jax.grad(lambda a, b: jnp.sum(jax_fn(a, b) * g),
                              argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht = _t(h).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    got = attention.AttentionGatherSegmentSum.apply(
        ht, lanes.src, wt, lanes.offsets, num_segments, lanes.segments,
        lanes.segment_transpose)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    got_h, got_w = torch.autograd.grad((got * _t(g)).sum(), (ht, wt))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **GRAD_TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **GRAD_TOL)


def test_attention_gather_needs_the_transpose_for_h_only():
    batch, t_dim = _packed_batch(seed=8)
    n = batch.node_capacity
    lanes = messages.EdgeLanes.combined(
        _t(batch.edge_sources_all), _t(batch.edge_types_all),
        _t(batch.edge_targets_all), t_dim, n)
    w = torch.rand(lanes.src.shape[0], requires_grad=True)
    h = torch.randn(n, 16)
    out = attention.AttentionGatherSegmentSum.apply(
        h, lanes.src, w, lanes.offsets, n * t_dim, lanes.segments, None)
    out.sum().backward()                   # dw only: no transpose needed
    assert w.grad is not None and torch.isfinite(w.grad).all()
    h.requires_grad_(True)
    out = attention.AttentionGatherSegmentSum.apply(
        h, lanes.src, w, lanes.offsets, n * t_dim, lanes.segments, None)
    with pytest.raises(RuntimeError, match="sorted by source"):
        out.sum().backward()


@pytest.mark.parametrize("ke,unroll", [(16, 8), (12, 4), (7, 1)])
def test_gather_rows_matches_jax_forward_and_grad(ke, unroll):
    """GatherRows (B3 forward at the widest unroll dividing KE, B2 over
    the source-sorted transpose backward) against JAX autodiff of
    h[src]."""
    assert gather_floor.widest_unroll(ke) == unroll
    rng = np.random.RandomState(ke)
    n, t_dim = 20, 3
    h = rng.randn(n, 16).astype(np.float32)
    src = rng.randint(0, n, (t_dim, ke)).astype(np.int32)
    g = rng.randn(t_dim, ke, 16).astype(np.float32)
    want = h[src]
    want_h = np.asarray(jax.grad(lambda a: jnp.sum(a[src] * g))(
        jnp.asarray(h)))
    flat = _t(src).reshape(-1).long()
    bgather, boff = ell_spmm.transpose_layout(
        flat, torch.arange(flat.shape[0]), n)
    ht = _t(h).requires_grad_(True)
    got = gather_floor.GatherRows.apply(ht, _t(src), bgather, boff)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got_h,) = torch.autograd.grad((got * _t(g)).sum(), ht)
    np.testing.assert_allclose(got_h.numpy(), want_h, **GRAD_TOL)
    out = gather_floor.GatherRows.apply(_t(h).requires_grad_(True), _t(src),
                                        None, None)
    with pytest.raises(RuntimeError, match="transpose layout"):
        out.sum().backward()
