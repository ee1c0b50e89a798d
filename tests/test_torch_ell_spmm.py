"""The gather + segment-sum kernel's wrapper (ggnn_tpu_torch/ops/kernels/
ell_spmm.py) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; these tests hold
that version, the offsets it shares with the CUDA kernel, and the ELL
entry point against JAX's Pallas kernel (interpret mode) and
`jax.ops.segment_sum`, at 1e-5 (f32 sums in another order). The
kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data import packing as jax_packing
from ggnn_tpu.data.ell import build_ell_layout, padded_node_count
from ggnn_tpu.data.loader import infer_metadata
from ggnn_tpu.data.synthetic import synthetic_molecules
from ggnn_tpu.ops.pallas import ell_aggregate_by_type as jax_ell_aggregate
from ggnn_tpu_torch.ops.kernels import ell_spmm
from ggnn_tpu_torch.ops.messages import EdgeLanes
from ggnn_tpu_torch.ops.segment import segment_offsets

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BN = 8  # ELL block, as in tests/test_pallas.py


def _random_ell_problem(seed, n_nodes=40, t_dim=3, n_edges=90, h_dim=16):
    """The random problem of tests/test_pallas.py:_random_problem."""
    rng = np.random.RandomState(seed)
    np_total = padded_node_count(n_nodes, BN)
    src = rng.randint(0, n_nodes, size=(t_dim, n_edges)).astype(np.int32)
    tgt = rng.randint(0, n_nodes, size=(t_dim, n_edges)).astype(np.int32)
    mask = (rng.rand(t_dim, n_edges) < 0.8).astype(np.float32)
    h = rng.randn(np_total, h_dim).astype(np.float32)
    return h, build_ell_layout(src, tgt, mask, n_nodes, BN)


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


@pytest.mark.parametrize("seed", [0, 1])
def test_ell_aggregate_by_type_matches_jax_pallas(seed):
    h, layout = _random_ell_problem(seed)
    want = jax_ell_aggregate(
        jnp.asarray(h), (jnp.asarray(layout.fwd_src),
                         jnp.asarray(layout.fwd_tgt)),
        (jnp.asarray(layout.bwd_tgt), jnp.asarray(layout.bwd_src)), BN,
        True)
    got = ell_spmm.ell_aggregate_by_type(
        torch.from_numpy(h), torch.from_numpy(layout.fwd_src),
        torch.from_numpy(layout.fwd_tgt))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ref = ell_spmm.ell_aggregate_by_type_reference(
        torch.from_numpy(h), torch.from_numpy(layout.fwd_src),
        torch.from_numpy(layout.fwd_tgt))
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


def test_gather_segment_sum_on_combined_lane_matches_jax_segment_sum():
    batch, t_dim = _packed_batch()
    n_cap = batch.node_capacity
    h = np.random.RandomState(2).randn(n_cap, 16).astype(np.float32)
    comp = batch.edge_targets_all * t_dim + batch.edge_types_all
    want = jax.ops.segment_sum(jnp.asarray(h)[batch.edge_sources_all],
                               comp, (n_cap + 1) * t_dim,
                               indices_are_sorted=True)[:n_cap * t_dim]
    src = torch.from_numpy(batch.edge_sources_all)
    offsets = EdgeLanes.combined(src, torch.from_numpy(batch.edge_types_all),
                                 torch.from_numpy(batch.edge_targets_all),
                                 t_dim, n_cap).offsets
    assert offsets.dtype == torch.int32
    assert offsets.shape == (n_cap * t_dim + 1,)
    # The pads (target = N) lie past the last segment's end.
    assert int(offsets[-1]) == int((batch.edge_mask_all > 0).sum())
    got = ell_spmm.gather_segment_sum(torch.from_numpy(h), src, offsets,
                                      n_cap * t_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_segment_sum_empty_segments_and_trailing_pads():
    rng = np.random.RandomState(5)
    n_nodes, h_dim, n_seg = 12, 7, 10
    # Segments 0, 3, 4 and 9 are empty; 6 real edges, then 5 pad slots
    # whose ids sit past the last segment.
    seg = np.array([1, 1, 2, 5, 6, 8, 10, 10, 10, 10, 10], np.int64)
    src = rng.randint(0, n_nodes, size=seg.shape).astype(np.int32)
    h = rng.randn(n_nodes, h_dim).astype(np.float32)
    offsets = segment_offsets(torch.from_numpy(seg), n_seg)
    np.testing.assert_array_equal(offsets.numpy(),
                                  [0, 0, 2, 3, 3, 3, 4, 5, 5, 6, 6])
    got = ell_spmm.gather_segment_sum(torch.from_numpy(h),
                                      torch.from_numpy(src), offsets, n_seg)
    want = jax.ops.segment_sum(h[src], seg, n_seg + 1)[:n_seg]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for empty in (0, 3, 4, 9):
        assert not got[empty].any()


def test_ell_aggregate_by_type_keeps_pads_out_of_the_next_type():
    """A pad slot's target NP must not land in type t+1's row 0."""
    np_total, t_dim = 8, 2
    h = torch.arange(np_total * 3, dtype=torch.float32).reshape(np_total, 3)
    fwd_src = torch.tensor([[[5, 6, 1, 2]], [[3, 0, 0, 0]]],
                           dtype=torch.int32)
    fwd_tgt = torch.tensor([[[0, 4, 8, 8]], [[7, 8, 8, 8]]],
                           dtype=torch.int32)
    got = ell_spmm.ell_aggregate_by_type(h, fwd_src, fwd_tgt)
    want = torch.zeros(t_dim, np_total, 3)
    want[0, 0], want[0, 4], want[1, 7] = h[5], h[6], h[3]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["h_dtype", "src_dtype", "offsets_len",
                                 "h_rank", "non_contiguous"])
def test_gather_segment_sum_rejects_bad_inputs(bad):
    h = torch.randn(6, 4)
    src = torch.tensor([0, 1, 2], dtype=torch.int32)
    offsets = torch.tensor([0, 1, 3], dtype=torch.int32)
    num_segments = 2
    if bad == "h_dtype":
        h = h.to(torch.float16)
    elif bad == "src_dtype":
        src = src.long()
    elif bad == "offsets_len":
        num_segments = 3
    elif bad == "h_rank":
        h = h.reshape(6, 2, 2)
    elif bad == "non_contiguous":
        h = torch.randn(4, 6).t()
    with pytest.raises((TypeError, ValueError)):
        ell_spmm.gather_segment_sum(h, src, offsets, num_segments)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = ell_spmm.launches
    h = torch.randn(5, 4)
    src = torch.tensor([4, 0, 3], dtype=torch.int32)
    offsets = torch.tensor([0, 2, 3], dtype=torch.int32)
    got = ell_spmm.gather_segment_sum(h, src, offsets, 2)
    torch.testing.assert_close(got, torch.stack([h[4] + h[0], h[3]]))
    assert ell_spmm.launches == before
